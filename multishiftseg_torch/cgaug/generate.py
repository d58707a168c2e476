"""CG-Aug generation: seg-conditioned image synthesis with semantic-shift
pasting and SAM / detector quality filtering.

Counterpart of ``multishiftseg_tpu/cgaug/generate.py``
(``CGAug/generate_multishift_image.py:32-234``), with the backends injected
through the Protocols below. Per Cityscapes frame (:meth:`MultiShiftGenerator.generate`):

1. remap the colour label into the ADE20K palette;
2. paste a random OOD object's mask onto the road in label space;
3. sample a domain prompt (weather x time x place, 50% plain);
4. run the seg-conditioned diffusion backend;
5. auto-filter: SAM's box-prompted IoU above ``iou_threshold``, then the mean
   detector score over the pasted region at least ``score_threshold``;
   otherwise resample (bounded retries).

The same backends and seed draw the same labels, prompts and decisions as
JAX's ``generate.py``. ``python -m multishiftseg_torch.cgaug.generate`` runs the
reference path (``--backend real``) on the card, or on the CPU with
``--device cpu``; the weights are read from ``--download_dir`` only.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Optional, Protocol, Sequence, Tuple

import numpy as np
from PIL import Image

from .label_ops import cityscapes_to_ade20k, paste_anomaly
from .prompts import DEFAULT_PLACES, DEFAULT_WEATHERS, get_prompt

log = logging.getLogger(__name__)

# the compact trainable backends (JAX's cgaug/train_backends.py) are not ported
TRAINABLE_ITEM = "ROADMAP.md Queue 1 item 5b (CG-Aug's compact trainable backends)"


class DiffusionBackend(Protocol):
    def generate(self, seg_label_rgb: np.ndarray, prompt: str) -> np.ndarray:
        """[H, W, 3] ADE20K-palette label + prompt -> [H, W, 3] uint8 image."""


class PromptableSegmenter(Protocol):
    def segment_box(self, image: np.ndarray, box_xyxy: np.ndarray) -> np.ndarray:
        """Image + box -> binary mask [H, W] (SAM-style box prompting)."""


class AnomalyDetector(Protocol):
    def anomaly_score(self, image: np.ndarray) -> np.ndarray:
        """[H, W, 3] uint8 -> [H, W] per-pixel anomaly score."""


class AnomalySource(Protocol):
    def sample(self, rng: np.random.Generator) -> Tuple[np.ndarray, str]:
        """-> (binary object mask [h, w], ADE20K class name)."""


# Cityscapes train cities in the reference's 4 generation-job shards
# (``generation_utils.py:14-30``: one process per city batch); val cities
# for the val split.
CITY_BATCHES = [
    ["aachen", "bochum", "bremen", "cologne"],
    ["darmstadt", "dusseldorf", "erfurt", "hamburg"],
    ["hanover", "jena", "krefeld", "monchengladbach", "strasbourg"],
    ["stuttgart", "tubingen", "ulm", "weimar", "zurich"],
]
VAL_CITIES = ["frankfurt", "lindau", "munster"]


def get_cities(split: str = "train", city_batch: int = 0):
    """The reference's generation-job sharding (``get_cities``)."""
    if split == "train":
        return CITY_BATCHES[city_batch]
    return VAL_CITIES


def _bbox(mask: np.ndarray) -> np.ndarray:
    ys, xs = np.where(mask == 1)
    return np.asarray([xs.min(), ys.min(), xs.max(), ys.max()])


def _iou(a: np.ndarray, b: np.ndarray) -> float:
    inter = np.logical_and(a, b).sum()
    union = np.logical_or(a, b).sum()
    return float(inter) / max(float(union), 1.0)


@dataclass
class GenerationConfig:
    weathers: Sequence[str] = DEFAULT_WEATHERS
    places: Sequence[str] = DEFAULT_PLACES
    iou_threshold: float = 0.7
    score_threshold: float = -3.02
    max_retries: int = 5
    ood_label_id: int = 254
    seed: int = 0
    # pasted-object longer-side range in LABEL pixels: the reference's
    # absolute 200-500 px, for its 1024x2048 labels; scale them with the label
    paste_min_size: int = 200
    paste_max_size: int = 500


class MultiShiftGenerator:
    """The ``Semantic2ImageGenerator`` equivalent with injected backends."""

    def __init__(
        self,
        diffusion: DiffusionBackend,
        anomaly_source: AnomalySource,
        cfg: GenerationConfig = GenerationConfig(),
        segmenter: Optional[PromptableSegmenter] = None,
        detector: Optional[AnomalyDetector] = None,
    ):
        self.diffusion = diffusion
        self.anomaly_source = anomaly_source
        self.segmenter = segmenter
        self.detector = detector
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        # filter observability: attempts / accepts / per-filter rejects
        self.stats = {"attempts": 0, "accepted": 0, "iou_rejects": 0,
                      "detector_rejects": 0, "failed_images": 0}

    def auto_filter(self, image: np.ndarray, anomaly_mask: np.ndarray) -> bool:
        """SAM IoU, then the detector score (``auto_filtering``,
        generate_multishift_image.py:145-184); the detector runs only on an
        image the IoU gate passed."""
        if self.segmenter is not None and anomaly_mask.sum() > 0:
            pred = self.segmenter.segment_box(image, _bbox(anomaly_mask))
            if _iou(pred, anomaly_mask) <= self.cfg.iou_threshold:
                self.stats["iou_rejects"] += 1
                return False
        if self.detector is not None and anomaly_mask.sum() > 0:
            score = self.detector.anomaly_score(image)
            if float(score[anomaly_mask == 1].mean()) < self.cfg.score_threshold:
                self.stats["detector_rejects"] += 1
                return False
        return True

    def generate(
        self, color_label: np.ndarray
    ) -> Optional[Tuple[np.ndarray, np.ndarray, str, str]]:
        """color_label: Cityscapes ``_gtFine_color.png`` RGB array.

        Returns (image, anomaly_mask, ood_name, domain) or None after max_retries.
        """
        ade_label, _ = cityscapes_to_ade20k(color_label)
        for attempt in range(self.cfg.max_retries):
            obj_mask, ood_name = self.anomaly_source.sample(self.rng)
            pasted, anomaly_mask = paste_anomaly(
                ade_label, obj_mask, ood_name, self.rng,
                min_size=self.cfg.paste_min_size,
                max_size=self.cfg.paste_max_size)
            prompt, domain = get_prompt(
                self.cfg.weathers, self.cfg.places, self.rng, ood_name=ood_name
            )
            image = self.diffusion.generate(pasted, prompt)
            self.stats["attempts"] += 1
            if self.auto_filter(image, anomaly_mask):
                self.stats["accepted"] += 1
                return image, anomaly_mask, ood_name, domain
            log.info("attempt %d rejected by auto-filter", attempt)
        self.stats["failed_images"] += 1
        return None

    def run(
        self,
        color_label_paths: Sequence[str],
        train_id_label_paths: Sequence[str],
        out_image_dir: str,
        out_label_dir: str,
    ):
        """Batch loop with resume-by-existence (generate_multishift_image.py:195-198):
        writes the generated image and a trainId label where pasted pixels = 254."""
        os.makedirs(out_image_dir, exist_ok=True)
        os.makedirs(out_label_dir, exist_ok=True)
        for color_path, tid_path in zip(color_label_paths, train_id_label_paths):
            stem = os.path.basename(color_path).split("_gtFine")[0]
            out_img = os.path.join(out_image_dir, f"{stem}_leftImg8bit.png")
            if os.path.exists(out_img):
                continue
            color = np.asarray(Image.open(color_path).convert("RGB"))
            result = self.generate(color)
            if result is None:
                log.warning("%s: generation failed after retries", stem)
                continue
            image, anomaly_mask, ood_name, domain = result
            tid = np.asarray(Image.open(tid_path)).copy()
            tid[anomaly_mask == 1] = self.cfg.ood_label_id
            # label FIRST: resume-by-existence keys on the image, so a crash
            # between the two writes must never leave an image without its label
            Image.fromarray(tid).save(
                os.path.join(out_label_dir, f"{stem}_gtFine_labelTrainIds.png")
            )
            Image.fromarray(image).save(out_img)
            log.info("%s: generated (%s%s)", stem, ood_name, domain)


def make_m2f_detector(model, device="cuda") -> AnomalyDetector:
    """The quality filter's detector slot served by the port's Mask2Anomaly
    ``MaskFormer`` on ``device`` (CUDA unless the caller asks for the CPU):
    JAX's normalisation on the [0, 1] scale, the /32 pad, the normal forward
    and ``inference``'s anomaly tail, cropped back to the image."""
    import torch

    from ..data.loader import pad_to_multiple
    from ..models.maskformer import inference
    from ..utils import resolve_device

    device = resolve_device(device)
    model = model.to(device).eval()
    mean = np.asarray((0.485, 0.456, 0.406), np.float32)
    std = np.asarray((0.229, 0.224, 0.225), np.float32)

    class _Detector:
        @torch.no_grad()
        def anomaly_score(self, image: np.ndarray) -> np.ndarray:
            x = image.astype(np.float32) / 255.0
            x = (x - mean) / std
            x, (h, w) = pad_to_multiple(x, 32)
            img = torch.from_numpy(np.ascontiguousarray(x[None])).to(device)
            _, anomaly = inference(model(img), tuple(img.shape[1:3]))
            return anomaly[0, :h, :w].float().cpu().numpy()

    return _Detector()


def main(argv: Optional[Sequence[str]] = None):
    """The CLI, the ``python CGAug/generate_multishift_image.py`` equivalent.

    Walks the Cityscapes ``gtFine`` colour labels of one generation-job city
    batch (the reference's 4-way ``get_cities`` sharding), builds the backends,
    and writes generated images and 254-labelled trainId maps in the
    ``DiverseCityscapes`` layout (``<out_root>/{leftImg8bit,gtFine}/<split>/<city>/``)."""
    import argparse
    import glob as globlib

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cityscapes_root", default="./datasets/cityscapes")
    ap.add_argument("--ade_root", required=True,
                    help="ADE20K 2021 root (with index_ade20k.pkl + class mapping)")
    ap.add_argument("--out_root", default="./datasets/DTWP_ADE_final")
    ap.add_argument("--split", default="train", choices=["train", "val"])
    ap.add_argument("--city_batch", type=int, default=0,
                    help="generation-job shard 0-3 (reference get_cities)")
    ap.add_argument("--backend", default="real", choices=["real", "trainable"],
                    help="'real' = control_sd15_seg.pth + SAM ViT-H from --download_dir; "
                         "'trainable' = the compact backends (not ported)")
    ap.add_argument("--download_dir", default="pretrained_model",
                    help="where the weights are read from; nothing is downloaded")
    ap.add_argument("--detector_weight", default=None,
                    help="M2F checkpoint for the anomaly-score gate "
                         "(reference: Mask2Anomaly at score >= -3.02)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paste_min_size", type=int, default=200,
                    help="pasted-object longer side, min px (reference's 200 "
                         "assumes 1024x2048 labels; scale for other sizes)")
    ap.add_argument("--paste_max_size", type=int, default=500)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="[%(asctime)s] %(message)s")
    from . import ade20k_source

    if args.backend != "real":
        raise NotImplementedError(f"--backend {args.backend}: {TRAINABLE_ITEM}")
    from .weights import build_real_backends

    diffusion, segmenter = build_real_backends(args.download_dir, device=args.device)

    detector = None
    if args.detector_weight:
        from ..core.config import load_config
        from ..train.m2f_trainer import TrainM2FOOD

        trainer = TrainM2FOOD(load_config(None, "cgaug_detector"),
                              weight_path=args.detector_weight, device=args.device)
        detector = make_m2f_detector(trainer.model, device=args.device)

    gen = MultiShiftGenerator(
        diffusion,
        ade20k_source.ADE20KAnomalySource(args.ade_root),
        GenerationConfig(seed=args.seed, paste_min_size=args.paste_min_size,
                         paste_max_size=args.paste_max_size),
        segmenter=segmenter,
        detector=detector,
    )
    for city in get_cities(args.split, args.city_batch):
        colors = sorted(globlib.glob(os.path.join(
            args.cityscapes_root, "gtFine", args.split, city,
            "*_gtFine_color.png")))
        tids = [c.replace("_gtFine_color.png", "_gtFine_labelTrainIds.png")
                for c in colors]
        log.info("%s: %d frames", city, len(colors))
        gen.run(
            colors, tids,
            out_image_dir=os.path.join(args.out_root, "leftImg8bit",
                                       args.split, city),
            out_label_dir=os.path.join(args.out_root, "gtFine",
                                       args.split, city),
        )
    log.info("filter stats: %s", gen.stats)
    return gen.stats


if __name__ == "__main__":
    main()
