"""Evaluation driver: whole-image forwards of both model families over the
anomaly benchmarks, and its command line.

Counterpart of ``multishiftseg_tpu/train/test_runner.py``: ``bucket_shape``,
``tta_wrap``, ``OODEvaluator`` (:59-205), the sampling-qualification gate
(:285-313), ``build_deeplab_forward`` (:255-271), ``build_m2f_forward``
(:316-411) and ``main`` (:414-486). Images are padded to shape buckets
(multiples of 128) and batched 4 to a forward; scores are cropped back before
the exact metrics. The forwards take the evaluator's images: ``ToTensor`` +
``Normalize(cfg.data.mean, cfg.data.std)``, f32 [B, H, W, 3], H and W
multiples of 32. ``build_m2f_request_forward`` serves uint8 requests over the
same forward. Both M2F forwards take every sample mode of JAX's
``build_m2f_forward`` (``bilinear``, the default and exact; ``int8``;
``nearest``; ``nearest_top{T}``; ``nearest_top{T}c``; ``shared``; a
comma-separated per-encoder-layer hybrid) and either approximate anomaly tail
(``score_lowres``, ``score_topq``; not both). Every mode but ``bilinear`` is
gated per checkpoint by the qualification artifact that
``multishiftseg_torch.tools.validate_release`` writes, under the key
``sample_mode[+lowres|+topq{Q}]``. ``--spatial N`` (``spatial_jit``,
:208-252) splits each image's rows over N cards in one process
(``core/spatial.py``): the buckets are padded to
:func:`~multishiftseg_torch.core.spatial.spatial_bucket_multiple` so that every
feature level splits evenly, and the CLI refuses N above the cards present.

CLI::

    python -m multishiftseg_torch.train.test_runner --model m2f \\
        --cfg exps/m2f.yaml --weight_path ckpt.pth [--test_dataset RoadAnomaly21] \\
        [--sample_mode nearest_top6c] [--score_lowres | --score_topq 32] [--spatial 2]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import spatial
from ..core.config import Config, load_config
from ..data.anomaly import EVAL_DATASETS
from ..data.transforms import Compose, Normalize, ToTensor
from ..evals.ood_metrics import eval_ood_measure, metrics_route
from ..evals.seg_metrics import compute_metric, hist_info
from ..models.deeplab import DeepWV3Plus
from ..models.maskformer import MaskFormer, preprocess
from ..models.pixel_decoder import DEFORM_POINTS
from ..ops.ms_deform_attn import parse_eval_sample_mode
from ..utils import map2citycolor, resolve_device

log = logging.getLogger(__name__)

# the reference's defaults: test_deeplab iterates {RoadAnomaly, RA21, RO21}; test_m2f adds MUAD
DEFAULT_DATASETS = ("RoadAnomaly", "RoadAnomaly21", "RoadObstacle21")
DEFAULT_DATASETS_M2F = DEFAULT_DATASETS + ("MUAD",)

Forward = Callable[[torch.Tensor], Tuple[torch.Tensor, Optional[torch.Tensor]]]


def bucket_shape(h: int, w: int, multiple: int = 128) -> Tuple[int, int]:
    """Round (h, w) up to a coarse bucket."""
    return (-(-h // multiple) * multiple, -(-w // multiple) * multiple)


def tta_wrap(forward_fn: Forward) -> Forward:
    """Horizontal-flip TTA over an (anomaly, sem) forward
    (``SemanticSegmentorWithTTA``): the mean of the image's and its mirror's."""

    def wrapped(img):
        a, s = forward_fn(img)
        a2, s2 = forward_fn(torch.flip(torch.as_tensor(img), dims=[2]))
        a = 0.5 * (a + torch.flip(a2, dims=[2]))
        if s is not None and s2 is not None:
            s = 0.5 * (s + torch.flip(s2, dims=[-1]))
        return a, s

    return wrapped


class OODEvaluator:
    """Whole-image eval loop over the anomaly benchmarks."""

    def __init__(self, cfg: Config, forward_fn: Forward, dataset_roots: Dict[str, str],
                 tta: bool = False, save_dir: Optional[str] = None, batch_size: int = 4,
                 bucket_multiple: int = 128):
        """``forward_fn(imgs [B, H, W, 3] f32) -> (anomaly [B, H, W], sem
        [B, C, H, W] or None)``, tensors on any device. ``batch_size`` images
        of one shape bucket go to one forward. ``save_dir``: per-image
        artifacts under ``<save_dir>/<dataset>/``, named by the image's path
        (separators as ``_``): ``<stem>_anomaly.npy`` (the f32 score map) and
        ``<stem>_pred_color.png`` (the train-id argmax in the Cityscapes
        palette). ``metric_routes`` records the route of each benchmark's
        exact metrics (``evals.ood_metrics.metrics_route``: native from
        2,000,000 labelled pixels on). ``bucket_multiple``: the padding
        granularity (/128); the row-partitioned eval raises it
        (``core.spatial.spatial_bucket_multiple``) so that every feature
        level's height splits evenly over the slabs."""
        self.cfg = cfg
        self.bucket_multiple = bucket_multiple
        self.metric_routes: Dict[str, Optional[str]] = {}
        self.forward_fn = tta_wrap(forward_fn) if tta else forward_fn
        self.roots = dataset_roots
        self.save_dir = save_dir
        self.batch_size = batch_size

    def _save_outputs(self, name: str, image_path: str, anomaly: np.ndarray,
                      sem: Optional[np.ndarray]) -> None:
        from PIL import Image

        out = os.path.join(self.save_dir, name)
        os.makedirs(out, exist_ok=True)
        # the whole path: per-city layouts repeat basenames
        stem = os.path.splitext(image_path)[0].replace(os.sep, "_").lstrip("_")
        np.save(os.path.join(out, f"{stem}_anomaly.npy"), anomaly)
        if sem is not None:
            pred = np.argmax(sem[:19], axis=0).astype(np.uint8)
            Image.fromarray(map2citycolor(pred)).save(os.path.join(out, f"{stem}_pred_color.png"))

    def _transform(self):
        d = self.cfg.data
        return Compose([ToTensor(), Normalize(mean=d.mean, std=d.std)])

    def test(self, name: str) -> Optional[Dict[str, float]]:
        """Evaluate one benchmark, batching images that share a padded bucket."""
        from PIL import Image

        kwargs = {"root": self.roots[name]} if name in self.roots else {}
        ds = EVAL_DATASETS[name](transform=self._transform(), **kwargs)
        if len(ds) == 0:
            log.warning("%s: no images found", name)
            return None
        scores: List[np.ndarray] = []
        gts: List[np.ndarray] = []
        hists = []
        # bucket by a header-only size probe
        buckets: Dict[Tuple[int, int], List[int]] = {}
        for i in range(len(ds)):
            with Image.open(ds.images[i]) as im:
                w, h = im.size
            buckets.setdefault(bucket_shape(h, w, self.bucket_multiple), []).append(i)

        for (bh, bw), idxs in buckets.items():
            for s in range(0, len(idxs), self.batch_size):
                chunk = [ds[i] for i in idxs[s:s + self.batch_size]]
                imgs = np.zeros((len(chunk), bh, bw, 3), np.float32)
                for j, item in enumerate(chunk):
                    imgs[j, :item[0].shape[0], :item[0].shape[1]] = item[0]
                anomaly, sem = self.forward_fn(torch.from_numpy(imgs))
                anomaly = anomaly.float().cpu().numpy()
                sem_np = (sem.float().cpu().numpy()
                          if self.save_dir is not None and sem is not None else None)
                for j, item in enumerate(chunk):
                    h, w = item[0].shape[:2]
                    eval_gt = item[3] if len(item) > 3 else None
                    scores.append(anomaly[j, :h, :w].reshape(-1))
                    gts.append(np.asarray(item[1]).reshape(-1))
                    if self.save_dir is not None:
                        self._save_outputs(
                            name, ds.images[idxs[s + j]], anomaly[j, :h, :w],
                            None if sem_np is None else sem_np[j, :, :h, :w])
                    if eval_gt is not None and sem is not None:
                        pred = torch.argmax(sem[j, :19, :h, :w], dim=0).cpu().numpy()
                        hists.append(dict(zip(("hist", "labeled", "correct"),
                                              hist_info(19, pred, np.asarray(eval_gt)))))
        scores, gts = np.concatenate(scores), np.concatenate(gts)
        res = eval_ood_measure(scores, gts)
        self.metric_routes[name] = None if res is None else metrics_route(
            int(np.count_nonzero((gts == 0) | (gts == 1))))
        out = {} if res is None else {"AUROC": res[0], "AUPRC": res[1], "FPR_TPR95": res[2]}
        if hists:
            miou, pacc = compute_metric(hists)
            out.update({"mIoU": miou, "pixel_acc": pacc})
        return out or None

    def test_all(self, names: Sequence[str] = DEFAULT_DATASETS) -> Dict[str, Dict[str, float]]:
        results = {}
        for name in names:
            try:
                r = self.test(name)
            except Exception as e:  # per-dataset resilience (test_deeplab.py:122-128)
                log.warning("%s failed: %s", name, e)
                r = None
            if r is not None:
                results[name] = r
                if "AUROC" in r:
                    log.warning("%s: AUROC %.2f AUPRC %.2f FPR95 %.2f", name,
                                100 * r["AUROC"], 100 * r["AUPRC"], 100 * r["FPR_TPR95"])
                if "mIoU" in r:
                    log.warning("%s: mIoU %.2f pixel_acc %.2f", name,
                                100 * r["mIoU"], 100 * r["pixel_acc"])
        return results


def sampling_qualification_path(weight_path: str) -> Path:
    """Where ``tools/validate_release.py`` records a checkpoint's
    approximate-sampling qualification."""
    p = Path(weight_path)
    return p.parent / (p.stem + ".sampling_qualification.json")


def check_sampling_qualification(weight_path: Optional[str], sample_mode: str) -> None:
    """Refuse an approximate sampling mode whose qualification on these
    weights failed; warn where no qualification of the mode is recorded (no
    artifact, or an artifact without the mode's key)."""
    if sample_mode == "bilinear" or not weight_path:
        return
    qp = sampling_qualification_path(weight_path)
    if not qp.exists():
        log.warning("sample_mode=%s: no per-checkpoint qualification artifact (%s); "
                    "run tools/validate_release.py to qualify this checkpoint.",
                    sample_mode, qp)
        return
    rec = json.loads(qp.read_text()).get("modes", {}).get(sample_mode)
    if rec is None:
        log.warning("sample_mode=%s: the qualification artifact %s has no entry for "
                    "this mode; it is not qualified on these weights.", sample_mode, qp)
        return
    if not rec.get("qualified", False):
        raise RuntimeError(
            f"sample_mode={sample_mode!r} REFUSED for {weight_path}: measured deltas vs "
            f"exact bilinear exceeded the qualification budget ({rec.get('delta_pts')}, "
            f"artifact {qp}). Use --sample_mode bilinear.")


def qualification_key(sample_mode: str, score_lowres: bool = False, score_topq: int = 0) -> str:
    """The artifact's key of an eval setting, as JAX's (``test_runner.py:353-356``):
    the sample mode, then ``+lowres`` or ``+topq{Q}``."""
    return sample_mode + ("+lowres" if score_lowres else "") + (
        f"+topq{score_topq}" if score_topq else "")


def _check_eval_options(sample_mode: str, score_lowres: bool, score_topq: int) -> None:
    """Refuse a setting the forward would refuse, before anything is built:
    an unknown mode, T outside 1..L * P, a negative Q, both tails."""
    parse_eval_sample_mode(sample_mode, DEFORM_POINTS)
    if score_lowres and score_topq:
        raise ValueError("score_lowres and score_topq are exclusive; set one")
    if score_topq < 0:
        raise ValueError(f"score_topq must be >= 0, got {score_topq}")


def build_m2f_forward(cfg: Config, weight_path: Optional[str] = None, *,
                      model: Optional[MaskFormer] = None, device="cuda",
                      sample_mode: str = "bilinear", score_lowres: bool = False,
                      score_topq: int = 0, enforce_qualification: bool = True,
                      spatial_devices: int = 0, slab_devices=None) -> Forward:
    """``fwd(imgs) -> (anomaly [B, H, W], sem [B, K + Q, H, W])`` for the
    evaluator's images, f32 on ``device`` (CUDA unless the caller asks for the
    CPU). The model is ``TrainM2FOOD``'s: from ``weight_path``, or ``model``,
    or random init from ``cfg.train.seed``; ``TrainM2FOOD.eval_step``: eval
    mode, bf16 autocast over f32 weights when ``cfg.train.bf16``, the sample
    mode and tail given (module docstring). The setting is checked, then the
    qualification gate runs under :func:`qualification_key` unless
    ``enforce_qualification`` is False (the qualification run itself), then the
    model is built. ``spatial_devices = N``: each image's rows in N slabs
    (``core.spatial.m2f_eval``) over ``slab_devices``, by default the first N
    cards (``core.spatial.slab_devices``)."""
    from .m2f_trainer import TrainM2FOOD

    _check_eval_options(sample_mode, score_lowres, score_topq)
    if enforce_qualification:
        check_sampling_qualification(weight_path,
                                     qualification_key(sample_mode, score_lowres, score_topq))
    trainer = TrainM2FOOD(cfg, weight_path, model=model, device=device)
    if spatial_devices:
        devs = spatial.slab_devices(spatial_devices, slab_devices, trainer.device)
        runner = spatial.SlabRunner(trainer.model.eval(), devs)

        @torch.inference_mode()
        def fwd_spatial(images):
            sem, anomaly = spatial.m2f_eval(trainer.model, _eval_images(images), devs,
                                            trainer.bf16, sample_mode, score_lowres,
                                            score_topq, runner)
            return anomaly, sem

        return fwd_spatial

    def fwd(images):
        sem, anomaly = trainer.eval_step(images, sample_mode, score_lowres, score_topq)
        return anomaly, sem

    return fwd


def build_m2f_request_forward(model: MaskFormer, device="cuda", sample_mode: str = "bilinear",
                              score_lowres: bool = False, score_topq: int = 0,
                              weight_path: Optional[str] = None,
                              enforce_qualification: bool = True
                              ) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """``fwd(images_uint8 [N, H, W, 3]) -> (anomaly [N, H, W], sem [N, K + Q, H, W])``.

    A request path over the same forward (``m2f_trainer.eval_forward``): moves
    ``model`` to ``device``, keeping its parameter dtype (bf16 or f32, no
    autocast); ``fwd`` normalises with ``PIXEL_MEAN`` / ``PIXEL_STD`` in 0-255
    space, pads to /32, and crops both outputs back to the input size. f32
    tensors on ``device``. ``sample_mode``, ``score_lowres`` and ``score_topq``
    as :func:`build_m2f_forward`; ``weight_path``, the checkpoint ``model``
    was loaded from, if any, names the qualification artifact the gate reads.
    """
    from .m2f_trainer import eval_forward

    _check_eval_options(sample_mode, score_lowres, score_topq)
    if enforce_qualification:
        check_sampling_qualification(weight_path,
                                     qualification_key(sample_mode, score_lowres, score_topq))
    device = resolve_device(device)
    model = model.to(device).eval()

    @torch.inference_mode()
    def fwd(images_uint8):
        imgs = torch.as_tensor(images_uint8, device=device)
        if imgs.dtype != torch.uint8 or imgs.dim() != 4 or imgs.shape[-1] != 3:
            raise ValueError(f"expected uint8 [N, H, W, 3] images, got "
                             f"{imgs.dtype} {tuple(imgs.shape)}")
        h, w = imgs.shape[1:3]
        sem, anomaly = eval_forward(model, preprocess(imgs), sample_mode=sample_mode,
                                    score_lowres=score_lowres, score_topq=score_topq)
        return anomaly[:, :h, :w], sem[..., :h, :w]

    return fwd


def _eval_images(images) -> torch.Tensor:
    x = torch.as_tensor(images)
    if x.dtype != torch.float32 or x.dim() != 4 or x.shape[-1] != 3:
        raise ValueError(f"expected normalised float32 [N, H, W, 3] images, got "
                         f"{x.dtype} {tuple(x.shape)}")
    return x


def build_deeplab_forward(cfg: Config, weight_path: Optional[str] = None, *,
                          model: Optional[DeepWV3Plus] = None, device="cuda",
                          spatial_devices: int = 0, slab_devices=None) -> Forward:
    """``fwd(imgs [N, H, W, 3] normalised f32) -> (score [N, H, W], logit
    [N, C, H, W])``, both f32 on ``device`` (CUDA unless the caller asks for
    the CPU): ``TrainDeepLabOOD.eval_step`` of the model from ``weight_path``,
    or ``model``, or random init; bf16 autocast over f32 weights when
    ``cfg.train.bf16``, the energy score and the logits' resize in f32.
    ``spatial_devices = N``: each image's rows in N slabs
    (``core.spatial.deeplab_forward``) over ``slab_devices``, by default the
    first N cards."""
    from .deeplab_trainer import TrainDeepLabOOD

    trainer = TrainDeepLabOOD(cfg, weight_path, model=model, device=device)
    if spatial_devices:
        devs = spatial.slab_devices(spatial_devices, slab_devices, trainer.device)
        runner = spatial.SlabRunner(trainer.model.eval(), devs)

        @torch.inference_mode()
        def fwd_spatial(images):
            x = _eval_images(images).to(devs[0])
            trainer.model.eval()
            with torch.autocast(devs[0].type, dtype=torch.bfloat16, enabled=trainer.bf16):
                return spatial.deeplab_forward(trainer.model, x.permute(0, 3, 1, 2), devs,
                                               runner)

        return fwd_spatial

    def fwd(images):
        return trainer.eval_step(_eval_images(images))

    return fwd


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, float]]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", choices=["deeplab", "m2f"], required=True)
    parser.add_argument("--cfg", default=None)
    parser.add_argument("--id", default="eval")
    parser.add_argument("--weight_path", default=None)
    parser.add_argument("--test_dataset", default=None)
    parser.add_argument("--tta", action="store_true",
                        help="horizontal-flip test-time augmentation")
    parser.add_argument("--save_outputs", default=None, metavar="DIR",
                        help="write per-image anomaly score maps (.npy) and colorized "
                             "predictions (.png) under DIR/<dataset>/")
    parser.add_argument("--sample_mode", default="bilinear",
                        help="m2f deformable sampling: bilinear (exact, default); int8, "
                             "nearest, nearest_top{T}, nearest_top{T}c, shared "
                             "(approximate, qualified per checkpoint by "
                             "multishiftseg_torch.tools.validate_release); a "
                             "comma-separated list gives a per-encoder-layer hybrid")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--spatial", type=int, default=0, metavar="N",
                        help="split each image's rows over N cards (single-image "
                             "latency; 0 = off); needs N cards")
    parser.add_argument("--score_lowres", action="store_true",
                        help="m2f: score the anomaly branch at mask resolution and "
                             "resize the score map (approximate; qualified under the "
                             "'<sample_mode>+lowres' key)")
    parser.add_argument("--score_topq", type=int, default=0, metavar="Q",
                        help="m2f: score the anomaly branch from the Q OOD queries of "
                             "largest non-void peak probability (approximate; "
                             "qualified under '<sample_mode>+topq{Q}'); not with "
                             "--score_lowres")
    args = parser.parse_args(argv)
    if args.spatial:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if args.device != "cuda" or cards < args.spatial:
            raise ValueError(f"--spatial {args.spatial} needs {args.spatial} cards; "
                             f"{cards if args.device == 'cuda' else 0} are present "
                             f"(--device {args.device})")

    logging.basicConfig(level=logging.INFO)
    cfg = load_config(args.cfg, args.id)
    if args.model == "deeplab":
        fwd = build_deeplab_forward(cfg, args.weight_path, device=args.device,
                                    spatial_devices=args.spatial)
    else:
        fwd = build_m2f_forward(cfg, args.weight_path, device=args.device,
                                sample_mode=args.sample_mode,
                                score_lowres=args.score_lowres, score_topq=args.score_topq,
                                spatial_devices=args.spatial)
    d = cfg.data
    roots = {"CityscapesVal": d.cityscapes_root, "RoadAnomaly": d.road_anomaly_root,
             "RoadAnomaly21": d.anomaly_track_root, "RoadObstacle21": d.obstacle_track_root,
             "MUAD": d.muad_root, "ACDC_POC": d.acdc_root}
    ev = OODEvaluator(cfg, fwd, roots, tta=args.tta, save_dir=args.save_outputs,
                      bucket_multiple=spatial.spatial_bucket_multiple(
                          args.spatial, spatial.M2F_STRIDE if args.model == "m2f"
                          else spatial.DEEPLAB_STRIDE))
    names = ((args.test_dataset,) if args.test_dataset
             else DEFAULT_DATASETS if args.model == "deeplab" else DEFAULT_DATASETS_M2F)
    results = ev.test_all(names)
    print(results)
    return results


if __name__ == "__main__":
    main()
