"""Seeded synthetic dataset folders in the layouts the training recipes read,
for smoke runs and tests where the real datasets are absent.

``write_training_tree(root, seed, ...)`` writes, under ``root``:

- ``cityscapes/``: ``leftImg8bit/train/<city>/*_leftImg8bit.png`` frames and
  ``gtFine/train/<city>/*_gtFine_labelTrainIds.png`` labels (train ids in
  blocks, a void band);
- ``generated/``: ``variants`` CG-Aug-style variants of each frame in the same
  layout, their labels carrying a label-254 (anomaly) rectangle;
- ``coco/``: ``train2017/<id>.jpg`` cut-out sources and
  ``annotations/oodclass_nocrowd_seg_train2017/mask_<id>.png`` object masks;
- ``anomaly_track/``: a SMIYC RoadAnomaly21 folder, ``images/*.jpg`` and
  ``labels_masks/*_labels_semantic.png`` (0 in-distribution, 1 anomaly, 255
  void).

Images are smooth blocks of colour with a little noise, so that they compress
and decode at realistic rates. Returns the roots as ``cfg.data`` names them.

``write_segments_tree(root, seed, ...)`` writes a Cityscapes tree in the
layouts of the instance, panoptic and semantic recipes, for ``train`` and
``val``, under ``root/cityscapes``: ``leftImg8bit/<split>/<city>/`` frames,
``gtFine/<split>/<city>/*_gtFine_labelTrainIds.png`` (uint8 train ids) and
``*_gtFine_instanceIds.png`` (uint16: stuff pixels hold their raw label id,
thing instances raw id * 1000 + n, crowds their raw id),
``gtFine/cityscapes_panoptic_<split>/*_gtFine_panoptic.png`` (RGB-encoded
segment ids, 0 where the class is ignored in evaluation) and
``gtFine/cityscapes_panoptic_<split>.json`` (``images`` and ``annotations``
with ``segments_info``: id, raw category id, area, iscrowd). Each frame has
stuff in blocks, a void band, one person crowd and ``things`` rectangles of
the thing classes, several of a class; caravans and trailers among them,
which the recipes drop.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
from PIL import Image


def _image(g: np.random.Generator, hw: Tuple[int, int], block: int = 32) -> np.ndarray:
    h, w = hw
    coarse = g.integers(0, 256, (-(-h // block), -(-w // block), 3))
    img = np.repeat(np.repeat(coarse, block, 0), block, 1)[:h, :w]
    return np.clip(img + g.integers(-6, 7, (h, w, 3)), 0, 255).astype(np.uint8)


def _labels(g: np.random.Generator, hw: Tuple[int, int], block: int = 64) -> np.ndarray:
    h, w = hw
    coarse = g.integers(0, 19, (-(-h // block), -(-w // block)))
    lab = np.repeat(np.repeat(coarse, block, 0), block, 1)[:h, :w].astype(np.uint8)
    lab[:max(h // 32, 1)] = 255
    return lab


def _save(path: Path, arr: np.ndarray, **kw) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(arr).save(path, **kw)


def write_training_tree(root, seed: int, frames: int = 16, hw: Tuple[int, int] = (1024, 2048),
                        cities: int = 2, variants: int = 1, coco: int = 4,
                        coco_hw: Tuple[int, int] = (480, 640), val: int = 4,
                        val_hw: Tuple[int, int] = (720, 1280)) -> Dict[str, str]:
    root = Path(root)
    g = np.random.default_rng(seed)
    h, w = hw
    for i in range(frames):
        city = f"city{i % cities}"
        stem = f"{city}_{i:06d}_000019"
        _save(root / "cityscapes/leftImg8bit/train" / city / f"{stem}_leftImg8bit.png",
              _image(g, hw))
        _save(root / "cityscapes/gtFine/train" / city / f"{stem}_gtFine_labelTrainIds.png",
              _labels(g, hw))
        for v in range(variants):
            gstem = f"{stem}_v{v}"
            _save(root / "generated/leftImg8bit/train" / city / f"{gstem}_leftImg8bit.png",
                  _image(g, hw))
            lab = _labels(g, hw)
            y0, x0 = int(g.integers(0, h // 2)), int(g.integers(0, w // 2))
            lab[y0:y0 + h // 4, x0:x0 + w // 6] = 254
            _save(root / "generated/gtFine/train" / city / f"{gstem}_gtFine_labelTrainIds.png", lab)
    ch, cw = coco_hw
    for i in range(coco):
        _save(root / "coco/train2017" / f"{i + 1:012d}.jpg", _image(g, coco_hw), quality=90)
        mask = np.zeros(coco_hw, np.uint8)
        y0, x0 = int(g.integers(0, ch // 2)), int(g.integers(0, cw // 2))
        mask[y0:y0 + ch // 3, x0:x0 + cw // 3] = 254
        mask[y0:y0 + 4] = 255  # an ignored border, as COCO's crowd edges
        _save(root / "coco/annotations/oodclass_nocrowd_seg_train2017"
              / f"mask_{i + 1:012d}.png", mask)
    vh, vw = val_hw
    for i in range(val):
        _save(root / "anomaly_track/images" / f"val{i}.jpg", _image(g, val_hw), quality=90)
        lab = np.zeros(val_hw, np.uint8)
        lab[vh // 3:vh // 2, vw // 4:vw // 2] = 1
        lab[:vh // 16] = 255
        _save(root / "anomaly_track/labels_masks" / f"val{i}_labels_semantic.png", lab)
    return {"cityscapes_root": str(root / "cityscapes"),
            "generation_root": str(root / "generated"),
            "coco_root": str(root / "coco"),
            "anomaly_track_root": str(root / "anomaly_track")}


# raw Cityscapes label ids (cityscapesScripts labels.py)
_STUFF_RAW = (7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23)
_THING_RAW = (24, 25, 26, 27, 28, 29, 30, 31, 32, 33)  # 29, 30: ignored in eval
_VOID_RAW = 0
_CROWD_RAW = 24  # a person group: thing pixels without an instance


def segments_frame(g: np.random.Generator, hw: Tuple[int, int], things: int,
                    block: int = 128) -> Tuple[np.ndarray, np.ndarray]:
    """(raw label ids [H, W] uint8, instance ids [H, W] int64) of one frame."""
    h, w = hw
    coarse = g.choice(_STUFF_RAW, (-(-h // block), -(-w // block)))
    raw = np.repeat(np.repeat(coarse, block, 0), block, 1)[:h, :w].astype(np.uint8)
    raw[:max(h // 32, 1)] = _VOID_RAW
    inst = raw.astype(np.int64)
    cy, cx = int(g.integers(0, h - h // 8)), int(g.integers(0, w - w // 8))
    raw[cy:cy + h // 10, cx:cx + w // 12] = _CROWD_RAW
    inst[cy:cy + h // 10, cx:cx + w // 12] = _CROWD_RAW
    count: Dict[int, int] = {}
    for _ in range(things):
        c = int(g.choice(_THING_RAW))
        th, tw = int(g.integers(h // 40, h // 6)), int(g.integers(w // 80, w // 10))
        y0, x0 = int(g.integers(0, h - th)), int(g.integers(0, w - tw))
        n = count.get(c, 0)
        count[c] = n + 1
        raw[y0:y0 + th, x0:x0 + tw] = c
        inst[y0:y0 + th, x0:x0 + tw] = c * 1000 + n
    return raw, inst


def write_segments_tree(root, seed: int, frames: Dict[str, int] = None,
                        hw: Tuple[int, int] = (1024, 2048), cities: int = 2,
                        things: int = 40) -> Dict[str, str]:
    """The tree described above; ``frames`` per split (default 16 train, 2
    val). Returns ``{"cityscapes_root": ...}``."""
    from ..data.cityscapes import ID_TO_TRAIN_ID

    frames = frames or {"train": 16, "val": 2}
    root = Path(root) / "cityscapes"
    g = np.random.default_rng(seed)
    h, w = hw
    for split, n_frames in frames.items():
        images: list = []
        annotations: list = []
        for i in range(n_frames):
            city = f"city{i % cities}"
            stem = f"{city}_{i:06d}_000019"
            gt = root / "gtFine" / split / city
            _save(root / "leftImg8bit" / split / city / f"{stem}_leftImg8bit.png", _image(g, hw))
            raw, inst = segments_frame(g, hw, things)
            _save(gt / f"{stem}_gtFine_labelTrainIds.png", ID_TO_TRAIN_ID[raw])
            _save(gt / f"{stem}_gtFine_instanceIds.png", inst.astype(np.uint16))
            # panoptic: segments of the evaluated classes; things by instance,
            # stuff and crowds by raw id; the rest 0
            pan = np.where(ID_TO_TRAIN_ID[raw] != 255, inst, 0)
            ids, areas = np.unique(pan, return_counts=True)
            segments = [{"id": int(s_id), "category_id": int(s_id // 1000 if s_id >= 1000
                                                                 else s_id),
                         "area": int(a), "iscrowd": int(s_id == _CROWD_RAW)}
                        for s_id, a in zip(ids, areas) if s_id]
            rgb = np.stack([pan % 256, pan // 256 % 256, pan // 65536], -1).astype(np.uint8)
            pan_name = f"{stem}_gtFine_panoptic.png"
            _save(root / "gtFine" / f"cityscapes_panoptic_{split}" / pan_name, rgb)
            images.append({"id": stem, "file_name": f"{stem}_leftImg8bit.png",
                           "height": h, "width": w})
            annotations.append({"image_id": stem, "file_name": pan_name,
                                "segments_info": segments})
        with open(root / "gtFine" / f"cityscapes_panoptic_{split}.json", "w") as f:
            json.dump({"images": images, "annotations": annotations}, f)
    return {"cityscapes_root": str(root)}
