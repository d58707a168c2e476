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
"""

from __future__ import annotations

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
