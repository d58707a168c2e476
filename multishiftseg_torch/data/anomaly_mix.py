"""PEBAL-style anomaly mix: paste a randomly scaled COCO object into the clean
image under label 254, and the clean / generated mixup blend.

Counterpart of ``multishiftseg_tpu/data/anomaly_mix.py`` on numpy and PIL: the
same draws from the caller's ``numpy.random.Generator`` in the same order, and
OpenCV's resizes through :mod:`.image_ops`.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
from PIL import Image

from . import image_ops as ops

IMAGENET_MEAN = np.asarray((0.485, 0.456, 0.406), np.float32)
IMAGENET_STD = np.asarray((0.229, 0.224, 0.225), np.float32)


def random_scale(img: np.ndarray, gt: np.ndarray, scales: Sequence[float],
                 rng: np.random.Generator):
    """Resize a raw float32 0-255 image (bilinear) and its uint8 mask (nearest)
    by a factor drawn from ``scales``."""
    scale = scales[rng.integers(len(scales))]
    size = (int(img.shape[0] * scale), int(img.shape[1] * scale))
    return ops.resize_linear(img, size), ops.resize_nearest(gt, size)


def mix_object(image: np.ndarray, mask: np.ndarray, cut_img: np.ndarray,
               cut_mask: np.ndarray, rng: np.random.Generator, normalized: bool = True):
    """Paste the cut object's pixels and label values (mask values other than 0
    and 255) at a random place of ``image`` [H, W, 3] f32 and ``mask`` [H, W],
    in place. ``cut_img`` is raw 0-255 f32, normalised first when
    ``normalized``. An object larger than the image is not pasted."""
    obj = (cut_mask != 0) & (cut_mask != 255)
    ys, xs = np.where(obj)
    if ys.size == 0:
        return image, mask
    y1, y2 = ys.min(), ys.max() + 1
    x1, x2 = xs.min(), xs.max() + 1
    cut_mask = cut_mask[y1:y2, x1:x2]
    cut_img = cut_img[y1:y2, x1:x2]
    ch, cw = cut_mask.shape
    if ch > mask.shape[0] or cw > mask.shape[1]:
        return image, mask
    if normalized:
        cut_img = (cut_img.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    hs = int(rng.integers(0, mask.shape[0] - ch + 1))
    ws = int(rng.integers(0, mask.shape[1] - cw + 1))
    sel = (cut_mask != 0) & (cut_mask != 255)
    image[hs:hs + ch, ws:ws + cw][sel] = cut_img[sel]
    mask[hs:hs + ch, ws:ws + cw][sel] = cut_mask[sel]
    return image, mask


def paste_coco_objects(image: np.ndarray, mask: np.ndarray, coco_images: List[str],
                       coco_targets: List[str], ood_scale_array: Sequence[float],
                       rng: np.random.Generator):
    """Pick a COCO cut-out, scale it and paste it into the normalised clean
    image."""
    idx = int(rng.integers(len(coco_images)))
    with Image.open(coco_images[idx]) as im:
        ood_image = np.asarray(im.convert("RGB"), np.float32)
    with Image.open(coco_targets[idx]) as im:
        ood_target = np.asarray(im.convert("L"), np.uint8)
    scaled_img, scaled_gt = random_scale(ood_image, ood_target, ood_scale_array, rng)
    return mix_object(image, mask, scaled_img, scaled_gt, rng)


def mixup_generated(image: np.ndarray, gen_image: np.ndarray, rng: np.random.Generator,
                    max_coeff: float = 0.3) -> np.ndarray:
    """Blend the clean uint8 image into the generated one with coefficient
    min(U(0, 1), 0.3), in float32, truncated back to uint8."""
    p = min(rng.random(), max_coeff)
    out = np.multiply(image, p, dtype=np.float32)
    out += np.multiply(gen_image, 1 - p, dtype=np.float32)
    return out.astype(np.uint8)
