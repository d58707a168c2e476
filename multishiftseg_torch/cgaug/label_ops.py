"""Label-space editing for CG-Aug: palette remapping + road-aware anomaly pasting.

Behavioural port of the reference ``CGAug/generation_utils.py:59-259`` (vectorized
where the reference loops): Cityscapes color labels are remapped into the ADE20K
palette (so the seg-conditioned diffusion model understands them), then an anomaly
object mask is rescaled to 200-500 px and pasted onto road pixels inside a shrinking
safe margin.

Counterpart of ``multishiftseg_tpu/cgaug/label_ops.py``: the same
``np.random.Generator`` gives the same label and mask, bit for bit. The object's
rescale is OpenCV's ``INTER_NEAREST`` with ``fx`` / ``fy``
(``data/image_ops.py::resize_nearest_scale``); the port does not import OpenCV.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..data.image_ops import resize_nearest_scale

from .palettes import (
    ADE20K_CLASSES, ADE20K_PALETTE, CITY2ADE_CATEGORY, CITYSCAPES_ALL_CLASSES,
    CITYSCAPES_ALL_PALETTE, ade20k_color,
)


def cityscapes_to_ade20k(city_label: np.ndarray) -> Tuple[np.ndarray, List[str]]:
    """Remap a Cityscapes RGB color label into the ADE20K palette.

    Returns the remapped label and the list of Cityscapes categories present.
    """
    ade_label = city_label.copy()
    present: List[str] = []
    for idx, category in enumerate(CITYSCAPES_ALL_CLASSES):
        city_rgb = np.asarray(CITYSCAPES_ALL_PALETTE[idx], np.uint8)
        ade_class = CITY2ADE_CATEGORY[category]
        ade_rgb = (
            np.asarray(ADE20K_PALETTE[ADE20K_CLASSES.index(ade_class)], np.uint8)
            if ade_class
            else np.zeros(3, np.uint8)
        )
        mask = np.all(city_label == city_rgb, axis=-1)
        if mask.any():
            present.append(category)
            ade_label[mask] = ade_rgb
    return ade_label, present


def paste_on_road(
    label: np.ndarray,
    anomaly_mask: np.ndarray,
    anomaly_rgb: np.ndarray,
    rng: np.random.Generator,
    safe_margin: int = 150,
    min_size: int = 200,
    max_size: int = 500,
) -> np.ndarray:
    """Paste an anomaly shape (in label space) onto a random road pixel.

    The paste center is sampled among road pixels inside a safe margin that shrinks in
    10px steps (down to 10px) if no candidates exist; the object's longer side is
    rescaled into [min_size, max_size].
    """
    road_rgb = ade20k_color("road")
    road_pixels = np.all(label == road_rgb, axis=-1)

    road_coords = np.empty((0, 2), np.int64)
    margin = safe_margin
    while margin >= 10:
        mark = np.zeros_like(road_pixels)
        mark[margin:-margin, margin:-margin] = True
        road_coords = np.column_stack(np.where(road_pixels & mark))
        if len(road_coords):
            break
        margin -= 10
    if len(road_coords) == 0:
        return label

    center_y, center_x = road_coords[int(rng.integers(len(road_coords)))]

    ys, xs = np.where(anomaly_mask == 1)
    if ys.size == 0:
        return label
    min_x, max_x = xs.min(), xs.max()
    min_y, max_y = ys.min(), ys.max()
    crop = anomaly_mask[min_y : max_y + 1, min_x : max_x + 1]
    longer = max(crop.shape)
    target = max(min(max_size, longer), min_size)
    scale = target / longer
    crop = resize_nearest_scale(crop, scale, scale)

    h, w = label.shape[:2]
    start_y = max(center_y - crop.shape[0] // 2, 0)
    start_x = max(center_x - crop.shape[1] // 2, 0)
    end_y = min(start_y + crop.shape[0], h)
    end_x = min(start_x + crop.shape[1], w)
    m = (crop == 1)[: end_y - start_y, : end_x - start_x]

    out = label.copy()
    out[start_y:end_y, start_x:end_x][m] = anomaly_rgb
    return out


def paste_anomaly(
    label: np.ndarray,
    anomaly_mask: np.ndarray,
    ood_class: str,
    rng: np.random.Generator,
    min_size: int = 200,
    max_size: int = 500,
) -> Tuple[np.ndarray, np.ndarray]:
    """Paste an anomaly of ADE20K class ``ood_class`` and return the pasted label +
    final anomaly mask (recomputed from the label, like the reference).
    ``min_size``/``max_size`` bound the pasted longer side in pixels (the
    reference's 200-500 defaults assume 1024x2048 labels)."""
    rgb = ade20k_color(ood_class)
    pasted = paste_on_road(label, anomaly_mask, rgb, rng,
                           min_size=min_size, max_size=max_size)
    final_mask = np.all(pasted == rgb, axis=-1).astype(np.uint8)
    return pasted, final_mask
