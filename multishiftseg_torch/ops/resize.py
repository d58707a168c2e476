"""Bilinear resize with torch ``F.interpolate`` semantics, and nearest resize.

Counterpart of ``multishiftseg_tpu/ops/resize.py:93-174``. The JAX package builds
interpolation matrices (``_interp_matrix``) so the TPU runs resizes as matmuls;
both follow torch's source-coordinate rule (``align_corners=False``: src =
(i + 0.5) * in / out - 0.5, edge-clamped; ``True``: src = i * (in - 1) /
(out - 1)), which ``F.interpolate`` implements directly. No antialiasing, so a
downsample is the same 2-tap rule. The nearest resize takes its source
indices from the JAX package's rule (``_nearest_index``, :51), built on the host
in float64, not from ``F.interpolate``'s float32 scale.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear-resize the spatial axes of a channels-last ``[..., H, W, C]`` tensor."""
    h_in, w_in, c = x.shape[-3:]
    if (h_in, w_in) == tuple(size):
        return x
    lead = x.shape[:-3]
    y = x.reshape(-1, h_in, w_in, c).permute(0, 3, 1, 2)
    y = F.interpolate(y, size=tuple(size), mode="bilinear",
                      align_corners=align_corners)
    return y.permute(0, 2, 3, 1).reshape(*lead, *size, c)


def resize_bilinear_nchw(x: torch.Tensor, size: Tuple[int, int],
                         align_corners: bool = False) -> torch.Tensor:
    """Bilinear-resize the trailing ``[H, W]`` axes of a channels-first tensor."""
    h_in, w_in = x.shape[-2:]
    if (h_in, w_in) == tuple(size):
        return x
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape(1, -1, h_in, w_in), size=tuple(size),
                      mode="bilinear", align_corners=align_corners)
    return y.reshape(*lead, *size)


@functools.lru_cache(maxsize=256)
def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Source index per output pixel: ``floor(i * in / out)`` in float64,
    clamped to the last pixel (JAX ``ops/resize.py:51``)."""
    i = np.arange(out_size, dtype=np.float64)
    return np.minimum(np.floor(i * in_size / out_size), in_size - 1).astype(np.int64)


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize of the spatial axes of a channels-first
    ``[..., H, W]`` tensor."""
    h_in, w_in = x.shape[-2:]
    if (h_in, w_in) == tuple(size):
        return x
    ih = torch.from_numpy(_nearest_index(h_in, size[0])).to(x.device)
    iw = torch.from_numpy(_nearest_index(w_in, size[1])).to(x.device)
    return x.index_select(-2, ih).index_select(-1, iw)
