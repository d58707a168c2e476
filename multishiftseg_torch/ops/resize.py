"""Bilinear resize with torch ``F.interpolate`` semantics, and nearest resize.

Counterpart of ``multishiftseg_tpu/ops/resize.py:93-174``. The JAX package builds
interpolation matrices (``_interp_matrix``) so the TPU runs resizes as matmuls;
both follow torch's source-coordinate rule (``align_corners=False``: src =
(i + 0.5) * in / out - 0.5, edge-clamped; ``True``: src = i * (in - 1) /
(out - 1)), which ``F.interpolate`` implements directly. No antialiasing, so a
downsample is the same 2-tap rule. :func:`resize_bilinear_antialias` is
``jax.image.resize(..., "bilinear")`` instead (SAM's predictor, CG-Aug), which
widens the triangle kernel by the downsampling factor. The nearest resize takes its source
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


def resize_bilinear_antialias(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Resize the trailing ``[H, W]`` axes of an ``[N, C, H, W]`` tensor as
    ``jax.image.resize(..., "bilinear")`` does: half-pixel centres and, on a
    downsampling axis, the triangle kernel widened by the factor, its taps
    renormalised at the edges. ``F.interpolate``'s ``antialias=True`` computes
    the same weights (held against JAX to f32 rounding in
    ``tests/test_torch_sam.py``); on an upsampling axis both are the 2-tap rule."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False,
                         antialias=True)


def source_rows(in_h: int, out_h: int, rows: Tuple[int, int],
                align_corners: bool = False) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """For output rows ``rows = (row0, count)`` of a bilinear resize from
    ``in_h`` rows to ``out_h``: each row's two source rows and the weight of
    the second (``F.interpolate``'s rule, in float64), as numpy arrays."""
    r = np.arange(rows[0], rows[0] + rows[1], dtype=np.float64)
    if align_corners:
        src = r * ((in_h - 1) / (out_h - 1)) if out_h > 1 else np.zeros_like(r)
    else:
        src = np.maximum((r + 0.5) * (in_h / out_h) - 0.5, 0.0)
    i0 = np.minimum(np.floor(src).astype(np.int64), in_h - 1)
    return i0, np.minimum(i0 + 1, in_h - 1), src - i0


def resize_bilinear_rows(x: torch.Tensor, size: Tuple[int, int], rows: Tuple[int, int],
                         align_corners: bool = False, in_h: int = 0,
                         in_row0: int = 0) -> torch.Tensor:
    """Rows ``rows = (row0, count)`` of the bilinear resize of a channels-first
    ``[..., h, w]`` map to ``size``, with the whole map's coordinates: the
    windowed resize of a row-partitioned eval. ``x`` may hold only source
    rows ``[in_row0, in_row0 + h)`` of a map ``in_h`` rows tall (default: all
    of it), as long as they cover what the rows read (:func:`source_rows`).
    The vertical taps are interpolated first, then the columns."""
    h, w = x.shape[-2:]
    in_h = in_h or h
    i0, i1, ly = source_rows(in_h, size[0], rows, align_corners)
    if rows[1] and (i0.min() < in_row0 or i1.max() >= in_row0 + h):
        raise ValueError(f"output rows {rows} read source rows [{i0.min()}, {i1.max()}], "
                         f"outside the window [{in_row0}, {in_row0 + h})")
    a = x.index_select(-2, torch.from_numpy(i0 - in_row0).to(x.device))
    b = x.index_select(-2, torch.from_numpy(i1 - in_row0).to(x.device))
    lam = torch.from_numpy(ly).to(x.device, x.dtype)[:, None]
    v = a + (b - a) * lam
    if w == size[1]:
        return v
    lead = v.shape[:-2]
    y = F.interpolate(v.reshape(1, -1, rows[1], w), size=(rows[1], size[1]),
                      mode="bilinear", align_corners=align_corners)
    return y.reshape(*lead, rows[1], size[1])


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
