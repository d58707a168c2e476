"""Bilinear point sampling (detectron2 ``point_sample``).

Counterpart of ``multishiftseg_tpu/ops/sampling.py:52-77``. The JAX package
writes ``grid_sample`` as a four-corner gather; here it is
``F.grid_sample(mode="bilinear", padding_mode="zeros", align_corners=False)``,
the library call that computes the same function, whose autograd the training
step needs. The JAX layouts stay at the boundary: images ``[N, H, W, C]``,
points ``[N, P, 2]`` as (x, y).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """img [N, H, W, C], grid [N, P, 2] in [-1, 1] (x, y) -> [N, P, C]."""
    out = F.grid_sample(img.permute(0, 3, 1, 2), grid[:, None], mode="bilinear",
                        padding_mode="zeros", align_corners=False)  # [N, C, 1, P]
    return out[:, :, 0].transpose(1, 2)


def point_sample(img: torch.Tensor, point_coords: torch.Tensor) -> torch.Tensor:
    """img [N, H, W, C], point_coords [N, P, 2] in [0, 1] (x, y) -> [N, P, C]."""
    return grid_sample(img, 2.0 * point_coords - 1.0)


def point_sample_nchw(img: torch.Tensor, point_coords: torch.Tensor) -> torch.Tensor:
    """The same on a channels-first ``[N, C, H, W]`` map -> ``[N, C, P]``."""
    out = F.grid_sample(img, (2.0 * point_coords - 1.0)[:, None], mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out[:, :, 0]
