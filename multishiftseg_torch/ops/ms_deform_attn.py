"""Multi-scale deformable attention: the CUDA kernels, their plain versions, the module.

Counterpart of ``multishiftseg_tpu/ops/ms_deform_attn.py`` (``ms_deform_attn_core``
:36-90, its custom VJP ``_core_vjp_fwd`` / ``_core_vjp_bwd`` :565-716 and
``MSDeformAttn`` :795-870) for the ``bilinear`` and ``nearest`` sample modes. The
kernels are in ``csrc/ms_deform_attn.cu``: the forward of both modes and the
backward of ``bilinear``, joined by a ``torch.autograd.Function`` that saves
(value, loc, attn) as the JAX VJP does. The plain version is the reference's
per-level ``grid_sample`` formula (``ms_deform_attn_core_pytorch``), and its
autograd is the plain version of the backward. ``nearest`` has no backward
kernel: on the card it raises when an input requires grad.

Layouts as in the JAX package:
  value:               [N, S, M, D]  (S = sum_l H_l * W_l)
  sampling_locations:  [N, Lq, M, L, P, 2]  normalised (x, y) in [0, 1]
  attention_weights:   [N, Lq, M, L, P]
  output:              [N, Lq, M * D]
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

SAMPLE_MODES = ("bilinear", "nearest")

# Kernel launches per sample mode (see ``ops.launch_counts``).
LAUNCHES = {"ms_deform_attn_bilinear": 0, "ms_deform_attn_nearest": 0,
            "ms_deform_attn_bilinear_backward": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def ms_deform_attn_core(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                        sampling_locations: torch.Tensor,
                        attention_weights: torch.Tensor,
                        sample_mode: str = "bilinear") -> torch.Tensor:
    """Deformable attention core: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.

    ``bilinear`` is exact (``grid_sample`` with zero padding,
    ``align_corners=False``). ``nearest`` rounds each point to its nearest pixel
    and drops points outside the half-pixel border, as the JAX
    ``_core_forward_nearest``.
    """
    if sample_mode not in SAMPLE_MODES:
        raise NotImplementedError(f"sample_mode {sample_mode!r} is not ported")
    spatial_shapes = tuple(tuple(int(v) for v in hw) for hw in spatial_shapes)
    if value.device.type == "cpu":
        return ms_deform_attn_core_plain(value, spatial_shapes, sampling_locations,
                                         attention_weights, sample_mode)
    if sample_mode == "nearest":
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (value, sampling_locations, attention_weights)):
            raise RuntimeError("ms_deform_attn_core: 'nearest' has no backward kernel; "
                               "train with 'bilinear' or run under torch.no_grad()")
        return _ms_deform_attn_cuda(value, spatial_shapes, sampling_locations,
                                    attention_weights, sample_mode)
    return _MSDeformAttnCore.apply(value, sampling_locations, attention_weights,
                                   spatial_shapes)


class _MSDeformAttnCore(torch.autograd.Function):
    """The bilinear core on the card: forward and backward kernels. Saves the
    residuals of the JAX VJP (value, loc, attn) and nothing else."""

    @staticmethod
    def forward(ctx, value, loc, attn, spatial_shapes):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, loc, attn)
        return _ms_deform_attn_cuda(value, spatial_shapes, loc, attn, "bilinear")

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        value, loc, attn = ctx.saved_tensors
        dvalue, dloc, dattn = ms_deform_attn_backward(value, ctx.spatial_shapes, loc,
                                                      attn, grad_out)
        return dvalue, dloc, dattn, None


def ms_deform_attn_backward(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                            sampling_locations: torch.Tensor,
                            attention_weights: torch.Tensor, grad_out: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of the bilinear core for ``grad_out`` [N, Lq, M * D] ->
    (d value [N, S, M, D] in value's type, d loc f32, d attn in attn's type):
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    spatial_shapes = tuple(tuple(int(v) for v in hw) for hw in spatial_shapes)
    if value.device.type == "cpu":
        return ms_deform_attn_backward_plain(value, spatial_shapes, sampling_locations,
                                             attention_weights, grad_out)
    return _ms_deform_attn_backward_cuda(value, spatial_shapes, sampling_locations,
                                         attention_weights, grad_out)


def ms_deform_attn_backward_plain(value, spatial_shapes, sampling_locations,
                                  attention_weights, grad_out):
    """Plain version of :func:`ms_deform_attn_backward`: autograd of the f32
    ``grid_sample`` formula."""
    with torch.enable_grad():
        v = value.detach().float().requires_grad_()
        loc = sampling_locations.detach().float().requires_grad_()
        a = attention_weights.detach().float().requires_grad_()
        out = ms_deform_attn_core_plain(v, spatial_shapes, loc, a, "bilinear")
        dv, dl, da = torch.autograd.grad(out, (v, loc, a), grad_out.float())
    return (dv.to(value.dtype), dl.to(sampling_locations.dtype),
            da.to(attention_weights.dtype))


def ms_deform_attn_core_plain(value: torch.Tensor,
                              spatial_shapes: Sequence[Tuple[int, int]],
                              sampling_locations: torch.Tensor,
                              attention_weights: torch.Tensor,
                              sample_mode: str = "bilinear") -> torch.Tensor:
    """Plain PyTorch version: per-level ``F.grid_sample`` and a weighted sum, in f32.

    ``nearest`` uses ``grid_sample(mode="nearest")``, which agrees with the
    kernel's ``floor(x + 0.5)`` rule everywhere except at exact half-pixel ties.
    """
    if sample_mode not in SAMPLE_MODES:
        raise NotImplementedError(f"sample_mode {sample_mode!r} is not ported")
    n, s, m, d = value.shape
    _, lq, _, L, P, _ = sampling_locations.shape
    splits = [h * w for h, w in spatial_shapes]
    if sum(splits) != s:
        raise ValueError(f"spatial_shapes {spatial_shapes} do not sum to S={s}")
    value_list = value.float().split(splits, dim=1)
    grids = 2 * sampling_locations.float() - 1
    sampled = []
    for lid, (h, w) in enumerate(spatial_shapes):
        v = value_list[lid].flatten(2).transpose(1, 2).reshape(n * m, d, h, w)
        g = grids[:, :, :, lid].transpose(1, 2).flatten(0, 1)  # [N*M, Lq, P, 2]
        sampled.append(F.grid_sample(v, g, mode=sample_mode, padding_mode="zeros",
                                     align_corners=False))  # [N*M, D, Lq, P]
    attn = attention_weights.float().transpose(1, 2).reshape(n * m, 1, lq, L * P)
    out = (torch.stack(sampled, dim=-2).flatten(-2) * attn).sum(-1)
    return out.view(n, m * d, lq).transpose(1, 2).contiguous().to(value.dtype)


def _check_core_args(value, spatial_shapes, loc, attn):
    if value.dtype not in _DTYPE_CODE:
        raise TypeError(f"value dtype {value.dtype} not in {list(_DTYPE_CODE)}")
    if attn.dtype != value.dtype:
        raise TypeError(f"attention weights {attn.dtype} != value {value.dtype}")
    if loc.dtype != torch.float32:
        raise TypeError(f"sampling locations must be float32, got {loc.dtype}")
    if value.dim() != 4 or loc.dim() != 6 or attn.dim() != 5:
        raise ValueError("expected value [N,S,M,D], loc [N,Lq,M,L,P,2], "
                         "attn [N,Lq,M,L,P]")
    n, s, m, d = value.shape
    _, lq, _, L, P, _ = loc.shape
    if tuple(loc.shape) != (n, lq, m, L, P, 2) or tuple(attn.shape) != (n, lq, m, L, P):
        raise ValueError(f"shape mismatch: value {tuple(value.shape)}, loc "
                         f"{tuple(loc.shape)}, attn {tuple(attn.shape)}")
    if len(spatial_shapes) != L or sum(h * w for h, w in spatial_shapes) != s:
        raise ValueError(f"spatial_shapes {spatial_shapes} do not match L={L}, S={s}")
    if L > 8:
        raise ValueError(f"the kernel takes at most 8 levels, got {L}")
    for name, t in (("value", value), ("loc", loc), ("attn", attn)):
        if t.device != value.device:
            raise ValueError(f"{name} on {t.device}, value on {value.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if loc.data_ptr() % 8:
        raise ValueError("sampling locations must be 8-byte aligned (read as float2)")
    return n, s, m, d, lq, L, P


def _levels(spatial_shapes):
    return (ctypes.c_int * (2 * len(spatial_shapes)))(*[v for hw in spatial_shapes for v in hw])


def _ms_deform_attn_cuda(value, spatial_shapes, loc, attn, sample_mode):
    n, s, m, d, lq, L, P = _check_core_args(value, spatial_shapes, loc, attn)
    from .._build import load

    lib = load("ms_deform_attn")
    fn = lib.msda_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    out = torch.empty((n, lq, m * d), dtype=value.dtype, device=value.device)
    nearest = sample_mode == "nearest"
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream(value.device).cuda_stream
        rc = fn(value.data_ptr(), loc.data_ptr(), attn.data_ptr(), out.data_ptr(),
                n, s, m, d, lq, L, P, _levels(spatial_shapes), _DTYPE_CODE[value.dtype],
                int(nearest), stream)
    if rc != 0:
        raise RuntimeError(f"msda_forward failed: cudaError {rc}")
    LAUNCHES["ms_deform_attn_nearest" if nearest else "ms_deform_attn_bilinear"] += 1
    return out


def _ms_deform_attn_backward_cuda(value, spatial_shapes, loc, attn, grad_out):
    n, s, m, d, lq, L, P = _check_core_args(value, spatial_shapes, loc, attn)
    if d > 128:
        raise ValueError(f"the backward kernel takes at most 128 channels a head, got {d}")
    grad_out = grad_out.to(value.dtype).contiguous()
    if tuple(grad_out.shape) != (n, lq, m * d) or grad_out.device != value.device:
        raise ValueError(f"grad_out {tuple(grad_out.shape)} on {grad_out.device}, "
                         f"expected {(n, lq, m * d)} on {value.device}")
    from .._build import load

    lib = load("ms_deform_attn")
    fn = lib.msda_backward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    # d value accumulates by atomics in f32 and is cast once to value's type
    dvalue = torch.zeros((n, s, m, d), dtype=torch.float32, device=value.device)
    dloc = torch.empty(loc.shape, dtype=torch.float32, device=value.device)
    dattn = torch.empty(attn.shape, dtype=attn.dtype, device=value.device)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream(value.device).cuda_stream
        rc = fn(value.data_ptr(), loc.data_ptr(), attn.data_ptr(), grad_out.data_ptr(),
                dvalue.data_ptr(), dloc.data_ptr(), dattn.data_ptr(),
                n, s, m, d, lq, L, P, _levels(spatial_shapes), _DTYPE_CODE[value.dtype],
                stream)
    if rc != 0:
        raise RuntimeError(f"msda_backward failed: cudaError {rc}")
    LAUNCHES["ms_deform_attn_bilinear_backward"] += 1
    return dvalue.to(value.dtype), dloc, dattn


def _sampling_offsets_bias_init(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """Directional grid init for the offset head bias (the reference's
    ``MSDeformAttn._reset_parameters``)."""
    thetas = np.arange(n_heads, dtype=np.float64) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)  # [M, 2]
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1).astype(np.float32)


class MSDeformAttn(nn.Module):
    """Deformable attention module: offset/weight heads + value/output projections
    (d_model 256, 8 heads, 4 points by default)."""

    def __init__(self, d_model: int = 256, n_levels: int = 4, n_heads: int = 8,
                 n_points: int = 4):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} not divisible by n_heads {n_heads}")
        self.d_model, self.n_levels = d_model, n_levels
        self.n_heads, self.n_points = n_heads, n_points
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.value_proj = nn.Linear(d_model, d_model)
        self.output_proj = nn.Linear(d_model, d_model)
        self.reset_parameters()

    def reset_parameters(self) -> None:
        nn.init.zeros_(self.sampling_offsets.weight)
        with torch.no_grad():
            self.sampling_offsets.bias.copy_(torch.from_numpy(
                _sampling_offsets_bias_init(self.n_heads, self.n_levels, self.n_points)))
        nn.init.zeros_(self.attention_weights.weight)
        nn.init.zeros_(self.attention_weights.bias)
        for lin in (self.value_proj, self.output_proj):
            nn.init.xavier_uniform_(lin.weight)
            nn.init.zeros_(lin.bias)

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor,
                input_flatten: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                sample_mode: str = "bilinear") -> torch.Tensor:
        """query [N, Lq, C], reference_points [N, Lq, L, 2] in [0, 1],
        input_flatten [N, S, C] -> [N, Lq, C]."""
        n, lq, _ = query.shape
        m, L, P = self.n_heads, self.n_levels, self.n_points
        value = self.value_proj(input_flatten).view(n, -1, m, self.d_model // m)
        offsets = self.sampling_offsets(query).view(n, lq, m, L, P, 2)
        attn = self.attention_weights(query).view(n, lq, m, L * P)
        attn = F.softmax(attn.float(), dim=-1).view(n, lq, m, L, P)
        normalizer = torch.tensor([[w, h] for (h, w) in spatial_shapes],
                                  dtype=torch.float32, device=query.device)
        loc = (reference_points[:, :, None, :, None, :].float()
               + offsets.float() / normalizer[None, None, None, :, None, :])
        out = ms_deform_attn_core(value, spatial_shapes, loc, attn.to(value.dtype),
                                  sample_mode)
        return self.output_proj(out)
