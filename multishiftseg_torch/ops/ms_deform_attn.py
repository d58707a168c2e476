"""Multi-scale deformable attention: the CUDA kernels, their plain versions, the module.

Counterpart of ``multishiftseg_tpu/ops/ms_deform_attn.py``: ``ms_deform_attn_core``
(:36-83) in every sample mode, the int8 value table (:130-139, :221-225), the
custom VJP ``_core_vjp_fwd`` / ``_core_vjp_bwd`` (:565-716) and ``MSDeformAttn``
(:795-870). The kernels are in ``csrc/ms_deform_attn.cu`` (the ``bilinear`` and
``nearest`` forwards, the int8 table's quantize and forward, the ``bilinear``
backward) and ``csrc/ms_deform_attn_approx.cu`` (``nearest_top{T}``,
``nearest_top{T}c``, ``shared``). One forward kernel serves ``bilinear``,
``nearest`` and the int8 table: a block takes one (image, head) and copies that
head's rows of the first levels (the coarsest) into shared memory;
:func:`forward_staged_levels` picks how many. The top-T kernel selects once a
head, one lane a point.

Sample modes (:func:`parse_sample_mode`):

* ``bilinear``: exact (``grid_sample`` with zero padding, ``align_corners=False``),
  the default; with ``quantize_table`` the value table is int8 with one scale
  per channel over (N, S, M), folded into the corner weights.
* ``nearest``: each point's nearest pixel, dropped outside the half-pixel border.
* ``nearest_top{T}``: per head the T highest in-map weights of the J = L * P
  points, renormalised to the head's in-map mass, at their nearest pixels.
* ``nearest_top{T}c``: the T points keep their exact weights, and each (head,
  level) adds one nearest row at the mass-weighted centroid of its other points,
  carrying their mass.
* ``shared``: per (query, level, point) one location for all heads, the heads'
  attention-weighted centroid; each head keeps its own weights.

Each kernel entry is a ``torch.library`` custom op (``ops.custom_op``):
``mss::ms_deform_attn`` (``bilinear``, ``nearest``), ``mss::ms_deform_attn_quantize``,
``mss::ms_deform_attn_int8_table`` (the quantize and int8 kernels),
``mss::ms_deform_attn_approx`` and ``mss::ms_deform_attn_backward``, each with
its plain version as the CPU implementation. ``bilinear`` has a backward
kernel, joined to the forward op by ``register_autograd``, which saves
(value, loc, attn) as the JAX VJP does. With the int8 table too: JAX's custom
VJP saves the exact value whatever ``quantize_table`` is (``_core_vjp_fwd``,
:565-569), so the table's op saves the exact value and its gradients are the
exact bilinear ones, on the card and on the CPU. The other
modes are eval-only, as in JAX: on the card they raise when an input requires
grad; on the CPU autograd runs through their plain versions.

The plain versions run on the CPU and hold the kernels on the card:
``bilinear`` is the reference's per-level ``grid_sample`` formula
(``ms_deform_attn_core_pytorch``); ``nearest``, the int8 table and the other
modes follow the JAX formulas with index arithmetic and gathers in f32. The
centroids of ``nearest_top{T}c`` and ``shared`` are sums in a fixed order
(point by point, head by head) with no fused multiply-add, as the kernels take
them, so kernel and plain round a centroid alike.

Layouts as in the JAX package:
  value:               [N, S, M, D]  (S = sum_l H_l * W_l)
  sampling_locations:  [N, Lq, M, L, P, 2]  normalised (x, y) in [0, 1]
  attention_weights:   [N, Lq, M, L, P]
  output:              [N, Lq, M * D]
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from . import autograd_enabled, custom_op

SAMPLE_MODES = ("bilinear", "nearest", "nearest_top{T}", "nearest_top{T}c", "shared")
MAX_POINTS = 32  # J = L * P a head: one warp's lanes in the top-T kernel's selection
# the shared memory a block of the forward kernel may stage (an
# H100's 227 KB)
SMEM_BUDGET = 232448

# Kernel launches per entry point (see ``ops.launch_counts``).
LAUNCHES = {"ms_deform_attn_bilinear": 0, "ms_deform_attn_nearest": 0,
            "ms_deform_attn_bilinear_backward": 0, "ms_deform_attn_quantize": 0,
            "ms_deform_attn_int8": 0, "ms_deform_attn_nearest_top": 0,
            "ms_deform_attn_nearest_topc": 0, "ms_deform_attn_shared": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def parse_sample_mode(mode: str, n_samples: Optional[int] = None) -> Tuple[str, int]:
    """One deformable sample mode -> (kind, T): kind ``bilinear``, ``nearest``,
    ``nearest_top``, ``nearest_topc`` or ``shared``, T the points kept a head
    (0 for the modes that keep all). Accepts what JAX's ``build_m2f_forward``
    accepts (``test_runner.py:359-368``); with ``n_samples`` = L * P given,
    rejects T outside 1..L * P, as JAX asserts (``ms_deform_attn.py:332``)."""
    if mode in ("bilinear", "nearest", "shared"):
        return mode, 0
    if isinstance(mode, str) and mode.startswith("nearest_top"):
        spec = mode[len("nearest_top"):]
        kind = "nearest_top"
        if spec.endswith("c"):
            spec, kind = spec[:-1], "nearest_topc"
        if spec.isdigit():
            top = int(spec)
            if top < 1 or (n_samples is not None and top > n_samples):
                raise ValueError(f"sample_mode {mode!r}: T = {top} is outside 1.."
                                 f"{n_samples if n_samples is not None else 'L * P'}")
            return kind, top
    raise ValueError(f"unknown sample_mode {mode!r}; expected one of {SAMPLE_MODES}")


def parse_eval_sample_mode(spec: str, n_samples: Optional[int] = None
                           ) -> Tuple[Union[str, Tuple[str, ...]], bool]:
    """An evaluator's ``--sample_mode`` -> (the model's ``deform_sample_mode``,
    ``quantize_deform_table``), as JAX's ``build_m2f_forward`` reads it
    (``test_runner.py:370-382``): ``int8`` is ``bilinear`` over an int8 table;
    a comma-separated list is a per-encoder-layer hybrid of single modes; else
    one mode for every layer."""
    if spec == "int8":
        return "bilinear", True
    if "," in spec:
        modes = tuple(s.strip() for s in spec.split(","))
        for s in modes:
            parse_sample_mode(s, n_samples)
        return modes, False
    parse_sample_mode(spec, n_samples)
    return spec, False


def ms_deform_attn_core(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                        sampling_locations: torch.Tensor,
                        attention_weights: torch.Tensor,
                        sample_mode: str = "bilinear",
                        quantize_table: bool = False) -> torch.Tensor:
    """Deformable attention core: the custom ops, whose CUDA implementations
    launch the kernels and whose CPU implementations are the plain versions.
    ``quantize_table`` (``bilinear`` only; JAX ignores it in the other modes,
    the port refuses it there) takes one int8 scale per channel over the whole
    batch, as JAX's op does."""
    spatial_shapes = _shapes(spatial_shapes)
    L, P = sampling_locations.shape[3:5]
    kind, top = parse_sample_mode(sample_mode, L * P)
    levels = _level_list(spatial_shapes)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (value, sampling_locations, attention_weights))
    if quantize_table:
        if kind != "bilinear":
            raise ValueError(f"quantize_table applies to the bilinear mode, not {sample_mode!r}")
        return torch.ops.mss.ms_deform_attn_int8_table(value, sampling_locations,
                                                       attention_weights, levels)
    if kind != "bilinear" and grad:
        if value.device.type == "cpu":
            return ms_deform_attn_core_plain(value, spatial_shapes, sampling_locations,
                                             attention_weights, sample_mode)
        _refuse_grad(sample_mode)
    if kind in ("bilinear", "nearest"):
        return torch.ops.mss.ms_deform_attn(value, sampling_locations, attention_weights,
                                            levels, kind == "nearest")
    return torch.ops.mss.ms_deform_attn_approx(value, sampling_locations, attention_weights,
                                               levels, kind, top)


def _refuse_grad(sample_mode):
    raise RuntimeError(f"ms_deform_attn_core: {sample_mode!r} has no backward kernel; "
                       "train with 'bilinear' or run under torch.no_grad()")


def ms_deform_attn_backward(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                            sampling_locations: torch.Tensor,
                            attention_weights: torch.Tensor, grad_out: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of the bilinear core for ``grad_out`` [N, Lq, M * D] ->
    (d value [N, S, M, D] in value's type, d loc f32, d attn in attn's type):
    the ``mss::ms_deform_attn_backward`` op, the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    return torch.ops.mss.ms_deform_attn_backward(
        value, sampling_locations, attention_weights, grad_out,
        _level_list(_shapes(spatial_shapes)))


def ms_deform_attn_backward_plain(value, spatial_shapes, sampling_locations,
                                  attention_weights, grad_out):
    """Plain version of :func:`ms_deform_attn_backward`: autograd of the f32
    ``grid_sample`` formula."""
    with autograd_enabled():
        v = value.detach().float().requires_grad_()
        loc = sampling_locations.detach().float().requires_grad_()
        a = attention_weights.detach().float().requires_grad_()
        out = _bilinear_plain(v, _shapes(spatial_shapes), loc, a)
        dv, dl, da = torch.autograd.grad(out, (v, loc, a), grad_out.float())
    return (dv.to(value.dtype).contiguous(), dl.to(sampling_locations.dtype).contiguous(),
            da.to(attention_weights.dtype).contiguous())


def ms_deform_attn_core_plain(value: torch.Tensor,
                              spatial_shapes: Sequence[Tuple[int, int]],
                              sampling_locations: torch.Tensor,
                              attention_weights: torch.Tensor,
                              sample_mode: str = "bilinear",
                              quantize_table: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`ms_deform_attn_core`, in f32.

    ``bilinear`` is per-level ``F.grid_sample`` and a weighted sum (the
    reference's formula, and autograd's route to the backward's plain
    version). The other modes are the JAX formulas' index arithmetic and
    gathers (:func:`_nearest_plain`, :func:`_nearest_topk_plain`,
    :func:`_shared_plain`, and for the int8 table
    :func:`quantize_value_table_plain` with :func:`_bilinear_int8_plain`), so
    they round a point to its pixel exactly as JAX does, half-pixel ties
    included (``floor(x + 0.5)``).
    """
    spatial_shapes = _shapes(spatial_shapes)
    n, s, m, d = value.shape
    _, lq, _, L, P, _ = sampling_locations.shape
    kind, top = parse_sample_mode(sample_mode, L * P)
    if sum(h * w for h, w in spatial_shapes) != s or len(spatial_shapes) != L:
        raise ValueError(f"spatial_shapes {spatial_shapes} do not match L={L}, S={s}")
    if quantize_table:
        if kind != "bilinear":
            raise ValueError(f"quantize_table applies to the bilinear mode, not {sample_mode!r}")
        qvalue, scale = quantize_value_table_plain(value)
        out = _bilinear_int8_plain(qvalue, scale, spatial_shapes, sampling_locations,
                                   attention_weights)
    elif kind in ("nearest_top", "nearest_topc"):
        out = _nearest_topk_plain(value, spatial_shapes, sampling_locations,
                                  attention_weights, top, kind == "nearest_topc")
    elif kind == "shared":
        out = _shared_plain(value, spatial_shapes, sampling_locations, attention_weights)
    elif kind == "nearest":
        out = _nearest_plain(value, spatial_shapes, sampling_locations, attention_weights)
    else:
        out = _bilinear_plain(value, spatial_shapes, sampling_locations, attention_weights)
    return out.to(value.dtype)


def _bilinear_plain(value, spatial_shapes, sampling_locations, attention_weights):
    """The reference's per-level ``grid_sample`` formula."""
    n, s, m, d = value.shape
    _, lq, _, L, P, _ = sampling_locations.shape
    value_list = value.float().split([h * w for h, w in spatial_shapes], dim=1)
    grids = 2 * sampling_locations.float() - 1
    sampled = []
    for lid, (h, w) in enumerate(spatial_shapes):
        v = value_list[lid].flatten(2).transpose(1, 2).reshape(n * m, d, h, w)
        g = grids[:, :, :, lid].transpose(1, 2).flatten(0, 1)  # [N*M, Lq, P, 2]
        sampled.append(F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                                     align_corners=False))  # [N*M, D, Lq, P]
    attn = attention_weights.float().transpose(1, 2).reshape(n * m, 1, lq, L * P)
    out = (torch.stack(sampled, dim=-2).flatten(-2) * attn).sum(-1)
    return out.view(n, m * d, lq).transpose(1, 2).contiguous()


# ---------------------------------------------------------------------------
# index arithmetic of the plain versions (the JAX formulas)


def _level_consts(spatial_shapes, device):
    """Per level, as [L, 1] tensors: width and height (f32), width and the
    level's first row in S (int64)."""
    hw = np.asarray(spatial_shapes, np.int64).reshape(-1, 2)
    start = np.concatenate([[0], np.cumsum(hw[:, 0] * hw[:, 1])[:-1]])
    f = lambda a, t: torch.as_tensor(a, dtype=t, device=device)[:, None]
    return (f(hw[:, 1], torch.float32), f(hw[:, 0], torch.float32),
            f(hw[:, 1], torch.int64), f(start, torch.int64))


def _pixel(loc_x, loc_y, wf, hf):
    """Normalised (x, y) -> pixel coordinates ``x * W - 0.5`` (a multiply and a
    subtract, each rounded: no fused multiply-add, as the kernels)."""
    return loc_x * wf - 0.5, loc_y * hf - 0.5


def _nearest_pixel(x, y, wf, hf):
    """(ix, iy) = clamp(floor(x + 0.5)) as int64, and whether the point lies
    inside the half-pixel border (``_core_forward_nearest``'s zero padding)."""
    ix = torch.minimum(torch.clamp(torch.floor(x + 0.5), min=0.0), wf - 1).long()
    iy = torch.minimum(torch.clamp(torch.floor(y + 0.5), min=0.0), hf - 1).long()
    inb = (x > -0.5) & (x < wf - 0.5) & (y > -0.5) & (y < hf - 0.5)
    return ix, iy, inb


def _value_rows(n, s, m, pix, head_axis):
    """Rows of value viewed as [N * S * M, D] for per-image pixel offsets
    ``pix`` [N, Lq, M, ...]: ((n * S + pix) * M + m)."""
    shape = [1] * pix.dim()
    shape[0] = n
    nn_ = torch.arange(n, device=pix.device).view(shape)
    shape = [1] * pix.dim()
    shape[head_axis] = m
    mm = torch.arange(m, device=pix.device).view(shape)
    return (nn_ * s + pix) * m + mm


def _ordered_sum(terms):
    """Sum of a list of tensors, left to right (the kernels' order)."""
    acc = torch.zeros_like(terms[0])
    for t in terms:
        acc = acc + t
    return acc


def _nearest_plain(value, spatial_shapes, loc, attn):
    """``_core_forward_nearest`` (:236-301): each point's nearest pixel
    ``clamp(floor(x + 0.5))``, its weight zeroed outside the half-pixel border."""
    n, s, m, d = value.shape
    _, lq, _, L, P, _ = loc.shape
    wf, hf, wi, start = _level_consts(spatial_shapes, value.device)
    loc = loc.float()
    x, y = _pixel(loc[..., 0], loc[..., 1], wf, hf)
    ix, iy, inb = _nearest_pixel(x, y, wf, hf)
    rows = _value_rows(n, s, m, start + iy * wi + ix, 2)
    g = value.reshape(n * s * m, d).float()[rows.reshape(-1)].view(n, lq, m, L * P, d)
    w = torch.where(inb, attn.float(), 0.0).reshape(n, lq, m, L * P, 1)
    return (g * w).sum(3).reshape(n, lq, m * d)


def _nearest_topk_plain(value, spatial_shapes, loc, attn, top, centroid):
    """``_core_forward_nearest_topk`` (:304-372) and, with ``centroid``,
    ``_core_forward_nearest_topk_centroid`` (:375-478). The selection is a
    stable descending sort of each head's J in-map weights (out-of-map points
    zeroed first): equal weights keep the lower index, as ``jax.lax.top_k``."""
    n, s, m, d = value.shape
    _, lq, _, L, P, _ = loc.shape
    J = L * P
    wf, hf, wi, start = _level_consts(spatial_shapes, value.device)
    loc = loc.float()
    x, y = _pixel(loc[..., 0], loc[..., 1], wf, hf)  # [N, Lq, M, L, P]
    ix, iy, inb = _nearest_pixel(x, y, wf, hf)
    rows = _value_rows(n, s, m, start + iy * wi + ix, 2).reshape(n, lq, m, J)
    a = torch.where(inb, attn.float(), 0.0).reshape(n, lq, m, J)
    order = torch.sort(a, dim=-1, descending=True, stable=True).indices[..., :top]
    a_sel = a.gather(-1, order)
    rows_sel = rows.gather(-1, order)
    if not centroid:
        weights = a_sel * (a.sum(-1, keepdim=True)
                           / a_sel.sum(-1, keepdim=True).clamp_min(1e-12))
    else:
        kept = torch.zeros_like(a).scatter_(-1, order, 1.0)
        tail = (a * (1.0 - kept)).reshape(n, lq, m, L, P)
        mass = _ordered_sum([tail[..., p] for p in range(P)])  # [N, Lq, M, L]
        sx = _ordered_sum([tail[..., p] * loc[..., p, 0] for p in range(P)])
        sy = _ordered_sum([tail[..., p] * loc[..., p, 1] for p in range(P)])
        inv = 1.0 / mass.clamp_min(1e-12)
        safe = mass > 1e-12
        # zero-mass tails park mid-map with weight 0 (the index stays in bounds)
        cx = torch.where(safe, sx * inv, 0.5)
        cy = torch.where(safe, sy * inv, 0.5)
        xt, yt = _pixel(cx, cy, wf[:, 0], hf[:, 0])
        ixt, iyt, inb_t = _nearest_pixel(xt, yt, wf[:, 0], hf[:, 0])
        rows_t = _value_rows(n, s, m, start[:, 0] + iyt * wi[:, 0] + ixt, 2)
        weights = torch.cat([a_sel, torch.where(inb_t, mass, 0.0)], -1)
        rows_sel = torch.cat([rows_sel, rows_t], -1)
    g = value.reshape(n * s * m, d).float()[rows_sel.reshape(-1)]
    out = (g.view(n, lq, m, -1, d) * weights[..., None]).sum(3)
    return out.reshape(n, lq, m * d)


def _shared_plain(value, spatial_shapes, loc, attn):
    """``_core_forward_shared`` (:481-562): per (query, level, point) the heads'
    attention-weighted centroid, rounded to its nearest pixel; the [M * D] row
    there, each head with its exact weight; a centroid outside the half-pixel
    border drops the point for every head."""
    n, s, m, d = value.shape
    _, lq, _, L, P, _ = loc.shape
    wf, hf, wi, start = _level_consts(spatial_shapes, value.device)
    loc = loc.float()
    a = attn.float()  # [N, Lq, M, L, P]
    asum = _ordered_sum([a[:, :, h] for h in range(m)])  # [N, Lq, L, P]
    sx = _ordered_sum([loc[:, :, h, ..., 0] * a[:, :, h] for h in range(m)])
    sy = _ordered_sum([loc[:, :, h, ..., 1] * a[:, :, h] for h in range(m)])
    inv = 1.0 / asum.clamp_min(1e-12)
    x, y = _pixel(sx * inv, sy * inv, wf, hf)
    ix, iy, inb = _nearest_pixel(x, y, wf, hf)
    nn_ = torch.arange(n, device=value.device).view(n, 1, 1, 1)
    rows = value.reshape(n * s, m * d).float()[(nn_ * s + start + iy * wi + ix).reshape(-1)]
    w = torch.where(inb[:, :, None], a, 0.0).reshape(n, lq, m, L * P)
    out = (rows.view(n, lq, L * P, m, d) * w.transpose(2, 3)[..., None]).sum(2)
    return out.reshape(n, lq, m * d)


def quantize_value_table(value: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 value table (``ms_deform_attn.py:135-139``): per channel ``d``
    the scale ``max(|v|) / 127`` over (N, S, M), floored at 1e-12, and
    ``clip(round(v / scale), -127, 127)`` as int8 (round half to even, IEEE
    division) -> (int8 [N, S, M, D], f32 scale [D]). The CUDA kernel for CUDA
    tensors, bit for bit the plain version; the plain version for CPU tensors
    (the ``mss::ms_deform_attn_quantize`` op)."""
    return torch.ops.mss.ms_deform_attn_quantize(value)


def quantize_value_table_plain(value):
    """Plain version of :func:`quantize_value_table`."""
    v = value.float()
    amax = v.abs().amax(dim=(0, 1, 2))
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which is not the IEEE quotient
    scale = (amax / torch.full_like(amax, 127.0)).clamp_min(1e-12)
    # a NaN propagates to its channel's scale and quotients; NaN -> 0 in the
    # table, as XLA converts it (a cast alone leaves it undefined)
    q = torch.clamp(torch.round(v / scale), -127, 127).nan_to_num(0.0)
    return q.to(torch.int8), scale


def _bilinear_int8_plain(qvalue, scale, spatial_shapes, loc, attn):
    """The bilinear forward over the int8 table (``_core_forward`` with
    ``quantize_table``): four corner gathers a point, each corner weight
    (attention x the two bilinear factors, 0 for a corner outside the map) times
    the channel's scale, summed in f32."""
    n, s, m, d = qvalue.shape
    _, lq, _, L, P, _ = loc.shape
    wf, hf, wi, start = _level_consts(spatial_shapes, qvalue.device)
    loc = loc.float()
    x, y = _pixel(loc[..., 0], loc[..., 1], wf, hf)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    a = attn.float()
    table = qvalue.reshape(n * s * m, d)
    out = torch.zeros(n, lq, m, d, dtype=torch.float32, device=qvalue.device)
    for dy in (0, 1):
        for dx in (0, 1):
            cx, cy = x0 + dx, y0 + dy
            inside = (cx >= 0) & (cx < wf) & (cy >= 0) & (cy < hf)
            w = (a * (fy if dy else 1 - fy)) * (fx if dx else 1 - fx)
            w = torch.where(inside, w, 0.0)
            ix = torch.minimum(cx.clamp(min=0), wf - 1).long()
            iy = torch.minimum(cy.clamp(min=0), hf - 1).long()
            rows = _value_rows(n, s, m, start + iy * wi + ix, 2)
            g = table[rows.reshape(-1)].float().view(n, lq, m, L * P, d)
            out += (g * (w.reshape(n, lq, m, L * P, 1) * scale)).sum(3)
    return out.reshape(n, lq, m * d)


# ---------------------------------------------------------------------------
# the CUDA wrappers


def _shapes(spatial_shapes):
    return tuple(tuple(int(v) for v in hw) for hw in spatial_shapes)


def _level_list(spatial_shapes):
    """((h, w), ...) -> [h0, w0, h1, w1, ...], the ops' ``int[] levels``."""
    return [v for hw in spatial_shapes for v in hw]


def _level_pairs(levels):
    return tuple(zip(levels[0::2], levels[1::2]))


def _check_core_args(value, spatial_shapes, loc, attn, value_dtypes=tuple(_DTYPE_CODE)):
    if value.dtype not in value_dtypes:
        raise TypeError(f"value dtype {value.dtype} not in {list(value_dtypes)}")
    if attn.dtype not in _DTYPE_CODE:
        raise TypeError(f"attention weights dtype {attn.dtype} not in {list(_DTYPE_CODE)}")
    if value.dtype in _DTYPE_CODE and attn.dtype != value.dtype:
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


def staged_levels(spatial_shapes: Sequence[Tuple[int, int]], head_dim: int,
                  dtype: torch.dtype, smem_budget: int = SMEM_BUDGET) -> int:
    """How many levels, from the first (the coarsest, as the model orders
    them), the forward kernel stages in shared memory: as many as fit in
    ``smem_budget`` bytes with one head's rows of ``head_dim`` channels of
    ``dtype`` (bf16, f32, or the int8 table's). Zero when a row is not a whole
    number of 16-byte pieces (the kernel copies rows in 16-byte pieces)."""
    row = head_dim * torch.empty((), dtype=dtype).element_size()
    if row % 16:
        return 0
    staged, used = 0, 0
    for h, w in spatial_shapes:
        used += h * w * row
        if used > smem_budget:
            break
        staged += 1
    return staged


def forward_staged_levels(table: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                          nearest: bool = False) -> int:
    """The levels a forward launch stages for this value table [N, S, M, D]
    (bf16, f32 or the int8 table): none for ``nearest`` (one row a point:
    staging ran no faster on the H100, PERF.md) or for a table that is not
    16-byte aligned (staging copies 16-byte pieces), else :func:`staged_levels`."""
    if nearest or table.data_ptr() % 16:
        return 0
    return staged_levels(spatial_shapes, table.shape[-1], table.dtype)


def _levels(spatial_shapes):
    return (ctypes.c_int * (2 * len(spatial_shapes)))(*[v for hw in spatial_shapes for v in hw])


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _ms_deform_attn_cuda(value, spatial_shapes, loc, attn, sample_mode):
    """``bilinear`` or ``nearest`` on the card, staging the levels
    :func:`forward_staged_levels` picks."""
    n, s, m, d, lq, L, P = _check_core_args(value, spatial_shapes, loc, attn)
    from .._build import function

    nearest = sample_mode == "nearest"
    fn = function("ms_deform_attn", "msda_forward",
                  [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                  + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    out = torch.empty((n, lq, m * d), dtype=value.dtype, device=value.device)
    staged = forward_staged_levels(value, spatial_shapes, nearest)
    with torch.cuda.device(value.device):
        rc = fn(value.data_ptr(), loc.data_ptr(), attn.data_ptr(), out.data_ptr(),
                n, s, m, d, lq, L, P, _levels(spatial_shapes), _DTYPE_CODE[value.dtype],
                int(nearest), staged, _stream(value.device))
    if rc != 0:
        raise RuntimeError(f"msda_forward failed: cudaError {rc}")
    LAUNCHES["ms_deform_attn_nearest" if nearest else "ms_deform_attn_bilinear"] += 1
    return out


# device index -> the most blocks msda_quantize launches there (its scratch rows)
_QUANTIZE_BLOCKS = {}


def _quantize_cuda(value):
    """The quantize kernel: one launch, no zeroed buffer. The scale [D] is a
    view of one f32 buffer whose tail is the kernel's scratch (a partial max
    a block and channel)."""
    if value.dtype not in _DTYPE_CODE or value.dim() != 4 or not value.is_contiguous():
        raise ValueError(f"expected a contiguous f32 or bf16 value [N, S, M, D], got "
                         f"{value.dtype} {tuple(value.shape)}")
    from .._build import function

    fn = function("ms_deform_attn", "msda_quantize",
                  [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p])
    d = value.shape[-1]
    dev = value.device
    with torch.cuda.device(dev):
        blocks = _QUANTIZE_BLOCKS.get(dev.index)
        if blocks is None:
            blocks = function("ms_deform_attn", "msda_quantize_max_blocks", [])()
            if blocks < 1:
                raise RuntimeError("msda_quantize_max_blocks failed")
            _QUANTIZE_BLOCKS[dev.index] = blocks
        qvalue = torch.empty(value.shape, dtype=torch.int8, device=dev)
        buf = torch.empty(d * (1 + blocks), dtype=torch.float32, device=dev)
        rc = fn(value.data_ptr(), qvalue.data_ptr(), buf.data_ptr(), buf.data_ptr() + 4 * d,
                blocks, value.numel() // max(d, 1), d, _DTYPE_CODE[value.dtype], _stream(dev))
    if rc != 0:
        raise RuntimeError(f"msda_quantize failed: cudaError {rc}")
    LAUNCHES["ms_deform_attn_quantize"] += 1
    return qvalue, buf[:d]


def _ms_deform_attn_int8_cuda(qvalue, scale, spatial_shapes, loc, attn):
    """The bilinear forward over the int8 table on the card, staging the
    levels :func:`forward_staged_levels` picks."""
    n, s, m, d, lq, L, P = _check_core_args(qvalue, spatial_shapes, loc, attn,
                                            value_dtypes=(torch.int8,))
    if (scale.dtype != torch.float32 or tuple(scale.shape) != (d,)
            or scale.device != qvalue.device):
        raise ValueError(f"expected an f32 scale [{d}] on {qvalue.device}")
    from .._build import function

    fn = function("ms_deform_attn", "msda_forward_int8",
                  [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                  + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    out = torch.empty((n, lq, m * d), dtype=attn.dtype, device=qvalue.device)
    staged = forward_staged_levels(qvalue, spatial_shapes)
    with torch.cuda.device(qvalue.device):
        rc = fn(qvalue.data_ptr(), scale.data_ptr(), loc.data_ptr(), attn.data_ptr(),
                out.data_ptr(), n, s, m, d, lq, L, P, _levels(spatial_shapes),
                _DTYPE_CODE[attn.dtype], staged, _stream(qvalue.device))
    if rc != 0:
        raise RuntimeError(f"msda_forward_int8 failed: cudaError {rc}")
    LAUNCHES["ms_deform_attn_int8"] += 1
    return out


def _ms_deform_attn_approx_cuda(value, spatial_shapes, loc, attn, kind, top):
    n, s, m, d, lq, L, P = _check_core_args(value, spatial_shapes, loc, attn)
    if L * P > MAX_POINTS:
        raise ValueError(f"the {kind} kernel takes at most {MAX_POINTS} points a head, "
                         f"got L * P = {L * P}")
    from .._build import function

    head = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_int]
    if kind == "shared":
        fn = function("ms_deform_attn_approx", "msda_forward_shared", head + [ctypes.c_void_p])
        extra = ()
    else:
        fn = function("ms_deform_attn_approx", "msda_forward_topk",
                      head + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        extra = (top, int(kind == "nearest_topc"))
    out = torch.empty((n, lq, m * d), dtype=value.dtype, device=value.device)
    with torch.cuda.device(value.device):
        rc = fn(value.data_ptr(), loc.data_ptr(), attn.data_ptr(), out.data_ptr(),
                n, s, m, d, lq, L, P, _levels(spatial_shapes), _DTYPE_CODE[value.dtype],
                *extra, _stream(value.device))
    if rc != 0:
        raise RuntimeError(f"msda_forward_{kind} failed: cudaError {rc}")
    LAUNCHES[f"ms_deform_attn_{kind}"] += 1
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
        rc = fn(value.data_ptr(), loc.data_ptr(), attn.data_ptr(), grad_out.data_ptr(),
                dvalue.data_ptr(), dloc.data_ptr(), dattn.data_ptr(),
                n, s, m, d, lq, L, P, _levels(spatial_shapes), _DTYPE_CODE[value.dtype],
                _stream(value.device))
    if rc != 0:
        raise RuntimeError(f"msda_backward failed: cudaError {rc}")
    LAUNCHES["ms_deform_attn_bilinear_backward"] += 1
    return dvalue.to(value.dtype), dloc, dattn


# ---------------------------------------------------------------------------
# the custom ops: plain versions on the CPU, the kernels on the card


def _core_plain(value, loc, attn, levels, nearest):
    return ms_deform_attn_core_plain(value, _level_pairs(levels), loc, attn,
                                     "nearest" if nearest else "bilinear")


def _core_cuda(value, loc, attn, levels, nearest):
    return _ms_deform_attn_cuda(value, _level_pairs(levels), loc, attn,
                                "nearest" if nearest else "bilinear")


def _core_fake(value, loc, attn, levels, nearest):
    n, _, m, d = value.shape
    return value.new_empty((n, loc.shape[1], m * d))


def _core_setup(ctx, inputs, output):
    value, loc, attn, levels, nearest = inputs
    ctx.levels, ctx.nearest = levels, nearest
    ctx.save_for_backward(value, loc, attn)


def _core_backward(ctx, grad_out):
    if ctx.nearest:
        _refuse_grad("nearest")
    value, loc, attn = ctx.saved_tensors
    dvalue, dloc, dattn = torch.ops.mss.ms_deform_attn_backward(value, loc, attn, grad_out,
                                                                ctx.levels)
    return dvalue, dloc, dattn, None, None


_CORE_ARGS = "Tensor value, Tensor sampling_locations, Tensor attention_weights, int[] levels"

custom_op("ms_deform_attn", f"({_CORE_ARGS}, bool nearest) -> Tensor",
          _core_plain, _core_cuda, _core_fake, _core_backward, _core_setup)


def _backward_fake(value, loc, attn, grad_out, levels):
    return (torch.empty_like(value), torch.empty_like(loc, dtype=torch.float32),
            torch.empty_like(attn))


custom_op("ms_deform_attn_backward",
          "(Tensor value, Tensor sampling_locations, Tensor attention_weights, "
          "Tensor grad_out, int[] levels) -> (Tensor, Tensor, Tensor)",
          lambda value, loc, attn, grad_out, levels: ms_deform_attn_backward_plain(
              value, _level_pairs(levels), loc, attn, grad_out),
          lambda value, loc, attn, grad_out, levels: _ms_deform_attn_backward_cuda(
              value, _level_pairs(levels), loc, attn, grad_out),
          _backward_fake)

custom_op("ms_deform_attn_quantize", "(Tensor value) -> (Tensor, Tensor)",
          lambda value: quantize_value_table_plain(value), lambda value: _quantize_cuda(value),
          lambda value: (torch.empty_like(value, dtype=torch.int8),
                         value.new_empty(value.shape[-1:], dtype=torch.float32)))


def _int8_table_cuda(value, loc, attn, levels):
    qvalue, scale = _quantize_cuda(value)
    return _ms_deform_attn_int8_cuda(qvalue, scale, _level_pairs(levels), loc,
                                     attn).to(value.dtype)


def _int8_table_setup(ctx, inputs, output):
    _core_setup(ctx, (*inputs, False), output)


def _int8_table_backward(ctx, grad_out):
    return _core_backward(ctx, grad_out)[:4]


# ``bilinear`` over the int8 table: the quantize and int8 kernels forward; the
# exact bilinear backward on the saved exact value, as JAX's custom VJP takes it
custom_op("ms_deform_attn_int8_table", f"({_CORE_ARGS}) -> Tensor",
          lambda value, loc, attn, levels: ms_deform_attn_core_plain(
              value, _level_pairs(levels), loc, attn, "bilinear", quantize_table=True),
          _int8_table_cuda,
          lambda value, loc, attn, levels: _core_fake(value, loc, attn, levels, False),
          _int8_table_backward, _int8_table_setup)


def _approx_mode(kind, top):
    """(kind, T) -> the sample mode string of the plain versions."""
    if kind == "shared":
        return kind
    return f"nearest_top{top}" + ("c" if kind == "nearest_topc" else "")


custom_op("ms_deform_attn_approx", f"({_CORE_ARGS}, str kind, int top) -> Tensor",
          lambda value, loc, attn, levels, kind, top: ms_deform_attn_core_plain(
              value, _level_pairs(levels), loc, attn, _approx_mode(kind, top)),
          lambda value, loc, attn, levels, kind, top: _ms_deform_attn_approx_cuda(
              value, _level_pairs(levels), loc, attn, kind, top),
          lambda value, loc, attn, levels, kind, top: _core_fake(value, loc, attn, levels,
                                                                 False))


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

    def sampling(self, query: torch.Tensor, reference_points: torch.Tensor,
                 input_flatten: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]]
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The core's inputs: (value [N, S, M, D], sampling locations
        [N, Lq, M, L, P, 2] f32, attention weights [N, Lq, M, L, P] in value's
        type)."""
        value = self.value(input_flatten)
        loc, attn = self.locations(query, reference_points, spatial_shapes)
        return value, loc, attn.to(value.dtype)

    def value(self, input_flatten: torch.Tensor) -> torch.Tensor:
        """The value table [N, S, M, D] of tokens [N, S, C]."""
        n = input_flatten.shape[0]
        m = self.n_heads
        return self.value_proj(input_flatten).view(n, -1, m, self.d_model // m)

    def locations(self, query: torch.Tensor, reference_points: torch.Tensor,
                  spatial_shapes: Sequence[Tuple[int, int]]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(sampling locations [N, Lq, M, L, P, 2] f32, attention weights
        [N, Lq, M, L, P] f32) of queries [N, Lq, C]."""
        n, lq, _ = query.shape
        m, L, P = self.n_heads, self.n_levels, self.n_points
        offsets = self.sampling_offsets(query).view(n, lq, m, L, P, 2)
        attn = self.attention_weights(query).view(n, lq, m, L * P)
        attn = F.softmax(attn.float(), dim=-1).view(n, lq, m, L, P)
        normalizer = torch.tensor([[w, h] for (h, w) in spatial_shapes],
                                  dtype=torch.float32, device=query.device)
        loc = (reference_points[:, :, None, :, None, :].float()
               + offsets.float() / normalizer[None, None, None, :, None, :])
        return loc, attn

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor,
                input_flatten: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                sample_mode: str = "bilinear", quantize_table: bool = False) -> torch.Tensor:
        """query [N, Lq, C], reference_points [N, Lq, L, 2] in [0, 1],
        input_flatten [N, S, C] -> [N, Lq, C]."""
        value, loc, attn = self.sampling(query, reference_points, input_flatten, spatial_shapes)
        out = ms_deform_attn_core(value, spatial_shapes, loc, attn, sample_mode, quantize_table)
        return self.output_proj(out)
