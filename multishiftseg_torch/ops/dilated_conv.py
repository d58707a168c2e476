"""Large-dilation 3x3 convolution: the CUDA kernels, their plain version, the autograd.

Counterpart of ``multishiftseg_tpu/ops/dilated_conv.py:19-52`` (``dilated_conv3x3``),
the ASPP's rate-12/24/36 convolutions. The kernels are in ``csrc/dilated_conv.cu``:
an implicit-GEMM forward and the weight gradient, as the custom ops
``mss::dilated_conv3x3`` and ``mss::dilated_conv3x3_backward`` (``ops.custom_op``;
the plain version is their CPU implementation), joined by ``register_autograd``.
The backward op computes the weight gradient with the second kernel and, only
when autograd asks for it, the input gradient with the forward kernel on the
flipped, transposed weight at the same rate. The plain
version is the JAX package's formula: nine zero-padded shifted products summed
in f32, the weight cast to the input's type first, one rounding at the end.

Layouts as in the JAX package:
  x:      [N, H, W, Cin]
  kernel: [3, 3, Cin, Cout]  (HWIO)
  output: [N, H, W, Cout]
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch
import torch.nn.functional as F

from .. import _build
from . import autograd_enabled, custom_op

# Kernel launches per entry point (see ``ops.launch_counts``).
LAUNCHES = {"dilated_conv3x3": 0, "dilated_conv3x3_wgrad": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def tap_windows(h: int, w: int, rate: int) -> List[Tuple[int, int, slice, slice, slice, slice]]:
    """(ky, kx, src rows, src cols, dst rows, dst cols) of the taps whose shift
    leaves part of the map inside it: ``out[dst] += x[src] @ W[ky, kx]``."""
    taps = []
    for ky in range(3):
        for kx in range(3):
            dy, dx = (ky - 1) * rate, (kx - 1) * rate
            sy0, sy1 = max(dy, 0), h + min(dy, 0)
            sx0, sx1 = max(dx, 0), w + min(dx, 0)
            if sy0 >= sy1 or sx0 >= sx1:
                continue
            taps.append((ky, kx, slice(sy0, sy1), slice(sx0, sx1),
                         slice(max(-dy, 0), h + min(-dy, 0)), slice(max(-dx, 0), w + min(-dx, 0))))
    return taps


def dilated_conv3x3(x: torch.Tensor, kernel: torch.Tensor, rate: int) -> torch.Tensor:
    """3x3 convolution at dilation ``rate``, stride 1, zero padding ``rate``, no
    bias: the CUDA kernels for CUDA tensors, the plain version for CPU tensors
    (the ``mss::dilated_conv3x3`` op). The kernel is cast to ``x``'s type; the
    gradient reaches it in its own type."""
    return torch.ops.mss.dilated_conv3x3(x, kernel, int(rate))


def dilated_conv3x3_plain(x: torch.Tensor, kernel: torch.Tensor, rate: int) -> torch.Tensor:
    """Plain version: the in-map part of each tap as one product, summed in f32
    (float64 stays float64) and rounded once to ``x``'s type."""
    n, h, w, _ = x.shape
    acc = torch.promote_types(x.dtype, torch.float32)
    k = kernel.to(x.dtype).to(acc)
    xa = x.to(acc)
    out = torch.zeros((n, h, w, kernel.shape[-1]), dtype=acc, device=x.device)
    for ky, kx, sy, sx, dy, dx in tap_windows(h, w, rate):
        out[:, dy, dx] += torch.einsum("nhwc,cd->nhwd", xa[:, sy, sx], k[ky, kx])
    return out.to(x.dtype)


def _tap_major(kernel: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[3, 3, Cin, Cout] -> the kernels' [9, Cout, Cin], contiguous, in ``dtype``."""
    cin, cout = kernel.shape[2:]
    return kernel.to(dtype).permute(0, 1, 3, 2).reshape(9, cout, cin).contiguous()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _pad_last(t: torch.Tensor, to: int) -> torch.Tensor:
    return t if t.shape[-1] == to else F.pad(t, (0, to - t.shape[-1]))


def _round8(v: int) -> int:
    return -(-v // 8) * 8


def _check(x: torch.Tensor, other: torch.Tensor, name: str):
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"dtype {x.dtype} not in {list(_DTYPE_CODE)}")
    if other.dtype != x.dtype or other.device != x.device:
        raise TypeError(f"{name} is {other.dtype} on {other.device}, x {x.dtype} on {x.device}")
    if x.dim() != 4:
        raise ValueError(f"expected x [N, H, W, C], got {tuple(x.shape)}")


_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def dilated_conv3x3_forward(x: torch.Tensor, wk: torch.Tensor, rate: int) -> torch.Tensor:
    """The forward kernel: x [N, H, W, Cin], tap-major weight [9, Cout, Cin] in
    x's type -> [N, H, W, Cout]. bf16 takes channel counts that are multiples of
    8; others are zero-padded here (never on the main path)."""
    _check(x, wk, "weight")
    n, h, w, cin = x.shape
    cout = wk.shape[1]
    if tuple(wk.shape) != (9, cout, cin):
        raise ValueError(f"weight {tuple(wk.shape)} does not match x {tuple(x.shape)}")
    cin_p = _round8(cin) if x.dtype == torch.bfloat16 else cin
    x = _aligned(_pad_last(x, cin_p))
    wk = _aligned(_pad_last(wk, cin_p))
    out = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    fn = _build.function("dilated_conv", "dconv_forward", _ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), wk.data_ptr(), out.data_ptr(), n, h, w, cin_p, cout, int(rate),
                _DTYPE_CODE[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"dconv_forward failed: cudaError {rc}")
    LAUNCHES["dilated_conv3x3"] += 1
    return out


def dilated_conv3x3_wgrad(x: torch.Tensor, grad_out: torch.Tensor, rate: int) -> torch.Tensor:
    """The weight-gradient kernel: x [N, H, W, Cin], grad_out [N, H, W, Cout] in
    x's type -> d weight [9, Cout, Cin] f32 (tap = 3 * ky + kx)."""
    _check(x, grad_out, "grad_out")
    n, h, w, cin = x.shape
    cout = grad_out.shape[-1]
    if tuple(grad_out.shape[:3]) != (n, h, w):
        raise ValueError(f"grad_out {tuple(grad_out.shape)} does not match x {tuple(x.shape)}")
    bf16 = x.dtype == torch.bfloat16
    cin_p, cout_p = (_round8(cin), _round8(cout)) if bf16 else (cin, cout)
    x = _aligned(_pad_last(x, cin_p))
    g = _aligned(_pad_last(grad_out, cout_p))
    dw = torch.zeros((9, cout_p, cin_p), dtype=torch.float32, device=x.device)
    fn = _build.function("dilated_conv", "dconv_wgrad", _ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), g.data_ptr(), dw.data_ptr(), n, h, w, cin_p, cout_p, int(rate),
                _DTYPE_CODE[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"dconv_wgrad failed: cudaError {rc}")
    LAUNCHES["dilated_conv3x3_wgrad"] += 1
    return dw[:, :cout, :cin]


def dilated_conv3x3_wgrad_plain(x: torch.Tensor, grad_out: torch.Tensor,
                                rate: int) -> torch.Tensor:
    """Plain version of :func:`dilated_conv3x3_wgrad`: per tap, the in-map
    pixels' ``g^T x`` in f32."""
    n, h, w, cin = x.shape
    cout = grad_out.shape[-1]
    acc = torch.promote_types(x.dtype, torch.float32)
    dw = torch.zeros((3, 3, cout, cin), dtype=acc, device=x.device)
    xa, ga = x.to(acc), grad_out.to(acc)
    for ky, kx, sy, sx, dy, dx in tap_windows(h, w, rate):
        dw[ky, kx] = torch.einsum("nhwd,nhwc->dc", ga[:, dy, dx], xa[:, sy, sx])
    return dw.reshape(9, cout, cin)


def dilated_conv3x3_backward_plain(x: torch.Tensor, kernel: torch.Tensor, grad_out: torch.Tensor,
                                   rate: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d x, d kernel) of :func:`dilated_conv3x3_plain` for ``grad_out``: its
    autograd."""
    with autograd_enabled():
        xg = x.detach().requires_grad_()
        kg = kernel.detach().requires_grad_()
        dx, dk = torch.autograd.grad(dilated_conv3x3_plain(xg, kg, rate), (xg, kg),
                                     grad_out.to(x.dtype))
    return dx.contiguous(), dk.contiguous()


# ---------------------------------------------------------------------------
# the custom ops: plain versions on the CPU, the kernels on the card


def _forward_cuda(x, kernel, rate):
    return dilated_conv3x3_forward(x, _tap_major(kernel, x.dtype), rate)


def _backward_cuda(x, kernel, grad_out, rate, want_dx, want_dk):
    """d x = the forward kernel on the flipped taps (shift -> -shift) with the
    in / out channels swapped, at the same rate; d kernel = the weight-gradient
    kernel's f32 sums, cast once to the kernel's type."""
    g = grad_out.to(x.dtype).contiguous()
    wk = _tap_major(kernel, x.dtype)
    dx = dk = None
    if want_dx:
        dx = dilated_conv3x3_forward(g, wk.flip(0).transpose(1, 2).contiguous(), rate)
    if want_dk:
        cout, cin = wk.shape[1:]
        dw = dilated_conv3x3_wgrad(x, g, rate)  # [9, Cout, Cin] f32
        dk = dw.reshape(3, 3, cout, cin).permute(0, 1, 3, 2).to(kernel.dtype).contiguous()
    return _or_empty(dx, x), _or_empty(dk, kernel)


def _backward_plain(x, kernel, grad_out, rate, want_dx, want_dk):
    dx, dk = dilated_conv3x3_backward_plain(x, kernel, grad_out, rate)
    return _or_empty(dx if want_dx else None, x), _or_empty(dk if want_dk else None, kernel)


def _or_empty(grad, like):
    return like.new_empty(0) if grad is None else grad


def _setup(ctx, inputs, output):
    x, kernel, rate = inputs
    ctx.rate = rate
    ctx.save_for_backward(x, kernel)


def _backward(ctx, grad_out):
    x, kernel = ctx.saved_tensors
    want_dx, want_dk = ctx.needs_input_grad[:2]
    dx, dk = torch.ops.mss.dilated_conv3x3_backward(x, kernel, grad_out, ctx.rate,
                                                    want_dx, want_dk)
    return (dx if want_dx else None), (dk if want_dk else None), None


custom_op("dilated_conv3x3", "(Tensor x, Tensor kernel, int rate) -> Tensor",
          lambda x, kernel, rate: dilated_conv3x3_plain(x, kernel, rate),
          lambda x, kernel, rate: _forward_cuda(x, kernel, rate),
          lambda x, kernel, rate: x.new_empty((*x.shape[:3], kernel.shape[-1])),
          _backward, _setup)

custom_op("dilated_conv3x3_backward",
          "(Tensor x, Tensor kernel, Tensor grad_out, int rate, bool dx, bool dk) "
          "-> (Tensor, Tensor)",
          _backward_plain,
          lambda x, kernel, grad_out, rate, want_dx, want_dk: _backward_cuda(
              x, kernel, grad_out, rate, want_dx, want_dk),
          lambda x, kernel, grad_out, rate, want_dx, want_dk: (
              torch.empty_like(x) if want_dx else x.new_empty(0),
              torch.empty_like(kernel) if want_dk else kernel.new_empty(0)))
