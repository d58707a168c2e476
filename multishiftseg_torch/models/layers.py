"""Shared building blocks.

Counterpart of ``multishiftseg_tpu/models/layers.py`` (``Conv`` and its routing
:25-94, ``BNReLU`` :112-150, ``max_pool_3x3_s2``, ``global_avg_pool``,
``Dropout2d``, ``MLP``). ``Conv2d`` follows detectron2's, which owns its norm
(and optional activation) so that ``state_dict`` keys read ``<conv>.weight`` and
``<conv>.norm.*`` as in the reference checkpoints; :func:`conv` is the JAX
package's ``Conv`` for the DeepLab trunk and heads.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..core.mesh import process_count, spans_ranks
from ..ops.dilated_conv import dilated_conv3x3


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` followed by an optional ``norm`` child and activation."""

    def __init__(self, *args, norm: Optional[nn.Module] = None,
                 activation: Optional[Callable] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.norm = norm
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = super().forward(x)
        if self.norm is not None:
            x = self.norm(x)
        if self.activation is not None:
            x = self.activation(x)
        return x


def he_normal_(conv: nn.Conv2d) -> nn.Conv2d:
    """The JAX package's conv init (flax ``he_normal``: fan-in, gain 2)."""
    nn.init.kaiming_normal_(conv.weight, mode="fan_in", nonlinearity="relu")
    if conv.bias is not None:
        nn.init.zeros_(conv.bias)
    return conv


class MLP(nn.Module):
    """ReLU MLP head (reference ``mask2former_transformer_decoder.py:266-278``)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        dims_in = [input_dim] + [hidden_dim] * (num_layers - 1)
        dims_out = [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims_in, dims_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class DilatedConv2d(nn.Conv2d):
    """A 3x3, stride-1, bias-free convolution at a square dilation >= 8 through
    :func:`~multishiftseg_torch.ops.dilated_conv.dilated_conv3x3` (its CUDA
    kernels on the card), as the JAX ``Conv`` routes it (``layers.py:43-55``).
    The weight keeps ``nn.Conv2d``'s [Cout, Cin, 3, 3] layout and name. Under
    autocast the input is cast to the autocast type and the f32 weight to the
    input's, as the JAX module casts both to its ``dtype``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if torch.is_autocast_enabled(x.device.type):
            x = x.to(torch.get_autocast_dtype(x.device.type))
        y = dilated_conv3x3(x.permute(0, 2, 3, 1), self.weight.permute(2, 3, 1, 0),
                            self.dilation[0])
        return y.permute(0, 3, 1, 2)


def conv(cin: int, cout: int, k: int, stride: int = 1, dilation: int = 1) -> nn.Conv2d:
    """The JAX ``Conv``: bias-free, padding ``dilation * (k // 2)``, ``he_normal``
    init. A 3x3 stride-1 convolution at dilation >= 8 is a :class:`DilatedConv2d`;
    every other one (the trunk's dilation 2 and 4 included) an ``nn.Conv2d``."""
    cls = DilatedConv2d if (k == 3 and stride == 1 and dilation >= 8) else nn.Conv2d
    return he_normal_(cls(cin, cout, k, stride=stride, padding=dilation * (k // 2),
                          dilation=dilation, bias=False))


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm (eps 1e-5, momentum 0.1 = flax's 0.9) whose running variance takes
    the biased batch variance, as flax's ``BatchNorm`` does; torch's takes the
    unbiased one. Training normalises with the batch statistics, as both do.
    There is no ``num_batches_tracked`` buffer (the momentum is fixed), so the
    state dict maps one to one onto the JAX tree."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.num_batches_tracked = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if spans_ranks():
            return self._global_batch_norm(x)
        # batch_norm updates copies (autograd may save them), then the buffers
        # take them; torch added momentum * unbiased var, and the biased var is
        # unbiased * (n - 1) / n
        mean, var = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.copy_(mean)
            self.running_var.copy_(var - (var - (1 - self.momentum) * self.running_var) / n)
        return y

    def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        """Training over the global batch of a process group
        (:class:`_GlobalBatchNorm`), the running statistics updated with the
        global mean and flax's biased variance. Not ``nn.SyncBatchNorm``,
        whose running variance is the unbiased one."""
        y, mean, invstd = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps)
        with torch.no_grad():
            var = (invstd.double().pow(-2) - self.eps).clamp_min(0)
            self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1 - self.momentum).add_(self.momentum * var)
        return y

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # skip _NormBase's, which adds a num_batches_tracked entry to old state dicts
        nn.Module._load_from_state_dict(self, state_dict, prefix, *args, **kwargs)


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the global batch, as ``nn.SyncBatchNorm``
    computes it: each rank's mean and inverse standard deviation
    (``torch.batch_norm_stats``), gathered with the counts and combined
    (``batch_norm_gather_stats_with_counts``: the biased variance), then the
    normalisation (``batch_norm_elemt``); backward, the local sums of dy and
    dy (x - mean) (``batch_norm_backward_reduce``), one all-reduce of both,
    then ``batch_norm_backward_elemt``. These are CUDA-only; CPU tensors take
    their plain versions. Returns (y, mean, invstd), the last two f32 (x's
    type on the CPU) and not differentiable. The incoming gradient is
    summed over the ranks by the all-reduce; the scale's and bias's stay
    local, for DDP to average."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        # channels-last stays so (DeepLab on the card), as SyncBatchNorm keeps it
        ctx.fmt = (torch.channels_last if x.is_contiguous(memory_format=torch.channels_last)
                   else torch.contiguous_format)
        x = x.contiguous(memory_format=ctx.fmt)
        c = x.shape[1]
        if x.is_cuda:
            mean, invstd = torch.batch_norm_stats(x, eps)
        else:
            var, mean = torch.var_mean(x, (0, 2, 3), correction=0)
            invstd = torch.rsqrt(var + eps)
        local = torch.cat([mean, invstd, mean.new_full((1,), x.numel() // c)])
        parts = [torch.empty_like(local) for _ in range(process_count())]
        dist.all_gather(parts, local)
        gathered = torch.stack(parts)
        means, invstds, counts = gathered[:, :c], gathered[:, c:2 * c], gathered[:, 2 * c]
        if x.is_cuda:
            # throwaway running statistics: without them the kernel reads the
            # counts in x's type, which in bf16 cannot hold them
            mean, invstd = torch.batch_norm_gather_stats_with_counts(
                x, means, invstds, torch.zeros_like(mean), torch.ones_like(mean), 0.0, eps,
                counts)
            w, b = (weight.float(), bias.float()) if x.dtype != mean.dtype else (weight, bias)
            y = torch.batch_norm_elemt(x, w, b, mean, invstd, eps)
        else:
            n = counts.sum()
            mean = (means * counts[:, None]).sum(0) / n
            var = ((invstds.pow(-2) - eps + (means - mean).pow(2)) * counts[:, None]).sum(0) / n
            invstd = torch.rsqrt(var + eps)
            y = (x - mean[:, None, None]) * (invstd * weight)[:, None, None] + bias[:, None, None]
        ctx.save_for_backward(x, weight, mean, invstd, counts)
        ctx.mark_non_differentiable(mean, invstd)
        return y, mean, invstd

    @staticmethod
    def backward(ctx, dy, _dmean, _dinvstd):
        x, weight, mean, invstd, counts = ctx.saved_tensors
        dy = dy.contiguous(memory_format=ctx.fmt)
        c = x.shape[1]
        if x.is_cuda:
            w = weight.float() if x.dtype != mean.dtype else weight
            sum_dy, sum_dy_xmu, dw, db = torch.batch_norm_backward_reduce(
                dy, x, mean, invstd, w, True, True, True)
        else:
            xmu = x - mean[:, None, None]
            sum_dy, sum_dy_xmu = dy.sum((0, 2, 3)), (dy * xmu).sum((0, 2, 3))
            dw, db = sum_dy_xmu * invstd, sum_dy
        both = torch.cat([sum_dy, sum_dy_xmu])
        dist.all_reduce(both)
        sum_dy, sum_dy_xmu = both[:c], both[c:]
        if x.is_cuda:
            dx = torch.batch_norm_backward_elemt(dy, x, mean, invstd, w, sum_dy, sum_dy_xmu,
                                                 counts.int())
        else:
            n = counts.sum()
            dx = ((dy - (sum_dy / n)[:, None, None]
                   - xmu * (invstd.pow(2) * sum_dy_xmu / n)[:, None, None])
                  * (invstd * weight)[:, None, None])
        return dx, dw.to(weight.dtype), db.to(weight.dtype), None


def bn_relu(channels: int) -> nn.Sequential:
    """The reference's ``bnrelu`` (``wider_resnet.py:43-48``): keys ``<name>.0.*``."""
    return nn.Sequential(BatchNorm2d(channels), nn.ReLU())


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """torch ``MaxPool2d(3, stride=2, padding=1)``."""
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """[N, C, H, W] -> [N, C, 1, 1]."""
    return x.mean(dim=(2, 3), keepdim=True)


class Dropout2d(nn.Module):
    """Channel dropout, flax ``nn.Dropout(broadcast_dims=(1, 2))``: in training,
    ``x / (1 - p)`` on the kept channels and 0 elsewhere. The keep mask [N, C, 1, 1]
    (bool) is an input, drawn by :meth:`draw_mask` from the caller's generator, so
    that a test can hand both frameworks the same masks."""

    def __init__(self, p: float, channels: int):
        super().__init__()
        self.p, self.channels = p, channels

    def draw_mask(self, batch: int, generator: Optional[torch.Generator],
                  device) -> torch.Tensor:
        u = torch.rand((batch, self.channels, 1, 1), generator=generator, device=device)
        return u < 1.0 - self.p

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if mask is None:
            raise ValueError("Dropout2d in training needs its keep mask (draw_mask)")
        return torch.where(mask, x / (1.0 - self.p), x.new_zeros(()))
