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
import torch.nn as nn
import torch.nn.functional as F

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

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # skip _NormBase's, which adds a num_batches_tracked entry to old state dicts
        nn.Module._load_from_state_dict(self, state_dict, prefix, *args, **kwargs)


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
