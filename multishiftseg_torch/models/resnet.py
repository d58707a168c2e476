"""detectron2-style ResNet backbone (R-50) exposing res2..res5.

Counterpart of ``multishiftseg_tpu/models/resnet.py`` in the Mask2Former regime:
frozen BatchNorm (running statistics only), strides in the 3x3 conv
(STRIDE_IN_1X1=False), output stride 32. Module names follow detectron2
(``stem.conv1``, ``res2.0.conv1``, ``res2.0.conv1.norm``, ``res2.0.shortcut``).
Tensors are channels-first inside the backbone.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2d, he_normal_


class FrozenBN(nn.Module):
    """BatchNorm with frozen running statistics (detectron2 ``FrozenBatchNorm2d``).

    The statistics are buffers; the affine ``weight`` and ``bias`` are parameters,
    as the JAX package's ``FrozenBN`` keeps them in ``params``, so stage-2
    fine-tuning trains them (at the backbone's rate, without weight decay).
    """

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # fold in f32, apply in the activation's type
        scale = self.weight.float() * torch.rsqrt(self.running_var.float() + self.eps)
        shift = self.bias.float() - self.running_mean.float() * scale
        return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> Conv2d:
    return he_normal_(Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False,
                             norm=FrozenBN(cout)))


class BasicStem(nn.Module):
    """7x7/2 conv + frozen BN + ReLU, then 3x3/2 max pool."""

    def __init__(self, out_channels: int = 64):
        super().__init__()
        self.conv1 = _conv(3, out_channels, 7, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv1(x))
        return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


class BottleneckBlock(nn.Module):
    def __init__(self, in_channels: int, bottleneck_channels: int, out_channels: int,
                 stride: int = 1):
        super().__init__()
        self.shortcut = (_conv(in_channels, out_channels, 1, stride)
                         if in_channels != out_channels or stride != 1 else None)
        self.conv1 = _conv(in_channels, bottleneck_channels, 1)
        self.conv2 = _conv(bottleneck_channels, bottleneck_channels, 3, stride)
        self.conv3 = _conv(bottleneck_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.shortcut is None else self.shortcut(x)
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out))
        return F.relu(self.conv3(out) + shortcut)


RESNET_STAGES = {50: (3, 4, 6, 3)}
RESNET_FEATURE_CHANNELS = {"res2": 256, "res3": 512, "res4": 1024, "res5": 2048}


class ResNet(nn.Module):
    """ResNet trunk: [N, 3, H, W] -> {'res2': s4, 'res3': s8, 'res4': s16, 'res5': s32}."""

    def __init__(self, depth: int = 50):
        super().__init__()
        if depth not in RESNET_STAGES:
            raise NotImplementedError(f"ResNet-{depth} is not ported; only R-50")
        self.stem = BasicStem(64)
        in_ch, bottleneck, out_ch = 64, 64, 256
        for stage_idx, num_blocks in enumerate(RESNET_STAGES[depth]):
            blocks = []
            for block_idx in range(num_blocks):
                stride = 2 if stage_idx > 0 and block_idx == 0 else 1
                blocks.append(BottleneckBlock(in_ch, bottleneck, out_ch, stride))
                in_ch = out_ch
            self.add_module(f"res{stage_idx + 2}", nn.Sequential(*blocks))
            bottleneck *= 2
            out_ch *= 2

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.stem(x)
        feats = {}
        for name in ("res2", "res3", "res4", "res5"):
            x = getattr(self, name)(x)
            feats[name] = x
        return feats
