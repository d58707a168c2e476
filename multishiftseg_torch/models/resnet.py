"""detectron2-style ResNet backbone exposing res2..res5.

Counterpart of ``multishiftseg_tpu/models/resnet.py``: the depths of
``RESNET_STAGES`` (``BasicBlock`` for 18 and 34, bottlenecks for 50, 101 and
152), strides in the 3x3 conv (STRIDE_IN_1X1=False), output stride 32 (the
Mask2Former backbone) or 8 (the DeepLab D variant: stride 1 and dilation 2 / 4
in res4 / res5). BatchNorm is frozen (running statistics only) in the
Mask2Former regime; ``trainable_bn`` makes it train-mode BatchNorm whose
running variance follows flax (:class:`.layers.BatchNorm2d`), as the DeepV3Plus
baselines train their trunk. Module names follow detectron2 (``stem.conv1``,
``res2.0.conv1``, ``res2.0.conv1.norm``, ``res2.0.shortcut``) in both regimes.
Tensors are channels-first inside the backbone.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core import tensor_parallel as tp
from .layers import BatchNorm2d, Conv2d, he_normal_


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


def _conv(cin: int, cout: int, k: int, stride: int = 1, dilation: int = 1,
          trainable_bn: bool = False) -> Conv2d:
    norm = BatchNorm2d(cout) if trainable_bn else FrozenBN(cout)
    return he_normal_(Conv2d(cin, cout, k, stride=stride, padding=dilation * (k // 2),
                             dilation=dilation, bias=False, norm=norm))


class BasicStem(nn.Module):
    """7x7/2 conv + BN + ReLU, then 3x3/2 max pool."""

    def __init__(self, out_channels: int = 64, trainable_bn: bool = False):
        super().__init__()
        self.conv1 = _conv(3, out_channels, 7, stride=2, trainable_bn=trainable_bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv1(x))
        return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


class BottleneckBlock(nn.Module):
    def __init__(self, in_channels: int, bottleneck_channels: int, out_channels: int,
                 stride: int = 1, dilation: int = 1, trainable_bn: bool = False):
        super().__init__()
        bn = dict(trainable_bn=trainable_bn)
        self.shortcut = (_conv(in_channels, out_channels, 1, stride, **bn)
                         if in_channels != out_channels or stride != 1 else None)
        self.conv1 = _conv(in_channels, bottleneck_channels, 1, **bn)
        self.conv2 = _conv(bottleneck_channels, bottleneck_channels, 3, stride, dilation, **bn)
        self.conv3 = _conv(bottleneck_channels, out_channels, 1, **bn)

    def forward(self, x):
        """``x`` whole, or its channel slices under tensor parallelism
        (``core.tensor_parallel``); the output likewise."""
        shortcut = tp.apply(self.shortcut, x)
        out = tp.relu(tp.apply(self.conv1, x))
        out = tp.relu(tp.apply(self.conv2, out))
        return tp.relu(tp.add(tp.apply(self.conv3, out), shortcut))


class BasicBlock(nn.Module):
    """3x3-3x3 residual block of ResNet-18/34 (JAX ``BasicBlock``, :69-82)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 dilation: int = 1, trainable_bn: bool = False):
        super().__init__()
        bn = dict(trainable_bn=trainable_bn)
        self.shortcut = (_conv(in_channels, out_channels, 1, stride, **bn)
                         if in_channels != out_channels or stride != 1 else None)
        self.conv1 = _conv(in_channels, out_channels, 3, stride, dilation, **bn)
        self.conv2 = _conv(out_channels, out_channels, 3, 1, dilation, **bn)

    def forward(self, x):
        shortcut = tp.apply(self.shortcut, x)
        out = tp.relu(tp.apply(self.conv1, x))
        return tp.relu(tp.add(tp.apply(self.conv2, out), shortcut))


RESNET_STAGES = {
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}
BASIC_BLOCK_DEPTHS = {18, 34}
RESNET_FEATURE_CHANNELS = {"res2": 256, "res3": 512, "res4": 1024, "res5": 2048}


def resnet_feature_channels(depth: int) -> Dict[str, int]:
    """Channels of res2..res5 at ``depth`` (64 .. 512 for the basic-block depths)."""
    base = 64 if depth in BASIC_BLOCK_DEPTHS else 256
    return {f"res{i + 2}": base * 2 ** i for i in range(4)}


class ResNet(nn.Module):
    """ResNet trunk: [N, 3, H, W] -> {'res2': s4, 'res3': s8, 'res4', 'res5'}
    (s16 and s32 at ``output_stride`` 32; s8 and s8 at 8)."""

    def __init__(self, depth: int = 50, output_stride: int = 32, trainable_bn: bool = False):
        super().__init__()
        if depth not in RESNET_STAGES:
            raise ValueError(f"ResNet depth {depth} not in {sorted(RESNET_STAGES)}")
        if output_stride not in (8, 32):
            raise ValueError(f"output_stride {output_stride}: 32 or 8")
        basic = depth in BASIC_BLOCK_DEPTHS
        self.stem = BasicStem(64, trainable_bn)
        in_ch, bottleneck = 64, 64
        out_ch = 64 if basic else 256
        for stage_idx, num_blocks in enumerate(RESNET_STAGES[depth]):
            stride, dilation = (1 if stage_idx == 0 else 2), 1
            if output_stride == 8 and stage_idx >= 2:
                stride, dilation = 1, (2 if stage_idx == 2 else 4)
            blocks = []
            for block_idx in range(num_blocks):
                s = stride if block_idx == 0 else 1
                blocks.append(
                    BasicBlock(in_ch, out_ch, s, dilation, trainable_bn) if basic
                    else BottleneckBlock(in_ch, bottleneck, out_ch, s, dilation, trainable_bn))
                in_ch = out_ch
            self.add_module(f"res{stage_idx + 2}", nn.Sequential(*blocks))
            bottleneck *= 2
            out_ch *= 2

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.stem(x)
        feats = {}
        for name in ("res2", "res3", "res4", "res5"):
            for block in getattr(self, name):
                x = block(x)
            x = tp.full(x)  # a sharded stage's output, whole
            feats[name] = x
        return feats
