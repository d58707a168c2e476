"""SEResNeXt-50/101 trunks: squeeze-excitation and grouped bottlenecks.

Counterpart of ``multishiftseg_tpu/models/seresnext.py`` (the reference's
``lib/network/deepv3/SEresnext.py:69-406``): ResNeXt 32x4d bottlenecks with SE
blocks (reduction 16), a 7x7 stem, stages (3, 4, 6, 3) / (3, 4, 23, 3), and
the D variant at output stride 8 (stride 1 and dilation 2 / 4 in layer3 /
layer4). Every BatchNorm trains in training mode (running variance as flax's,
:class:`.layers.BatchNorm2d`). Module names follow the reference's
(``layer0.conv1``, ``layer0.bn1``, ``layer{s}.{b}.{conv1..3, bn1..3}``,
``layer{s}.{b}.se_module.fc1`` / ``fc2``, 1x1 convs with bias, and
``layer{s}.{b}.downsample.{0,1}``). Channels-first.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm2d, conv, max_pool_3x3_s2


class SEBlock(nn.Module):
    """Squeeze-excitation (JAX ``SEBlock``): the channel mean, fc1, ReLU, fc2,
    an f32 sigmoid, and the input scaled by it."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, channels // reduction, 1)
        self.fc2 = nn.Conv2d(channels // reduction, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.fc2(F.relu(self.fc1(x.mean(dim=(2, 3), keepdim=True))))
        return x * torch.sigmoid(s.float()).to(x.dtype)


class SEResNeXtBottleneck(nn.Module):
    """ResNeXt bottleneck (cardinality 32, base width 4) with SE; output
    ``planes * 4`` channels."""

    def __init__(self, in_channels: int, planes: int, stride: int = 1, dilation: int = 1,
                 cardinality: int = 32, base_width: int = 4):
        super().__init__()
        width = (planes * base_width // 64) * cardinality
        out_ch = planes * 4
        self.conv1 = conv(in_channels, width, 1)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=dilation,
                               dilation=dilation, groups=cardinality, bias=False)
        nn.init.kaiming_normal_(self.conv2.weight, mode="fan_in", nonlinearity="relu")
        self.bn2 = BatchNorm2d(width)
        self.conv3 = conv(width, out_ch, 1)
        self.bn3 = BatchNorm2d(out_ch)
        self.se_module = SEBlock(out_ch)
        self.downsample = (nn.Sequential(conv(in_channels, out_ch, 1, stride=stride),
                                         BatchNorm2d(out_ch))
                           if in_channels != out_ch or stride != 1 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.se_module(self.bn3(self.conv3(out)))
        return F.relu(out + shortcut)


SERESNEXT_STAGES = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


class SEResNeXt(nn.Module):
    """[N, 3, H, W] -> {'layer0': s4, 'layer1': s4, 'layer2': s8, 'layer3',
    'layer4'} (s8 and s8 at output stride 8, s16 and s32 otherwise)."""

    def __init__(self, depth: int = 50, output_stride: int = 8):
        super().__init__()
        if depth not in SERESNEXT_STAGES:
            raise ValueError(f"SEResNeXt depth {depth} not in {sorted(SERESNEXT_STAGES)}")
        self.layer0 = nn.Module()
        self.layer0.conv1 = conv(3, 64, 7, stride=2)
        self.layer0.bn1 = BatchNorm2d(64)
        in_ch, planes = 64, 64
        for stage_idx, blocks in enumerate(SERESNEXT_STAGES[depth]):
            if output_stride == 8 and stage_idx >= 2:
                stride, dilation = 1, (2 if stage_idx == 2 else 4)
            else:
                stride, dilation = (1 if stage_idx == 0 else 2), 1
            layer = []
            for b in range(blocks):
                layer.append(SEResNeXtBottleneck(in_ch, planes, stride if b == 0 else 1,
                                                 dilation))
                in_ch = planes * 4
            self.add_module(f"layer{stage_idx + 1}", nn.Sequential(*layer))
            planes *= 2

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = max_pool_3x3_s2(F.relu(self.layer0.bn1(self.layer0.conv1(x))))
        feats = {"layer0": x}
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
            feats[f"layer{i}"] = x
        return feats
