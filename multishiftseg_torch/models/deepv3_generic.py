"""Generic DeepLab v3+ over ResNet / SEResNeXt trunks (the reference's ``DeepV3Plus``).

Counterpart of ``multishiftseg_tpu/models/deepv3_generic.py`` (the reference's
``lib/network/deepv3/deepv3.py:95-201`` and builders :288-314): a trunk in the D
variant (output stride 8), the ASPP (2048 -> 256, rates 12 / 24 / 36: its three
dilated 3x3 convs run through ``ops.dilated_conv``, CUDA kernels on the card),
the m1 skip from the stride-4 map (256 -> 48) and a 3-conv ``final`` head. No
OOD head: this is the closed-set baseline. The ResNet trunk trains its
BatchNorm (``trainable_bn``), as the baselines do.

``state_dict`` keys: ``trunk.*`` (the port's ResNet names, ``trunk.stem.conv1``,
``trunk.res2.0.conv1.norm``, ...; or SEResNeXt's, ``trunk.layer0.conv1``, ...),
``aspp.features.{0..3}.{0,1}``, ``aspp.img_conv.{0,1}``, ``bot_fine``,
``bot_aspp``, ``final.{0,1,3,4,6}``. Input [N, 3, H, W]; output logits
[N, C, H, W] f32, upsampled bilinearly (``align_corners=True``) to the input.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .deeplab import ASPP
from .layers import BatchNorm2d, conv
from .resnet import ResNet, resnet_feature_channels
from .seresnext import SEResNeXt

TRUNKS = ("resnet-50", "resnet-101", "seresnext-50", "seresnext-101")


def _up(x: torch.Tensor, size) -> torch.Tensor:
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True)


class DeepV3Plus(nn.Module):
    def __init__(self, num_classes: int = 19, trunk: str = "resnet-50", skip_num: int = 48):
        super().__init__()
        kind, _, depth = trunk.partition("-")
        if kind == "resnet" and depth.isdigit():
            self.trunk = ResNet(int(depth), output_stride=8, trainable_bn=True)
            chans = resnet_feature_channels(int(depth))
            self.low_name, self.top_name = "res2", "res5"
            low_ch, top_ch = chans["res2"], chans["res5"]
        elif kind == "seresnext" and depth.isdigit():
            self.trunk = SEResNeXt(int(depth))
            self.low_name, self.top_name = "layer1", "layer4"
            low_ch, top_ch = 256, 2048
        else:
            raise ValueError(f"unknown trunk {trunk!r}; one of {TRUNKS}")
        self.aspp = ASPP(top_ch)
        self.bot_fine = conv(low_ch, skip_num, 1)
        self.bot_aspp = conv(5 * 256, 256, 1)
        self.final = nn.Sequential(
            conv(skip_num + 256, 256, 3), BatchNorm2d(256), nn.ReLU(),
            conv(256, 256, 3), BatchNorm2d(256), nn.ReLU(),
            conv(256, num_classes, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_size = x.shape[2:]
        feats = self.trunk(x.to(next(self.trunk.parameters()).dtype))
        low, top = feats[self.low_name], feats[self.top_name]
        dec0_up = self.bot_aspp(self.aspp(top))
        dec0_fine = self.bot_fine(low)
        dec0 = torch.cat([dec0_fine, _up(dec0_up, low.shape[2:])], dim=1)
        return _up(self.final(dec0).float(), in_size)


def DeepR50V3PlusD_m1(num_classes: int = 19) -> DeepV3Plus:
    return DeepV3Plus(num_classes=num_classes, trunk="resnet-50")


def DeepSRNX50V3PlusD_m1(num_classes: int = 19) -> DeepV3Plus:
    return DeepV3Plus(num_classes=num_classes, trunk="seresnext-50")


def DeepSRNX101V3PlusD_m1(num_classes: int = 19) -> DeepV3Plus:
    return DeepV3Plus(num_classes=num_classes, trunk="seresnext-101")
