"""DeepLab v3+ on WideResNet-38 with a per-pixel energy-scored OOD head.

Counterpart of ``multishiftseg_tpu/models/deeplab.py:27-127`` (``ConvBNReLU``,
``ASPP``, ``DeepWV3Plus``, ``init_ood_head_from_final``): WRN-38 trunk (output
stride 8) -> ASPP (4096 -> 256, rates 12/24/36 + image pooling, concat 1280) ->
``bot_aspp`` 1280 -> 256, ``bot_fine`` 128 -> 48 skip from mod2, the 3-conv
``final`` head to 19 classes, and a duplicate 1x1 ``ood_head`` whose negative
``logsumexp`` energy is the anomaly score. The ASPP's dilated 3x3 convs run
through ``ops.dilated_conv`` (CUDA kernels on the card).

``state_dict`` keys are the reference's (``lib/network/deepv3/deepv3.py:203-285``):
the trunk's ``mod1`` .. ``mod7`` at the top level, ``aspp.features.{0..3}.{0,1}``,
``aspp.img_conv.{0,1}``, ``bot_fine``, ``bot_aspp``, ``final.{0,1,3,4,6}``,
``ood_head``. Input NCHW; outputs (anomaly score [N, H, W], logits [N, C, H, W]),
both f32 and upsampled bilinearly (``align_corners=True``) to the input size.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.scores import energy_score
from .layers import BatchNorm2d, conv, global_avg_pool
from .wider_resnet import WRN38_CHANNELS, WRN38_STRUCTURE, build_trunk, trunk_forward


def conv_bn_relu(cin: int, cout: int, k: int, dilation: int = 1) -> nn.Sequential:
    """JAX ``ConvBNReLU``; keys ``<name>.0.weight`` and ``<name>.1.*``."""
    return nn.Sequential(conv(cin, cout, k, dilation=dilation), BatchNorm2d(cout), nn.ReLU())


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling, output-stride-8 rates (reference
    ``deepv3.py:35-92``): image pooling, a 1x1 branch and three dilated 3x3 ones."""

    def __init__(self, in_dim: int, reduction_dim: int = 256,
                 rates: Sequence[int] = (12, 24, 36)):
        super().__init__()
        self.img_conv = conv_bn_relu(in_dim, reduction_dim, 1)
        self.features = nn.ModuleList(
            [conv_bn_relu(in_dim, reduction_dim, 1)]
            + [conv_bn_relu(in_dim, reduction_dim, 3, dilation=r) for r in rates])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[2:]
        img = self.img_conv(global_avg_pool(x)).expand(-1, -1, h, w)
        return torch.cat([img] + [f(x) for f in self.features], dim=1)


def _up(x: torch.Tensor, size) -> torch.Tensor:
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True)


class DeepWV3Plus(nn.Module):
    """WideResNet-38 DeepLab v3+ with the classification and OOD heads.

    ``trunk_structure`` / ``trunk_channels`` default to WRN-38; overriding them
    gives a tiny model through the same code. In training, ``dropout_masks``
    (``wider_resnet.draw_dropout_masks``) hold the trunk's channel-dropout masks.
    """

    def __init__(self, num_classes: int = 19, trunk_structure: Optional[Sequence[int]] = None,
                 trunk_channels: Optional[Sequence[Tuple[int, ...]]] = None):
        super().__init__()
        structure = tuple(trunk_structure or WRN38_STRUCTURE)
        channels = tuple(tuple(c) for c in (trunk_channels or WRN38_CHANNELS))
        self.num_mods = len(structure)
        for name, module in build_trunk(structure, channels).items():
            self.add_module(name, module)
        self.aspp = ASPP(channels[-1][-1])
        self.bot_fine = conv(channels[0][-1], 48, 1)
        self.bot_aspp = conv(5 * 256, 256, 1)
        self.final = nn.Sequential(
            conv(48 + 256, 256, 3), BatchNorm2d(256), nn.ReLU(),
            conv(256, 256, 3), BatchNorm2d(256), nn.ReLU(),
            conv(256, num_classes, 1))
        self.ood_head = conv(256, num_classes, 1)

    def forward(self, x: torch.Tensor,
                dropout_masks: Optional[Mapping[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        in_size = x.shape[2:]
        x = x.to(next(self.parameters()).dtype)
        m2, trunk_out = trunk_forward(self, self.num_mods, x, dropout_masks)
        dec0_up = self.bot_aspp(self.aspp(trunk_out))
        dec0_fine = self.bot_fine(m2)
        dec0 = torch.cat([dec0_fine, _up(dec0_up, m2.shape[2:])], dim=1)
        feature = self.final[:6](dec0)
        logit = _up(self.final[6](feature).float(), in_size)
        # energy in f32 on the stride-2 map, then upsample the scalar map
        score = energy_score(self.ood_head(feature), dim=1)[:, None]
        return _up(score, in_size)[:, 0], logit


@torch.no_grad()
def init_ood_head_from_final(model: DeepWV3Plus) -> None:
    """``ood_head`` <- the classifier's kernel, a copy (the reference's
    ``uncertainty_func_init``, ``deepv3.py:255-256``)."""
    model.ood_head.weight.copy_(model.final[6].weight)
