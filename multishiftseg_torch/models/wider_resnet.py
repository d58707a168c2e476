"""WideResNet-38 (A2 variant) trunk, pre-activation identity-residual blocks.

Counterpart of ``multishiftseg_tpu/models/wider_resnet.py:24-122`` in its dilated
mode (output stride 8): structure [3, 3, 6, 3, 1, 1], channels up to 4096, max
pooling before mod2 and mod3, a stride-2 first block in mod4, dilation 2 in mod5
and 4 in mod6/mod7, channel dropout p 0.3 / 0.5 in mod6 / mod7. ``structure`` and
``channels`` can be overridden for a tiny trunk through the same code.

Module names follow the reference checkpoints (``mod1.conv1``,
``modN.blockM.bn1.0``, ``modN.blockM.convs.conv1`` / ``.bn2.0`` / ...,
``modN.blockM.proj_conv``). Tensors are channels-first; on the card the models
run in the channels-last memory format.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..core import tensor_parallel as tp
from .layers import Dropout2d, bn_relu, conv, max_pool_3x3_s2

# (structure, per-module channels) of WRN-38-A2 (reference wider_resnet.py:316-317, 384)
WRN38_STRUCTURE = (3, 3, 6, 3, 1, 1)
WRN38_CHANNELS = (
    (128, 128),
    (256, 256),
    (512, 512),
    (512, 1024),
    (512, 1024, 2048),
    (1024, 2048, 4096),
)


class IdentityResidualBlock(nn.Module):
    """Pre-activation residual block: the 2-conv wide variant, or the 1-3-1
    bottleneck when ``channels`` has three entries. Dropout sits before the last
    conv."""

    def __init__(self, in_channels: int, channels: Tuple[int, ...], stride: int = 1,
                 dilation: int = 1, dropout: float = 0.0):
        super().__init__()
        c = tuple(channels)
        self.bn1 = bn_relu(in_channels)
        layers = OrderedDict()
        if len(c) == 2:
            layers["conv1"] = conv(in_channels, c[0], 3, stride, dilation)
            layers["bn2"] = bn_relu(c[0])
            if dropout > 0:
                layers["dropout"] = Dropout2d(dropout, c[0])
            layers["conv2"] = conv(c[0], c[1], 3, 1, dilation)
        else:
            layers["conv1"] = conv(in_channels, c[0], 1, stride)
            layers["bn2"] = bn_relu(c[0])
            layers["conv2"] = conv(c[0], c[1], 3, 1, dilation)
            layers["bn3"] = bn_relu(c[1])
            if dropout > 0:
                layers["dropout"] = Dropout2d(dropout, c[1])
            layers["conv3"] = conv(c[1], c[2], 1)
        self.convs = nn.Sequential(layers)
        need_proj = stride != 1 or in_channels != c[-1]
        self.proj_conv = conv(in_channels, c[-1], 1, stride) if need_proj else None

    def forward(self, x, dropout_mask: Optional[torch.Tensor] = None):
        """``x`` whole, or its channel slices under tensor parallelism
        (``core.tensor_parallel``); the output likewise."""
        bn1 = tp.apply(self.bn1, x)
        if self.proj_conv is not None:
            bn1 = tp.full(bn1)  # both convs read every channel: one gather
        shortcut = tp.apply(self.proj_conv, bn1) if self.proj_conv is not None else x
        out = bn1
        for layer in self.convs:
            if isinstance(layer, Dropout2d):
                out = tp.per_channel(layer, out, dropout_mask)
            else:
                out = tp.apply(layer, out)
        return tp.add(out, shortcut)


def build_trunk(structure: Sequence[int] = WRN38_STRUCTURE,
                channels: Sequence[Tuple[int, ...]] = WRN38_CHANNELS,
                stem_width: int = 64) -> "OrderedDict[str, nn.Module]":
    """The trunk's modules ``mod1`` .. ``mod{len(structure) + 1}``."""
    mods = OrderedDict(mod1=nn.Sequential(OrderedDict(conv1=conv(3, stem_width, 3))))
    in_ch = stem_width
    for mod_id, num_blocks in enumerate(structure):
        blocks = OrderedDict()
        for block_id in range(num_blocks):
            blocks[f"block{block_id + 1}"] = IdentityResidualBlock(
                in_ch, channels[mod_id],
                stride=2 if (block_id == 0 and mod_id == 2) else 1,
                dilation=2 if mod_id == 3 else (4 if mod_id > 3 else 1),
                dropout=0.3 if mod_id == 4 else (0.5 if mod_id == 5 else 0.0))
            in_ch = channels[mod_id][-1]
        mods[f"mod{mod_id + 2}"] = nn.Sequential(blocks)
    return mods


def trunk_forward(owner: nn.Module, num_mods: int, x: torch.Tensor,
                  dropout_masks: Optional[Mapping[str, torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the trunk modules held by ``owner`` -> (mod2's output, the last one's).
    ``dropout_masks`` maps a block's name (``"mod6.block1"``) to its keep mask."""
    masks = dropout_masks or {}
    x = owner.mod1(x)
    m2 = x
    for mod_id in range(num_mods):
        if mod_id < 2:
            x = max_pool_3x3_s2(x)
        name = f"mod{mod_id + 2}"
        for block_name, block in getattr(owner, name).named_children():
            x = block(x, masks.get(f"{name}.{block_name}"))
        # a sharded residual stream stays in slices within a module
        x = tp.full(x)
        if mod_id == 0:
            m2 = x
    return m2, x


def draw_dropout_masks(model: nn.Module, batch: int, generator: Optional[torch.Generator],
                       device) -> Dict[str, torch.Tensor]:
    """A keep mask [batch, C, 1, 1] for every block with dropout, in forward
    order, keyed by the block's name; drawn from ``generator``."""
    masks = {}
    for name, module in model.named_modules():
        if isinstance(module, Dropout2d):
            masks[name.rsplit(".convs.", 1)[0]] = module.draw_mask(batch, generator, device)
    return masks


class WiderResNetA2(nn.Module):
    """Dilated WRN trunk: ``forward(x) -> (mod2 output, final output)``."""

    def __init__(self, structure: Sequence[int] = WRN38_STRUCTURE,
                 channels: Sequence[Tuple[int, ...]] = WRN38_CHANNELS, stem_width: int = 64):
        super().__init__()
        self.num_mods = len(structure)
        for name, module in build_trunk(structure, channels, stem_width).items():
            self.add_module(name, module)

    def forward(self, x: torch.Tensor,
                dropout_masks: Optional[Mapping[str, torch.Tensor]] = None):
        return trunk_forward(self, self.num_mods, x, dropout_masks)
