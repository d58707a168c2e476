"""FPN pixel decoders: the registered non-deformable alternatives.

Counterpart of ``multishiftseg_tpu/models/fpn_decoder.py`` (the reference's
``modeling/pixel_decoder/fpn.py:37-312``):

* :class:`BasePixelDecoder`: a plain top-down FPN over res2..res5 (a 3x3 output
  conv on res5, then 1x1 lateral and 3x3 output convs with GroupNorm, fused by
  nearest upsampling, ``fpn.py:149``), mask features at stride 4 and the three
  coarsest maps as multi-scale features;
* :class:`TransformerEncoderPixelDecoder`: the MaskFormer-v1 variant, which runs
  a DETR encoder on the projected res5 before the same top-down pass.

Module names follow the reference: ``layer_{1..4}`` (``layer_4`` on res5),
``adapter_{1..3}``, ``mask_features``; the encoder variant adds ``input_proj``
and ``transformer.encoder.layers.{i}`` and keeps the FPN at its top level (the
JAX module nests it under ``fpn``). Feature maps are channels-first.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize_nearest
from .attention import MultiheadAttention
from .layers import Conv2d, he_normal_
from .position_encoding import position_embedding_sine

IN_FEATURES = ("res2", "res3", "res4", "res5")


def _gn(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, channels, eps=1e-5)


class TransformerEncoderLayer(nn.Module):
    """DETR encoder layer, post-norm (JAX ``TransformerEncoderLayer``, :24)."""

    def __init__(self, d_model: int = 256, nheads: int = 8, dim_feedforward: int = 2048):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nheads)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, src: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        q = src + pos
        src = self.norm1(src + self.self_attn(q, q, src))
        return self.norm2(src + self.linear2(F.relu(self.linear1(src))))


class BasePixelDecoder(nn.Module):
    """Plain FPN (JAX ``BasePixelDecoder``, :43). ``feature_channels``: the
    backbone's channels by feature name."""

    def __init__(self, feature_channels: Mapping[str, int], conv_dim: int = 256,
                 mask_dim: int = 256, in_features: Sequence[str] = IN_FEATURES,
                 num_outputs: int = 3):
        super().__init__()
        self.in_features, self.num_outputs = tuple(in_features), num_outputs
        n = len(self.in_features)
        for idx, name in enumerate(self.in_features):
            cin = feature_channels[name]
            if idx < n - 1:  # a lateral 1x1, then the output conv on the sum
                self.add_module(f"adapter_{idx + 1}", he_normal_(
                    Conv2d(cin, conv_dim, 1, bias=False, norm=_gn(conv_dim))))
                cin = conv_dim
            self.add_module(f"layer_{idx + 1}", he_normal_(
                Conv2d(cin, conv_dim, 3, padding=1, bias=False, norm=_gn(conv_dim),
                       activation=F.relu)))
        self.mask_features = he_normal_(Conv2d(conv_dim, mask_dim, 3, padding=1))

    def forward(self, features: Dict[str, torch.Tensor]):
        """-> (mask features [N, mask_dim, H/4, W/4], the res5 level's output,
        the ``num_outputs`` coarsest outputs, coarse first)."""
        n = len(self.in_features)
        outs = []
        y = None
        for idx in range(n - 1, -1, -1):
            x = features[self.in_features[idx]]
            if y is not None:
                # nearest upsampling, as the FPN (unlike msdeformattn's bilinear)
                x = getattr(self, f"adapter_{idx + 1}")(x) + resize_nearest(y, x.shape[-2:])
            y = getattr(self, f"layer_{idx + 1}")(x)
            outs.append(y)
        return self.mask_features(outs[-1]), outs[0], outs[:self.num_outputs]


class TransformerEncoderOnly(nn.Module):
    """Holds ``encoder.layers`` under the reference's names."""

    def __init__(self, num_layers: int, **layer_kwargs):
        super().__init__()
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(
            TransformerEncoderLayer(**layer_kwargs) for _ in range(num_layers))


class TransformerEncoderPixelDecoder(BasePixelDecoder):
    """MaskFormer-v1 pixel decoder (JAX ``TransformerEncoderPixelDecoder``, :87):
    a 1x1 projection of res5 with bias, a DETR encoder with sine positions,
    then the FPN with the encoded map in res5's place. Returns (mask features,
    the encoded map, the multi-scale outputs)."""

    def __init__(self, feature_channels: Mapping[str, int], conv_dim: int = 256,
                 mask_dim: int = 256, transformer_enc_layers: int = 6, nheads: int = 8,
                 dim_feedforward: int = 2048, in_features: Sequence[str] = IN_FEATURES,
                 num_outputs: int = 3):
        top = in_features[-1]
        super().__init__({**feature_channels, top: conv_dim}, conv_dim, mask_dim,
                         in_features, num_outputs)
        self.conv_dim = conv_dim
        self.input_proj = he_normal_(nn.Conv2d(feature_channels[top], conv_dim, 1))
        self.transformer = TransformerEncoderOnly(
            transformer_enc_layers, d_model=conv_dim, nheads=nheads,
            dim_feedforward=dim_feedforward)

    def forward(self, features: Dict[str, torch.Tensor]):
        top = self.in_features[-1]
        src = self.input_proj(features[top])
        n, c, h, w = src.shape
        pos = position_embedding_sine(h, w, self.conv_dim, device=src.device)
        pos = pos.reshape(1, h * w, c).to(src.dtype)
        tokens = src.flatten(2).transpose(1, 2)
        for layer in self.transformer.encoder.layers:
            tokens = layer(tokens, pos)
        transformed = tokens.transpose(1, 2).reshape(n, c, h, w)
        mask_features, _, multi_scale = super().forward({**features, top: transformed})
        return mask_features, transformed, multi_scale
