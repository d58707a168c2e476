"""MSDeformAttn pixel decoder: deformable-DETR encoder over res3-5 + FPN to stride 4.

Counterpart of ``multishiftseg_tpu/models/pixel_decoder.py:41-184`` (the
sequential encoder; the GPipe path is not ported). Module names follow the
reference ``MSDeformAttnPixelDecoder``: ``input_proj.{i}.{0,1}``,
``transformer.level_embed``, ``transformer.encoder.layers.{i}``,
``adapter_1``, ``layer_1``, ``mask_features``. Feature maps are channels-first.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.ms_deform_attn import MSDeformAttn
from ..ops.resize import resize_bilinear_nchw
from .layers import Conv2d, he_normal_
from .position_encoding import position_embedding_sine
from .resnet import RESNET_FEATURE_CHANNELS


def _reference_points(spatial_shapes: Sequence[Tuple[int, int]]) -> np.ndarray:
    """[S, 2] normalised (x, y) pixel-centre positions, concatenated over levels
    (reference ``get_reference_points`` with valid ratios = 1)."""
    pts = []
    for h, w in spatial_shapes:
        ys = (np.arange(h, dtype=np.float64) + 0.5) / h
        xs = (np.arange(w, dtype=np.float64) + 0.5) / w
        gy, gx = np.meshgrid(ys, xs, indexing="ij")
        pts.append(np.stack([gx.reshape(-1), gy.reshape(-1)], -1))
    return np.concatenate(pts, 0).astype(np.float32)


class DeformableEncoderLayer(nn.Module):
    def __init__(self, d_model: int = 256, d_ffn: int = 1024, n_levels: int = 3,
                 n_heads: int = 8, n_points: int = 4):
        super().__init__()
        self.self_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, src, pos, reference_points, spatial_shapes, sample_mode="bilinear",
                quantize_table=False):
        attn_out = self.self_attn(src + pos, reference_points, src, spatial_shapes,
                                  sample_mode, quantize_table)
        src = self.norm1(src + attn_out)
        ffn = self.linear2(F.relu(self.linear1(src)))
        return self.norm2(src + ffn)


class DeformableEncoder(nn.Module):
    def __init__(self, num_layers: int, **layer_kwargs):
        super().__init__()
        self.layers = nn.ModuleList(
            DeformableEncoderLayer(**layer_kwargs) for _ in range(num_layers))


class MSDeformAttnTransformerEncoderOnly(nn.Module):
    """Holds ``level_embed`` and ``encoder.layers`` under the reference's names."""

    def __init__(self, d_model: int, n_levels: int, num_layers: int, **layer_kwargs):
        super().__init__()
        self.level_embed = nn.Parameter(torch.randn(n_levels, d_model))
        self.encoder = DeformableEncoder(num_layers, d_model=d_model,
                                         n_levels=n_levels, **layer_kwargs)


def _group_norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, channels, eps=1e-5)


# deformable levels, low -> high resolution, and the FPN level below them
ENCODER_FEATURES = ("res5", "res4", "res3")
FPN_FEATURE = "res2"
N_HEADS, N_POINTS, D_FFN = 8, 4, 1024  # the JAX encoder layer's fixed widths
# J = L * P sample points a head: the bound on T of the nearest_top{T} modes
DEFORM_POINTS = len(ENCODER_FEATURES) * N_POINTS


class MSDeformAttnPixelDecoder(nn.Module):
    def __init__(self, conv_dim: int = 256, mask_dim: int = 256,
                 transformer_enc_layers: int = 6):
        super().__init__()
        self.conv_dim = conv_dim
        self.input_proj = nn.ModuleList(
            nn.Sequential(he_normal_(nn.Conv2d(RESNET_FEATURE_CHANNELS[name], conv_dim, 1)),
                          _group_norm(conv_dim))
            for name in ENCODER_FEATURES)
        self.transformer = MSDeformAttnTransformerEncoderOnly(
            conv_dim, len(ENCODER_FEATURES), transformer_enc_layers, d_ffn=D_FFN,
            n_heads=N_HEADS, n_points=N_POINTS)
        self.adapter_1 = he_normal_(Conv2d(RESNET_FEATURE_CHANNELS[FPN_FEATURE], conv_dim, 1,
                                           bias=False, norm=_group_norm(conv_dim)))
        self.layer_1 = he_normal_(Conv2d(conv_dim, conv_dim, 3, padding=1, bias=False,
                                         norm=_group_norm(conv_dim), activation=F.relu))
        self.mask_features = he_normal_(Conv2d(conv_dim, mask_dim, 1))
        # per-instance device copies of the host-built constants, by shape
        self._constants: Dict[tuple, tuple] = {}

    def _pos_and_ref(self, shapes, device):
        """Per-level [HW, C] position embeddings and the [S, 2] reference points."""
        key = (tuple(shapes), str(device))
        if key not in self._constants:
            pos = [position_embedding_sine(h, w, self.conv_dim, device=device)
                   .reshape(h * w, -1) for h, w in shapes]
            ref = torch.from_numpy(_reference_points(shapes)).to(device)
            self._constants[key] = (pos, ref)
        return self._constants[key]

    def forward(self, features: Dict[str, torch.Tensor],
                sample_mode: Union[str, Sequence[str]] = "bilinear",
                quantize_table: bool = False):
        """features: channels-first maps by name. Returns (mask_features
        [N, mask_dim, H/4, W/4], encoder_top, multi-scale maps [stride 32, 16, 8]).

        ``sample_mode``: one deformable sample mode for every encoder layer, or
        one per layer (a hybrid, JAX ``pixel_decoder.py:146-159``);
        ``quantize_table``: the int8 value table in every layer."""
        layers = self.transformer.encoder.layers
        modes = (sample_mode,) * len(layers) if isinstance(sample_mode, str) else tuple(sample_mode)
        if len(modes) != len(layers):
            raise ValueError(f"per-layer sample_mode needs {len(layers)} entries, got "
                             f"{len(modes)}: {modes}")
        srcs, shapes = [], []
        for proj, name in zip(self.input_proj, ENCODER_FEATURES):
            x = proj(features[name])
            n, c, h, w = x.shape
            shapes.append((h, w))
            srcs.append(x.flatten(2).transpose(1, 2))  # [N, HW, C]
        src = torch.cat(srcs, dim=1)
        pos_levels, ref = self._pos_and_ref(shapes, src.device)
        level_embed = self.transformer.level_embed.to(src.dtype)
        pos = torch.cat([p.to(src.dtype) + level_embed[i] for i, p in enumerate(pos_levels)])
        pos = pos[None].expand(n, -1, -1)
        ref = ref[None, :, None, :].expand(n, -1, len(shapes), -1)
        for layer, mode in zip(layers, modes):
            src = layer(src, pos, ref, shapes, mode, quantize_table)

        # split back to 2-D maps, low -> high resolution
        outs: List[torch.Tensor] = []
        start = 0
        for h, w in shapes:
            outs.append(src[:, start:start + h * w].transpose(1, 2).reshape(n, -1, h, w))
            start += h * w

        # FPN step down to stride 4
        x = features[FPN_FEATURE]
        up = resize_bilinear_nchw(outs[-1], x.shape[-2:], align_corners=False)
        y = self.layer_1(self.adapter_1(x) + up)
        return self.mask_features(y), outs[0], outs
