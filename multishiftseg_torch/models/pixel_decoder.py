"""MSDeformAttn pixel decoder: deformable-DETR encoder over res3-5 + FPN to stride 4.

Counterpart of ``multishiftseg_tpu/models/pixel_decoder.py:41-224``: the
sequential encoder with its training remat, and the GPipe path
(``_pipelined_encoder``, :186-224; ``core/pipeline.py``), which a trainer turns
on with :meth:`MSDeformAttnPixelDecoder.set_pipeline` and which runs in
training mode only: evaluation stays sequential, as JAX's eval model.
Module names follow the reference ``MSDeformAttnPixelDecoder``:
``input_proj.{i}.{0,1}``,
``transformer.level_embed``, ``transformer.encoder.layers.{i}``,
``adapter_1``, ``layer_1``, ``mask_features``. Feature maps are channels-first.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, noop_context_fn

from ..core.pipeline import check_geometry, gpipe_encoder_apply
from ..ops import ms_deform_attn as msda
from ..ops.resize import resize_bilinear_nchw
from ..utils import cached
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
        self.self_attn = msda.MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        # the checkpoints' context_fn (torch.utils.checkpoint): a tool that
        # follows the running module sets it to see the backward's recompute
        self.checkpoint_context = noop_context_fn

    def forward(self, src, pos, reference_points, spatial_shapes, sample_mode="bilinear",
                quantize_table=False):
        """In training (grad enabled) the layer rematerialises as JAX's
        ``nn.remat`` with ``save_only_these_names("deform_core")``
        (``pixel_decoder.py:127-159``): the segments before and after the
        deformable core are checkpointed and recomputed in the backward, while
        the core runs once and keeps what its backward needs (its inputs; its
        output is the second segment's saved input)."""
        remat = self.training and torch.is_grad_enabled()
        value, loc, attn = self._segment(remat, self._sampling, src, pos, reference_points,
                                         spatial_shapes)
        core = msda.ms_deform_attn_core(value, spatial_shapes, loc, attn, sample_mode,
                                        quantize_table)
        return self._segment(remat, self._finish, src, core)

    def _segment(self, remat: bool, fn, *args):
        """``fn(*args)``, checkpointed when ``remat``."""
        if not remat:
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, context_fn=self.checkpoint_context)

    def _sampling(self, src, pos, reference_points, spatial_shapes):
        return self.self_attn.sampling(src + pos, reference_points, src, spatial_shapes)

    def _finish(self, src, core):
        src = self.norm1(src + self.self_attn.output_proj(core))
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
                 transformer_enc_layers: int = 6,
                 feature_channels: Optional[Mapping[str, int]] = None):
        """``feature_channels``: the backbone's channels by feature name (R-50's
        by default), which the input projections take."""
        super().__init__()
        chans = dict(feature_channels or RESNET_FEATURE_CHANNELS)
        self.conv_dim = conv_dim
        self.input_proj = nn.ModuleList(
            nn.Sequential(he_normal_(nn.Conv2d(chans[name], conv_dim, 1)),
                          _group_norm(conv_dim))
            for name in ENCODER_FEATURES)
        self.transformer = MSDeformAttnTransformerEncoderOnly(
            conv_dim, len(ENCODER_FEATURES), transformer_enc_layers, d_ffn=D_FFN,
            n_heads=N_HEADS, n_points=N_POINTS)
        self.adapter_1 = he_normal_(Conv2d(chans[FPN_FEATURE], conv_dim, 1,
                                           bias=False, norm=_group_norm(conv_dim)))
        self.layer_1 = he_normal_(Conv2d(conv_dim, conv_dim, 3, padding=1, bias=False,
                                         norm=_group_norm(conv_dim), activation=F.relu))
        self.mask_features = he_normal_(Conv2d(conv_dim, mask_dim, 1))
        # per-instance device copies of the host-built constants, by shape
        self._constants: Dict[tuple, tuple] = {}
        # (stage devices, microbatches) of the GPipe path, when set
        self.pipeline: Optional[Tuple[List[torch.device], int]] = None

    def set_pipeline(self, devices: Sequence[torch.device], n_micro: int) -> None:
        """GPipe the encoder in training over ``devices`` (``core.pipeline.
        stage_devices``) in ``n_micro`` microbatches: stage ``p``'s contiguous
        slice of ``transformer.encoder.layers`` moves to ``devices[p]``, and its
        parameters and their optimizer state live there from then on. The
        layers keep their names, so checkpoints do not change."""
        layers = self.transformer.encoder.layers
        check_geometry(len(layers), len(devices), n_micro=n_micro)
        per = len(layers) // len(devices)
        for i, layer in enumerate(layers):
            layer.to(devices[i // per])
        self.pipeline = (list(devices), n_micro)

    def _pos_and_ref(self, shapes, device):
        """Per-level [HW, C] position embeddings and the [S, 2] reference points."""
        def make():
            pos = [position_embedding_sine(h, w, self.conv_dim, device=device)
                   .reshape(h * w, -1) for h, w in shapes]
            return pos, torch.from_numpy(_reference_points(shapes)).to(device)

        return cached(self._constants, (tuple(shapes), str(device)), make)

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
        ref = ref[None, :, None, :].expand(1, -1, len(shapes), -1)
        if self.pipeline is not None and self.training:
            if len(set(modes)) != 1:
                raise ValueError(f"the pipelined encoder takes one sample mode, got {modes}")
            devices, n_micro = self.pipeline
            src = gpipe_encoder_apply(layers, src, pos[None], ref, shapes, devices=devices,
                                      n_micro=n_micro, sample_mode=modes[0],
                                      quantize_table=quantize_table)
        else:
            src = self._sequential_encoder(layers, modes, src, pos[None].expand(n, -1, -1),
                                           ref.expand(n, -1, -1, -1), shapes, quantize_table)

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

    def _sequential_encoder(self, layers, modes, src, pos, ref, shapes, quantize_table):
        """The layers in order; a pipelined model's layers sit on their stages'
        devices, and the activations follow them there and back."""
        device = src.device
        for layer, mode in zip(layers, modes):
            if self.pipeline is not None:
                dev = layer.norm1.weight.device
                src, pos, ref = src.to(dev), pos.to(dev), ref.to(dev)
            src = layer(src, pos, ref, shapes, mode, quantize_table)
        return src.to(device)
