"""Stable-Diffusion-1.5 UNet and its ControlNet branch.

Counterpart of ``multishiftseg_tpu/cgaug/sd_unet.py``, with the module tree of
the reference's torch stack, so that the ``model.diffusion_model.*`` and
``control_model.*`` tensors of ``control_sd15_seg.pth`` load by name:

* UNet: ``CGAug/ControlNet/ldm/modules/diffusionmodules/openaimodel.py:412-786``
  (``UNetModel``) and ``cldm/cldm.py:21-46`` (``ControlledUnetModel``):
  ``time_embed``, ``input_blocks``, ``middle_block``, ``output_blocks``, ``out``;
  residual blocks with the timestep embedding added, spatial transformers
  (self and cross attention over the text context) at downsample rates 1/2/4,
  skip concatenation; the control residuals add to the middle output and to
  each skip.
* ControlNet: ``cldm/cldm.py:48-305``: a copy of the encoder with the 8x
  downsampling hint CNN (``input_hint_block``) and a 1x1 projection a tap
  (``zero_convs``, ``middle_block_out``).

Layout is NCHW, as the checkpoint's. :func:`unet_layout` walks the
constructor loops once for both towers, as JAX's does. ``cfg.dtype`` casts the
inputs, the timestep embedding and (in :class:`sd_pipeline.ControlNetPipeline`)
the weights; group norms compute in f32 and attention logits and softmax in
f32, as JAX's explicit casts do. The layers keep PyTorch's default init (the
reference zero-initialises the zero convs and some output convs): weights come
from a checkpoint, and random ones then exercise every branch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class SDUNetConfig:
    """Architecture knobs of ``UNetModel`` (openaimodel.py:442-472) that the
    SD1.5 / ControlNet-v15 family uses (models/cldm_v15.yaml)."""

    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    num_res_blocks: int = 2
    # downsample rates at which a SpatialTransformer follows each ResBlock
    attention_ds: Tuple[int, ...] = (1, 2, 4)
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_heads: int = 8
    transformer_depth: int = 1
    context_dim: int = 768
    # ControlNet-only
    hint_channels: int = 3
    hint_widths: Tuple[int, ...] = (16, 16, 32, 32, 96, 96, 256)
    dtype: torch.dtype = torch.float32


def tiny_sd_config(**over) -> SDUNetConfig:
    """A GroupNorm(32)-compatible miniature for tests (JAX's ``tiny_sd_config``)."""
    kw = dict(
        model_channels=32,
        num_res_blocks=1,
        channel_mult=(1, 2),
        attention_ds=(1, 2),
        num_heads=4,
        context_dim=16,
        hint_widths=(8, 8, 16, 16, 24, 24, 32),
    )
    kw.update(over)
    return SDUNetConfig(**kw)


def unet_layout(cfg: SDUNetConfig):
    """Walk the UNetModel constructor loops (openaimodel.py:542-730).

    Returns (input_specs, middle_ch, output_specs, skip_channels) where each
    input spec is a dict {i, kind, ch_in, ch_out, st, ds} keyed by the
    ``input_blocks`` index, and each output spec additionally carries the skip
    width and whether an upsample trails the block.
    """
    M = cfg.model_channels
    inputs = [dict(i=0, kind="conv", ch_in=cfg.in_channels, ch_out=M, st=False, ds=1)]
    skip_ch = [M]
    ch, ds, i = M, 1, 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            inputs.append(dict(i=i, kind="res", ch_in=ch, ch_out=mult * M,
                               st=ds in cfg.attention_ds, ds=ds))
            ch = mult * M
            skip_ch.append(ch)
            i += 1
        if level != len(cfg.channel_mult) - 1:
            inputs.append(dict(i=i, kind="down", ch_in=ch, ch_out=ch, st=False, ds=ds))
            skip_ch.append(ch)
            ds *= 2
            i += 1
    mid_ch = ch
    outputs = []
    sc = list(skip_ch)
    for level, mult in reversed(list(enumerate(cfg.channel_mult))):
        for j in range(cfg.num_res_blocks + 1):
            ich = sc.pop()
            spec = dict(i=len(outputs), ch_in=ch + ich, ch_out=mult * M, skip=ich,
                        st=ds in cfg.attention_ds, up=False, ds=ds)
            ch = mult * M
            if level and j == cfg.num_res_blocks:
                spec["up"] = True
                ds //= 2
            outputs.append(spec)
    return inputs, mid_ch, outputs, skip_ch


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding, cos|sin order (diffusionmodules/util.py:152-170)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class GroupNorm32(nn.GroupNorm):
    """GroupNorm evaluated in f32 then cast back (util.py ``GroupNorm32``)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__(32, channels, eps=eps)

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


def conv3(ch_in: int, ch_out: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(ch_in, ch_out, 3, stride=stride, padding=1)


class ResBlock(nn.Module):
    """GN-SiLU-conv / + timestep embedding / GN-SiLU-conv with skip
    (openaimodel.py:162-274; SD adds the embedding, no scale-shift)."""

    def __init__(self, ch_in: int, ch_out: int, emb_ch: int, eps: float = 1e-5):
        super().__init__()
        self.in_layers = nn.Sequential(GroupNorm32(ch_in, eps), nn.SiLU(), conv3(ch_in, ch_out))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_ch, ch_out))
        self.out_layers = nn.Sequential(GroupNorm32(ch_out, eps), nn.SiLU(), nn.Identity(),
                                        conv3(ch_out, ch_out))
        self.skip_connection = (nn.Identity() if ch_in == ch_out
                                else nn.Conv2d(ch_in, ch_out, 1))

    def forward(self, x, emb):
        h = self.in_layers(x)
        h = h + self.emb_layers(emb).to(h.dtype)[:, :, None, None]
        return self.skip_connection(x) + self.out_layers(h)


class CrossAttention(nn.Module):
    """Multi-head attention, self attention when ``context`` is None
    (attention.py:145-194). Logits and softmax in f32 (the reference forces
    ATTN_PRECISION=fp32)."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim or dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim or dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, dim), nn.Identity())

    def forward(self, x, context=None):
        ctx = x if context is None else context
        b, n, _ = x.shape
        m = ctx.shape[1]
        q = self.to_q(x).reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
        k = self.to_k(ctx).reshape(b, m, self.heads, self.dim_head).transpose(1, 2)
        v = self.to_v(ctx).reshape(b, m, self.heads, self.dim_head).transpose(1, 2)
        sim = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (self.dim_head ** -0.5)
        attn = sim.softmax(-1).to(v.dtype)
        del sim
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, -1)
        return self.to_out(out)


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x):
        val, gate = self.proj(x).chunk(2, dim=-1)
        return val * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, dim * mult), nn.Identity(), nn.Linear(dim * mult, dim))

    def forward(self, x):
        return self.net(x)


class BasicTransformerBlock(nn.Module):
    """self-attn / cross-attn / GEGLU feed-forward, each pre-LN residual
    (attention.py:246-275)."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads, dim_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.norm3 = nn.LayerNorm(dim)

    def forward(self, x, context):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context) + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    """1x1-projected token transformer over the spatial grid, with residual
    (attention.py:278-340)."""

    def __init__(self, channels: int, heads: int, depth: int, context_dim: int):
        super().__init__()
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(channels, heads, channels // heads, context_dim)
            for _ in range(depth))
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x, context):
        b, c, hh, ww = x.shape
        h = self.proj_in(self.norm(x))
        h = h.flatten(2).transpose(1, 2)
        for blk in self.transformer_blocks:
            h = blk(h, context)
        h = h.transpose(1, 2).reshape(b, c, hh, ww)
        return x + self.proj_out(h)


class Downsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.op = conv3(ch, ch, stride=2)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = conv3(ch, ch)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class TimestepEmbedSequential(nn.Sequential):
    """A block list whose residual blocks take the embedding and whose
    transformers take the context (openaimodel.py ``TimestepEmbedSequential``)."""

    def forward(self, x, emb, context):
        for layer in self:
            if isinstance(layer, ResBlock):
                x = layer(x, emb)
            elif isinstance(layer, SpatialTransformer):
                x = layer(x, context)
            else:
                x = layer(x)
        return x


def _time_embed(cfg: SDUNetConfig) -> nn.Sequential:
    M = cfg.model_channels
    return nn.Sequential(nn.Linear(M, 4 * M), nn.SiLU(), nn.Linear(4 * M, 4 * M))


def _input_blocks(cfg: SDUNetConfig):
    """``input_blocks`` and ``middle_block``, shared by the UNet and the ControlNet."""
    inputs, mid_ch, _, _ = unet_layout(cfg)
    emb_ch = 4 * cfg.model_channels
    heads, depth, ctx = cfg.num_heads, cfg.transformer_depth, cfg.context_dim
    blocks = nn.ModuleList()
    for s in inputs:
        if s["kind"] == "conv":
            blocks.append(TimestepEmbedSequential(conv3(s["ch_in"], s["ch_out"])))
        elif s["kind"] == "down":
            blocks.append(TimestepEmbedSequential(Downsample(s["ch_out"])))
        else:
            layers = [ResBlock(s["ch_in"], s["ch_out"], emb_ch)]
            if s["st"]:
                layers.append(SpatialTransformer(s["ch_out"], heads, depth, ctx))
            blocks.append(TimestepEmbedSequential(*layers))
    middle = TimestepEmbedSequential(ResBlock(mid_ch, mid_ch, emb_ch),
                                     SpatialTransformer(mid_ch, heads, depth, ctx),
                                     ResBlock(mid_ch, mid_ch, emb_ch))
    return blocks, middle


class SDUNet(nn.Module):
    """The denoiser ``eps = f(x_t, t, context[, control])`` on NCHW latents;
    ``control`` is the 13-tensor residual list of :class:`ControlNetBranch`
    (``ControlledUnetModel``, cldm.py:21-46)."""

    def __init__(self, cfg: SDUNetConfig = SDUNetConfig()):
        super().__init__()
        self.cfg = cfg
        _, _, outputs, _ = unet_layout(cfg)
        emb_ch = 4 * cfg.model_channels
        self.time_embed = _time_embed(cfg)
        self.input_blocks, self.middle_block = _input_blocks(cfg)
        self.output_blocks = nn.ModuleList()
        for s in outputs:
            layers = [ResBlock(s["ch_in"], s["ch_out"], emb_ch)]
            if s["st"]:
                layers.append(SpatialTransformer(s["ch_out"], cfg.num_heads,
                                                 cfg.transformer_depth, cfg.context_dim))
            if s["up"]:
                layers.append(Upsample(s["ch_out"]))
            self.output_blocks.append(TimestepEmbedSequential(*layers))
        ch = cfg.model_channels * cfg.channel_mult[0]
        self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(), conv3(ch, cfg.out_channels))

    def forward(self, x, t, context, control: Optional[Sequence[torch.Tensor]] = None):
        cfg = self.cfg
        x = x.to(cfg.dtype)
        context = context.to(cfg.dtype)
        emb = self.time_embed(timestep_embedding(t, cfg.model_channels).to(cfg.dtype))
        hs = []
        h = x
        for blk in self.input_blocks:
            h = blk(h, emb, context)
            hs.append(h)
        h = self.middle_block(h, emb, context)
        if control is not None:
            h = h + control[-1]
        for idx, blk in enumerate(self.output_blocks):
            skip = hs[-1 - idx]
            if control is not None:
                skip = skip + control[-2 - idx]
            h = blk(torch.cat([h, skip.to(h.dtype)], dim=1), emb, context)
        return self.out(h)


class ControlNetBranch(nn.Module):
    """The hint-conditioned encoder copy emitting 13 control taps (cldm.py:48-305):
    one a input block, then the middle block's."""

    # hint convs with stride 2 (cldm.py:147-163), by position among the convs
    STRIDED = (2, 4, 6)

    def __init__(self, cfg: SDUNetConfig = SDUNetConfig()):
        super().__init__()
        self.cfg = cfg
        inputs, mid_ch, _, _ = unet_layout(cfg)
        self.time_embed = _time_embed(cfg)
        hint, ch = [], cfg.hint_channels
        for j, w in enumerate(cfg.hint_widths):
            hint += [conv3(ch, w, stride=2 if j in self.STRIDED else 1), nn.SiLU()]
            ch = w
        hint.append(conv3(ch, cfg.model_channels))
        self.input_hint_block = TimestepEmbedSequential(*hint)
        self.input_blocks, self.middle_block = _input_blocks(cfg)
        self.zero_convs = nn.ModuleList(
            TimestepEmbedSequential(nn.Conv2d(s["ch_out"], s["ch_out"], 1)) for s in inputs)
        self.middle_block_out = TimestepEmbedSequential(nn.Conv2d(mid_ch, mid_ch, 1))

    def forward(self, x, hint, t, context) -> List[torch.Tensor]:
        cfg = self.cfg
        x = x.to(cfg.dtype)
        context = context.to(cfg.dtype)
        emb = self.time_embed(timestep_embedding(t, cfg.model_channels).to(cfg.dtype))
        guided = self.input_hint_block(hint.to(cfg.dtype), emb, context)
        outs = []
        h = x
        for i, (blk, zero) in enumerate(zip(self.input_blocks, self.zero_convs)):
            h = blk(h, emb, context)
            if i == 0:
                h = h + guided
            outs.append(zero(h, emb, context))
        h = self.middle_block(h, emb, context)
        outs.append(self.middle_block_out(h, emb, context))
        return outs
