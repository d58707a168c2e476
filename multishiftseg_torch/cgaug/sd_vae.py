"""AutoencoderKL, the SD first stage.

Counterpart of ``multishiftseg_tpu/cgaug/sd_vae.py``, with the module tree of
the reference's torch stack (``CGAug/ControlNet/ldm/modules/diffusionmodules/
model.py:452-652`` Encoder / Decoder, ``ldm/models/autoencoder.py``), so the
``first_stage_model.*`` tensors of ``control_sd15_seg.pth`` load by name:
pre-activation residual blocks (GroupNorm eps 1e-6, swish), one single-head
attention block at the bottleneck, strided-conv downsampling after a (0, 1)
pad, nearest-2x conv upsampling, and the 1x1 quant / post-quant projections
around the diagonal-Gaussian latent. SD1.5: ch 128, ch_mult (1, 2, 4, 4), 2
residual blocks, z 4, double_z, no attention on the down path. Generation
needs ``decode`` alone; ``encode`` is here because the checkpoint holds both.
NCHW; group norms and the attention logits compute in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    in_channels: int = 3
    out_ch: int = 3
    z_channels: int = 4
    embed_dim: int = 4
    double_z: bool = True
    attn_resolutions: Tuple[int, ...] = ()
    resolution: int = 256
    dtype: torch.dtype = torch.float32


def tiny_vae_config(**over) -> VAEConfig:
    kw = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, resolution=32)
    kw.update(over)
    return VAEConfig(**kw)


class Normalize(nn.GroupNorm):
    """GroupNorm(32, eps 1e-6), evaluated in f32."""

    def __init__(self, channels: int):
        super().__init__(32, channels, eps=1e-6)

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


def _conv3(ch_in: int, ch_out: int) -> nn.Conv2d:
    return nn.Conv2d(ch_in, ch_out, 3, padding=1)


class VAEResBlock(nn.Module):
    """norm-swish-conv twice with a learned 1x1 shortcut on a width change
    (model.py:88-122; no timestep embedding in the autoencoder)."""

    def __init__(self, ch_in: int, ch_out: int):
        super().__init__()
        self.norm1 = Normalize(ch_in)
        self.conv1 = _conv3(ch_in, ch_out)
        self.norm2 = Normalize(ch_out)
        self.conv2 = _conv3(ch_out, ch_out)
        if ch_in != ch_out:
            self.nin_shortcut = nn.Conv2d(ch_in, ch_out, 1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class VAEAttnBlock(nn.Module):
    """Single-head spatial self-attention with 1x1 projections (model.py:144-190)."""

    def __init__(self, ch: int):
        super().__init__()
        self.norm = Normalize(ch)
        self.q = nn.Conv2d(ch, ch, 1)
        self.k = nn.Conv2d(ch, ch, 1)
        self.v = nn.Conv2d(ch, ch, 1)
        self.proj_out = nn.Conv2d(ch, ch, 1)

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.norm(x)
        q = self.q(h).flatten(2).transpose(1, 2)          # [b, n, c]
        k = self.k(h).flatten(2)                          # [b, c, n]
        v = self.v(h).flatten(2).transpose(1, 2)
        w = torch.bmm(q.float(), k.float()) * (c ** -0.5)
        w = w.softmax(-1).to(v.dtype)
        h = torch.bmm(w, v).transpose(1, 2).reshape(b, c, hh, ww)
        return x + self.proj_out(h)


class Downsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = _conv3(ch, ch)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class _Level(nn.Module):
    """One resolution of the encoder or decoder: ``block``, ``attn`` and its
    resampler (model.py's anonymous ``nn.Module`` per level)."""

    def __init__(self, blocks, attns, resample=None, resample_name="downsample"):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        self.attn = nn.ModuleList(attns)
        if resample is not None:
            setattr(self, resample_name, resample)


class _Mid(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.block_1 = VAEResBlock(ch, ch)
        self.attn_1 = VAEAttnBlock(ch)
        self.block_2 = VAEResBlock(ch, ch)

    def forward(self, h):
        return self.block_2(self.attn_1(self.block_1(h)))


def _run_level(level: _Level, h):
    for i, blk in enumerate(level.block):
        h = blk(h)
        if len(level.attn):
            h = level.attn[i](h)
    return h


class VAEEncoder(nn.Module):
    """model.py:452-543."""

    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.conv_in = _conv3(cfg.in_channels, cfg.ch)
        res, ch = cfg.resolution, cfg.ch
        self.down = nn.ModuleList()
        for level, mult in enumerate(cfg.ch_mult):
            blocks, attns = [], []
            for _ in range(cfg.num_res_blocks):
                blocks.append(VAEResBlock(ch, cfg.ch * mult))
                ch = cfg.ch * mult
                if res in cfg.attn_resolutions:
                    attns.append(VAEAttnBlock(ch))
            last = level == len(cfg.ch_mult) - 1
            self.down.append(_Level(blocks, attns, None if last else Downsample(ch)))
            if not last:
                res //= 2
        self.mid = _Mid(ch)
        self.norm_out = Normalize(ch)
        self.conv_out = _conv3(ch, 2 * cfg.z_channels if cfg.double_z else cfg.z_channels)

    def forward(self, x):
        h = self.conv_in(x.to(self.cfg.dtype))
        for level in self.down:
            h = _run_level(level, h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class VAEDecoder(nn.Module):
    """model.py:546-652; ``up`` is indexed by level, as the checkpoint's."""

    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        levels = len(cfg.ch_mult)
        ch = cfg.ch * cfg.ch_mult[-1]
        res = cfg.resolution // 2 ** (levels - 1)
        self.conv_in = _conv3(cfg.z_channels, ch)
        self.mid = _Mid(ch)
        up = [None] * levels
        for level in reversed(range(levels)):
            blocks, attns = [], []
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(VAEResBlock(ch, cfg.ch * cfg.ch_mult[level]))
                ch = cfg.ch * cfg.ch_mult[level]
                if res in cfg.attn_resolutions:
                    attns.append(VAEAttnBlock(ch))
            up[level] = _Level(blocks, attns, Upsample(ch) if level else None, "upsample")
            if level:
                res *= 2
        self.up = nn.ModuleList(up)
        self.norm_out = Normalize(ch)
        self.conv_out = _conv3(ch, cfg.out_ch)

    def forward(self, z):
        h = self.mid(self.conv_in(z.to(self.cfg.dtype)))
        for level in reversed(self.up):
            h = _run_level(level, h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class AutoencoderKL(nn.Module):
    """``encode`` -> (mean, logvar) through the 1x1 quant conv; ``decode``
    through the 1x1 post-quant conv (autoencoder.py AutoencoderKL)."""

    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = VAEEncoder(cfg)
        self.decoder = VAEDecoder(cfg)
        self.quant_conv = nn.Conv2d(2 * cfg.z_channels, 2 * cfg.embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(cfg.embed_dim, cfg.z_channels, 1)

    def encode(self, x):
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z.to(self.cfg.dtype)))
