"""Swin Transformer backbone: windowed attention, shifted windows, patch merging.

Counterpart of ``multishiftseg_tpu/models/swin.py`` (the reference's
``modeling/backbone/swin.py`` with the ``D2SwinTransformer`` wrapper's per-stage
output norms), exposing res2..res5. Module names follow the reference's state
dict, as ``multishiftseg_tpu/convert/torch2jax.py:140-191`` reads it:
``patch_embed.{proj,norm}``, ``layers.{s}.blocks.{b}.{norm1, attn.qkv,
attn.proj, attn.relative_position_bias_table, norm2, mlp.fc1, mlp.fc2}``,
``layers.{s}.downsample.{norm,reduction}`` and ``norm{s}``. The relative
position index is a non-persistent buffer; the shifted windows' masks are built
on the host per (Hp, Wp, window, shift) and kept on the device by shape.

Window attention is plain ``torch.matmul`` and softmax, as JAX computes it with
einsums outside any kernel: logits in f32, then the relative-position bias, then
the shift mask, then an f32 softmax. Inside the backbone the maps are
channels-last ``[N, H, W, C]``; the input and the res2..res5 outputs are
channels-first.

Stochastic depth acts in training mode only and takes its keep masks from the
caller (:meth:`SwinTransformer.draw_drop_path_masks`), one bool per image for
each residual branch of each block whose rate is above 0, as ``Dropout2d``
takes its masks in the DeepLab trunk.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core import tensor_parallel as tp
from ..utils import cached

SWIN_CONFIGS = {
    "tiny": dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24), window_size=7),
    "small": dict(embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24), window_size=7),
    "base": dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32), window_size=12),
    "large": dict(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48),
                  window_size=12),
}


@functools.lru_cache(maxsize=32)
def _relative_position_index(ws: int) -> np.ndarray:
    """[ws^2, ws^2] index into the (2ws-1)^2 relative-position bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


@functools.lru_cache(maxsize=128)
def _shift_attn_mask(hp: int, wp: int, ws: int, shift: int) -> Optional[np.ndarray]:
    """[num_windows, ws^2, ws^2] additive f32 mask (-100 blocked, 0 allowed) of
    the shifted windows over an [hp, wp] map; None without a shift."""
    if shift == 0:
        return None
    img = np.zeros((hp, wp))
    cnt = 0
    for h in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for w in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[h, w] = cnt
            cnt += 1
    win = img.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def drop_path(x: torch.Tensor, rate: float, keep_mask: torch.Tensor) -> torch.Tensor:
    """Per-sample stochastic depth (timm ``DropPath``): ``x * keep / (1 - rate)``
    with ``keep_mask`` bool [N] (JAX ``drop_path``, :91)."""
    keep = 1.0 - rate
    return x * keep_mask.to(x.dtype).view(-1, *([1] * (x.dim() - 1))) / keep


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            nn.init.trunc_normal_(torch.empty((2 * window_size - 1) ** 2, num_heads), std=0.02))
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(_relative_position_index(window_size)).reshape(-1),
            persistent=False)

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """x [N * nW, L, C] windows; attn_mask [nW, L, L] f32 or None."""
        n, l, c = x.shape
        h = self.num_heads
        d = c // h
        q, k, v = self.qkv(x).reshape(n, l, 3, h, d).permute(2, 0, 3, 1, 4)
        # f32 logits (float64 in a float64 model)
        acc = torch.promote_types(q.dtype, torch.float32)
        logits = torch.matmul(q * d ** -0.5, k.transpose(-2, -1)).to(acc)
        bias = self.relative_position_bias_table[self.relative_position_index]
        logits = logits + bias.reshape(l, l, h).permute(2, 0, 1)[None].to(acc)
        if attn_mask is not None:
            nw = attn_mask.shape[0]
            logits = logits.view(n // nw, nw, h, l, l) + attn_mask[None, :, None]
            logits = logits.view(n, h, l, l)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(n, l, c)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # exact (erf) GELU, as JAX's; on fc1's slices under tensor parallelism
        return self.fc2(tp.full(tp.elementwise(F.gelu, tp.apply(self.fc1, x))))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int, shift_size: int,
                 mlp_ratio: float = 4.0, drop_path_rate: float = 0.0):
        super().__init__()
        self.window_size, self.shift_size = window_size, shift_size
        self.drop_path_rate = drop_path_rate
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, window_size)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor],
                keep: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        """x [N, H, W, C]; ``attn_mask`` the shift mask of the padded map;
        ``keep`` the (attention, MLP) branches' drop-path masks, bool [N] each,
        in training when this block's rate is above 0."""
        n, h, w, c = x.shape
        # the configured window and shift on every map, padded up to window
        # multiples even when H or W is smaller than a window (JAX :113-116)
        ws, shift = self.window_size, self.shift_size
        shortcut = x
        x = self.norm1(x)
        ph, pw = (-h) % ws, (-w) % ws
        if ph or pw:
            x = F.pad(x, (0, 0, 0, pw, 0, ph))
        hp, wp = h + ph, w + pw
        if shift:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        xw = x.reshape(n, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
        xw = self.attn(xw.reshape(-1, ws * ws, c), attn_mask)
        x = xw.reshape(n, hp // ws, wp // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(n, hp, wp, c)
        if shift:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = x[:, :h, :w]
        if keep is not None:
            x = drop_path(x, self.drop_path_rate, keep[0])
        x = shortcut + x
        y = self.mlp(self.norm2(x))
        if keep is not None:
            y = drop_path(y, self.drop_path_rate, keep[1])
        return x + y


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[N, H, W, C] -> [N, ceil(H/2), ceil(W/2), 2C]; odd sides padded at the end."""
        h, w = x.shape[1:3]
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class PatchEmbed(nn.Module):
    """4x4 / 4 conv with flax's ``SAME`` padding (the remainder split low / high,
    the low side taking the smaller half), then LayerNorm, channels-last out."""

    def __init__(self, embed_dim: int, patch: int = 4):
        super().__init__()
        self.patch = patch
        self.proj = nn.Conv2d(3, embed_dim, patch, stride=patch)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch
        ph, pw = (-x.shape[2]) % p, (-x.shape[3]) % p
        if ph or pw:
            x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        return self.norm(self.proj(x).permute(0, 2, 3, 1))


class BasicLayer(nn.Module):
    def __init__(self, blocks: List[SwinBlock], downsample: Optional[PatchMerging]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class SwinTransformer(nn.Module):
    """[N, 3, H, W] -> {'res2': s4, 'res3': s8, 'res4': s16, 'res5': s32},
    channels-first, each after its stage's output norm."""

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 mlp_ratio: float = 4.0, drop_path_rate: float = 0.3):
        super().__init__()
        self.window_size = window_size
        self.patch_embed = PatchEmbed(embed_dim)
        # stochastic depth over a linspace of all blocks (JAX :191-193)
        dpr = np.linspace(0.0, drop_path_rate, sum(depths))
        self.layers = nn.ModuleList()
        dim, done = embed_dim, 0
        for stage, depth in enumerate(depths):
            blocks = [SwinBlock(dim, num_heads[stage], window_size,
                                0 if b % 2 == 0 else window_size // 2, mlp_ratio,
                                float(dpr[done + b])) for b in range(depth)]
            last = stage == len(depths) - 1
            self.layers.append(BasicLayer(blocks, None if last else PatchMerging(dim)))
            self.add_module(f"norm{stage}", nn.LayerNorm(dim, eps=1e-5))
            done += depth
            dim = dim if last else 2 * dim
        # shift masks on the device, by (Hp, Wp, shift, device)
        self._masks: Dict[tuple, Optional[torch.Tensor]] = {}

    def drop_path_rates(self) -> List[float]:
        """The rate of each drop-path call of a training forward, in order:
        (attention, MLP) of every block whose rate is above 0."""
        return [b.drop_path_rate for layer in self.layers for b in layer.blocks
                for _ in range(2) if b.drop_path_rate > 0]

    def draw_drop_path_masks(self, batch: int, generator: Optional[torch.Generator],
                             device) -> torch.Tensor:
        """Keep masks, bool [calls, batch], each row kept with probability
        1 - its rate, from ``generator``."""
        rates = torch.tensor(self.drop_path_rates(), dtype=torch.float32, device=device)
        u = torch.rand((len(rates), batch), generator=generator, device=device)
        return u < (1.0 - rates)[:, None]

    def _mask(self, hp: int, wp: int, shift: int, device) -> Optional[torch.Tensor]:
        def make():
            m = _shift_attn_mask(hp, wp, self.window_size, shift)
            return None if m is None else torch.from_numpy(m).to(device)

        return cached(self._masks, (hp, wp, shift, str(device)), make)

    def forward(self, x: torch.Tensor, drop_path_masks: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """x [N, 3, H, W]; ``drop_path_masks`` (:meth:`draw_drop_path_masks`)
        is required in training mode when a block's rate is above 0."""
        x = self.patch_embed(x)
        ws = self.window_size
        call = 0
        feats = {}
        for stage, layer in enumerate(self.layers):
            hp, wp = -(-x.shape[1] // ws) * ws, -(-x.shape[2] // ws) * ws
            for block in layer.blocks:
                keep = None
                if self.training and block.drop_path_rate > 0:
                    if drop_path_masks is None:
                        raise ValueError("Swin in training needs its drop-path keep masks "
                                         "(draw_drop_path_masks)")
                    keep = (drop_path_masks[call], drop_path_masks[call + 1])
                    call += 2
                x = block(x, self._mask(hp, wp, block.shift_size, x.device), keep)
            feats[f"res{stage + 2}"] = getattr(self, f"norm{stage}")(x).permute(0, 3, 1, 2)
            if layer.downsample is not None:
                x = layer.downsample(x)
        return feats


SWIN_FEATURE_CHANNELS = {
    name: {f"res{i + 2}": cfg["embed_dim"] * (2 ** i) for i in range(4)}
    for name, cfg in SWIN_CONFIGS.items()
}
