"""Segment Anything (SAM): CG-Aug's box-prompted segmenter, the IoU gate.

Counterpart of ``multishiftseg_tpu/cgaug/sam.py``, with segment-anything's
module tree (Kirillov et al., 2023; Apache-2.0 facebookresearch/segment-anything),
so ``sam_vit_h_4b8939.pth`` loads by name (:func:`load_sam`):

* ``image_encoder``: ViT-det, 16x16 patch embed, absolute and decomposed
  relative positions, 14x14 windowed attention with periodic global blocks,
  a 1x1 + 3x3 neck with channel LayerNorm -> [B, 256, 64, 64] embeddings;
* ``prompt_encoder``: random-Fourier point encoding, a box as two corner
  points with learned corner embeddings, ``no_mask_embed``; the mask-input CNN
  and ``not_a_point_embed``, which the box path never runs, are left out, as
  JAX's converter skips them;
* ``mask_decoder``: the two-way transformer (token <-> image cross attention,
  2 layers, attention width halved), 4x transposed-conv upscaling, a
  hypernetwork MLP a mask token, the IoU head.

The encoder works channels-last inside, as the reference's; attention
logits and softmax compute in f32. :class:`SamPredictor` mirrors JAX's
``SamPredictor``: the longer side resized to ``img_size`` with JAX's
antialiased bilinear (``ops/resize.py::resize_bilinear_antialias``),
normalised, padded; the masks upscaled, cropped, resized to the image and
thresholded at 0.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_bilinear_antialias
from ..utils import resolve_device


@dataclasses.dataclass(frozen=True)
class SAMConfig:
    img_size: int = 1024
    patch: int = 16
    width: int = 1280
    depth: int = 32
    heads: int = 16
    global_blocks: Tuple[int, ...] = (7, 15, 23, 31)
    window: int = 14
    embed_dim: int = 256  # prompt/mask-decoder transformer dim
    decoder_heads: int = 8
    decoder_downsample: int = 2
    num_multimask: int = 3
    dtype: torch.dtype = torch.float32


def sam_vit_h() -> SAMConfig:
    return SAMConfig()


def sam_vit_l() -> SAMConfig:
    return SAMConfig(width=1024, depth=24, heads=16, global_blocks=(5, 11, 17, 23))


def sam_vit_b() -> SAMConfig:
    return SAMConfig(width=768, depth=12, heads=12, global_blocks=(2, 5, 8, 11))


def tiny_sam_config(**over) -> SAMConfig:
    kw = dict(img_size=64, width=16, depth=2, heads=2, global_blocks=(1,),
              window=2, embed_dim=16, decoder_heads=2)
    kw.update(over)
    return SAMConfig(**kw)


class LayerNorm2d(nn.Module):
    """Channel LayerNorm of an NCHW map, in f32 (segment-anything's ``LayerNorm2d``)."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x):
        x32 = x.float()
        mu = x32.mean(1, keepdim=True)
        var = ((x32 - mu) ** 2).mean(1, keepdim=True)
        y = (x32 - mu) / torch.sqrt(var + self.eps)
        return (y * self.weight.float()[:, None, None]
                + self.bias.float()[:, None, None]).to(x.dtype)


def window_partition(x: torch.Tensor, w: int):
    """[B, H, W, C] -> ([B*nw, w, w, C], padded (Hp, Wp)); zero right/bottom pad."""
    b, h, wd, c = x.shape
    ph, pw = (-h) % w, (-wd) % w
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, wd + pw
    x = x.reshape(b, hp // w, w, wp // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w, w, c), (hp, wp)


def window_unpartition(x: torch.Tensor, w: int, pad_hw, hw):
    hp, wp = pad_hw
    h, wd = hw
    b = x.shape[0] // ((hp // w) * (wp // w))
    x = x.reshape(b, hp // w, wp // w, w, w, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :h, :wd]


def rel_coords(q: int, k: int) -> np.ndarray:
    """Index table into a (2*max(q,k)-1)-long relative embedding (segment-anything
    ``get_rel_pos``; equal q and k here)."""
    ratio_k = max(q / k, 1.0)
    ratio_q = max(k / q, 1.0)
    qs = np.arange(q)[:, None] * ratio_q
    ks = np.arange(k)[None, :] * ratio_k
    return (qs - ks + (k - 1) * ratio_k).astype(np.int64)


class ViTAttention(nn.Module):
    """qkv attention with decomposed relative positions added to the f32 logits
    (``attn += q.Rh + q.Rw``); ``grid`` is the side the block attends over
    (the window, or the whole token grid for a global block)."""

    def __init__(self, dim: int, heads: int, grid: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        d = dim // heads
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * grid - 1, d))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * grid - 1, d))

    def forward(self, x):
        b, h, w, c = x.shape
        d = c // self.heads
        qkv = self.qkv(x).reshape(b, h * w, 3, self.heads, d)
        q, k, v = qkv.unbind(2)                                   # [b, hw, heads, d]
        attn = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * (d ** -0.5)
        idx_h = torch.from_numpy(rel_coords(h, h)).to(x.device)
        idx_w = torch.from_numpy(rel_coords(w, w)).to(x.device)
        rh = self.rel_pos_h.float()[idx_h]                        # [h, h, d]
        rw = self.rel_pos_w.float()[idx_w]                        # [w, w, d]
        qs = q.reshape(b, h, w, self.heads, d).float()
        add_h = torch.einsum("bxyhd,xid->bhxyi", qs, rh)
        add_w = torch.einsum("bxyhd,yjd->bhxyj", qs, rw)
        attn = attn.reshape(b, self.heads, h, w, h, w)
        attn = attn + add_h[:, :, :, :, :, None] + add_w[:, :, :, :, None, :]
        p = attn.reshape(b, self.heads, h * w, h * w).softmax(-1).to(x.dtype)
        del attn
        o = torch.einsum("bhnm,bmhd->bnhd", p, v).reshape(b, h, w, c)
        return self.proj(o)


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, act=F.gelu):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)
        self.act = act

    def forward(self, x):
        return self.lin2(self.act(self.lin1(x)))


class ViTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, grid: int):
        super().__init__()
        self.window = window  # 0 = global
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = ViTAttention(dim, heads, window or grid)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, 4 * dim)

    def forward(self, x):
        h0, w0 = x.shape[1], x.shape[2]
        s = self.norm1(x)
        if self.window:
            s, pad_hw = window_partition(s, self.window)
        s = self.attn(s)
        if self.window:
            s = window_unpartition(s, self.window, pad_hw, (h0, w0))
        x = x + s
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)

    def forward(self, x):
        return self.proj(x).permute(0, 2, 3, 1)


class SAMImageEncoder(nn.Module):
    """[B, 3, S, S] normalised, padded image -> [B, embed_dim, S/16, S/16]."""

    def __init__(self, cfg: SAMConfig = SAMConfig()):
        super().__init__()
        self.cfg = cfg
        g = cfg.img_size // cfg.patch
        self.patch_embed = PatchEmbed(cfg.patch, cfg.width)
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g, cfg.width))
        self.blocks = nn.ModuleList(
            ViTBlock(cfg.width, cfg.heads, 0 if i in cfg.global_blocks else cfg.window, g)
            for i in range(cfg.depth))
        D = cfg.embed_dim
        self.neck = nn.Sequential(nn.Conv2d(cfg.width, D, 1, bias=False), LayerNorm2d(D),
                                  nn.Conv2d(D, D, 3, padding=1, bias=False), LayerNorm2d(D))

    def forward(self, x):
        x = self.patch_embed(x.to(self.cfg.dtype))
        x = x + self.pos_embed.to(x.dtype)
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x.permute(0, 3, 1, 2))


# ---------------------------------------------------------------------------
# prompt encoder
# ---------------------------------------------------------------------------

class PositionEmbeddingRandom(nn.Module):
    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.randn(2, num_pos_feats))

    def forward(self, coords01: torch.Tensor) -> torch.Tensor:
        """Random-Fourier encoding of [..., 2] coordinates in [0, 1]."""
        c = (2.0 * coords01 - 1.0) @ self.positional_encoding_gaussian_matrix.float()
        c = c * (2.0 * np.pi)
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


class SAMPromptEncoder(nn.Module):
    """Box prompts (the CG-Aug path) and the no-mask dense embedding."""

    def __init__(self, cfg: SAMConfig = SAMConfig()):
        super().__init__()
        self.cfg = cfg
        D = cfg.embed_dim
        self.pe_layer = PositionEmbeddingRandom(D // 2)
        # 0/1: negative / positive points, 2/3: the box's corners
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, D) for _ in range(4))
        self.no_mask_embed = nn.Embedding(1, D)

    def forward(self, boxes_xyxy: Optional[torch.Tensor]):
        """-> (sparse [B, 2, D] or None, dense [1, D, g, g], image_pe [1, D, g, g])."""
        cfg = self.cfg
        g = cfg.img_size // cfg.patch
        dev = self.no_mask_embed.weight.device
        sparse = None
        if boxes_xyxy is not None:
            pts = (boxes_xyxy.float().reshape(-1, 2, 2) + 0.5) / cfg.img_size
            corners = torch.cat([self.point_embeddings[2].weight,
                                 self.point_embeddings[3].weight]).float()
            sparse = self.pe_layer(pts) + corners[None]
        ax = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g
        grid = torch.stack(torch.meshgrid(ax, ax, indexing="xy"), dim=-1)
        image_pe = self.pe_layer(grid).permute(2, 0, 1)[None]
        dense = self.no_mask_embed.weight.float().reshape(1, -1, 1, 1).expand(1, -1, g, g)
        return sparse, dense, image_pe


# ---------------------------------------------------------------------------
# two-way transformer mask decoder
# ---------------------------------------------------------------------------

class DecoderAttention(nn.Module):
    def __init__(self, dim: int, heads: int, downsample: int = 1):
        super().__init__()
        inner = dim // downsample
        self.heads = heads
        self.q_proj = nn.Linear(dim, inner)
        self.k_proj = nn.Linear(dim, inner)
        self.v_proj = nn.Linear(dim, inner)
        self.out_proj = nn.Linear(inner, dim)

    def forward(self, q, k, v):
        qq, kk, vv = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        b, inner = q.shape[0], qq.shape[-1]
        d = inner // self.heads
        qq = qq.reshape(b, -1, self.heads, d)
        kk = kk.reshape(b, -1, self.heads, d)
        vv = vv.reshape(b, -1, self.heads, d)
        sim = torch.einsum("bnhd,bmhd->bhnm", qq.float(), kk.float()) / np.sqrt(d)
        p = sim.softmax(-1).to(vv.dtype)
        o = torch.einsum("bhnm,bmhd->bnhd", p, vv).reshape(b, -1, inner)
        return self.out_proj(o)


class MLP(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int, layers: int = 3):
        super().__init__()
        dims = [dim] + [hidden] * (layers - 1)
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims, dims[1:] + [out]))

    def forward(self, x):
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class TwoWayBlock(nn.Module):
    def __init__(self, cfg: SAMConfig, skip_first_layer_pe: bool):
        super().__init__()
        D, ds = cfg.embed_dim, cfg.decoder_downsample
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = DecoderAttention(D, cfg.decoder_heads)
        self.norm1 = nn.LayerNorm(D)
        self.cross_attn_token_to_image = DecoderAttention(D, cfg.decoder_heads, ds)
        self.norm2 = nn.LayerNorm(D)
        self.mlp = MLPBlock(D, 8 * D, act=F.relu)
        self.norm3 = nn.LayerNorm(D)
        self.norm4 = nn.LayerNorm(D)
        self.cross_attn_image_to_token = DecoderAttention(D, cfg.decoder_heads, ds)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            # the first layer REPLACES the queries by the attention output
            queries = self.self_attn(queries, queries, queries)
        else:
            qpe = queries + query_pe
            queries = queries + self.self_attn(qpe, qpe, queries)
        queries = self.norm1(queries)
        a = self.cross_attn_token_to_image(queries + query_pe, keys + key_pe, keys)
        queries = self.norm2(queries + a)
        queries = self.norm3(queries + self.mlp(queries))
        a = self.cross_attn_image_to_token(keys + key_pe, queries + query_pe, queries)
        keys = self.norm4(keys + a)
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        D = cfg.embed_dim
        self.layers = nn.ModuleList(TwoWayBlock(cfg, skip_first_layer_pe=(i == 0))
                                    for i in range(2))
        self.final_attn_token_to_image = DecoderAttention(D, cfg.decoder_heads,
                                                          cfg.decoder_downsample)
        self.norm_final_attn = nn.LayerNorm(D)


class SAMMaskDecoder(nn.Module):
    def __init__(self, cfg: SAMConfig = SAMConfig()):
        super().__init__()
        self.cfg = cfg
        D = cfg.embed_dim
        nm = cfg.num_multimask + 1
        self.iou_token = nn.Embedding(1, D)
        self.mask_tokens = nn.Embedding(nm, D)
        self.transformer = TwoWayTransformer(cfg)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(D, D // 4, 2, stride=2), LayerNorm2d(D // 4), nn.GELU(),
            nn.ConvTranspose2d(D // 4, D // 8, 2, stride=2), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(MLP(D, D, D // 8) for _ in range(nm))
        self.iou_prediction_head = MLP(D, D, nm)

    def forward(self, image_embed, image_pe, sparse, dense):
        """image_embed [1, D, g, g] (one image, shared by the boxes), sparse
        [B, n, D] -> (low-res mask logits [B, 1+M, 4g, 4g], iou_pred [B, 1+M])."""
        D = self.cfg.embed_dim
        b = sparse.shape[0]
        toks = torch.cat([self.iou_token.weight, self.mask_tokens.weight]).to(sparse.dtype)
        tokens = torch.cat([toks[None].expand(b, -1, -1), sparse], dim=1)
        src = (image_embed + dense.to(image_embed.dtype)).expand(b, -1, -1, -1)
        g = src.shape[-1]
        keys = src.flatten(2).transpose(1, 2)
        key_pe = image_pe.flatten(2).transpose(1, 2).expand(b, -1, -1).to(keys.dtype)
        queries = tokens.to(keys.dtype)
        tokens = queries
        tr = self.transformer
        for layer in tr.layers:
            queries, keys = layer(queries, keys, tokens, key_pe)
        a = tr.final_attn_token_to_image(queries + tokens, keys + key_pe, keys)
        queries = tr.norm_final_attn(queries + a)
        nm = self.cfg.num_multimask + 1
        img = self.output_upscaling(keys.transpose(1, 2).reshape(b, D, g, g))
        hyper = torch.stack([mlp(queries[:, 1 + i]) for i, mlp in
                             enumerate(self.output_hypernetworks_mlps)], dim=1)
        masks = torch.einsum("bnc,bchw->bnhw", hyper, img)
        return masks, self.iou_prediction_head(queries[:, 0])


class SAM(nn.Module):
    """Box-prompted segmentation: the padded image -> low-res mask logits."""

    def __init__(self, cfg: SAMConfig = SAMConfig()):
        super().__init__()
        self.cfg = cfg
        self.image_encoder = SAMImageEncoder(cfg)
        self.prompt_encoder = SAMPromptEncoder(cfg)
        self.mask_decoder = SAMMaskDecoder(cfg)

    def encode_image(self, x):
        return self.image_encoder(x)

    def decode_box(self, image_embed, boxes_xyxy):
        sparse, dense, image_pe = self.prompt_encoder(boxes_xyxy)
        return self.mask_decoder(image_embed, image_pe, sparse.to(image_embed.dtype), dense)

    def forward(self, x, boxes_xyxy):
        return self.decode_box(self.encode_image(x), boxes_xyxy)


# the checkpoint's keys the box path never reads: JAX's ``convert_sam`` reports
# exactly these as skipped, and the loader drops exactly them
SKIPPED_PREFIXES = ("prompt_encoder.not_a_point_embed.", "prompt_encoder.mask_downscaling.")


def load_sam(path: str, cfg: SAMConfig = SAMConfig()) -> SAM:
    """``sam_vit_*.pth`` -> :class:`SAM` on the CPU: the skipped keys dropped,
    every other key loaded strictly (a missing or unexpected one raises)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    model = SAM(cfg)
    model.load_state_dict({k: v for k, v in state.items()
                           if not k.startswith(SKIPPED_PREFIXES)}, strict=True)
    return model.eval()


# ---------------------------------------------------------------------------
# predictor (the SamPredictor surface CG-Aug uses)
# ---------------------------------------------------------------------------

PIXEL_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
PIXEL_STD = np.array([58.395, 57.12, 57.375], np.float32)
MASK_THRESHOLD = 0.0


class SamPredictor:
    """``set_image`` caches the ViT embedding; ``predict(box=...)`` returns
    binary masks at the image's resolution (segment_anything.SamPredictor's
    box, ``multimask_output=False`` path, as JAX's)."""

    def __init__(self, model: SAM):
        self.model = model.to(model.cfg.dtype).eval()
        self.cfg = model.cfg
        self.device = next(model.parameters()).device
        self._embed = None
        self._orig_hw = None
        self._input_hw = None

    def _scale(self, h, w):
        return self.cfg.img_size / max(h, w)

    @torch.no_grad()
    def set_image(self, image: np.ndarray):
        h, w = image.shape[:2]
        s = self._scale(h, w)
        nh, nw = int(h * s + 0.5), int(w * s + 0.5)
        x = torch.from_numpy(np.asarray(image, np.float32)).to(self.device)
        x = resize_bilinear_antialias(x.permute(2, 0, 1)[None], (nh, nw))
        mean = torch.from_numpy(PIXEL_MEAN).to(self.device)[:, None, None]
        std = torch.from_numpy(PIXEL_STD).to(self.device)[:, None, None]
        x = (x - mean) / std
        x = F.pad(x, (0, self.cfg.img_size - nw, 0, self.cfg.img_size - nh))
        self._embed = self.model.encode_image(x)
        self._orig_hw = (h, w)
        self._input_hw = (nh, nw)

    @torch.no_grad()
    def mask_logits(self, box, multimask_output: bool = False):
        """-> (mask logits [B, M, H, W] at the image's size, iou [B, M],
        low-res logits [B, M, 4g, 4g]) for boxes [B, 4] (or one box): what
        :meth:`predict` thresholds, on the model's device."""
        if self._embed is None:
            raise RuntimeError("call set_image first")
        h, w = self._orig_hw
        s = self._scale(h, w)
        boxes = torch.from_numpy(np.asarray(box, np.float32).reshape(-1, 4) * s)
        masks, iou = self.model.decode_box(self._embed, boxes.to(self.device))
        sl = slice(0, 1) if not multimask_output else slice(1, None)
        masks, iou = masks[:, sl].float(), iou[:, sl].float()
        size = self.cfg.img_size
        full = resize_bilinear_antialias(masks, (size, size))
        full = full[:, :, : self._input_hw[0], : self._input_hw[1]]
        return resize_bilinear_antialias(full, (h, w)), iou, masks

    def predict(self, box=None, multimask_output: bool = False):
        """-> (masks [M, H, W] bool, iou [M], low-res logits [M, 4g, 4g]) for
        one box; a leading box axis for several."""
        if box is None:
            raise ValueError("box prompts only (the CG-Aug path)")
        full, iou, low = self.mask_logits(box, multimask_output)
        out = (full > MASK_THRESHOLD).cpu().numpy()
        iou, low = iou.cpu().numpy(), low.cpu().numpy()
        if np.asarray(box).ndim == 1 or np.asarray(box).shape[0] == 1:
            return out[0], iou[0], low[0]
        return out, iou, low


class SAMSegmenter:
    """:class:`cgaug.generate.PromptableSegmenter` over SAM, on ``device``
    (CUDA unless the caller asks for the CPU)."""

    def __init__(self, model: SAM, device="cuda"):
        self.predictor = SamPredictor(model.to(resolve_device(device)))

    def segment_box(self, image: np.ndarray, box_xyxy: np.ndarray) -> np.ndarray:
        self.predictor.set_image(image)
        masks, _, _ = self.predictor.predict(box=np.asarray(box_xyxy), multimask_output=False)
        return masks[0].astype(bool)
