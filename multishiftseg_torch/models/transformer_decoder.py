"""Mask2Anomaly GMA (global masked attention) transformer decoder.

Counterpart of ``multishiftseg_tpu/models/transformer_decoder.py``
(``MultiScaleMaskedTransformerDecoderGMA``, :29-224): layers of
[fg + bg masked cross attention -> self attention -> FFN] round-robin over three
scales, per-layer class and mask heads, and the duplicate OOD class head
``class_embed2`` sharing ``mask_embed``. Module names follow the reference
(``transformer_cross_attention_layers.{i}.multihead_attn_foreground``, ...).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize_bilinear_nchw
from ..utils import cached
from .attention import MultiheadAttention
from .layers import MLP
from .position_encoding import position_embedding_sine


class SelfAttentionLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.norm = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, tgt, query_pos):
        q = tgt + query_pos
        return self.norm(tgt + self.self_attn(q, q, tgt))


class GlobalCrossAttentionLayer(nn.Module):
    """Foreground- and background-masked cross attentions, summed."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.multihead_attn_foreground = MultiheadAttention(d_model, nhead)
        self.multihead_attn_background = MultiheadAttention(d_model, nhead)
        self.norm = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, tgt, memory, mask_fg, mask_bg, pos, query_pos):
        q = tgt + query_pos
        k = memory + pos
        fg = self.multihead_attn_foreground(q, k, memory, mask_fg)
        bg = self.multihead_attn_background(q, k, memory, mask_bg)
        return self.norm(tgt + fg + bg)


class CrossAttentionLayer(nn.Module):
    """One foreground-masked cross attention (the vanilla decoder's)."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.multihead_attn = MultiheadAttention(d_model, nhead)
        self.norm = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, tgt, memory, mask, pos, query_pos):
        return self.norm(tgt + self.multihead_attn(tgt + query_pos, memory + pos, memory,
                                                   mask))


class FFNLayer(nn.Module):
    def __init__(self, d_model: int, dim_feedforward: int):
        super().__init__()
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, tgt):
        return self.norm(tgt + self.linear2(F.relu(self.linear1(tgt))))


def attn_masks_from_logits(outputs_mask: torch.Tensor, target_hw):
    """Resize [N, Q, h, w] mask logits to the next attention resolution and
    threshold their sigmoid at 0.5 -> (fg, bg) bool masks [N, 1, Q, HW], True =
    disallowed (``transformer_decoder.py:86-96``; broadcast over heads)."""
    m = resize_bilinear_nchw(outputs_mask, target_hw, align_corners=False)
    flat = torch.sigmoid(m.float()).flatten(2)[:, None]
    return flat < 0.5, flat > 0.5


class _LevelInputs:
    """What both decoders do first: the multi-scale sources with their level
    embeddings, the sine position embeddings (built once per size and device),
    and the learned queries broadcast over the batch."""

    def _position_embedding(self, h, w, device):
        return cached(self._pos, (h, w, str(device)),
                      lambda: position_embedding_sine(h, w, self.hidden_dim, device=device))

    def _inputs(self, x: Sequence[torch.Tensor]):
        """x: channels-first maps, low -> high resolution -> (sources [N, HW, C],
        position embeddings, sizes, query features, query positions)."""
        if len(x) != self.num_feature_levels:
            raise ValueError(f"expected {self.num_feature_levels} levels, got {len(x)}")
        n = x[0].shape[0]
        srcs, poss, sizes = [], [], []
        for i, xi in enumerate(x):
            h, w = xi.shape[-2:]
            sizes.append((h, w))
            pe = self._position_embedding(h, w, xi.device)
            poss.append(pe.to(xi.dtype).reshape(1, h * w, self.hidden_dim).expand(n, -1, -1))
            srcs.append(xi.flatten(2).transpose(1, 2)
                        + self.level_embed.weight[i].to(xi.dtype))
        dtype = srcs[0].dtype
        output = self.query_feat.weight[None].expand(n, -1, -1).to(dtype)
        query_pos = self.query_embed.weight[None].expand(n, -1, -1).to(dtype)
        return srcs, poss, sizes, output, query_pos


def _mask_product(mask_embed, mask_features):
    """f32 mask logits [N, Q, H, W]: an f32 island, as in the JAX decoders
    (autocast would run it in bf16)."""
    with torch.autocast(mask_features.device.type, enabled=False):
        return torch.einsum("nqc,nchw->nqhw", mask_embed.float(), mask_features.float())


class MultiScaleMaskedTransformerDecoderGMA(_LevelInputs, nn.Module):
    def __init__(self, num_classes: int = 19, hidden_dim: int = 256,
                 num_queries: int = 100, nheads: int = 8, dim_feedforward: int = 2048,
                 dec_layers: int = 9, mask_dim: int = 256, num_feature_levels: int = 3):
        super().__init__()
        self.hidden_dim, self.num_queries = hidden_dim, num_queries
        self.num_feature_levels = num_feature_levels
        self.query_feat = nn.Embedding(num_queries, hidden_dim)
        self.query_embed = nn.Embedding(num_queries, hidden_dim)
        self.level_embed = nn.Embedding(num_feature_levels, hidden_dim)
        self.transformer_cross_attention_layers = nn.ModuleList(
            GlobalCrossAttentionLayer(hidden_dim, nheads) for _ in range(dec_layers))
        self.transformer_self_attention_layers = nn.ModuleList(
            SelfAttentionLayer(hidden_dim, nheads) for _ in range(dec_layers))
        self.transformer_ffn_layers = nn.ModuleList(
            FFNLayer(hidden_dim, dim_feedforward) for _ in range(dec_layers))
        self.decoder_norm = nn.LayerNorm(hidden_dim, eps=1e-5)
        self.class_embed = nn.Linear(hidden_dim, num_classes + 1)
        self.class_embed2 = nn.Linear(hidden_dim, num_classes + 1)
        self.mask_embed = MLP(hidden_dim, hidden_dim, mask_dim, 3)
        # per-instance device copies of the host-built position embeddings
        self._pos: Dict[tuple, torch.Tensor] = {}

    def _predict(self, output, mask_features):
        """Decoder state -> (class logits [N,Q,K+1], OOD class logits, f32 mask
        logits [N,Q,H,W]). The OOD head shares ``mask_embed``, so one mask
        product serves both heads."""
        x = self.decoder_norm(output)
        mask_embed = self.mask_embed(x)
        return self.class_embed(x), self.class_embed2(x), _mask_product(mask_embed,
                                                                        mask_features)

    def forward(self, x: Sequence[torch.Tensor],
                mask_features: torch.Tensor) -> Dict[str, object]:
        """x: channels-first multi-scale maps, low -> high resolution;
        mask_features [N, mask_dim, H/4, W/4]."""
        srcs, poss, sizes, output, query_pos = self._inputs(x)

        pred_class: List[torch.Tensor] = []
        pred_mask: List[torch.Tensor] = []
        pred_class_ood: List[torch.Tensor] = []
        pred_mask_ood: List[torch.Tensor] = []

        outputs_class, _, outputs_mask = self._predict(output, mask_features)
        mask_fg, mask_bg = attn_masks_from_logits(outputs_mask, sizes[0])
        pred_class.append(outputs_class)
        pred_mask.append(outputs_mask)

        num_layers = len(self.transformer_cross_attention_layers)
        for i in range(num_layers):
            li = i % self.num_feature_levels
            output = self.transformer_cross_attention_layers[i](
                output, srcs[li], mask_fg, mask_bg, poss[li], query_pos)
            output = self.transformer_self_attention_layers[i](output, query_pos)
            output = self.transformer_ffn_layers[i](output)
            outputs_class, outputs_class_ood, outputs_mask = self._predict(
                output, mask_features)
            if i + 1 < num_layers:
                mask_fg, mask_bg = attn_masks_from_logits(
                    outputs_mask, sizes[(i + 1) % self.num_feature_levels])
            pred_class.append(outputs_class)
            pred_mask.append(outputs_mask)
            pred_class_ood.append(outputs_class_ood)
            pred_mask_ood.append(outputs_mask)

        # zip truncates to the OOD lists' length, as the JAX decoder does
        aux = [
            {"pred_logits": a, "pred_masks": b, "pred_logits_ood": c, "pred_masks_ood": d}
            for a, b, c, d in zip(pred_class[:-1], pred_mask[:-1],
                                  pred_class_ood[:-1], pred_mask_ood[:-1])
        ]
        return {
            "pred_logits": pred_class[-1],
            "pred_masks": pred_mask[-1],
            "pred_logits_ood": pred_class_ood[-1],
            "pred_masks_ood": pred_mask_ood[-1],
            "aux_outputs": aux,
        }


class MultiScaleMaskedTransformerDecoder(_LevelInputs, nn.Module):
    """The vanilla Mask2Former decoder: [foreground-masked cross attention ->
    self attention -> FFN] per layer, one class head, no OOD head. Each layer
    attends where the previous prediction's resized mask logit is positive
    (a row masked everywhere attends everywhere, see ``attention.py``)."""

    def __init__(self, num_classes: int = 19, hidden_dim: int = 256,
                 num_queries: int = 100, nheads: int = 8, dim_feedforward: int = 2048,
                 dec_layers: int = 9, mask_dim: int = 256, num_feature_levels: int = 3):
        super().__init__()
        self.hidden_dim, self.num_queries = hidden_dim, num_queries
        self.num_feature_levels = num_feature_levels
        self.query_feat = nn.Embedding(num_queries, hidden_dim)
        self.query_embed = nn.Embedding(num_queries, hidden_dim)
        self.level_embed = nn.Embedding(num_feature_levels, hidden_dim)
        self.transformer_cross_attention_layers = nn.ModuleList(
            CrossAttentionLayer(hidden_dim, nheads) for _ in range(dec_layers))
        self.transformer_self_attention_layers = nn.ModuleList(
            SelfAttentionLayer(hidden_dim, nheads) for _ in range(dec_layers))
        self.transformer_ffn_layers = nn.ModuleList(
            FFNLayer(hidden_dim, dim_feedforward) for _ in range(dec_layers))
        self.decoder_norm = nn.LayerNorm(hidden_dim, eps=1e-5)
        self.class_embed = nn.Linear(hidden_dim, num_classes + 1)
        self.mask_embed = MLP(hidden_dim, hidden_dim, mask_dim, 3)
        self._pos: Dict[tuple, torch.Tensor] = {}

    def _predict(self, output, mask_features):
        """Decoder state -> (class logits [N, Q, K+1], f32 mask logits [N, Q, H, W])."""
        x = self.decoder_norm(output)
        return self.class_embed(x), _mask_product(self.mask_embed(x), mask_features)

    def forward(self, x: Sequence[torch.Tensor],
                mask_features: torch.Tensor) -> Dict[str, object]:
        """x: channels-first multi-scale maps, low -> high resolution;
        mask_features [N, mask_dim, H/4, W/4]."""
        srcs, poss, sizes, output, query_pos = self._inputs(x)
        outputs_class, outputs_mask = self._predict(output, mask_features)
        pred_class, pred_mask = [outputs_class], [outputs_mask]
        num_layers = len(self.transformer_cross_attention_layers)
        for i in range(num_layers):
            li = i % self.num_feature_levels
            mask_fg = attn_masks_from_logits(outputs_mask, sizes[li])[0]
            output = self.transformer_cross_attention_layers[i](
                output, srcs[li], mask_fg, poss[li], query_pos)
            output = self.transformer_self_attention_layers[i](output, query_pos)
            output = self.transformer_ffn_layers[i](output)
            outputs_class, outputs_mask = self._predict(output, mask_features)
            pred_class.append(outputs_class)
            pred_mask.append(outputs_mask)
        aux = [{"pred_logits": a, "pred_masks": b}
               for a, b in zip(pred_class[:-1], pred_mask[:-1])]
        return {"pred_logits": pred_class[-1], "pred_masks": pred_mask[-1],
                "aux_outputs": aux}
