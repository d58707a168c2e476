"""MaskFormer-v1 predictor: a DETR decoder over one feature map.

Counterpart of ``multishiftseg_tpu/models/maskformer_v1_decoder.py`` (the
reference's ``StandardTransformerDecoder``, ``maskformer_transformer_decoder.py:
30-188``, with the DETR ``Transformer`` decoder of ``transformer.py``): learned
query embeddings cross-attend to the top feature map (post-norm layers); each
layer's output goes through the shared ``decoder_norm`` into the class head and
the mask-embedding MLP, whose product with the mask features gives the masks.

Module names follow the reference: ``transformer.decoder.layers.{i}.{self_attn,
multihead_attn, linear1, linear2, norm1..3}``, ``transformer.decoder.norm``,
``query_embed``, ``class_embed``, ``mask_embed.layers.{i}``. The map enters
with ``hidden_dim`` channels, as every pixel decoder of ``MaskFormer`` gives it
(JAX's projection for other widths, a dense ``input_proj``, never runs there).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from .attention import MultiheadAttention
from .layers import MLP
from .position_encoding import position_embedding_sine
from .transformer_decoder import _mask_product


class DETRDecoderLayer(nn.Module):
    """JAX ``DETRDecoderLayer`` (:22): self attention, cross attention, FFN,
    each followed by its LayerNorm."""

    def __init__(self, d_model: int = 256, nheads: int = 8, dim_feedforward: int = 2048):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nheads)
        self.multihead_attn = MultiheadAttention(d_model, nheads)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, tgt, memory, pos, query_pos):
        q = tgt + query_pos
        tgt = self.norm1(tgt + self.self_attn(q, q, tgt))
        tgt = self.norm2(tgt + self.multihead_attn(tgt + query_pos, memory + pos, memory))
        return self.norm3(tgt + self.linear2(F.relu(self.linear1(tgt))))


class _Decoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, **layer_kwargs):
        super().__init__()
        self.layers = nn.ModuleList(DETRDecoderLayer(d_model, **layer_kwargs)
                                    for _ in range(num_layers))
        self.norm = nn.LayerNorm(d_model, eps=1e-5)


class _Transformer(nn.Module):
    def __init__(self, num_layers: int, d_model: int, **layer_kwargs):
        super().__init__()
        self.decoder = _Decoder(num_layers, d_model, **layer_kwargs)


class StandardTransformerDecoder(nn.Module):
    """MaskFormer-v1 predictor over (top feature map, mask features)."""

    def __init__(self, num_classes: int = 19, hidden_dim: int = 256, num_queries: int = 100,
                 nheads: int = 8, dim_feedforward: int = 2048, dec_layers: int = 6,
                 mask_dim: int = 256, deep_supervision: bool = True):
        super().__init__()
        self.hidden_dim, self.num_queries = hidden_dim, num_queries
        self.deep_supervision = deep_supervision
        self.transformer = _Transformer(dec_layers, hidden_dim, nheads=nheads,
                                        dim_feedforward=dim_feedforward)
        self.query_embed = nn.Embedding(num_queries, hidden_dim)
        nn.init.normal_(self.query_embed.weight, std=1.0)
        self.class_embed = nn.Linear(hidden_dim, num_classes + 1)
        self.mask_embed = MLP(hidden_dim, hidden_dim, mask_dim, 3)

    def forward(self, x: torch.Tensor, mask_features: torch.Tensor) -> Dict[str, object]:
        """x: [N, hidden_dim, H, W] top feature map; mask_features: [N, mask_dim, H4, W4].
        Returns the last layer's ``pred_logits`` [N, Q, K+1] and f32
        ``pred_masks`` [N, Q, H4, W4], and the earlier layers' as ``aux_outputs``."""
        n, _, h, w = x.shape
        memory = x.flatten(2).transpose(1, 2)
        pos = position_embedding_sine(h, w, self.hidden_dim, device=x.device)
        pos = pos.reshape(1, h * w, -1).to(memory.dtype)
        query_pos = self.query_embed.weight[None].expand(n, -1, -1).to(memory.dtype)
        tgt = torch.zeros_like(query_pos)
        dec = self.transformer.decoder
        outs = []
        for layer in dec.layers:
            tgt = layer(tgt, memory, pos, query_pos)
            y = dec.norm(tgt)
            outs.append({"pred_logits": self.class_embed(y),
                         "pred_masks": _mask_product(self.mask_embed(y), mask_features)})
        return {**outs[-1], "aux_outputs": outs[:-1] if self.deep_supervision else []}
