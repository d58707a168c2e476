"""CLIP ViT-L/14 text encoder (the SD conditioning stage) and CLIP's BPE tokenizer.

Counterpart of ``multishiftseg_tpu/cgaug/clip_text.py``. The reference
conditions generation through ``FrozenCLIPEmbedder``
(``CGAug/ControlNet/ldm/modules/encoders/modules.py:88-140``): huggingface
``CLIPTextModel`` (openai/clip-vit-large-patch14), tokens padded to 77, the
last hidden state (after the final layer norm) as the cross-attention context.
:class:`CLIPTextEncoder` holds the checkpoint's own names under
``cond_stage_model.transformer.text_model.`` (``embeddings.*``,
``encoder.layers.{i}.*``, ``final_layer_norm``): causal pre-LN blocks,
quick-GELU MLPs, learned positions, attention logits and softmax in f32.

The tokenizer is pure Python and a copy of JAX's: CLIP's byte-level BPE over
``vocab.json`` / ``merges.txt`` (lowercased, whitespace cleaned, ``</w>``
word ends), padded with the end token to a fixed length.
"""

from __future__ import annotations

import dataclasses
import gzip
import html
import json
import os
import re
from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    width: int = 768
    layers: int = 12
    heads: int = 12
    max_len: int = 77
    mlp_ratio: int = 4
    act: str = "quick_gelu"  # ViT-L/14 text tower
    dtype: torch.dtype = torch.float32


def tiny_clip_config(**over) -> CLIPTextConfig:
    kw = dict(vocab_size=97, width=32, layers=2, heads=4)
    kw.update(over)
    return CLIPTextConfig(**kw)


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return lambda x: nn.functional.gelu(x)
    raise ValueError(name)


class CLIPAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, x, mask):
        b, n, c = x.shape
        d = c // self.heads
        q = self.q_proj(x).reshape(b, n, self.heads, d)
        k = self.k_proj(x).reshape(b, n, self.heads, d)
        v = self.v_proj(x).reshape(b, n, self.heads, d)
        sim = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * (d ** -0.5)
        sim = sim.masked_fill(~mask, torch.finfo(torch.float32).min)
        attn = sim.softmax(-1).to(v.dtype)
        o = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b, n, c)
        return self.out_proj(o)


class CLIPMLP(nn.Module):
    def __init__(self, width: int, hidden: int, act: str):
        super().__init__()
        self.fc1 = nn.Linear(width, hidden)
        self.fc2 = nn.Linear(hidden, width)
        self.act = _act(act)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPTextBlock(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.self_attn = CLIPAttention(cfg.width, cfg.heads)
        self.layer_norm1 = nn.LayerNorm(cfg.width, eps=1e-5)
        self.mlp = CLIPMLP(cfg.width, cfg.width * cfg.mlp_ratio, cfg.act)
        self.layer_norm2 = nn.LayerNorm(cfg.width, eps=1e-5)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.position_embedding = nn.Embedding(cfg.max_len, cfg.width)

    def forward(self, tokens):
        return self.token_embedding(tokens) + self.position_embedding.weight[: tokens.shape[1]]


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(CLIPTextBlock(cfg) for _ in range(cfg.layers))


class CLIPTextEncoder(nn.Module):
    """token ids [B, n] -> last hidden states [B, n, width] after the final
    layer norm (FrozenCLIPEmbedder's ``layer="last"``)."""

    def __init__(self, cfg: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.cfg = cfg
        self.embeddings = CLIPEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.width, eps=1e-5)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embeddings(tokens.long()).to(self.cfg.dtype)
        n = tokens.shape[1]
        causal = torch.ones(n, n, dtype=torch.bool, device=tokens.device).tril()[None, None]
        for layer in self.encoder.layers:
            x = layer(x, causal)
        ln = self.final_layer_norm
        out = nn.functional.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                                       ln.bias.float(), ln.eps)
        return out.to(self.cfg.dtype)


# ---------------------------------------------------------------------------
# CLIP BPE tokenizer (byte-level vocabulary with </w> word-final markers).
# ---------------------------------------------------------------------------

@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """The GPT-2/CLIP reversible byte <-> printable-unicode table."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


# the CLIP word pattern (\p{L}+ / \p{N} / other-non-space runs) in std-`re`
# terms: letters = word chars minus digits/underscore; "other" includes `_`
_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|\d|(?:[^\s\w]|_)+",
    re.IGNORECASE,
)


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class CLIPTokenizer:
    """Minimal CLIP BPE, file-compatible with openai/clip vocab assets.

    vocab: token -> id (merged tokens use the printable-byte alphabet, word-
    final pieces end in ``</w>``); merges: ranked merge pairs. Padding follows
    huggingface CLIPTokenizer: fixed length, pad id = eot.
    """

    def __init__(self, vocab_path: str, merges_path: str, max_len: int = 77):
        opener = gzip.open if vocab_path.endswith(".gz") else open
        with opener(vocab_path, "rt", encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        with open(merges_path, encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(l.split()) for l in lines
                  if l and not l.startswith("#version") and len(l.split()) == 2]
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.max_len = max_len
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self._cache: Dict[str, List[str]] = {}

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = list(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        text = _whitespace_clean(html.unescape(html.unescape(text))).lower()
        ids: List[int] = []
        for tok in _PAT.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[p] for p in self._bpe(tok) if p in self.encoder)
        return ids

    def __call__(self, texts) -> np.ndarray:
        """Batch-encode to fixed [B, max_len] int32 (sot ... eot, eot-padded)."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), self.max_len), self.eot, np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot] + self.encode(t)[: self.max_len - 2] + [self.eot]
            out[i, : len(ids)] = ids
        return out


def load_tokenizer(asset_dir: str, max_len: int = 77) -> CLIPTokenizer:
    """Load from a directory holding vocab.json[.gz] + merges.txt (the layout
    of huggingface openai/clip-vit-large-patch14 tokenizer assets)."""
    vocab = os.path.join(asset_dir, "vocab.json")
    if not os.path.exists(vocab):
        vocab += ".gz"
    return CLIPTokenizer(vocab, os.path.join(asset_dir, "merges.txt"), max_len)
