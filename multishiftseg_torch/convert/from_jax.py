"""JAX ``MaskFormer``, ``DeepWV3Plus`` and ``DeepV3Plus`` variables -> the port's ``state_dict``.

The inverse of ``multishiftseg_tpu/convert/torch2jax.py::convert_maskformer``
(ResNet or Swin backbone + MSDeformAttn + GMA) and of ``convert_deeplab``
(:84-137, WRN-38 DeepLab v3+ with its OOD head), extended by rules for what
those converters do not read: the vanilla decoder's single
``cross_{i}/multihead_attn``, the FPN and transformer-encoder pixel decoders,
the MaskFormer-v1 predictor (``predictor/layer_{i}``), and ``DeepV3Plus`` over
ResNet and SEResNeXt trunks (``trunk/...``). Conv HWIO -> OIHW, dense
``[in, out]`` -> ``[out, in]`` (``[out, in, 1, 1]`` for SEResNeXt's 1x1 SE
convs), BatchNorm/LayerNorm/GroupNorm ``scale`` -> ``weight``, running
statistics from ``batch_stats``, and the ``q_proj``/``k_proj``/``v_proj`` of
each attention packed into ``in_proj_weight``/``in_proj_bias``. The input is a
nested dict of numpy arrays (``{"params": ..., "batch_stats": ...}``); a tree
holding only some of ``backbone``, ``pixel_decoder`` and ``predictor`` converts
those. Any path without a rule raises; a strict ``load_state_dict`` then also
refuses a tree that misses a parameter or a running statistic.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

PIXEL_DECODER = "sem_seg_head.pixel_decoder"
PREDICTOR = "sem_seg_head.predictor"



def _resnet_rules(src: str, dst: str):
    """The JAX ``ResNet`` under ``src`` -> the port's detectron2 names under ``dst``."""
    return [
        (src + r"/stem_conv1/conv", dst + ".stem.conv1"),
        (src + r"/stem_norm1/bn", dst + ".stem.conv1.norm"),
        (src + r"/res(\d)_(\d+)/(conv\d|shortcut)/conv", dst + r".res\1.\2.\3"),
        (src + r"/res(\d)_(\d+)/norm(\d)/bn", dst + r".res\1.\2.conv\3.norm"),
        (src + r"/res(\d)_(\d+)/shortcut_norm/bn", dst + r".res\1.\2.shortcut.norm"),
    ]


_SWIN_BLOCK = r"backbone.layers.\1.blocks.\2"
# (JAX module path regex, port module path); module path = leaf path without its
# last name, joined by "/". First match wins.
_MODULE_RULES = _resnet_rules("backbone", "backbone") + [
    (r"backbone/patch_embed", "backbone.patch_embed.proj"),
    (r"backbone/patch_norm", "backbone.patch_embed.norm"),
    (r"backbone/stage(\d)_block(\d+)/(norm\d)", _SWIN_BLOCK + r".\3"),
    (r"backbone/stage(\d)_block(\d+)/attn/(qkv|proj)", _SWIN_BLOCK + r".attn.\3"),
    (r"backbone/stage(\d)_block(\d+)/attn", _SWIN_BLOCK + ".attn"),
    (r"backbone/stage(\d)_block(\d+)/mlp_(fc\d)", _SWIN_BLOCK + r".mlp.\3"),
    (r"backbone/downsample(\d)/(norm|reduction)", r"backbone.layers.\1.downsample.\2"),
    (r"backbone/out_norm(\d)", r"backbone.norm\1"),
    (r"pixel_decoder/input_proj_(\d+)/conv", PIXEL_DECODER + r".input_proj.\1.0"),
    (r"pixel_decoder/input_proj_(\d+)_gn", PIXEL_DECODER + r".input_proj.\1.1"),
    (r"pixel_decoder/input_proj/conv", PIXEL_DECODER + ".input_proj"),
    (r"pixel_decoder/encoder_layer_(\d+)/self_attn/(\w+)",
     PIXEL_DECODER + r".transformer.encoder.layers.\1.self_attn.\2"),
    (r"pixel_decoder/encoder_layer_(\d+)/(self_attn|linear\d|norm\d)",
     PIXEL_DECODER + r".transformer.encoder.layers.\1.\2"),
    # the transformer-encoder decoder nests its FPN under "fpn"; the port, as
    # the reference, keeps it at the pixel decoder's top level
    (r"pixel_decoder/(?:fpn/)?(adapter|layer)_(\d+)/conv", PIXEL_DECODER + r".\1_\2"),
    (r"pixel_decoder/(?:fpn/)?(adapter|layer)_(\d+)_gn", PIXEL_DECODER + r".\1_\2.norm"),
    (r"pixel_decoder/(?:fpn/)?mask_features/conv", PIXEL_DECODER + ".mask_features"),
    (r"predictor/cross_(\d+)/(multihead_attn(?:_foreground|_background)?|norm)",
     PREDICTOR + r".transformer_cross_attention_layers.\1.\2"),
    (r"predictor/self_(\d+)/(self_attn|norm)",
     PREDICTOR + r".transformer_self_attention_layers.\1.\2"),
    (r"predictor/ffn_(\d+)/(linear\d|norm)", PREDICTOR + r".transformer_ffn_layers.\1.\2"),
    (r"predictor/layer_(\d+)/(self_attn|multihead_attn|linear\d|norm\d)",
     PREDICTOR + r".transformer.decoder.layers.\1.\2"),
    (r"predictor/mask_embed/layers_(\d+)", PREDICTOR + r".mask_embed.layers.\1"),
    (r"predictor/(decoder_norm|class_embed2?)", PREDICTOR + r".\1"),
]
# the MaskFormer-v1 predictor (a tree with predictor/layer_{i}) keeps its
# shared norm where the reference's DETR decoder does
_STANDARD_RULES = [(r"predictor/decoder_norm", PREDICTOR + ".transformer.decoder.norm")]

# DeepLab: the reference's names (trunk modules at the top level, Sequential
# indices in the ASPP branches and the final head), as convert_deeplab reads them
_DEEPLAB_RULES = [
    (r"trunk/mod1_conv1/conv", "mod1.conv1"),
    (r"trunk/mod(\d)_block(\d+)/bn1/bn", r"mod\1.block\2.bn1.0"),
    (r"trunk/mod(\d)_block(\d+)/convs_(conv\d)/conv", r"mod\1.block\2.convs.\3"),
    (r"trunk/mod(\d)_block(\d+)/convs_(bn\d)/bn", r"mod\1.block\2.convs.\3.0"),
    (r"trunk/mod(\d)_block(\d+)/proj_conv/conv", r"mod\1.block\2.proj_conv"),
    (r"aspp/features_(\d)/conv/conv", r"aspp.features.\1.0"),
    (r"aspp/features_(\d)/bn", r"aspp.features.\1.1"),
    (r"aspp/img_conv/conv/conv", "aspp.img_conv.0"),
    (r"aspp/img_conv/bn", "aspp.img_conv.1"),
    (r"(bot_fine|bot_aspp|ood_head)/conv", r"\1"),
    (r"final_0/conv/conv", "final.0"),
    (r"final_0/bn", "final.1"),
    (r"final_1/conv/conv", "final.3"),
    (r"final_1/bn", "final.4"),
    (r"final_cls/conv", "final.6"),
]

# DeepV3Plus: the heads as DeepWV3Plus's, the trunk under "trunk" (the port's
# ResNet names, or SEResNeXt's reference names)
_DEEPV3_RULES = _resnet_rules("trunk", "trunk") + [
    (r"trunk/stem_conv/conv", "trunk.layer0.conv1"),
    (r"trunk/stem_bn", "trunk.layer0.bn1"),
    (r"trunk/layer(\d)_(\d+)/(conv\d)/conv", r"trunk.layer\1.\2.\3"),
    (r"trunk/layer(\d)_(\d+)/(bn\d)", r"trunk.layer\1.\2.\3"),
    (r"trunk/layer(\d)_(\d+)/se/(fc\d)", r"trunk.layer\1.\2.se_module.\3"),
    (r"trunk/layer(\d)_(\d+)/downsample/conv", r"trunk.layer\1.\2.downsample.0"),
    (r"trunk/layer(\d)_(\d+)/downsample_bn", r"trunk.layer\1.\2.downsample.1"),
] + [r for r in _DEEPLAB_RULES if not r[0].startswith("trunk/")]

# whole-leaf rules: parameters held directly by a module
_LEAF_RULES = {
    "pixel_decoder/level_embed": PIXEL_DECODER + ".transformer.level_embed",
    "predictor/query_feat": PREDICTOR + ".query_feat.weight",
    "predictor/query_embed": PREDICTOR + ".query_embed.weight",
    "predictor/level_embed": PREDICTOR + ".level_embed.weight",
}

_LEAF_NAMES = {"kernel": "weight", "bias": "bias", "scale": "weight",
               "mean": "running_mean", "var": "running_var"}
_QKV = ("q_proj", "k_proj", "v_proj")


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def _module(path: str, rules=_MODULE_RULES) -> str:
    for pattern, repl in rules:
        if re.fullmatch(pattern, path):
            return re.sub(pattern, repl, path)
    raise KeyError(f"no port module for JAX path {path!r}")


def _layout(leaf: str, arr: np.ndarray) -> np.ndarray:
    if leaf == "kernel" and arr.ndim == 4:
        return np.transpose(arr, (3, 2, 0, 1))  # HWIO -> OIHW
    if leaf == "kernel" and arr.ndim == 2:
        return arr.T  # [in, out] -> [out, in]
    return arr


def port_key(path: Tuple[str, ...], rules=_MODULE_RULES) -> str:
    """The port ``state_dict`` key of a JAX leaf path (without its collection);
    the ``q_proj``/``k_proj``/``v_proj`` leaves of an attention land in its packed
    ``in_proj_weight`` / ``in_proj_bias``. ``rules``: :func:`maskformer_rules`
    of the tree (the MaskFormer-v1 predictor's differ)."""
    joined = "/".join(path)
    if joined in _LEAF_RULES:
        return _LEAF_RULES[joined]
    *mod, leaf = path
    if leaf == "relative_position_bias_table":
        return f"{_module('/'.join(mod), rules)}.{leaf}"
    if leaf not in _LEAF_NAMES:
        raise KeyError(f"unexpected leaf {leaf!r} at {joined!r}")
    if mod and mod[-1] in _QKV:
        name = "in_proj_weight" if leaf == "kernel" else "in_proj_bias"
        return f"{_module('/'.join(mod[:-1]), rules)}.{name}"
    if mod and mod[-1] == "out_proj":
        return f"{_module('/'.join(mod[:-1]), rules)}.out_proj.{_LEAF_NAMES[leaf]}"
    return f"{_module('/'.join(mod), rules)}.{_LEAF_NAMES[leaf]}"


def maskformer_rules(paths) -> list:
    """The module rules for a tree with these leaf paths: the MaskFormer-v1
    predictor's where it has ``predictor/layer_{i}``."""
    standard = any(len(p) > 1 and p[0] == "predictor" and p[1].startswith("layer_")
                   for p in paths)
    return _STANDARD_RULES + _MODULE_RULES if standard else _MODULE_RULES


def maskformer_from_jax(variables: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``MaskFormer`` variables -> ``state_dict`` for the port's ``MaskFormer``."""
    flat = {}
    for col in ("params", "batch_stats"):
        flat.update(_flatten(variables.get(col, {})))
    rules = maskformer_rules(flat)
    sd: Dict[str, np.ndarray] = {}
    packed: Dict[str, Dict[str, np.ndarray]] = {}
    for path, arr in flat.items():
        key = port_key(path, rules)
        if len(path) > 1 and path[-2] in _QKV:
            packed.setdefault(key, {})[path[-2]] = _layout(path[-1], arr)
        else:
            sd[key] = _layout(path[-1], arr)
    for key, by_proj in packed.items():
        if set(by_proj) != set(_QKV):
            raise KeyError(f"{key}: incomplete q/k/v ({sorted(by_proj)})")
        sd[key] = np.concatenate([by_proj[p] for p in _QKV], axis=0)
    return OrderedDict(
        (k, torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)))
        for k, v in sorted(sd.items()))


def deeplab_port_key(path: Tuple[str, ...]) -> str:
    """The port ``state_dict`` key of a JAX ``DeepWV3Plus`` leaf path (without
    its collection)."""
    *mod, leaf = path
    if leaf not in _LEAF_NAMES:
        raise KeyError(f"unexpected leaf {leaf!r} at {'/'.join(path)!r}")
    return f"{_module('/'.join(mod), _DEEPLAB_RULES)}.{_LEAF_NAMES[leaf]}"


def deeplab_from_jax(variables: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``DeepWV3Plus`` variables (``params`` and ``batch_stats``) ->
    ``state_dict`` for the port's ``DeepWV3Plus``."""
    flat = {}
    for col in ("params", "batch_stats"):
        flat.update(_flatten(variables.get(col, {})))
    return OrderedDict(
        (deeplab_port_key(path), torch.from_numpy(np.array(_layout(path[-1], arr),
                                                           dtype=np.float32)))
        for path, arr in sorted(flat.items()))


def deepv3_from_jax(variables: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``DeepV3Plus`` variables (``params`` and ``batch_stats``) ->
    ``state_dict`` for the port's ``DeepV3Plus``, on either trunk."""
    flat = {}
    for col in ("params", "batch_stats"):
        flat.update(_flatten(variables.get(col, {})))
    sd = OrderedDict()
    for path, arr in sorted(flat.items()):
        *mod, leaf = path
        if leaf not in _LEAF_NAMES:
            raise KeyError(f"unexpected leaf {leaf!r} at {'/'.join(path)!r}")
        arr = _layout(leaf, arr)
        if leaf == "kernel" and len(mod) > 1 and mod[-2] == "se":
            arr = arr[:, :, None, None]  # SE dense -> the reference's 1x1 conv
        key = f"{_module('/'.join(mod), _DEEPV3_RULES)}.{_LEAF_NAMES[leaf]}"
        sd[key] = torch.from_numpy(np.array(arr, dtype=np.float32))
    return sd
