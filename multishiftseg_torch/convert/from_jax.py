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


# ---------------------------------------------------------------------------
# CG-Aug: the ControlNet-SD1.5 towers and SAM (inverses of the JAX package's
# convert/sd_controlnet.py::convert_control_sd15 and convert/sam.py::convert_sam)
# ---------------------------------------------------------------------------

# (JAX module path prefix regex, port prefix or callable(match), sub-rules or None)
_SD_RES = [(r"norm_in/gn", "in_layers.0", None), (r"conv_in", "in_layers.2", None),
           (r"emb", "emb_layers.1", None), (r"norm_out/gn", "out_layers.0", None),
           (r"conv_out", "out_layers.3", None), (r"skip", "skip_connection", None)]
_SD_ST = [(r"norm/gn", "norm", None), (r"proj_(in|out)", r"proj_\1", None),
          (r"block_(\d+)/(attn\d)/to_out", r"transformer_blocks.\1.\2.to_out.0", None),
          (r"block_(\d+)/(attn\d)/(to_[qkv])", r"transformer_blocks.\1.\2.\3", None),
          (r"block_(\d+)/(norm\d)", r"transformer_blocks.\1.\2", None),
          (r"block_(\d+)/ff_proj", r"transformer_blocks.\1.ff.net.0.proj", None),
          (r"block_(\d+)/ff_out", r"transformer_blocks.\1.ff.net.2", None)]
_SD_ENCODER = [(r"time_embed_0", "time_embed.0", None), (r"time_embed_1", "time_embed.2", None),
               (r"enc/in_(\d+)_conv", r"input_blocks.\1.0", None),
               (r"enc/in_(\d+)_down", r"input_blocks.\1.0.op", None),
               (r"enc/in_(\d+)_res", r"input_blocks.\1.0", _SD_RES),
               (r"enc/in_(\d+)_st", r"input_blocks.\1.1", _SD_ST),
               (r"enc/mid_res1", "middle_block.0", _SD_RES),
               (r"enc/mid_st", "middle_block.1", _SD_ST),
               (r"enc/mid_res2", "middle_block.2", _SD_RES)]
_VAE_RES = [(r"norm(\d)", r"norm\1", None), (r"conv(\d)", r"conv\1", None),
            (r"shortcut", "nin_shortcut", None)]
_VAE_ATTN = [(r"(norm|q|k|v|proj_out)", r"\1", None)]
_VAE = [(r"(encoder|decoder)/(conv_in|conv_out|norm_out)", r"\1.\2", None),
        (r"(encoder|decoder)/mid_(block_\d)", r"\1.mid.\2", _VAE_RES),
        (r"(encoder|decoder)/mid_(attn_\d)", r"\1.mid.\2", _VAE_ATTN),
        (r"encoder/down_(\d+)_block_(\d+)", r"encoder.down.\1.block.\2", _VAE_RES),
        (r"encoder/down_(\d+)_attn_(\d+)", r"encoder.down.\1.attn.\2", _VAE_ATTN),
        (r"encoder/down_(\d+)_downsample", r"encoder.down.\1.downsample.conv", None),
        (r"decoder/up_(\d+)_block_(\d+)", r"decoder.up.\1.block.\2", _VAE_RES),
        (r"decoder/up_(\d+)_attn_(\d+)", r"decoder.up.\1.attn.\2", _VAE_ATTN),
        (r"decoder/up_(\d+)_upsample", r"decoder.up.\1.upsample.conv", None),
        (r"(quant_conv|post_quant_conv)", r"\1", None)]
_CLIP = [(r"token_embedding", "embeddings.token_embedding", None),
         (r"layer_(\d+)/(q|k|v)", r"encoder.layers.\1.self_attn.\2_proj", None),
         (r"layer_(\d+)/proj", r"encoder.layers.\1.self_attn.out_proj", None),
         (r"layer_(\d+)/ln(\d)", r"encoder.layers.\1.layer_norm\2", None),
         (r"layer_(\d+)/(fc\d)", r"encoder.layers.\1.mlp.\2", None),
         (r"final_ln", "final_layer_norm", None)]
_SD_PREFIX = {"unet": "model.diffusion_model.", "control": "control_model.",
              "vae": "first_stage_model.", "clip": "cond_stage_model.transformer.text_model."}
_LEAF_NAMES_CG = {"kernel": "weight", "bias": "bias", "scale": "weight",
                  "embedding": "weight", "weight": "weight"}


def _nested_module(path: str, rules) -> str:
    """The port module of a JAX module path under prefix rules, each with its
    own sub-rules for what follows the prefix (None: nothing may follow)."""
    for pattern, repl, sub in rules:
        m = re.match(pattern + r"(?:/|$)", path)
        if m is None:
            continue
        head = repl(m) if callable(repl) else m.expand(repl)
        rest = path[m.end():]
        if sub is None:
            if rest:
                continue
            return head
        return f"{head}.{_nested_module(rest, sub)}"
    raise KeyError(f"no port module for JAX path {path!r}")


def _reshaped(sd: Dict[str, np.ndarray], template) -> "OrderedDict[str, torch.Tensor]":
    """``sd`` with each entry in the shape of the port's ``template`` (a
    ``state_dict``: a dense kernel becomes a 1x1 conv's where the port has
    one); a missing or unexpected key, or a size that differs, raises."""
    if set(sd) != set(template):
        raise KeyError(f"JAX tree vs the port's state_dict: missing "
                       f"{sorted(set(template) - set(sd))[:5]}, unexpected "
                       f"{sorted(set(sd) - set(template))[:5]}")
    out = OrderedDict()
    for k, t in template.items():
        out[k] = torch.from_numpy(np.ascontiguousarray(sd[k], dtype=np.float32)).reshape(t.shape)
    return out


def control_sd15_from_jax(params: Mapping, unet_cfg=None, vae_cfg=None,
                          clip_cfg=None) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``{'unet', 'control', 'vae', 'clip'}`` params (``convert_control_sd15``'s
    output) -> the ``state_dict`` of the port's ``cgaug.sd_pipeline.ControlLDM``
    with those configs (defaults: SD1.5's)."""
    from ..cgaug.clip_text import CLIPTextConfig
    from ..cgaug.sd_pipeline import ControlLDM
    from ..cgaug.sd_unet import SDUNetConfig
    from ..cgaug.sd_vae import VAEConfig

    unet_cfg = unet_cfg or SDUNetConfig()
    with torch.device("meta"):
        template = ControlLDM(unet_cfg, vae_cfg or VAEConfig(),
                              clip_cfg or CLIPTextConfig()).state_dict()
    hint_out = f"input_hint_block.{2 * len(unet_cfg.hint_widths)}"
    sd: Dict[str, np.ndarray] = {}
    for tower, prefix in _SD_PREFIX.items():
        flat = _flatten(params[tower])
        top = {p[0] for p in flat}
        rules = {"vae": _VAE, "clip": _CLIP}.get(tower, _SD_ENCODER + [
            (r"out_(\d+)_res", r"output_blocks.\1.0", _SD_RES),
            (r"out_(\d+)_st", r"output_blocks.\1.1", _SD_ST),
            (r"out_(\d+)_up", lambda m: f"output_blocks.{m[1]}."
             f"{2 if f'out_{m[1]}_st' in top else 1}.conv", None),
            (r"out_norm/gn", "out.0", None), (r"out_conv", "out.2", None),
            (r"hint_out", hint_out, None),
            (r"hint_(\d+)", lambda m: f"input_hint_block.{2 * int(m[1])}", None),
            (r"zero_mid", "middle_block_out.0", None),
            (r"zero_(\d+)", r"zero_convs.\1.0", None)])
        for path, arr in flat.items():
            if path == ("position_embedding",):
                sd[prefix + "embeddings.position_embedding.weight"] = arr
                continue
            *mod, leaf = path
            key = f"{prefix}{_nested_module('/'.join(mod), rules)}.{_LEAF_NAMES_CG[leaf]}"
            sd[key] = _layout(leaf, arr)
    return _reshaped(sd, template)


_SAM_ATTN = [(r"(q_proj|k_proj|v_proj|out_proj)", r"\1", None)]
_SAM = [(r"image_encoder/patch_embed", "image_encoder.patch_embed.proj", None),
        (r"image_encoder/block_(\d+)/(norm\d)", r"image_encoder.blocks.\1.\2", None),
        (r"image_encoder/block_(\d+)/attn/(qkv|proj)", r"image_encoder.blocks.\1.attn.\2", None),
        (r"image_encoder/block_(\d+)/(lin\d)", r"image_encoder.blocks.\1.mlp.\2", None),
        (r"image_encoder/neck_conv1", "image_encoder.neck.0", None),
        (r"image_encoder/neck_ln1", "image_encoder.neck.1", None),
        (r"image_encoder/neck_conv2", "image_encoder.neck.2", None),
        (r"image_encoder/neck_ln2", "image_encoder.neck.3", None),
        (r"mask_decoder/final_attn", "mask_decoder.transformer.final_attn_token_to_image",
         _SAM_ATTN),
        (r"mask_decoder/norm_final", "mask_decoder.transformer.norm_final_attn", None),
        (r"mask_decoder/upscale_conv1", "mask_decoder.output_upscaling.0", None),
        (r"mask_decoder/upscale_ln", "mask_decoder.output_upscaling.1", None),
        (r"mask_decoder/upscale_conv2", "mask_decoder.output_upscaling.3", None),
        (r"mask_decoder/layer_(\d+)/(self_attn|cross_attn_token_to_image|"
         r"cross_attn_image_to_token)", r"mask_decoder.transformer.layers.\1.\2", _SAM_ATTN),
        (r"mask_decoder/layer_(\d+)/(norm\d)", r"mask_decoder.transformer.layers.\1.\2", None),
        (r"mask_decoder/layer_(\d+)/mlp_(lin\d)", r"mask_decoder.transformer.layers.\1.mlp.\2",
         None),
        (r"mask_decoder/hyper_(\d+)/lin_(\d)",
         r"mask_decoder.output_hypernetworks_mlps.\1.layers.\2", None),
        (r"mask_decoder/iou_head/lin_(\d)", r"mask_decoder.iou_prediction_head.layers.\1", None)]
_SAM_RAW = {"image_encoder/pos_embed": "image_encoder.pos_embed",
            "prompt_encoder/pe_gaussian":
                "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix",
            "prompt_encoder/no_mask_embed": "prompt_encoder.no_mask_embed.weight",
            "mask_decoder/iou_token": "mask_decoder.iou_token.weight",
            "mask_decoder/mask_tokens": "mask_decoder.mask_tokens.weight"}


def sam_from_jax(params: Mapping, cfg=None) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``SAM`` params (``convert_sam``'s first output) -> the ``state_dict``
    of the port's ``cgaug.sam.SAM`` with ``cfg`` (default ViT-H), which holds
    no key ``convert_sam`` skips."""
    from ..cgaug.sam import SAM, SAMConfig

    with torch.device("meta"):
        template = SAM(cfg or SAMConfig()).state_dict()
    sd: Dict[str, np.ndarray] = {}
    for path, arr in _flatten(params).items():
        joined = "/".join(path)
        if joined in _SAM_RAW:
            sd[_SAM_RAW[joined]] = arr
        elif joined == "prompt_encoder/point_embeddings":
            for i, row in enumerate(arr):
                sd[f"prompt_encoder.point_embeddings.{i}.weight"] = row[None]
        elif path[-1] in ("rel_pos_h", "rel_pos_w"):
            sd[f"image_encoder.blocks.{path[1][len('block_'):]}.attn.{path[-1]}"] = arr
        else:
            *mod, leaf = path
            key = f"{_nested_module('/'.join(mod), _SAM)}.{_LEAF_NAMES_CG[leaf]}"
            if mod[-1] == "qkv" and leaf == "kernel":  # [C, 3, heads, d] -> [3C, C]
                arr = arr.reshape(arr.shape[0], -1).T
            elif mod[-1] == "qkv":
                arr = arr.reshape(-1)
            elif mod[-1].startswith("upscale_conv") and leaf == "kernel":
                # flax [kh, kw, in, out] with flipped taps -> torch [in, out, kh, kw]
                arr = np.transpose(arr, (2, 3, 0, 1))[:, :, ::-1, ::-1]
            else:
                arr = _layout(leaf, arr)
            sd[key] = arr
    return _reshaped(sd, template)
