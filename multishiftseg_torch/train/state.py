"""Stage-2 optimizer: detectron2-style AdamW parameter groups and full-model
gradient clipping.

Counterpart of ``multishiftseg_tpu/train/state.py`` (``trainable_mask``,
``build_stage_optimizer`` :25-60, ``m2f_param_rules`` and
``build_m2f_official_optimizer`` :75-123). The JAX rules read flax paths
(``'.bn.'``, ``'norm'``, ``'_gn.'``); the port's detectron2 names
(``input_proj.0.1``, ``adapter_1.norm``, ...) do not carry those words, so here a
parameter is classified by the type of the module that owns it, as detectron2's
``norm_module_types`` does: GroupNorm, LayerNorm and the backbone's FrozenBN take
no weight decay; so do the learned query / level embeddings, by name. Backbone
parameters learn at 0.1x the base rate. ``tests/test_torch_train.py`` holds every
parameter's group against ``m2f_param_rules`` through the converter's name map.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import torch
import torch.nn as nn

from ..models.resnet import FrozenBN

NORM_MODULE_TYPES = (nn.GroupNorm, nn.LayerNorm, FrozenBN)
EMBED_NAMES = ("query_feat", "query_embed", "level_embed")
NO_DECAY_NAMES = ("relative_position_bias_table", "absolute_pos_embed")


def trainable_mask(model: nn.Module, names: Sequence[str]) -> Dict[str, bool]:
    """Parameter name -> whether any of ``names`` is a substring of it (the
    reference's ``any(i in name for i in trainable_params_name)``)."""
    return {n: any(s in n for s in names) for n, _ in model.named_parameters()}


def m2f_param_rules(model: nn.Module) -> Dict[str, Dict[str, object]]:
    """Parameter name -> ``{"lr_mult": 1.0 or 0.1, "decay": bool}``."""
    rules = {}
    for mod_name, module in model.named_modules():
        for leaf, _ in module.named_parameters(recurse=False):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            decay = not (isinstance(module, NORM_MODULE_TYPES)
                         or any(t in name for t in EMBED_NAMES + NO_DECAY_NAMES))
            rules[name] = {"lr_mult": 0.1 if "backbone" in name else 1.0, "decay": decay}
    return rules


def build_m2f_official_optimizer(model: nn.Module, base_lr: float = 1e-5,
                                 weight_decay: float = 0.05,
                                 trainable_names: Sequence[str] = (".",)
                                 ) -> torch.optim.AdamW:
    """Stage-2 AdamW (betas 0.9 / 0.999, eps 1e-8) with one group per (lr, decay)
    pair. Parameters outside ``trainable_names`` are frozen (requires_grad off),
    the others trainable.
    Each group records its ``lr_mult`` and whether it decays."""
    rules = m2f_param_rules(model)
    keep = trainable_mask(model, trainable_names)
    groups: Dict[Tuple[float, bool], List[nn.Parameter]] = {}
    names: Dict[Tuple[float, bool], List[str]] = {}
    for name, param in model.named_parameters():
        param.requires_grad_(keep[name])
        if not keep[name]:
            continue
        r = rules[name]
        key = (r["lr_mult"], r["decay"])
        groups.setdefault(key, []).append(param)
        names.setdefault(key, []).append(name)
    return torch.optim.AdamW(
        [{"params": groups[k], "names": names[k], "lr": base_lr * k[0], "lr_mult": k[0],
          "decay": k[1], "weight_decay": weight_decay if k[1] else 0.0}
         for k in sorted(groups)],
        lr=base_lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)


def build_stage_optimizer(model: nn.Module, lr: float, weight_decay: float,
                          trainable_names: Sequence[str]) -> torch.optim.Adam:
    """torch ``Adam`` (L2 added to the gradient) over the trainable subset only;
    the rest is frozen."""
    keep = trainable_mask(model, trainable_names)
    params = []
    for name, param in model.named_parameters():
        param.requires_grad_(keep[name])
        if keep[name]:
            params.append(param)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def clip_grad_norm(params: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Full-model clipping as ``optax.clip_by_global_norm``: scale every
    gradient by ``max_norm / norm`` when the global norm exceeds ``max_norm``.
    Returns the norm before clipping."""
    grads = [p.grad for p in params if p.grad is not None]
    # a pipelined model's gradients sit on its stages' devices
    device = grads[0].device
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g).to(device)
                                                 for g in grads]))
    scale = torch.where(norm > max_norm, max_norm / norm, torch.ones_like(norm))
    by_device = {}
    for g in grads:
        by_device.setdefault(g.device, []).append(g)
    for dev, group in by_device.items():
        torch._foreach_mul_(group, scale.to(dev))
    return norm
