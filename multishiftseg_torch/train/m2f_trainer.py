"""Mask2Anomaly stage-2 fine-tuning step.

Counterpart of ``multishiftseg_tpu/train/m2f_trainer.py``: ``copy_class_embed_to_ood``
(:60-70), ``_pad_batch`` (:236-244) and the paired stage-2 step
(``make_stage2_step`` + ``_pairify``, :281-324): the official Hungarian-matched
set criterion with RCL as its OOD loss, over all parameters, through the
detectron2-style AdamW groups and full-model gradient clipping. Datasets, the
epoch loop, validation and stage 1 are not ported yet.

The model keeps f32 master weights and AdamW state; with ``cfg.train.bf16`` the
forward runs under ``torch.autocast`` in bf16 (the JAX model's
``dtype=bfloat16``), with the mask products, attention softmax and all losses in
f32. Every random draw comes from the trainer's ``torch.Generator``.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..convert.from_jax import maskformer_from_jax
from ..core.config import Config
from ..losses.criterion import CriterionConfig, criterion_draws, set_criterion
from ..losses.rcl import make_rcl_params
from ..models.maskformer import MaskFormer
from ..utils import resolve_device
from .state import build_m2f_official_optimizer, clip_grad_norm

SIZE_DIVISIBILITY = 32
IGNORE_LABEL = 255


@torch.no_grad()
def copy_class_embed_to_ood(model: MaskFormer) -> None:
    """class_embed2 <- class_embed (reference ``train_m2f.py:125-132``), a copy."""
    pred = model.sem_seg_head.predictor
    pred.class_embed2.weight.copy_(pred.class_embed.weight)
    pred.class_embed2.bias.copy_(pred.class_embed.bias)


def pad_batch(img: torch.Tensor, target: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, Tuple[int, int]]:
    """Pad [B, H, W, C] images with 0 and [B, H, W] labels with 255 at the
    bottom and right to /32 (detectron2 ``ImageList``)."""
    h, w = img.shape[1:3]
    ph, pw = (-h) % SIZE_DIVISIBILITY, (-w) % SIZE_DIVISIBILITY
    if ph or pw:
        img = torch.nn.functional.pad(img, (0, 0, 0, pw, 0, ph))
        target = torch.nn.functional.pad(target, (0, pw, 0, ph), value=IGNORE_LABEL)
    return img, target, (h, w)


class TrainM2FOOD:
    """Stage-2 trainer. ``cfg`` is a :class:`Config` (``load_config("exps/m2f.yaml")``);
    ``model`` defaults to the configured MaskFormer at random init from
    ``cfg.train.seed``. Runs on CUDA unless the caller asks for the CPU."""

    def __init__(self, cfg: Config, model: Optional[MaskFormer] = None, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        m = cfg.model.m2f
        # loss.params.mask2anomaly_loss_weight overrides the model's loss weights
        lw = (cfg.loss.params or {}).get("mask2anomaly_loss_weight") or {}
        weights = {k: lw.get(f"{k}_weight", getattr(m, f"{k}_weight"))
                   for k in ("class", "mask", "dice", "ood")}
        if model is None:
            torch.manual_seed(cfg.train.seed)
            model = MaskFormer(num_classes=m.num_classes, backbone=m.backbone,
                               hidden_dim=m.hidden_dim, num_queries=m.num_queries,
                               nheads=m.nheads, dim_feedforward=m.dim_feedforward,
                               dec_layers=m.dec_layers - 1, mask_dim=m.mask_dim,
                               transformer_enc_layers=m.transformer_enc_layers,
                               pixel_decoder=m.pixel_decoder, predictor=m.transformer_decoder)
        self.model = model.to(self.device).float()
        self.rcl_params = make_rcl_params(cfg.loss.params)
        self.crit_cfg = CriterionConfig(
            num_classes=m.num_classes, eos_coef=m.no_object_weight,
            num_points=m.train_num_points, importance_sample_ratio=m.importance_sample_ratio,
            oversample_ratio=m.oversample_ratio, class_weight=weights["class"],
            mask_weight=weights["mask"], dice_weight=weights["dice"],
            ood_weight=weights["ood"],
            ood_loss="RCL" if cfg.model.mask2anomaly.replace_official_odd_loss_with_RCL
            else m.ood_loss,
            margin=m.margin, deep_supervision=cfg.model.mask2anomaly.deep_supervision,
            mask_loss_with_pixel_selection=cfg.model.mask2anomaly.mask_loss_with_pixel_selection)
        self.crop_hw = tuple(cfg.data.crop_size)
        self.clip_value = m.clip_gradients_value
        self.optimizer = build_m2f_official_optimizer(
            self.model, base_lr=m.base_lr, weight_decay=m.weight_decay,
            trainable_names=cfg.model.trainable_params_name_update or (".",))
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.train.seed)
        self.bf16 = cfg.train.bf16
        self.step = 0

    def load_jax_variables(self, variables: Mapping) -> None:
        """Load a JAX ``MaskFormer`` variable tree (numpy leaves) strictly,
        ``class_embed2`` included, and clear the optimizer state."""
        self.model.load_state_dict(maskformer_from_jax(variables), strict=True)
        self.optimizer.state.clear()

    def draws(self, batch: int, label_hw: Tuple[int, int]) -> Dict[str, object]:
        """The criterion's draws for one step, from the trainer's generator."""
        n_aux = len(self.model.sem_seg_head.predictor.transformer_cross_attention_layers) - 1
        return criterion_draws(self.generator, batch, self.crit_cfg, label_hw,
                               crop_hw=self.crop_hw, num_aux=n_aux, device=self.device)

    def stage2_step(self, img_c: torch.Tensor, img_g: torch.Tensor, tgt_c: torch.Tensor,
                    tgt_g: torch.Tensor, draws: Optional[Dict[str, object]] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor,
                               List[torch.Tensor]]:
        """One stage-2 step on the clean and augmented halves.

        img_*: normalised f32 [B, H, W, 3]; tgt_*: int [B, H, W] label maps (train
        ids, OOD > 100, void 255). Both halves are padded to /32 and concatenated
        as [clean ‖ augmented]. ``draws`` (from :meth:`draws`, or made elsewhere
        for a replay) default to fresh ones. Returns (total loss, components,
        global gradient norm before clipping, the criterion's assignments),
        detached.
        """
        img = torch.cat([torch.as_tensor(img_c), torch.as_tensor(img_g)]).to(
            self.device, torch.float32)
        tgt = torch.cat([torch.as_tensor(tgt_c), torch.as_tensor(tgt_g)]).to(
            self.device, torch.int32)
        img, tgt, _ = pad_batch(img, tgt)
        if draws is None:
            draws = self.draws(img.shape[0], tuple(tgt.shape[1:]))
        self.model.train()
        with torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=self.bf16):
            outputs = self.model(img)
        total, losses, assignments = set_criterion(outputs, tgt, draws, self.crit_cfg,
                                                   self.rcl_params, crop_hw=self.crop_hw)
        self.optimizer.zero_grad(set_to_none=True)
        total.backward()
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        grad_norm = clip_grad_norm(params, self.clip_value)
        self.optimizer.step()
        self.step += 1
        return (total.detach(), {k: v.detach() for k, v in losses.items()}, grad_norm,
                assignments)


def synthetic_batch(pairs: int, hw: Tuple[int, int], num_classes: int, seed: int,
                    ood_label: int = 254) -> Tuple[np.ndarray, ...]:
    """A seeded clean/augmented batch for smoke runs: normalised f32 images
    [pairs, H, W, 3] and int32 label maps made of class blocks, each augmented map
    with a pasted OOD square. Returns (img_c, img_g, tgt_c, tgt_g)."""
    g = np.random.RandomState(seed)
    h, w = hw
    imgs = g.randn(2, pairs, h, w, 3).astype(np.float32)
    blocks = g.randint(0, num_classes, (2, pairs, -(-h // 32), -(-w // 32)))
    tgts = np.repeat(np.repeat(blocks, 32, axis=2), 32, axis=3)[:, :, :h, :w].astype(np.int32)
    side = max(h // 5, 2)
    for i in range(pairs):
        y0, x0 = g.randint(0, h - side), g.randint(0, w - side)
        tgts[1, i, y0:y0 + side, x0:x0 + side] = ood_label
    tgts[:, :, :2] = IGNORE_LABEL  # a void strip
    return imgs[0], imgs[1], tgts[0], tgts[1]
