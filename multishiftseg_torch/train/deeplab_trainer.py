"""DeepLab OOD fine-tuning: the two-stage step.

Counterpart of ``multishiftseg_tpu/train/deeplab_trainer.py``: the paired train
step (``make_train_step`` :43-91: clean ‖ augmented concatenated on the leading
axis, the whole model in training mode, RCL on the logits and energy scores) and
the two-stage schedule (``_stage_optimizer`` :169-180): stage 0 trains
``trainable_params_name`` (``ood_head``) at ``lr``, stage 1 trains
``trainable_params_name_update`` (``aspp``, ``bot_fine``, ``bot_aspp``,
``ood_head``) at ``lr_update``, each with a fresh torch ``Adam`` (L2 added to the
gradient). Datasets, the epoch loop, validation and checkpoints are not ported
yet.

Every BatchNorm, the frozen trunk's included, normalises with batch statistics
and updates its running statistics with the biased variance, as flax does
(``models.layers.BatchNorm2d``). The model keeps f32 master weights and Adam
state; with ``cfg.train.bf16`` the forward runs under ``torch.autocast`` in bf16
(the JAX model's ``dtype=bfloat16``), with the energy score, the logits' resize
and the loss in f32. On the card the model runs in the channels-last memory
format, in which an NHWC batch is an NCHW view without a copy. Every random draw
(the RCL pixel-pair noise and the trunk's dropout masks) comes from the
trainer's ``torch.Generator``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from ..convert.from_jax import deeplab_from_jax
from ..core.config import Config
from ..losses.rcl import make_rcl_params, rel_contrastive_loss
from ..models.deeplab import DeepWV3Plus
from ..models.wider_resnet import draw_dropout_masks
from ..utils import resolve_device
from .m2f_trainer import synthetic_batch  # noqa: F401  seeded batches, as for M2F
from .state import build_stage_optimizer


class TrainDeepLabOOD:
    """Two-stage DeepLab step. ``cfg`` is a :class:`Config`
    (``load_config("exps/deeplab.yaml")``); ``model`` defaults to WRN-38 DeepLab
    at random init from ``cfg.train.seed``. Runs on CUDA unless the caller asks
    for the CPU. Starts in stage 0."""

    def __init__(self, cfg: Config, model: Optional[DeepWV3Plus] = None, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        if model is None:
            torch.manual_seed(cfg.train.seed)
            model = DeepWV3Plus(num_classes=cfg.data.class_num)
        self.model = model.to(self.device).float()
        if self.device.type == "cuda":
            self.model = self.model.to(memory_format=torch.channels_last)
        self.rcl_params = make_rcl_params(cfg.loss.params)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.train.seed)
        self.bf16 = cfg.train.bf16
        self.set_stage(0)

    def set_stage(self, stage: int) -> None:
        """Freeze all but the stage's trainable parameters and build a fresh
        ``Adam`` over them at the stage's rate (``_stage_optimizer``)."""
        m, t = self.cfg.model, self.cfg.train
        names = m.trainable_params_name if stage == 0 else (
            m.trainable_params_name_update or m.trainable_params_name)
        lr = t.lr if stage == 0 else (t.lr_update or t.lr)
        self.optimizer = build_stage_optimizer(self.model, lr, t.weight_decay, names)

    def load_jax_variables(self, variables: Mapping) -> None:
        """Load a JAX ``DeepWV3Plus`` variable tree (numpy leaves) strictly,
        running statistics included, and clear the optimizer state."""
        self.model.load_state_dict(deeplab_from_jax(variables), strict=True)
        self.optimizer.state.clear()

    def draws(self, batch: int, hw: Tuple[int, int]) -> Dict[str, object]:
        """One step's draws from the trainer's generator: ``rcl_noise``
        [3, batch * H * W] and the trunk's ``dropout`` keep masks."""
        h, w = hw
        return {"rcl_noise": torch.rand((3, batch * h * w), generator=self.generator,
                                        device=self.device),
                "dropout": draw_dropout_masks(self.model, batch, self.generator, self.device)}

    def step(self, img_c: torch.Tensor, img_g: torch.Tensor, tgt_c: torch.Tensor,
             tgt_g: torch.Tensor, draws: Optional[Dict[str, object]] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One step of the current stage on the clean and augmented halves.

        img_*: normalised f32 [B, H, W, 3]; tgt_*: int [B, H, W] label maps (train
        ids, OOD > 100, void 255), concatenated as [clean ‖ augmented]. ``draws``
        (from :meth:`draws`, or made elsewhere for a replay) default to fresh
        ones. Returns (loss, RCL components), detached.
        """
        img = torch.cat([torch.as_tensor(img_c), torch.as_tensor(img_g)]).to(
            self.device, torch.float32)
        tgt = torch.cat([torch.as_tensor(tgt_c), torch.as_tensor(tgt_g)]).to(
            self.device, torch.int32)
        if draws is None:
            draws = self.draws(img.shape[0], tuple(img.shape[1:3]))
        self.model.train()
        with torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=self.bf16):
            score, logit = self.model(img.permute(0, 3, 1, 2), dropout_masks=draws["dropout"])
        loss, aux = rel_contrastive_loss(logit.permute(0, 2, 3, 1), score, tgt,
                                         draws["rcl_noise"], self.rcl_params)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach(), {k: v.detach() for k, v in aux.items()}
