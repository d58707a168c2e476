"""DeepLab OOD fine-tuning: the two-stage step and per-epoch validation.

Counterpart of ``multishiftseg_tpu/train/deeplab_trainer.py``: construction from
a reference checkpoint (``_build_variables`` :131-139), the paired train
step (``make_train_step`` :43-91: clean ‖ augmented concatenated on the leading
axis, the whole model in training mode, RCL on the logits and energy scores) and
the two-stage schedule (``_stage_optimizer`` :169-180): stage 0 trains
``trainable_params_name`` (``ood_head``) at ``lr``, stage 1 trains
``trainable_params_name_update`` (``aspp``, ``bot_fine``, ``bot_aspp``,
``ood_head``) at ``lr_update``, each with a fresh torch ``Adam`` (L2 added to the
gradient), ``build_datasets`` (:146-166: the crop-first Compose), ``train``
(:184-318, the single-process branch: :func:`.epochs.train_epochs`) and
``valid`` (:324-333: the energy score in eval mode through
``batched_valid``).

Inside a process group (``core.mesh``; ``torchrun``) each rank takes its
``train_batch / world`` pairs under DDP (wrapped again at each stage), draws
the global batch's dropout masks and RCL noise from the same generator and
takes its rows, and every BatchNorm and RCL reduction spans the global batch.

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
from ..convert.torch_checkpoint import load_reference_weights
from ..core.config import Config
from ..core.mesh import (check_parallelism, check_train_batch, data_parallel, process_count,
                         rank_draws)
from ..core.tensor_parallel import place_tensor_parallel
from ..data.anomaly import RoadAnomaly21
from ..data.cityscapes import DiverseCityscapes
from ..data.transforms import Compose, Normalize, RandCrop, ToTensor
from ..losses.rcl import make_rcl_params, rel_contrastive_loss
from ..models.deeplab import DeepWV3Plus, init_ood_head_from_final
from ..models.wider_resnet import draw_dropout_masks
from ..utils import resolve_device
from .epochs import train_epochs
from .m2f_trainer import synthetic_batch  # noqa: F401  seeded batches, as for M2F
from .state import build_stage_optimizer
from .validation import batched_valid


class TrainDeepLabOOD:
    """Two-stage DeepLab step. ``cfg`` is a :class:`Config`
    (``load_config("exps/deeplab.yaml")``); ``weight_path`` a reference
    checkpoint (loaded strictly, then ``ood_head`` <- the classifier);
    ``model`` defaults to WRN-38 DeepLab at random init from
    ``cfg.train.seed``. Runs on CUDA unless the caller asks for the CPU. Starts
    in stage 0. With ``train.model_parallel > 1`` the widest layers' channels
    split over ``tp_devices`` (``core.tensor_parallel``; by default the cards
    from this process's, or the CPU for every shard of a CPU trainer)."""

    def __init__(self, cfg: Config, weight_path: Optional[str] = None,
                 model: Optional[DeepWV3Plus] = None, device="cuda", tp_devices=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        check_parallelism(cfg.train)
        self.local_batch = check_train_batch(cfg.train.train_batch)
        if model is None:
            torch.manual_seed(cfg.train.seed)
            model = DeepWV3Plus(num_classes=cfg.data.class_num)
        if weight_path:
            load_reference_weights(model, weight_path)
            init_ood_head_from_final(model)
        self.model = model.to(self.device).float()
        if self.device.type == "cuda":
            self.model = self.model.to(memory_format=torch.channels_last)
        # tensor parallelism: the widest layers' channels over tp_devices
        self.tp_devices = place_tensor_parallel(self.model, cfg.train, self.device, tp_devices)
        self.rcl_params = make_rcl_params(cfg.loss.params)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.train.seed)
        self.bf16 = cfg.train.bf16
        self.n_steps = 0
        self.best: Dict[str, float] = {"AUPRC": -1.0}
        self.set_stage(0)

    def set_stage(self, stage: int) -> None:
        """Freeze all but the stage's trainable parameters and build a fresh
        ``Adam`` over them at the stage's rate (``_stage_optimizer``)."""
        m, t = self.cfg.model, self.cfg.train
        names = m.trainable_params_name if stage == 0 else (
            m.trainable_params_name_update or m.trainable_params_name)
        lr = t.lr if stage == 0 else (t.lr_update or t.lr)
        self.optimizer = build_stage_optimizer(self.model, lr, t.weight_decay, names)
        self.stage = stage
        self.train_model = data_parallel(self.model, getattr(self, "train_model", None))

    def build_datasets(self):
        """(DiverseCityscapes train set, RoadAnomaly21 validation set). The
        train Compose crops first: ``RandCrop`` is a pixel selection at the
        recipe's geometry (frames larger than the crop) and ``ToTensor`` /
        ``Normalize`` are pixel-wise, so this equals the reference order
        ``[ToTensor, RandCrop, Normalize]`` on a fraction of the pixels."""
        d = self.cfg.data
        train_tf = Compose([RandCrop(size=tuple(d.crop_size)), ToTensor(),
                            Normalize(mean=d.mean, std=d.std)])
        test_tf = Compose([ToTensor(), Normalize(mean=d.mean, std=d.std)])
        train_ds = DiverseCityscapes(
            root=d.cityscapes_root, generation_root=d.generation_root, coco_root=d.coco_root,
            split="train", transform=train_tf, anomaly_mix=d.anomaly_mix, mixup=d.mixup,
            seed=self.cfg.train.seed)
        return train_ds, RoadAnomaly21(root=d.anomaly_track_root, transform=test_tf)

    def train(self, start_epoch: int = 0, resume: Optional[str] = None) -> Dict[str, float]:
        """The recipe: ``ood_head`` until ``warmup_epoch``, then ``aspp``,
        ``bot_*`` and ``ood_head`` at ``lr_update``. Validates every epoch,
        keeps ``AUPRC_best`` and ``last`` under ``cfg.model_dir`` and writes
        ``train/loss``, ``train/img_per_s`` and ``val/*`` to its
        ``scalars.csv``. Returns ``{"AUPRC": best}``."""
        return train_epochs(self, start_epoch, resume,
                            lambda stage, *batch: self.step(*batch)[0],
                            lambda stage, img_per_s: {"train/img_per_s": img_per_s})

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
        ones; in a process group they cover the global batch. Returns (loss,
        RCL components), detached.
        """
        img = torch.cat([torch.as_tensor(img_c), torch.as_tensor(img_g)]).to(
            self.device, torch.float32)
        tgt = torch.cat([torch.as_tensor(tgt_c), torch.as_tensor(tgt_g)]).to(
            self.device, torch.int32)
        if draws is None:
            draws = self.draws(img.shape[0] * process_count(), tuple(img.shape[1:3]))
        local = rank_draws(draws, paired=True)
        self.model.train()
        with torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=self.bf16):
            score, logit = self.train_model(img.permute(0, 3, 1, 2),
                                            dropout_masks=local["dropout"])
        loss, aux = rel_contrastive_loss(logit.permute(0, 2, 3, 1), score, tgt,
                                         draws["rcl_noise"], self.rcl_params)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.n_steps += 1
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    @torch.inference_mode()
    def eval_step(self, imgs) -> Tuple[torch.Tensor, torch.Tensor]:
        """imgs: normalised f32 [B, H, W, 3] -> (score [B, H, W], logit
        [B, C, H, W]), f32: eval mode (running statistics), bf16 autocast over
        the f32 master weights when ``cfg.train.bf16``."""
        x = torch.as_tensor(imgs).to(self.device, torch.float32)
        self.model.eval()
        with torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=self.bf16):
            return self.model(x.permute(0, 3, 1, 2))

    def valid(self, val_ds) -> Optional[Dict[str, float]]:
        """Per-epoch validation: binned metrics of the energy score over
        shape-bucketed batches (``batched_valid``)."""
        return batched_valid(val_ds, lambda imgs: self.eval_step(imgs)[0])
