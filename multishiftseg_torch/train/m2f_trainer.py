"""Mask2Anomaly two-stage fine-tuning steps and per-epoch validation.

Counterpart of ``multishiftseg_tpu/train/m2f_trainer.py``: construction from a
reference checkpoint (``_build_variables`` :156-173), ``copy_class_embed_to_ood``
(:60-70), ``_pad_batch`` (:236-244), the paired stage-1 step
(``make_stage1_step`` + ``_pairify``, :246-279, :308-324: the eval-style
``inference``, then RCL on the semantic logits and the anomaly score, Adam over
``class_embed2``), the paired stage-2 step (``make_stage2_step``, :281-306: the
official Hungarian-matched set criterion with RCL as its OOD loss, over all
parameters, through the detectron2-style AdamW groups and full-model gradient
clipping), ``build_datasets`` (:208-230: the 12-stage probabilistic Compose),
``train`` (:347-493, the single-process branch: :func:`.epochs.train_epochs`
with ``stage1_step`` before ``warmup_epoch`` and ``stage2_step`` from it on),
``make_eval_step`` (:326-343) and ``valid`` (:494-506).

Inside a process group (``core.mesh``; ``torchrun``) each rank takes its
``train_batch / world`` pairs, the model trains under DDP (wrapped again at
each stage, so frozen parameters stay out of the all-reduce), every rank draws
the global batch's draws from the same generator and takes its rows, and the
losses reduce over the global batch, so two ranks take the step one process
takes on the same global batch.

With ``train.pipeline_parallel = P > 1`` (one process, as JAX's
``:125-147``) both stage steps run the deformable encoder GPipe-staged over P
devices (``core/pipeline.py``; ``MSDeformAttnPixelDecoder.set_pipeline``) in
``train.pipeline_microbatches`` microbatches of the paired batch (by default
``auto_microbatches``); evaluation, ``valid`` and every checkpoint stay
sequential and keep the layers' names.

The model keeps f32 master weights and optimizer state; with ``cfg.train.bf16``
the forward runs under ``torch.autocast`` in bf16 (the JAX model's
``dtype=bfloat16``), with the mask products, attention softmax, score tails
and all losses in f32. Every random draw comes from the trainer's
``torch.Generator``.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..convert.from_jax import maskformer_from_jax
from ..convert.torch_checkpoint import load_reference_weights
from ..core.config import Config
from ..core.mesh import (check_parallelism, check_train_batch, data_parallel, process_count,
                         rank_draws)
from ..core.pipeline import auto_microbatches, stage_devices
from ..data.anomaly import RoadAnomaly21
from ..data.cityscapes import DiverseCityscapes
from ..data.transforms import (AutoContrast, ColorJitter, Compose, Equalize, GaussianBlur,
                               Normalize, RandCrop, RandHorizontalFlip, RandResize,
                               RandRotate, RandSharpness, RandVerticalFlip, ToTensor)
from ..losses.criterion import CriterionConfig, criterion_draws, set_criterion
from ..losses.rcl import make_rcl_params, rel_contrastive_loss
from ..models.maskformer import MaskFormer, inference, maskformer_from_config
from ..models.pixel_decoder import DEFORM_POINTS
from ..ops.ms_deform_attn import parse_eval_sample_mode
from ..ops.scores import anomaly_score_upsampled
from ..utils import resolve_device
from .epochs import train_epochs
from .state import build_m2f_official_optimizer, build_stage_optimizer, clip_grad_norm
from .validation import batched_valid

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
    """Two-stage trainer. ``cfg`` is a :class:`Config` (``load_config("exps/m2f.yaml")``);
    ``weight_path`` a reference checkpoint (loaded strictly, then
    ``class_embed2`` <- ``class_embed``); ``model`` defaults to the configured
    MaskFormer at random init from ``cfg.train.seed``. Runs on CUDA unless the
    caller asks for the CPU. Starts in stage 0 (:meth:`set_stage`).
    ``pipeline_devices``: the GPipe stages' devices when
    ``train.pipeline_parallel > 1`` (``core.pipeline.stage_devices``; by
    default the first cards, or the CPU for every stage of a CPU trainer)."""

    def __init__(self, cfg: Config, weight_path: Optional[str] = None,
                 model: Optional[MaskFormer] = None, device="cuda",
                 pipeline_devices=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        check_parallelism(cfg.train, pipelined=True)
        self.local_batch = check_train_batch(cfg.train.train_batch)
        m = cfg.model.m2f
        # loss.params.mask2anomaly_loss_weight overrides the model's loss weights
        lw = (cfg.loss.params or {}).get("mask2anomaly_loss_weight") or {}
        weights = {k: lw.get(f"{k}_weight", getattr(m, f"{k}_weight"))
                   for k in ("class", "mask", "dice", "ood")}
        if model is None:
            torch.manual_seed(cfg.train.seed)
            model = maskformer_from_config(m)
        if weight_path:
            load_reference_weights(model, weight_path, fill=_ood_head_from_class_head)
            copy_class_embed_to_ood(model)
        self.model = model.to(self.device).float()
        if cfg.train.pipeline_parallel > 1:
            self._set_pipeline(cfg.train, pipeline_devices)
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
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.train.seed)
        self.bf16 = cfg.train.bf16
        self.step = 0
        self.best: Dict[str, float] = {"AUPRC": -1.0}
        self.set_stage(0)

    def _set_pipeline(self, t, devices) -> None:
        """GPipe the encoder of both steps over ``t.pipeline_parallel`` stages
        (JAX ``m2f_trainer.py:125-147``): the paired batch of ``2 *
        train_batch`` rows in ``t.pipeline_microbatches`` microbatches, or
        ``auto_microbatches``."""
        if self.model.pixel_decoder_name != "msdeformattn":
            raise ValueError("pipeline_parallel requires the msdeformattn pixel decoder "
                             f"(got {self.model.pixel_decoder_name!r})")
        rows = 2 * self.local_batch
        n_micro = t.pipeline_microbatches or auto_microbatches(rows, t.pipeline_parallel)
        if rows % n_micro:
            raise ValueError(f"paired batch {rows} not divisible by "
                             f"pipeline_microbatches={n_micro}")
        if devices is None and self.device.type != "cuda":
            devices = [self.device] * t.pipeline_parallel
        self.model.sem_seg_head.pixel_decoder.set_pipeline(
            stage_devices(t.pipeline_parallel, devices), n_micro)

    @property
    def n_steps(self) -> int:
        """The step count under the name both trainers give it (checkpoints)."""
        return self.step

    @n_steps.setter
    def n_steps(self, value: int) -> None:
        self.step = value

    def set_stage(self, stage: int) -> None:
        """Stage 0: a fresh ``Adam`` at ``train.lr`` / ``train.weight_decay``
        over ``trainable_params_name`` (``class_embed2``), the rest frozen.
        Stage 1: the detectron2-style AdamW groups over
        ``trainable_params_name_update`` (all), as ``train`` builds them at the
        warmup boundary."""
        m, t = self.cfg.model, self.cfg.train
        if stage == 0:
            self.optimizer = build_stage_optimizer(self.model, t.lr, t.weight_decay,
                                                   m.trainable_params_name)
        elif stage == 1:
            self.optimizer = build_m2f_official_optimizer(
                self.model, base_lr=m.m2f.base_lr, weight_decay=m.m2f.weight_decay,
                trainable_names=m.trainable_params_name_update or (".",))
        else:
            raise ValueError(f"stage {stage}: the recipe has stages 0 and 1")
        self.stage = stage
        self.train_model = data_parallel(self.model, getattr(self, "train_model", None))

    def build_datasets(self):
        """(DiverseCityscapes train set with the 12-stage probabilistic
        pipeline, RoadAnomaly21 validation set)."""
        d = self.cfg.data
        train_tf = Compose([
            [ToTensor(), 1.0],
            [ColorJitter(), 0.5],
            [GaussianBlur(), 0.5],
            [RandSharpness(), 0.5],
            [AutoContrast(), 0.5],
            [Equalize(), 0.5],
            [RandResize(scale=[0.7, 0.8, 0.9, 1.0]), 0.5],
            [RandRotate(), 0.5],
            [RandHorizontalFlip(), 0.5],
            [RandVerticalFlip(), 0.5],
            [RandCrop(size=tuple(d.crop_size)), 1.0],
            [Normalize(mean=d.mean, std=d.std), 1.0],
        ])
        test_tf = Compose([ToTensor(), Normalize(mean=d.mean, std=d.std)])
        train_ds = DiverseCityscapes(
            root=d.cityscapes_root, generation_root=d.generation_root, coco_root=d.coco_root,
            split="train", transform=train_tf, anomaly_mix=d.anomaly_mix, mixup=d.mixup,
            seed=self.cfg.train.seed)
        return train_ds, RoadAnomaly21(root=d.anomaly_track_root, transform=test_tf)

    def train(self, start_epoch: int = 0, resume: Optional[str] = None) -> Dict[str, float]:
        """The recipe: ``stage1_step`` (RCL on ``class_embed2``) until
        ``warmup_epoch``, then ``stage2_step`` (the official criterion, all
        parameters); each half padded to /32. Validates every epoch, keeps
        ``AUPRC_best`` and ``last`` under ``cfg.model_dir`` and writes
        ``train/loss``, ``stage`` and ``val/*`` to its ``scalars.csv``.
        Returns ``{"AUPRC": best}``."""
        def step(stage, img_c, img_g, tgt_c, tgt_g):
            if stage == 0:
                return self.stage1_step(img_c, img_g, tgt_c, tgt_g)[0]
            return self.stage2_step(img_c, img_g, tgt_c, tgt_g)[0]

        return train_epochs(self, start_epoch, resume, step,
                            lambda stage, img_per_s: {"stage": stage})

    def load_jax_variables(self, variables: Mapping) -> None:
        """Load a JAX ``MaskFormer`` variable tree (numpy leaves) strictly,
        ``class_embed2`` included, and clear the optimizer state."""
        self.model.load_state_dict(maskformer_from_jax(variables), strict=True)
        self.optimizer.state.clear()

    def draws(self, batch: int, label_hw: Tuple[int, int]) -> Dict[str, object]:
        """The current stage's draws for one step, from the trainer's generator:
        stage 0 the RCL noise [3, batch * crop_h * crop_w], stage 1 the criterion's;
        then, in both, a Swin backbone's drop-path keep masks (``drop_path``), as
        JAX's steps run the model with ``train=True`` and a dropout key."""
        if self.stage == 0:
            ch, cw = self.crop_hw
            out = {"rcl_noise": torch.rand((3, batch * ch * cw), generator=self.generator,
                                           device=self.device)}
        else:
            n_aux = len(self.model.sem_seg_head.predictor.transformer_cross_attention_layers) - 1
            out = criterion_draws(self.generator, batch, self.crit_cfg, label_hw,
                                  crop_hw=self.crop_hw, num_aux=n_aux, device=self.device)
        out["drop_path"] = self.model.draw_drop_path_masks(batch, self.generator, self.device)
        return out

    def _pair(self, img_c, img_g, tgt_c, tgt_g):
        img = torch.cat([torch.as_tensor(img_c), torch.as_tensor(img_g)]).to(
            self.device, torch.float32)
        tgt = torch.cat([torch.as_tensor(tgt_c), torch.as_tensor(tgt_g)]).to(
            self.device, torch.int32)
        img, tgt, _ = pad_batch(img, tgt)
        return img, tgt

    def _need_stage(self, stage: int, step: str) -> None:
        if self.stage != stage:
            raise RuntimeError(f"{step} runs in stage {stage}; the trainer is in stage "
                               f"{self.stage} (set_stage)")

    def stage1_step(self, img_c: torch.Tensor, img_g: torch.Tensor, tgt_c: torch.Tensor,
                    tgt_g: torch.Tensor, draws: Optional[Dict[str, object]] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One stage-1 step (``set_stage(0)``) on the clean and augmented halves.

        img_*: normalised f32 [B, H, W, 3]; tgt_*: int [B, H, W] label maps,
        padded to /32 and concatenated as [clean ‖ augmented]. The model runs in
        training mode; ``inference`` scores at the padded size, and RCL takes
        the semantic logits (NHWC) and the anomaly score cropped to
        ``crop_size``. ``draws`` (from :meth:`draws`, or made elsewhere for a
        replay) default to fresh ones; in a process group they cover the
        global batch. Returns (loss, RCL components), detached.
        """
        self._need_stage(0, "stage1_step")
        img, tgt = self._pair(img_c, img_g, tgt_c, tgt_g)
        if draws is None:
            draws = self.draws(img.shape[0] * process_count(), tuple(tgt.shape[1:]))
        local = rank_draws(draws, paired=True)
        self.model.train()
        with torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=self.bf16):
            outputs = self.train_model(img, drop_path_masks=local.get("drop_path"))
        sem, anomaly = inference(outputs, tuple(img.shape[1:3]),
                                 num_classes=self.model.num_classes, _classes_only=True)
        ch, cw = self.crop_hw
        loss, aux = rel_contrastive_loss(sem[:, :, :ch, :cw].permute(0, 2, 3, 1),
                                         anomaly[:, :ch, :cw], tgt[:, :ch, :cw],
                                         draws["rcl_noise"], self.rcl_params)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.step += 1
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    def stage2_step(self, img_c: torch.Tensor, img_g: torch.Tensor, tgt_c: torch.Tensor,
                    tgt_g: torch.Tensor, draws: Optional[Dict[str, object]] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor,
                               List[torch.Tensor]]:
        """One stage-2 step (``set_stage(1)``) on the clean and augmented halves.

        img_*: normalised f32 [B, H, W, 3]; tgt_*: int [B, H, W] label maps (train
        ids, OOD > 100, void 255). Both halves are padded to /32 and concatenated
        as [clean ‖ augmented]. ``draws`` (from :meth:`draws`, or made elsewhere
        for a replay) default to fresh ones; in a process group they cover the
        global batch. Returns (total loss, components, global gradient norm
        before clipping, the criterion's assignments of this rank's images),
        detached.
        """
        self._need_stage(1, "stage2_step")
        img, tgt = self._pair(img_c, img_g, tgt_c, tgt_g)
        if draws is None:
            draws = self.draws(img.shape[0] * process_count(), tuple(tgt.shape[1:]))
        local = rank_draws(draws, paired=True)
        self.model.train()
        with torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=self.bf16):
            outputs = self.train_model(img, drop_path_masks=local.get("drop_path"))
        total, losses, assignments = set_criterion(outputs, tgt, local, self.crit_cfg,
                                                   self.rcl_params, crop_hw=self.crop_hw)
        self.optimizer.zero_grad(set_to_none=True)
        total.backward()
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        grad_norm = clip_grad_norm(params, self.clip_value)
        self.optimizer.step()
        self.step += 1
        return (total.detach(), {k: v.detach() for k, v in losses.items()}, grad_norm,
                assignments)

    def eval_step(self, imgs, sample_mode: str = "bilinear", score_lowres: bool = False,
                  score_topq: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """imgs: normalised f32 [B, H, W, 3], H and W multiples of 32 ->
        (sem [B, K + Q, H, W], anomaly [B, H, W]): :func:`eval_forward` with
        bf16 autocast over the f32 master weights when ``cfg.train.bf16``."""
        return eval_forward(self.model, imgs, self.bf16, sample_mode,
                            score_lowres=score_lowres, score_topq=score_topq)

    def valid(self, val_ds) -> Optional[Dict[str, float]]:
        """Per-epoch validation: binned metrics over shape-bucketed batches
        (``batched_valid``) of the anomaly score alone."""
        return batched_valid(val_ds, lambda imgs: eval_forward(self.model, imgs, self.bf16,
                                                               anomaly_only=True))


@torch.inference_mode()
def eval_forward(model: MaskFormer, imgs, bf16: bool = False, sample_mode: str = "bilinear",
                 anomaly_only: bool = False, score_lowres: bool = False, score_topq: int = 0):
    """The M2F eval forward (``make_eval_step``): ``model`` in eval mode on
    normalised f32 images [B, H, W, 3] (H and W multiples of 32), moved to the
    model's device, under bf16 autocast when ``bf16``; then ``inference`` at
    the image size -> (sem [B, K + Q, H, W], anomaly [B, H, W]), or the anomaly
    score alone when ``anomaly_only``. f32 tensors on the model's device.

    ``sample_mode`` is an evaluator's mode (``ops.ms_deform_attn.
    parse_eval_sample_mode``): ``bilinear``, ``int8``, one approximate mode, or
    a comma-separated per-encoder-layer hybrid; ``score_lowres`` /
    ``score_topq``: the approximate anomaly tails of ``inference``.

    ``int8`` takes its scale per image: the batch runs one image at a time, as
    JAX's ``build_m2f_forward`` runs the model under ``lax.map``
    (``test_runner.py:397-408``), so an image's scores do not depend on the
    images it is batched with. The op itself keeps JAX's one scale over its
    batch.
    """
    deform_mode, quantize = parse_eval_sample_mode(sample_mode, DEFORM_POINTS)
    x = torch.as_tensor(imgs)
    if x.dtype != torch.float32 or x.dim() != 4 or x.shape[-1] != 3:
        raise ValueError(f"expected normalised float32 [N, H, W, 3] images, got "
                         f"{x.dtype} {tuple(x.shape)}")
    device = next(model.parameters()).device
    x = x.to(device)
    model.eval()
    hw = tuple(x.shape[1:3])

    def run(part):
        with torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16):
            outputs = model(part, deform_sample_mode=deform_mode,
                            quantize_deform_table=quantize)
        if anomaly_only:
            return (anomaly_score_upsampled(outputs["pred_logits_ood"],
                                            outputs["pred_masks_ood"], hw),)
        return inference(outputs, hw, num_classes=model.num_classes,
                         score_lowres=score_lowres, score_topq=score_topq)

    parts = [run(part) for part in (x.split(1) if quantize else (x,))]
    out = tuple(torch.cat(t) if len(parts) > 1 else t[0] for t in zip(*parts))
    return out[0] if anomaly_only else out


def _ood_head_from_class_head(state: Dict[str, torch.Tensor]) -> None:
    """A reference checkpoint may lack ``class_embed2``; the JAX converter then
    takes ``class_embed``'s (``torch2jax.py:302``), and so does the port."""
    pred = "sem_seg_head.predictor."
    for leaf in ("weight", "bias"):
        state.setdefault(f"{pred}class_embed2.{leaf}", state[f"{pred}class_embed.{leaf}"])


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
