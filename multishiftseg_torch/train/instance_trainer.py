"""Vanilla Mask2Former semantic / instance / panoptic training and evaluation.

Counterpart of ``multishiftseg_tpu/train/instance_trainer.py`` (:54-496),
its multi-process branches (:166-181, :321-322, :350-363) through
``core.mesh``: each rank of a process group takes ``train_batch / world``
images under DDP, draws the global batch's draws and takes its rows, and the
criterion normalises over the global batch. ``clip_targets``,
``drop_empty_segments``, ``InstanceDataset`` and ``TrainM2FInstance``
(construction, ``_register_default``, ``build_dataset``, the step, ``train``,
``evaluate`` and ``_evaluate_semantic``). The ``exps/m2f_{instance,panoptic,semantic}*.yaml``
recipes select it (``train.cli``): registry records -> mappers -> per-segment
targets padded to ``T = cfg.model.m2f.max_instances`` slots (duplicate classes
allowed) -> the vanilla decoder on the unpadded crop ->
:func:`losses.criterion.set_criterion_instance`, with the detectron2-style
AdamW groups and the global gradient clip.

The model keeps f32 master weights and optimizer state; with ``cfg.train.bf16``
the forward runs under bf16 autocast, the mask products and all losses in f32.
Every random draw of the criterion comes from the trainer's
``torch.Generator``. Evaluation keeps the upsampled masks on the device: the
instance and panoptic post-processing run there
(:mod:`models.inference_extras`), and the semantic task scores through the
``mask_scores`` kernel's K-class mode and takes the argmax on the device.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from PIL import Image

from ..convert.torch_checkpoint import load_reference_weights
from ..core.config import Config
from ..core.logging import ScalarWriter
from ..core.mesh import (check_parallelism, check_train_batch, data_parallel, process_count,
                         process_index, rank_draws)
from ..data.cityscapes import LABELS
from ..data.loader import Loader, pad_to_multiple
from ..data.mappers import (SegmentTargets, instance_to_targets, panoptic_to_targets,
                            remap_classes, rgb2id, segments_to_masks, semantic_to_targets,
                            targets_to_semantic)
from ..data.registry import (DatasetCatalog, MetadataCatalog, register_instance_folder,
                             register_panoptic_folder, register_semantic_folder)
from ..data.transforms import Compose, Normalize, RandCrop, RandHorizontalFlip, Sample, ToTensor
from ..evals.instance_metrics import InstanceSegEvaluator
from ..evals.panoptic_metrics import PanopticEvaluator, targets_to_panoptic
from ..evals.seg_metrics import compute_metric, hist_info
from ..losses.criterion import CriterionConfig, criterion_draws, set_criterion_instance
from ..models.inference_extras import instance_inference, panoptic_inference
from ..models.maskformer import MaskFormer, maskformer_from_config
from ..ops.resize import resize_bilinear_nchw
from ..ops.scores import semantic_inference_upsampled
from ..utils import resolve_device
from .checkpoint import CheckpointManager, restore_checkpoint
from .epochs import run_epoch
from .state import build_m2f_official_optimizer, clip_grad_norm

log = logging.getLogger(__name__)

# thing classes of the Cityscapes evaluation: raw label ids, and train ids (11..18)
THING_RAW_IDS = [l.id for l in LABELS if l.has_instances and not l.ignore_in_eval]
THING_TRAIN_IDS = {l.train_id for l in LABELS if l.has_instances and not l.ignore_in_eval}


def _take_segments(tgt: SegmentTargets, keep: np.ndarray) -> SegmentTargets:
    """Keep the given (sorted) segment indices, renumbering the id map."""
    k = len(tgt.classes)
    remap = -np.ones(k + 1, np.int32)
    remap[keep] = np.arange(len(keep), dtype=np.int32)
    id_map = np.where(tgt.id_map >= 0, remap[tgt.id_map], -1).astype(np.int32)
    return SegmentTargets(id_map, tgt.classes[keep], tgt.is_thing[keep])


def _areas(tgt: SegmentTargets) -> np.ndarray:
    return np.bincount(tgt.id_map[tgt.id_map >= 0].ravel(), minlength=len(tgt.classes))


def clip_targets(tgt: SegmentTargets, k_max: int) -> SegmentTargets:
    """Keep the ``k_max`` largest segments (by pixel count), renumbered."""
    if len(tgt.classes) <= k_max:
        return tgt
    keep = np.sort(np.argsort(_areas(tgt))[::-1][:k_max])
    return _take_segments(tgt, keep)


def drop_empty_segments(tgt: SegmentTargets) -> SegmentTargets:
    """Drop segments with no pixels (cropped away): panoptic targets come from
    a record's ``segments_info``, which lists segments the crop may remove."""
    if not len(tgt.classes):
        return tgt
    keep = np.where(_areas(tgt) > 0)[0]
    return tgt if len(keep) == len(tgt.classes) else _take_segments(tgt, keep)


class InstanceDataset:
    """Catalog records -> ``(image [H, W, 3] f32, id_map [H, W] i32, classes [T] i32)``.

    ``task`` follows the registry metadata: 'instance' reads Cityscapes
    ``instanceIds`` pngs (``class_id * divisor + instance``), 'panoptic' the
    RGB id pngs and each record's ``segments_info``, 'sem_seg' label maps (one
    segment per present class). The transform runs on the raw encoded map;
    targets are built after it, then mapped to training ids (``class_map``),
    clipped to the ``max_instances`` largest segments and padded. Files decode
    through PIL; each item draws from one generator per (seed, epoch, index).
    """

    def __init__(self, name: str, transform: Compose, max_instances: int, seed: int = 0):
        self.records = DatasetCatalog.get(name)
        self.meta = MetadataCatalog.get(name)
        self.task = self.meta.get("task", "instance")
        if self.task not in ("instance", "panoptic", "sem_seg"):
            raise ValueError(f"unknown task {self.task!r}")
        self.transform = transform
        self.max_instances = max_instances
        self.seed = seed
        self._epoch = 0

    def __len__(self):
        return len(self.records)

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __getitem__(self, i: int):
        rec = self.records[i]
        rng = np.random.default_rng((self.seed * 100003 + self._epoch) * 1000003 + i)
        img = np.asarray(Image.open(rec["file_name"]).convert("RGB"), np.float32) / 255.0
        if self.task == "instance":
            enc = np.asarray(Image.open(rec["instance_file_name"]), np.int32)
        elif self.task == "sem_seg":
            enc = np.asarray(Image.open(rec["sem_seg_file_name"]), np.int32)
        else:
            enc = rgb2id(np.asarray(
                Image.open(rec["pan_seg_file_name"]).convert("RGB"))).astype(np.int32)
        s = self.transform(rng, Sample(img, enc))
        if self.task == "instance":
            tgt = instance_to_targets(s.mask, divisor=self.meta.get("id_divisor", 1000))
        elif self.task == "sem_seg":
            tgt = semantic_to_targets(s.mask, ignore_label=self.meta.get("ignore_label", 255))
        else:
            tgt = drop_empty_segments(panoptic_to_targets(
                s.mask, rec["segments_info"], thing_ids=self.meta.get("thing_ids")))
        class_map = self.meta.get("class_map")
        if class_map:  # raw dataset ids -> contiguous training ids
            tgt = remap_classes(tgt, class_map)
        k = len(tgt.classes)
        if k > self.max_instances:
            log.warning("record %s: %d segments clipped to %d", rec["file_name"], k,
                        self.max_instances)
            tgt = clip_targets(tgt, self.max_instances)
        tgt = tgt.padded(self.max_instances)
        return (s.image.astype(np.float32), tgt.id_map.astype(np.int32),
                tgt.classes.astype(np.int32))


class TrainM2FInstance:
    """Instance / panoptic / semantic trainer (single stage, batches not
    paired). ``model`` defaults to the configured MaskFormer at random init
    from ``cfg.train.seed``; ``weight_path`` is a reference checkpoint, loaded
    strictly by the reference's names. Runs on CUDA unless the caller asks
    for the CPU. ``dataset_name`` defaults to the Cityscapes folder under
    ``cfg.data.cityscapes_root``, registered in the task's layout."""

    def __init__(self, cfg: Config, weight_path: Optional[str] = None,
                 model: Optional[MaskFormer] = None, dataset_name: Optional[str] = None,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        check_parallelism(cfg.train)
        self.local_batch = check_train_batch(cfg.train.train_batch)
        m = cfg.model.m2f
        self.task = ("panoptic" if m.panoptic_on
                     else "instance" if m.instance_on else "semantic")
        if model is None:
            torch.manual_seed(cfg.train.seed)
            model = maskformer_from_config(m)
        if weight_path:
            load_reference_weights(model, weight_path)
        self.model = model.to(self.device).float()
        self.crit_cfg = CriterionConfig(
            num_classes=m.num_classes, eos_coef=m.no_object_weight,
            num_points=m.train_num_points, oversample_ratio=m.oversample_ratio,
            importance_sample_ratio=m.importance_sample_ratio,
            class_weight=m.class_weight, mask_weight=m.mask_weight,
            dice_weight=m.dice_weight, ood_weight=0.0, ood_loss="none",
            deep_supervision=m.deep_supervision, mask_loss_with_pixel_selection=False)
        self.dataset_name = dataset_name or self._register_default()
        self.clip_value = m.clip_gradients_value
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.train.seed)
        self.bf16 = cfg.train.bf16
        self.n_steps = 0
        self.set_stage(0)

    def set_stage(self, stage: int) -> None:
        """The recipe's one stage: a fresh AdamW with the detectron2-style
        groups over ``trainable_params_name`` (the checkpoints' interface)."""
        if stage != 0:
            raise ValueError(f"stage {stage}: this recipe has stage 0 only")
        m = self.cfg.model
        self.optimizer = build_m2f_official_optimizer(
            self.model, base_lr=m.m2f.base_lr, weight_decay=m.m2f.weight_decay,
            trainable_names=m.trainable_params_name or (".",))
        self.stage = 0
        self.train_model = data_parallel(self.model, getattr(self, "train_model", None))

    def _register_default(self, split: str = "train") -> str:
        """Register the Cityscapes layout of the task under
        ``cfg.data.cityscapes_root`` (a name already registered is reused):
        labelTrainIds for semantic, instanceIds with the 8 evaluated thing
        classes mapped to 0..7 for instance, the panoptic pngs and json with
        raw ids mapped to train ids for panoptic."""
        root = self.cfg.data.cityscapes_root
        name = f"cityscapes_{self.task}_{split}"
        if name in DatasetCatalog.list():
            return name
        image_dir = os.path.join(root, "leftImg8bit", split)
        if self.task == "semantic":
            register_semantic_folder(name, image_dir=image_dir,
                                     label_dir=os.path.join(root, "gtFine", split),
                                     image_suffix="_leftImg8bit.png",
                                     label_suffix="_gtFine_labelTrainIds.png")
        elif self.task == "instance":
            register_instance_folder(name, image_dir=image_dir,
                                     instance_dir=os.path.join(root, "gtFine", split))
            MetadataCatalog.set(name, class_map={c: i for i, c in enumerate(THING_RAW_IDS)})
        else:
            register_panoptic_folder(
                name, image_dir=image_dir,
                panoptic_dir=os.path.join(root, "gtFine", f"cityscapes_panoptic_{split}"),
                panoptic_json=os.path.join(root, "gtFine", f"cityscapes_panoptic_{split}.json"),
                thing_ids=THING_RAW_IDS)
            MetadataCatalog.set(name, class_map={l.id: l.train_id for l in LABELS
                                                 if 0 <= l.train_id < 255})
        return name

    def build_dataset(self) -> InstanceDataset:
        """The training set: ToTensor, horizontal flip (p 0.5), ``RandCrop``
        to ``crop_size``, Normalize."""
        d = self.cfg.data
        transform = Compose([
            [ToTensor(), 1.0],
            [RandHorizontalFlip(), 0.5],
            [RandCrop(size=tuple(d.crop_size)), 1.0],
            [Normalize(mean=d.mean, std=d.std), 1.0],
        ])
        return InstanceDataset(self.dataset_name, transform, self.cfg.model.m2f.max_instances,
                               seed=self.cfg.train.seed)

    def draws(self, batch: int, slots: int) -> Dict[str, object]:
        """One step's criterion draws from the trainer's generator: the match
        points and, per (image, slot), the uncertain-point candidates and
        fill; the same again per auxiliary output; then a Swin backbone's
        drop-path keep masks (``drop_path``)."""
        n_aux = len(self.model.sem_seg_head.predictor.transformer_cross_attention_layers)
        out = criterion_draws(self.generator, batch, self.crit_cfg, (0, 0), num_aux=n_aux,
                              device=self.device, slots=slots)
        out["drop_path"] = self.model.draw_drop_path_masks(batch, self.generator, self.device)
        return out

    def step(self, img, id_map, classes, draws: Optional[Dict[str, object]] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor, list]:
        """One training step on a batch: img normalised f32 [B, H, W, 3] (the
        crop, unpadded), id_map int [B, H, W] (segment slot, -1 ignore),
        classes int [B, T] (-1 padding). ``draws`` (from :meth:`draws`, or
        made elsewhere for a replay) default to fresh ones; in a process
        group they cover the global batch. Returns (loss,
        components, global gradient norm before clipping, assignments),
        detached."""
        img = torch.as_tensor(img).to(self.device, torch.float32)
        id_map = torch.as_tensor(id_map).to(self.device, torch.int32)
        classes = torch.as_tensor(classes).to(self.device, torch.int64)
        if draws is None:
            draws = self.draws(img.shape[0] * process_count(), classes.shape[1])
        local = rank_draws(draws, paired=False)
        self.model.train()
        with torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=self.bf16):
            outputs = self.train_model(img, drop_path_masks=local.get("drop_path"))
        total, losses, assignments = set_criterion_instance(outputs, id_map, classes, local,
                                                            self.crit_cfg)
        self.optimizer.zero_grad(set_to_none=True)
        total.backward()
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        grad_norm = clip_grad_norm(params, self.clip_value)
        self.optimizer.step()
        self.n_steps += 1
        return (total.detach(), {k: v.detach() for k, v in losses.items()}, grad_norm,
                assignments)

    def train(self, start_epoch: int = 0, resume: Optional[str] = None) -> Dict[str, float]:
        """Epochs ``start_epoch`` (or the one after checkpoint ``resume``'s)
        to ``cfg.train.n_epochs``: a shuffling loader onto the device, the
        steps, ``train/loss`` in ``scalars.csv`` and the ``last`` checkpoint
        (model, optimizer, generator) every epoch. Each epoch's steps, times
        and loss come from :func:`~.epochs.run_epoch`, as the OOD trainers'
        (no step waits for the device), and go to ``self.history``. Returns
        ``{"loss": the last epoch's}``."""
        cfg = self.cfg
        ds = self.build_dataset()
        loader = Loader(ds, batch_size=self.local_batch, shuffle=True, drop_last=True,
                        num_workers=cfg.data.num_workers, seed=cfg.train.seed,
                        device=self.device, shard_index=process_index(),
                        shard_count=process_count())
        ckpt = CheckpointManager(cfg.model_dir)
        if resume and ckpt.exists(resume):
            # the optimizer's moments too: a fresh one would change the dynamics
            start_epoch = int(restore_checkpoint(ckpt.path(resume), self)["epoch"]) + 1
            log.warning("resumed %s at epoch %d", resume, start_epoch)
        writer = (ScalarWriter(cfg.model_dir)
                  if cfg.model_dir and process_index() == 0 else None)
        self.history = []
        last_loss = float("nan")
        for epoch in range(start_epoch, cfg.train.n_epochs):
            ds.set_epoch(epoch)
            rec = run_epoch(self, loader, lambda img, id_map, classes: (
                self.step(img, id_map, classes)[0], img.shape[0]))
            last_loss = rec["loss"]
            log.warning("epoch %d loss %.4f (%.1f img/s)", epoch, last_loss, rec["img_per_s"])
            if writer is not None:
                writer.add_scalar("train/loss", last_loss, epoch)
            ckpt.save("last", self, epoch=epoch)
            self.history.append({"epoch": epoch, **rec})
        if writer is not None:
            writer.close()
        return {"loss": last_loss}

    @torch.inference_mode()
    def _forward(self, img: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """Eval forward of one normalised image [H, W, 3] padded to /32 ->
        (class logits [Q, K+1] f32, mask logits [Q, H, W] f32 upsampled to the
        padded size), on the device."""
        x = torch.from_numpy(np.ascontiguousarray(img[None])).to(self.device)
        self.model.eval()
        with torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=self.bf16):
            out = self.model(x)
        return out["pred_logits"][0].float(), out["pred_masks"].float()

    def _eval_dataset(self, dataset_name: Optional[str]) -> InstanceDataset:
        d = self.cfg.data
        transform = Compose([[ToTensor(), 1.0], [Normalize(mean=d.mean, std=d.std), 1.0]])
        # generous padding: evaluation ground truth must not clip segments
        return InstanceDataset(dataset_name or self._register_default("val"), transform,
                               max_instances=256)

    def evaluate(self, dataset_name: Optional[str] = None,
                 max_images: Optional[int] = None) -> Optional[Dict[str, float]]:
        """COCO-protocol instance AP over a registered val split (the task's
        Cityscapes val folder by default): the eval forward on the image padded
        to /32, the mask logits upsampled and cropped on the device,
        ``instance_inference`` -> :class:`InstanceSegEvaluator`. The panoptic
        task scores things only (train ids 11-18) and adds PQ / SQ / RQ with
        their things / stuff splits (``panoptic_inference`` ->
        :class:`PanopticEvaluator`); the semantic task reports mIoU and pixel
        accuracy instead. None for an empty split."""
        ds = self._eval_dataset(dataset_name)
        if len(ds) == 0:
            return None
        n = len(ds) if max_images is None else min(len(ds), max_images)
        if self.task == "semantic":
            return self._evaluate_semantic(ds, n)
        m = self.cfg.model.m2f
        thing_ids = THING_TRAIN_IDS if self.task == "panoptic" else None
        ev = InstanceSegEvaluator(m.num_classes)
        pq_ev = PanopticEvaluator(m.num_classes, thing_ids) if self.task == "panoptic" else None
        for i in range(n):
            img, id_map, classes = ds[i]
            imgp, (h, w) = pad_to_multiple(img, 32)
            logits, masks = self._forward(imgp)
            masks = resize_bilinear_nchw(masks, imgp.shape[:2], align_corners=False)[0, :, :h, :w]
            pred = instance_inference(logits, masks, thing_ids=thing_ids)
            if pq_ev is not None:
                pan_seg, seg_info = panoptic_inference(logits, masks, thing_ids=thing_ids)
                pq_ev.process(pan_seg, seg_info, *targets_to_panoptic(id_map, classes))
            del masks
            k = int((classes >= 0).sum())  # padded() keeps the valid slots first
            gt_masks = segments_to_masks(id_map, k)
            gt_classes = classes[:k].astype(np.int64)
            if thing_ids is not None and k:
                keep = np.isin(gt_classes, list(thing_ids))
                gt_masks, gt_classes = gt_masks[keep], gt_classes[keep]
            ev.process({"masks": pred["pred_masks"], "scores": pred["scores"],
                        "classes": pred["pred_classes"]},
                       {"masks": gt_masks, "classes": gt_classes})
        out = ev.evaluate()
        if pq_ev is not None and out is not None:
            out.update({k: v for k, v in pq_ev.evaluate().items() if k != "PQ_per_class"})
        return out

    def _evaluate_semantic(self, ds: InstanceDataset, n: int) -> Optional[Dict[str, float]]:
        """mIoU and pixel accuracy: per image the argmax, on the device, of the
        K class scores softmax(cls)[:, :K] x sigmoid(upsampled masks) (the
        ``mask_scores`` kernel's K-class mode on the card); the ground truth
        is reassembled from the segment targets."""
        num_classes = self.cfg.model.m2f.num_classes
        results = []
        for i in range(n):
            img, id_map, classes = ds[i]
            imgp, (h, w) = pad_to_multiple(img, 32)
            with torch.inference_mode():
                logits, masks = self._forward(imgp)
                sem = semantic_inference_upsampled(logits[None], masks, imgp.shape[:2],
                                                   num_classes, _classes_only=True)
                pred = sem[0].argmax(0)[:h, :w].cpu().numpy()
            k = int((classes >= 0).sum())
            gt = targets_to_semantic(SegmentTargets(id_map, classes[:k].astype(np.int64),
                                                    np.zeros(k, bool)))
            hist, labeled, correct = hist_info(num_classes, pred, gt)
            results.append({"hist": hist, "labeled": labeled, "correct": correct})
        miou, pacc = compute_metric(results, num_classes)
        return {"mIoU": float(miou), "pixel_acc": float(pacc)}
