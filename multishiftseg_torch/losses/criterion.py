"""Set criterion for mask classification (Hungarian-matched losses) with the
Mask2Anomaly OOD extensions, and the label-point kernel it samples targets with.

Counterpart of ``multishiftseg_tpu/losses/criterion.py:37-336, 339-495``
(``CriterionConfig``, ``set_criterion``, ``_single_output_losses``,
``_plain_mask_losses``, ``_clean_point_coords``, ``uncertain_point_coords``,
``_finish_ood_loss``, the deep-supervision loop, and the instance criterion
``set_criterion_instance`` / ``_instance_output_losses``). In
:func:`set_criterion` the batch's leading axis is [clean ‖ augmented] and the
target slots are the K train ids with a presence mask; in
:func:`set_criterion_instance` the slots are T segments of an id map, each with
its class (duplicates allowed, -1 for padding).
Target masks are never materialised: they are sampled at points from the label
map, by the CUDA kernels of ``csrc/label_points.cu`` for CUDA tensors (the maps
packed once a call into each 2x2 block's corner codes, :func:`label_quads`,
which every sampling call of the call shares) and by the plain 4-corner gather
for CPU tensors.

Random numbers are an input. :func:`criterion_draws` makes every draw of one
``set_criterion`` call from a ``torch.Generator``; the losses take them as
tensors, so a test can hand both frameworks the very same numbers (the JAX
version draws them from ``jax.random`` keys at ``criterion.py:360-361, 405,
417, 156-166, 306-307`` and ``rcl.py:171-174``).

All losses run in f32, outside any autocast region.

Inside a process group (``core.mesh``) the outputs and labels are this rank's
rows and every normaliser spans the global batch, as in JAX's step over global
arrays: ``num_masks``, the class loss's weighted mean and the mask losses' sums
are all-reduced, and RCL reduces globally itself. The match and the point
sampling are per mask, so they run on the rank's rows.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.mesh import all_sum, global_sum
from ..ops.resize import resize_bilinear
from ..ops.sampling import point_sample_nchw
from ..ops.scores import mask2former_semantic_logits
from .matcher import launch_device, match
from .rcl import RCLParams, rel_contrastive_loss

# Kernel launches per entry point (see ``ops.launch_counts``): the classes
# entry (every class at the matcher's points), the rows entry and the pack of
# the label maps they read.
LAUNCHES = {"label_points_classes": 0, "label_points_rows": 0, "label_quads": 0}


@dataclass(frozen=True)
class CriterionConfig:
    num_classes: int = 19
    eos_coef: float = 0.1
    num_points: int = 12544
    importance_sample_ratio: float = 0.75
    oversample_ratio: float = 3.0
    class_weight: float = 2.0
    mask_weight: float = 5.0
    dice_weight: float = 5.0
    ood_weight: float = 1.0
    ood_loss: str = "RCL"  # margin | bce | RCL | none
    margin: float = 1.0
    deep_supervision: bool = False
    # clean-point sampling constants (hard-coded in the reference)
    clean_importance_ratio: float = 0.95
    clean_oversample: float = 1.25
    # on: loss_masks_aug (clean / augmented split); off: plain loss_masks
    mask_loss_with_pixel_selection: bool = True
    # the JAX package's TPU opt-in approximate top-k; not ported
    approx_point_topk: bool = False


# ---------------------------------------------------------------------------
# label points: kernel wrappers and plain versions


def label_quads(labels: torch.Tensor) -> Optional[torch.Tensor]:
    """The packed corner codes of ``labels`` [B, H, W] for the card's sampler
    (``csrc/label_points.cu``, one launch): [B, H + 1, WQ] int32, word (qy, qx)
    the four corners' codes of the 2x2 block at pixel (qx - 1, qy - 1), a
    label in [0, 254] its own code, anything else 255. The criterion makes
    them once a call and hands them to its sampling calls; None for CPU
    labels, which the plain versions read themselves."""
    if labels.device.type == "cpu":
        return None
    labels = _int32_labels(labels)
    b, h, w = labels.shape
    fn = _lp_entry("label_quads")
    quads = torch.empty((b, h + 1, _quads_width(w)), dtype=torch.int32, device=labels.device)
    with launch_device(labels.device):
        rc = fn(labels.data_ptr(), quads.data_ptr(), b, h, w,
                torch._C._cuda_getCurrentRawStream(labels.device.index))
    if rc != 0:
        raise RuntimeError(f"label_quads failed: cudaError {rc}")
    LAUNCHES["label_quads"] += 1
    return quads


def label_quads_plain(labels: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`label_quads` (the same words, on any device)."""
    b, h, w = labels.shape
    wq = _quads_width(w)
    code = torch.where((labels >= 0) & (labels < 255), labels.long(), 255)
    padded = torch.full((b, h + 2, wq + 1), 255, dtype=torch.int64, device=labels.device)
    padded[:, 1:h + 1, 1:w + 1] = code
    word = (padded[:, :h + 1, :wq] | padded[:, :h + 1, 1:] << 8
            | padded[:, 1:, :wq] << 16 | padded[:, 1:, 1:] << 24)
    return torch.where(word >= 2 ** 31, word - 2 ** 32, word).to(torch.int32)


def _quads_width(w: int) -> int:
    return (w + 1 + 3) // 4 * 4


def sample_target_points(labels: torch.Tensor, coords: torch.Tensor,
                         num_classes: int, quads: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bilinear samples of the one-hot masks of classes 0..K-1.

    labels [B, H, W] int; coords [B, P, 2] (x, y) in [0, 1] -> [B, K, P] f32.
    ``quads``: :func:`label_quads` of ``labels`` (made here on the card when
    not given).
    """
    if labels.device.type == "cpu":
        return sample_target_points_plain(labels, coords, num_classes)
    return _label_points_cuda(labels, quads, coords, None, num_classes, 1, 0)


def sample_class_points(labels: torch.Tensor, coords: torch.Tensor,
                        class_ids: torch.Tensor, rows_per_map: int = 1,
                        map_offset: int = 0, quads: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Bilinear samples of one class's one-hot mask per row.

    labels [B, H, W] int; coords [R, P, 2]; class_ids [R] -> [R, P] f32. Row r
    reads label map ``map_offset + r // rows_per_map``: the JAX package's
    ``jnp.repeat`` of the label maps, without the copy. ``quads`` as for
    :func:`sample_target_points`.
    """
    if labels.device.type == "cpu":
        return sample_class_points_plain(labels, coords, class_ids, rows_per_map, map_offset)
    return _label_points_cuda(labels, quads, coords, class_ids, rows_per_map, rows_per_map,
                              map_offset)


def _corner_gather_labels(labels: torch.Tensor, coords: torch.Tensor):
    """labels [B, H, W], coords [B, P, 2] -> corner labels [B, P, 4] (-1 off the
    map) and corner weights [B, P, 4] (0 off the map), corners in the order
    (x0, y0), (x1, y0), (x0, y1), (x1, y1)."""
    b, h, w = labels.shape
    x = coords[..., 0] * w - 0.5
    y = coords[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    x0i = x0.long()
    y0i = y0.long()
    flat = labels.reshape(b, h * w)
    labs, wgts = [], []
    for dx, dy, wgt in ((0, 0, (1 - wx) * (1 - wy)), (1, 0, wx * (1 - wy)),
                        (0, 1, (1 - wx) * wy), (1, 1, wx * wy)):
        ix, iy = x0i + dx, y0i + dy
        valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        idx = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
        lab = flat.gather(1, idx)
        labs.append(torch.where(valid, lab, torch.full_like(lab, -1)))
        wgts.append(wgt * valid.float())
    return torch.stack(labs, -1), torch.stack(wgts, -1)


def sample_target_points_plain(labels, coords, num_classes):
    """Plain version of :func:`sample_target_points`."""
    cl, cw = _corner_gather_labels(labels, coords.float())
    onehot = (cl[..., None] == torch.arange(num_classes, device=labels.device)).float()
    return torch.einsum("bpc,bpck->bkp", cw, onehot)


def sample_class_points_plain(labels, coords, class_ids, rows_per_map=1, map_offset=0):
    """Plain version of :func:`sample_class_points`."""
    r = coords.shape[0]
    maps = map_offset + torch.arange(r, device=labels.device) // rows_per_map
    cl, cw = _corner_gather_labels(labels[maps], coords.float())
    hit = (cl == class_ids.to(cl.dtype)[:, None, None]).float()
    return (cw * hit).sum(-1)


_LP_ENTRIES: Dict[str, object] = {}


def _lp_entry(name: str):
    """``csrc/label_points.cu``'s entry ``name``, resolved once."""
    fn = _LP_ENTRIES.get(name)
    if fn is None:
        from .._build import function

        pointers, ints = {"label_quads": (2, 3), "label_points_classes": (4, 5),
                          "label_points_rows": (5, 6)}[name]
        fn = _LP_ENTRIES[name] = function("label_points", name, [ctypes.c_void_p] * pointers
                                          + [ctypes.c_int] * ints + [ctypes.c_void_p])
    return fn


def _int32_labels(labels: torch.Tensor) -> torch.Tensor:
    if labels.dim() != 3:
        raise ValueError(f"expected labels [B, H, W], got {tuple(labels.shape)}")
    return labels.to(torch.int32).contiguous()


def _label_points_cuda(labels, quads, coords, class_ids, k_or_rows, rows_per_map, map_offset):
    if coords.dim() != 3 or coords.shape[-1] != 2:
        raise ValueError(f"expected coords [R, P, 2], got {tuple(coords.shape)}")
    if coords.dtype != torch.float32:
        raise TypeError(f"coords must be float32, got {coords.dtype}")
    labels = _int32_labels(labels)
    coords = coords.contiguous()
    b, h, w = labels.shape
    r, p = coords.shape[:2]
    dev = labels.device
    if coords.device != dev:
        raise ValueError(f"coords on {coords.device}, labels on {dev}")
    if quads is None:
        quads = label_quads(labels)
    elif (tuple(quads.shape) != (b, h + 1, _quads_width(w)) or quads.dtype != torch.int32
          or quads.device != dev or not quads.is_contiguous()):
        raise ValueError(f"quads {tuple(quads.shape)} {quads.dtype} on {quads.device} are not "
                         f"label_quads of labels {tuple(labels.shape)} on {dev}")
    if class_ids is None:
        if r != b:
            raise ValueError(f"coords cover {r} maps, labels hold {b}")
        entry = "label_points_classes"
        out = torch.empty((b, k_or_rows, p), dtype=torch.float32, device=dev)
        args = (labels.data_ptr(), quads.data_ptr(), coords.data_ptr(), out.data_ptr(), b, h, w,
                p, k_or_rows)
    else:
        class_ids = class_ids.to(device=dev, dtype=torch.int32).contiguous()
        if tuple(class_ids.shape) != (r,):
            raise ValueError(f"class_ids {tuple(class_ids.shape)}, expected ({r},)")
        if map_offset < 0 or map_offset + (r - 1) // rows_per_map >= b:
            raise ValueError(f"rows {r} at {rows_per_map} per map from map {map_offset} "
                             f"overrun {b} label maps")
        entry = "label_points_rows"
        out = torch.empty((r, p), dtype=torch.float32, device=dev)
        args = (labels.data_ptr(), quads.data_ptr(), coords.data_ptr(), class_ids.data_ptr(),
                out.data_ptr(), r, h, w, p, rows_per_map, map_offset)
    fn = _lp_entry(entry)
    with launch_device(dev):
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError(f"{entry} failed: cudaError {rc}")
    LAUNCHES[entry] += 1
    return out


# ---------------------------------------------------------------------------
# random draws


def _point_counts(cfg: CriterionConfig):
    clean = (int(cfg.num_points * cfg.clean_oversample),
             cfg.num_points - int(cfg.clean_importance_ratio * cfg.num_points))
    uncertain = (int(cfg.num_points * cfg.oversample_ratio),
                 cfg.num_points - int(cfg.importance_sample_ratio * cfg.num_points))
    return clean, uncertain


def criterion_draws(generator: torch.Generator, batch: int, cfg: CriterionConfig,
                    label_hw: Tuple[int, int], crop_hw: Optional[Tuple[int, int]] = None,
                    num_aux: int = 0, device=None, slots: Optional[int] = None
                    ) -> Dict[str, object]:
    """Every uniform [0, 1) draw of one :func:`set_criterion` call, made from
    ``generator`` on its device (or ``device``). ``slots`` replaces K, the
    target slots of each image, for :func:`set_criterion_instance` (its T
    segment slots; ``cfg`` then has no pixel selection and no OOD loss).

    Keys: ``match_coords`` [B, P, 2]; with pixel selection ``orig_coords``
    [B/2, K, P, 2], ``clean_coords`` [B/2 * K, 1.25 P, 2] and ``clean_rand``
    [B/2 * K, P - 0.95 P, 2]; without it ``uncertain_coords`` [B * K, 3 P, 2] and
    ``uncertain_rand`` [B * K, P - 0.75 P, 2]; with the RCL loss ``rcl_noise``
    [3, B * ch * cw]; under deep supervision ``aux``, one such dict per
    auxiliary output.
    """
    device = device if device is not None else generator.device
    K = cfg.num_classes if slots is None else slots
    P, half = cfg.num_points, batch // 2
    (n_clean, r_clean), (n_unc, r_unc) = _point_counts(cfg)

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=device)

    def one():
        d = {"match_coords": rand(batch, P, 2)}
        if cfg.mask_loss_with_pixel_selection:
            d["orig_coords"] = rand(half, K, P, 2)
            d["clean_coords"] = rand(half * K, n_clean, 2)
            d["clean_rand"] = rand(half * K, r_clean, 2)
        else:
            d["uncertain_coords"] = rand(batch * K, n_unc, 2)
            d["uncertain_rand"] = rand(batch * K, r_unc, 2)
        if cfg.ood_loss == "RCL":
            ch, cw = crop_hw or label_hw
            d["rcl_noise"] = rand(3, batch * ch * cw)
        return d

    draws = one()
    if cfg.deep_supervision:
        draws["aux"] = [one() for _ in range(num_aux)]
    return draws


# ---------------------------------------------------------------------------
# losses


def _dice(point_logits, point_labels, w):
    """Per-mask dice, weighted sum. point_*: [M, P]; w: [M]."""
    probs = torch.sigmoid(point_logits)
    num = 2.0 * (probs * point_labels).sum(-1)
    den = probs.sum(-1) + point_labels.sum(-1)
    return ((1.0 - (num + 1.0) / (den + 1.0)) * w).sum()


def _sigmoid_ce(point_logits, point_labels, w):
    """Per-mask mean BCE, weighted sum."""
    ce = (F.relu(point_logits) - point_logits * point_labels
          + F.softplus(-point_logits.abs()))
    return (ce.mean(-1) * w).sum()


def _check_exact_topk(cfg: CriterionConfig) -> None:
    if cfg.approx_point_topk:
        raise NotImplementedError("approx_point_topk (the JAX package's TPU "
                                  "approx_min_k opt-in) is not ported")


@torch.no_grad()
def clean_point_coords(pred_masks: torch.Tensor, labels: torch.Tensor,
                       class_ids: torch.Tensor, coords: torch.Tensor, rand: torch.Tensor,
                       cfg: CriterionConfig, rows_per_map: int, map_offset: int,
                       quads: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Lowest-BCE ("clean") points of each matched mask of the augmented half
    (``criterion.py:144-167``), all rows at once.

    pred_masks [R, Hs, Ws] logits; labels [B, H, W]; class_ids [R]; coords
    [R, 1.25 P, 2] and rand [R, P - 0.95 P, 2] are the draws -> [R, P, 2];
    quads: :func:`label_quads` of ``labels``.
    """
    _check_exact_topk(cfg)
    num_clean = int(cfg.clean_importance_ratio * cfg.num_points)
    logits = point_sample_nchw(pred_masks[:, None], coords)[:, 0]
    tgt = sample_class_points(labels, coords, class_ids, rows_per_map, map_offset, quads)
    bce = F.relu(logits) - logits * tgt + F.softplus(-logits.abs())
    idx = torch.topk(-bce, num_clean, dim=-1).indices
    clean = coords.gather(1, idx[..., None].expand(-1, -1, 2))
    return torch.cat([clean, rand], dim=1)


@torch.no_grad()
def uncertain_point_coords(pred_masks: torch.Tensor, coords: torch.Tensor,
                           rand: torch.Tensor, cfg: CriterionConfig) -> torch.Tensor:
    """PointRend importance sampling per mask (``criterion.py:170-194``): of the
    ``3 P`` candidates keep the ``0.75 P`` with the highest uncertainty -|logit|,
    then the fresh uniform points. pred_masks [R, Hs, Ws] -> [R, P, 2]."""
    _check_exact_topk(cfg)
    num_uncertain = int(cfg.importance_sample_ratio * cfg.num_points)
    logits = point_sample_nchw(pred_masks[:, None], coords)[:, 0]
    idx = torch.topk(-logits.abs(), num_uncertain, dim=-1).indices
    out = coords.gather(1, idx[..., None].expand(-1, -1, 2))
    return torch.cat([out, rand], dim=1) if rand.shape[1] > 0 else out


def _plain_mask_losses(draws, matched_masks, sem_seg, w_valid, num_masks, cfg, quads=None):
    """The plain uncertainty-sampled ``loss_masks`` over all matched masks
    (``criterion.py:197-223``). matched_masks [B, K, Hs, Ws]."""
    b, t = matched_masks.shape[:2]
    mm = matched_masks.reshape(b * t, *matched_masks.shape[2:])
    class_ids = torch.arange(t, device=mm.device, dtype=torch.int32).repeat(b)
    coords = uncertain_point_coords(mm.detach(), draws["uncertain_coords"],
                                    draws["uncertain_rand"], cfg)
    logits = point_sample_nchw(mm[:, None], coords)[:, 0]
    tgts = sample_class_points(sem_seg, coords, class_ids, rows_per_map=t, quads=quads)
    w = w_valid.reshape(-1)
    return {"loss_mask": all_sum(_sigmoid_ce(logits, tgts, w)) / num_masks * cfg.mask_weight,
            "loss_dice": all_sum(_dice(logits, tgts, w)) / num_masks * cfg.dice_weight}


def set_criterion(outputs: Dict[str, object], sem_seg: torch.Tensor, draws: Dict[str, object],
                  cfg: CriterionConfig, rcl_params: Optional[RCLParams] = None,
                  crop_hw: Optional[Tuple[int, int]] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], List[torch.Tensor]]:
    """Weighted total loss, its components and the assignments.

    outputs: the decoder's prediction dict; sem_seg [B, Hp, Wp] int label map
    padded with 255; draws from :func:`criterion_draws`; crop_hw the unpadded
    label extent the RCL loss reads. Under ``cfg.deep_supervision`` the match and
    the losses repeat per auxiliary output with ``_{i}``-suffixed keys. The
    assignments are [B, K] (the query matched to each class slot), the final
    output's first, then one per auxiliary output.
    """
    dev = sem_seg.device.type
    with torch.autocast(dev, enabled=False):
        quads = label_quads(sem_seg)  # shared by every output's sampling
        total, losses, assignment = _single_output_losses(outputs, sem_seg, draws, cfg,
                                                          rcl_params, crop_hw, quads)
        assignments = [assignment]
        if cfg.deep_supervision:
            aux_draws: List[dict] = draws["aux"]
            for i, aux in enumerate(outputs.get("aux_outputs", [])):
                has_ood = "pred_logits_ood" in aux
                aux_cfg = cfg if has_ood or cfg.ood_loss == "none" else (
                    dataclasses.replace(cfg, ood_loss="margin"))
                t_i, l_i, a_i = _single_output_losses(
                    aux, sem_seg, aux_draws[i], aux_cfg,
                    rcl_params if has_ood or aux_cfg.ood_loss != "RCL" else None, crop_hw,
                    quads)
                total = total + t_i
                losses.update({f"{k}_{i}": v for k, v in l_i.items()})
                assignments.append(a_i)
    return total, losses, assignments


def set_criterion_instance(outputs: Dict[str, object], id_map: torch.Tensor,
                           tgt_classes: torch.Tensor, draws: Dict[str, object],
                           cfg: CriterionConfig
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], List[torch.Tensor]]:
    """The instance criterion: per-segment targets with duplicate classes
    (the reference's ``prepare_targets``), padded to T slots.

    id_map [B, H, W] int: the segment slot of each pixel, -1 = ignore;
    tgt_classes [B, T] int: each slot's class, -1 = padding; draws from
    :func:`criterion_draws` with ``slots=T``. Losses: labels and the plain
    uncertainty-sampled masks, no OOD loss. Under ``cfg.deep_supervision`` the
    match and the losses repeat per auxiliary output with ``_{i}``-suffixed keys.
    Returns (total, components, the assignments [B, T], the final output's
    first).
    """
    with torch.autocast(id_map.device.type, enabled=False):
        quads = label_quads(id_map)  # shared by every output's sampling
        total, losses, assignment = _instance_output_losses(outputs, id_map, tgt_classes,
                                                            draws, cfg, quads)
        assignments = [assignment]
        if cfg.deep_supervision:
            for i, aux in enumerate(outputs.get("aux_outputs", [])):
                t_i, l_i, a_i = _instance_output_losses(aux, id_map, tgt_classes,
                                                        draws["aux"][i], cfg, quads)
                total = total + t_i
                losses.update({f"{k}_{i}": v for k, v in l_i.items()})
                assignments.append(a_i)
    return total, losses, assignments


def _instance_output_losses(outputs, id_map, tgt_classes, draws, cfg, quads=None):
    b, t = tgt_classes.shape
    K = cfg.num_classes
    dev = id_map.device
    pred_logits = outputs["pred_logits"].float()  # [B, Q, K+1]
    pred_masks = outputs["pred_masks"].float()  # [B, Q, Hs, Ws]
    q = pred_logits.shape[1]
    tgt_classes = tgt_classes.long()
    valid = tgt_classes >= 0
    num_masks = global_sum(valid).clamp_min(1).float()

    # slot t's mask is (id_map == t): the semantic path's sampling with the
    # slot indices for classes
    match_coords = draws["match_coords"]
    out_pts = point_sample_nchw(pred_masks.detach(), match_coords)  # [B, Q, P]
    tgt_pts = sample_target_points(id_map, match_coords, t, quads)  # [B, T, P]
    assignment = match(pred_logits.detach(), out_pts, tgt_pts, valid,
                       cost_class_w=cfg.class_weight, cost_mask_w=cfg.mask_weight,
                       cost_dice_w=cfg.dice_weight, tgt_classes=tgt_classes)  # [B, T]

    # loss_labels: each slot's class at its matched query (the assignment is
    # injective over an image's slots), no-object elsewhere and for padding
    slot_classes = torch.where(valid, tgt_classes, torch.full_like(tgt_classes, K))
    target_classes = torch.full((b, q), K, dtype=torch.long, device=dev).scatter(
        1, assignment, slot_classes)
    logp = F.log_softmax(pred_logits, dim=-1)
    nll = -logp.gather(-1, target_classes[..., None])[..., 0]
    class_w = torch.where(target_classes == K, cfg.eos_coef, 1.0)
    loss_ce = global_sum(nll * class_w) / global_sum(class_w)

    matched_masks = pred_masks[torch.arange(b, device=dev)[:, None], assignment]  # [B, T, ...]
    losses = {"loss_ce": loss_ce * cfg.class_weight,
              **_plain_mask_losses(draws, matched_masks, id_map, valid.float(), num_masks,
                                   cfg, quads)}
    return sum(losses.values()), losses, assignment


def _single_output_losses(outputs, sem_seg, draws, cfg, rcl_params=None, crop_hw=None,
                          quads=None):
    b = sem_seg.shape[0]
    half = b // 2
    K = cfg.num_classes
    dev = sem_seg.device
    pred_logits = outputs["pred_logits"].float()  # [B, Q, K+1]
    pred_masks = outputs["pred_masks"].float()  # [B, Q, Hs, Ws]
    q = pred_logits.shape[1]

    lm = sem_seg.reshape(b, -1).long()
    bins = torch.where(lm < K, lm, torch.full_like(lm, K)) + (K + 1) * torch.arange(
        b, device=dev)[:, None]
    valid = torch.bincount(bins.reshape(-1), minlength=b * (K + 1)).view(b, K + 1)[:, :K] > 0
    num_masks = global_sum(valid).clamp_min(1).float()

    # matching on shared random points per image
    match_coords = draws["match_coords"]
    out_pts = point_sample_nchw(pred_masks.detach(), match_coords)  # [B, Q, P]
    tgt_pts = sample_target_points(sem_seg, match_coords, K, quads)  # [B, K, P]
    assignment = match(pred_logits.detach(), out_pts, tgt_pts, valid,
                       cost_class_w=cfg.class_weight, cost_mask_w=cfg.mask_weight,
                       cost_dice_w=cfg.dice_weight)  # [B, K] query per class slot

    # loss_labels: matched queries take their slot's class, the rest no-object;
    # an invalid slot scatters K, which equals the default
    slot_classes = torch.arange(K, device=dev).expand(b, K)
    target_classes = torch.full((b, q), K, dtype=torch.long, device=dev).scatter(
        1, assignment, torch.where(valid, slot_classes, torch.full_like(slot_classes, K)))
    logp = F.log_softmax(pred_logits, dim=-1)
    nll = -logp.gather(-1, target_classes[..., None])[..., 0]
    class_w = torch.where(target_classes == K, cfg.eos_coef, 1.0)
    loss_ce = global_sum(nll * class_w) / global_sum(class_w)

    matched_masks = pred_masks[torch.arange(b, device=dev)[:, None], assignment]  # [B, K, Hs, Ws]
    w_valid = valid.float()

    if not cfg.mask_loss_with_pixel_selection:
        losses = {"loss_ce": loss_ce * cfg.class_weight,
                  **_plain_mask_losses(draws, matched_masks, sem_seg, w_valid, num_masks, cfg,
                                       quads)}
        return (*_finish_ood_loss(outputs, sem_seg, draws, cfg, rcl_params, crop_hw,
                                  pred_logits, pred_masks, losses), assignment)

    # loss_masks_aug, clean half: fresh uniform points per mask, weighted 2x
    hs, ws = matched_masks.shape[2:]
    class_ids = torch.arange(K, device=dev, dtype=torch.int32).repeat(half)
    om = matched_masks[:half].reshape(half * K, hs, ws)
    oc = draws["orig_coords"].reshape(half * K, cfg.num_points, 2)
    orig_logits = point_sample_nchw(om[:, None], oc)[:, 0]
    orig_tgts = sample_class_points(sem_seg, oc, class_ids, rows_per_map=K, quads=quads)
    w_orig = w_valid[:half].reshape(-1)
    loss_orig_mask = 2.0 * all_sum(_sigmoid_ce(orig_logits, orig_tgts, w_orig)) / num_masks
    loss_orig_dice = 2.0 * all_sum(_dice(orig_logits, orig_tgts, w_orig)) / num_masks

    # augmented half: the lowest-BCE "clean" points of each mask
    am = matched_masks[half:].reshape(half * K, hs, ws)
    coords = clean_point_coords(am.detach(), sem_seg, class_ids, draws["clean_coords"],
                                draws["clean_rand"], cfg, rows_per_map=K, map_offset=half,
                                quads=quads)
    aug_logits = point_sample_nchw(am[:, None], coords)[:, 0]
    aug_tgts = sample_class_points(sem_seg, coords, class_ids, rows_per_map=K,
                                   map_offset=half, quads=quads)
    w_aug = w_valid[half:].reshape(-1)
    loss_aug_mask = all_sum(_sigmoid_ce(aug_logits, aug_tgts, w_aug)) / num_masks
    loss_aug_dice = all_sum(_dice(aug_logits, aug_tgts, w_aug)) / num_masks

    losses = {
        "loss_ce": loss_ce * cfg.class_weight,
        "loss_original_mask": loss_orig_mask * cfg.mask_weight,
        "loss_original_dice": loss_orig_dice * cfg.dice_weight,
        "loss_aug_mask": loss_aug_mask * cfg.mask_weight,
        "loss_aug_dice": loss_aug_dice * cfg.dice_weight,
    }
    return (*_finish_ood_loss(outputs, sem_seg, draws, cfg, rcl_params, crop_hw, pred_logits,
                              pred_masks, losses), assignment)


def _finish_ood_loss(outputs, sem_seg, draws, cfg, rcl_params, crop_hw, pred_logits,
                     pred_masks, losses):
    """``loss_ood`` over the per-pixel score maps (``criterion.py:445-495``)."""
    if cfg.ood_loss == "none":
        return sum(losses.values()), losses
    hw = tuple(sem_seg.shape[-2:])
    logits_px = resize_bilinear(mask2former_semantic_logits(pred_logits, pred_masks), hw)

    if cfg.ood_loss == "RCL":
        if rcl_params is None:
            raise ValueError("ood_loss 'RCL' needs rcl_params")
        ch, cw_ = crop_hw or hw
        bal = mask2former_semantic_logits(outputs["pred_logits_ood"].float(),
                                          outputs["pred_masks_ood"].float())
        bal = resize_bilinear(bal, hw)[:, :ch, :cw_]
        score = -bal.max(dim=-1).values
        loss_ood, _ = rel_contrastive_loss(logits_px[:, :ch, :cw_], score,
                                           sem_seg[:, :ch, :cw_], draws["rcl_noise"],
                                           rcl_params)
    elif cfg.ood_loss in ("margin", "bce"):
        score = -logits_px.max(dim=-1).values
        ood_f = ((sem_seg > 100) & (sem_seg != 255)).float()
        id_f = (sem_seg < 100).float()
        n_ood = global_sum(ood_f)
        n_id = global_sum(id_f).clamp_min(1)
        if cfg.ood_loss == "margin":
            id_term = global_sum(score ** 2 * id_f) / n_id
            ood_term = (global_sum((cfg.margin - score).clamp_min(0) ** 2 * ood_f)
                        / n_ood.clamp_min(1))
            loss_ood = 0.5 * (id_term + torch.where(n_ood > 0, ood_term, ood_term.new_zeros(())))
        else:
            bce_id = global_sum(F.softplus(score) * id_f) / n_id
            bce_ood = global_sum(F.softplus(-score) * ood_f) / n_ood.clamp_min(1)
            loss_ood = 0.5 * (bce_id + torch.where(n_ood > 0, bce_ood, bce_ood.new_zeros(())))
    else:
        raise ValueError(f"unknown ood_loss {cfg.ood_loss}")

    losses["loss_ood"] = loss_ood * cfg.ood_weight
    return sum(losses.values()), losses
