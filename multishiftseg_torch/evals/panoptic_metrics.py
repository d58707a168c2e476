"""Panoptic Quality (PQ / SQ / RQ), the COCO-panoptic protocol.

A copy of ``multishiftseg_tpu/evals/panoptic_metrics.py`` (numpy only), which
implements the PQ protocol of Kirillov et al. (CVPR 2019) as panopticapi's
``pq_compute`` does:

* intersections between every (gt segment, pred segment) pair come from one
  histogram over the combined id map (``gt_id * OFFSET + pred_id``);
* a gt/pred pair of the same category is a TP iff IoU > 0.5, where the union
  excludes the prediction's overlap with VOID
  (``union = pred_area + gt_area - inter - inter(VOID, pred)``);
* unmatched gt segments count FN unless ``iscrowd``; unmatched pred segments
  count FP unless more than half their area is VOID or same-category crowd gt;
* per class: PQ = sum IoU / (TP + FP/2 + FN/2), SQ = sum IoU / TP,
  RQ = TP / (TP + FP/2 + FN/2); dataset PQ averages classes with any of
  TP+FP+FN > 0 (things/stuff splits likewise).

Where panopticapi assumes at most one crowd segment per (category, image), the
FP test here sums the prediction's overlap over all same-category crowd
segments, which is identical on conforming data.

Inputs are id maps + segments_info as ``models.inference_extras.
panoptic_inference`` gives them (id 0 = VOID); :func:`targets_to_panoptic`
adapts ``data.mappers.SegmentTargets`` ground truth (slot k -> id k+1,
ignore -> VOID).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

VOID = 0
_OFFSET = np.int64(1) << 32


def _areas(seg: np.ndarray) -> Dict[int, int]:
    ids, counts = np.unique(seg, return_counts=True)
    return {int(i): int(c) for i, c in zip(ids, counts)}


def _intersections(gt_seg: np.ndarray, pred_seg: np.ndarray) -> Dict[Tuple[int, int], int]:
    combined = gt_seg.astype(np.int64) * _OFFSET + pred_seg.astype(np.int64)
    ids, counts = np.unique(combined, return_counts=True)
    return {(int(i // _OFFSET), int(i % _OFFSET)): int(c)
            for i, c in zip(ids, counts)}


class PQStat:
    """Per-class accumulators (iou sum, TP, FP, FN) with += merging."""

    def __init__(self, num_classes: int):
        self.iou = np.zeros(num_classes, np.float64)
        self.tp = np.zeros(num_classes, np.int64)
        self.fp = np.zeros(num_classes, np.int64)
        self.fn = np.zeros(num_classes, np.int64)

    def __iadd__(self, other: "PQStat") -> "PQStat":
        self.iou += other.iou
        self.tp += other.tp
        self.fp += other.fp
        self.fn += other.fn
        return self


def panoptic_quality_stats(
    pred_seg: np.ndarray,
    pred_info: Sequence[Dict],
    gt_seg: np.ndarray,
    gt_info: Sequence[Dict],
    num_classes: int,
) -> PQStat:
    """One image's PQ accumulators.

    pred_seg / gt_seg: [H, W] integer id maps, 0 = VOID.
    pred_info / gt_info: [{"id", "category_id", "iscrowd"?}, ...] — ids must be
    the non-zero values of the corresponding map.
    """
    assert pred_seg.shape == gt_seg.shape, (pred_seg.shape, gt_seg.shape)
    stat = PQStat(num_classes)
    gt_by_id = {int(s["id"]): s for s in gt_info}
    pred_by_id = {int(s["id"]): s for s in pred_info}
    gt_area = _areas(gt_seg)
    pred_area = _areas(pred_seg)
    inter = _intersections(gt_seg, pred_seg)

    # sanity: every labelled segment must appear in its info list (a dropped
    # info entry would silently skew FP/FN)
    for i in gt_area:
        assert i == VOID or i in gt_by_id, f"gt id {i} missing from gt_info"
    for i in pred_area:
        assert i == VOID or i in pred_by_id, f"pred id {i} missing from pred_info"

    matched_gt: Set[int] = set()
    matched_pred: Set[int] = set()
    for (gi, pi), n in inter.items():
        if gi == VOID or pi == VOID:
            continue
        g, p = gt_by_id[gi], pred_by_id[pi]
        if g.get("iscrowd", 0):
            continue
        if int(g["category_id"]) != int(p["category_id"]):
            continue
        union = (pred_area[pi] + gt_area[gi] - n
                 - inter.get((VOID, pi), 0))
        iou = n / union
        if iou > 0.5:
            c = int(g["category_id"])
            stat.tp[c] += 1
            stat.iou[c] += iou
            matched_gt.add(gi)
            matched_pred.add(pi)

    crowd_by_class: Dict[int, List[int]] = {}
    for s in gt_info:
        if s.get("iscrowd", 0):
            crowd_by_class.setdefault(int(s["category_id"]), []).append(int(s["id"]))

    for gi, g in gt_by_id.items():
        if gi in matched_gt or g.get("iscrowd", 0):
            continue
        if gt_area.get(gi, 0) == 0:
            continue  # segment cropped away entirely
        stat.fn[int(g["category_id"])] += 1

    for pi, p in pred_by_id.items():
        if pi in matched_pred:
            continue
        area = pred_area.get(pi, 0)
        if area == 0:
            continue
        c = int(p["category_id"])
        ignored = inter.get((VOID, pi), 0)
        for crowd_id in crowd_by_class.get(c, ()):
            ignored += inter.get((crowd_id, pi), 0)
        if ignored / area > 0.5:
            continue
        stat.fp[c] += 1
    return stat


def pq_averages(
    stat: PQStat,
    thing_ids: Optional[Set[int]] = None,
) -> Dict[str, float]:
    """Dataset-level PQ/SQ/RQ (+ things/stuff splits when ``thing_ids`` given),
    averaging over classes with TP + FP + FN > 0."""
    denom = stat.tp + stat.fp / 2.0 + stat.fn / 2.0
    present = denom > 0
    with np.errstate(invalid="ignore", divide="ignore"):
        pq_c = np.where(present, stat.iou / np.maximum(denom, 1e-12), np.nan)
        sq_c = np.where(stat.tp > 0, stat.iou / np.maximum(stat.tp, 1), 0.0)
        sq_c = np.where(present, sq_c, np.nan)
        rq_c = np.where(present, stat.tp / np.maximum(denom, 1e-12), np.nan)

    def avg(values: np.ndarray, sel: np.ndarray) -> float:
        return float(np.mean(values[sel])) if sel.any() else float("nan")

    out = {
        "PQ": avg(pq_c, present),
        "SQ": avg(sq_c, present),
        "RQ": avg(rq_c, present),
        "n_classes": int(present.sum()),
        "PQ_per_class": pq_c.tolist(),
    }
    if thing_ids is not None:
        is_thing = np.zeros(pq_c.size, bool)
        for t in thing_ids:
            if 0 <= t < pq_c.size:
                is_thing[t] = True
        out["PQ_th"] = avg(pq_c, present & is_thing)
        out["RQ_th"] = avg(rq_c, present & is_thing)
        out["SQ_th"] = avg(sq_c, present & is_thing)
        out["PQ_st"] = avg(pq_c, present & ~is_thing)
        out["RQ_st"] = avg(rq_c, present & ~is_thing)
        out["SQ_st"] = avg(sq_c, present & ~is_thing)
    return out


def targets_to_panoptic(
    id_map: np.ndarray, classes: np.ndarray
) -> Tuple[np.ndarray, List[Dict]]:
    """``SegmentTargets``-style gt (slot id map, -1 = ignore; padded classes may
    hold -1) -> (gt_seg with 0 = VOID, gt_info). Crowd segments were already
    dropped to ignore by the mappers — their pixels land in VOID, which removes
    crowd-covered predictions from FP exactly like the crowd rule (see module
    docstring)."""
    k = int((np.asarray(classes) >= 0).sum())
    gt_seg = np.where(id_map >= 0, id_map + 1, VOID).astype(np.int64)
    gt_info = [{"id": s + 1, "category_id": int(classes[s]), "iscrowd": 0}
               for s in range(k)]
    return gt_seg, gt_info


class PanopticEvaluator:
    """Accumulating process/evaluate wrapper (the ``COCOPanopticEvaluator`` role,
    same interface shape as :class:`evals.instance_metrics.InstanceSegEvaluator`)."""

    def __init__(self, num_classes: int, thing_ids: Optional[Set[int]] = None):
        self.num_classes = num_classes
        self.thing_ids = thing_ids
        self.reset()

    def reset(self):
        self._stat = PQStat(self.num_classes)
        self._images = 0

    def process(self, pred_seg, pred_info, gt_seg, gt_info):
        self._stat += panoptic_quality_stats(
            np.asarray(pred_seg), pred_info, np.asarray(gt_seg), gt_info,
            self.num_classes)
        self._images += 1

    def evaluate(self) -> Optional[Dict[str, float]]:
        if self._images == 0:
            return None
        return pq_averages(self._stat, self.thing_ids)
