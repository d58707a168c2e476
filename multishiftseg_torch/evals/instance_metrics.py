"""COCO-style instance segmentation AP (the reference's ``InstanceSegEvaluator``,
``evaluation/instance_evaluation.py:30-107``, without pycocotools).

A copy of ``multishiftseg_tpu/evals/instance_metrics.py`` (numpy only), with
the COCO evaluation protocol:
* per (class, IoU threshold): predictions sorted by descending score across images
  (top ``max_dets`` per image), greedily matched to the highest-IoU unmatched GT of
  the same class in the same image with IoU >= threshold;
* AP = mean 101-point interpolated precision over recall in {0, 0.01, .., 1};
* AP averaged over classes that have ground truth, and over IoU thresholds
  0.50:0.05:0.95 (AP50 / AP75 are the single-threshold values).

Inputs are per-image dicts with dense binary masks (the output of
``models.inference_extras.instance_inference``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

IOU_THRESHOLDS = np.linspace(0.5, 0.95, 10)  # exact values (arange drifts: 0.6000..01)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)


def mask_iou_matrix(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """[Np, H, W] x [Ng, H, W] binary masks -> [Np, Ng] IoU.

    float32 operands: pixel counts stay < 2^24 for any mask up to 16.7M pixels,
    so the matmul is exact while using half the memory of float64 (at 2048x1024
    with 100 detections the f64 operand alone was 1.7 GB)."""
    p = pred.reshape(pred.shape[0], -1).astype(np.float32)
    g = gt.reshape(gt.shape[0], -1).astype(np.float32)
    inter = p @ g.T
    union = p.sum(1)[:, None] + g.sum(1)[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1), 0.0).astype(np.float64)


def _ap_from_matches(matched: np.ndarray, n_gt: int) -> float:
    """101-point interpolated AP from a score-ordered boolean TP vector."""
    if n_gt == 0:
        return float("nan")
    if matched.size == 0:
        return 0.0
    tp = np.cumsum(matched)
    fp = np.cumsum(~matched)
    recall = tp / n_gt
    precision = tp / np.maximum(tp + fp, 1)
    # precision envelope (monotone non-increasing from the right)
    for i in range(precision.size - 1, 0, -1):
        precision[i - 1] = max(precision[i - 1], precision[i])
    idx = np.searchsorted(recall, RECALL_POINTS, side="left")
    return float(
        np.mean([precision[j] if j < precision.size else 0.0 for j in idx])
    )


def instance_ap(
    predictions: Sequence[Dict],
    ground_truths: Sequence[Dict],
    num_classes: int,
    iou_thresholds: np.ndarray = IOU_THRESHOLDS,
    max_dets: int = 100,
) -> Dict[str, float]:
    """COCO mask AP over a dataset.

    predictions[i]: {"masks" [N,H,W] bool, "scores" [N], "classes" [N]}
    ground_truths[i]: {"masks" [M,H,W] bool, "classes" [M]}
    Returns {"AP", "AP50", "AP75", "AP_per_class" (list, NaN when no GT)}.
    """
    assert len(predictions) == len(ground_truths)
    per_image = [reduce_image(p, g, max_dets)
                 for p, g in zip(predictions, ground_truths)]
    return instance_ap_reduced(per_image, num_classes, iou_thresholds)


def reduce_image(pred: Dict, gt: Dict, max_dets: int = 100) -> Tuple:
    """Per-image reduction to ``(scores, pred_classes, gt_classes, iou)`` —
    everything AP needs; the dense masks can be dropped immediately after
    (the streaming evaluator's memory bound)."""
    scores = np.asarray(pred.get("scores", np.zeros(0)))
    order = np.argsort(-scores, kind="mergesort")[:max_dets]
    pm = np.asarray(pred["masks"])[order] if scores.size else np.zeros((0, 1, 1))
    pc = np.asarray(pred["classes"])[order] if scores.size else np.zeros(0, int)
    gm = np.asarray(gt["masks"])
    gc = np.asarray(gt["classes"])
    iou = mask_iou_matrix(pm, gm) if pm.shape[0] and gm.shape[0] else np.zeros(
        (pm.shape[0], gm.shape[0])
    )
    return (scores[order] if scores.size else scores, pc, gc, iou)


def instance_ap_reduced(
    per_image: Sequence[Tuple],
    num_classes: int,
    iou_thresholds: np.ndarray = IOU_THRESHOLDS,
) -> Dict[str, float]:
    """COCO mask AP from per-image :func:`reduce_image` tuples."""
    ap_ct = np.full((len(iou_thresholds), num_classes), np.nan)
    for c in range(num_classes):
        n_gt = sum(int((gc == c).sum()) for _, _, gc, _ in per_image)
        if n_gt == 0:
            continue
        # flatten class-c predictions across images, keep image id for matching
        entries = []  # (score, img, local pred row)
        for img, (scores, pc, gc, iou) in enumerate(per_image):
            for j in np.where(pc == c)[0]:
                entries.append((float(scores[j]), img, int(j)))
        entries.sort(key=lambda e: -e[0])
        for ti, t in enumerate(iou_thresholds):
            used = [np.zeros(int((gc == c).sum()), bool)
                    for _, _, gc, _ in per_image]
            gt_rows = [np.where(gc == c)[0] for _, _, gc, _ in per_image]
            matched = np.zeros(len(entries), bool)
            for k, (_, img, j) in enumerate(entries):
                iou = per_image[img][3]
                best, best_g = t, -1
                for gi, grow in enumerate(gt_rows[img]):
                    if used[img][gi]:
                        continue
                    if iou[j, grow] >= best:
                        best, best_g = iou[j, grow], gi
                if best_g >= 0:
                    used[img][best_g] = True
                    matched[k] = True
            ap_ct[ti, c] = _ap_from_matches(matched, n_gt)

    with np.errstate(invalid="ignore"):
        ap_t = np.nanmean(ap_ct, axis=1)  # mean over classes with GT
    i50 = int(np.argmin(np.abs(iou_thresholds - 0.5)))
    i75 = int(np.argmin(np.abs(iou_thresholds - 0.75)))
    return {
        "AP": float(np.nanmean(ap_t)),
        "AP50": float(ap_t[i50]),
        "AP75": float(ap_t[i75]),
        "AP_per_class": np.nanmean(ap_ct, axis=0).tolist(),
    }


class InstanceSegEvaluator:
    """Accumulating wrapper mirroring the reference evaluator's process/evaluate
    interface (``instance_evaluation.py:30``): feed per-image predictions + ground
    truth, then ``evaluate()`` returns the COCO AP dict."""

    def __init__(self, num_classes: int, max_dets: int = 100):
        self.num_classes = num_classes
        self.max_dets = max_dets
        self.reset()

    def reset(self):
        self._per_image: List[Tuple] = []

    def process(self, prediction: Dict, ground_truth: Dict):
        # reduce to (scores, classes, gt_classes, iou) NOW so the dense masks
        # (several MB per image at benchmark resolution) are never retained
        self._per_image.append(
            reduce_image(prediction, ground_truth, self.max_dets))

    def evaluate(self) -> Optional[Dict[str, float]]:
        if not self._per_image:
            return None
        return instance_ap_reduced(self._per_image, self.num_classes)
