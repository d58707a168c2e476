"""Closed-set segmentation metrics: confusion matrix, mIoU, pixel accuracy.

Counterpart of ``multishiftseg_tpu/evals/seg_metrics.py`` (the reference's
``lib/utils/metric.py:10-64``): the numpy API, and :func:`confusion_matrix`,
which accumulates the histogram on the tensors' device.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def hist_info(n_cl: int, pred: np.ndarray, gt: np.ndarray) -> Tuple[np.ndarray, int, int]:
    """Confusion matrix + (labeled, correct) pixel counts. Ignores gt outside [0, n_cl)."""
    assert pred.shape == gt.shape
    k = (gt >= 0) & (gt < n_cl)
    labeled = int(np.sum(k))
    correct = int(np.sum(pred[k] == gt[k]))
    hist = np.bincount(n_cl * gt[k].astype(int) + pred[k].astype(int),
                       minlength=n_cl ** 2).reshape(n_cl, n_cl)
    return hist, labeled, correct


def compute_score(hist: np.ndarray, correct: int, labeled: int):
    iu = np.diag(hist) / (hist.sum(1) + hist.sum(0) - np.diag(hist))
    return iu, np.nanmean(iu), correct / max(labeled, 1)


def compute_metric(results: List[Dict], n_cl: int = 19, per_class: bool = False):
    """Aggregate ``{'hist', 'labeled', 'correct'}`` dicts into (mIoU, pixel acc)."""
    hist = np.zeros((n_cl, n_cl))
    correct = labeled = 0
    for d in results:
        hist += d["hist"]
        correct += d["correct"]
        labeled += d["labeled"]
    iu, mean_iu, mean_pixel_acc = compute_score(hist, correct, labeled)
    if per_class:
        class_acc = np.diag(hist) / np.maximum(hist.sum(axis=1), 1)
        return mean_iu, mean_pixel_acc, iu, class_acc
    return mean_iu, mean_pixel_acc


def confusion_matrix(pred: torch.Tensor, gt: torch.Tensor, n_cl: int = 19) -> torch.Tensor:
    """[n_cl, n_cl] int64 counts (rows gt, columns pred) on the inputs' device
    (JAX ``confusion_matrix``, :52). pred / gt: integer tensors of one shape;
    a gt outside [0, n_cl) is ignored and a pred outside it is clamped."""
    pred, gt = pred.reshape(-1).long(), gt.reshape(-1).long()
    valid = (gt >= 0) & (gt < n_cl)
    idx = torch.where(valid, gt * n_cl + pred.clamp(0, n_cl - 1), n_cl * n_cl)
    return torch.bincount(idx, minlength=n_cl * n_cl + 1)[:-1].reshape(n_cl, n_cl)
