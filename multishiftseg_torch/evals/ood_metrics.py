"""Pixel-level OOD detection metrics: AUROC, AUPRC (average precision), FPR@95TPR.

Exact numpy implementations, a copy of ``multishiftseg_tpu/evals/ood_metrics.py:26-151``
(sklearn semantics of the reference's ``lib/utils/metric.py:69-181``) without the
native C++ route; and the binned metrics of ``:159-316`` (``BinnedOODMeter``,
``binned_ood_metrics``), whose per-map reductions, the masked score range and the
label-split histogram, run as CUDA kernels for CUDA tensors
(``csrc/ood_hist.cu``) and as their plain versions for CPU tensors. Label 1 =
OOD (positive), label 0 = in-distribution; higher score = more anomalous.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import _build

# Kernel launches (see ``ops.launch_counts``).
LAUNCHES = {"ood_hist_minmax": 0, "ood_hist": 0}

# numpy<2 names the trapezoidal rule `trapz`
_np_trapezoid = getattr(np, "trapezoid", getattr(np, "trapz", None))


def _threshold_counts(y_true: np.ndarray, y_score: np.ndarray):
    """Cumulative tp/fp at each distinct descending score threshold."""
    order = np.argsort(-y_score, kind="mergesort")
    y = y_true[order].astype(np.float64)
    s = y_score[order]
    distinct = np.where(np.diff(s))[0]
    idxs = np.r_[distinct, len(s) - 1]
    tps = np.cumsum(y)[idxs]
    fps = 1 + idxs - tps
    return tps, fps, s[idxs]


def auroc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Area under the ROC curve (trapezoid over distinct thresholds)."""
    tps, fps, _ = _threshold_counts(y_true, y_score)
    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    if tps[-1] == 0 or fps[-1] == 0:
        return float("nan")
    return float(_np_trapezoid(tps / tps[-1], fps / fps[-1]))


def average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """AP = sum_n (R_n - R_{n-1}) P_n over descending thresholds."""
    tps, fps, _ = _threshold_counts(y_true, y_score)
    if tps[-1] == 0:
        return float("nan")
    precision = tps / (tps + fps)
    recall = tps / tps[-1]
    recall_prev = np.r_[0.0, recall[:-1]]
    return float(np.sum((recall - recall_prev) * precision))


def fpr_at_recall(y_true: np.ndarray, y_score: np.ndarray,
                  recall_level: float = 0.95) -> float:
    """FPR at the threshold whose TPR is closest to ``recall_level`` (the
    reference's ``fpr_and_fdr_at_recall`` cutoff selection)."""
    tps, fps, _ = _threshold_counts(y_true, y_score)
    if tps[-1] == 0:
        return float("nan")
    recall = tps / tps[-1]
    last_ind = int(np.searchsorted(tps, tps[-1]))
    sl = slice(last_ind, None, -1)
    recall_r = np.r_[recall[sl], 1.0]
    fps_r = np.r_[fps[sl], 0.0]
    cutoff = int(np.argmin(np.abs(recall_r - recall_level)))
    n_neg = float(np.sum(y_true == 0))
    return float(fps_r[cutoff] / n_neg)


def eval_ood_measure(conf: np.ndarray, seg_label: np.ndarray, train_id_in: int = 0,
                     train_id_out: int = 1, recall_level: float = 0.95
                     ) -> Optional[Tuple[float, float, float]]:
    """(AUROC, AUPRC, FPR@95) over pixels labelled in/out; None if either set is
    empty. Pixels with other labels (e.g. 255 void) are excluded."""
    conf = np.asarray(conf).reshape(-1)
    seg_label = np.asarray(seg_label).reshape(-1)
    mask = (seg_label == train_id_in) | (seg_label == train_id_out)
    if not mask.any():
        return None
    labels = (seg_label[mask] == train_id_out).astype(np.int64)
    if labels.sum() == 0 or labels.sum() == labels.size:
        return None
    scores = conf[mask].astype(np.float64)
    return (
        auroc(labels, scores),
        average_precision(labels, scores),
        fpr_at_recall(labels, scores, recall_level),
    )


# ---------------------------------------------------------------------------
# Binned metrics (approximate; error ~ O(1/num_bins) of the score range).


def metrics_from_histograms(pos_hist: torch.Tensor, neg_hist: torch.Tensor,
                            recall_level: float = 0.95
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(AUROC, AUPRC, FPR@recall) as f32 tensors from count histograms
    (``pos_hist[i]`` / ``neg_hist[i]`` count OOD / in-distribution pixels in
    bin i, bin 0 the lowest score). int32 cumsums, as the JAX version."""
    tps = torch.cumsum(pos_hist.flip(0).to(torch.int32), 0, dtype=torch.int32).float()
    fps = torch.cumsum(neg_hist.flip(0).to(torch.int32), 0, dtype=torch.int32).float()
    p_total = tps[-1].clamp_min(1.0)
    n_total = fps[-1].clamp_min(1.0)
    zero = tps.new_zeros(1)
    tpr = torch.cat([zero, tps]) / p_total
    fpr = torch.cat([zero, fps]) / n_total
    auroc_v = torch.trapezoid(tpr, fpr)
    precision = tps / (tps + fps).clamp_min(1.0)
    recall = tps / p_total
    recall_prev = torch.cat([zero, recall[:-1]])
    ap = torch.sum((recall - recall_prev) * precision)
    reach = recall >= recall_level
    idx = torch.argmax(reach.to(torch.int32))  # first True (0 if none; guarded below)
    fpr95 = torch.where(reach.any(), fps[idx] / n_total, torch.ones_like(n_total))
    return auroc_v, ap, fpr95


def masked_min_max(scores: torch.Tensor, labels: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi), f32 0-d tensors: the range of the scores whose label is 0 or 1
    (+inf, -inf when there is none; NaN, both, when one of them is NaN, as
    JAX's ``min`` / ``max`` give). The CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    scores, labels = _flat(scores, labels)
    if scores.device.type == "cpu":
        return masked_min_max_plain(scores, labels)
    return _min_max_cuda(scores, labels)


def masked_min_max_plain(scores, labels):
    scores, labels = _flat(scores, labels)
    valid = (labels == 0) | (labels == 1)
    inf = torch.full_like(scores, float("inf"))
    return torch.where(valid, scores, inf).min(), torch.where(valid, scores, -inf).max()


def label_histograms(scores: torch.Tensor, labels: torch.Tensor, lo: torch.Tensor,
                     hi: torch.Tensor, num_bins: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pos, neg), int32 [num_bins]: the counts of one map's OOD / in-distribution
    pixels, binned over [lo, hi]: ``bin = clamp(int((s - lo) / max(hi - lo,
    1e-12) * num_bins), 0, num_bins - 1)`` in f32 (JAX's ``_hist_update`` from
    zero histograms). The CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    scores, labels = _flat(scores, labels)
    if scores.device.type == "cpu":
        return label_histograms_plain(scores, labels, lo, hi, num_bins)
    return _hist_cuda(scores, labels, lo, hi, num_bins)


def label_histograms_plain(scores, labels, lo, hi, num_bins):
    scores, labels = _flat(scores, labels)
    lo = torch.as_tensor(lo, dtype=torch.float32, device=scores.device)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=scores.device)
    x = (scores - lo) / torch.clamp(hi - lo, min=1e-12) * num_bins
    # clamped in float first: the same bin as clamping the int, for every
    # non-NaN value, without converting an out-of-range float
    bins = x.clamp(0, num_bins).to(torch.int32).clamp(max=num_bins - 1).long()
    pos = torch.bincount(bins[labels == 1], minlength=num_bins).to(torch.int32)
    neg = torch.bincount(bins[labels == 0], minlength=num_bins).to(torch.int32)
    return pos, neg


def _flat(scores, labels):
    return (scores.reshape(-1).float(),
            torch.as_tensor(labels).to(scores.device).reshape(-1).to(torch.int32))


def _min_max_cuda(scores, labels):
    scores, labels = scores.contiguous(), labels.contiguous()
    lohi = torch.empty(2, dtype=torch.float32, device=scores.device)
    fn = _build.function("ood_hist", "ood_masked_min_max",
                         [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                          ctypes.c_void_p, ctypes.c_void_p])
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        rc = fn(scores.data_ptr(), labels.data_ptr(), scores.numel(), lohi.data_ptr(),
                stream)
    if rc != 0:
        raise RuntimeError(f"ood_masked_min_max failed: cudaError {rc}")
    LAUNCHES["ood_hist_minmax"] += 1
    return lohi[0], lohi[1]


def _hist_cuda(scores, labels, lo, hi, num_bins):
    scores, labels = scores.contiguous(), labels.contiguous()
    dev = scores.device
    if 2 * num_bins * 4 > 232448:
        raise ValueError(f"the kernel takes at most 29056 bins, got {num_bins}")
    lohi = torch.stack([torch.as_tensor(lo, dtype=torch.float32, device=dev).reshape(()),
                        torch.as_tensor(hi, dtype=torch.float32, device=dev).reshape(())])
    hists = torch.zeros((2, num_bins), dtype=torch.int32, device=dev)
    fn = _build.function("ood_hist", "ood_hist",
                         [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(scores.data_ptr(), labels.data_ptr(), scores.numel(), lohi.data_ptr(),
                num_bins, hists[0].data_ptr(), hists[1].data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"ood_hist failed: cudaError {rc}")
    LAUNCHES["ood_hist"] += 1
    return hists[0], hists[1]


class BinnedOODMeter:
    """Streaming (AUROC, AUPRC, FPR@95) over many variable-size score maps with
    bounded memory (``ood_metrics.py:200-266``): ``update`` reduces each map on
    its device to an int32 histogram over the map's own score range (one host
    sync for the range, then 2 x num_bins counts copied to the host); ``compute``
    merges the maps' histograms into the global range on the host, each source
    bin's count landing at its bin centre's target bin, and finishes in float64.
    Accuracy is O(score range / num_bins)."""

    def __init__(self, num_bins: int = 8192, recall_level: float = 0.95):
        self.num_bins = num_bins
        self.recall_level = recall_level
        self._hists: List[Tuple[np.ndarray, np.ndarray, float, float]] = []

    def update(self, scores: torch.Tensor, labels) -> None:
        """scores: [...] tensor; labels: [...] int (1 = OOD, 0 = in, other = void)."""
        scores = torch.as_tensor(scores).reshape(-1)
        labels = torch.as_tensor(np.asarray(labels).reshape(-1)).to(scores.device, torch.int32)
        lo, hi = masked_min_max(scores, labels)
        lo_f, hi_f = float(lo), float(hi)
        if not (np.isfinite(lo_f) and np.isfinite(hi_f)):
            return  # no valid pixel in this map, or a NaN score
        pos, neg = label_histograms(scores, labels, lo, hi, self.num_bins)
        self._hists.append((pos.cpu().numpy().astype(np.int64),
                            neg.cpu().numpy().astype(np.int64), lo_f, hi_f))

    def compute(self) -> Optional[Tuple[float, float, float]]:
        if not self._hists:
            return None
        lo = min(h[2] for h in self._hists)
        hi = max(h[3] for h in self._hists)
        span = max(hi - lo, 1e-12)
        b = self.num_bins
        pos_hist = np.zeros(b, np.int64)
        neg_hist = np.zeros(b, np.int64)
        for pos, neg, lo_i, hi_i in self._hists:
            centers = lo_i + (np.arange(b) + 0.5) * max(hi_i - lo_i, 1e-12) / b
            tgt = np.clip(((centers - lo) / span * b).astype(np.int64), 0, b - 1)
            np.add.at(pos_hist, tgt, pos)
            np.add.at(neg_hist, tgt, neg)
        if pos_hist.sum() == 0 or neg_hist.sum() == 0:
            return None
        self._hists.clear()
        return _finish_histograms_np(pos_hist, neg_hist, self.recall_level)


def _finish_histograms_np(pos_hist: np.ndarray, neg_hist: np.ndarray,
                          recall_level: float = 0.95) -> Tuple[float, float, float]:
    """float64 host finish of :func:`metrics_from_histograms`."""
    tps = np.cumsum(pos_hist[::-1]).astype(np.float64)
    fps = np.cumsum(neg_hist[::-1]).astype(np.float64)
    p_total = max(tps[-1], 1.0)
    n_total = max(fps[-1], 1.0)
    tpr = np.concatenate([[0.0], tps]) / p_total
    fpr = np.concatenate([[0.0], fps]) / n_total
    auroc_v = _np_trapezoid(tpr, fpr)
    precision = tps / np.maximum(tps + fps, 1.0)
    recall = tps / p_total
    recall_prev = np.concatenate([[0.0], recall[:-1]])
    ap = np.sum((recall - recall_prev) * precision)
    reach = recall >= recall_level
    fpr95 = float(fps[np.argmax(reach)] / n_total) if reach.any() else 1.0
    return float(auroc_v), float(ap), float(fpr95)


def binned_ood_metrics(scores: torch.Tensor, labels: torch.Tensor, num_bins: int = 8192,
                       lo: Optional[float] = None, hi: Optional[float] = None,
                       recall_level: float = 0.95
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Histogram-binned (AUROC, AUPRC, FPR@recall) of one set of maps, on their
    device: the range (unless given) and the histogram through the same
    kernels as :class:`BinnedOODMeter`, no host sync."""
    scores, labels = _flat(torch.as_tensor(scores), labels)
    if lo is None or hi is None:
        lo_v, hi_v = masked_min_max(scores, labels)
    if lo is not None:
        lo_v = torch.tensor(lo, dtype=torch.float32)
    if hi is not None:
        hi_v = torch.tensor(hi, dtype=torch.float32)
    pos, neg = label_histograms(scores, labels, lo_v, hi_v, num_bins)
    return metrics_from_histograms(pos, neg, recall_level)
