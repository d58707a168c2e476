"""Pixel-level OOD detection metrics: AUROC, AUPRC (average precision), FPR@95TPR.

Exact implementations, a copy of ``multishiftseg_tpu/evals/ood_metrics.py:26-151``
(sklearn semantics of the reference's ``lib/utils/metric.py:69-181``): numpy, and
for inputs of 2,000,000 labelled pixels or more the native route, the
repository's threaded C++ sort and sweep (``native/metrics.cc``,
``mss_ood_metrics``), built with ``g++`` into ``multishiftseg_torch/build/`` at
first use and bound with ctypes (``use_native`` as in JAX; a library that
cannot be built raises, nothing falls back quietly); and the binned metrics of
``:159-316`` (``BinnedOODMeter``, ``binned_ood_metrics``), whose per-map
reductions, the masked score range and the label-split histogram, run as one
CUDA kernel for CUDA tensors (``csrc/ood_hist.cu``: the range, the histogram
over a given range, or both in one launch) and as their plain versions for
CPU tensors. Label 1 =
OOD (positive), label 0 = in-distribution; higher score = more anomalous.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import _build
from ..losses.matcher import launch_device

# Kernel launches (see ``ops.launch_counts``), by entry: the range, the
# histogram over a given range, both in one launch.
LAUNCHES = {"ood_hist_minmax": 0, "ood_hist": 0, "ood_range_hist": 0}

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


NATIVE_MIN_PIXELS = 2_000_000  # below this, numpy's sort wins on dispatch overhead
NATIVE_SOURCE = Path(__file__).resolve().parents[2] / "native" / "metrics.cc"
NATIVE_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
_native_lock = threading.Lock()
_native: Dict[str, ctypes.CDLL] = {}


def native_library() -> ctypes.CDLL:
    """``native/metrics.cc`` built with ``g++`` into ``build/`` (named by a hash
    of the source and flags, so an edited source is rebuilt) and loaded.
    Raises where it cannot be built."""
    with _native_lock:
        lib = _native.get("metrics")
        if lib is None:
            digest = hashlib.sha256(NATIVE_SOURCE.read_bytes() + " ".join(NATIVE_FLAGS).encode())
            path = _build.BUILD_DIR / f"libmssmetrics-{digest.hexdigest()[:12]}.so"
            if not path.exists():
                _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                out = subprocess.run(["g++", *NATIVE_FLAGS, "-o", str(tmp), str(NATIVE_SOURCE),
                                      "-lpthread"], capture_output=True, text=True)
                if out.returncode != 0:
                    raise RuntimeError(f"g++ failed on {NATIVE_SOURCE}:\n{out.stdout}{out.stderr}")
                os.replace(tmp, path)
            lib = ctypes.CDLL(str(path))
            lib.mss_ood_metrics.restype = ctypes.c_int
            lib.mss_ood_metrics.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                            ctypes.c_double, ctypes.c_int, ctypes.c_void_p]
            _native["metrics"] = lib
        return lib


def native_ood_metrics(scores: np.ndarray, labels: np.ndarray,
                       recall_level: float = 0.95) -> Tuple[float, float, float]:
    """(AUROC, AUPRC, FPR@recall) by the native route: scores taken as f32,
    labels 1 OOD / 0 in-distribution, one thread a core."""
    s = np.ascontiguousarray(scores, np.float32)
    lab = np.ascontiguousarray(labels, np.uint8)
    out = np.zeros(3, np.float64)
    rc = native_library().mss_ood_metrics(s.ctypes.data, lab.ctypes.data, s.size,
                                          recall_level, os.cpu_count() or 1, out.ctypes.data)
    if rc != 0:
        raise ValueError("mss_ood_metrics: a class is empty")
    return float(out[0]), float(out[1]), float(out[2])


def metrics_route(n_pixels: int, use_native: Optional[bool] = None) -> str:
    """``"native"`` or ``"numpy"``: the route ``eval_ood_measure`` takes for
    ``n_pixels`` labelled pixels (``use_native`` None: native from
    ``NATIVE_MIN_PIXELS`` on)."""
    if use_native or (use_native is None and n_pixels >= NATIVE_MIN_PIXELS):
        return "native"
    return "numpy"


def eval_ood_measure(conf: np.ndarray, seg_label: np.ndarray, train_id_in: int = 0,
                     train_id_out: int = 1, recall_level: float = 0.95,
                     use_native: Optional[bool] = None
                     ) -> Optional[Tuple[float, float, float]]:
    """(AUROC, AUPRC, FPR@95) over pixels labelled in/out; None if either set is
    empty. Pixels with other labels (e.g. 255 void) are excluded. The route is
    :func:`metrics_route`'s: from ``NATIVE_MIN_PIXELS`` labelled pixels on (or
    with ``use_native=True``) the native one (same tie semantics, f32 score
    precision); ``use_native=False`` keeps numpy."""
    conf = np.asarray(conf).reshape(-1)
    seg_label = np.asarray(seg_label).reshape(-1)
    mask = (seg_label == train_id_in) | (seg_label == train_id_out)
    if not mask.any():
        return None
    labels = (seg_label[mask] == train_id_out).astype(np.int64)
    if labels.sum() == 0 or labels.sum() == labels.size:
        return None
    if metrics_route(labels.size, use_native) == "native":
        return native_ood_metrics(conf[mask], labels, recall_level)
    scores = conf[mask].astype(np.float64)
    return (auroc(labels, scores), average_precision(labels, scores),
            fpr_at_recall(labels, scores, recall_level))


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


def masked_min_max(scores: torch.Tensor, labels) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi), f32 0-d tensors: the range of the scores whose label is 0 or 1
    (+inf, -inf when there is none; NaN, both, when one of them is NaN, as
    JAX's ``min`` / ``max`` give). The CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if scores.device.type == "cpu":
        return masked_min_max_plain(scores, labels)
    out = _reduce_cuda(_RANGE, scores, labels)
    lohi = out[:2].view(torch.float32)
    return lohi[0], lohi[1]


def masked_min_max_plain(scores, labels):
    scores, labels = _flat(scores, labels)
    valid = (labels == 0) | (labels == 1)
    inf = torch.full_like(scores, float("inf"))
    return torch.where(valid, scores, inf).min(), torch.where(valid, scores, -inf).max()


def label_histograms(scores: torch.Tensor, labels, lo, hi, num_bins: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pos, neg), int32 [num_bins]: the counts of one map's OOD / in-distribution
    pixels, binned over [lo, hi]: ``bin = clamp(int((s - lo) / max(hi - lo,
    1e-12) * num_bins), 0, num_bins - 1)`` in f32, a NaN in bin 0 (JAX's
    ``_hist_update`` from zero histograms). ``lo`` / ``hi``: tensors (read on
    the card where they lie there) or numbers. The CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if scores.device.type == "cpu":
        return label_histograms_plain(scores, labels, lo, hi, num_bins)
    out = _reduce_cuda(_HIST, scores, labels, num_bins, lo, hi)
    return out[2:2 + num_bins], out[2 + num_bins:]


def label_histograms_plain(scores, labels, lo, hi, num_bins):
    scores, labels = _flat(scores, labels)
    lo = torch.as_tensor(lo, dtype=torch.float32, device=scores.device)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=scores.device)
    x = (scores - lo) / torch.clamp(hi - lo, min=1e-12) * num_bins
    # a NaN to bin 0, as XLA's conversion (NaN to 0) and clip give; the rest
    # clamped in float first: the same bin as clamping the int, without
    # converting an out-of-range float
    x = torch.nan_to_num(x, nan=0.0)
    bins = x.clamp(0, num_bins).to(torch.int32).clamp(max=num_bins - 1).long()
    pos = torch.bincount(bins[labels == 1], minlength=num_bins).to(torch.int32)
    neg = torch.bincount(bins[labels == 0], minlength=num_bins).to(torch.int32)
    return pos, neg


def range_histograms(scores: torch.Tensor, labels, num_bins: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(lo, hi, pos, neg): :func:`masked_min_max`, then :func:`label_histograms`
    over that range, as JAX's ``BinnedOODMeter.update`` and
    ``binned_ood_metrics`` chain them. On the card one kernel, whose four
    results are views of one int32 buffer; the plain versions in sequence for
    CPU tensors."""
    out = _range_histograms_buffer(scores, labels, num_bins)
    lohi = out[:2].view(torch.float32)
    return lohi[0], lohi[1], out[2:2 + num_bins], out[2 + num_bins:]


def range_histograms_plain(scores, labels, num_bins):
    lo, hi = masked_min_max_plain(scores, labels)
    return (lo, hi) + label_histograms_plain(scores, labels, lo, hi, num_bins)


def _range_histograms_buffer(scores, labels, num_bins):
    """int32 [2 + 2 num_bins]: lo and hi (f32 bits), pos, neg."""
    if scores.device.type == "cpu":
        lo, hi, pos, neg = range_histograms_plain(scores, labels, num_bins)
        return torch.cat([torch.stack([lo, hi]).view(torch.int32), pos, neg])
    return _reduce_cuda(_RANGE | _HIST, scores, labels, num_bins)


def _flat(scores, labels):
    return (scores.reshape(-1).float(),
            torch.as_tensor(labels).to(scores.device).reshape(-1).to(torch.int32))


# ---------------------------------------------------------------------------
# The CUDA kernel (csrc/ood_hist.cu): one entry, three modes.

_RANGE, _HIST = 1, 2
_COUNTER = {_RANGE: "ood_hist_minmax", _HIST: "ood_hist", _RANGE | _HIST: "ood_range_hist"}


@dataclass(frozen=True)
class _Kernel:
    """A device's entry of ``csrc/ood_hist.cu`` and its launch shape: the most
    blocks (all resident), the shared memory a block may take, the cluster
    size; ``lib`` is the library it came from."""

    lib: object
    reduce: object
    max_blocks: int
    smem_bytes: int
    cluster: int


_KERNELS: Dict[Optional[int], _Kernel] = {}


def _kernel(dev: torch.device) -> _Kernel:
    """The entry and launch shape on ``dev``, queried once a device. The
    library is asked for on every call (``_build`` keeps it loaded), so a
    failed build raises however often it is tried."""
    lib = _build.load("ood_hist")
    kern = _KERNELS.get(dev.index)
    if kern is None or kern.lib is not lib:
        cfg = _build.function("ood_hist", "ood_config", [ctypes.c_void_p] * 3)
        blocks, smem, cluster = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(dev):
            rc = cfg(ctypes.addressof(blocks), ctypes.addressof(smem), ctypes.addressof(cluster))
        if rc != 0:
            raise RuntimeError(f"ood_config failed: cudaError {rc}")
        kern = _KERNELS[dev.index] = _Kernel(
            lib=lib,
            reduce=_build.function("ood_hist", "ood_reduce",
                                   [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_longlong] * 3
                                   + [ctypes.c_void_p] * 3 + [ctypes.c_float] * 2
                                   + [ctypes.c_int] + [ctypes.c_void_p] * 2
                                   + [ctypes.c_int] * 2 + [ctypes.c_void_p]),
            max_blocks=blocks.value, smem_bytes=smem.value, cluster=cluster.value)
    return kern


def _rows(scores: torch.Tensor):
    """(f32 scores, pixels, row width, row stride): a contiguous map is one row;
    a 2-D view with contiguous rows (a crop) is read in place; anything else
    is made contiguous."""
    if scores.dtype != torch.float32:
        scores = scores.float()
    n = scores.numel()
    if scores.is_contiguous():
        return scores, n, n, n
    if scores.dim() == 2 and scores.stride(1) == 1 and scores.stride(0) >= scores.shape[1]:
        return scores, n, scores.shape[1], scores.stride(0)
    return scores.contiguous(), n, n, n


def _labels_on(labels, dev: torch.device) -> torch.Tensor:
    """int32 [n] labels on ``dev``: a tensor moves device to device, a numpy
    array is uploaded without a host sync."""
    if isinstance(labels, torch.Tensor):
        return labels.to(dev).reshape(-1).to(torch.int32).contiguous()
    host = np.ascontiguousarray(np.asarray(labels).reshape(-1), dtype=np.int32)
    return torch.from_numpy(host).to(dev, non_blocking=True)


def _range_arg(v, dev: torch.device):
    """(f32 tensor on ``dev`` or None, its pointer or None, value) of one end of
    a given range. The caller holds the tensor until the launch is queued: a
    converted copy freed before it could be handed to the other end."""
    if isinstance(v, torch.Tensor) and v.device.type != "cpu":
        v = v.to(dev, torch.float32).reshape(())
        return v, v.data_ptr(), 0.0
    return None, None, float(v)


def _reduce_cuda(mode: int, scores: torch.Tensor, labels, num_bins: int = 1, lo=None, hi=None
                 ) -> torch.Tensor:
    """One launch of the kernel in ``mode``: int32 [2 + 2 num_bins], lo and hi
    (f32 bits) then pos and neg."""
    dev = scores.device
    scores, n, w, ld = _rows(scores)
    lab = _labels_on(labels, dev)
    if lab.numel() != n:
        raise ValueError(f"{lab.numel()} labels for {n} scores")
    kern = _kernel(dev)
    step = 4 * kern.cluster  # the kernel's histogram entries a block, padded
    if mode & _HIST and 4 * step * -(-2 * num_bins // step) > kern.smem_bytes:
        raise ValueError(f"too many bins for the kernel's shared memory: {num_bins}")
    lo_t, lo_p, lo_v = _range_arg(lo, dev) if mode == _HIST else (None, None, 0.0)
    hi_t, hi_p, hi_v = _range_arg(hi, dev) if mode == _HIST else (None, None, 0.0)
    words = 2 + 2 * num_bins
    # the output, then the blocks' partial ranges (two words a block)
    buf = torch.empty(words + 2 * kern.max_blocks, dtype=torch.int32, device=dev)
    with launch_device(dev):  # the raw stream handle, as in matcher.py
        rc = kern.reduce(mode, scores.data_ptr(), n, w, ld, lab.data_ptr(), lo_p, hi_p, lo_v,
                         hi_v, num_bins, buf.data_ptr(), buf.data_ptr() + 4 * words,
                         kern.max_blocks, kern.smem_bytes,
                         torch._C._cuda_getCurrentRawStream(dev.index))
    del lo_t, hi_t  # queued: the stream orders their reuse after the kernel
    if rc != 0:
        raise RuntimeError(f"ood_reduce failed: cudaError {rc}")
    LAUNCHES[_COUNTER[mode]] += 1
    return buf[:words]


class BinnedOODMeter:
    """Streaming (AUROC, AUPRC, FPR@95) over many variable-size score maps with
    bounded memory (``ood_metrics.py:200-266``): ``update`` reduces each map on
    its device to an int32 histogram over the map's own score range (range and
    histogram in one kernel, then one copy of both to the host); ``compute``
    merges the maps' histograms into the global range on the host, each source
    bin's count landing at its bin centre's target bin, and finishes in float64.
    Accuracy is O(score range / num_bins)."""

    def __init__(self, num_bins: int = 8192, recall_level: float = 0.95):
        self.num_bins = num_bins
        self.recall_level = recall_level
        self._hists: List[Tuple[np.ndarray, np.ndarray, float, float]] = []

    def update(self, scores: torch.Tensor, labels) -> None:
        """scores: [...] tensor; labels: [...] int (1 = OOD, 0 = in, other =
        void), a numpy array or a tensor on any device. On the card: one
        kernel, one copy of its int32 buffer to the host."""
        host = _range_histograms_buffer(torch.as_tensor(scores), labels,
                                        self.num_bins).cpu().numpy()
        lo, hi = (float(v) for v in host[:2].view(np.float32))
        if not (np.isfinite(lo) and np.isfinite(hi)):
            return  # no valid pixel in this map, or a NaN or infinite score
        b = self.num_bins
        self._hists.append((host[2:2 + b].astype(np.int64), host[2 + b:].astype(np.int64),
                            lo, hi))

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
    device, no host sync: the range and the histogram in one kernel, or the
    histogram alone over a given range."""
    scores = torch.as_tensor(scores)
    if lo is None and hi is None:
        _, _, pos, neg = range_histograms(scores, labels, num_bins)
    else:
        if lo is None or hi is None:
            lo_v, hi_v = masked_min_max(scores, labels)
            lo = lo_v if lo is None else lo
            hi = hi_v if hi is None else hi
        pos, neg = label_histograms(scores, labels, lo, hi, num_bins)
    return metrics_from_histograms(pos, neg, recall_level)
