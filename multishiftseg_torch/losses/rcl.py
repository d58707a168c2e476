"""Relative Contrastive Loss (RCL), the paper's anomaly-aware loss.

Counterpart of ``multishiftseg_tpu/losses/rcl.py`` (all of it). The batch's
leading axis is [clean half ‖ augmented half]. The random numbers are an input:
``noise`` [3, B * H * W] holds the uniform draws that pick the contrastive pixel
pairs (clean in-distribution, augmented in-distribution, OOD), which the JAX
version draws from three keys split off ``rng`` (``rcl.py:171-174``). The
caller makes them (``losses.criterion.criterion_draws``), so the port and the
JAX package can be fed the very same numbers.

Pairs are formed by position: the i-th sampled clean pixel meets the i-th sampled
OOD pixel. Sampling keeps the pixels with the largest noise, ties broken towards
the lower index as ``jax.lax.top_k`` does, by a stable descending sort.

The pixel selection of the augmented half's CE (``_bottom_k_sum``) runs as a CUDA
kernel for CUDA tensors (``csrc/bottom_k.cu``), as its plain version on the CPU.
Inside a process group it selects over the global batch's pixels
(:func:`bottom_k_sum_global`): two radix rounds whose digit histograms are
all-reduced between them, then a fold of the last digit's counts and sums
with the sums below, all-reduced, from which one block forms the result.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from .. import _build
from ..core.mesh import (all_sum, gather_rows, global_mean, global_sum, process_count,
                         spans_ranks)
from .matcher import launch_device

# Kernel launches (see ``ops.launch_counts``): the single-process selection and
# the global one of a process group (a call of its route counts once).
LAUNCHES = {"bottom_k_sum": 0, "bottom_k_sum_global": 0}


@dataclass(frozen=True)
class RCLParams:
    """The ``loss.params`` dict of the experiment YAMLs."""

    ce_weights: Tuple[float, float] = (1.0, 1.0)
    inoutaug_contras_margins_tri: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    contras_weight: float = 1.0
    sample_ratio: float = 1.0
    conduct_pixel_selection: bool = False
    selection_ratio: float = 1.0
    in_id: int = 99
    void_id: int = 255
    num_pair_samples: int = 65536  # cap on contrastive pixel pairs


def make_rcl_params(cfg_params: Optional[dict]) -> RCLParams:
    """RCLParams from a reference-style ``loss.params`` dict."""
    d = dict(cfg_params or {})
    kw = {}
    for name in ("ce_weights", "inoutaug_contras_margins_tri", "contras_weight",
                 "sample_ratio", "conduct_pixel_selection", "selection_ratio",
                 "num_pair_samples"):
        if name in d and d[name] is not None:
            v = d[name]
            kw[name] = tuple(v) if isinstance(v, list) else v
    return RCLParams(**kw)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    cnt = mask.sum()
    return torch.where(cnt > 0, (x * mask).sum() / cnt.clamp_min(1), x.new_zeros(()))


def _pixel_ce(logits: torch.Tensor, targets: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-pixel cross entropy, zero where invalid. logits [..., C], targets [...]."""
    logp = F.log_softmax(logits.float(), dim=-1)
    t = targets.clamp(0, logits.shape[-1] - 1).long()
    return -logp.gather(-1, t[..., None])[..., 0] * valid


def _bottom_k_sum(values: torch.Tensor, keyed: torch.Tensor,
                  select_num: torch.Tensor) -> torch.Tensor:
    """Sum of the ``select_num`` smallest-keyed elements of ``values``, threshold
    ties sharing the remaining weight (``rcl.py:65-97``): the CUDA kernel
    (``csrc/bottom_k.cu``) for CUDA tensors, the plain version for CPU tensors.
    ``keyed`` is a detached copy of ``values`` (>= 0, +inf where invalid);
    ``select_num`` an int32 scalar tensor, which stays on the device. In a
    process group of more than one rank the selection spans every rank's
    elements (:func:`bottom_k_sum_global`, ``select_num`` the global count)."""
    if spans_ranks():
        return bottom_k_sum_global(values, keyed, select_num)
    if values.device.type == "cpu":
        return bottom_k_sum_plain(values, keyed, select_num)
    return _BottomKSum.apply(values, keyed, select_num)


def bottom_k_sum_global(values: torch.Tensor, keyed: torch.Tensor,
                        select_num: torch.Tensor) -> torch.Tensor:
    """:func:`_bottom_k_sum` over the elements of every rank of the process
    group: ``select_num`` of the global set, the same sum on every rank, whose
    backward sums the incoming gradient over the ranks (``core.mesh``). The
    CUDA kernels' route (``csrc/bottom_k.cu``, ``bottom_k_global_*``) for CUDA
    tensors, the plain version for CPU tensors. No sort and no host sync."""
    if values.device.type == "cpu":
        return bottom_k_sum_global_plain(values, keyed, select_num)
    return _GlobalBottomKSum.apply(values, keyed, select_num)


# the radix digits, most significant first: (shift, bits)
RADIX_DIGITS = ((21, 11), (10, 11), (0, 10))


def bottom_k_sum_global_plain(values: torch.Tensor, keyed: torch.Tensor,
                              select_num: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`bottom_k_sum_global`: the threshold digit by
    digit (11, 11, 10 bits), each round a histogram of the keys under the
    prefix so far, all-reduced, and the smallest digit whose running count
    reaches the count still needed (digit 0 when none is needed, the last
    digit when the keys fall short, as the single-process search ends); then
    the sums below and at the threshold and their counts, all-reduced, with
    ties sharing ``need / n_eq``."""
    dev = values.device
    bits = keyed.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    prefix = torch.zeros((), dtype=torch.int64, device=dev)
    left = select_num.long().reshape(())
    for shift, width in RADIX_DIGITS:
        bins = 1 << width
        above = (0xFFFFFFFF << (shift + width)) & 0xFFFFFFFF
        under = (bits & above) == prefix
        digit = (bits >> shift) & (bins - 1)
        hist = torch.zeros(bins, dtype=torch.int64, device=dev).index_add_(
            0, digit.reshape(-1), under.reshape(-1).long())
        hist = all_sum(hist)
        cum = hist.cumsum(0)
        d = (cum < left).sum().clamp_max(bins - 1)
        prefix = prefix | (d << shift)
        left = left - (cum - hist)[d]
    less, eq = bits < prefix, bits == prefix
    zero = values.new_zeros(())
    sums = all_sum(torch.stack([torch.where(less, values, zero).sum(),
                                torch.where(eq, values, zero).sum()]))
    counts = all_sum(torch.stack([less.sum(), eq.sum()]))
    need = (select_num.long().reshape(()) - counts[0]).clamp_min(0).float()
    return sums[0] + sums[1] * (need / counts[1].clamp_min(1).float())


def bottom_k_sum_plain(values: torch.Tensor, keyed: torch.Tensor,
                       select_num: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`_bottom_k_sum`: the JAX package's exact
    k-th-smallest threshold by a 32-step binary search over the float32 bit
    pattern, then two masked sums. Its autograd gives weight 1 below the
    threshold and ``need / n_eq`` at it."""
    bits = keyed.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    lo = torch.zeros((), dtype=torch.int64, device=values.device)
    hi = torch.full((), 0xFFFFFFFF, dtype=torch.int64, device=values.device)
    for _ in range(32):
        mid = lo + (hi - lo) // 2
        found = (bits <= mid).sum() >= select_num
        lo, hi = torch.where(found, lo, mid + 1), torch.where(found, mid, hi)
    less = bits < lo
    eq = bits == lo
    n_less = less.sum()
    n_eq = eq.sum().clamp_min(1)
    need = (select_num - n_less).clamp_min(0).float()
    zero = values.new_zeros(())
    return (torch.where(less, values, zero).sum()
            + torch.where(eq, values, zero).sum() * (need / n_eq.float()))


class _BottomKSum(torch.autograd.Function):
    """The selection on the card: one cooperative kernel forward (radix select
    and the sums); backward, the elementwise weight from the saved threshold."""

    @staticmethod
    def forward(ctx, values, keyed, select_num):
        out, keys, scratch = _bottom_k_forward(values, keyed, select_num)
        ctx.shape = values.shape
        ctx.save_for_backward(keys, scratch)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        keys, scratch = ctx.saved_tensors
        dvalues = torch.empty(keys.shape, dtype=torch.float32, device=keys.device)
        g = grad.float().contiguous()
        dev = keys.device
        with launch_device(dev):
            rc = _kernel(dev).backward(keys.data_ptr(), keys.numel(), scratch.data_ptr(),
                                       g.data_ptr(), dvalues.data_ptr(),
                                       torch._C._cuda_getCurrentRawStream(dev.index))
        if rc != 0:
            raise RuntimeError(f"bottom_k_backward failed: cudaError {rc}")
        return dvalues.view(ctx.shape), None, None


# the scratch's words (csrc/bottom_k.cu): threshold, then the result
SCRATCH_THRESHOLD, SCRATCH_RESULT = 0, 1


@dataclass(frozen=True)
class _Kernel:
    """A device's entries of ``csrc/bottom_k.cu`` and its launch shape: the most
    blocks (all resident), the 4-byte words a block stages (keys, then values)
    and the scratch words of the single-process and the global routes."""

    forward: object
    backward: object
    global_round: object
    global_fold: object
    global_result: object
    max_blocks: int
    stage_words: int
    scratch_words: int
    global_blocks: int
    global_layout: "GlobalLayout"


@dataclass(frozen=True)
class GlobalLayout:
    """The global route's scratch (``bottom_k_global_layout``, int32 words):
    the two rounds' histograms, the fold that is all-reduced (f64 from
    ``fold``, ``fold_len`` entries), and the words in all."""

    h0: int
    bins0: int
    h1: int
    bins1: int
    fold: int
    fold_len: int
    words: int


_KERNELS: Dict[Optional[int], _Kernel] = {}


def _kernel(dev: torch.device) -> _Kernel:
    """The kernel's entries and launch shape on ``dev``, loaded and queried
    once a device."""
    kern = _KERNELS.get(dev.index)
    if kern is None:
        cfg = _build.function("bottom_k", "bottom_k_config", [ctypes.c_void_p] * 2)
        blocks, stage = ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(dev):
            rc = cfg(ctypes.addressof(blocks), ctypes.addressof(stage))
        if rc != 0:
            raise RuntimeError(f"bottom_k_config failed: cudaError {rc}")
        gcfg = _build.function("bottom_k", "bottom_k_global_config", [ctypes.c_void_p])
        gblocks = ctypes.c_int()
        with torch.cuda.device(dev):
            rc = gcfg(ctypes.addressof(gblocks))
        if rc != 0:
            raise RuntimeError(f"bottom_k_global_config failed: cudaError {rc}")
        words = _build.function("bottom_k", "bottom_k_scratch_words", [ctypes.c_int])
        words.restype = ctypes.c_longlong
        layout = (ctypes.c_longlong * 7)()
        rc = _build.function("bottom_k", "bottom_k_global_layout",
                             [ctypes.c_int, ctypes.c_void_p])(gblocks.value, layout)
        if rc != 0:
            raise RuntimeError(f"bottom_k_global_layout failed: cudaError {rc}")
        f = _build.function
        kern = _KERNELS[dev.index] = _Kernel(
            forward=f("bottom_k", "bottom_k_forward",
                      [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
                      + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]),
            backward=f("bottom_k", "bottom_k_backward",
                       [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 4),
            global_round=f("bottom_k", "bottom_k_global_round",
                           [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 2
                           + [ctypes.c_int] * 2 + [ctypes.c_void_p]),
            global_fold=f("bottom_k", "bottom_k_global_fold",
                          [ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_void_p] * 2
                          + [ctypes.c_int, ctypes.c_void_p]),
            global_result=f("bottom_k", "bottom_k_global_result", [ctypes.c_void_p] * 3),
            max_blocks=blocks.value, stage_words=stage.value,
            scratch_words=words(blocks.value), global_blocks=gblocks.value,
            global_layout=GlobalLayout(*layout))
    return kern


def staged_fraction(n: int, dev: torch.device) -> float:
    """The share of ``n`` keys the forward on ``dev`` stages in shared memory
    (the rest it reads from global memory in every pass)."""
    kern = _kernel(dev)
    fn = _build.function("bottom_k", "bottom_k_staged_keys",
                         [ctypes.c_longlong, ctypes.c_int, ctypes.c_int])
    fn.restype = ctypes.c_longlong
    return fn(n, kern.max_blocks, kern.stage_words) / max(n, 1)


def _bottom_k_forward(values: torch.Tensor, keyed: torch.Tensor, select_num: torch.Tensor):
    """The kernel: (sum [] f32, the keys, the scratch that holds the threshold
    and the result). f32 ``values`` and ``keyed`` of one shape, ``select_num``
    int32 with one element, all on one device."""
    if values.dtype != torch.float32 or keyed.dtype != torch.float32:
        raise TypeError(f"values and keys must be float32, got {values.dtype}, {keyed.dtype}")
    if values.shape != keyed.shape:
        raise ValueError(f"values {tuple(values.shape)} and keys {tuple(keyed.shape)} differ")
    if select_num.numel() != 1 or select_num.dtype != torch.int32:
        raise TypeError("select_num must be one int32")
    dev = values.device
    if keyed.device != dev or select_num.device != dev:
        raise ValueError("values, keys and select_num must be on one device")
    keys = keyed.contiguous()
    vals = values.contiguous()
    kern = _kernel(dev)
    scratch = torch.empty(kern.scratch_words, dtype=torch.float32, device=dev)
    with launch_device(dev):  # the raw stream handle, as in matcher.py
        rc = kern.forward(keys.data_ptr(), vals.data_ptr(), keys.numel(), select_num.data_ptr(),
                          scratch.data_ptr(), kern.max_blocks, kern.stage_words,
                          torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError(f"bottom_k_forward failed: cudaError {rc}")
    LAUNCHES["bottom_k_sum"] += 1
    return scratch[SCRATCH_RESULT], keys, scratch


class _GlobalBottomKSum(torch.autograd.Function):
    """The global selection on the card: two round kernels, each all-reduced,
    the fold kernel, all-reduced, then the result kernel; backward, the
    incoming gradient all-reduced, then the single-process route's
    elementwise weights."""

    @staticmethod
    def forward(ctx, values, keyed, select_num):
        out, keys, scratch = _bottom_k_global_forward(values, keyed, select_num)
        ctx.shape = values.shape
        ctx.save_for_backward(keys, scratch)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        keys, scratch = ctx.saved_tensors
        g = all_sum(grad.float().contiguous())
        dvalues = torch.empty(keys.shape, dtype=torch.float32, device=keys.device)
        dev = keys.device
        with launch_device(dev):
            rc = _kernel(dev).backward(keys.data_ptr(), keys.numel(), scratch.data_ptr(),
                                       g.data_ptr(), dvalues.data_ptr(),
                                       torch._C._cuda_getCurrentRawStream(dev.index))
        if rc != 0:
            raise RuntimeError(f"bottom_k_backward failed: cudaError {rc}")
        return dvalues.view(ctx.shape), None, None


def _check(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} failed: cudaError {rc}")


def _bottom_k_global_forward(values: torch.Tensor, keyed: torch.Tensor,
                             select_num: torch.Tensor):
    """The global route's kernels and collectives: (sum [] f32, the keys, the
    scratch that holds the threshold, the result and the tie weight)."""
    if values.dtype != torch.float32 or keyed.dtype != torch.float32:
        raise TypeError(f"values and keys must be float32, got {values.dtype}, {keyed.dtype}")
    if values.shape != keyed.shape:
        raise ValueError(f"values {tuple(values.shape)} and keys {tuple(keyed.shape)} differ")
    if select_num.numel() != 1 or select_num.dtype != torch.int32:
        raise TypeError("select_num must be one int32")
    dev = values.device
    if keyed.device != dev or select_num.device != dev:
        raise ValueError("values, keys and select_num must be on one device")
    keys, vals = keyed.contiguous(), values.contiguous()
    kern = _kernel(dev)
    lay = kern.global_layout
    # one a call, as the single-process route's: the backward reads the
    # threshold and the tie weight from it; round 0 zeroes what the route
    # adds into
    scratch = torch.empty(lay.words, dtype=torch.int32, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    args = (keys.data_ptr(), keys.numel(), select_num.data_ptr(), scratch.data_ptr())
    with launch_device(dev):
        for r, (first, bins) in enumerate(((lay.h0, lay.bins0), (lay.h1, lay.bins1))):
            _check("bottom_k_global_round", kern.global_round(*args, r, kern.global_blocks,
                                                              stream))
            dist.all_reduce(scratch[first:first + bins])
        _check("bottom_k_global_fold",
               kern.global_fold(keys.data_ptr(), vals.data_ptr(), keys.numel(),
                                select_num.data_ptr(), scratch.data_ptr(), kern.global_blocks,
                                stream))
        dist.all_reduce(scratch[lay.fold:lay.fold + 2 * lay.fold_len].view(torch.float64))
        _check("bottom_k_global_result",
               kern.global_result(select_num.data_ptr(), scratch.data_ptr(), stream))
    LAUNCHES["bottom_k_sum_global"] += 1
    result = scratch[SCRATCH_RESULT:SCRATCH_RESULT + 4].view(torch.float32)
    return result[0], keys, scratch


def bottom_k_sum_global_cuda(values: torch.Tensor, keyed: torch.Tensor,
                             select_num: torch.Tensor):
    """The global route outside autograd: (sum [] f32, threshold [] int32,
    result [4] f32: sum, tie weight, n_less, n_eq), views of one scratch."""
    out, _, scratch = _bottom_k_global_forward(values.detach(), keyed.detach(),
                                               select_num.detach())
    return (out, scratch[SCRATCH_THRESHOLD],
            scratch[SCRATCH_RESULT:SCRATCH_RESULT + 4].view(torch.float32))


def bottom_k_sum_cuda(values: torch.Tensor, keyed: torch.Tensor, select_num: torch.Tensor):
    """The kernel outside autograd: (sum [] f32, threshold [] int32, result [4]
    f32: sum, tie weight, n_less, n_eq), views of one scratch buffer."""
    out, _, scratch = _bottom_k_forward(values.detach(), keyed.detach(), select_num.detach())
    return (out, scratch[SCRATCH_THRESHOLD].view(torch.int32),
            scratch[SCRATCH_RESULT:SCRATCH_RESULT + 4])


def _sample_masked(noise: torch.Tensor, values: torch.Tensor, mask: torch.Tensor,
                   k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to ``k`` distinct elements of ``values`` where ``mask``, uniformly: the
    ``k`` largest of ``noise`` (masked to -1), ties to the lower index. Returns
    (samples [k], count); positions past the count hold arbitrary values."""
    scored = torch.where(mask, noise, torch.full_like(noise, -1.0))
    order = torch.sort(scored, descending=True, stable=True).indices
    return values[order[:min(k, mask.numel())]], mask.sum()


def rel_contrastive_loss(logits: torch.Tensor, anomaly_score: torch.Tensor,
                         targets: torch.Tensor, noise: torch.Tensor,
                         params: RCLParams) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """RCL loss and its components.

    logits [B, H, W, C]; anomaly_score [B, H, W]; targets [B, H, W] int (< 99
    in-distribution train ids, > 99 and != 255 OOD, 255 void); noise [3, B*H*W]
    uniform draws in [0, 1).

    Inside a process group (``core.mesh``) the arguments are this rank's rows,
    [its clean ‖ its augmented], and ``noise`` covers the global batch: every
    reduction spans the global batch as JAX's step over global arrays does. The
    CE means and counts are all-reduced, the pixel selection is the global
    bottom-k, and the contrastive pairs are drawn from the gathered scores in
    JAX's global order [all clean ‖ all augmented].
    """
    p = params
    b = logits.shape[0]
    half = b // 2
    targets = targets.long()
    ood_mask = (targets > p.in_id) & (targets != p.void_id)
    in_mask = targets < p.in_id

    # (a) CE on the clean half; NLLLoss(reduction='none').mean() divides by all pixels
    ce_map = _pixel_ce(logits, torch.where(in_mask, targets, torch.full_like(targets, p.void_id)),
                       in_mask)
    ce_original = global_mean(ce_map[:half])

    # (b) CE on the augmented half, optionally over the easiest pixels only
    aug_ce = ce_map[half:].reshape(-1)
    aug_in = in_mask[half:].reshape(-1)
    n_aug_in = global_sum(aug_in)
    if p.conduct_pixel_selection and 0.0 < p.selection_ratio < 1.0:
        keyed = torch.where(aug_in, aug_ce.detach(), torch.full_like(aug_ce, float("inf")))
        select_num = (p.selection_ratio * n_aug_in).to(torch.int32)
        ssum = _bottom_k_sum(aug_ce, keyed, select_num)
        ce_aug = torch.where(select_num > 0, ssum / select_num.clamp_min(1), ssum.new_zeros(()))
    else:
        ce_aug = torch.where(n_aug_in > 0,
                             global_sum(aug_ce) / (aug_ce.numel() * process_count()),
                             aug_ce.new_zeros(()))
    ce_loss = p.ce_weights[0] * ce_original + p.ce_weights[1] * ce_aug

    # (c) contrastive terms over pixel pairs of the global batch
    score = gather_rows(anomaly_score.float(), paired=True)
    targets = gather_rows(targets.int(), paired=True).long()
    ood_mask = (targets > p.in_id) & (targets != p.void_id)
    in_mask = targets < p.in_id
    half = targets.shape[0] // 2
    in_orig = in_mask.clone()
    in_orig[half:] = False
    in_aug = in_mask.clone()
    in_aug[:half] = False
    flat_score = score.reshape(-1)
    if tuple(noise.shape) != (3, flat_score.numel()):
        raise ValueError(f"noise {tuple(noise.shape)}, expected (3, {flat_score.numel()})")
    k = min(p.num_pair_samples, flat_score.numel())
    s_orig, n_orig = _sample_masked(noise[0], flat_score, in_orig.reshape(-1), k)
    s_aug, n_aug = _sample_masked(noise[1], flat_score, in_aug.reshape(-1), k)
    s_ood, n_ood = _sample_masked(noise[2], flat_score, ood_mask.reshape(-1), k)
    total_budget = int(p.sample_ratio * targets.numel())
    n_pairs = torch.stack([n_orig, n_aug, n_ood]).min().clamp_max(min(k, total_budget))
    pair_w = (torch.arange(k, device=score.device) < n_pairs).float()

    m0, m1, m2 = p.inoutaug_contras_margins_tri
    contras_original = _masked_mean(F.relu(s_orig + m0 - s_ood), pair_w)
    contras_aug = _masked_mean(F.relu(s_aug + m1 - s_ood), pair_w)
    same_in = (in_mask[:half] & in_mask[half:]).float()
    contras_in = _masked_mean(F.relu(score[half:] - score[:half] - m2), same_in)

    loss = ce_loss + p.contras_weight * (contras_original + contras_aug + contras_in)
    aux = {"ce_original": ce_original, "ce_aug": ce_aug,
           "contras_original": contras_original, "contras_aug": contras_aug,
           "contras_in": contras_in, "n_pairs": n_pairs.float()}
    return loss, aux
