"""Score heads: DeepLab's energy score, and Mask2Former's plain versions and
fused CUDA score tail.

Counterpart of ``multishiftseg_tpu/ops/scores.py:25-51`` and
``models/maskformer.py:155-173`` (``semantic_inference``). The JAX eval path
upsamples the ``[N, Q, h, w]`` mask logits to image size and then contracts them;
:func:`anomaly_score_upsampled` and :func:`semantic_inference_upsampled` compute
the same per output pixel in one kernel (``csrc/mask_scores.cu``) for CUDA
tensors, and through the plain path for CPU tensors: the ``mss::mask_scores``
custom op (``ops.custom_op``) in three modes (anomaly, semantic, semantic
classes). The anomaly mode's autograd (``register_autograd``) is the
``mss::mask_scores_backward`` op, a kernel on the card
(:func:`mask_scores_backward`); the semantic modes have no backward kernel and
raise on the card when an input requires grad, rather than return a result
cut off from the graph (on the CPU autograd runs through the plain versions).
Every forward mode can write a window of output rows (``rows = (row0,
count)``: a slab of the row-partitioned eval, ``core/spatial.py``) with the
whole image's coordinates; the windowed plain version resizes through
``ops.resize.resize_bilinear_rows``. The approximate anomaly tails of JAX
``inference`` (``maskformer.py:214-234``) reuse the anomaly kernel:
:func:`anomaly_score_lowres` at the identity resize, then one resize of the
score plane; :func:`anomaly_score_topq` on the gathered rows of the kept
queries.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build
from . import autograd_enabled, custom_op
from .resize import resize_bilinear_nchw, resize_bilinear_rows

# Kernel launches per entry point (see ``ops.launch_counts``).
LAUNCHES = {"mask_scores_anomaly": 0, "mask_scores_semantic": 0,
            "mask_scores_semantic_classes": 0, "mask_scores_backward": 0}

MAX_CLASSES = 32  # K accumulators per thread in the kernel
# the backward's pass 2 gives each query one or two of a block's 256 threads
MAX_BACKWARD_QUERIES = 256
# forward kernel modes (csrc/mask_scores.cu), each with its launch counter
_ANOMALY, _SEMANTIC, _SEMANTIC_CLASSES = 0, 1, 2
_COUNTER = {_ANOMALY: "mask_scores_anomaly", _SEMANTIC: "mask_scores_semantic",
            _SEMANTIC_CLASSES: "mask_scores_semantic_classes"}


def energy_score(ood_logits: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """DeepLab's anomaly score, the negative free energy ``-logsumexp`` over the
    class axis, in f32 (``multishiftseg_tpu/ops/scores.py:20-22``)."""
    return -torch.logsumexp(ood_logits.float(), dim=dim)


def mask2former_semantic_logits(class_logits: torch.Tensor,
                                mask_logits: torch.Tensor) -> torch.Tensor:
    """[B, Q, K+1] class logits x [B, Q, H, W] mask logits -> [B, H, W, K]
    (softmax over classes, void dropped, x sigmoid over masks)."""
    probs = torch.softmax(class_logits.float(), dim=-1)[..., :-1]
    masks = torch.sigmoid(mask_logits.float())
    return torch.einsum("bqk,bqhw->bhwk", probs, masks)


def mask2former_anomaly_score(class_logits_ood: torch.Tensor,
                              mask_logits_ood: torch.Tensor) -> torch.Tensor:
    """Mask2Anomaly per-pixel score ``1 - max_k (softmax x sigmoid)`` -> [B, H, W].
    ``amax``: a tie's gradient is split evenly among the maxima, as ``jnp.max``'s."""
    sem = mask2former_semantic_logits(class_logits_ood, mask_logits_ood)
    return 1.0 - sem.amax(dim=-1)


def keep_weights(class_logits: torch.Tensor, num_classes: int = 19) -> torch.Tensor:
    """[N, Q] weight of each query's extra semantic channel: its top class score
    where that score > 0.95 and the label is a non-void class in (1, 11), else 0
    (``maskformer.py:165-171``)."""
    probs = torch.softmax(class_logits.float(), dim=-1)
    scores, labels = probs.max(dim=-1)
    keep = (labels != num_classes) & (scores > 0.95) & (labels < 11) & (labels > 1)
    return torch.where(keep, scores, torch.zeros_like(scores))


def semantic_inference(class_logits: torch.Tensor, mask_logits_up: torch.Tensor,
                       num_classes: int = 19) -> torch.Tensor:
    """Mask2Anomaly semantic inference on upsampled masks -> [N, K + Q, H, W]:
    K softmax x sigmoid channels, then one kept-query channel per query."""
    sem = mask2former_semantic_logits(class_logits, mask_logits_up)  # [N, H, W, K]
    extra = (torch.sigmoid(mask_logits_up.float())
             * keep_weights(class_logits, num_classes)[:, :, None, None])
    return torch.cat([sem.permute(0, 3, 1, 2), extra], dim=1)


def anomaly_score_upsampled(class_logits_ood: torch.Tensor,
                            mask_logits_ood: torch.Tensor,
                            out_hw: Tuple[int, int],
                            rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Anomaly score at ``out_hw`` from low-resolution mask logits -> [N, H, W],
    or its rows ``rows = (row0, count)`` alone, [N, count, W].

    Differentiable on both devices over the whole map: the softmax (and the
    dropped void column) stays in torch autograd, and the fused tail's
    backward is the :func:`mask_scores_backward` op."""
    probs = torch.softmax(class_logits_ood.float(), dim=-1)[..., :-1].contiguous()
    return torch.ops.mss.mask_scores(mask_logits_ood, probs, None, _hw(out_hw), _ANOMALY,
                                     *_window(rows))


def anomaly_score_upsampled_plain(class_logits_ood, mask_logits_ood, out_hw):
    """Plain version of :func:`anomaly_score_upsampled`: resize, then score."""
    up = resize_bilinear_nchw(mask_logits_ood.float(), out_hw, align_corners=False)
    return mask2former_anomaly_score(class_logits_ood, up)


def anomaly_score_lowres(class_logits_ood: torch.Tensor, mask_logits_ood: torch.Tensor,
                         out_hw: Tuple[int, int],
                         rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The ``score_lowres`` tail (JAX ``inference``, ``maskformer.py:229-234``):
    the anomaly score at the masks' own resolution, the fused tail at the
    identity resize (a CUDA kernel on the card), then one bilinear resize of
    the [N, h, w] score plane to ``out_hw`` (its ``rows`` alone, when given)."""
    low = anomaly_score_upsampled(class_logits_ood, mask_logits_ood,
                                  tuple(mask_logits_ood.shape[-2:]))
    if rows is None:
        return resize_bilinear_nchw(low, out_hw, align_corners=False)
    return resize_bilinear_rows(low, out_hw, rows, align_corners=False)


def top_queries(class_logits_ood: torch.Tensor, q: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(class probabilities [N, Q, K + 1] in f32, the indices [N, q] of the q
    queries with the largest non-void peak probability), as JAX's ``score_topq``
    picks them (``maskformer.py:214-218``): a stable descending sort, so equal
    peaks keep the lower index first, as ``jax.lax.top_k``."""
    n_queries = class_logits_ood.shape[1]
    if not 1 <= q <= n_queries:
        raise ValueError(f"score_topq = {q} must lie in 1..{n_queries} (the queries)")
    probs = torch.softmax(class_logits_ood.float(), dim=-1)
    peak = probs[..., :-1].amax(dim=-1)
    return probs, torch.sort(peak, dim=-1, descending=True, stable=True).indices[:, :q]


def _top_query_inputs(class_logits_ood, mask_logits_ood, q):
    """(the kept queries' non-void probabilities [N, q, K], their mask logits
    [N, q, h, w] in f32), contiguous."""
    probs, idx = top_queries(class_logits_ood, q)
    k = probs.shape[-1] - 1
    probs_sel = probs[..., :-1].gather(1, idx[:, :, None].expand(-1, -1, k))
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return probs_sel.contiguous(), mask_logits_ood[rows, idx].float().contiguous()


def anomaly_score_topq(class_logits_ood: torch.Tensor, mask_logits_ood: torch.Tensor,
                       out_hw: Tuple[int, int], q: int,
                       rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The ``score_topq = q`` tail (JAX ``inference``, ``maskformer.py:214-228``):
    the anomaly score at ``out_hw`` from the q OOD queries with the largest
    non-void peak probability (:func:`top_queries`) and nothing else, with no
    renormalisation. The fused tail (a CUDA kernel on the card, its launch on
    q queries) over the gathered probability rows and mask planes; ``rows``
    as :func:`anomaly_score_upsampled`."""
    probs_sel, masks_sel = _top_query_inputs(class_logits_ood, mask_logits_ood, q)
    return torch.ops.mss.mask_scores(masks_sel, probs_sel, None, _hw(out_hw), _ANOMALY,
                                     *_window(rows))


def anomaly_score_topq_plain(class_logits_ood, mask_logits_ood, out_hw, q):
    """Plain version of :func:`anomaly_score_topq`: resize the q planes, then score."""
    return _anomaly_from_probs_plain(*_top_query_inputs(class_logits_ood, mask_logits_ood, q),
                                     out_hw)


def _anomaly_from_probs_plain(probs, masks, out_hw):
    up = resize_bilinear_nchw(masks, out_hw, align_corners=False)
    sem = torch.einsum("bqk,bqhw->bhwk", probs, torch.sigmoid(up))
    return 1.0 - sem.amax(dim=-1)


def mask_scores_backward(masks: torch.Tensor, probs: torch.Tensor, grad: torch.Tensor,
                         out_hw: Tuple[int, int], dmask: bool = False
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Gradients of ``1 - max_k sum_q probs[:, q, k] sigmoid(up(masks)[:, q])``
    for ``grad`` [N, H, W] -> (d probs [N, Q, K], d masks [N, Q, h, w] when
    ``dmask``, else None), f32. A tie's gradient is split evenly among the
    classes that reach the max. The CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (the ``mss::mask_scores_backward`` op)."""
    dprobs, dm = torch.ops.mss.mask_scores_backward(masks, probs, grad, _hw(out_hw), dmask)
    return dprobs, (dm if dmask else None)


def mask_scores_backward_plain(masks, probs, grad, out_hw, dmask=False):
    """Plain version of :func:`mask_scores_backward`: autograd of resize,
    sigmoid, the contraction and ``amax``."""
    with autograd_enabled():
        m = masks.detach().float().requires_grad_(dmask)
        p = probs.detach().float().requires_grad_()
        out = _anomaly_from_probs_plain(p, m, _hw(out_hw))
        grads = torch.autograd.grad(out, (p, m) if dmask else (p,), grad.float())
    return grads[0].contiguous(), (grads[1].contiguous() if dmask else None)


def semantic_inference_upsampled(class_logits: torch.Tensor, mask_logits: torch.Tensor,
                                 out_hw: Tuple[int, int], num_classes: int = 19,
                                 _classes_only: bool = False,
                                 rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Semantic inference at ``out_hw`` from low-resolution mask logits
    -> [N, K + Q, H, W]. ``_classes_only`` (for :func:`models.maskformer.inference`
    when its caller keeps only ``sem[:, :K]``) computes the K class channels
    alone, [N, K, H, W]: the kept-query channels are never written. ``rows =
    (row0, count)``: those output rows alone."""
    if class_logits.shape[-1] != num_classes + 1:
        raise ValueError(f"class logits have {class_logits.shape[-1]} entries, "
                         f"expected num_classes + 1 = {num_classes + 1}")
    if torch.is_grad_enabled() and (class_logits.requires_grad or mask_logits.requires_grad):
        if mask_logits.device.type == "cpu" and rows is None:
            return semantic_inference_upsampled_plain(class_logits, mask_logits, out_hw,
                                                      num_classes, _classes_only)
        _refuse_grad("semantic_inference_upsampled")
    probs = torch.softmax(class_logits.float(), dim=-1)[..., :-1].contiguous()
    if _classes_only:
        return torch.ops.mss.mask_scores(mask_logits, probs, None, _hw(out_hw),
                                         _SEMANTIC_CLASSES, *_window(rows))
    keep = keep_weights(class_logits, num_classes).contiguous()
    return torch.ops.mss.mask_scores(mask_logits, probs, keep, _hw(out_hw), _SEMANTIC,
                                     *_window(rows))


def semantic_inference_upsampled_plain(class_logits, mask_logits, out_hw,
                                       num_classes=19, _classes_only=False):
    """Plain version of :func:`semantic_inference_upsampled`: resize, then score."""
    up = resize_bilinear_nchw(mask_logits.float(), out_hw, align_corners=False)
    if _classes_only:
        return mask2former_semantic_logits(class_logits, up).permute(0, 3, 1, 2)
    return semantic_inference(class_logits, up, num_classes)


def _refuse_grad(name):
    raise RuntimeError(f"{name}: the score-tail kernel has no backward yet; "
                       "run it under torch.no_grad()")


def _hw(out_hw):
    return [int(v) for v in out_hw]


def _window(rows):
    """The op's (row0, rows) arguments: (0, -1) for the whole map."""
    return (0, -1) if rows is None else (int(rows[0]), int(rows[1]))


def _rows(out_hw, row0, rows):
    """The output rows (row0, count) of a call, checked against the map."""
    H = int(out_hw[0])
    count = H - row0 if rows < 0 else rows
    if row0 < 0 or count < 0 or row0 + count > H:
        raise ValueError(f"rows [{row0}, {row0 + count}) outside a map of {H} rows")
    return row0, count


def _check_tail_args(masks, probs):
    if masks.dtype != torch.float32:
        raise TypeError(f"mask logits must be float32, got {masks.dtype}")
    if masks.dim() != 4 or not masks.is_contiguous():
        raise ValueError("mask logits must be a contiguous [N, Q, h, w] tensor")
    n, q, h, w = masks.shape
    k = probs.shape[-1]
    if tuple(probs.shape) != (n, q, k):
        raise ValueError(f"class probabilities {tuple(probs.shape)} do not match "
                         f"masks {tuple(masks.shape)}")
    if not 1 <= k <= MAX_CLASSES:
        raise ValueError(f"the kernel takes 1..{MAX_CLASSES} classes, got {k}")
    return n, q, k, h, w


def _mask_scores_cuda(masks, probs, keep, out_hw, mode, row0=0, rows=-1):
    n, q, k, h, w = _check_tail_args(masks, probs)
    tensors = (masks, probs) + ((keep,) if mode == _SEMANTIC else ())
    if any(t.device != masks.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    H, W = (int(v) for v in out_hw)
    row0, rows = _rows(out_hw, row0, rows)
    fn = _build.function("mask_scores", "mask_scores_forward",
                         [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    shape = {_ANOMALY: (n, rows, W), _SEMANTIC: (n, k + q, rows, W),
             _SEMANTIC_CLASSES: (n, k, rows, W)}[mode]
    out = torch.empty(shape, dtype=torch.float32, device=masks.device)
    with torch.cuda.device(masks.device):
        stream = torch.cuda.current_stream(masks.device).cuda_stream
        rc = fn(masks.data_ptr(), probs.data_ptr(),
                keep.data_ptr() if mode == _SEMANTIC else None, out.data_ptr(),
                n, q, k, h, w, H, W, row0, rows, mode, stream)
    if rc != 0:
        raise RuntimeError(f"mask_scores_forward failed: cudaError {rc}")
    LAUNCHES[_COUNTER[mode]] += 1
    return out


def _mask_scores_backward_cuda(masks, probs, grad, out_hw, want_dmask):
    n, q, k, h, w = _check_tail_args(masks, probs)
    H, W = (int(v) for v in out_hw)
    if q > MAX_BACKWARD_QUERIES:
        raise ValueError(f"the backward kernel takes at most {MAX_BACKWARD_QUERIES} "
                         f"queries, got {q}")
    probs = probs.float().contiguous()
    grad = grad.float().contiguous()
    if tuple(grad.shape) != (n, H, W) or any(
            t.device != masks.device for t in (probs, grad)):
        raise ValueError(f"grad {tuple(grad.shape)} on {grad.device}, expected "
                         f"{(n, H, W)} on {masks.device}")
    fn = _build.function("mask_scores", "mask_scores_backward",
                         [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 3
                         + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    occupancy = _build.function("mask_scores", "mask_scores_backward_blocks_per_sm",
                                [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)])
    dev = masks.device
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = occupancy(q, k, h, w, H, W, ctypes.byref(per_sm))
    if rc != 0 or per_sm.value < 1:
        raise RuntimeError(f"mask_scores_backward: no block fits on an SM (cudaError {rc})")
    # the images share one wave of blocks, each image's pixels split in chunks
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunks = max(1, per_sm.value * sms // max(n, 1))
    # each block's sums, per query in up to two halves of its class lists
    partial = torch.empty((n, chunks, 2, q, k), dtype=torch.float32, device=dev)
    dprobs = torch.empty((n, q, k), dtype=torch.float32, device=dev)
    dmask = tie = share = None
    if want_dmask:
        dmask = torch.empty_like(masks)
        tie = torch.empty((n, H, W), dtype=torch.int32, device=dev)
        share = torch.empty((n, H, W), dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(masks.data_ptr(), probs.data_ptr(), grad.data_ptr(), dprobs.data_ptr(),
                partial.data_ptr(), chunks, ptr(dmask), ptr(tie), ptr(share),
                n, q, k, h, w, H, W, stream)
    if rc != 0:
        raise RuntimeError(f"mask_scores_backward failed: cudaError {rc}")
    LAUNCHES["mask_scores_backward"] += 1
    return dprobs, dmask


# ---------------------------------------------------------------------------
# the custom ops: plain versions on the CPU, the kernels on the card


def _tail_plain(masks, probs, keep, out_hw, mode, row0=0, rows=-1):
    """The plain version of every mode of ``mss::mask_scores``: resize (the
    window's rows alone), then score."""
    window = _rows(out_hw, row0, rows)
    up = (resize_bilinear_nchw(masks.float(), tuple(out_hw), align_corners=False)
          if window == (0, int(out_hw[0]))
          else resize_bilinear_rows(masks.float(), tuple(out_hw), window, align_corners=False))
    sig = torch.sigmoid(up)
    sem = torch.einsum("bqk,bqhw->bhwk", probs, sig)
    if mode == _ANOMALY:
        return 1.0 - sem.amax(dim=-1)
    sem = sem.permute(0, 3, 1, 2)
    if mode == _SEMANTIC_CLASSES:
        return sem.contiguous()
    return torch.cat([sem, sig * keep[:, :, None, None]], dim=1)


def _tail_fake(masks, probs, keep, out_hw, mode, row0=0, rows=-1):
    n, q = masks.shape[:2]
    k = probs.shape[-1]
    lead = {_ANOMALY: (n,), _SEMANTIC: (n, k + q), _SEMANTIC_CLASSES: (n, k)}[mode]
    return masks.new_empty((*lead, _rows(out_hw, row0, rows)[1], out_hw[1]),
                           dtype=torch.float32)


def _tail_setup(ctx, inputs, output):
    masks, probs, _, out_hw, mode, row0, rows = inputs
    ctx.out_hw, ctx.mode, ctx.window = out_hw, mode, (row0, rows)
    ctx.save_for_backward(masks, probs)


def _tail_backward(ctx, grad):
    if ctx.mode != _ANOMALY:
        _refuse_grad("semantic_inference_upsampled")
    if _rows(ctx.out_hw, *ctx.window) != (0, int(ctx.out_hw[0])):
        raise RuntimeError("the score tail's backward takes the whole map, not a window "
                           "of its rows")
    masks, probs = ctx.saved_tensors
    want_dmask = ctx.needs_input_grad[0]
    dprobs, dmask = torch.ops.mss.mask_scores_backward(masks, probs, grad, ctx.out_hw,
                                                       want_dmask)
    return (dmask.to(masks.dtype) if want_dmask else None), dprobs, None, None, None, None, None


custom_op("mask_scores",
          "(Tensor masks, Tensor probs, Tensor? keep, int[] out_hw, int mode, int row0=0, "
          "int rows=-1) -> Tensor",
          _tail_plain,
          # looked up at each call, so that a harness may wrap the launch
          lambda masks, probs, keep, out_hw, mode, row0=0, rows=-1: _mask_scores_cuda(
              masks, probs, keep, out_hw, mode, row0, rows),
          _tail_fake, _tail_backward, _tail_setup)


def _no_dmask(masks):
    return masks.new_empty(0, dtype=torch.float32)


def _tail_backward_plain(masks, probs, grad, out_hw, dmask):
    dprobs, dm = mask_scores_backward_plain(masks, probs, grad, out_hw, dmask)
    return dprobs, (dm if dmask else _no_dmask(masks))


def _tail_backward_cuda(masks, probs, grad, out_hw, dmask):
    dprobs, dm = _mask_scores_backward_cuda(masks, probs, grad, out_hw, dmask)
    return dprobs, (dm if dmask else _no_dmask(masks))


custom_op("mask_scores_backward",
          "(Tensor masks, Tensor probs, Tensor grad, int[] out_hw, bool dmask) "
          "-> (Tensor, Tensor)",
          _tail_backward_plain, _tail_backward_cuda,
          lambda masks, probs, grad, out_hw, dmask: (
              torch.empty_like(probs, dtype=torch.float32),
              torch.empty_like(masks, dtype=torch.float32) if dmask else _no_dmask(masks)))
