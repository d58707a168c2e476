"""Score heads: DeepLab's energy score, and Mask2Former's plain versions and
fused CUDA score tail.

Counterpart of ``multishiftseg_tpu/ops/scores.py:25-51`` and
``models/maskformer.py:155-173`` (``semantic_inference``). The JAX eval path
upsamples the ``[N, Q, h, w]`` mask logits to image size and then contracts them;
:func:`anomaly_score_upsampled` and :func:`semantic_inference_upsampled` compute
the same per output pixel in one kernel (``csrc/mask_scores.cu``) for CUDA
tensors, and through the plain path for CPU tensors. The kernel has no backward
yet: on the card both entries raise when an input requires grad, rather than
return a result cut off from the graph.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .resize import resize_bilinear_nchw

# Kernel launches per entry point (see ``ops.launch_counts``).
LAUNCHES = {"mask_scores_anomaly": 0, "mask_scores_semantic": 0}

MAX_CLASSES = 32  # K accumulators per thread in the kernel


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
    """Mask2Anomaly per-pixel score ``1 - max_k (softmax x sigmoid)`` -> [B, H, W]."""
    sem = mask2former_semantic_logits(class_logits_ood, mask_logits_ood)
    return 1.0 - sem.max(dim=-1).values


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
                            out_hw: Tuple[int, int]) -> torch.Tensor:
    """Anomaly score at ``out_hw`` from low-resolution mask logits -> [N, H, W]."""
    if mask_logits_ood.device.type == "cpu":
        return anomaly_score_upsampled_plain(class_logits_ood, mask_logits_ood, out_hw)
    _refuse_grad("anomaly_score_upsampled", class_logits_ood, mask_logits_ood)
    probs = torch.softmax(class_logits_ood.float(), dim=-1)[..., :-1].contiguous()
    return _mask_scores_cuda(mask_logits_ood, probs, None, out_hw)


def anomaly_score_upsampled_plain(class_logits_ood, mask_logits_ood, out_hw):
    """Plain version of :func:`anomaly_score_upsampled`: resize, then score."""
    up = resize_bilinear_nchw(mask_logits_ood.float(), out_hw, align_corners=False)
    return mask2former_anomaly_score(class_logits_ood, up)


def semantic_inference_upsampled(class_logits: torch.Tensor, mask_logits: torch.Tensor,
                                 out_hw: Tuple[int, int],
                                 num_classes: int = 19) -> torch.Tensor:
    """Semantic inference at ``out_hw`` from low-resolution mask logits
    -> [N, K + Q, H, W]."""
    if class_logits.shape[-1] != num_classes + 1:
        raise ValueError(f"class logits have {class_logits.shape[-1]} entries, "
                         f"expected num_classes + 1 = {num_classes + 1}")
    if mask_logits.device.type == "cpu":
        return semantic_inference_upsampled_plain(class_logits, mask_logits, out_hw,
                                                  num_classes)
    _refuse_grad("semantic_inference_upsampled", class_logits, mask_logits)
    probs = torch.softmax(class_logits.float(), dim=-1)[..., :-1].contiguous()
    keep = keep_weights(class_logits, num_classes).contiguous()
    return _mask_scores_cuda(mask_logits, probs, keep, out_hw)


def semantic_inference_upsampled_plain(class_logits, mask_logits, out_hw,
                                       num_classes=19):
    """Plain version of :func:`semantic_inference_upsampled`: resize, then score."""
    up = resize_bilinear_nchw(mask_logits.float(), out_hw, align_corners=False)
    return semantic_inference(class_logits, up, num_classes)


def _refuse_grad(name, *tensors):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the score-tail kernel has no backward yet; "
                           "run it under torch.no_grad()")


def _mask_scores_cuda(masks, probs, keep, out_hw):
    semantic = keep is not None
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
    tensors = (masks, probs) + ((keep,) if semantic else ())
    if any(t.device != masks.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    H, W = (int(v) for v in out_hw)
    from .._build import load

    lib = load("mask_scores")
    fn = lib.mask_scores_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    shape = (n, k + q, H, W) if semantic else (n, H, W)
    out = torch.empty(shape, dtype=torch.float32, device=masks.device)
    with torch.cuda.device(masks.device):
        stream = torch.cuda.current_stream(masks.device).cuda_stream
        rc = fn(masks.data_ptr(), probs.data_ptr(),
                keep.data_ptr() if semantic else None, out.data_ptr(),
                n, q, k, h, w, H, W, int(semantic), stream)
    if rc != 0:
        raise RuntimeError(f"mask_scores_forward failed: cudaError {rc}")
    LAUNCHES["mask_scores_semantic" if semantic else "mask_scores_anomaly"] += 1
    return out
