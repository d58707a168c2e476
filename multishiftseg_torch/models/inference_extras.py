"""Panoptic / instance inference and test-time augmentation on the device.

Counterpart of ``multishiftseg_tpu/models/inference_extras.py`` (the
reference's ``maskformer_model.py:356-450`` and ``SemanticSegmentorWithTTA``):

* :func:`panoptic_inference`: argmax over score-weighted masks, overlap
  filtering and the merging of stuff regions of one class;
* :func:`instance_inference`: the top-k (query, class) pairs, scored by the
  class probability times the mean mask probability inside the binary mask;
* :func:`hflip_tta`: the average over the image and its horizontal flip.

The JAX package pulls the [Q, H, W] f32 mask logits to the host and loops in
numpy (800 MB an image at 1024x2048). Here the inputs are tensors and the work
stays on their device: the panoptic loop becomes one pass of per-query areas,
a few numbers on the host to decide each query's segment id, and one lookup
that paints the map; the instance masks reach the host as the kept binary
masks alone (bool). The results are numpy, as the evaluators take them.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

# Cityscapes train-id things (instances exist): person..bicycle = 11..18.
CITYSCAPES_THING_IDS: Set[int] = {11, 12, 13, 14, 15, 16, 17, 18}


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """The JAX version's f32 softmax: shift by the max, exp, divide by the sum."""
    x = x.float()
    e = torch.exp(x - x.max(-1, keepdim=True).values)
    return e / e.sum(-1, keepdim=True)


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-x.float()))


@torch.no_grad()
def panoptic_inference(mask_cls: torch.Tensor, mask_pred: torch.Tensor,
                       thing_ids: Set[int] = CITYSCAPES_THING_IDS,
                       object_mask_threshold: float = 0.8,
                       overlap_threshold: float = 0.8) -> Tuple[np.ndarray, List[Dict]]:
    """mask_cls [Q, K+1] logits, mask_pred [Q, H, W] upsampled mask logits ->
    (panoptic_seg [H, W] int32 segment ids, segments_info).

    Query k keeps the pixels where it wins the argmax of score x mask
    probability and its own probability is >= 0.5; it becomes a segment when
    that area is at least ``overlap_threshold`` of its whole >= 0.5 area, and a
    stuff class's later queries join its first segment, in query order.
    """
    num_classes = mask_cls.shape[-1] - 1
    probs = _softmax(mask_cls)
    scores, labels = probs.max(-1)
    keep = (labels != num_classes) & (scores > object_mask_threshold)
    h, w = mask_pred.shape[-2:]
    cur_classes = labels[keep]
    if cur_classes.numel() == 0:
        return np.zeros((h, w), np.int32), []
    cur_masks = _sigmoid(mask_pred[keep])
    cur_mask_ids = (scores[keep][:, None, None] * cur_masks).argmax(0)  # [H, W]
    above = cur_masks >= 0.5
    # the pixels each query wins and holds at >= 0.5: disjoint over queries
    hit = above.gather(0, cur_mask_ids[None])[0]
    n = cur_classes.numel()
    mask_area = torch.bincount(cur_mask_ids[hit], minlength=n)
    original_area = above.flatten(1).sum(1)
    lut = np.zeros(n, np.int32)
    stuff_memory: Dict[int, int] = {}
    segments_info: List[Dict] = []
    segment_id = 0
    for k, (pred_class, area, orig) in enumerate(zip(cur_classes.tolist(), mask_area.tolist(),
                                                     original_area.tolist())):
        isthing = pred_class in thing_ids
        if area > 0 and orig > 0:
            if area / orig < overlap_threshold:
                continue
            if not isthing:
                if pred_class in stuff_memory:
                    lut[k] = stuff_memory[pred_class]
                    continue
                stuff_memory[pred_class] = segment_id + 1
            segment_id += 1
            lut[k] = segment_id
            segments_info.append({"id": segment_id, "isthing": isthing,
                                  "category_id": pred_class})
    ids = torch.from_numpy(lut).to(cur_mask_ids.device)[cur_mask_ids]
    panoptic_seg = torch.where(hit, ids, torch.zeros_like(ids))
    return panoptic_seg.cpu().numpy(), segments_info


@torch.no_grad()
def instance_inference(mask_cls: torch.Tensor, mask_pred: torch.Tensor,
                       test_topk_per_image: int = 100,
                       thing_ids: Optional[Set[int]] = None) -> Dict[str, np.ndarray]:
    """mask_cls [Q, K+1], mask_pred [Q, H, W] logits -> {'pred_masks' [T, H, W]
    bool, 'scores' [T] f32, 'pred_classes' [T] int64}: the top
    ``test_topk_per_image`` (query, class) scores, restricted to ``thing_ids``
    when given. The order among the T entries is ``torch.topk``'s (the JAX
    version's ``argpartition`` leaves it unspecified)."""
    num_classes = mask_cls.shape[-1] - 1
    flat = _softmax(mask_cls)[:, :-1].reshape(-1)
    topk = min(test_topk_per_image, flat.numel())
    scores_per_image, idx = torch.topk(flat, topk)
    labels_per_image = idx % num_classes
    query_idx = idx // num_classes
    if thing_ids is not None:
        kept = torch.isin(labels_per_image,
                          torch.tensor(sorted(thing_ids), device=labels_per_image.device))
        scores_per_image, labels_per_image = scores_per_image[kept], labels_per_image[kept]
        query_idx = query_idx[kept]
    masks = mask_pred[query_idx].float()
    binary = masks > 0
    mask_scores = ((_sigmoid(masks) * binary).flatten(1).sum(1)
                   / (binary.flatten(1).sum(1) + 1e-6))
    return {"pred_masks": binary.cpu().numpy(),
            "scores": (scores_per_image * mask_scores).cpu().numpy(),
            "pred_classes": labels_per_image.cpu().numpy()}


def hflip_tta(forward_fn: Callable, img: torch.Tensor):
    """Average semantic scores over {identity, horizontal flip}
    (``SemanticSegmentorWithTTA``). img [N, H, W, C]; forward_fn(img) ->
    sem [N, C, H, W] or a tuple (sem, aux...), the aux of the identity kept."""
    out = forward_fn(img)
    out_f = forward_fn(img.flip(2))
    sem = out[0] if isinstance(out, tuple) else out
    sem_f = out_f[0] if isinstance(out_f, tuple) else out_f
    avg = 0.5 * (sem + sem_f.flip(3))
    if isinstance(out, tuple):
        return (avg,) + tuple(out[1:])
    return avg
