"""Dataset mappers for the panoptic / instance / COCO task variants: annotation
encodings -> per-segment ``(classes, id map)`` training targets.

A copy of ``multishiftseg_tpu/data/mappers.py`` (numpy only), kept in the port
so that it imports nothing of the JAX package: ``SegmentTargets``,
``segments_to_masks``, ``semantic_/panoptic_/instance_to_targets``, ``rgb2id``,
``remap_classes``, ``coco_annotations_to_targets`` and ``targets_to_semantic``.
A target is a segment **id map** [H, W] (-1 = ignore) plus parallel
``classes`` / ``is_thing`` vectors; dense [K, H, W] mask stacks are made only on
demand (``segments_to_masks``), and ``padded`` fixes K for batching.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

IGNORE_LABEL = 255


@dataclass
class SegmentTargets:
    """Per-image mask-classification targets.

    id_map: [H, W] int32, value k means pixel belongs to segment k (-1 = ignore).
    classes: [K] int64 semantic class per segment.
    is_thing: [K] bool (instances True, stuff False).
    """

    id_map: np.ndarray
    classes: np.ndarray
    is_thing: np.ndarray

    def masks(self) -> np.ndarray:
        return segments_to_masks(self.id_map, len(self.classes))

    def padded(self, k_max: int) -> "SegmentTargets":
        """Pad to a fixed segment count (class -1 = empty slot) for static shapes."""
        k = len(self.classes)
        assert k <= k_max, (k, k_max)
        return SegmentTargets(
            id_map=self.id_map,
            classes=np.concatenate([self.classes, -np.ones(k_max - k, np.int64)]),
            is_thing=np.concatenate([self.is_thing, np.zeros(k_max - k, bool)]),
        )


def segments_to_masks(id_map: np.ndarray, num_segments: int) -> np.ndarray:
    """[H, W] id map -> [K, H, W] binary masks."""
    return np.stack(
        [(id_map == k) for k in range(num_segments)], axis=0
    ) if num_segments else np.zeros((0,) + id_map.shape, bool)


def semantic_to_targets(
    sem_seg: np.ndarray, ignore_label: int = IGNORE_LABEL
) -> SegmentTargets:
    """Semantic label map -> one segment per present class
    (``MaskFormerSemanticDatasetMapper``'s target build, ``:281-303``)."""
    classes = np.unique(sem_seg)
    classes = classes[classes != ignore_label].astype(np.int64)
    id_map = -np.ones(sem_seg.shape, np.int32)
    for k, c in enumerate(classes):
        id_map[sem_seg == c] = k
    return SegmentTargets(id_map, classes, np.zeros(len(classes), bool))


def panoptic_to_targets(
    pan_seg: np.ndarray,
    segments_info: Sequence[Dict],
    thing_ids: Optional[Sequence[int]] = None,
) -> SegmentTargets:
    """COCO-panoptic encoding -> targets (``MaskFormerPanopticDatasetMapper``).

    pan_seg: [H, W] segment-id map (decode RGB pngs with :func:`rgb2id` first).
    segments_info: [{"id", "category_id", "iscrowd"?, "isthing"?}, ...]; crowd
    segments are dropped like the reference.
    """
    classes: List[int] = []
    thing: List[bool] = []
    id_map = -np.ones(pan_seg.shape, np.int32)
    for info in segments_info:
        if info.get("iscrowd", 0):
            continue
        k = len(classes)
        id_map[pan_seg == info["id"]] = k
        classes.append(int(info["category_id"]))
        if "isthing" in info:
            thing.append(bool(info["isthing"]))
        else:
            thing.append(thing_ids is not None and info["category_id"] in thing_ids)
    return SegmentTargets(
        id_map, np.asarray(classes, np.int64), np.asarray(thing, bool)
    )


def rgb2id(color: np.ndarray) -> np.ndarray:
    """COCO-panoptic RGB png -> id map (id = R + G*256 + B*256^2)."""
    color = color.astype(np.int64)
    return color[..., 0] + 256 * color[..., 1] + 256 * 256 * color[..., 2]


def instance_to_targets(
    inst_map: np.ndarray, divisor: int = 1000, min_pixels: int = 1
) -> SegmentTargets:
    """Cityscapes ``instanceIds`` encoding -> targets
    (``MaskFormerInstanceDatasetMapper``): pixels with id >= divisor are instances
    of class id // divisor; smaller ids are stuff/ignore and excluded."""
    ids = np.unique(inst_map)
    ids = ids[ids >= divisor]
    classes: List[int] = []
    id_map = -np.ones(inst_map.shape, np.int32)
    for iid in ids:
        m = inst_map == iid
        if m.sum() < min_pixels:
            continue
        id_map[m] = len(classes)
        classes.append(int(iid // divisor))
    return SegmentTargets(
        id_map, np.asarray(classes, np.int64), np.ones(len(classes), bool)
    )


def remap_classes(tgt: SegmentTargets, class_map: Dict[int, int]) -> SegmentTargets:
    """Raw dataset category ids -> contiguous training ids, DROPPING segments
    whose class is absent from the map (their pixels become ignore). The
    reference does this through detectron2 metadata
    (``thing_dataset_id_to_contiguous_id`` in the cityscapes/coco loaders)."""
    keep = [i for i, c in enumerate(tgt.classes) if int(c) in class_map]
    remap = -np.ones(len(tgt.classes) + 1, np.int32)
    remap[keep] = np.arange(len(keep), dtype=np.int32)
    id_map = np.where(tgt.id_map >= 0, remap[tgt.id_map], -1).astype(np.int32)
    return SegmentTargets(
        id_map,
        np.asarray([class_map[int(tgt.classes[i])] for i in keep], np.int64),
        tgt.is_thing[keep] if len(keep) else np.zeros(0, bool),
    )


def coco_annotations_to_targets(
    annotations: Sequence[Dict], image_hw: Tuple[int, int]
) -> SegmentTargets:
    """COCO-style annotation dicts (dense ``bitmask`` or polygon-free) -> targets
    (``coco_instance_new_baseline_dataset_mapper.py`` role). Each annotation needs
    {"category_id", "segmentation": [H, W] binary array}; crowd dropped."""
    classes: List[int] = []
    id_map = -np.ones(image_hw, np.int32)
    for ann in annotations:
        if ann.get("iscrowd", 0):
            continue
        seg = np.asarray(ann["segmentation"], bool)
        assert seg.shape == tuple(image_hw), (seg.shape, image_hw)
        id_map[seg] = len(classes)
        classes.append(int(ann["category_id"]))
    return SegmentTargets(
        id_map, np.asarray(classes, np.int64), np.ones(len(classes), bool)
    )


def targets_to_semantic(
    targets: SegmentTargets, ignore_label: int = IGNORE_LABEL
) -> np.ndarray:
    """Collapse segment targets back to a semantic label map (for this package's
    point-sampling criterion, which consumes label maps directly)."""
    sem = np.full(targets.id_map.shape, ignore_label, np.int64)
    for k, c in enumerate(targets.classes):
        if c >= 0:
            sem[targets.id_map == k] = c
    return sem
