"""ADE20K-backed anomaly source for CG-Aug.

Behavioural port of ``prepare_ADE20k`` + the sampling loop of
``paste_anomalies_ade`` (``CGAug/generation_utils.py:32-56,214-259``): read the
official ``index_ade20k.pkl``, keep objects that are present-and-not-part, map the
3000+ fine-grained classes onto the 150 semantic categories, restrict to an OOD class
list, and sample (object mask, class name) pairs from the ``*_seg.png`` annotations
(R//10*256 + G encodes the fine class; masks are exact color matches).
Counterpart of ``multishiftseg_tpu/cgaug/ade20k_source.py``: the same index,
mapping and ``np.random.Generator`` give the same (mask, class) samples.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional, Tuple

import numpy as np
from PIL import Image

from .palettes import ADE20K_CLASSES

# Default OOD-capable semantic categories (objects plausible as road anomalies) used
# when no explicit ood-class pickle is given.
DEFAULT_OOD_CLASSES = (
    "bed ", "cabinet", "sofa", "chair", "armchair", "seat", "desk", "wardrobe",
    "lamp", "bathtub", "cushion", "box", "chest of drawers", "counter", "sink",
    "refrigerator", "case", "pool table", "pillow", "bookcase", "coffee table",
    "toilet", "bench", "countertop", "stove", "computer", "swivel chair", "boat",
    "arcade machine", "towel", "television receiver", "airplane", "apparel",
    "ottoman", "bottle", "buffet", "washer", "plaything", "stool", "barrel",
    "basket", "tent", "bag", "minibike", "cradle", "oven", "ball", "food", "tank",
    "microwave", "pot", "animal", "bicycle", "dishwasher", "screen", "blanket",
    "sculpture", "vase", "tray", "ashcan", "fan", "plate", "monitor", "radiator",
    "glass", "clock",
)


class ADE20KAnomalySource:
    """Samples (mask, class-name) anomalies from an ADE20K 2021 index."""

    def __init__(
        self,
        ade_root: str,
        class_mapping_path: Optional[str] = None,
        ood_class_idx_path: Optional[str] = None,
        max_tries: int = 20,
    ):
        self.ade_root = ade_root
        self.max_tries = max_tries
        index_path = os.path.join(ade_root, "ADE20K_2021_17_01", "index_ade20k.pkl")
        with open(index_path, "rb") as f:
            self.index = pickle.load(f)
        self.size = len(self.index["filename"])

        # the fine->150 class mapping is REQUIRED (the reference hard-opens
        # CGAug/static_data/ADE_class_mapping.pkl, generation_utils.py:45-46);
        # without it every fine id would map to -1 and sample() could never
        # find an object — fail loudly at construction, not per-frame
        if class_mapping_path is None:
            class_mapping_path = os.path.join(
                ade_root, "ADE_class_mapping.pkl")
        if not os.path.exists(class_mapping_path):
            raise FileNotFoundError(
                f"ADE fine->semantic class mapping not found at "
                f"{class_mapping_path} (the reference ships it as "
                f"CGAug/static_data/ADE_class_mapping.pkl — copy it next to "
                f"the ADE root or pass class_mapping_path)")
        with open(class_mapping_path, "rb") as f:
            self.class_mapping: Dict[int, int] = pickle.load(f)

        if ood_class_idx_path and os.path.exists(ood_class_idx_path):
            with open(ood_class_idx_path, "rb") as f:
                idxs = pickle.load(f)
            self.ood_classes_idx = {i - 1 for i in idxs}
        else:
            self.ood_classes_idx = {
                ADE20K_CLASSES.index(c) for c in DEFAULT_OOD_CLASSES
            }

    def sample(self, rng: np.random.Generator) -> Tuple[np.ndarray, str]:
        for _ in range(self.max_tries):
            idx = int(rng.integers(self.size))
            gt_path = os.path.join(
                self.ade_root, self.index["folder"][idx], self.index["filename"][idx]
            )
            gt_path = gt_path.split(".jpg")[0] + "_seg.png"
            if not os.path.exists(gt_path):
                continue
            gt = np.asarray(Image.open(gt_path))
            unique_rgb = np.unique(gt.reshape(-1, gt.shape[2]), axis=0)
            fine_idx = (unique_rgb[:, 0].astype(np.int32) // 10) * 256 + unique_rgb[
                :, 1
            ].astype(np.int32)
            sem_idx = [self.class_mapping.get(int(i), 0) - 1 for i in fine_idx]
            choices = [
                k for k, s in enumerate(sem_idx) if s in self.ood_classes_idx
            ]
            if not choices:
                continue
            pick = choices[int(rng.integers(len(choices)))]
            mask = np.all(gt == unique_rgb[pick], axis=2).astype(np.uint8)
            return mask, ADE20K_CLASSES[sem_idx[pick]]
        raise RuntimeError("no OOD object found after max_tries samples")
