"""Evaluation datasets: RoadAnomaly, SMIYC RoadAnomaly21 / RoadObstacle21, MUAD,
ACDC-POC, and Cityscapes val.

Counterpart of ``multishiftseg_tpu/data/anomaly.py`` (the reference's
``lib/dataset/anomaly.py:15-385``) on numpy and PIL, with the same file layouts
and label rules: 0 = in-distribution, 1 = OOD, 255 = void. MUAD, ACDC-POC and
Cityscapes val also return a closed-set target for mIoU.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional

import numpy as np

from .io import decode
from .transforms import Compose, Sample


def _rgb(a: np.ndarray) -> np.ndarray:
    if a.ndim == 2:
        return np.repeat(a[..., None], 3, axis=-1)
    return a[..., :3]


def _gray(a: np.ndarray) -> np.ndarray:
    """L-mode conversion: PIL uses ITU-R 601-2 weights for RGB label files."""
    if a.ndim == 2:
        return a.astype(np.uint8)
    return (a[..., 0] * 299 / 1000 + a[..., 1] * 587 / 1000 + a[..., 2] * 114 / 1000).astype(np.uint8)


class _EvalDataset:
    train_id_in = 0
    train_id_out = 1
    train_id_ignore = 255
    num_eval_classes = 19

    def __init__(self, transform: Optional[Compose] = None, seed: int = 0):
        self.transform = transform
        self.rng = np.random.default_rng(seed)
        self.images: List[str] = []
        self.targets: List[str] = []

    def __len__(self):
        return len(self.images)

    def _apply(self, image: np.ndarray, target: np.ndarray):
        if self.transform is not None:
            s = self.transform(self.rng, Sample(image, target.astype(np.int32)))
            return s.image, s.mask
        return image, target

    def __getitem__(self, i: int):
        image = _rgb(decode(self.images[i]))
        target = _gray(decode(self.targets[i]))
        image, target = self._apply(image, target)
        f_name = os.path.splitext(os.path.basename(self.images[i]))[0]
        return image, target, f_name


class RoadAnomaly(_EvalDataset):
    """RoadAnomaly: jpg images + label pngs (reference anomaly.py:15-72)."""

    def __init__(self, root="./datasets/road_anomaly", transform=None):
        super().__init__(transform)
        for filename in sorted(os.listdir(os.path.join(root, "original"))):
            if os.path.splitext(filename)[1] == ".jpg":
                f = os.path.splitext(filename)[0]
                self.images.append(os.path.join(root, "original", f + ".jpg"))
                self.targets.append(os.path.join(root, "labels", f + ".png"))


class RoadAnomaly21(_EvalDataset):
    """SMIYC AnomalyTrack validation split — keeps only labelled images
    (reference anomaly.py:75-141)."""

    def __init__(self, root="./datasets/dataset_AnomalyTrack", transform=None):
        super().__init__(transform)
        for filename in sorted(os.listdir(os.path.join(root, "images"))):
            if os.path.splitext(filename)[1] == ".jpg":
                f = os.path.splitext(filename)[0]
                label = os.path.join(root, "labels_masks", f + "_labels_semantic.png")
                if not os.path.exists(label):
                    continue
                self.images.append(os.path.join(root, "images", f + ".jpg"))
                self.targets.append(label)


class RoadObstacle21(_EvalDataset):
    """SMIYC ObstacleTrack (webp); optional void->in remap
    (reference anomaly.py:144-215)."""

    def __init__(self, root="./datasets/dataset_ObstacleTrack", transform=None,
                 no_void=False):
        super().__init__(transform)
        self.no_void = no_void
        for filename in sorted(os.listdir(os.path.join(root, "images"))):
            if os.path.splitext(filename)[1] == ".webp":
                f = os.path.splitext(filename)[0]
                label = os.path.join(root, "labels_masks", f + "_labels_semantic.png")
                if not os.path.exists(label):
                    continue
                self.images.append(os.path.join(root, "images", f + ".webp"))
                self.targets.append(label)

    def __getitem__(self, i):
        image, target, f_name = super().__getitem__(i)
        if self.no_void:
            target = np.where(target == self.train_id_ignore, self.train_id_in, target)
        return image, target, f_name


class MUAD(_EvalDataset):
    """MUAD OOD test set: ids 19/20 -> OOD, >=19 void in the closed-set target
    (reference anomaly.py:218-251). Returns (img, ood_gt, f_name, eval_gt)."""

    def __init__(self, root="./datasets/MUAD_challenge/test_sets/test_OOD", transform=None):
        super().__init__(transform)
        self.images = sorted(glob.glob(os.path.join(root, "leftImg8bit", "*.png")))
        self.targets = [p.replace("leftImg8bit", "leftLabel") for p in self.images]

    def __getitem__(self, i):
        img = decode(self.images[i])
        gt = decode(self.targets[i]).astype(np.int32)
        img, gt = self._apply(img, gt)
        ood_gt = np.zeros_like(gt)
        ood_gt[gt <= 18] = 0
        ood_gt[(gt == 19) | (gt == 20)] = 1
        ood_gt[gt == 255] = 255
        eval_gt = np.where(gt >= 19, 255, gt)
        f_name = os.path.splitext(os.path.basename(self.images[i]))[0]
        return img, ood_gt, f_name, eval_gt


class ACDC_POC(_EvalDataset):
    """ACDC place-of-crash variant over 4 weather domains: id > 33 -> OOD
    (reference anomaly.py:254-385). Returns (img, ood_gt, f_name, eval_gt)."""

    trainId2evalId = [
        (7, 0), (8, 1), (11, 2), (12, 3), (13, 4), (17, 5), (19, 6), (20, 7),
        (21, 8), (22, 9), (23, 10), (24, 11), (25, 12), (26, 13), (27, 14),
        (28, 15), (31, 16), (32, 17), (33, 18),
    ]

    def __init__(self, root="./datasets/acdc_ood/", transform=None, splits=None,
                 domains=None):
        super().__init__(transform)
        domains = domains or ["fog", "rain", "snow", "night"]
        splits = splits or ["val"]
        assert splits == ["val"], "ACDC_POC only supports the validation split"
        img_root = os.path.join(root, "rgb_anon_trainvaltest", "rgb_anon")
        gt_root = os.path.join(root, "gt_trainval", "gt")
        for domain in domains:
            self.images += sorted(
                glob.glob(os.path.join(img_root, domain, splits[0], "*", "*.png"))
            )
            self.targets += sorted(
                glob.glob(os.path.join(gt_root, domain, splits[0], "*", "*.png"))
            )

    def __getitem__(self, i):
        # the acdc_ood layout pairs one same-named gt png per image; the
        # reference asserts this per item (anomaly.py:363) — keep the loud
        # failure rather than silently misaligning on a stock ACDC tree
        # (whose gt dirs hold several pngs per frame)
        assert os.path.basename(self.images[i]) == os.path.basename(self.targets[i]), (
            self.images[i], self.targets[i])
        image = _rgb(decode(self.images[i]))
        target = _gray(decode(self.targets[i])).astype(np.int32)
        image, target = self._apply(image, target)
        ood_gt = np.zeros_like(target)
        ood_gt[target == 0] = 255
        ood_gt[target > 33] = 1
        target = np.where(target > 33, 255, target)
        eval_gt = np.full_like(target, 255)
        for train_id, eval_id in self.trainId2evalId:
            eval_gt[target == train_id] = eval_id
        f_name = os.path.splitext(os.path.basename(self.images[i]))[0]
        return image, ood_gt, f_name, eval_gt


EVAL_DATASETS = {
    "RoadAnomaly": RoadAnomaly,
    "RoadAnomaly21": RoadAnomaly21,
    "RoadObstacle21": RoadObstacle21,
    "MUAD": MUAD,
    "ACDC_POC": ACDC_POC,
}


class CityscapesVal(_EvalDataset):
    """Closed-set Cityscapes val split for mIoU evaluation (the reference's
    ``hist_info``/``compute_metric`` machinery target, ``lib/utils/metric.py:10-64``).

    Returns (img, ood_gt=zeros, f_name, eval_gt=trainIds) so the shared evaluator's
    mIoU path applies; OOD metrics are skipped (no positive pixels).
    """

    def __init__(self, root="./datasets/cityscapes", transform=None):
        super().__init__(transform)
        img_dir = os.path.join(root, "leftImg8bit", "val")
        gt_dir = os.path.join(root, "gtFine", "val")
        if os.path.isdir(img_dir):
            for city in sorted(os.listdir(img_dir)):
                for fname in sorted(os.listdir(os.path.join(img_dir, city))):
                    if not fname.endswith(".png"):
                        continue
                    stem = fname.split("_leftImg8bit")[0]
                    self.images.append(os.path.join(img_dir, city, fname))
                    self.targets.append(
                        os.path.join(gt_dir, city, f"{stem}_gtFine_labelTrainIds.png")
                    )

    def __getitem__(self, i):
        image = _rgb(decode(self.images[i]))
        target = decode(self.targets[i]).astype(np.int32)
        image, target = self._apply(image, target)
        ood_gt = np.zeros_like(target)
        f_name = os.path.splitext(os.path.basename(self.images[i]))[0]
        return image, ood_gt, f_name, target


EVAL_DATASETS["CityscapesVal"] = CityscapesVal
