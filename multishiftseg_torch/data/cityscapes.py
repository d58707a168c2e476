"""DiverseCityscapes: the paired clean / CG-Aug-generated Cityscapes train set.

Counterpart of ``multishiftseg_tpu/data/cityscapes.py`` (:32-193), with its own
copy of the Cityscapes label table. Each clean frame is paired at
``__init__`` with one generated variant, drawn from the files that
``glob.glob`` finds for its stem, one draw a frame in sorted city and file
order; the COCO cut-out bank comes from ``oodclass_nocrowd_seg_train2017``.
``__getitem__`` returns ``(image, target, gen_image, gen_target)`` after the
mixup of the clean image into the generated one, the shared transform, and
the anomaly paste into the clean image, in that order, all drawing from one
generator per (seed, epoch, index).
"""

from __future__ import annotations

import glob
import os
from collections import namedtuple
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .anomaly_mix import mixup_generated, paste_coco_objects
from .native_io import decode_batch
from .transforms import Compose, Sample

CityscapesClass = namedtuple(
    "CityscapesClass",
    ["name", "id", "train_id", "category", "category_id", "has_instances",
     "ignore_in_eval", "color"],
)

# the Cityscapes label table (cityscapesScripts labels.py)
LABELS = [
    CityscapesClass("unlabeled", 0, 255, "void", 0, False, True, (0, 0, 0)),
    CityscapesClass("ego vehicle", 1, 255, "void", 0, False, True, (0, 0, 0)),
    CityscapesClass("rectification border", 2, 255, "void", 0, False, True, (0, 0, 0)),
    CityscapesClass("out of roi", 3, 255, "void", 0, False, True, (0, 0, 0)),
    CityscapesClass("static", 4, 255, "void", 0, False, True, (0, 0, 0)),
    CityscapesClass("dynamic", 5, 255, "void", 0, False, True, (111, 74, 0)),
    CityscapesClass("ground", 6, 255, "void", 0, False, True, (81, 0, 81)),
    CityscapesClass("road", 7, 0, "flat", 1, False, False, (128, 64, 128)),
    CityscapesClass("sidewalk", 8, 1, "flat", 1, False, False, (244, 35, 232)),
    CityscapesClass("parking", 9, 255, "flat", 1, False, True, (250, 170, 160)),
    CityscapesClass("rail track", 10, 255, "flat", 1, False, True, (230, 150, 140)),
    CityscapesClass("building", 11, 2, "construction", 2, False, False, (70, 70, 70)),
    CityscapesClass("wall", 12, 3, "construction", 2, False, False, (102, 102, 156)),
    CityscapesClass("fence", 13, 4, "construction", 2, False, False, (190, 153, 153)),
    CityscapesClass("guard rail", 14, 255, "construction", 2, False, True, (180, 165, 180)),
    CityscapesClass("bridge", 15, 255, "construction", 2, False, True, (150, 100, 100)),
    CityscapesClass("tunnel", 16, 255, "construction", 2, False, True, (150, 120, 90)),
    CityscapesClass("pole", 17, 5, "object", 3, False, False, (153, 153, 153)),
    CityscapesClass("polegroup", 18, 255, "object", 3, False, True, (153, 153, 153)),
    CityscapesClass("traffic light", 19, 6, "object", 3, False, False, (250, 170, 30)),
    CityscapesClass("traffic sign", 20, 7, "object", 3, False, False, (220, 220, 0)),
    CityscapesClass("vegetation", 21, 8, "nature", 4, False, False, (107, 142, 35)),
    CityscapesClass("terrain", 22, 9, "nature", 4, False, False, (152, 251, 152)),
    CityscapesClass("sky", 23, 10, "sky", 5, False, False, (70, 130, 180)),
    CityscapesClass("person", 24, 11, "human", 6, True, False, (220, 20, 60)),
    CityscapesClass("rider", 25, 12, "human", 6, True, False, (255, 0, 0)),
    CityscapesClass("car", 26, 13, "vehicle", 7, True, False, (0, 0, 142)),
    CityscapesClass("truck", 27, 14, "vehicle", 7, True, False, (0, 0, 70)),
    CityscapesClass("bus", 28, 15, "vehicle", 7, True, False, (0, 60, 100)),
    CityscapesClass("caravan", 29, 255, "vehicle", 7, True, True, (0, 0, 90)),
    CityscapesClass("trailer", 30, 255, "vehicle", 7, True, True, (0, 0, 110)),
    CityscapesClass("train", 31, 16, "vehicle", 7, True, False, (0, 80, 100)),
    CityscapesClass("motorcycle", 32, 17, "vehicle", 7, True, False, (0, 0, 230)),
    CityscapesClass("bicycle", 33, 18, "vehicle", 7, True, False, (119, 11, 32)),
    CityscapesClass("license plate", -1, -1, "vehicle", 7, False, True, (0, 0, 142)),
]

NUM_TRAIN_IDS = 19
ID_TO_TRAIN_ID = np.full(256, 255, np.uint8)
for _l in LABELS:
    if _l.id >= 0:
        ID_TO_TRAIN_ID[_l.id] = _l.train_id if _l.train_id >= 0 else 255


def _target_suffix(mode: str, target_type: str) -> str:
    return {
        "instance": f"{mode}_instanceIds.png",
        "semantic_id": f"{mode}_labelIds.png",
        "semantic_train_id": f"{mode}_labelTrainIds.png",
        "color": f"{mode}_color.png",
    }[target_type]


class DiverseCityscapes:
    def __init__(
        self,
        root: str = "./datasets/cityscapes",
        generation_root: str = "./datasets/DTWP_ADE_final",
        coco_root: str = "./datasets/coco/coco2017",
        split: str = "val",
        mode: str = "gtFine_labelIds",
        target_type: str = "semantic_train_id",
        transform: Optional[Compose] = None,
        anomaly_mix: bool = False,
        mixup: bool = False,
        ood_scale_array: Sequence[float] = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0),
        seed: int = 0,
    ):
        self.transform = transform
        self.anomaly_mix = anomaly_mix
        self.mixup = mixup
        self.ood_scale_array = list(ood_scale_array)
        self.seed = seed
        self._epoch = 0
        # the pairing draws happen here, single-threaded; __getitem__ makes its
        # own generator per (epoch, index), as the loader fetches from threads
        self.rng = np.random.default_rng(seed)
        gtmode = "gtFine" if "fine" in mode.lower() else "gtCoarse"

        images_dir = os.path.join(root, "leftImg8bit", split)
        targets_dir = os.path.join(root, gtmode, split)
        gen_img_dir = os.path.join(generation_root, "leftImg8bit", split)
        gen_target_dir = os.path.join(generation_root, "gtFine", split)

        self.images: List[str] = []
        self.targets: List[str] = []
        self.generated_images: List[str] = []
        self.generated_targets: List[str] = []

        suffix = _target_suffix(gtmode, target_type)
        for city in sorted(os.listdir(images_dir)):
            for fname in sorted(os.listdir(os.path.join(images_dir, city))):
                if fname.endswith(".txt"):
                    continue
                stem = "_".join(fname.split("_")[:3])
                matches = glob.glob(os.path.join(gen_img_dir, city, stem + "*"))
                if not matches:
                    continue
                pick = matches[int(self.rng.integers(len(matches)))]
                gen_fname = os.path.basename(pick)
                tname = f"{fname.split('_leftImg8bit')[0]}_{suffix}"
                gen_tname = f"{gen_fname.split('_leftImg8bit')[0]}_{suffix}"
                self.images.append(os.path.join(images_dir, city, fname))
                self.targets.append(os.path.join(targets_dir, city, tname))
                self.generated_images.append(pick)
                self.generated_targets.append(os.path.join(gen_target_dir, city, gen_tname))

        self.coco_images: List[str] = []
        self.coco_targets: List[str] = []
        coco_targets_dir = os.path.join(coco_root, "annotations",
                                        "oodclass_nocrowd_seg_train2017")
        coco_images_dir = os.path.join(coco_root, "train2017")
        if os.path.isdir(coco_targets_dir):
            for r, _, filenames in os.walk(coco_targets_dir):
                for filename in sorted(filenames):
                    if os.path.splitext(filename)[-1] == ".png":
                        self.coco_targets.append(os.path.join(r, filename))
                        self.coco_images.append(os.path.join(
                            coco_images_dir, filename.split("_")[1].split(".")[0] + ".jpg"))

    def __len__(self) -> int:
        return len(self.images)

    def set_epoch(self, epoch: int) -> None:
        """Select the epoch's augmentation draws."""
        self._epoch = epoch

    def __getitem__(self, index: int) -> Tuple[np.ndarray, ...]:
        rng = np.random.default_rng((self.seed * 100003 + self._epoch) * 1000003 + index)
        image, gen_image, target, gen_target = decode_batch([
            self.images[index], self.generated_images[index],
            self.targets[index], self.generated_targets[index],
        ])
        target = target.astype(np.uint8)
        gen_target = gen_target.astype(np.uint8)
        if self.mixup:
            gen_image = mixup_generated(image, gen_image, rng)
        s = Sample(image, target.astype(np.int32), gen_image, gen_target.astype(np.int32))
        if self.transform is not None:
            s = self.transform(rng, s)
        if self.anomaly_mix and self.coco_images:
            s.image, s.mask = paste_coco_objects(s.image, s.mask, self.coco_images,
                                                 self.coco_targets, self.ood_scale_array, rng)
        return s.image, s.mask, s.gen_image, s.gen_mask
