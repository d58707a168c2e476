"""Dataset catalog: named dataset registration and lookup.

A copy of ``multishiftseg_tpu/data/registry.py`` (the reference's detectron2
``DatasetCatalog`` / ``MetadataCatalog`` role): one generic, process-global
catalog plus walkers of the semantic, COCO-panoptic and Cityscapes instance
folder layouts. A name registers once; ``DatasetCatalog.remove`` drops it and
its metadata.
"""

from __future__ import annotations

import glob
import os
from typing import Callable, Dict, List, Optional, Sequence

_DATASETS: Dict[str, Callable[[], List[Dict]]] = {}
_METADATA: Dict[str, Dict] = {}


class DatasetCatalog:
    """Lazy name -> list[record] registry (detectron2 ``DatasetCatalog`` role)."""

    @staticmethod
    def register(name: str, fn: Callable[[], List[Dict]]) -> None:
        if name in _DATASETS:
            raise KeyError(f"dataset {name!r} already registered")
        _DATASETS[name] = fn

    @staticmethod
    def get(name: str) -> List[Dict]:
        return _DATASETS[name]()

    @staticmethod
    def list() -> List[str]:
        return sorted(_DATASETS)

    @staticmethod
    def remove(name: str) -> None:
        _DATASETS.pop(name, None)
        _METADATA.pop(name, None)


class MetadataCatalog:
    @staticmethod
    def get(name: str) -> Dict:
        return _METADATA.setdefault(name, {"name": name})

    @staticmethod
    def set(name: str, **kwargs) -> Dict:
        md = MetadataCatalog.get(name)
        md.update(kwargs)
        return md


def _pair_records(
    image_dir: str,
    label_dir: str,
    image_suffix: str,
    label_suffix: str,
) -> List[Dict]:
    records = []
    for img in sorted(glob.glob(os.path.join(image_dir, "**", f"*{image_suffix}"),
                                recursive=True)):
        rel = os.path.relpath(img, image_dir)
        lbl = os.path.join(label_dir, rel[: -len(image_suffix)] + label_suffix)
        if os.path.exists(lbl):
            records.append({"file_name": img, "sem_seg_file_name": lbl})
    return records


def register_semantic_folder(
    name: str,
    image_dir: str,
    label_dir: str,
    image_suffix: str = ".jpg",
    label_suffix: str = ".png",
    class_names: Optional[Sequence[str]] = None,
    ignore_label: int = 255,
) -> None:
    """Generic paired image/label-map layout (the shape of the reference's
    ADE20K-full / COCO-stuff-10k / StreetHazards registrations)."""
    DatasetCatalog.register(
        name, lambda: _pair_records(image_dir, label_dir, image_suffix, label_suffix)
    )
    MetadataCatalog.set(
        name, image_dir=image_dir, label_dir=label_dir,
        class_names=list(class_names) if class_names else None,
        ignore_label=ignore_label, task="sem_seg",
    )


def register_panoptic_folder(
    name: str,
    image_dir: str,
    panoptic_dir: str,
    panoptic_json: str,
    class_names: Optional[Sequence[str]] = None,
    thing_ids: Optional[Sequence[int]] = None,
) -> None:
    """COCO-panoptic layout: images + RGB-encoded id pngs + a json with per-image
    ``segments_info`` (the reference's ade20k/coco panoptic registrations)."""

    def load() -> List[Dict]:
        import json

        with open(panoptic_json) as f:
            meta = json.load(f)
        by_image = {a["image_id"]: a for a in meta["annotations"]}
        records = []
        for img in meta["images"]:
            ann = by_image.get(img["id"])
            if ann is None:
                continue
            fn = img["file_name"]
            path = os.path.join(image_dir, fn)
            if not os.path.exists(path):
                # cityscapes layout nests images under the city subdir while
                # the panoptic json's file_name is the bare basename
                path = os.path.join(image_dir, fn.split("_")[0], fn)
            records.append({
                "file_name": path,
                "pan_seg_file_name": os.path.join(panoptic_dir, ann["file_name"]),
                "segments_info": ann["segments_info"],
                "image_id": img["id"],
            })
        return records

    DatasetCatalog.register(name, load)
    MetadataCatalog.set(
        name, image_dir=image_dir, panoptic_dir=panoptic_dir,
        class_names=list(class_names) if class_names else None,
        thing_ids=list(thing_ids) if thing_ids else None, task="panoptic",
    )


def register_instance_folder(
    name: str,
    image_dir: str,
    instance_dir: str,
    image_suffix: str = "_leftImg8bit.png",
    instance_suffix: str = "_gtFine_instanceIds.png",
    id_divisor: int = 1000,
) -> None:
    """Cityscapes-style instance-id layout
    (``class_id * divisor + instance`` encoding)."""
    DatasetCatalog.register(
        name,
        # the **r unpack evaluates BEFORE pop would run, so build the record
        # without the semantic key (a stale sem_seg_file_name aimed at the
        # instance-id png would make semantic consumers read id*1000 encodings)
        lambda: [
            {**{k: v for k, v in r.items() if k != "sem_seg_file_name"},
             "instance_file_name": r["sem_seg_file_name"]}
            for r in _pair_records(image_dir, instance_dir, image_suffix,
                                   instance_suffix)
        ],
    )
    MetadataCatalog.set(name, image_dir=image_dir, instance_dir=instance_dir,
                        id_divisor=id_divisor, task="instance")
