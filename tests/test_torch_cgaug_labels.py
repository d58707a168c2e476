"""PyTorch port, CG-Aug's label-space editing (``multishiftseg_torch/cgaug/
{palettes,prompts,label_ops,ade20k_source}.py``, ``generate.get_cities``)
against the JAX package's, on the CPU: the same ``np.random.Generator`` seeds
give the same labels, masks, prompts and samples bit for bit, and leave the
generators in the same state. The port rescales the pasted object with
OpenCV's ``INTER_NEAREST`` rule for ``fx`` / ``fy`` without OpenCV
(``data/image_ops.py::resize_nearest_scale``), held here against ``cv2``
where that rule and the ratio of the sizes pick different pixels.
"""

import pickle

import cv2
import numpy as np
import pytest
from PIL import Image

from multishiftseg_tpu.cgaug import ade20k_source as jade
from multishiftseg_tpu.cgaug import generate as jgenerate
from multishiftseg_tpu.cgaug import label_ops as jlabel
from multishiftseg_tpu.cgaug import palettes as jpal
from multishiftseg_tpu.cgaug import prompts as jprompts

from multishiftseg_torch.cgaug import ade20k_source, generate, label_ops, palettes, prompts
from multishiftseg_torch.data.image_ops import resize_nearest, resize_nearest_scale

SEEDS = (0, 1, 2, 3, 7, 11)


def city_label(seed, h=300, w=400):
    """A seeded Cityscapes colour label: sky over road, with blocks of other
    classes' colours (some on the road) and a few unknown colours."""
    g = np.random.RandomState(seed)
    lbl = np.zeros((h, w, 3), np.uint8)
    lbl[:] = (70, 130, 180)
    lbl[h // 2:] = (128, 64, 128)
    colours = np.asarray(jpal.CITYSCAPES_ALL_PALETTE + ((1, 2, 3), (250, 250, 250)), np.uint8)
    for _ in range(12):
        y, x = g.randint(0, h - 20), g.randint(0, w - 20)
        lbl[y:y + g.randint(5, 40), x:x + g.randint(5, 60)] = colours[g.randint(len(colours))]
    return lbl


def object_mask(seed):
    g = np.random.RandomState(100 + seed)
    h, w = g.randint(20, 120, 2)
    m = (g.rand(h, w) < 0.6).astype(np.uint8)
    m[g.randint(h), :] = 1
    return m


def test_palettes_are_jax_tables():
    for name in ("CITYSCAPES_ALL_CLASSES", "CITYSCAPES_ALL_PALETTE", "ADE20K_CLASSES",
                 "ADE20K_PALETTE", "CITY2ADE_CATEGORY"):
        assert getattr(palettes, name) == getattr(jpal, name), name
    for c in ("road", "sofa", "animal"):
        assert np.array_equal(palettes.ade20k_color(c), jpal.ade20k_color(c))


@pytest.mark.parametrize("seed", SEEDS)
def test_cityscapes_to_ade20k_matches_jax(seed):
    lbl = city_label(seed)
    got, present = label_ops.cityscapes_to_ade20k(lbl)
    want, jpresent = jlabel.cityscapes_to_ade20k(lbl)
    assert present == jpresent and np.array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_paste_anomaly_matches_jax(seed):
    """Label, final mask and the generator's state after the draws; at the
    reference's 200-500 px and at a scaled range, and on a label with no road
    inside the first margins (the margin shrinks)."""
    ade, _ = jlabel.cityscapes_to_ade20k(city_label(seed))
    narrow = ade.copy()
    narrow[:-12] = jpal.ade20k_color("sky")
    for label, lo, hi in ((ade, 200, 500), (ade, 40, 120), (narrow, 30, 60)):
        rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
        got = label_ops.paste_anomaly(label, object_mask(seed), "animal", rng, lo, hi)
        want = jlabel.paste_anomaly(label, object_mask(seed), "animal", jrng, lo, hi)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        assert got[1].sum() > 0
        assert rng.bit_generator.state == jrng.bit_generator.state


@pytest.mark.parametrize("seed", SEEDS)
def test_get_prompt_matches_jax(seed):
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    for i in range(20):
        ood = None if i % 3 == 0 else "sofa"
        got = prompts.get_prompt(prompts.DEFAULT_WEATHERS, prompts.DEFAULT_PLACES, rng, ood)
        want = jprompts.get_prompt(jprompts.DEFAULT_WEATHERS, jprompts.DEFAULT_PLACES, jrng, ood)
        assert got == want


def test_nearest_scale_rule_matches_opencv():
    """``cv2.resize(crop, (0, 0), fx=s, fy=s, INTER_NEAREST)`` at the paste's
    scales: the size rounded, each pixel through 1 / s. The ratio of the
    sizes (``resize_nearest``) picks other rows or columns in many of them."""
    g = np.random.default_rng(0)
    differ = 0
    for _ in range(400):
        h, w = g.integers(5, 600, 2)
        crop = (g.random((h, w)) < 0.5).astype(np.uint8)
        scale = max(min(500, max(h, w)), 200) / max(h, w)
        want = cv2.resize(crop, (0, 0), fx=scale, fy=scale, interpolation=cv2.INTER_NEAREST)
        got = resize_nearest_scale(crop, scale, scale)
        assert got.shape == want.shape and np.array_equal(got, want), (h, w, scale)
        differ += not np.array_equal(resize_nearest(crop, want.shape), want)
    assert differ > 50
    colour = g.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    for fx, fy in ((0.37, 1.9), (2.5, 0.5), (1.0, 1.0)):
        want = cv2.resize(colour, (0, 0), fx=fx, fy=fy, interpolation=cv2.INTER_NEAREST)
        assert np.array_equal(resize_nearest_scale(colour, fx, fy), want)


ADE_CLASSES = ("sofa", "bicycle", "wall", "road", "animal", "lamp")


def write_ade_tree(root, seed, images=4):
    """A synthetic ADE20K 2021 layout under ``root``: ``index_ade20k.pkl``,
    ``ADE_class_mapping.pkl`` (fine id -> 1-based semantic id) and
    ``*_seg.png`` files whose R // 10 * 256 + G encodes fine ids of several
    classes, OOD and not; one indexed image has no seg file."""
    g = np.random.RandomState(seed)
    (root / "ADE20K_2021_17_01").mkdir(parents=True)
    (root / "images").mkdir()
    fine = {c: 300 + 17 * i for i, c in enumerate(ADE_CLASSES)}
    mapping = {f: jpal.ADE20K_CLASSES.index(c) + 1 for c, f in fine.items()}
    mapping[0] = 0
    names = []
    for i in range(images):
        seg = np.zeros((60, 80, 3), np.uint8)
        for c in g.choice(ADE_CLASSES, 3, replace=False):
            y, x = g.randint(0, 40), g.randint(0, 50)
            f = fine[c]
            seg[y:y + g.randint(8, 20), x:x + g.randint(8, 30)] = (f // 256 * 10, f % 256, 0)
        name = f"img{i}.jpg"
        Image.fromarray(seg).save(root / "images" / name.replace(".jpg", "_seg.png"))
        names.append(name)
    names.append("missing.jpg")
    with open(root / "ADE20K_2021_17_01" / "index_ade20k.pkl", "wb") as f:
        pickle.dump({"filename": names, "folder": ["images"] * len(names)}, f)
    with open(root / "ADE_class_mapping.pkl", "wb") as f:
        pickle.dump(mapping, f)
    return root


@pytest.mark.parametrize("seed", (0, 5))
def test_ade20k_source_matches_jax(tmp_path, seed):
    root = str(write_ade_tree(tmp_path / "ade", seed))
    src, jsrc = ade20k_source.ADE20KAnomalySource(root), jade.ADE20KAnomalySource(root)
    assert src.ood_classes_idx == jsrc.ood_classes_idx and src.size == jsrc.size == 5
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(12):
        mask, name = src.sample(rng)
        jmask, jname = jsrc.sample(jrng)
        assert name == jname and name in ADE_CLASSES and np.array_equal(mask, jmask)
    with pytest.raises(FileNotFoundError, match="mapping"):
        ade20k_source.ADE20KAnomalySource(root, class_mapping_path=str(tmp_path / "none.pkl"))


def test_get_cities_matches_jax():
    assert generate.CITY_BATCHES == jgenerate.CITY_BATCHES
    for split, batch in (("train", 0), ("train", 3), ("val", 0)):
        assert generate.get_cities(split, batch) == jgenerate.get_cities(split, batch)
