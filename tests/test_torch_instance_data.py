"""PyTorch port, the data and evaluation side of the vanilla Mask2Former recipes
against the JAX package on the CPU: every mapper, the dataset catalog and its
folder walkers, ``clip_targets`` / ``drop_empty_segments``, ``InstanceDataset``
items for the instance, panoptic and sem_seg tasks (bit for bit), the instance
and panoptic post-processing on the same logits, both evaluators on the same
predictions (``test_torch_instance_eval.py`` holds ``TrainM2FInstance.evaluate``).

The folders come from ``tools.synthetic_tree.write_segments_tree`` at 96x128
(things as rectangles, duplicate classes, a crowd, caravans and trailers that
the recipes drop). The catalogs are process-global in each package, so every
test that registers a name removes it again.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multishiftseg_tpu.core.config import load_config as jax_load_config
from multishiftseg_tpu.data import mappers as jax_mappers
from multishiftseg_tpu.data import registry as jax_registry
from multishiftseg_tpu.evals import instance_metrics as jax_instance_metrics
from multishiftseg_tpu.evals import panoptic_metrics as jax_panoptic_metrics
from multishiftseg_tpu.models import inference_extras as jax_extras
from multishiftseg_tpu.train import instance_trainer as jax_instance_trainer

from multishiftseg_torch.core.config import load_config
from multishiftseg_torch.data import mappers, registry
from multishiftseg_torch.evals import instance_metrics, panoptic_metrics
from multishiftseg_torch.models import inference_extras as extras
from multishiftseg_torch.tools.synthetic_tree import write_segments_tree
from multishiftseg_torch.train import instance_trainer

HW = (96, 128)
TASKS = {"instance": "exps/m2f_instance.yaml", "panoptic": "exps/m2f_panoptic.yaml",
         "semantic": "exps/m2f_semantic.yaml"}


def assert_targets_equal(a, b):
    for f in ("id_map", "classes", "is_thing"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("segments")
    return write_segments_tree(root, seed=5, frames={"train": 3, "val": 2}, hw=HW,
                               things=10)["cityscapes_root"]


@pytest.fixture
def catalogs():
    """Empty catalogs in both packages for the test, and again after it."""
    def clear():
        for cat in (jax_registry.DatasetCatalog, registry.DatasetCatalog):
            for name in cat.list():
                cat.remove(name)

    clear()
    yield
    clear()


# ---------------------------------------------------------------------------
# mappers


def test_mappers_match_jax_bit_for_bit():
    rng = np.random.RandomState(0)
    sem = rng.randint(0, 6, (20, 24)).astype(np.int32)
    sem[:3] = 255
    assert_targets_equal(mappers.semantic_to_targets(sem),
                         jax_mappers.semantic_to_targets(sem))
    inst = np.where(rng.rand(20, 24) < 0.5, rng.randint(0, 30, (20, 24)),
                    1000 * rng.randint(24, 34, (20, 24)) + rng.randint(0, 3, (20, 24)))
    for min_pixels in (1, 3):
        assert_targets_equal(mappers.instance_to_targets(inst, min_pixels=min_pixels),
                             jax_mappers.instance_to_targets(inst, min_pixels=min_pixels))
    color = rng.randint(0, 256, (20, 24, 3)).astype(np.uint8)
    np.testing.assert_array_equal(mappers.rgb2id(color), jax_mappers.rgb2id(color))
    pan = rng.choice([0, 7, 24001, 24002, 26000], (20, 24))
    info = [{"id": 7, "category_id": 7}, {"id": 24001, "category_id": 24},
            {"id": 24002, "category_id": 24, "iscrowd": 1},
            {"id": 26000, "category_id": 26, "isthing": True}]
    for thing_ids in (None, [24, 26]):
        assert_targets_equal(mappers.panoptic_to_targets(pan, info, thing_ids),
                             jax_mappers.panoptic_to_targets(pan, info, thing_ids))
    tgt = jax_mappers.instance_to_targets(inst)
    class_map = {24: 0, 26: 2, 33: 7}
    assert_targets_equal(mappers.remap_classes(mappers.SegmentTargets(
        tgt.id_map, tgt.classes, tgt.is_thing), class_map),
        jax_mappers.remap_classes(tgt, class_map))
    assert_targets_equal(mappers.SegmentTargets(tgt.id_map, tgt.classes, tgt.is_thing)
                         .padded(40), tgt.padded(40))
    np.testing.assert_array_equal(mappers.segments_to_masks(tgt.id_map, 5),
                                  jax_mappers.segments_to_masks(tgt.id_map, 5))
    assert mappers.segments_to_masks(tgt.id_map, 0).shape == (0, 20, 24)
    np.testing.assert_array_equal(mappers.targets_to_semantic(tgt.padded(40)),
                                  jax_mappers.targets_to_semantic(tgt.padded(40)))
    anns = [{"category_id": 3, "segmentation": rng.rand(20, 24) > 0.7},
            {"category_id": 5, "segmentation": rng.rand(20, 24) > 0.7, "iscrowd": 1},
            {"category_id": 3, "segmentation": rng.rand(20, 24) > 0.7}]
    assert_targets_equal(mappers.coco_annotations_to_targets(anns, (20, 24)),
                         jax_mappers.coco_annotations_to_targets(anns, (20, 24)))


def test_clip_and_drop_segments_match_jax():
    rng = np.random.RandomState(1)
    id_map = rng.randint(-1, 9, (30, 30)).astype(np.int32)
    id_map[id_map == 4] = 3  # segment 4 left empty
    tgt = mappers.SegmentTargets(id_map, rng.randint(0, 8, 9).astype(np.int64),
                                 rng.rand(9) > 0.5)
    ref = jax_mappers.SegmentTargets(tgt.id_map, tgt.classes, tgt.is_thing)
    for k in (3, 9):
        assert_targets_equal(instance_trainer.clip_targets(tgt, k),
                             jax_instance_trainer.clip_targets(ref, k))
    out = instance_trainer.drop_empty_segments(tgt)
    assert_targets_equal(out, jax_instance_trainer.drop_empty_segments(ref))
    assert len(out.classes) == 8


# ---------------------------------------------------------------------------
# the catalog and the datasets


def test_registry_walkers_match_jax(tree, catalogs):
    import os

    def register(reg):
        reg.register_semantic_folder(
            "sem", image_dir=os.path.join(tree, "leftImg8bit", "train"),
            label_dir=os.path.join(tree, "gtFine", "train"), image_suffix="_leftImg8bit.png",
            label_suffix="_gtFine_labelTrainIds.png", class_names=["a", "b"])
        reg.register_instance_folder("inst", image_dir=os.path.join(tree, "leftImg8bit", "val"),
                                     instance_dir=os.path.join(tree, "gtFine", "val"))
        reg.register_panoptic_folder(
            "pan", image_dir=os.path.join(tree, "leftImg8bit", "train"),
            panoptic_dir=os.path.join(tree, "gtFine", "cityscapes_panoptic_train"),
            panoptic_json=os.path.join(tree, "gtFine", "cityscapes_panoptic_train.json"),
            thing_ids=[24, 26])
        reg.MetadataCatalog.set("inst", class_map={24: 0})

    register(registry)
    register(jax_registry)
    assert registry.DatasetCatalog.list() == jax_registry.DatasetCatalog.list() == [
        "inst", "pan", "sem"]
    for name, n in (("sem", 3), ("inst", 2), ("pan", 3)):
        recs = registry.DatasetCatalog.get(name)
        assert recs == jax_registry.DatasetCatalog.get(name) and len(recs) == n
        assert all(os.path.exists(r["file_name"]) for r in recs)
        assert registry.MetadataCatalog.get(name) == jax_registry.MetadataCatalog.get(name)
    with pytest.raises(KeyError):
        registry.register_semantic_folder("sem", image_dir=tree, label_dir=tree)
    registry.DatasetCatalog.remove("sem")
    assert "sem" not in registry.DatasetCatalog.list()


def _bare(cls, cfg, task):
    """A trainer of either package with only what its dataset methods read."""
    tr = cls.__new__(cls)
    tr.cfg, tr.task = cfg, task
    return tr


@pytest.mark.parametrize("task", list(TASKS))
def test_instance_dataset_items_match_jax(tree, catalogs, task):
    """The task's default registration and ``build_dataset`` in both packages:
    every item of two epochs bit for bit (flip, crop, targets, class map,
    clipping to 5 slots, padding)."""
    cfgs = []
    for loader in (load_config, jax_load_config):
        cfg = loader(TASKS[task])
        cfg.data.cityscapes_root = tree
        cfg.data.crop_size = (64, 96)
        cfg.model.m2f.max_instances = 5 if task != "semantic" else 20
        cfgs.append(cfg)
    ours = _bare(instance_trainer.TrainM2FInstance, cfgs[0], task)
    ref = _bare(jax_instance_trainer.TrainM2FInstance, cfgs[1], task)
    ours.dataset_name = ours._register_default()
    ref.dataset_name = ref._register_default()
    assert ours.dataset_name == ref.dataset_name == f"cityscapes_{task}_train"
    ds, ref_ds = ours.build_dataset(), ref.build_dataset()
    assert ds.task == ref_ds.task and len(ds) == len(ref_ds) == 3
    clipped = 0
    for epoch in range(2):
        ds.set_epoch(epoch)
        ref_ds.set_epoch(epoch)
        for i in range(len(ds)):
            got, want = ds[i], ref_ds[i]
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.shape == w.shape
                np.testing.assert_array_equal(g, w)
            assert got[0].shape == (64, 96, 3) and got[1].shape == (64, 96)
            assert got[1].max() < len(got[2]) and got[1].min() >= -1
            clipped += int((got[2] >= 0).all())
    if task != "semantic":
        assert clipped > 0  # some items fill all 5 slots


# ---------------------------------------------------------------------------
# post-processing and evaluators on the same inputs


def _logits(seed, q=12, k=19, hw=(40, 56)):
    """Class logits with confident queries (so that the panoptic thresholds
    keep some) and mask logits."""
    rng = np.random.RandomState(seed)
    cls = rng.randn(q, k + 1).astype(np.float32)
    cls[np.arange(q), rng.randint(0, k, q)] += np.where(rng.rand(q) < 0.7, 6.0, 0.0)
    cls[0, 2] = cls[1, 2] = 9.0  # two queries of one stuff class: merged
    # each query positive on a rectangle of its own (overlapping others), with
    # noise: some win most of their area, some too little of it
    masks = rng.randn(q, *hw).astype(np.float32) - 6.0
    for i in range(q):
        y0, x0 = rng.randint(0, hw[0] - 12), rng.randint(0, hw[1] - 12)
        masks[i, y0:y0 + rng.randint(8, 24), x0:x0 + rng.randint(8, 30)] += 12.0
    return cls, masks


def _sorted_detections(pred):
    order = np.lexsort((pred["pred_classes"], -np.asarray(pred["scores"], np.float64)))
    return {k: np.asarray(v)[order] for k, v in pred.items()}


@pytest.mark.parametrize("thing_ids", [None, {11, 12, 13, 14, 15, 16, 17, 18}])
def test_instance_inference_matches_jax(thing_ids):
    """The same detections: the sets of (class, score, mask), in score order
    (the order of torch.topk among them, not argpartition's)."""
    cls, masks = _logits(0)
    got = _sorted_detections(extras.instance_inference(
        torch.from_numpy(cls), torch.from_numpy(masks), test_topk_per_image=30,
        thing_ids=thing_ids))
    want = _sorted_detections(jax_extras.instance_inference(cls, masks, 30, thing_ids))
    np.testing.assert_array_equal(got["pred_classes"], want["pred_classes"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(got["pred_masks"], want["pred_masks"].astype(bool))
    assert got["pred_masks"].dtype == bool and len(got["scores"]) > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_panoptic_inference_matches_jax(seed):
    cls, masks = _logits(seed)
    got_seg, got_info = extras.panoptic_inference(torch.from_numpy(cls),
                                                  torch.from_numpy(masks))
    want_seg, want_info = jax_extras.panoptic_inference(cls, masks)
    assert got_seg.dtype == np.int32
    np.testing.assert_array_equal(got_seg, want_seg)
    assert got_info == want_info and len(got_info) > 0
    # no query above the threshold
    seg, info = extras.panoptic_inference(torch.from_numpy(cls), torch.from_numpy(masks),
                                          object_mask_threshold=1.0)
    assert info == [] and not seg.any()


def test_hflip_tta_matches_jax():
    img = np.random.RandomState(3).randn(2, 8, 10, 3).astype(np.float32)
    ramp = np.arange(10, dtype=np.float32)  # makes the flip visible
    got = extras.hflip_tta(lambda x: (x.permute(0, 3, 1, 2) * torch.from_numpy(ramp),
                                      x[:, 0, -1]), torch.from_numpy(img))
    want = jax_extras.hflip_tta(lambda x: (jnp.transpose(x, (0, 3, 1, 2)) * ramp, x[:, 0, -1]),
                                jnp.asarray(img))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))  # the identity's aux


def test_evaluators_match_jax():
    """Both evaluators, fed the same per-image predictions and ground truth."""
    rng = np.random.RandomState(4)
    inst, ref_inst = (instance_metrics.InstanceSegEvaluator(5),
                      jax_instance_metrics.InstanceSegEvaluator(5))
    pq, ref_pq = (panoptic_metrics.PanopticEvaluator(5, {3, 4}),
                  jax_panoptic_metrics.PanopticEvaluator(5, {3, 4}))
    for _ in range(3):
        gt_ids = rng.randint(-1, 6, (24, 32)).astype(np.int32)
        gt_cls = rng.randint(0, 5, 6)
        gt = {"masks": mappers.segments_to_masks(gt_ids, 6), "classes": gt_cls}
        n = rng.randint(0, 9)
        pred = {"masks": rng.rand(n, 24, 32) > 0.6, "scores": rng.rand(n),
                "classes": rng.randint(0, 5, n)}
        pred["masks"][: n // 2] |= gt["masks"][: n // 2]
        inst.process(pred, gt)
        ref_inst.process(pred, gt)
        pan = np.where(rng.rand(24, 32) < 0.8, gt_ids + 1, 0)
        info = [{"id": s, "category_id": int(gt_cls[(s + 1) % 6])} for s in range(1, 7)]
        gt_seg, gt_info = panoptic_metrics.targets_to_panoptic(gt_ids, gt_cls)
        ref_gt = jax_panoptic_metrics.targets_to_panoptic(gt_ids, gt_cls)
        np.testing.assert_array_equal(gt_seg, ref_gt[0])
        assert gt_info == ref_gt[1]
        pq.process(pan, info, gt_seg, gt_info)
        ref_pq.process(pan, info, gt_seg, gt_info)
    got, want = inst.evaluate(), ref_inst.evaluate()
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(np.array([got[k] for k in ("AP", "AP50", "AP75")]),
                                  np.array([want[k] for k in ("AP", "AP50", "AP75")]))
    np.testing.assert_array_equal(got["AP_per_class"], want["AP_per_class"])
    got, want = pq.evaluate(), ref_pq.evaluate()
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
