"""PyTorch port, the eval driver against the JAX package on the CPU.

The eval transforms, every eval dataset on a temporary folder in its layout,
``hist_info`` / ``compute_metric``, ``map2citycolor``, ``load_torch_checkpoint``
and the strict reference-weight loads, ``OODEvaluator`` against JAX's on the
same folder and score function (exact; batch 1 equal to batch 4), the
sampling-qualification gate, and ``main()`` on a tiny MaskFormer.

Images are written as PNG where the layout allows; RoadAnomaly and SMIYC
RoadAnomaly21 name JPEG files, and for those the test asserts that JAX's
``native_io.decode`` (its native library, or PIL) and the port's PIL decode
give the same pixels.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from multishiftseg_tpu.convert.torch2jax import load_torch_checkpoint as jax_load_ckpt
from multishiftseg_tpu.core.config import load_config as jax_load_config
from multishiftseg_tpu.data import anomaly as jax_anomaly
from multishiftseg_tpu.data import transforms as jax_tf
from multishiftseg_tpu.data.native_io import decode as jax_decode
from multishiftseg_tpu.evals import seg_metrics as jax_seg
from multishiftseg_tpu.train import test_runner as jax_runner
from multishiftseg_tpu.utils import map2citycolor as jax_map2citycolor

from multishiftseg_torch.convert.torch_checkpoint import load_torch_checkpoint
from multishiftseg_torch.core.config import load_config
from multishiftseg_torch.data import anomaly
from multishiftseg_torch.data import transforms as tf
from multishiftseg_torch.data.io import decode
from multishiftseg_torch.evals import seg_metrics
from multishiftseg_torch.models.deeplab import DeepWV3Plus
from multishiftseg_torch.models.maskformer import MaskFormer
from multishiftseg_torch.train import test_runner
from multishiftseg_torch.train.deeplab_trainer import TrainDeepLabOOD
from multishiftseg_torch.train.m2f_trainer import TrainM2FOOD
from multishiftseg_torch.utils import map2citycolor

from test_torch_deeplab import TINY

MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
SHAPES = ((70, 100), (64, 128), (120, 90), (70, 100), (50, 60))


def _save(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


def _rgb(rng, h, w):
    return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)


def _ood_label(rng, h, w):
    lab = np.zeros((h, w), np.uint8)
    lab[h // 4:h // 2, w // 3:2 * w // 3] = 1
    lab[rng.rand(h, w) < 0.1] = 255
    return lab


def make_tree(root, rng):
    """All six eval datasets in their on-disk layouts under ``root``."""
    roots = {k: str(root / k) for k in ("RoadAnomaly", "RoadAnomaly21", "RoadObstacle21",
                                         "MUAD", "ACDC_POC", "CityscapesVal")}
    for i, (h, w) in enumerate(SHAPES):
        _save(f"{roots['RoadAnomaly']}/original/ra{i}.jpg", _rgb(rng, h, w))
        _save(f"{roots['RoadAnomaly']}/labels/ra{i}.png", _ood_label(rng, h, w))
        _save(f"{roots['RoadAnomaly21']}/images/a{i}.jpg", _rgb(rng, h, w))
        _save(f"{roots['RoadAnomaly21']}/labels_masks/a{i}_labels_semantic.png",
              _ood_label(rng, h, w))
        _save(f"{roots['RoadObstacle21']}/images/o{i}.webp", _rgb(rng, h, w))
        _save(f"{roots['RoadObstacle21']}/labels_masks/o{i}_labels_semantic.png",
              _ood_label(rng, h, w))
        _save(f"{roots['MUAD']}/leftImg8bit/m{i}.png", _rgb(rng, h, w))
        muad = rng.randint(0, 21, (h, w)).astype(np.uint8)
        muad[rng.rand(h, w) < 0.05] = 255
        _save(f"{roots['MUAD']}/leftLabel/m{i}.png", muad)
        dom = ("fog", "night")[i % 2]
        _save(f"{roots['ACDC_POC']}/rgb_anon_trainvaltest/rgb_anon/{dom}/val/s{i}/c{i}.png",
              _rgb(rng, h, w))
        _save(f"{roots['ACDC_POC']}/gt_trainval/gt/{dom}/val/s{i}/c{i}.png",
              rng.randint(0, 40, (h, w)).astype(np.uint8))
        city = ("aachen", "bonn")[i % 2]
        _save(f"{roots['CityscapesVal']}/leftImg8bit/val/{city}/x{i}_leftImg8bit.png",
              _rgb(rng, h, w))
        cs = rng.randint(0, 19, (h, w)).astype(np.uint8)
        cs[rng.rand(h, w) < 0.05] = 255
        _save(f"{roots['CityscapesVal']}/gtFine/val/{city}/x{i}_gtFine_labelTrainIds.png", cs)
    # an AnomalyTrack image without labels is skipped
    _save(f"{roots['RoadAnomaly21']}/images/unlabelled.jpg", _rgb(rng, 40, 40))
    return roots


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    roots = make_tree(tmp_path_factory.mktemp("datasets"), np.random.RandomState(0))
    # the JPEGs decode to the same pixels through JAX's decode and PIL
    for name in ("RoadAnomaly", "RoadAnomaly21"):
        for p in anomaly.EVAL_DATASETS[name](root=roots[name]).images:
            np.testing.assert_array_equal(decode(p), jax_decode(p))
    return roots


def test_eval_transforms_match_jax():
    img = np.random.RandomState(1).randint(0, 256, (13, 17, 3)).astype(np.uint8)
    mask = np.random.RandomState(2).randint(0, 3, (13, 17))
    ours = tf.Compose([tf.ToTensor(), tf.Normalize(MEAN, STD)])(
        np.random.default_rng(0), tf.Sample(img, mask))
    ref = jax_tf.Compose([jax_tf.ToTensor(), jax_tf.Normalize(MEAN, STD)])(
        np.random.default_rng(0), jax_tf.Sample(img, mask))
    assert ours.image.dtype == np.float32 and ours.mask.dtype == np.int32
    np.testing.assert_array_equal(ours.image, ref.image)
    np.testing.assert_array_equal(ours.mask, ref.mask)
    # (transform, probability) pairs draw from the generator as JAX's do
    seq = lambda m: [(m.ToTensor(), 1.0), (m.Normalize(MEAN, STD), 0.5)]
    for seed in range(4):
        a = tf.Compose(seq(tf))(np.random.default_rng(seed), tf.Sample(img, mask))
        b = jax_tf.Compose(seq(jax_tf))(np.random.default_rng(seed), jax_tf.Sample(img, mask))
        np.testing.assert_array_equal(a.image, b.image)


@pytest.mark.parametrize("name", sorted(anomaly.EVAL_DATASETS))
def test_eval_datasets_match_jax(tree, name):
    kw = {"root": tree[name]}
    ours = anomaly.EVAL_DATASETS[name](transform=tf.Compose([tf.ToTensor(),
                                                             tf.Normalize(MEAN, STD)]), **kw)
    ref = jax_anomaly.EVAL_DATASETS[name](transform=jax_tf.Compose(
        [jax_tf.ToTensor(), jax_tf.Normalize(MEAN, STD)]), **kw)
    assert len(ours) == len(ref) == len(SHAPES)
    assert ours.images == ref.images and ours.targets == ref.targets
    for i in range(len(ours)):
        a, b = ours[i], ref[i]
        assert len(a) == len(b) and a[2] == b[2]
        for x, y in zip(a[:2] + a[3:], b[:2] + b[3:]):
            np.testing.assert_array_equal(x, y)
    labels = np.concatenate([ours[i][1].reshape(-1) for i in range(len(ours))])
    assert set(np.unique(labels)) <= {0, 1, 255}


def test_seg_metrics_and_palette_match_jax():
    rng = np.random.RandomState(3)
    results, ref = [], []
    for _ in range(3):
        pred = rng.randint(0, 19, (20, 30))
        gt = rng.randint(0, 21, (20, 30))
        gt[gt > 18] = 255
        h, lab, cor = seg_metrics.hist_info(19, pred, gt)
        hj, labj, corj = jax_seg.hist_info(19, pred, gt)
        np.testing.assert_array_equal(h, hj)
        assert (lab, cor) == (labj, corj)
        results.append({"hist": h, "labeled": lab, "correct": cor})
        ref.append({"hist": hj, "labeled": labj, "correct": corj})
    assert seg_metrics.compute_metric(results) == jax_seg.compute_metric(ref)
    for a, b in zip(seg_metrics.compute_metric(results, per_class=True),
                    jax_seg.compute_metric(ref, per_class=True)):
        np.testing.assert_array_equal(a, b)
    pred = rng.randint(0, 21, (9, 11))
    np.testing.assert_array_equal(map2citycolor(pred), jax_map2citycolor(pred))


def test_load_torch_checkpoint_unwraps_like_jax(tmp_path):
    sd = {"backbone.stem.conv1.weight": torch.randn(2, 3), "sem_seg_head.x": torch.randn(4)}
    dl = {"mod1.conv1.weight": torch.randn(3), "model": {"a": torch.zeros(1)}}
    cases = {"plain": sd, "state_dict": {"state_dict": sd, "epoch": 3},
             "d2": {"model": sd, "iteration": 7},
             "model_key_is_a_tensor_dict_beside_model_keys": dl}
    for name, obj in cases.items():
        path = str(tmp_path / f"{name}.pth")
        torch.save(obj, path)
        ours, ref = load_torch_checkpoint(path), jax_load_ckpt(path)
        assert list(ours) == list(ref), name
        for k in ours:
            if isinstance(ours[k], torch.Tensor):
                assert torch.equal(ours[k], ref[k]), (name, k)


def test_reference_weights_load_strictly(tmp_path):
    """A DeepLab checkpoint as DataParallel saves it (``module.`` prefix, BN step
    counters) loads into the trainer's model, ``ood_head`` <- the classifier; a
    missing key refuses. An M2F checkpoint in detectron2's wrapper, with the
    loss's buffer and without ``class_embed2``, loads with the OOD head copied."""
    cfg = load_config("exps/deeplab.yaml")
    src = DeepWV3Plus(**TINY)
    sd = {f"module.{k}": v for k, v in src.state_dict().items()}
    sd.update({"module.mod1.bn.num_batches_tracked": torch.tensor(5)})
    torch.save({"state_dict": sd}, tmp_path / "dl.pth")
    tr = TrainDeepLabOOD(cfg, str(tmp_path / "dl.pth"), model=DeepWV3Plus(**TINY), device="cpu")
    got = tr.model.state_dict()
    for k, v in src.state_dict().items():
        if k != "ood_head.weight":
            assert torch.equal(got[k], v), k
    assert torch.equal(got["ood_head.weight"], src.state_dict()["final.6.weight"])
    del sd["module.final.6.weight"]
    torch.save(sd, tmp_path / "bad.pth")
    with pytest.raises(RuntimeError, match="Missing key"):
        TrainDeepLabOOD(cfg, str(tmp_path / "bad.pth"), model=DeepWV3Plus(**TINY), device="cpu")

    m2f = MaskFormer(**M2F)
    msd = {k: v for k, v in m2f.state_dict().items() if ".class_embed2." not in k}
    msd["criterion.empty_weight"] = torch.ones(20)
    torch.save({"model": msd, "iteration": 9}, tmp_path / "m2f.pth")
    t = TrainM2FOOD(m2f_cfg(tmp_path), str(tmp_path / "m2f.pth"), model=MaskFormer(**M2F),
                    device="cpu")
    got = t.model.state_dict()
    pred = "sem_seg_head.predictor."
    for leaf in ("weight", "bias"):
        assert torch.equal(got[f"{pred}class_embed2.{leaf}"], msd[f"{pred}class_embed.{leaf}"])
    assert all(torch.equal(got[k], v) for k, v in msd.items() if k in got)


def _artifact_stem(path):
    """The datasets keep no root, so an artifact is named by the image's whole
    path, as the JAX evaluator names it."""
    return os.path.splitext(path)[0].replace(os.sep, "_").lstrip("_")


def _score_fn(framework):
    """anomaly = channel 0 - channel 1 and a 19-channel semantic map of scaled
    channels: exact in both frameworks."""
    def fwd(imgs):
        a = imgs[..., 0] - imgs[..., 1]
        sem = [imgs[..., c % 3] * ((c + 1) / 19) for c in range(19)]
        if framework == "jax":
            return a, jnp.stack(sem, axis=1)
        return a, torch.stack(sem, dim=1)

    return fwd


@pytest.mark.parametrize("name", ["RoadAnomaly21", "MUAD"])
def test_ood_evaluator_matches_jax(tree, tmp_path, name):
    """Same folder, same score function: the same metrics (mIoU too on MUAD),
    exactly; batch 1 gives what batch 4 gives; the artifacts have the images'
    shapes."""
    cfg, jcfg = load_config(None), jax_load_config(None)
    ours = test_runner.OODEvaluator(cfg, _score_fn("torch"), tree,
                                    save_dir=str(tmp_path / "out")).test(name)
    ref = jax_runner.OODEvaluator(jcfg, _score_fn("jax"), tree).test(name)
    assert ours == ref and set(ref) >= {"AUROC", "AUPRC", "FPR_TPR95"}
    if name == "MUAD":
        assert "mIoU" in ours
    one = test_runner.OODEvaluator(cfg, _score_fn("torch"), tree, batch_size=1).test(name)
    assert one == ours
    ds = anomaly.EVAL_DATASETS[name](root=tree[name])
    for path, (h, w) in zip(ds.images, [Image.open(p).size[::-1] for p in ds.images]):
        stem = _artifact_stem(path)
        assert np.load(tmp_path / "out" / name / f"{stem}_anomaly.npy").shape == (h, w)
        assert Image.open(tmp_path / "out" / name / f"{stem}_pred_color.png").size == (w, h)


def test_tta_averages_the_mirrored_forward():
    imgs = torch.from_numpy(np.random.RandomState(4).randn(2, 8, 12, 3).astype(np.float32))
    a, s = test_runner.tta_wrap(_score_fn("torch"))(imgs)
    aj, sj = jax_runner.tta_wrap(_score_fn("jax"))(jnp.asarray(imgs.numpy()))
    np.testing.assert_array_equal(a.numpy(), np.asarray(aj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))


def test_qualification_gate_warns_where_jax_passes_silently(tmp_path, caplog):
    weights = tmp_path / "ckpt.pth"
    weights.write_bytes(b"")
    qp = test_runner.sampling_qualification_path(str(weights))
    assert qp == jax_runner.sampling_qualification_path(str(weights))
    with caplog.at_level(logging.WARNING):
        test_runner.check_sampling_qualification(str(weights), "nearest")
    assert "no per-checkpoint qualification artifact" in caplog.text
    qp.write_text(json.dumps({"modes": {"int8": {"qualified": True}}}))
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        test_runner.check_sampling_qualification(str(weights), "nearest")
        jax_runner.check_sampling_qualification(str(weights), "nearest")  # silent
    assert [r.name for r in caplog.records] == ["multishiftseg_torch.train.test_runner"]
    assert "has no entry for this mode" in caplog.text
    qp.write_text(json.dumps({"modes": {"nearest": {"qualified": False, "delta_pts": -2}}}))
    with pytest.raises(RuntimeError, match="REFUSED"):
        test_runner.check_sampling_qualification(str(weights), "nearest")
    with pytest.raises(RuntimeError, match="REFUSED"):  # before any model is built
        test_runner.build_m2f_forward(load_config(None), str(weights), device="cpu",
                                      sample_mode="nearest")
    test_runner.check_sampling_qualification(str(weights), "bilinear")


M2F = dict(num_classes=19, hidden_dim=32, num_queries=8, nheads=4, dim_feedforward=64,
           dec_layers=3, mask_dim=32, transformer_enc_layers=1)


def m2f_cfg(tmp_path, roots=None, enc_layers=1):
    """A YAML config of the tiny MaskFormer (f32), with dataset roots."""
    data = {"anomaly_track_root": roots["RoadAnomaly21"]} if roots else {}
    y = {"data": data, "train": {"bf16": False},
         "model": {"m2f": {"hidden_dim": 32, "num_queries": 8, "nheads": 4,
                           "dim_feedforward": 64, "dec_layers": 4, "mask_dim": 32,
                           "transformer_enc_layers": enc_layers}}}
    path = tmp_path / "tiny.yaml"
    path.write_text(json.dumps(y))  # JSON is YAML
    return load_config(str(path))


def test_main_runs_the_tiny_model_on_a_folder(tree, tmp_path, monkeypatch):
    """The CLI, ``--model m2f`` on the CPU, with a detectron2-style checkpoint of
    a seeded tiny model and ``--save_outputs``: finite metrics, artifacts of the
    images' shapes, and the numbers the evaluator gives through
    ``build_m2f_forward`` directly."""
    cfg = m2f_cfg(tmp_path, tree)
    torch.manual_seed(3)
    model = MaskFormer(**M2F)
    torch.save({"model": model.state_dict()}, tmp_path / "w.pth")
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "art"
    argv = ["--model", "m2f", "--cfg", str(tmp_path / "tiny.yaml"), "--weight_path",
            str(tmp_path / "w.pth"), "--test_dataset", "RoadAnomaly21", "--device", "cpu",
            "--save_outputs", str(out)]
    res = test_runner.main(argv)["RoadAnomaly21"]
    assert all(np.isfinite(v) for v in res.values()) and set(res) == {"AUROC", "AUPRC",
                                                                     "FPR_TPR95"}
    fwd = test_runner.build_m2f_forward(cfg, str(tmp_path / "w.pth"), model=MaskFormer(**M2F),
                                        device="cpu")
    direct = test_runner.OODEvaluator(cfg, fwd, {"RoadAnomaly21": tree["RoadAnomaly21"]})
    assert direct.test("RoadAnomaly21") == res
    ds = anomaly.RoadAnomaly21(root=tree["RoadAnomaly21"])
    for p in ds.images:
        w, h = Image.open(p).size
        assert np.load(out / "RoadAnomaly21" / f"{_artifact_stem(p)}_anomaly.npy").shape == (h, w)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        test_runner.main(argv + ["--spatial", "2"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        test_runner.main(argv + ["--score_lowres"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        test_runner.main(argv + ["--sample_mode", "int8"])


def test_m2f_forward_from_a_checkpoint_matches_jax(tmp_path, monkeypatch):
    """``build_m2f_forward(cfg, weight_path)`` in each framework, from one
    detectron2-style checkpoint of a seeded tiny model, on the same normalised
    batch padded to its 128 bucket: anomaly and sem within 1e-4. Six encoder
    layers, as JAX's checkpoint converter has them."""
    cfg = m2f_cfg(tmp_path, enc_layers=6)
    jcfg = jax_load_config(str(tmp_path / "tiny.yaml"))
    torch.manual_seed(5)
    torch.save({"model": MaskFormer(**{**M2F, "transformer_enc_layers": 6}).state_dict()},
               tmp_path / "w.pth")
    monkeypatch.chdir(tmp_path)  # the JAX trainer makes its checkpoint folder here
    rng = np.random.RandomState(6)
    imgs = np.zeros((2, 128, 128, 3), np.float32)
    imgs[:, :70, :100] = (rng.rand(2, 70, 100, 3) - np.array(MEAN)) / np.array(STD)
    anomaly, sem = test_runner.build_m2f_forward(cfg, str(tmp_path / "w.pth"), device="cpu")(
        torch.from_numpy(imgs))
    anomaly_j, sem_j = jax_runner.build_m2f_forward(jcfg, str(tmp_path / "w.pth"))(
        jnp.asarray(imgs))
    assert anomaly.shape == (2, 128, 128) and sem.shape == (2, 19 + 8, 128, 128)
    np.testing.assert_allclose(anomaly.numpy(), np.asarray(anomaly_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(sem.numpy(), np.asarray(sem_j), rtol=0, atol=1e-4)


def test_entry_points_need_the_card_unless_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = m2f_cfg(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        test_runner.build_m2f_forward(cfg, model=MaskFormer(**M2F))
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainM2FOOD(cfg, model=MaskFormer(**M2F))
    with pytest.raises(RuntimeError, match="CUDA"):
        test_runner.build_m2f_request_forward(MaskFormer(**M2F))
