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

import jax
import jax.numpy as jnp

from multishiftseg_tpu.convert.torch2jax import load_torch_checkpoint as jax_load_ckpt
from multishiftseg_tpu.core.config import load_config as jax_load_config
from multishiftseg_tpu.data import anomaly as jax_anomaly
from multishiftseg_tpu.data import transforms as jax_tf
from multishiftseg_tpu.data.native_io import decode as jax_decode
from multishiftseg_tpu.evals import seg_metrics as jax_seg
from multishiftseg_tpu.ops import ms_deform_attn as jax_msda
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
from multishiftseg_torch.ops import ms_deform_attn as msda
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


def test_ood_evaluator_reports_the_metrics_route(tree, monkeypatch):
    """``metric_routes`` names the exact metrics' route of each benchmark: the
    numpy one for this small folder, the native one once the folder's
    labelled pixels reach ``NATIVE_MIN_PIXELS`` (lowered here), with the same
    metrics."""
    from multishiftseg_torch.evals import ood_metrics

    cfg = load_config(None)
    default = test_runner.OODEvaluator(cfg, _score_fn("torch"), tree)
    a = default.test("RoadAnomaly21")
    monkeypatch.setattr(ood_metrics, "NATIVE_MIN_PIXELS", 1)
    native = test_runner.OODEvaluator(cfg, _score_fn("torch"), tree)
    b = native.test("RoadAnomaly21")
    assert default.metric_routes == {"RoadAnomaly21": "numpy"}
    assert native.metric_routes == {"RoadAnomaly21": "native"}
    assert a.keys() == b.keys() and all(abs(a[k] - b[k]) <= 1e-9 for k in a)


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
    with pytest.raises(ValueError, match="exclusive"):
        test_runner.main(argv + ["--score_lowres", "--score_topq", "4"])
    with pytest.raises(ValueError, match="unknown sample_mode"):
        test_runner.main(argv + ["--sample_mode", "bicubic"])


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


# ---------------------------------------------------------------------------
# the approximate eval modes: every setting JAX's build_m2f_forward accepts

HYBRID = "bilinear,bilinear,bilinear,nearest_top6c,nearest_top6c,nearest_top6c"
EVAL_SETTINGS = {"int8": ("int8", False, 0), "nearest": ("nearest", False, 0),
                 "nearest_top6": ("nearest_top6", False, 0),
                 "nearest_top6c": ("nearest_top6c", False, 0), "shared": ("shared", False, 0),
                 "hybrid": (HYBRID, False, 0), "nearest+lowres": ("nearest", True, 0),
                 "nearest+topq4": ("nearest", False, 4)}


def replay_deform_inputs(monkeypatch, layers, images):
    """Run the port's deformable cores on the JAX model's own core inputs.

    The approximate modes take discrete decisions inside the core: a point's
    nearest pixel, a centroid's pixel, the top-T set, an int8 rounding step.
    The two frameworks' f32 inputs differ in the last bits, so a decision whose
    input lies within that noise of its boundary may go either way, and in a
    deformable encoder one such flip moves every later feature (queries on a
    coarse level sample the finer levels exactly on pixel boundaries, where
    the centroid of points in one row is a tie). So, as the decoder tests
    replay attention-mask bits, JAX's ``ms_deform_attn_core`` records its
    (value, loc, attn) in order (``jax.debug.callback``, the JAX file
    unedited) and the port's core runs on them: the rest of both models is
    held to f32 noise, and each core's own decisions are held by the op tests.
    Returns a list that counts, per port call, the outputs that its own inputs
    would have moved by more than 1e-3 of the output's scale (flipped
    decisions)."""
    recorded, moved = [], []
    jax_core = jax_msda.ms_deform_attn_core

    def recording(value, shapes, loc, attn, quantize_table=False, sample_mode="bilinear"):
        jax.debug.callback(lambda *a: recorded.append([np.asarray(t) for t in a]),
                           value, loc, attn, ordered=True)
        return jax_core(value, shapes, loc, attn, quantize_table=quantize_table,
                        sample_mode=sample_mode)

    port_core = msda.ms_deform_attn_core
    calls = []

    def replaying(value, shapes, loc, attn, sample_mode="bilinear", quantize_table=False):
        # JAX maps the model over the images: image-major records; the port
        # runs the batch at once (or one image at a time for int8)
        k = len(calls)
        picks = ([recorded[k]] if value.shape[0] == 1 else
                 [recorded[k + i * layers] for i in range(images)])
        calls.append(k)
        v, l, a = (torch.from_numpy(np.concatenate(t)) for t in zip(*picks))
        assert tuple(v.shape) == tuple(value.shape) and tuple(l.shape) == tuple(loc.shape)
        own = port_core(value, shapes, loc, attn, sample_mode, quantize_table)
        out = port_core(v, shapes, l, a, sample_mode, quantize_table)
        moved.append(int(((own - out).abs() > 1e-3 * out.abs().max()).sum()))
        return out

    monkeypatch.setattr(jax_msda, "ms_deform_attn_core", recording)
    monkeypatch.setattr(msda, "ms_deform_attn_core", replaying)
    return moved


@pytest.mark.parametrize("setting", sorted(EVAL_SETTINGS))
def test_m2f_forward_in_each_mode_matches_jax(tmp_path, monkeypatch, caplog, setting):
    """``build_m2f_forward`` in each framework in one approximate setting, from
    one checkpoint, on one batch of 2 (so ``int8`` takes a scale per image in
    both; the port's int8 cores see one image each), the cores' discrete
    decisions replayed (:func:`replay_deform_inputs`): anomaly and sem within
    1e-4, as the ``bilinear`` test. The gate warns in both, no artifact being
    recorded."""
    mode, lowres, topq = EVAL_SETTINGS[setting]
    cfg = m2f_cfg(tmp_path, enc_layers=6)
    jcfg = jax_load_config(str(tmp_path / "tiny.yaml"))
    torch.manual_seed(7)
    m2f = MaskFormer(**{**M2F, "transformer_enc_layers": 6})
    with torch.no_grad():  # the deformable weight heads init to 0: give them weights
        rng = np.random.RandomState(8)
        for name, p in m2f.named_parameters():
            if "attention_weights" in name or "sampling_offsets" in name:
                p.add_(torch.from_numpy(0.1 * rng.randn(*p.shape).astype(np.float32)))
    torch.save({"model": m2f.state_dict()}, tmp_path / "w.pth")
    monkeypatch.chdir(tmp_path)
    rng = np.random.RandomState(9)
    imgs = np.zeros((2, 128, 128, 3), np.float32)
    imgs[:, :70, :100] = (rng.rand(2, 70, 100, 3) - np.array(MEAN)) / np.array(STD)
    imgs[1] *= 1.5  # images of another scale: a shared int8 scale would differ
    opts = dict(sample_mode=mode, score_lowres=lowres, score_topq=topq)
    moved = replay_deform_inputs(monkeypatch, layers=6, images=2)
    with caplog.at_level(logging.WARNING):
        fwd = test_runner.build_m2f_forward(cfg, str(tmp_path / "w.pth"), device="cpu", **opts)
        anomaly_j, sem_j = jax_runner.build_m2f_forward(jcfg, str(tmp_path / "w.pth"), **opts)(
            jnp.asarray(imgs))
    assert caplog.text.count("no per-checkpoint qualification artifact") == 2
    anomaly, sem = fwd(torch.from_numpy(imgs))
    assert len(moved) == (12 if mode == "int8" else 6)
    assert anomaly.shape == (2, 128, 128) and sem.shape == (2, 19 + 8, 128, 128)
    np.testing.assert_allclose(anomaly.numpy(), np.asarray(anomaly_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(sem.numpy(), np.asarray(sem_j), rtol=0, atol=1e-4)
    # flipped decisions move few of a core's 2 x 336 x 32 outputs
    assert max(moved) <= 0.01 * 2 * 336 * 32, moved


def test_int8_scale_is_per_image():
    """The port's int8 eval runs one image at a time: an image's scores do not
    depend on the images batched with it (JAX: one image a ``lax.map`` step)."""
    from multishiftseg_torch.train.m2f_trainer import eval_forward

    torch.manual_seed(7)
    m2f = MaskFormer(**M2F)
    rng = np.random.RandomState(9)
    imgs = torch.from_numpy(rng.randn(2, 64, 64, 3).astype(np.float32))
    imgs[1] *= 3.0
    sem, anomaly = eval_forward(m2f, imgs, sample_mode="int8")
    alone_sem, alone = eval_forward(m2f, imgs[1:], sample_mode="int8")
    assert torch.equal(alone[0], anomaly[1]) and torch.equal(alone_sem[0], sem[1])
    launches = []
    orig = msda.quantize_value_table_plain
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(msda, "quantize_value_table_plain",
                   lambda v: launches.append(v.shape[0]) or orig(v))
        eval_forward(m2f, imgs, sample_mode="int8")
    assert launches == [1, 1]  # one encoder layer, two images


def test_cli_takes_the_approximate_flags(tree, tmp_path, monkeypatch):
    """``--sample_mode`` in every form and either tail: the CLI's numbers are
    the evaluator's through ``build_m2f_forward`` with the same options."""
    cfg = m2f_cfg(tmp_path, tree)
    torch.manual_seed(3)
    torch.save({"model": MaskFormer(**M2F).state_dict()}, tmp_path / "w.pth")
    monkeypatch.chdir(tmp_path)
    argv = ["--model", "m2f", "--cfg", str(tmp_path / "tiny.yaml"), "--weight_path",
            str(tmp_path / "w.pth"), "--test_dataset", "RoadAnomaly21", "--device", "cpu"]
    for flags, opts in ((["--sample_mode", "nearest_top6c", "--score_topq", "4"],
                         dict(sample_mode="nearest_top6c", score_topq=4)),
                        (["--sample_mode", "int8", "--score_lowres"],
                         dict(sample_mode="int8", score_lowres=True))):
        res = test_runner.main(argv + flags)["RoadAnomaly21"]
        assert set(res) == {"AUROC", "AUPRC", "FPR_TPR95"}
        fwd = test_runner.build_m2f_forward(cfg, str(tmp_path / "w.pth"),
                                            model=MaskFormer(**M2F), device="cpu", **opts)
        direct = test_runner.OODEvaluator(cfg, fwd, {"RoadAnomaly21": tree["RoadAnomaly21"]})
        assert direct.test("RoadAnomaly21") == res
    with pytest.raises(ValueError, match="outside 1..12"):
        test_runner.main(argv + ["--sample_mode", "nearest_top13"])


def test_qualification_key_is_composite(tmp_path, caplog):
    """The key is JAX's (``test_runner.py:353-356``): a missing key warns, a key
    recorded unqualified refuses before any model is built, a qualified one
    passes, and ``enforce_qualification=False`` measures a refused one."""
    for args in (("nearest", False, 0), ("nearest", True, 0), ("int8", False, 32),
                 (HYBRID, False, 0), ("bilinear", False, 4)):
        want = args[0] + ("+lowres" if args[1] else "") + (f"+topq{args[2]}" if args[2] else "")
        assert test_runner.qualification_key(*args) == want
    weights = tmp_path / "ckpt.pth"
    torch.save({"model": MaskFormer(**M2F).state_dict()}, weights)
    qp = test_runner.sampling_qualification_path(str(weights))
    qp.write_text(json.dumps({"modes": {"nearest": {"qualified": True},
                                        "nearest+topq4": {"qualified": False, "delta_pts": -3},
                                        "nearest+lowres": {"qualified": True}}}))
    cfg = m2f_cfg(tmp_path)
    with caplog.at_level(logging.WARNING):
        test_runner.build_m2f_forward(cfg, str(weights), model=MaskFormer(**M2F), device="cpu",
                                      sample_mode="nearest", score_topq=8)
    assert "no entry for this mode" in caplog.text and "nearest+topq8" in caplog.text
    with pytest.raises(RuntimeError, match="REFUSED"):
        test_runner.build_m2f_forward(cfg, str(weights), device="cpu", sample_mode="nearest",
                                      score_topq=4)
    with pytest.raises(RuntimeError, match="REFUSED"):
        test_runner.build_m2f_request_forward(MaskFormer(**M2F), device="cpu",
                                              sample_mode="nearest", score_topq=4,
                                              weight_path=str(weights))
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        test_runner.build_m2f_forward(cfg, str(weights), model=MaskFormer(**M2F), device="cpu",
                                      sample_mode="nearest", score_lowres=True)
        test_runner.build_m2f_forward(cfg, str(weights), model=MaskFormer(**M2F), device="cpu",
                                      sample_mode="nearest", score_topq=4,
                                      enforce_qualification=False)
    assert not caplog.text


def test_qualify_sampling_modes_on_a_folder(tree, tmp_path, monkeypatch):
    """The port's ``validate_release``: ``qualify_sampling_modes`` measures each
    mode against a measured ``bilinear`` result on a RoadAnomaly folder and
    writes the artifact; the gate then refuses exactly the modes recorded
    unqualified. ``main``'s exit codes: 2 without a dataset, 1 off the
    published numbers, 3 with a refused mode, 0 with none."""
    from multishiftseg_torch.tools import validate_release as vr

    cfg = m2f_cfg(tmp_path, tree)
    torch.manual_seed(11)
    weights = str(tmp_path / "w.pth")
    torch.save({"model": MaskFormer(**M2F).state_dict()}, weights)
    monkeypatch.chdir(tmp_path)
    fwd = test_runner.build_m2f_forward(cfg, weights, device="cpu")
    got = test_runner.OODEvaluator(cfg, fwd, tree).test("RoadAnomaly")
    bilinear_pts = {k: 100.0 * got[k] for k in ("AUROC", "AUPRC", "FPR_TPR95")}
    modes = ("nearest", "int8", "nearest_top6c", "shared", "nearest+lowres", "nearest+topq4")
    rec = vr.qualify_sampling_modes(cfg, weights, "RoadAnomaly", tree["RoadAnomaly"],
                                    bilinear_pts, 0.5, modes=modes, device="cpu")
    assert set(rec["modes"]) == set(modes) and rec["tolerance_pts"] == 0.5
    for mode, r in rec["modes"].items():
        assert r["qualified"] == all(abs(d) <= 0.5 for d in r["delta_pts"].values()), mode
    path = vr.write_qualification(weights, rec)
    assert path == test_runner.sampling_qualification_path(weights)
    for mode, r in rec["modes"].items():
        base, _, suffix = mode.partition("+")
        opts = dict(sample_mode=base, score_lowres=suffix == "lowres",
                    score_topq=int(suffix[4:]) if suffix.startswith("topq") else 0)
        if r["qualified"]:
            test_runner.build_m2f_forward(cfg, weights, model=MaskFormer(**M2F), device="cpu",
                                          **opts)
        else:
            with pytest.raises(RuntimeError, match="REFUSED"):
                test_runner.build_m2f_forward(cfg, weights, device="cpu", **opts)

    argv = ["--model", "m2f", "--cfg", str(tmp_path / "tiny.yaml"), "--weight_path", weights,
            "--device", "cpu", "--road_anomaly_root"]
    assert vr.main(argv + [str(tmp_path / "absent")]) == 2
    assert vr.main(argv + [tree["RoadAnomaly"]]) == 1  # random weights
    monkeypatch.setitem(vr.PUBLISHED, "m2f", bilinear_pts)
    monkeypatch.setattr(vr, "QUAL_MODES", ("int8", "nearest+topq4"))
    assert vr.main(argv + [tree["RoadAnomaly"], "--tolerance", "1000"]) == 0
    assert set(json.loads(path.read_text())["modes"]) == {"int8", "nearest+topq4"}
    monkeypatch.setattr(vr, "QUAL_MODES", ("nearest+topq32",))  # 8 queries: no result
    assert vr.main(argv + [tree["RoadAnomaly"], "--tolerance", "1000"]) == 3
    assert json.loads(path.read_text())["modes"]["nearest+topq32"]["qualified"] is False
