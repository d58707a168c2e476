"""PyTorch port, the epoch loop of both trainers on the CPU.

``TrainM2FOOD.train`` and ``TrainDeepLabOOD.train`` with tiny models on a
seeded synthetic dataset tree (``tools/synthetic_tree.py``): the stage switch
at ``warmup_epoch`` (stage 0's optimizer, then stage 1's from the boundary
epoch on), ``AUPRC_best`` saved only on improvement and ``last`` every epoch,
the resume in both cases of the saved stage, an empty loader and a worker's
exception, the scalar curves read back by the JAX package's ``ScalarWriter``,
and the training CLI's routing. Against the JAX package's ``train()`` on the
same tree: the stage and the [clean ‖ generated] batch of every step over two
epochs (the steps themselves replaced by recorders in both packages).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multishiftseg_tpu.train.deeplab_trainer as jax_deeplab_trainer
import multishiftseg_tpu.train.m2f_trainer as jax_m2f_trainer
from multishiftseg_tpu.core.config import load_config as jax_load_config
from multishiftseg_tpu.core.logging import ScalarWriter as JaxScalarWriter
from multishiftseg_tpu.models.deeplab import DeepWV3Plus as JaxDeepLab
from multishiftseg_tpu.models.maskformer import MaskFormer as JaxMaskFormer

from multishiftseg_torch.core.config import load_config
from multishiftseg_torch.models.deeplab import DeepWV3Plus
from multishiftseg_torch.models.maskformer import MaskFormer
from multishiftseg_torch.tools.synthetic_tree import write_segments_tree, write_training_tree
from multishiftseg_torch.train import cli
from multishiftseg_torch.train.checkpoint import CheckpointManager
from multishiftseg_torch.train.deeplab_trainer import TrainDeepLabOOD
from multishiftseg_torch.train.m2f_trainer import TrainM2FOOD

CROP = (64, 64)
M2F_WIDTHS = dict(hidden_dim=32, num_queries=24, nheads=4, dim_feedforward=64, dec_layers=3,
                  mask_dim=32, transformer_enc_layers=1)
DL_TINY = dict(trunk_structure=(1,) * 6,
               trunk_channels=((8, 8), (8, 8), (16, 16), (16, 16), (8, 16, 32), (16, 32, 64)))
# the tags each JAX trainer writes to scalars.csv (m2f_trainer.py:465-470,
# deeplab_trainer.py:290-297)
VAL_TAGS = {"val/AUROC", "val/AUPRC", "val/FPR_TPR95"}
TAGS = {"m2f": {"train/loss", "stage"} | VAL_TAGS,
        "deeplab": {"train/loss", "train/img_per_s"} | VAL_TAGS}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the loop's loader threads run beside the steps,
    and the suite runs several worker processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """4 frames of 96x160 with one variant each, 2 COCO cut-outs, 2 validation
    images of 64x96."""
    return write_training_tree(tmp_path_factory.mktemp("data"), seed=0, frames=4, hw=(96, 160),
                               coco=2, coco_hw=(60, 80), val=2, val_hw=(64, 96))


def make_cfg(name, tree, model_dir, n_epochs=3, warmup=1, batch=2, loader=load_config):
    cfg = loader(f"exps/{name}.yaml")
    for k, v in tree.items():
        setattr(cfg.data, k, v)
    cfg.data.crop_size, cfg.data.num_workers = CROP, 2
    cfg.train.n_epochs, cfg.train.warmup_epoch = n_epochs, warmup
    cfg.train.train_batch, cfg.train.bf16 = batch, False
    cfg.model_dir = str(model_dir)
    if name == "m2f":
        cfg.model.m2f.train_num_points = 64
        cfg.loss.params["num_pair_samples"] = 256
    return cfg


def make_trainer(name, cfg):
    torch.manual_seed(0)
    if name == "m2f":
        return TrainM2FOOD(cfg, model=MaskFormer(num_classes=19, **M2F_WIDTHS), device="cpu")
    return TrainDeepLabOOD(cfg, model=DeepWV3Plus(**DL_TINY), device="cpu")


@pytest.mark.parametrize("name", ["m2f", "deeplab"])
def test_train_crosses_the_warmup_boundary(name, tree, tmp_path):
    """Three epochs, warmup 1: stage 0 with its optimizer, then stage 1's from
    the boundary epoch on; a validation, a ``last`` and the scalars every
    epoch."""
    cfg = make_cfg(name, tree, tmp_path / "ckpt")
    tr = make_trainer(name, cfg)
    best = tr.train()
    stage0, stage1 = (("Adam", "AdamW") if name == "m2f" else ("Adam", "Adam"))
    assert [h["stage"] for h in tr.history] == [0, 1, 1]
    assert [h["optimizer"] for h in tr.history] == [stage0, stage1, stage1]
    assert [h["steps"] for h in tr.history] == [2, 2, 2]
    assert all(np.isfinite(h["loss"]) and set(h["metrics"]) == {"AUROC", "AUPRC", "FPR_TPR95"}
               for h in tr.history)
    assert best["AUPRC"] == max(h["metrics"]["AUPRC"] for h in tr.history)
    if name == "m2f":  # stage 1 trains all parameters, stage 0 class_embed2 only
        assert all(p.requires_grad for p in tr.model.parameters())
    ckpt = CheckpointManager(cfg.model_dir)
    assert ckpt.exists("last") and ckpt.exists("AUPRC_best")
    last = ckpt.restore("last")
    assert last["epoch"] == 2 and last["stage"] == 1 and "generator" in last
    assert "generator" not in ckpt.restore("AUPRC_best")
    curves = JaxScalarWriter(cfg.model_dir).read()
    assert set(curves) == TAGS[name]
    assert [s for s, _ in curves["train/loss"]] == [0, 1, 2]
    if name == "m2f":
        assert [v for _, v in curves["stage"]] == [0.0, 1.0, 1.0]


NORM_ATOL = 5e-5  # f32 images after Normalize, as in test_torch_data.py


def jax_step_inputs(name, tree, model_dir, monkeypatch):
    """[(stage, images, targets)] that the JAX package's ``train()`` feeds
    its step over two epochs across the boundary; the steps, the validation
    and the checkpoint writes are stubbed out."""
    cfg = make_cfg(name, tree, model_dir, n_epochs=2, loader=jax_load_config)
    seen = []

    def recorder(stage):
        def step(state, img, tgt):  # the arrays as the jitted step takes them
            seen.append((stage, np.asarray(jnp.asarray(img)), np.asarray(jnp.asarray(tgt))))
            return state, 0.0, {}
        return step

    for module in (jax_deeplab_trainer, jax_m2f_trainer):
        monkeypatch.setattr(module, "shard_batch", lambda arrays, mesh: arrays)
    if name == "m2f":
        tr = jax_m2f_trainer.TrainM2FOOD(cfg, model=JaxMaskFormer(num_classes=19, **M2F_WIDTHS))
        tr.make_stage1_step = lambda tx, paired=True: recorder(0)
        tr.make_stage2_step = lambda tx, paired=True: recorder(1)
    else:
        made = []

        def make_train_step(model, tx, rcl_params, paired=False):
            made.append(tx)  # the first optimizer is stage 0's, a second stage 1's
            return recorder(len(made) - 1)

        monkeypatch.setattr(jax_deeplab_trainer, "make_train_step", make_train_step)
        tr = jax_deeplab_trainer.TrainDeepLabOOD(cfg, model=JaxDeepLab(**DL_TINY))
    tr.valid = lambda *a: {}
    tr.ckpt.save = lambda *a, **k: None
    tr.train()
    return seen


def port_step_inputs(name, tree, model_dir):
    """The port's counterpart of :func:`jax_step_inputs`: what its
    ``train()`` hands the step, concatenated [clean ‖ generated] as the
    step does (M2F through its own ``_pair``, padding included)."""
    tr = make_trainer(name, make_cfg(name, tree, model_dir, n_epochs=2))
    seen = []

    def pair(img_c, img_g, tgt_c, tgt_g):
        return torch.cat([img_c, img_g]), torch.cat([tgt_c, tgt_g])

    def recorder(pair):
        def step(img_c, img_g, tgt_c, tgt_g):
            img, tgt = pair(img_c, img_g, tgt_c, tgt_g)
            seen.append((tr.stage, img.numpy(), tgt.numpy()))
            return torch.zeros(()), {}
        return step

    if name == "m2f":
        tr.stage1_step = tr.stage2_step = recorder(tr._pair)
    else:
        tr.step = recorder(pair)
    tr.valid = lambda ds: {}
    tr.train()
    return seen


@pytest.mark.parametrize("name", ["m2f", "deeplab"])
def test_train_feeds_the_step_what_jax_feeds_it(name, tree, tmp_path, monkeypatch):
    """The loop's wiring against the JAX package's ``train()`` on one tree and
    seed: the Loader's seed and shuffle, ``set_epoch`` before each epoch, the
    unpacking of (image, mask, gen_image, gen_mask) into the step's halves and
    their order, and the stage of every step. Images within 5e-5 (after
    Normalize), targets equal."""
    want = jax_step_inputs(name, tree, tmp_path / "jax", monkeypatch)
    got = port_step_inputs(name, tree, tmp_path / "port")
    assert [s for s, _, _ in got] == [s for s, _, _ in want] == [0, 0, 1, 1]
    for (_, img, tgt), (_, want_img, want_tgt) in zip(got, want):
        assert img.shape == want_img.shape and img.dtype == want_img.dtype
        np.testing.assert_allclose(img, want_img, rtol=0, atol=NORM_ATOL)
        np.testing.assert_array_equal(tgt, want_tgt)


def test_auprc_best_is_saved_only_on_improvement(tree, tmp_path):
    cfg = make_cfg("deeplab", tree, tmp_path / "ckpt")
    tr = make_trainer("deeplab", cfg)
    scores = iter([0.5, 0.3, 0.7])
    tr.valid = lambda ds: {"AUROC": 0.5, "AUPRC": next(scores), "FPR_TPR95": 0.9}
    tr.train()
    assert [h["saved"] for h in tr.history] == [["AUPRC_best", "last"], ["last"],
                                                ["AUPRC_best", "last"]]
    best = CheckpointManager(cfg.model_dir).restore("AUPRC_best")
    assert best["epoch"] == 2 and best["best_auprc"] == 0.7


@pytest.mark.parametrize("name", ["m2f", "deeplab"])
def test_resume_in_the_saved_stage_restores_the_optimizer(name, tree, tmp_path):
    """``last`` of epoch 1 (stage 1) resumed into epoch 2 (stage 1): model,
    optimizer, generator and the best AUPRC come back; the third epoch runs in
    stage 1."""
    cfg = make_cfg(name, tree, tmp_path / "ckpt", n_epochs=2)
    a = make_trainer(name, cfg)
    a.train()
    saved = CheckpointManager(cfg.model_dir).restore("last")
    b = make_trainer(name, make_cfg(name, tree, tmp_path / "ckpt", n_epochs=3))
    start, stage = CheckpointManager(cfg.model_dir).resume(b, "last", 0, 1)
    assert (start, stage) == (2, 1) and b.best["AUPRC"] == saved["best_auprc"]
    got = b.optimizer.state_dict()
    assert got["param_groups"] == saved["optimizer"]["param_groups"]
    assert set(got["state"]) == set(saved["optimizer"]["state"]) and got["state"]
    for k, st in saved["optimizer"]["state"].items():
        for key, v in st.items():
            assert torch.equal(got["state"][k][key], v), (k, key)
    assert torch.equal(b.generator.get_state(), saved["generator"])
    for (n, p), (_, q) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(p, q), n
    b.train(resume="last")
    assert [(h["epoch"], h["stage"]) for h in b.history] == [(2, 1)]


def test_resume_across_the_boundary_builds_a_fresh_optimizer(tree, tmp_path):
    """``last`` of epoch 0 (stage 0) resumed into epoch 1 (stage 1): the model
    and best AUPRC come back, the stage-1 optimizer starts empty and the
    generator is not replaced (the resume is the trainers' shared
    ``CheckpointManager.resume``)."""
    name = "deeplab"
    cfg = make_cfg(name, tree, tmp_path / "ckpt", n_epochs=1)
    make_trainer(name, cfg).train()
    saved = CheckpointManager(cfg.model_dir).restore("last")
    assert saved["stage"] == 0
    b = make_trainer(name, make_cfg(name, tree, tmp_path / "ckpt", n_epochs=2))
    gen_before = b.generator.get_state()
    start, stage = CheckpointManager(cfg.model_dir).resume(b, "last", 0, 1)
    assert (start, stage) == (1, 1) and b.stage == 1
    assert b.best["AUPRC"] == saved["best_auprc"]
    assert not b.optimizer.state_dict()["state"]
    assert type(b.optimizer).__name__ == "Adam"
    assert torch.equal(b.generator.get_state(), gen_before)
    b.train(resume="last")
    assert [(h["epoch"], h["stage"]) for h in b.history] == [(1, 1)]


def test_an_empty_loader_raises(tree, tmp_path):
    tr = make_trainer("deeplab", make_cfg("deeplab", tree, tmp_path / "ckpt", batch=8))
    with pytest.raises(RuntimeError, match="no batches"):
        tr.train()


def test_a_worker_exception_reaches_the_caller(tree, tmp_path):
    tr = make_trainer("m2f", make_cfg("m2f", tree, tmp_path / "ckpt"))
    build = tr.build_datasets

    def broken():
        train_ds, val_ds = build()
        train_ds.images[2] = str(tmp_path / "missing.png")
        return train_ds, val_ds

    tr.build_datasets = broken
    with pytest.raises((FileNotFoundError, OSError)):
        tr.train()


def test_logging_helpers(tmp_path):
    """Meters, the step timer (its warm-up excluded), the stream step timer,
    the first-call logger and the profiler trace's export, on the CPU."""
    from multishiftseg_torch.core import logging as mlog

    meters = mlog.MultiRunningMeter()
    meters.update({"a": 1.0, "b": 4.0}, n=2)
    meters.update({"a": 4.0})
    assert meters.get_metric() == {"a": 2.0, "b": 4.0}
    timer = mlog.StepTimer(warmup_steps=1)
    for _ in range(3):
        timer.start()
        timer.stop(torch.ones(2), items=4)
    assert timer.steps == 3 and timer.total_items == 8 and len(timer.times) == 3
    stream_timer = mlog.StreamStepTimer("cpu")
    for _ in range(2):
        stream_timer.start()
        torch.ones(8).sum()
        stream_timer.stop()
    assert len(stream_timer.times_ms()) == 2 and min(stream_timer.times_ms()) >= 0
    calls = []
    fn = mlog.log_compile_time("f")(lambda x: calls.append(x) or x)
    assert fn(1) == 1 and fn(2) == 2 and calls == [1, 2]
    with mlog.profiler_trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_cli_routes_the_model_and_refuses_the_instance_configuration(tree, tmp_path,
                                                                     monkeypatch):
    """The routing of ``--model`` and the configuration. The name is from
    before the instance trainer was ported, when this test held that the CLI
    refused the vanilla recipes; now each of exps/m2f_{instance,panoptic,
    semantic}.yaml (``instance_on``, ``panoptic_on``, ``ood_finetune: false``)
    builds ``TrainM2FInstance`` through the CLI with ``--device cpu``."""
    from multishiftseg_torch.data.registry import DatasetCatalog
    from multishiftseg_torch.train.instance_trainer import InstanceDataset, TrainM2FInstance

    cfg = load_config("exps/m2f.yaml")
    assert cli.trainer_class("m2f", cfg) is TrainM2FOOD
    assert cli.trainer_class("deeplab", cfg) is TrainDeepLabOOD
    for flag in ("instance_on", "panoptic_on"):
        c = load_config("exps/m2f.yaml")
        setattr(c.model.m2f, flag, True)
        assert cli.trainer_class("m2f", c) is TrainM2FInstance
    c = load_config("exps/m2f.yaml")
    c.model.m2f.ood_finetune = False
    assert cli.trainer_class("m2f", c) is TrainM2FInstance
    repo = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    monkeypatch.chdir(tmp_path)  # the recipes' root is ./datasets/cityscapes
    write_segments_tree(tmp_path / "datasets", seed=0, frames={"train": 1}, hw=(64, 96),
                        things=4)
    try:
        for name, task in (("instance", "instance"), ("panoptic", "panoptic"),
                           ("semantic", "sem_seg")):
            yaml_path = os.path.join(repo, "exps", f"m2f_{name}.yaml")
            assert cli.trainer_class("m2f", load_config(yaml_path)) is TrainM2FInstance
            ds = cli.main(["--model", "m2f", "--cfg", yaml_path, "--id", f"route_{name}",
                           "--device", "cpu", "--run", "build_dataset"])
            assert isinstance(ds, InstanceDataset) and ds.task == task and len(ds) == 1
    finally:
        for name in DatasetCatalog.list():
            DatasetCatalog.remove(name)
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--model", "deeplab", "--cfg", os.path.join(repo, "exps", "deeplab.yaml"),
                      "--id", str(tmp_path / "nocard")])


def test_cli_trains_m2f_on_the_cpu(tree, tmp_path, monkeypatch):
    """``python -m multishiftseg_torch.train.cli --model m2f --device cpu`` on
    a YAML that includes exps/m2f.yaml and narrows the model: two epochs
    across the boundary, the log and the checkpoints where the config puts
    them."""
    import yaml

    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "exps", "m2f.yaml")
    monkeypatch.chdir(tmp_path)
    m = dict(M2F_WIDTHS, train_num_points=64)
    y = {"base": base,
         "data": {**tree, "crop_size": list(CROP), "num_workers": 2},
         "model": {"m2f": m},
         "train": {"n_epochs": 2, "warmup_epoch": 1, "train_batch": 2, "bf16": False},
         "loss": {"params": {"num_pair_samples": 256}}}
    (tmp_path / "tiny.yaml").write_text(yaml.safe_dump(y))
    best = cli.main(["--model", "m2f", "--cfg", "tiny.yaml", "--id", "run0", "--device", "cpu"])
    assert np.isfinite(best["AUPRC"])
    assert os.path.isfile("outputs/run0/log.txt")
    assert {"last.pt", "AUPRC_best.pt", "scalars.csv"} <= set(os.listdir("ckpts/run0"))
    curves = JaxScalarWriter("ckpts/run0").read()
    assert [v for _, v in curves["stage"]] == [0.0, 1.0]
