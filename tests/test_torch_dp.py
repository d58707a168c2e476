"""PyTorch port, data parallelism (``multishiftseg_torch/core/mesh.py``) on the
CPU: two gloo ranks (``torch_dp_worker``, spawned; they import no JAX).

- The global reductions held to the JAX package on the global arrays: RCL's
  bottom-k (``losses/rcl.py:65``) at heavy ties, and flax's train-mode
  BatchNorm (biased one-pass variance, running statistics, gradients).
- One two-rank ``train()`` epoch and a resume (DeepLab, tiny trunk): rank 0
  writes ``last`` and ``AUPRC_best`` behind a barrier, both ranks resume from
  them, and every epoch's loss and metrics equal those of the same run in one
  process, as ``tests/test_multihost.py`` asserts for JAX.
- The refusals: an indivisible per-half batch, tensor parallelism, and
  pipeline parallelism across ranks or without a deformable encoder.
- A group of one rank keeps the single-process routes.

The trainers' steps of a global batch split over two ranks are held to JAX's
single-process steps in the files that build those JAX steps
(``test_torch_deeplab_train.py``, ``test_torch_train.py``,
``test_torch_instance_step.py``: ``test_two_rank_*``).
"""

import copy

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from multishiftseg_tpu.losses.rcl import _bottom_k_sum as jax_bottom_k_sum

from multishiftseg_torch.core import mesh
from multishiftseg_torch.core.config import load_config
from multishiftseg_torch.models.deeplab import DeepWV3Plus
from multishiftseg_torch.tools.synthetic_tree import write_training_tree
from multishiftseg_torch.train.checkpoint import CheckpointManager
from multishiftseg_torch.train.deeplab_trainer import TrainDeepLabOOD

from torch_dp_worker import run_ranks

WORLD = 2
DL_TINY = dict(trunk_structure=(1,) * 6,
               trunk_channels=((8, 8), (8, 8), (16, 16), (16, 16), (8, 16, 32), (16, 32, 64)))
SELECT = (0, 1, 777, 2400, 4001, 5000)  # of 6000 values, 4800 valid


@pytest.fixture(scope="module")
def unit_job():
    g = np.random.RandomState(3)
    values = (np.round(g.rand(4, 1500) * 40) / 40).astype(np.float32)  # heavy ties
    return dict(kind="units", values=values, valid=g.rand(4, 1500) < 0.8, select=SELECT,
                bn_x=(g.randn(4, 3, 5, 6) * 2 + 3).astype(np.float32),
                bn_w=g.rand(3).astype(np.float32) + 0.5, bn_b=g.randn(3).astype(np.float32),
                bn_c=g.randn(4, 3, 5, 6).astype(np.float32))


@pytest.fixture(scope="module")
def units(unit_job, tmp_path_factory):
    return run_ranks(unit_job, tmp_path_factory.mktemp("units"), WORLD)


def test_global_bottom_k_matches_jax(unit_job, units):
    """The radix rounds' all-reduced histograms find JAX's threshold over the
    global elements: every rank's sum within f32 rounding of JAX's, and its
    gradient exactly ``world`` times JAX's (every rank computes the global
    sum, and its backward sums the gradient over the ranks; DDP's average
    divides the world back out)."""
    values, valid = unit_job["values"], unit_job["valid"]
    keyed = np.where(valid, values, np.inf).astype(np.float32)
    for i, k in enumerate(SELECT):
        fn = lambda v: jax_bottom_k_sum(v, jnp.asarray(keyed.reshape(-1)), jnp.int32(k))
        want, dwant = jax.value_and_grad(fn)(jnp.asarray(values.reshape(-1)))
        dwant = np.asarray(dwant).reshape(values.shape)
        for rank, res in enumerate(units):
            s, grad = res["bottom_k"][i]
            assert abs(s - float(want)) <= 1e-5 * max(abs(float(want)), 1.0), (k, rank)
            rows = slice(rank * 2, rank * 2 + 2)
            np.testing.assert_array_equal(grad, WORLD * dwant[rows], err_msg=str(k))
    assert units[0]["bottom_k"][0][0] == 0.0


def test_global_batch_norm_matches_flax(unit_job, units):
    """Train-mode BatchNorm over the global batch: every rank's output rows,
    the running mean and the biased running variance (flax's, which
    ``test_running_variance_follows_flax_not_torch`` pins), the gradient of
    its input rows and, summed over the ranks, of the scale and bias, against
    flax's BatchNorm on the whole batch, within 1e-5; channels-last rows give
    the same and stay channels-last."""
    x = jnp.asarray(unit_job["bn_x"].transpose(0, 2, 3, 1))
    c = jnp.asarray(unit_job["bn_c"].transpose(0, 2, 3, 1))
    bn = flax.linen.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), x)
    params = {"scale": jnp.asarray(unit_job["bn_w"]), "bias": jnp.asarray(unit_job["bn_b"])}

    def loss(params, x):
        y, upd = bn.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                          mutable=["batch_stats"])
        return jnp.sum(y * c), (y, upd["batch_stats"])

    (_, (y, stats)), (dparams, dx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, x)
    nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2)
    close = lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    for rank, res in enumerate(units):
        rows = slice(rank * 2, rank * 2 + 2)
        close(res["bn"]["y"], nchw(y)[rows])
        close(res["bn"]["dx"], nchw(dx)[rows])
        close(res["bn"]["mean"], stats["mean"])
        close(res["bn"]["var"], stats["var"])
    close(sum(r["bn"]["dw"] for r in units), dparams["scale"])
    close(sum(r["bn"]["db"] for r in units), dparams["bias"])
    for res in units:  # channels-last rows: the same values, the layout kept
        cl = res["bn_channels_last"]
        close(cl["y"], res["bn"]["y"])
        close(cl["dx"], res["bn"]["dx"])
        assert cl["kept"]


def test_world_of_one_takes_the_single_process_routes(unit_job, tmp_path):
    """A group of one rank (``torchrun --nproc_per_node 1``) keeps the
    single-process routes: the collectives are the identity, and a train-mode
    BatchNorm and the bottom-k sum equal those of one process bit for bit."""
    from multishiftseg_torch.losses.rcl import _bottom_k_sum

    from torch_dp_worker import batch_norm_run

    (got,) = run_ranks(dict(unit_job, kind="world_of_one"), tmp_path, world=1)
    assert got["in_group"] and got["identity"]
    want = batch_norm_run(unit_job)
    for k, v in want.items():
        np.testing.assert_array_equal(got["bn"][k], v, err_msg=k)
    v = torch.from_numpy(unit_job["values"]).reshape(-1)
    keyed = torch.where(torch.from_numpy(unit_job["valid"]).reshape(-1), v,
                        torch.full_like(v, float("inf")))
    assert got["bottom_k"] == float(_bottom_k_sum(v, keyed, torch.tensor(777, dtype=torch.int32)))


@pytest.fixture(scope="module")
def loop_cfg(tmp_path_factory):
    tree = write_training_tree(tmp_path_factory.mktemp("data"), seed=0, frames=4,
                               hw=(96, 160), coco=2, coco_hw=(60, 80), val=2, val_hw=(64, 96))
    cfg = load_config("exps/deeplab.yaml")
    for k, v in tree.items():
        setattr(cfg.data, k, v)
    cfg.data.crop_size, cfg.data.num_workers = (64, 64), 2
    cfg.train.warmup_epoch, cfg.train.train_batch, cfg.train.bf16 = 0, 2, False
    return cfg


def test_two_rank_train_writes_once_and_resumes_on_both_ranks(loop_cfg, tmp_path):
    """Two ranks of one pair each: one epoch, then a resume from ``last`` to
    two. Rank 0 wrote the checkpoints, both ranks resumed at epoch 1 with the
    optimizer and generator, and both end with the same parameters; each
    epoch's loss and metrics and the best AUPRC equal those of the same run
    (one epoch, then a resume) in one process on the same global batches
    (rel 2e-4, ``test_multihost.py``'s bound). Both ranks refuse a per-half
    batch of 3 and ``model_parallel: 2``."""
    cfg = copy.deepcopy(loop_cfg)
    cfg.model_dir = str(tmp_path / "two")
    ranks = run_ranks(dict(kind="train_and_resume", cfg=cfg, model=DL_TINY, epochs=(1, 2)),
                      tmp_path / "ranks", WORLD)
    ckpt = CheckpointManager(cfg.model_dir)
    assert ckpt.exists("last") and ckpt.exists("AUPRC_best")
    assert ckpt.restore("last")["epoch"] == 1
    assert not list((tmp_path / "two").glob("*.tmp"))
    for r in ranks:
        assert [h["epoch"] for h in r["history0"]] == [0]
        assert [h["epoch"] for h in r["history1"]] == [1]  # resumed, not restarted
        assert all(h["steps"] == 2 and h["images"] == 4 for h in r["history0"] + r["history1"])
        assert r["best1"] == ranks[0]["best1"]
        assert all(np.array_equal(r["params1"][n], p) for n, p in ranks[0]["params1"].items())
        assert r["refusals"]["odd_batch"].startswith("ValueError: per-half batch rows 3")
        assert r["refusals"]["model_parallel"].startswith("NotImplementedError: train.model")

    history = []
    for epochs, resume in ((1, None), (2, "last")):  # the same run in one process
        single = copy.deepcopy(loop_cfg)
        single.model_dir, single.train.n_epochs = str(tmp_path / "one"), epochs
        torch.manual_seed(0)
        tr = TrainDeepLabOOD(single, model=DeepWV3Plus(**DL_TINY), device="cpu")
        tr.train(resume=resume)
        history += tr.history
    two = ranks[0]["history0"] + ranks[0]["history1"]
    assert [h["epoch"] for h in history] == [h["epoch"] for h in two] == [0, 1]
    for got, want in zip(two, history):
        assert got["loss"] == pytest.approx(want["loss"], rel=2e-4), got["epoch"]
        for k, v in want["metrics"].items():
            assert got["metrics"][k] == pytest.approx(v, rel=2e-4), (got["epoch"], k)
    assert ranks[0]["best1"]["AUPRC"] == pytest.approx(tr.best["AUPRC"], rel=2e-4)


@pytest.mark.parametrize("case", ["model_parallel", "pipeline_world", "pipeline_decoder"])
def test_unported_parallelism_raises(case, monkeypatch):
    """The refusals at construction: tensor parallelism (the next slice,
    named by its ROADMAP item); GPipe in a world above 1, as JAX refuses it
    across processes; GPipe of a model whose pixel decoder is not the
    deformable one."""
    cfg = load_config("exps/deeplab.yaml")
    if case == "model_parallel":
        cfg.train.model_parallel = 2
        with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 4"):
            TrainDeepLabOOD(cfg, model=DeepWV3Plus(**DL_TINY), device="cpu")
        with pytest.raises(NotImplementedError, match="model_parallel"):
            mesh.check_parallelism(cfg.train)
    elif case == "pipeline_world":
        cfg.train.pipeline_parallel = 2
        mesh.check_parallelism(cfg.train, pipelined=True)
        monkeypatch.setattr(mesh, "process_count", lambda: 2)
        for pipe, micro in ((2, 0), (1, 4)):
            cfg.train.pipeline_parallel, cfg.train.pipeline_microbatches = pipe, micro
            with pytest.raises(ValueError, match="one process"):
                mesh.check_parallelism(cfg.train, pipelined=True)
    else:
        from multishiftseg_torch.models.maskformer import MaskFormer
        from multishiftseg_torch.train.m2f_trainer import TrainM2FOOD

        cfg = load_config("exps/m2f.yaml")
        cfg.train.pipeline_parallel = 2
        with pytest.raises(ValueError, match="msdeformattn"):
            TrainM2FOOD(cfg, model=MaskFormer(hidden_dim=32, num_queries=4, nheads=4,
                                               dim_feedforward=32, dec_layers=3, mask_dim=32,
                                               pixel_decoder="fpn"), device="cpu")
        with pytest.raises(ValueError, match="no deformable encoder"):
            TrainDeepLabOOD(cfg, model=DeepWV3Plus(**DL_TINY), device="cpu")


def test_single_process_is_the_identity(monkeypatch):
    """Without a launch environment nothing joins a group, and the batch
    split, the draws' rows and the collectives are the identity."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert not mesh.initialize_distributed() and not mesh.is_distributed()
    assert (mesh.process_index(), mesh.process_count()) == (0, 1)
    assert mesh.check_train_batch(3) == 3 and mesh.local_batch_slice(4) == slice(0, 4)
    x = torch.arange(6.0).reshape(3, 2)
    assert mesh.all_sum(x) is x and mesh.gather_rows(x, paired=True) is x
    draws = {"match_coords": x, "rcl_noise": x}
    assert mesh.rank_draws(draws, paired=True) is draws
    model = torch.nn.Linear(2, 2)
    assert mesh.data_parallel(model) is model


def test_rank_rows_take_each_half_of_a_paired_batch(monkeypatch):
    """Rank 1 of 2 takes rows 2-3 of the clean half and of the augmented half
    of a global [clean ‖ augmented] batch of 4 pairs, whole images of rows
    grouped by image, and dim 1 of Swin's [calls, batch] drop-path masks;
    RCL's noise stays global."""
    monkeypatch.setattr(mesh, "process_count", lambda: 2)
    monkeypatch.setattr(mesh, "process_index", lambda: 1)
    rows = torch.arange(8)
    assert mesh.rank_rows(rows, paired=True).tolist() == [2, 3, 6, 7]
    assert mesh.rank_rows(rows, paired=False).tolist() == [4, 5, 6, 7]
    draws = {"match_coords": rows, "orig_coords": torch.arange(4),
             "clean_coords": torch.arange(12), "rcl_noise": rows,
             "drop_path": torch.arange(16).reshape(2, 8), "aux": [{"match_coords": rows}]}
    got = mesh.rank_draws(draws, paired=True)
    assert got["match_coords"].tolist() == [2, 3, 6, 7]
    assert got["orig_coords"].tolist() == [2, 3]
    assert got["clean_coords"].tolist() == [6, 7, 8, 9, 10, 11]  # 3 slots an image
    assert got["rcl_noise"] is rows
    assert got["drop_path"].tolist() == [[2, 3, 6, 7], [10, 11, 14, 15]]
    assert got["aux"][0]["match_coords"].tolist() == [2, 3, 6, 7]
