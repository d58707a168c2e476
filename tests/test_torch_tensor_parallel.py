"""PyTorch port, tensor parallelism (``core/tensor_parallel.py``) against the JAX
package's rule and the port's unsharded steps, on the CPU.

The plan (which ``state_dict`` entries shard) is held to the leaves JAX's
``tensor_parallel_shardings`` marks ``model``, mapped through the converter's
names, at full width (WRN-38 DeepLab, M2F R-50; shapes from ``jax.eval_shape``,
the port's models on the meta device) and on ``tests/test_mesh.py``'s tiny
trunk at ``min_size = 64``. Every shard sits on ``cpu``: the tiny DeepLab
forward against JAX's unsharded forward at ``test_mesh.py``'s tolerance, and
the DeepLab, M2F stage-2 and instance steps against the port's unsharded
steps from the same weights, batch and draws (float64 within 1e-10). Two gloo
ranks of ``model_parallel`` 2 each take the single-process step; checkpoints
move between ``model_parallel`` 1 and 2.
"""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multishiftseg_tpu.core import mesh as jax_mesh
from multishiftseg_tpu.models.deeplab import DeepWV3Plus as JaxDeepLab
from multishiftseg_tpu.models.maskformer import MaskFormer as JaxMaskFormer

from multishiftseg_torch.convert.from_jax import deeplab_from_jax, deeplab_port_key, port_key
from multishiftseg_torch.core import mesh
from multishiftseg_torch.core import tensor_parallel as tp
from multishiftseg_torch.core.config import load_config
from multishiftseg_torch.models.deeplab import DeepWV3Plus
from multishiftseg_torch.models.maskformer import MaskFormer
from multishiftseg_torch.models.wider_resnet import draw_dropout_masks
from multishiftseg_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from multishiftseg_torch.train.deeplab_trainer import TrainDeepLabOOD, synthetic_batch
from multishiftseg_torch.train.m2f_trainer import TrainM2FOOD

from test_torch_swin import seeded_variables

# tests/test_mesh.py's tiny trunk (test_mesh.py:115-127), at min_size 64
TINY = dict(trunk_structure=(1, 1, 1, 1, 1, 1),
            trunk_channels=((16, 16), (16, 16), (32, 32), (32, 32), (16, 32, 64),
                            (32, 64, 128)))
TINY_MIN = 64
# the M2F steps on R-18 at min_size 64: every backbone conv with its FrozenBN
# shards (R-50's res4 / res5 at 1024 are the card's), and so do both FFNs'
# linear1 (the encoder's 1024, the decoder's 64)
M2F_TINY = dict(hidden_dim=32, num_queries=20, nheads=4, dim_feedforward=64, dec_layers=3,
                mask_dim=32, transformer_enc_layers=1, backbone="resnet18")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the models are tiny, and the lane runs several
    test processes on the same cores, where more threads only contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def jax_shapes(name):
    """``jax.eval_shape`` of a JAX model's variables at a 64x64 input."""
    jm = (JaxMaskFormer(num_classes=19) if name == "m2f"
          else JaxDeepLab(num_classes=19, **({} if name == "deeplab" else TINY)))
    return jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                          jnp.zeros((1, 64, 64, 3)), train=False))


def jax_plan(name, mp, min_size, key_of):
    """The port keys of the leaves JAX's ``tensor_parallel_shardings`` marks
    ``model`` on a (1, mp) mesh."""
    shapes = jax_shapes(name)
    m = jax_mesh.make_mesh(devices=jax.devices()[:mp], model_parallel=mp)
    shardings = jax_mesh.tensor_parallel_shardings(shapes, m, min_size)
    keys = set()
    for path, sh in jax.tree_util.tree_leaves_with_path(shardings):
        if "model" in str(sh.spec):
            keys.add(key_of(tuple(k.key for k in path[1:])))
    return keys


PLAN_CASES = [("deeplab", 2, 1024), ("deeplab", 4, 1024), ("m2f", 2, 1024),
              ("m2f", 4, 1024), ("tiny", 2, TINY_MIN), ("tiny", 4, TINY_MIN)]


@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: f"{c[0]}-mp{c[1]}")
def test_plan_matches_jax_rule(case):
    """``tensor_parallel_plan`` names exactly the tensors JAX shards: WRN-38's
    1024-4096-channel mod5-7 convs and BatchNorms, R-50's res4 / res5, the
    encoder FFN's ``linear1`` (1024) and the decoder FFN's (2048)."""
    name, mp, min_size = case
    with torch.device("meta"):
        model = (DeepWV3Plus() if name == "deeplab" else DeepWV3Plus(**TINY) if name == "tiny"
                 else MaskFormer())
    want = jax_plan(name, mp, min_size, port_key if name == "m2f" else deeplab_port_key)
    got = tp.tensor_parallel_plan(model, mp, min_size)
    assert len(got) == len(set(got)) and want, name
    assert set(got) == want
    if name == "m2f":
        assert "sem_seg_head.pixel_decoder.transformer.encoder.layers.0.linear1.weight" in want
        assert "sem_seg_head.predictor.transformer_ffn_layers.0.linear1.bias" in want
        assert "backbone.res5.2.conv3.norm.running_var" in want
    if name == "deeplab":
        assert "mod7.block1.convs.conv3.weight" in want and "aspp.features.1.0.weight" not in want


# ---------------------------------------------------------------------------
# DeepLab: forward against JAX, the step against the unsharded one


@pytest.fixture(scope="module")
def tiny_deeplab():
    """JAX's tiny DeepLab with numpy-seeded variables, its unsharded eval
    forward of a 2 x 64 x 64 batch, and the port's state dict."""
    jm = JaxDeepLab(num_classes=19, **TINY)
    x = np.random.RandomState(2).randn(2, 64, 64, 3).astype(np.float32)
    variables = seeded_variables(jm, 3, jnp.zeros((1, 64, 64, 3)), train=False)
    score, logit = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x)
    return dict(x=x, score=np.asarray(score), logit=np.asarray(logit).transpose(0, 3, 1, 2),
                state=deeplab_from_jax(variables))


def deeplab_trainer(state, mp, dtype=torch.float32, min_size=TINY_MIN):
    cfg = load_config("exps/deeplab.yaml")
    cfg.train.bf16, cfg.data.crop_size = False, (64, 64)
    cfg.train.model_parallel, cfg.train.model_parallel_min_size = mp, min_size
    model = DeepWV3Plus(**TINY)
    model.load_state_dict(state, strict=True)
    tr = TrainDeepLabOOD(cfg, model=model.to(dtype), device="cpu")
    tr.model.to(dtype)
    return tr


def shard_fractions(model, mp):
    """Every ChannelShards' shards: (devices, each shard's dim-0 share)."""
    out = []
    for mod in model.modules():
        if isinstance(mod, tp.ChannelShards):
            assert len(mod.shards) == mp and mod.devices == [CPU] * mp
            for shard in mod.shards:
                for t in shard.state_dict().values():
                    out.append(t.shape[0] * mp / mod.channels)
    return out


@pytest.mark.parametrize("mp", [2, 4])
def test_tiny_deeplab_forward_matches_jax(tiny_deeplab, mp):
    """The sharded eval forward equals JAX's unsharded one (``test_mesh.py``'s
    rtol 1e-4 / atol 1e-3), and every sharded tensor holds 1 / mp of its
    entries on each shard."""
    tr = deeplab_trainer(tiny_deeplab["state"], mp)
    fractions = shard_fractions(tr.model, mp)
    assert fractions and all(f == 1.0 for f in fractions)
    assert len(tr.model.state_dict()) == len(tiny_deeplab["state"])
    score, logit = tr.eval_step(tiny_deeplab["x"])
    np.testing.assert_allclose(score.numpy(), tiny_deeplab["score"], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(logit.numpy(), tiny_deeplab["logit"], rtol=1e-4, atol=1e-3)


def deeplab_draws(model, seed=5, pairs=1, hw=(64, 64)):
    g = torch.Generator().manual_seed(seed)
    return {"rcl_noise": torch.rand((3, 2 * pairs * hw[0] * hw[1]), generator=g,
                                    dtype=torch.float64),
            "dropout": draw_dropout_masks(model, 2 * pairs, g, "cpu")}


def run_deeplab_steps(tr, draws, steps=(1, 2)):
    """``steps[s]`` steps of stage s (stage 1 trains the sharded ASPP)."""
    batch = synthetic_batch(1, (64, 64), 19, seed=4)
    losses = []
    for stage, n in enumerate(steps):
        tr.set_stage(stage)
        for _ in range(n):
            loss, _ = tr.step(*batch, draws=draws)
            losses.append(float(loss))
    return losses, tr.model.state_dict()


@pytest.fixture(scope="module")
def unsharded_deeplab_steps(tiny_deeplab):
    tr = deeplab_trainer(tiny_deeplab["state"], 1, torch.float64)
    return run_deeplab_steps(tr, deeplab_draws(tr.model))


@pytest.mark.parametrize("mp", [2, 4])
def test_tiny_deeplab_steps_match_unsharded_float64(tiny_deeplab, unsharded_deeplab_steps, mp):
    """A stage-0 step, then two of stage 1, in float64: losses, parameters,
    Adam-updated weights and running statistics within 1e-10 of the
    unsharded trainer's."""
    tr = deeplab_trainer(tiny_deeplab["state"], mp, torch.float64)
    losses, state = run_deeplab_steps(tr, deeplab_draws(tr.model))
    want_losses, want = unsharded_deeplab_steps
    np.testing.assert_allclose(losses, want_losses, rtol=1e-10, atol=0)
    assert set(state) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=0, atol=1e-10, err_msg=k)


def test_two_ranks_of_two_shards_match_one_process(tiny_deeplab, tmp_path):
    """Two gloo ranks of one pair each, ``model_parallel`` 2 in each: the
    global step (DDP over a multi-device module, the global BatchNorm and
    bottom-k on the shards' slices) equals the single-process unsharded step
    on the same global batch, in float64 at ``test_torch_deeplab_train.py``'s
    two-rank bound: every gradient and running statistic within 1e-9 of its
    tensor's scale (the global routes sum in another order; Adam's update of
    an entry whose gradient is near its eps magnifies that, so the updated
    weights are not compared); the loss, which RCL reduces in f32, within
    1e-6."""
    from torch_dp_worker import run_ranks

    cfg = load_config("exps/deeplab.yaml")
    cfg.train.bf16, cfg.data.crop_size, cfg.train.train_batch = False, (64, 64), 2
    cfg.train.model_parallel, cfg.train.model_parallel_min_size = 2, TINY_MIN
    with torch.random.fork_rng():
        model = DeepWV3Plus(**TINY).double()
    draws = [deeplab_draws(model, seed=s, pairs=2) for s in (6, 7)]
    batch = synthetic_batch(2, (64, 64), 19, seed=8)
    ranks = run_ranks(dict(kind="deeplab", cfg=cfg, model=TINY, state=tiny_deeplab["state"],
                           batch=batch, draws=draws, dtypes=[torch.float64]),
                      tmp_path / "ranks")
    single = copy.deepcopy(cfg)
    single.train.model_parallel = 1
    model = DeepWV3Plus(**TINY)
    model.load_state_dict(tiny_deeplab["state"])
    tr = TrainDeepLabOOD(single, model=model, device="cpu")
    tr.model.double()
    for stage, d in enumerate(draws):
        tr.set_stage(stage)
        loss, _ = tr.step(*batch, draws=d)
        grads = tp.unsharded_grads(tr.model)
        stats = {k: v for k, v in tr.model.state_dict().items() if "running_" in k}
        for r in ranks:
            got = r[str(torch.float64)][stage]
            assert got["loss"] == pytest.approx(float(loss), rel=1e-6, abs=0)
            assert set(got["unsharded_grads"]) == set(grads)
            for k, v in list(grads.items()) + list(stats.items()):
                want = v.double().numpy()
                got_k = got["unsharded_grads"][k] if k in grads else got["state"][k]
                np.testing.assert_allclose(got_k, want, rtol=0,
                                           atol=1e-9 * np.abs(want).max(), err_msg=k)


def test_checkpoint_moves_between_one_and_two_shards(tiny_deeplab, tmp_path):
    """A checkpoint saved at ``model_parallel`` 2 after two steps holds the
    unsharded layout; it resumes at 1 and at 2 with equal parameters,
    statistics and Adam moments, and one more step agrees (float64 1e-10)."""
    tr = deeplab_trainer(tiny_deeplab["state"], 2, torch.float64)
    run_deeplab_steps(tr, deeplab_draws(tr.model), steps=(0, 1))
    path = save_checkpoint(str(tmp_path / "mp2.pt"), tr)
    saved = torch.load(path, weights_only=True)
    assert set(saved["model"]) == set(tiny_deeplab["state"])
    unsharded_names = [n for n, p in DeepWV3Plus(**TINY).named_parameters()
                       if any(s in n for s in ("aspp", "bot_fine", "bot_aspp", "ood_head"))]
    assert len(saved["optimizer"]["state"]) == len(unsharded_names)
    resumed = {}
    for mp in (1, 2):
        other = deeplab_trainer(tiny_deeplab["state"], mp, torch.float64)
        restore_checkpoint(path, other)
        assert other.stage == 1
        moments = tp.optimizer_state_dict(other.model, other.optimizer)
        for k, v in saved["optimizer"]["state"].items():
            for s in ("exp_avg", "exp_avg_sq"):
                np.testing.assert_array_equal(moments["state"][k][s].numpy(), v[s].numpy())
        batch = synthetic_batch(1, (64, 64), 19, seed=9)
        loss, _ = other.step(*batch, draws=deeplab_draws(other.model, seed=9))
        resumed[mp] = (float(loss), other.model.state_dict())
    assert resumed[1][0] == pytest.approx(resumed[2][0], rel=1e-10)
    for k, v in resumed[1][1].items():
        np.testing.assert_allclose(resumed[2][1][k].numpy(), v.numpy(), rtol=0, atol=1e-10,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the Mask2Former steps


def m2f_step(cfg_path, mp, trainer_fn, step_fn):
    torch.manual_seed(0)
    model = MaskFormer(**M2F_TINY, predictor="gma" if "instance" not in cfg_path
                       else "vanilla")
    cfg = load_config(cfg_path)
    cfg.data.crop_size, cfg.model.m2f.train_num_points, cfg.train.bf16 = (64, 64), 64, False
    cfg.loss.params["num_pair_samples"] = 256
    cfg.model.m2f.max_instances = 4
    cfg.train.model_parallel, cfg.train.model_parallel_min_size = mp, TINY_MIN
    tr = trainer_fn(cfg, model)
    tr.model.double()
    loss = step_fn(tr)
    return float(loss), tr.model.state_dict(), tr


def _stage2(tr):
    from multishiftseg_torch.train.m2f_trainer import synthetic_batch as m2f_batch

    tr.set_stage(1)
    return tr.stage2_step(*m2f_batch(1, (64, 64), 19, seed=0))[0]


def _instance_batch(b):
    rng = np.random.RandomState(1)
    img = rng.randn(b, 64, 64, 3).astype(np.float32)
    id_map = np.repeat(np.repeat(rng.randint(-1, 3, (b, 4, 4)), 16, 1), 16, 2).astype(np.int32)
    classes = np.array([[0, 3, 5, -1], [2, 2, 7, -1]] * (b // 2), np.int32)
    return img, id_map, classes


def _instance(tr):
    return tr.step(*_instance_batch(2))[0]


STEP_CASES = {
    "m2f_stage2": ("exps/m2f.yaml", lambda cfg, m: TrainM2FOOD(cfg, model=m, device="cpu"),
                   _stage2),
    "instance": ("exps/m2f_instance.yaml",
                 lambda cfg, m: __import__(
                     "multishiftseg_torch.train.instance_trainer",
                     fromlist=["TrainM2FInstance"]).TrainM2FInstance(
                         cfg, model=m, dataset_name="unused", device="cpu"),
                 _instance),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_m2f_steps_at_two_shards_match_unsharded_float64(case):
    """One float64 step at ``model_parallel`` 2 (R-18's convs with their
    FrozenBNs, basic blocks' residual slices, the encoder and decoder FFNs'
    ``linear1``) equals the unsharded step: loss, AdamW-updated parameters
    and the gradient clip within 1e-10."""
    path, make, step = STEP_CASES[case]
    want_loss, want, _ = m2f_step(path, 1, make, step)
    loss, state, tr = m2f_step(path, 2, make, step)
    assert tp.is_tensor_parallel(tr.model)
    assert loss == pytest.approx(want_loss, rel=1e-10, abs=1e-12)
    for k, v in want.items():
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=0, atol=1e-10, err_msg=k)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_two_ranks_of_two_shards_match_one_process_m2f(case, tmp_path):
    """Two gloo ranks of one image pair (or 1 image) each, ``model_parallel``
    2 in each (R-18 at ``min_size`` 64), take the single-process unsharded
    step of the same global batch and draws in float64, at
    ``test_torch_train.py``'s two-rank bound: losses within 1e-6 and every
    gradient within 1e-6 of its tensor's scale; a gradient that is zero but
    for rounding (a conv bias before a GroupNorm) held to 0 at 1e-8, as
    ROADMAP's standing differences hold such biases."""
    from torch_dp_worker import run_ranks

    path, make, _ = STEP_CASES[case]
    cfg = load_config(path)
    cfg.data.crop_size, cfg.model.m2f.train_num_points, cfg.train.bf16 = (64, 64), 64, False
    cfg.loss.params["num_pair_samples"] = 256
    cfg.model.m2f.max_instances = 4
    cfg.train.train_batch = 2
    torch.manual_seed(0)
    kw = dict(M2F_TINY)
    tr = make(cfg, MaskFormer(**kw, predictor="vanilla" if case == "instance" else "gma"))
    state = {k: v.clone() for k, v in tr.model.state_dict().items()}
    tr.model.double()
    if case == "instance":
        batch = _instance_batch(2)
        tr.set_stage(0)
        draws = tr.draws(2, batch[2].shape[1])
        loss = tr.step(*batch, draws=draws)[0]
    else:
        from multishiftseg_torch.train.m2f_trainer import synthetic_batch as m2f_batch

        batch = m2f_batch(2, (64, 64), 19, seed=0)
        tr.set_stage(1)
        draws = tr.draws(4, (64, 64))
        loss = tr.stage2_step(*batch, draws=draws)[0]
    grads = tp.unsharded_grads(tr.model)
    sharded = copy.deepcopy(cfg)
    sharded.train.model_parallel, sharded.train.model_parallel_min_size = 2, TINY_MIN
    ranks = run_ranks(dict(kind=case, cfg=sharded, model=kw, state=state, batch=batch,
                           draws=draws, dtypes=[torch.float64]), tmp_path / "ranks")
    for r in ranks:
        got = r[str(torch.float64)]
        assert got["loss"] == pytest.approx(float(loss), rel=1e-6, abs=0)
        assert set(got["unsharded_grads"]) == set(grads)
        for k, v in grads.items():
            want, scale = v.double().numpy(), float(v.abs().max())
            if scale < 1e-8:
                assert np.abs(got["unsharded_grads"][k]).max() <= 1e-8, k
                continue
            np.testing.assert_allclose(got["unsharded_grads"][k], want, rtol=0,
                                       atol=1e-6 * scale, err_msg=k)


# ---------------------------------------------------------------------------
# refusals


def test_refusals():
    """``model_parallel`` with ``pipeline_parallel`` raises (ROADMAP's next
    item); so does a device count other than processes x model_parallel; a
    list of shard devices of the wrong length; and ``model_parallel`` where
    no tensor reaches the threshold."""
    cfg = load_config("exps/m2f.yaml")
    cfg.train.model_parallel, cfg.train.pipeline_parallel = 2, 2
    with pytest.raises(NotImplementedError, match="Queue 1 item 4.5"):
        mesh.check_parallelism(cfg.train, pipelined=True)
    cfg.train.pipeline_parallel = 1
    mesh.check_parallelism(cfg.train, pipelined=True)
    cfg.train.num_devices = 4
    with pytest.raises(ValueError, match="model_parallel 2"):
        mesh.check_parallelism(cfg.train)
    cfg.train.num_devices = 2
    mesh.check_parallelism(cfg.train)
    with pytest.raises(ValueError, match="3 devices given"):
        tp.tensor_parallel_devices(2, [CPU] * 3)
    dl = load_config("exps/deeplab.yaml")
    dl.train.model_parallel = 2
    with pytest.raises(ValueError, match="no tensor of this model"):
        TrainDeepLabOOD(dl, model=DeepWV3Plus(**dict(TINY, trunk_channels=(
            (8, 8), (8, 8), (8, 8), (8, 8), (8, 8, 8), (8, 8, 8)))), device="cpu")
