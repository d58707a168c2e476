"""PyTorch port, the DeepLab two-stage RCL fine-tuning step against the JAX
package on the CPU.

A tiny DeepWV3Plus (one block a module, narrow channels) and exps/deeplab.yaml's
recipe (RCL ce_weights 50/10, margins 10/5/5, pixel selection at 0.8; stage 0
trains ``ood_head`` with Adam at 1e-4, stage 1 ``aspp``, ``bot_fine``, ``bot_aspp``
and ``ood_head`` at 1e-6 with a fresh Adam; L2 1e-4) on 2 pairs of 200x184 crops.
One stage-0 step, then one stage-1 step, through the JAX package's own
``make_train_step`` and the port's ``TrainDeepLabOOD.step``, from the same
weights and batch. The RCL noise is replayed from the JAX key splits; the trunk's
dropout masks are numpy-seeded and fed to both (the JAX model through
``flax.linen.intercept_methods``), so both sides draw nothing of their own.
"""

import numpy as np
import optax
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from multishiftseg_tpu.losses import rcl as jax_rcl
from multishiftseg_tpu.models.deeplab import DeepWV3Plus as JaxDeepLab
from multishiftseg_tpu.train.deeplab_trainer import make_train_step
from multishiftseg_tpu.train.state import TrainState
from multishiftseg_tpu.train.state import build_stage_optimizer as jax_stage_optimizer
from multishiftseg_tpu.train.state import trainable_mask as jax_trainable_mask

from multishiftseg_torch.convert.from_jax import deeplab_from_jax, deeplab_port_key
from multishiftseg_torch.core.config import load_config
from multishiftseg_torch.losses import rcl
from multishiftseg_torch.models.deeplab import DeepWV3Plus
from multishiftseg_torch.train.deeplab_trainer import TrainDeepLabOOD, synthetic_batch

from test_torch_deeplab import TINY, tiny_variables

PAIRS, CROP = 2, (200, 184)
STAGE_NAMES = ("ood_head",), ("aspp", "bot_fine", "bot_aspp", "ood_head")


def deeplab_cfg():
    cfg = load_config("exps/deeplab.yaml")
    cfg.train.bf16 = False
    cfg.data.crop_size = CROP
    return cfg


def dropout_masks(seed, batch):
    """Keep masks for the tiny trunk's two dropout blocks (mod6: p 0.3 over 16
    channels, mod7: p 0.5 over 32), numpy-seeded, in the JAX layout [N, 1, 1, C]."""
    rng = np.random.RandomState(seed)
    return {"mod6_block1": rng.rand(batch, 1, 1, 16) < 0.7,
            "mod7_block1": rng.rand(batch, 1, 1, 32) < 0.5}


def masked_dropout(masks):
    """A flax interceptor: each ``nn.Dropout`` call in training returns
    ``x / keep`` where its block's mask holds and 0 elsewhere, as flax's
    ``Dropout`` does with its own draws."""
    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if not isinstance(mod, flax.linen.Dropout) or mod.deterministic:
            return next_fun(*args, **kwargs)
        x = args[0]
        keep = 1.0 - mod.rate
        return jnp.where(jnp.asarray(masks[mod.scope.path[1]]), x / keep, jnp.zeros_like(x))
    return flax.linen.intercept_methods(interceptor)


def capture_grads():
    """An optax stage ahead of the optimizer that keeps the step's gradients
    in its state, so the JAX package's own ``make_train_step`` hands them out."""
    return optax.GradientTransformation(lambda params: params,
                                        lambda updates, state, params=None: (updates, updates))


def trainable(name, stage):
    """The reference's substring rule (``trainable_mask``) for a port name."""
    return any(s in name for s in STAGE_NAMES[stage])


def port_tree(collection, tree):
    """A JAX tree in the port's names and layouts, as float64 numpy arrays."""
    return {k: v.double().numpy() for k, v in deeplab_from_jax(
        {collection: jax.tree_util.tree_map(np.asarray, tree)}).items()}


@pytest.fixture(scope="module")
def steps():
    """Stage 0 then stage 1: the JAX package's state after each step, with the
    step's loss, components and gradients; the port's f32 trainer and a float64
    twin after the same steps."""
    cfg = deeplab_cfg()
    jm, variables = tiny_variables(seed=2)
    img_c, img_g, tgt_c, tgt_g = synthetic_batch(PAIRS, CROP, 19, seed=4)
    img = jnp.asarray(np.concatenate([img_c, img_g]))
    tgt = jnp.asarray(np.concatenate([tgt_c, tgt_g]))
    batch = 2 * PAIRS
    rcl_params = jax_rcl.make_rcl_params(cfg.loss.params)
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=None, step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(3))
    ref, draws = [], []
    for stage, (names, lr) in enumerate(zip(STAGE_NAMES, (cfg.train.lr, cfg.train.lr_update))):
        tx, _ = jax_stage_optimizer(state.params, lr, cfg.train.weight_decay, names)
        tx = optax.chain(capture_grads(), tx)
        state = state.replace(opt_state=tx.init(state.params))
        # the draws the step makes: RCL noise from its key splits, dropout masks
        _, step_rng, _ = jax.random.split(state.rng, 3)
        noise = np.stack([np.asarray(jax.random.uniform(k, (batch * CROP[0] * CROP[1],)))
                          for k in jax.random.split(step_rng, 3)])
        masks = dropout_masks(10 + stage, batch)
        with masked_dropout(masks):
            state, loss, aux = make_train_step(jm, tx, rcl_params)(state, img, tgt)
        ref.append(dict(loss=float(loss), aux={k: float(v) for k, v in aux.items()},
                        grads=port_tree("params", state.opt_state[0]),
                        params=port_tree("params", state.params),
                        stats=port_tree("batch_stats", state.batch_stats)))
        draws.append({"rcl_noise": torch.from_numpy(noise), "dropout": {
            name.replace("_", "."): torch.from_numpy(m.transpose(0, 3, 1, 2).copy())
            for name, m in masks.items()}})
    ports = {}
    for dtype in (torch.float32, torch.float64):
        tr = TrainDeepLabOOD(cfg, model=DeepWV3Plus(**TINY), device="cpu")
        tr.load_jax_variables(variables)
        tr.model.to(dtype)  # in place: the optimizers keep the same parameters
        initial = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
        runs = []
        for stage in (0, 1):
            tr.set_stage(stage)
            loss, aux = tr.step(img_c, img_g, tgt_c, tgt_g, draws=draws[stage])
            runs.append(dict(loss=float(loss), aux={k: float(v) for k, v in aux.items()},
                             grads={n: p.grad.double().numpy()
                                    for n, p in tr.model.named_parameters() if p.grad is not None},
                             params={n: p.detach().double().numpy().copy()
                                     for n, p in tr.model.named_parameters()},
                             stats={n: b.double().numpy().copy()
                                    for n, b in tr.model.named_buffers()}))
        ports[dtype] = dict(runs=runs, initial=initial, model=tr.model)
    return dict(ref=ref, f32=ports[torch.float32], f64=ports[torch.float64],
                variables=variables, draws=draws)


@pytest.fixture(scope="module")
def two_ranks(steps, tmp_path_factory):
    """The same two steps on two gloo ranks of one pair each
    (``torch_dp_worker``), in f32 and in float64, from the same weights, global
    batch and global draws: rank 0's runs, after checking that both ranks end
    each step with the same parameters."""
    from torch_dp_worker import run_ranks, same_params

    job = dict(kind="deeplab", cfg=deeplab_cfg(), model=TINY,
               state=deeplab_from_jax(steps["variables"]),
               batch=synthetic_batch(PAIRS, CROP, 19, seed=4), draws=steps["draws"],
               dtypes=[torch.float32, torch.float64])
    ranks = run_ranks(job, tmp_path_factory.mktemp("two_ranks"))
    for dtype in ranks[0]:
        for stage in (0, 1):
            assert same_params([r[dtype][stage] for r in ranks]), (dtype, stage)
    return {dtype: runs for dtype, runs in ranks[0].items()}


@pytest.mark.parametrize("stage", [0, 1])
def test_step_losses_match_jax(steps, stage):
    ref, got = steps["ref"][stage], steps["f32"]["runs"][stage]
    assert set(got["aux"]) == set(ref["aux"])
    for k, v in ref["aux"].items():
        assert abs(got["aux"][k] - v) <= 1e-5 * max(abs(v), 1e-6), (k, got["aux"][k], v)
    assert abs(got["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    assert ref["aux"]["ce_aug"] > 0 and ref["aux"]["n_pairs"] > 0  # selection and pairs live


@pytest.mark.parametrize("stage", [0, 1])
def test_step_gradients_match_jax(steps, stage):
    """Every trainable parameter's gradient against the JAX f32 step, with the
    port's float64 step as the yardstick. In stage 1 the gradients pass through
    the head's train-mode BatchNorms, ReLUs and the pixel selection, and an f32
    step lands up to 1.4e-2 of a tensor's scale away from float64 (the port's
    own f32 and float64 steps differ that much; readings in PERF.md). So, as
    ``chip_smoke.py``'s parity rule, per tensor: the JAX f32 gradient may sit
    from the port's float64 one at most 4x as far as the port's f32 gradient
    does, plus 1e-3 of the tensor's scale."""
    ref, f32, f64 = steps["ref"][stage], steps["f32"]["runs"][stage], steps["f64"]["runs"][stage]
    trained = {n for n in ref["grads"] if trainable(n, stage)}
    assert set(f32["grads"]) == set(f64["grads"]) == trained  # nothing frozen is reached
    assert ("aspp.features.3.0.weight" in trained) == (stage == 1)
    for name in trained:
        exact = f64["grads"][name]
        scale = np.abs(exact).max()
        err_jax = np.abs(ref["grads"][name] - exact).max() / scale
        err_f32 = np.abs(f32["grads"][name] - exact).max() / scale
        assert err_jax <= 4 * err_f32 + 1e-3, (name, err_jax, err_f32)


def test_f32_step_meets_float64_on_the_same_relu_branches():
    """Why stage 1's f32 gradients sit up to ~1e-2 of scale from float64 (the
    test above): ReLU inputs within rounding of 0 take other sides. With the
    f32 step's ReLU branches replayed in the float64 step, the two differ by
    rounding alone: every trainable gradient within 1e-4 of its scale."""
    from multishiftseg_torch.utils import relu_sign_hooks

    cfg = deeplab_cfg()
    _, variables = tiny_variables(seed=2)
    batch = synthetic_batch(PAIRS, CROP, 19, seed=4)
    signs, grads = {}, {}
    for dtype in (torch.float32, torch.float64):
        tr = TrainDeepLabOOD(cfg, model=DeepWV3Plus(**TINY), device="cpu")
        tr.load_jax_variables(variables)
        tr.model.to(dtype)
        tr.set_stage(1)
        draws = tr.draws(2 * PAIRS, CROP)  # the same generator state on both
        hooks = relu_sign_hooks(tr.model, signs.setdefault(dtype, {}),
                                replay=signs[torch.float32] if dtype == torch.float64 else None)
        tr.step(*batch, draws=draws)
        for h in hooks:
            h.remove()
        grads[dtype] = {n: p.grad.double() for n, p in tr.model.named_parameters()
                        if p.grad is not None}
    assert len(grads[torch.float64]) == 18
    for name, exact in grads[torch.float64].items():
        err = (grads[torch.float32][name] - exact).abs().max() / exact.abs().max()
        assert err <= 1e-4, (name, float(err))


def test_dropout_in_training_needs_its_mask():
    from multishiftseg_torch.models.layers import Dropout2d

    drop = Dropout2d(0.5, 4).train()
    x = torch.ones(2, 4, 3, 3)
    with pytest.raises(ValueError, match="keep mask"):
        drop(x)
    mask = drop.draw_mask(2, torch.Generator().manual_seed(0), "cpu")
    torch.testing.assert_close(drop(x, mask), torch.where(mask, 2 * x, torch.zeros(())))
    assert drop.eval()(x) is x


@pytest.mark.parametrize("stage", [0, 1])
def test_step_running_statistics_match_jax(steps, stage):
    """Every BatchNorm's running mean and variance after the step (biased
    variance, as flax), within 1e-5 of each tensor's scale: the JAX f32
    forward's own rounding puts it up to 4.1e-6 from the port's float64 step."""
    ref, got = steps["ref"][stage]["stats"], steps["f32"]["runs"][stage]["stats"]
    assert set(got) == set(ref) and len(ref) > 40
    for name, want in ref.items():
        assert np.abs(got[name] - want).max() <= 1e-5 * np.abs(want).max(), name


def test_running_variance_follows_flax_not_torch():
    """One training forward of a batch of 36 samples a channel: the port's
    running variance takes the biased batch variance (flax), not the
    unbiased one torch's own BatchNorm takes."""
    from multishiftseg_torch.models.layers import BatchNorm2d

    x = torch.from_numpy(np.random.RandomState(15).randn(4, 3, 3, 3).astype(np.float32) * 2)
    ours, theirs = BatchNorm2d(3), torch.nn.BatchNorm2d(3)
    ours.train()(x)
    theirs.train()(x)
    var = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(ours.running_var, 0.9 + 0.1 * var)
    assert not torch.allclose(theirs.running_var, ours.running_var)
    flax_bn = flax.linen.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = flax_bn.init(jax.random.PRNGKey(0), jnp.asarray(x.permute(0, 2, 3, 1).numpy()))
    _, upd = flax_bn.apply(v, jnp.asarray(x.permute(0, 2, 3, 1).numpy()), mutable=["batch_stats"])
    np.testing.assert_allclose(ours.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-6)


@pytest.mark.parametrize("stage", [0, 1])
def test_step_updates_match_jax(steps, stage):
    """Adam's first step is about lr * sign(g + wd * p): compare where the
    gradient is far above eps and clear of sign noise; frozen parameters keep
    their values bit for bit."""
    cfg = deeplab_cfg()
    lr = (cfg.train.lr, cfg.train.lr_update)[stage]
    ref, got = steps["ref"][stage], steps["f32"]["runs"][stage]
    checked = 0
    for name, want in ref["params"].items():
        g = ref["grads"][name]
        if not trainable(name, stage):
            # frozen in both stages: exactly the loaded value, on both sides
            assert not trainable(name, 0)
            initial = steps["f32"]["initial"][name].double().numpy()
            assert np.array_equal(got["params"][name], initial), name
            assert np.array_equal(want, initial), name
            continue
        sel = (np.abs(g) > 1e-6) & (np.abs(g) > 1e-2 * np.abs(g).max())
        # 1e-2 of the step, plus 4 f32 ulps of the largest entry (stage 1's step
        # of 1e-6 is a few ulps of a 0.3 weight)
        atol = 1e-2 * lr + 2.0 ** -21 * np.abs(want).max()
        np.testing.assert_allclose(got["params"][name][sel], want[sel], rtol=0, atol=atol,
                                   err_msg=name)
        checked += int(sel.sum())
    assert checked > 100


@pytest.mark.parametrize("stage", [0, 1])
def test_stage_trainable_sets_equal_jax_mask(stage):
    """Each stage's trainable set, parameter by parameter through the
    converter's name map, equals ``trainable_mask`` on the full WRN-38 tree."""
    cfg = load_config("exps/deeplab.yaml")
    names = (cfg.model.trainable_params_name, cfg.model.trainable_params_name_update)[stage]
    assert tuple(names) == STAGE_NAMES[stage]
    params = jax.eval_shape(lambda: JaxDeepLab().init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3)), train=False))["params"]
    mask = flax.traverse_util.flatten_dict(jax_trainable_mask(params, names))
    with torch.device("meta"):
        model = DeepWV3Plus()
    tr = TrainDeepLabOOD.__new__(TrainDeepLabOOD)
    tr.cfg, tr.model = cfg, model
    tr.set_stage(stage)
    assert {deeplab_port_key(k) for k in mask} == {n for n, _ in model.named_parameters()}
    assert {n for n, p in model.named_parameters() if p.requires_grad} == {
        deeplab_port_key(k) for k, v in mask.items() if v}
    group = tr.optimizer.param_groups[0]
    assert (group["lr"], group["weight_decay"]) == (
        (cfg.train.lr, cfg.train.lr_update)[stage], cfg.train.weight_decay)


def test_make_rcl_params_reads_deeplab_yaml():
    cfg = load_config("exps/deeplab.yaml")
    ours = rcl.make_rcl_params(cfg.loss.params)
    assert ours == rcl.RCLParams(**vars(jax_rcl.make_rcl_params(cfg.loss.params)))
    assert ours.conduct_pixel_selection and ours.selection_ratio == 0.8
    assert ours.ce_weights == (50, 10) and ours.inoutaug_contras_margins_tri == (10, 5, 5)


def test_draws_come_from_the_trainer_generator():
    cfg = deeplab_cfg()
    a = TrainDeepLabOOD(cfg, model=DeepWV3Plus(**TINY), device="cpu").draws(4, (16, 8))
    b = TrainDeepLabOOD(cfg, model=DeepWV3Plus(**TINY), device="cpu").draws(4, (16, 8))
    assert tuple(a["rcl_noise"].shape) == (3, 4 * 16 * 8)
    assert {k: tuple(v.shape) for k, v in a["dropout"].items()} == {
        "mod6.block1": (4, 16, 1, 1), "mod7.block1": (4, 32, 1, 1)}
    assert torch.equal(a["rcl_noise"], b["rcl_noise"])
    assert all(torch.equal(a["dropout"][k], b["dropout"][k]) for k in a["dropout"])


@pytest.mark.parametrize("stage", [0, 1])
def test_two_rank_step_matches_jax(steps, two_ranks, stage):
    """The step of the global batch split over two ranks (train-mode
    BatchNorm over the global batch, RCL's global bottom-k and pairs, DDP's
    average of the summed all-reduce backward) against JAX's single-process
    step, at this file's tolerances: losses and components within 1e-5,
    running statistics within 1e-5 of scale, the updates as
    ``test_step_updates_match_jax``. Gradients: the two-rank float64 step is
    the single-process float64 step (every gradient within 1e-9 of scale),
    which ``test_step_gradients_match_jax`` holds to JAX; and the two-rank f32
    gradient sits from the float64 one at most 4x as far as this step's other
    f32 runs do (JAX's or the single-process port's, whichever is farther:
    f32 rounding at ReLU kinks moves each run's gradients by up to 1.5e-2 of
    scale, at units of its own), plus 1e-3 of scale."""
    ref, f64, f32 = steps["ref"][stage], steps["f64"]["runs"][stage], steps["f32"]["runs"][stage]
    got, got64 = two_ranks["torch.float32"][stage], two_ranks["torch.float64"][stage]
    assert set(got["parts"]) == set(ref["aux"])
    for k, v in ref["aux"].items():
        assert abs(got["parts"][k] - v) <= 1e-5 * max(abs(v), 1e-6), (k, got["parts"][k], v)
    assert abs(got["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    for name, want in ref["stats"].items():
        assert np.abs(got["stats"][name] - want).max() <= 1e-5 * np.abs(want).max(), name
    assert set(got["grads"]) == set(got64["grads"]) == set(f64["grads"])
    for name, exact in f64["grads"].items():
        scale = np.abs(exact).max()
        err_dp = np.abs(got["grads"][name] - exact).max() / scale
        err_f32 = max(np.abs(ref["grads"][name] - exact).max(),
                      np.abs(f32["grads"][name] - exact).max()) / scale
        assert err_dp <= 4 * err_f32 + 1e-3, (name, err_dp, err_f32)
        assert np.abs(got64["grads"][name] - exact).max() <= 1e-9 * scale, name
    lr = (deeplab_cfg().train.lr, deeplab_cfg().train.lr_update)[stage]
    for name, want in ref["params"].items():
        g = ref["grads"][name]
        sel = (np.abs(g) > 1e-6) & (np.abs(g) > 1e-2 * np.abs(g).max())
        atol = 1e-2 * lr + 2.0 ** -21 * np.abs(want).max()
        np.testing.assert_allclose(got["params"][name][sel], want[sel], rtol=0, atol=atol,
                                   err_msg=name)
