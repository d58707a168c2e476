"""PyTorch port, one ``TrainM2FInstance`` step against a JAX step on the CPU:
the loss and its 16 components (deep supervision over the vanilla decoder's
3 layers), every parameter's gradient and the parameters after the official
AdamW step, from the same weights, batch and draws.

The sizes of ``test_torch_instance_model.py`` (tiny widths, 8 classes, 2
unpadded 72x72 crops, 6 target slots with duplicates and padding, 64 points,
fp32). As for the stage-2 step (``test_torch_train.py``), the gradients are
held with the port's step in float64.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from multishiftseg_tpu.losses import criterion as jax_criterion
from multishiftseg_tpu.train.state import build_m2f_official_optimizer as jax_optimizer

from multishiftseg_torch.convert.from_jax import maskformer_from_jax
from multishiftseg_torch.core.config import load_config
from multishiftseg_torch.models.maskformer import MaskFormer
from multishiftseg_torch.train.instance_trainer import TrainM2FInstance

from test_torch_instance_model import (B, CFG, CROP, P, T, crit_kw, instance_jax_draws,
                                       instance_targets, jax_model, rel_err,  # noqa: F401
                                       to_torch)

BASE_LR = 1e-3


def _tiny_cfg():
    cfg = load_config("exps/m2f_instance.yaml")
    cfg.data.crop_size = CROP
    cfg.model.m2f.train_num_points = P
    cfg.model.m2f.base_lr = BASE_LR
    cfg.model.m2f.max_instances = T
    cfg.train.bf16 = False
    return cfg


@pytest.fixture(scope="module")
def step_run(jax_model):
    """One JAX instance step (value_and_grad of ``set_criterion_instance`` on
    the vanilla model + the official AdamW) and the port's trainer after the
    same step, from the same weights, batch and draws."""
    jm, variables = jax_model
    img = np.random.RandomState(11).randn(B, *CROP, 3).astype(np.float32)
    id_map, classes = instance_targets(12)
    jcfg = jax_criterion.CriterionConfig(**crit_kw())
    tx, opt_state = jax_optimizer(variables["params"], base_lr=BASE_LR, weight_decay=0.05,
                                  clip_value=0.01)
    key = jax.random.PRNGKey(13)

    @jax.jit
    def step(params, opt_state, img, id_map, classes):
        def loss_fn(p):
            out = jm.apply({"params": p, "batch_stats": variables["batch_stats"]}, img,
                           train=True)
            return jax_criterion.set_criterion_instance(out, id_map, classes, key, jcfg)

        (loss, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, opt_state, params)
        return loss, losses, grads, optax.apply_updates(params, updates)

    loss, losses, grads, new_params = jax.tree_util.tree_map(np.asarray, step(
        variables["params"], opt_state, jnp.asarray(img), jnp.asarray(id_map),
        jnp.asarray(classes)))
    draws = to_torch(instance_jax_draws(key, B, T, jcfg, n_aux=CFG["dec_layers"]))

    def trainer():
        tr = TrainM2FInstance(_tiny_cfg(), model=MaskFormer(**CFG, predictor="vanilla"),
                              dataset_name="unused", device="cpu")
        tr.model.load_state_dict(maskformer_from_jax(variables), strict=True)
        return tr

    # the f32 step; and the same step in float64, which holds the gradients
    # (a ReLU input within f32 rounding of 0 may take the other side in each
    # framework and move the gradients below it, see test_torch_train.py)
    t32 = trainer()
    t_loss, t_losses, _, t_assign = t32.step(img, id_map, classes, draws=draws)
    t64 = trainer()
    t64.model.double()  # in place: the optimizer keeps the same parameters
    loss64, _, grad_norm, _ = t64.step(img, id_map, classes, draws=draws)
    return dict(loss=loss, losses=losses, grads=maskformer_from_jax({"params": grads}),
                new_params=maskformer_from_jax({"params": new_params}), t_loss=t_loss,
                t_losses=t_losses, loss64=loss64, trainer=t64, t_assign=t_assign,
                scale=min(1.0, 0.01 / float(grad_norm)), variables=variables,
                batch=(img, id_map, classes), draws=draws)


@pytest.fixture(scope="module")
def two_ranks(step_run, tmp_path_factory):
    """The same instance step on two gloo ranks of one image each
    (``torch_dp_worker``), in f32 and in float64, from the same weights, global
    batch and global draws: rank 0's runs by dtype, after checking that both
    ranks end the step with the same parameters."""
    from torch_dp_worker import run_ranks, same_params

    job = dict(kind="instance", cfg=_tiny_cfg(), model=CFG,
               state=maskformer_from_jax(step_run["variables"]), batch=step_run["batch"],
               draws=step_run["draws"], dtypes=[torch.float32, torch.float64])
    ranks = run_ranks(job, tmp_path_factory.mktemp("two_ranks"))
    for dtype in ranks[0]:
        assert same_params([r[dtype] for r in ranks]), dtype
    return ranks[0]


def test_two_rank_instance_step_matches_jax(step_run, two_ranks):
    """The instance step of the global batch split over two ranks (the
    criterion's ``num_masks`` and normalisers over the global batch, the clip
    on the all-reduced gradient) against JAX's single-process step, at this
    file's tolerances: losses within 1e-4 in f32 and float64, every gradient of
    the float64 run within 1e-3 of scale (the input projections' conv biases,
    0 in exact arithmetic, within 1e-8 of the largest gradient), the AdamW
    update as above; and the two-rank float64 step is the single-process
    float64 step, gradients within 1e-6 of scale (the f32 draws and
    point coordinates round differently at another batch split)."""
    r = step_run
    got, got64 = two_ranks["torch.float32"], two_ranks["torch.float64"]
    assert set(got["parts"]) == set(r["losses"])
    for k, v in r["losses"].items():
        assert rel_err(got["parts"][k], float(v)) < 1e-4, k
        assert rel_err(got64["parts"][k], float(v)) < 1e-4, k
    assert rel_err(got["loss"], float(r["loss"])) < 1e-4
    scale = min(1.0, 0.01 / got64["grad_norm"])
    single = dict(r["trainer"].model.named_parameters())
    top = max(float(np.abs(g.numpy()).max()) for g in r["grads"].values())
    bad = []
    for name, ref in r["grads"].items():
        ref = ref.numpy()
        grad = got64["grads"][name]
        exact = single[name].grad.numpy()
        if "input_proj" in name and name.endswith(".0.bias"):
            assert max(np.abs(grad / scale).max(), np.abs(ref).max()) < 1e-8 * top, name
            continue
        if np.abs(grad / scale - ref).max() > 1e-3 * max(np.abs(ref).max(), 1e-9):
            bad.append(name)
        assert np.abs(grad - exact).max() <= 1e-6 * max(np.abs(exact).max(), 1e-30), name
    assert not bad, bad[:5]
    for name, g in r["grads"].items():
        g = g.numpy()
        sel = (np.abs(g * r["scale"]) > 1e-6) & (np.abs(g) > 1e-2 * np.abs(g).max())
        np.testing.assert_allclose(got["params"][name][sel], r["new_params"][name].numpy()[sel],
                                   rtol=0, atol=1e-3 * BASE_LR, err_msg=name)


def test_instance_step_losses_match_jax(step_run):
    r = step_run
    assert set(r["t_losses"]) == set(r["losses"])
    assert len(r["t_losses"]) == 3 * (CFG["dec_layers"] + 1)  # deep supervision
    for k, v in r["losses"].items():
        assert rel_err(float(r["t_losses"][k]), float(v)) < 1e-4, k
    assert rel_err(float(r["t_loss"]), float(r["loss"])) < 1e-4
    assert rel_err(float(r["loss64"]), float(r["loss"])) < 1e-4
    assert len(r["t_assign"]) == CFG["dec_layers"] + 1


def test_instance_step_gradients_match_jax(step_run):
    """Every parameter's gradient within 1e-3 of its tensor's scale (the port in
    float64 against the JAX f32 step). The input projections' conv biases,
    which a GroupNorm follows, have a gradient of 0 in exact arithmetic: there
    JAX's f32 step holds rounding noise (up to 3e-9 of the largest gradient
    with this seed), so both sides are held to 0 instead, at 1e-8 of it."""
    r = step_run
    params = dict(r["trainer"].model.named_parameters())
    assert set(params) == set(r["grads"])
    top = max(float(np.abs(g.numpy()).max()) for g in r["grads"].values())
    bad = []
    for name, ref in r["grads"].items():
        ref = ref.numpy()
        got = params[name].grad.numpy() / r["scale"]
        if "input_proj" in name and name.endswith(".0.bias"):
            assert max(np.abs(got).max(), np.abs(ref).max()) < 1e-8 * top, name
            continue
        tol = 1e-3 * max(np.abs(ref).max(), 1e-9)
        if np.abs(got - ref).max() > tol:
            bad.append((name, float(np.abs(got - ref).max()), tol))
    assert not bad, bad[:5]
    nonzero = sum(float(np.abs(g.numpy()).max()) > 0 for g in r["grads"].values())
    assert nonzero > 0.9 * len(r["grads"])


def test_instance_step_adamw_update_matches_jax(step_run):
    """Adam's first step is about lr * sign(g): compare where the clipped
    gradient is far above eps (1e-8) and clear of sign noise."""
    r = step_run
    checked = 0
    for name, param in r["trainer"].model.named_parameters():
        g = r["grads"][name].numpy()
        sel = (np.abs(g * r["scale"]) > 1e-6) & (np.abs(g) > 1e-2 * np.abs(g).max())
        got = param.detach().float().numpy()[sel]
        want = r["new_params"][name].numpy()[sel]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * BASE_LR, err_msg=name)
        checked += int(sel.sum())
    assert checked > 10000


def test_instance_step_f32_meets_float64_on_the_same_relu_branches(jax_model):
    """The f32 and float64 steps of the port differ by rounding alone once the
    float64 step follows the f32 step's ReLU branches (``relu_sign_hooks``,
    which reaches the backbone's, the pixel decoder's and the decoder's
    functional ReLUs as well as ``nn.ReLU`` modules): every input whose sign
    differs lies within 1e-6 of its call's largest |input|, and every
    gradient within 1e-4 of its tensor's scale (the input projections' conv
    biases, 0 in exact arithmetic, within 1e-8 of the largest gradient, as
    above)."""
    from multishiftseg_torch.utils import relu_sign_hooks

    _, variables = jax_model
    img = np.random.RandomState(11).randn(B, *CROP, 3).astype(np.float32)
    id_map, classes = instance_targets(12)
    signs, flips, grads = {}, {}, {}
    for dtype in ("float32", "float64"):
        tr = TrainM2FInstance(_tiny_cfg(), model=MaskFormer(**CFG, predictor="vanilla"),
                              dataset_name="unused", device="cpu")
        tr.model.load_state_dict(maskformer_from_jax(variables), strict=True)
        if dtype == "float64":
            tr.model.double()
        draws = tr.draws(B, T)  # the same generator state on both
        hooks = relu_sign_hooks(tr.model, signs.setdefault(dtype, {}),
                                replay=signs["float32"] if dtype == "float64" else None,
                                flips=flips)
        try:
            tr.step(img, id_map, classes, draws=draws)
        finally:
            for h in hooks:
                h.remove()
        grads[dtype] = {n: p.grad.double() for n, p in tr.model.named_parameters()}
    assert torch.nn.functional.relu.__module__ == "torch.nn.functional"  # restored
    names = set(signs["float32"])
    assert names == set(signs["float64"])
    assert any(n.startswith("backbone.") for n in names)
    assert any(n.startswith("sem_seg_head.pixel_decoder.") for n in names)
    assert any(n.startswith("sem_seg_head.predictor.transformer_ffn_layers.") for n in names)
    assert all(f["max_abs_over_scale"] <= 1e-6 for f in flips.values()), flips
    top = max(float(g.abs().max()) for g in grads["float64"].values())
    bad = []
    for name, exact in grads["float64"].items():
        got = grads["float32"][name]
        if "input_proj" in name and name.endswith(".0.bias"):  # 0 in exact arithmetic
            assert max(float(got.abs().max()), float(exact.abs().max())) < 1e-8 * top, name
            continue
        err = float((got - exact).abs().max() / exact.abs().max().clamp_min(1e-30))
        if err > 1e-4:
            bad.append((name, err))
    assert not bad, bad[:5]
