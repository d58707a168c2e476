"""PyTorch port, the trainers' steps over the tiny Swin of ``test_torch_swin.py``
against JAX's on the CPU: one ``TrainM2FOOD`` stage-2 step (the GMA MaskFormer)
and one ``TrainM2FInstance`` step (the vanilla one), each with drop path acting
on numpy-made masks both sides take (``test_torch_swin.jax_drop_path``), in
the float64-twin style of ``test_torch_train.py``: the losses, every
parameter's gradient of the port's float64 step against JAX's f32 one, and
the AdamW update. The float64 step follows JAX's ReLU branches
(:func:`jax_relu_signs` replayed through ``utils.relu_sign_hooks``), and every
unit where its own branch differs must lie within rounding of 0.
"""

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp
import optax

from multishiftseg_tpu.losses import criterion as jax_criterion
from multishiftseg_tpu.losses import rcl as jax_rcl
from multishiftseg_tpu.models.maskformer import MaskFormer as JaxMaskFormer
from multishiftseg_tpu.train.state import build_m2f_official_optimizer as jax_optimizer

from multishiftseg_torch.convert.from_jax import maskformer_from_jax
from multishiftseg_torch.models.maskformer import MaskFormer
from multishiftseg_torch.train.instance_trainer import TrainM2FInstance
from multishiftseg_torch.train.m2f_trainer import TrainM2FOOD, synthetic_batch
from multishiftseg_torch.utils import relu_sign_hooks

from test_torch_swin import drop_masks, jax_drop_path, micro_swin, rel_err, seeded_variables
from test_torch_train import BASE_LR, CROP, HW, K, PAIRS, RCL, crit_cfg, jax_draws
from test_torch_train import to_torch, _tiny_cfg


MODEL = dict(num_classes=K, backbone="swin_micro", hidden_dim=64, num_queries=8, nheads=4,
             dim_feedforward=128, dec_layers=3, mask_dim=64, transformer_enc_layers=2)
# a unit on the other branch of a ReLU than JAX's: its |input| at most this
# share of its call's largest |input| (f32 rounding carried through the
# network; the units seen lie at 2e-7)
FLIP_RTOL = 1e-5
# the modules whose outputs JAX's ReLUs take (the Swin blocks use GELU)
RELU_INPUTS = ("linear1", "layers_0", "layers_1") + tuple(f"layer_{i}_gn" for i in range(1, 4))


def capture_relu_inputs(module, method):
    return method == "__call__" and module.name in RELU_INPUTS


def jax_relu_signs(intermediates, dec_layers):
    """JAX's ReLU branches (input > 0) under the port's ``relu_sign_hooks``
    keys, from the intermediates :func:`capture_relu_inputs` kept: the
    deformable encoder's FFNs, the FPN's output convs (NHWC to NCHW), the
    decoder's FFNs and the mask-embedding MLP's two ReLUs a prediction. The
    GMA decoder runs that MLP twice a layer on the same input (class and OOD
    heads) where the port runs it once; both JAX calls must take one branch."""
    flat = {"/".join(k[:-1]): v for k, v in  # per module, a tuple of its calls
            flax.traverse_util.flatten_dict(intermediates).items()}
    out = {}
    for key, v in flat.items():
        path = key.split("/")
        if path[-2:-1] == ["pixel_decoder"] and path[-1].endswith("_gn"):
            port = f"sem_seg_head.pixel_decoder.{path[-1][:-3]}"
            v = (np.transpose(v[0], (0, 3, 1, 2)),)
        elif path[-1] == "linear1" and path[-2].startswith("encoder_layer_"):
            port = "sem_seg_head.pixel_decoder.transformer.encoder.layers." + path[-2][14:]
        elif path[-1] == "linear1" and path[-2].startswith("ffn_"):
            port = f"sem_seg_head.predictor.transformer_ffn_layers.{path[-2][4:]}"
        else:
            continue
        assert len(v) == 1, key  # one call a forward
        out[port] = v[0]
    mlp = [flat[f"predictor/mask_embed/layers_{j}"] for j in (0, 1)]
    calls = len(mlp[0])
    if calls == 2 * dec_layers + 1:  # GMA: the initial call, then (class, OOD) a layer
        for j in (0, 1):
            for n in range(1, dec_layers + 1):
                assert np.array_equal(mlp[j][2 * n - 1] > 0, mlp[j][2 * n] > 0)
        calls = [0] + [2 * n - 1 for n in range(1, dec_layers + 1)]
    else:
        assert calls == dec_layers + 1
        calls = list(range(calls))
    for n, c in enumerate(calls):
        for j in (0, 1):
            k = 2 * n + j
            out["sem_seg_head.predictor.mask_embed" + (f"#{k}" if k else "")] = mlp[j][c]
    return {k: torch.from_numpy(np.asarray(v) > 0) for k, v in out.items()}


def replayed_step(trainer, replay, step):
    """``step()`` with ``trainer.model``'s ReLUs on ``replay``'s branches:
    its result and, per ReLU call whose own branch differs, the flips."""
    signs, flips = {}, {}
    hooks = relu_sign_hooks(trainer.model, signs, replay=replay, flips=flips)
    try:
        out = step()
    finally:
        for h in hooks:
            h.remove()
    assert set(signs) == set(replay)
    return out, flips


@pytest.fixture(scope="module")
def stage2_run():
    """One JAX stage-2 step on the micro-Swin MaskFormer (``train=True``, so
    drop path acts, with no ``batch_stats``: Swin has no BatchNorm) and the
    port's, in f32 and in float64, from the same weights, batch and draws."""
    img_c, img_g, tgt_c, tgt_g = synthetic_batch(PAIRS, CROP, K, seed=0)
    pad = ((0, 0), (0, HW[0] - CROP[0]), (0, HW[1] - CROP[1]))
    img_p = np.pad(np.concatenate([img_c, img_g]), pad + ((0, 0),))
    sem_p = np.pad(np.concatenate([tgt_c, tgt_g]), pad, constant_values=255)
    with micro_swin():
        jm = JaxMaskFormer(**MODEL)
        variables = seeded_variables(jm, 1, jnp.zeros((1, *HW, 3)), train=False)
        assert set(variables) == {"params"}
        jcfg = jax_criterion.CriterionConfig(**crit_cfg())
        tx, opt_state = jax_optimizer(variables["params"], base_lr=BASE_LR,
                                      weight_decay=0.05, clip_value=0.01)
        key = jax.random.PRNGKey(1)
        t32 = TrainM2FOOD(_tiny_cfg(), model=MaskFormer(**MODEL), device="cpu")
        masks = drop_masks(t32.model.backbone, 2 * PAIRS, seed=4)

        def step(params, opt_state, img, sem):
            def loss_fn(p):
                out, st = jm.apply({"params": p}, img, train=True,
                                   rngs={"dropout": jax.random.PRNGKey(2)},
                                   capture_intermediates=capture_relu_inputs,
                                   mutable=["intermediates"])
                loss, losses = jax_criterion.set_criterion(out, sem, key, jcfg,
                                                           jax_rcl.RCLParams(**RCL), crop_hw=CROP)
                return loss, (losses, st["intermediates"])

            (loss, (losses, inter)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            updates, _ = tx.update(grads, opt_state, params)
            return loss, losses, inter, grads, optax.apply_updates(params, updates)

        with jax_drop_path(masks):
            loss, losses, inter, grads, new_params = jax.tree_util.tree_map(
                np.asarray, jax.jit(step)(variables["params"], opt_state, jnp.asarray(img_p),
                                          jnp.asarray(sem_p)))
        draws = to_torch(jax_draws(key, 2 * PAIRS, jcfg, HW, CROP))
        draws["drop_path"] = torch.from_numpy(masks)
        t32.set_stage(1)
        t32.load_jax_variables(variables)
        t_loss, t_losses, _, _ = t32.stage2_step(img_c, img_g, tgt_c, tgt_g, draws=draws)
        t64 = TrainM2FOOD(_tiny_cfg(), model=MaskFormer(**MODEL), device="cpu")
        t64.set_stage(1)
        t64.load_jax_variables(variables)
        t64.model.double()
        (loss64, _, grad_norm, _), flips = replayed_step(
            t64, jax_relu_signs(inter, MODEL["dec_layers"]),
            lambda: t64.stage2_step(img_c, img_g, tgt_c, tgt_g, draws=draws))
    return dict(loss=loss, losses=losses, grads=maskformer_from_jax({"params": grads}),
                new_params=maskformer_from_jax({"params": new_params}), t_loss=t_loss,
                t_losses=t_losses, loss64=loss64, trainer=t64, flips=flips,
                scale=min(1.0, 0.01 / float(grad_norm)))


def _check_step(r, base_lr):
    """Losses within 1e-4; every unit where the float64 port's own ReLU branch
    differs from JAX's within FLIP_RTOL of 0; every gradient of the float64
    port (on JAX's branches) within 1e-3 of its tensor's scale of JAX's f32
    one; the AdamW update where the clipped gradient is clear of eps and of
    sign noise."""
    assert all(f["max_abs_over_scale"] <= FLIP_RTOL for f in r["flips"].values()), r["flips"]
    assert set(r["t_losses"]) == set(r["losses"])
    for k, v in r["losses"].items():
        assert rel_err(float(r["t_losses"][k]), float(v)) < 1e-4, k
    assert rel_err(float(r["t_loss"]), float(r["loss"])) < 1e-4
    assert rel_err(float(r["loss64"]), float(r["loss"])) < 1e-4
    params = dict(r["trainer"].model.named_parameters())
    assert set(params) == set(r["grads"])
    bad = []
    for name, ref in r["grads"].items():
        ref = ref.numpy()
        got = params[name].grad.numpy() / r["scale"]
        if "input_proj" in name and name.endswith(".0.bias"):  # 0 in exact arithmetic
            continue
        if np.abs(got - ref).max() > 1e-3 * max(np.abs(ref).max(), 1e-9):
            bad.append((name, float(np.abs(got - ref).max() / np.abs(ref).max())))
    assert not bad, bad[:5]
    assert float(params["backbone.layers.0.blocks.1.attn.relative_position_bias_table"]
                 .grad.abs().max()) > 0
    checked = 0
    for name, param in params.items():
        g = r["grads"][name].numpy()
        sel = (np.abs(g * r["scale"]) > 1e-6) & (np.abs(g) > 1e-2 * np.abs(g).max())
        np.testing.assert_allclose(param.detach().float().numpy()[sel],
                                   r["new_params"][name].numpy()[sel], rtol=0,
                                   atol=1e-3 * base_lr, err_msg=name)
        checked += int(sel.sum())
    assert checked > 10000


def test_swin_stage2_step_matches_jax(stage2_run):
    _check_step(stage2_run, BASE_LR)


@pytest.fixture(scope="module")
def instance_run():
    """One JAX instance step (the vanilla decoder over the micro Swin,
    ``train=True``) and the port's ``TrainM2FInstance.step``, f32 and float64."""
    from test_torch_instance_model import B, CROP as ICROP, T, crit_kw, instance_jax_draws
    from test_torch_instance_model import instance_targets
    from test_torch_instance_step import BASE_LR as ILR, _tiny_cfg as instance_cfg

    cfg = dict(MODEL, num_classes=8, predictor="vanilla")
    img = np.random.RandomState(11).randn(B, *ICROP, 3).astype(np.float32)
    id_map, classes = instance_targets(12)
    with micro_swin():
        jm = JaxMaskFormer(**cfg)
        variables = seeded_variables(jm, 3, jnp.zeros((1, *ICROP, 3)), train=False)
        jcfg = jax_criterion.CriterionConfig(**crit_kw())
        tx, opt_state = jax_optimizer(variables["params"], base_lr=ILR, weight_decay=0.05,
                                      clip_value=0.01)
        key = jax.random.PRNGKey(13)

        def trainer():
            tr = TrainM2FInstance(instance_cfg(), model=MaskFormer(**cfg),
                                  dataset_name="unused", device="cpu")
            tr.model.load_state_dict(maskformer_from_jax(variables), strict=True)
            return tr

        t32 = trainer()
        masks = drop_masks(t32.model.backbone, B, seed=5)

        def step(params, opt_state, img, id_map, classes):
            def loss_fn(p):
                out, st = jm.apply({"params": p}, img, train=True,
                                   rngs={"dropout": jax.random.PRNGKey(2)},
                                   capture_intermediates=capture_relu_inputs,
                                   mutable=["intermediates"])
                loss, losses = jax_criterion.set_criterion_instance(out, id_map, classes, key,
                                                                    jcfg)
                return loss, (losses, st["intermediates"])

            (loss, (losses, inter)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            updates, _ = tx.update(grads, opt_state, params)
            return loss, losses, inter, grads, optax.apply_updates(params, updates)

        with jax_drop_path(masks):
            loss, losses, inter, grads, new_params = jax.tree_util.tree_map(
                np.asarray, jax.jit(step)(variables["params"], opt_state, jnp.asarray(img),
                                          jnp.asarray(id_map), jnp.asarray(classes)))
        draws = to_torch(instance_jax_draws(key, B, T, jcfg, n_aux=cfg["dec_layers"]))
        draws["drop_path"] = torch.from_numpy(masks)
        t_loss, t_losses, _, _ = t32.step(img, id_map, classes, draws=draws)
        t64 = trainer()
        t64.model.double()
        (loss64, _, grad_norm, _), flips = replayed_step(
            t64, jax_relu_signs(inter, cfg["dec_layers"]),
            lambda: t64.step(img, id_map, classes, draws=draws))
    return dict(loss=loss, losses=losses, grads=maskformer_from_jax({"params": grads}),
                new_params=maskformer_from_jax({"params": new_params}), t_loss=t_loss,
                t_losses=t_losses, loss64=loss64, trainer=t64, flips=flips,
                scale=min(1.0, 0.01 / float(grad_norm)), base_lr=ILR)


def test_swin_instance_step_matches_jax(instance_run):
    _check_step(instance_run, instance_run["base_lr"])


def test_trainers_draw_drop_path_masks():
    """Both trainers' ``draws`` carry the Swin keep masks from their generator
    (JAX draws them in both OOD stages and in the instance step)."""
    from test_torch_instance_step import _tiny_cfg as instance_cfg

    with micro_swin():
        tr = TrainM2FOOD(_tiny_cfg(), model=MaskFormer(**MODEL), device="cpu")
        for stage in (0, 1):
            tr.set_stage(stage)
            d = tr.draws(2 * PAIRS, HW)
            assert d["drop_path"].dtype == torch.bool
            assert tuple(d["drop_path"].shape) == (14, 2 * PAIRS)
        inst = TrainM2FInstance(instance_cfg(), model=MaskFormer(**dict(MODEL, num_classes=8,
                                                                       predictor="vanilla")),
                                dataset_name="unused", device="cpu")
        assert tuple(inst.draws(2, 6)["drop_path"].shape) == (14, 2)
    tr = TrainM2FOOD(_tiny_cfg(), model=MaskFormer(**dict(MODEL, backbone="resnet50")),
                     device="cpu")
    assert tr.draws(2, HW)["drop_path"] is None
