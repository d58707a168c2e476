"""PyTorch port, the stage-2 training slice against the JAX package on the CPU.

The RCL loss, every set-criterion component, the AdamW parameter groups and one
whole stage-2 step (loss, every parameter's gradient, the parameters after one
AdamW step) at a tiny size: 5 classes, hidden 64, 8 queries, 2 encoder and 3
decoder layers, R-50 at its own widths, 2 pairs of 60x60 crops padded to 64x64,
64 points, 256 pixel pairs. Random numbers are made once by replaying the JAX
key splits (:func:`jax_draws`) and handed to the port as tensors, so both sides
see the very same draws.
"""

import dataclasses

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
from multishiftseg_tpu.train.m2f_trainer import copy_class_embed_to_ood as jax_copy_ood
from multishiftseg_tpu.train.state import build_m2f_official_optimizer as jax_optimizer
from multishiftseg_tpu.train.state import m2f_param_rules as jax_param_rules

from multishiftseg_torch.convert.from_jax import maskformer_from_jax, port_key
from multishiftseg_torch.core.config import load_config
from multishiftseg_torch.losses import criterion, rcl
from multishiftseg_torch.models.maskformer import MaskFormer
from multishiftseg_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from multishiftseg_torch.train.m2f_trainer import (TrainM2FOOD, copy_class_embed_to_ood,
                                                  pad_batch, synthetic_batch)
from multishiftseg_torch.train.state import build_stage_optimizer

K, PAIRS, CROP, HW = 5, 2, (60, 60), (64, 64)
MODEL = dict(num_classes=K, hidden_dim=64, num_queries=8, nheads=4, dim_feedforward=128,
             dec_layers=3, mask_dim=64, transformer_enc_layers=2)
BASE_LR = 1e-3
RCL = dict(ce_weights=(0.0, 0.0), inoutaug_contras_margins_tri=(0.7, 0.5, 0.2),
           num_pair_samples=256)


def crit_cfg(**kw):
    """exps/m2f.yaml's criterion at 64 points."""
    base = dict(num_classes=K, num_points=64, class_weight=5.0, mask_weight=10.0,
                dice_weight=10.0, ood_weight=1.0, ood_loss="RCL")
    base.update(kw)
    return base


def jax_draws(key, batch, cfg, label_hw, crop_hw=None, n_aux=0):
    """The draws ``set_criterion`` makes from ``key``, in the port's layout
    (``criterion_draws``): the JAX key splits replayed, as numpy arrays."""
    K_, P, half = cfg.num_classes, cfg.num_points, batch // 2
    uni = lambda k, shape: np.asarray(jax.random.uniform(k, shape))

    def one(rng):
        k_match, k_orig, k_clean = jax.random.split(rng, 3)
        d = {"match_coords": uni(k_match, (batch, P, 2))}
        if cfg.mask_loss_with_pixel_selection:
            n_s = int(P * cfg.clean_oversample)
            n_r = P - int(cfg.clean_importance_ratio * P)
            d["orig_coords"] = uni(k_orig, (half, K_, P, 2))
            pairs = [jax.random.split(k) for k in jax.random.split(k_clean, half * K_)]
            d["clean_coords"] = np.stack([uni(a, (n_s, 2)) for a, _ in pairs])
            d["clean_rand"] = np.stack([uni(b, (n_r, 2)) for _, b in pairs])
        else:
            n_s = int(P * cfg.oversample_ratio)
            n_r = P - int(cfg.importance_sample_ratio * P)
            pairs = [jax.random.split(k) for k in jax.random.split(k_orig, batch * K_)]
            d["uncertain_coords"] = np.stack([uni(a, (n_s, 2)) for a, _ in pairs])
            d["uncertain_rand"] = np.stack([uni(b, (n_r, 2)) for _, b in pairs])
        if cfg.ood_loss == "RCL":
            ch, cw = crop_hw or label_hw
            d["rcl_noise"] = np.stack([uni(k, (batch * ch * cw,)) for k in
                                       jax.random.split(jax.random.fold_in(rng, 7), 3)])
        return d

    draws = one(key)
    if cfg.deep_supervision:
        draws["aux"] = [one(jax.random.fold_in(key, 100 + i)) for i in range(n_aux)]
    return draws


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def rel_err(ours, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(ours, np.float64) - ref).max() / max(np.abs(ref).max(), 1e-12))


def tiny_outputs(rng, b=2 * PAIRS, q=8, hs=16, ws=16):
    out = {"pred_logits": rng.randn(b, q, K + 1), "pred_masks": 3 * rng.randn(b, q, hs, ws),
           "pred_logits_ood": rng.randn(b, q, K + 1), "pred_masks_ood": 3 * rng.randn(b, q, hs, ws)}
    return {k: v.astype(np.float32) for k, v in out.items()}


def tiny_labels():
    _, _, tc, tg = synthetic_batch(PAIRS, CROP, K, seed=3)
    sem = np.concatenate([tc, tg])
    return np.pad(sem, ((0, 0), (0, HW[0] - CROP[0]), (0, HW[1] - CROP[1])), constant_values=255)


# ---------------------------------------------------------------------------
# RCL


@pytest.mark.parametrize("ce_weights,selection", [((0.0, 0.0), None), ((1.0, 1.0), None),
                                                  ((1.0, 1.0), 0.6)])
def test_rel_contrastive_loss_matches_jax_with_noise_ties(monkeypatch, ce_weights, selection):
    """The same noise on both sides, quantised to 8 levels so that the pixel
    sampling meets many ties: pairs are formed by position, so the port must
    order ties as jax.lax.top_k does (lower index first)."""
    rng = np.random.RandomState(0)
    b, h, w, c = 4, 12, 14, 5
    logits = rng.randn(b, h, w, c).astype(np.float32)
    score = rng.randn(b, h, w).astype(np.float32)
    tgt = rng.randint(0, c, (b, h, w)).astype(np.int32)
    tgt[:, 3:7, 4:9] = 254
    tgt[:, 0] = 255
    noise = (np.floor(rng.rand(3, b * h * w) * 8) / 8).astype(np.float32)
    kw = dict(ce_weights=ce_weights, inoutaug_contras_margins_tri=(0.7, 0.5, 0.2),
              num_pair_samples=64)
    if selection:
        kw.update(conduct_pixel_selection=True, selection_ratio=selection)
    queue = [jnp.asarray(n) for n in noise]
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape: queue.pop(0))
    ref_loss, ref_aux = jax_rcl.rel_contrastive_loss(
        jnp.asarray(logits), jnp.asarray(score), jnp.asarray(tgt), jax.random.PRNGKey(0),
        jax_rcl.RCLParams(**kw))
    assert not queue
    loss, aux = rcl.rel_contrastive_loss(torch.from_numpy(logits), torch.from_numpy(score),
                                         torch.from_numpy(tgt), torch.from_numpy(noise),
                                         rcl.RCLParams(**kw))
    # f32 means over a few hundred pixels
    assert rel_err(float(loss), float(ref_loss)) < 1e-5
    for k in ref_aux:
        np.testing.assert_allclose(float(aux[k]), float(ref_aux[k]), rtol=1e-5, atol=1e-6)
    assert float(aux["n_pairs"]) == 64  # the cap binds: ties decide the pairs


def test_make_rcl_params_reads_the_yaml():
    cfg = load_config("exps/m2f.yaml")
    ours = rcl.make_rcl_params(cfg.loss.params)
    ref = jax_rcl.make_rcl_params(cfg.loss.params)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.ce_weights == (0, 0) and ours.inoutaug_contras_margins_tri == (0.7, 0.5, 0.2)


# ---------------------------------------------------------------------------
# set criterion on the same predictions


@pytest.mark.parametrize("variant", ["pixel_selection", "plain_masks", "deep_supervision",
                                     "margin", "bce"])
def test_set_criterion_components_match_jax(variant):
    rng = np.random.RandomState(1)
    outs = tiny_outputs(rng)
    kw = {"pixel_selection": {}, "plain_masks": dict(mask_loss_with_pixel_selection=False),
          "deep_supervision": dict(deep_supervision=True),
          "margin": dict(ood_loss="margin"), "bce": dict(ood_loss="bce")}[variant]
    if variant == "deep_supervision":
        outs_aux = [tiny_outputs(rng) for _ in range(2)]
    else:
        outs_aux = []
    sem = tiny_labels()
    jcfg = jax_criterion.CriterionConfig(**crit_cfg(**kw))
    tcfg = criterion.CriterionConfig(**crit_cfg(**kw))
    key = jax.random.PRNGKey(5)
    j_out = {k: jnp.asarray(v) for k, v in outs.items()}
    j_out["aux_outputs"] = [{k: jnp.asarray(v) for k, v in a.items()} for a in outs_aux]
    ref_total, ref = jax.jit(lambda o, s: jax_criterion.set_criterion(
        o, s, key, jcfg, jax_rcl.RCLParams(**RCL), crop_hw=CROP))(j_out, jnp.asarray(sem))
    draws = to_torch(jax_draws(key, 2 * PAIRS, jcfg, HW, CROP, n_aux=len(outs_aux)))
    t_out = to_torch(outs)
    t_out["aux_outputs"] = [to_torch(a) for a in outs_aux]
    total, losses, _ = criterion.set_criterion(t_out, torch.from_numpy(sem), draws, tcfg,
                                            rcl.RCLParams(**RCL), crop_hw=CROP)
    assert set(losses) == set(ref)
    # f32 sums over points and pixels in another order
    for k in ref:
        assert rel_err(float(losses[k]), float(ref[k])) < 1e-4, (k, float(losses[k]), float(ref[k]))
    assert rel_err(float(total), float(ref_total)) < 1e-4


def test_criterion_refuses_approx_point_topk():
    cfg = criterion.CriterionConfig(**crit_cfg(approx_point_topk=True))
    with pytest.raises(NotImplementedError):
        criterion.clean_point_coords(torch.zeros(1, 4, 4), torch.zeros(1, 8, 8, dtype=torch.int32),
                                     torch.zeros(1, dtype=torch.long), torch.rand(1, 80, 2),
                                     torch.rand(1, 4, 2), cfg, 1, 0)


def test_criterion_draws_shapes():
    cfg = criterion.CriterionConfig(**crit_cfg(deep_supervision=True))
    g = torch.Generator().manual_seed(0)
    d = criterion.criterion_draws(g, 4, cfg, HW, crop_hw=CROP, num_aux=2)
    ref = jax_draws(jax.random.PRNGKey(0), 4, cfg, HW, CROP, n_aux=2)
    assert {k: tuple(v.shape) for k, v in d.items() if k != "aux"} == \
        {k: v.shape for k, v in ref.items() if k != "aux"}
    assert len(d["aux"]) == 2
    again = criterion.criterion_draws(torch.Generator().manual_seed(0), 4, cfg, HW,
                                      crop_hw=CROP, num_aux=2)
    assert torch.equal(d["rcl_noise"], again["rcl_noise"])  # the generator decides


# ---------------------------------------------------------------------------
# optimizer groups


def test_adamw_groups_equal_m2f_param_rules():
    """Every parameter, through the converter's name map: the port's group (lr
    multiplier, weight decay or not) equals the JAX rule for its flax path."""
    jm = JaxMaskFormer(**MODEL)
    params = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                            jnp.zeros((1, *HW, 3)), train=False))["params"]
    cfg = load_config("exps/m2f.yaml")
    trainer = TrainM2FOOD(cfg, model=MaskFormer(**MODEL), device="cpu")
    trainer.set_stage(1)
    groups = {n: {"lr": g["lr"], "weight_decay": g["weight_decay"]}
              for g in trainer.optimizer.param_groups for n in g["names"]}
    assert set(groups) == {n for n, _ in trainer.model.named_parameters()}
    seen = set()
    for path in flax.traverse_util.flatten_dict(params):
        rules = jax_param_rules(path)
        name = port_key(path)
        seen.add(name)
        g = groups[name]
        assert g["lr"] == pytest.approx(cfg.model.m2f.base_lr * rules["lr_mult"]), name
        want_wd = cfg.model.m2f.weight_decay if rules["wd"] is None else rules["wd"]
        assert g["weight_decay"] == pytest.approx(want_wd), name
    assert seen == set(groups)  # no port parameter without a JAX counterpart


def test_stage_optimizer_trains_only_the_named_parameters():
    """Stage 1's ``trainable_params_name: ["class_embed2"]``: the JAX mask
    (``trainable_mask``) and the port's frozen set agree parameter by parameter."""
    from multishiftseg_tpu.train.state import trainable_mask as jax_trainable_mask

    jm = JaxMaskFormer(**MODEL)
    params = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                            jnp.zeros((1, *HW, 3)), train=False))["params"]
    model = MaskFormer(**MODEL)
    opt = build_stage_optimizer(model, lr=1e-4, weight_decay=1e-4, trainable_names=["class_embed2"])
    mask = flax.traverse_util.flatten_dict(jax_trainable_mask(params, ["class_embed2"]))
    trained = {n for n, p in model.named_parameters() if p.requires_grad}
    assert trained == {port_key(k) for k, v in mask.items() if v}
    assert sum(p.numel() for g in opt.param_groups for p in g["params"]) == sum(
        p.numel() for n, p in model.named_parameters() if n in trained)


# ---------------------------------------------------------------------------
# the whole stage-2 step


def _perturbed(variables, seed):
    """Seeded numpy noise on every leaf (0.01), 0.1 on the deformable offset /
    weight kernels, which the init sets to zero."""
    rng = np.random.RandomState(seed)
    flat = flax.traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, variables))
    out = {}
    for k in sorted(flat):
        scale = 0.1 if k[-2] in ("sampling_offsets", "attention_weights") else 0.01
        out[k] = (flat[k] + scale * rng.randn(*flat[k].shape)).astype(np.float32)
    return flax.traverse_util.unflatten_dict(out)


def _tiny_cfg():
    cfg = load_config("exps/m2f.yaml")
    cfg.data.crop_size = CROP
    cfg.model.m2f.num_classes = K
    cfg.model.m2f.train_num_points = 64
    cfg.model.m2f.base_lr = BASE_LR
    cfg.loss.params["num_pair_samples"] = RCL["num_pair_samples"]
    cfg.train.bf16 = False
    return cfg


@pytest.fixture(scope="module")
def step_run():
    """One JAX stage-2 step (value_and_grad + the official AdamW) and the port's
    trainer after the same step, from the same weights, batch and draws."""
    img_c, img_g, tgt_c, tgt_g = synthetic_batch(PAIRS, CROP, K, seed=0)
    img = np.concatenate([img_c, img_g])
    pad = ((0, 0), (0, HW[0] - CROP[0]), (0, HW[1] - CROP[1]))
    img_p = np.pad(img, pad + ((0, 0),))
    sem_p = np.pad(np.concatenate([tgt_c, tgt_g]), pad, constant_values=255)

    jm = JaxMaskFormer(**MODEL)
    variables = jax.jit(lambda k: jm.init({"params": k}, jnp.zeros((1, *HW, 3)), train=False))(
        jax.random.PRNGKey(0))
    variables = _perturbed(variables, 1)
    jcfg = jax_criterion.CriterionConfig(**crit_cfg())
    rcl_params = jax_rcl.RCLParams(**RCL)
    tx, opt_state = jax_optimizer(variables["params"], base_lr=BASE_LR, weight_decay=0.05,
                                  clip_value=0.01)
    key = jax.random.PRNGKey(1)

    @jax.jit
    def step(params, opt_state, img, sem):
        def loss_fn(p):
            out = jm.apply({"params": p, "batch_stats": variables["batch_stats"]}, img,
                           train=True)
            return jax_criterion.set_criterion(out, sem, key, jcfg, rcl_params, crop_hw=CROP)

        (loss, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, opt_state, params)
        return loss, losses, grads, optax.apply_updates(params, updates)

    loss, losses, grads, new_params = jax.tree_util.tree_map(
        np.asarray, step(variables["params"], opt_state, jnp.asarray(img_p), jnp.asarray(sem_p)))

    draws = to_torch(jax_draws(key, 2 * PAIRS, jcfg, HW, CROP))
    # the port's f32 step; and the same step with the model in float64, which
    # holds the gradients: in f32 one ReLU input of this batch (res4) lies within
    # rounding of 0 and takes the other side in each framework, which moves the
    # gradients below it by up to 5e-3 of scale. The port in float64 agrees with
    # the JAX f32 step to about 1e-5 of scale.
    t32 = TrainM2FOOD(_tiny_cfg(), model=MaskFormer(**MODEL), device="cpu")
    t32.set_stage(1)
    t32.load_jax_variables(variables)
    t_loss, t_losses, _, _ = t32.stage2_step(img_c, img_g, tgt_c, tgt_g, draws=draws)
    t64 = TrainM2FOOD(_tiny_cfg(), model=MaskFormer(**MODEL), device="cpu")
    t64.set_stage(1)
    t64.load_jax_variables(variables)
    t64.model.double()  # in place: the optimizer keeps the same parameters
    loss64, _, grad_norm, _ = t64.stage2_step(img_c, img_g, tgt_c, tgt_g, draws=draws)
    scale = min(1.0, 0.01 / float(grad_norm))  # the clip applied to the port's grads
    return dict(loss=loss, losses=losses, grads=maskformer_from_jax({"params": grads}),
                new_params=maskformer_from_jax({"params": new_params}), t_loss=t_loss,
                t_losses=t_losses, loss64=loss64, scale=scale, trainer=t64,
                variables=variables)


def test_stage2_step_losses_match_jax(step_run):
    r = step_run
    assert set(r["t_losses"]) == set(r["losses"])
    for k, v in r["losses"].items():
        assert rel_err(float(r["t_losses"][k]), float(v)) < 1e-4, k
    assert rel_err(float(r["t_loss"]), float(r["loss"])) < 1e-4
    assert rel_err(float(r["loss64"]), float(r["loss"])) < 1e-4


def test_stage2_step_gradients_match_jax(step_run):
    """Every parameter's gradient within 1e-3 of its tensor's scale (the port in
    float64 against the JAX f32 step, see ``step_run``)."""
    r = step_run
    params = dict(r["trainer"].model.named_parameters())
    assert set(params) == set(r["grads"])
    bad = []
    for name, ref in r["grads"].items():
        ref = ref.numpy()
        got = params[name].grad.numpy() / r["scale"]
        tol = 1e-3 * max(np.abs(ref).max(), 1e-9)
        if np.abs(got - ref).max() > tol:
            bad.append((name, float(np.abs(got - ref).max()), tol))
    assert not bad, bad[:5]
    nonzero = sum(float(np.abs(g.numpy()).max()) > 0 for g in r["grads"].values())
    assert nonzero > 0.9 * len(r["grads"])
    # the deformable core passes gradients upstream of it
    for name in ("value_proj.weight", "sampling_offsets.weight", "attention_weights.weight"):
        full = f"sem_seg_head.pixel_decoder.transformer.encoder.layers.0.self_attn.{name}"
        assert float(params[full].grad.abs().max()) > 0, full


def test_stage2_step_adamw_update_matches_jax(step_run):
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


def test_load_jax_variables_carries_the_ood_head(step_run):
    """The strict load carries ``class_embed2``; ``copy_class_embed_to_ood``
    then gives what the JAX trainer's copy gives."""
    variables = step_run["variables"]
    model = MaskFormer(**MODEL)
    TrainM2FOOD(_tiny_cfg(), model=model, device="cpu").load_jax_variables(variables)
    loaded = maskformer_from_jax(variables)
    pred = "sem_seg_head.predictor."
    assert torch.equal(model.state_dict()[pred + "class_embed2.weight"],
                       loaded[pred + "class_embed2.weight"])
    copy_class_embed_to_ood(model)
    ref = maskformer_from_jax({"params": jax_copy_ood(variables["params"])})
    for leaf in ("weight", "bias"):
        got = model.state_dict()[pred + "class_embed2." + leaf]
        assert torch.equal(got, ref[pred + "class_embed2." + leaf])
        assert torch.equal(got, model.state_dict()[pred + "class_embed." + leaf])


def test_checkpoint_round_trip(tmp_path):
    """Save after one step, take a second; a restored trainer's second step
    gives the same loss and parameters (model, AdamW moments and generator)."""
    cfg = _tiny_cfg()
    batch = synthetic_batch(1, CROP, K, seed=2)
    torch.manual_seed(0)
    a = TrainM2FOOD(cfg, model=MaskFormer(**MODEL), device="cpu")
    a.set_stage(1)
    a.stage2_step(*batch)
    path = save_checkpoint(str(tmp_path / "ckpt" / "last.pt"), a)
    loss_a, _, _, _ = a.stage2_step(*batch)
    torch.manual_seed(1)
    b = TrainM2FOOD(cfg, model=MaskFormer(**MODEL), device="cpu")
    restore_checkpoint(path, b)
    assert b.step == 1
    loss_b, _, _, _ = b.stage2_step(*batch)
    assert float(loss_a) == float(loss_b)
    for (n, pa), (_, pb) in zip(a.model.named_parameters(), b.model.named_parameters()):
        assert torch.equal(pa, pb), n


def test_pad_batch_matches_the_jax_trainer():
    img = np.random.RandomState(0).randn(2, 40, 70, 3).astype(np.float32)
    tgt = np.random.RandomState(1).randint(0, 5, (2, 40, 70)).astype(np.int32)
    i, t, hw = pad_batch(torch.from_numpy(img), torch.from_numpy(tgt))
    assert hw == (40, 70) and tuple(i.shape) == (2, 64, 96, 3)
    np.testing.assert_array_equal(t.numpy(), np.pad(tgt, ((0, 0), (0, 24), (0, 26)),
                                                    constant_values=255))
    np.testing.assert_array_equal(i.numpy(), np.pad(img, ((0, 0), (0, 24), (0, 26), (0, 0))))
