"""PyTorch port, the Mask2Anomaly stage-1 slice against the JAX package on the CPU.

The anomaly tail's VJP (``1 - max_k`` of softmax x sigmoid over the upsampled
masks) against ``jax.vjp``, a forced tie included; one whole stage-1 step
(``TrainM2FOOD.stage1_step``) against JAX's own ``make_stage1_step(tx,
paired=False)`` with ``build_stage_optimizer``; the stages' trainable sets; and
``inference``'s classes-only semantic path. Tiny model: 19 classes, hidden 32,
12 queries, 1 encoder and 3 decoder layers, R-50 at its own widths, one pair of
60x60 crops padded to 64x64. The RCL noise is replayed from the JAX key splits.
"""

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from multishiftseg_tpu.core.config import load_config as jax_load_config
from multishiftseg_tpu.losses import rcl as jax_rcl
from multishiftseg_tpu.models.maskformer import MaskFormer as JaxMaskFormer
from multishiftseg_tpu.models.maskformer import inference as jax_inference
from multishiftseg_tpu.ops import scores as jax_scores
from multishiftseg_tpu.ops.resize import resize_bilinear_nchw as jax_resize_nchw
from multishiftseg_tpu.train.m2f_trainer import TrainM2FOOD as JaxTrainM2FOOD
from multishiftseg_tpu.train.m2f_trainer import copy_class_embed_to_ood as jax_copy_ood
from multishiftseg_tpu.train.state import TrainState, build_stage_optimizer
from multishiftseg_tpu.train.state import trainable_mask as jax_trainable_mask

from multishiftseg_torch.convert.from_jax import maskformer_from_jax, port_key
from multishiftseg_torch.core.config import load_config
from multishiftseg_torch.models.maskformer import MaskFormer, inference
from multishiftseg_torch.ops import scores
from multishiftseg_torch.train.m2f_trainer import TrainM2FOOD, synthetic_batch

K = 19
MODEL = dict(num_classes=K, hidden_dim=32, num_queries=12, nheads=4, dim_feedforward=64,
             dec_layers=3, mask_dim=32, transformer_enc_layers=1)
CROP, HW = (60, 60), (64, 64)
OOD_HEAD = "sem_seg_head.predictor.class_embed2."


def rel_err(ours, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(ours, np.float64) - ref).max() / max(np.abs(ref).max(), 1e-12))


# ---------------------------------------------------------------------------
# the anomaly tail's VJP


def _tail_inputs(rng, tie):
    cls = rng.randn(2, 6, K + 1).astype(np.float32)
    if tie:
        # classes 0 and 1 equal and leading: their sums tie wherever they lead
        cls[..., 1] = cls[..., 0] = 3.0 + rng.rand(2, 6).astype(np.float32)
    masks = (3 * rng.randn(2, 6, 8, 10)).astype(np.float32)
    g = rng.randn(2, 32, 40).astype(np.float32)
    return cls, masks, g


def _jax_tail(c, m):
    return jax_scores.mask2former_anomaly_score(c, jax_resize_nchw(m, (32, 40)))


@pytest.mark.parametrize("tie", [False, True])
def test_anomaly_tail_vjp_matches_jax(tie):
    """``anomaly_score_upsampled``'s gradients (class logits and mask logits)
    and the plain ``mask_scores_backward`` (probabilities and mask logits)
    against ``jax.vjp``. With a forced tie the gradient splits evenly."""
    cls, masks, g = _tail_inputs(np.random.RandomState(3), tie)
    out, vjp = jax.vjp(_jax_tail, jnp.asarray(cls), jnp.asarray(masks))
    gc, gm = vjp(jnp.asarray(g))
    c = torch.from_numpy(cls).requires_grad_()
    m = torch.from_numpy(masks).requires_grad_()
    anomaly = scores.anomaly_score_upsampled(c, m, (32, 40))
    np.testing.assert_allclose(anomaly.detach().numpy(), np.asarray(out), rtol=0, atol=1e-6)
    anomaly.backward(torch.from_numpy(g))
    # f32 sums over pixels and queries in another order
    assert rel_err(c.grad.numpy(), gc) < 1e-5
    assert rel_err(m.grad.numpy(), gm) < 1e-5

    probs = torch.softmax(torch.from_numpy(cls), -1)[..., :-1]
    _, vjp_p = jax.vjp(lambda p, mm: 1.0 - jnp.max(jnp.einsum(
        "bqk,bqhw->bhwk", p, jax.nn.sigmoid(jax_resize_nchw(mm, (32, 40)))), -1),
        jnp.asarray(probs.numpy()), jnp.asarray(masks))
    gp, gm2 = vjp_p(jnp.asarray(g))
    dp, dm = scores.mask_scores_backward(torch.from_numpy(masks), probs, torch.from_numpy(g),
                                         (32, 40), dmask=True)
    assert rel_err(dp.numpy(), gp) < 1e-5 and rel_err(dm.numpy(), gm2) < 1e-5
    dp_only, none = scores.mask_scores_backward(torch.from_numpy(masks), probs,
                                                torch.from_numpy(g), (32, 40))
    assert none is None and torch.equal(dp_only, dp)
    if tie:
        sem = scores.mask2former_semantic_logits(
            torch.from_numpy(cls), scores.resize_bilinear_nchw(torch.from_numpy(masks), (32, 40)))
        top2 = sem.topk(2, dim=-1).values
        ties = top2[..., 0] == top2[..., 1]
        assert ties.float().mean() > 0.5  # most pixels tie
        # the tied classes receive equal shares
        np.testing.assert_array_equal(dp[..., 0].numpy(), dp[..., 1].numpy())
        np.testing.assert_allclose(np.asarray(gp)[..., 0], np.asarray(gp)[..., 1], rtol=1e-6)


# ---------------------------------------------------------------------------
# one whole stage-1 step


def _perturbed(variables, seed):
    rng = np.random.RandomState(seed)
    flat = flax.traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, variables))
    out = {}
    for k in sorted(flat):
        scale = 0.1 if k[-2] in ("sampling_offsets", "attention_weights") else 0.01
        out[k] = (flat[k] + scale * rng.randn(*flat[k].shape)).astype(np.float32)
    return flax.traverse_util.unflatten_dict(out)


def _cfg(loader):
    cfg = loader("exps/m2f.yaml")
    cfg.data.crop_size = CROP
    cfg.train.train_batch = 1
    cfg.train.bf16 = False
    return cfg


@pytest.fixture(scope="module")
def stage1_run():
    img_c, img_g, tgt_c, tgt_g = synthetic_batch(1, CROP, K, seed=4)
    pad = ((0, 0), (0, HW[0] - CROP[0]), (0, HW[1] - CROP[1]))
    img = np.pad(np.concatenate([img_c, img_g]), pad + ((0, 0),))
    tgt = np.pad(np.concatenate([tgt_c, tgt_g]), pad, constant_values=255)

    jcfg = _cfg(jax_load_config)
    tr = JaxTrainM2FOOD(jcfg, model=JaxMaskFormer(**MODEL))
    jm = tr.model
    variables = _perturbed(jax.jit(lambda k: jm.init({"params": k}, jnp.zeros((1, *HW, 3)),
                                                     train=False))(jax.random.PRNGKey(0)), 2)
    params = jax_copy_ood(variables["params"])
    tx, opt_state = build_stage_optimizer(params, jcfg.train.lr, jcfg.train.weight_decay,
                                          ("class_embed2",))
    rng = jax.random.PRNGKey(7)
    # the step's gradient and its RCL noise, from the step's own key splits
    # (before the step, which donates its state)
    _, step_rng, drop_rng = jax.random.split(rng, 3)
    rcl_params = jax_rcl.make_rcl_params(jcfg.loss.params)

    def loss_fn(p):
        out = jm.apply({"params": p, "batch_stats": variables["batch_stats"]},
                       jnp.asarray(img), train=True, rngs={"dropout": drop_rng})
        sem, anomaly = jax_inference(out, HW, num_classes=K)
        return jax_rcl.rel_contrastive_loss(
            sem[:, :K, :CROP[0], :CROP[1]].transpose(0, 2, 3, 1), anomaly[:, :CROP[0], :CROP[1]],
            jnp.asarray(tgt)[:, :CROP[0], :CROP[1]], step_rng, rcl_params)[0]

    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    grads = to_np(jax.jit(jax.grad(loss_fn))(params))
    noise = np.stack([np.asarray(jax.random.uniform(k, (2 * CROP[0] * CROP[1],)))
                      for k in jax.random.split(step_rng, 3)])
    start = {"params": to_np(params), "batch_stats": variables["batch_stats"]}
    state = TrainState(params=params, batch_stats=variables["batch_stats"],
                       opt_state=opt_state, step=jnp.zeros((), jnp.int32), rng=rng)
    new_state, loss, aux = tr.make_stage1_step(tx, paired=False)(
        state, jnp.asarray(img), jnp.asarray(tgt))

    runs = {}
    for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        t = TrainM2FOOD(_cfg(load_config), model=MaskFormer(**MODEL), device="cpu")
        t.load_jax_variables(start)
        t.model.to(dtype)  # in place: the optimizer keeps the same parameters
        before = {n: p.detach().clone() for n, p in t.model.named_parameters()}
        t_loss, t_aux = t.stage1_step(img_c, img_g, tgt_c, tgt_g,
                                      draws={"rcl_noise": torch.from_numpy(noise)})
        runs[name] = dict(trainer=t, before=before, loss=t_loss, aux=t_aux)
    return dict(loss=float(loss), aux={k: float(v) for k, v in aux.items()},
                grads=maskformer_from_jax({"params": grads}),
                start=maskformer_from_jax(start),
                new=maskformer_from_jax({"params": to_np(new_state.params),
                                         "batch_stats": variables["batch_stats"]}),
                runs=runs, lr=jcfg.train.lr)


def test_stage1_step_losses_match_jax(stage1_run):
    r = stage1_run
    assert r["loss"] > 0 and r["aux"]["n_pairs"] > 0
    for run in r["runs"].values():
        assert rel_err(float(run["loss"]), r["loss"]) < 1e-5
        assert set(run["aux"]) == set(r["aux"])
        for k, v in r["aux"].items():
            assert abs(float(run["aux"][k]) - v) <= 1e-5 * max(abs(v), 1e-6), k


def test_stage1_step_ood_head_gradient_matches_jax(stage1_run):
    """``class_embed2``'s gradient, the port in float64, within 1e-4 of scale;
    no other parameter has one."""
    r = stage1_run
    params = dict(r["runs"]["f64"]["trainer"].model.named_parameters())
    for leaf in ("weight", "bias"):
        ref = r["grads"][OOD_HEAD + leaf].numpy()
        got = params[OOD_HEAD + leaf].grad.numpy()
        assert np.abs(ref).max() > 0
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max(), leaf
    assert {n for n, p in params.items() if p.grad is not None} == {
        OOD_HEAD + "weight", OOD_HEAD + "bias"}


def test_stage1_step_adam_update_matches_jax(stage1_run):
    """Adam's first step is about lr * sign(g + wd * p): compare where that is
    far above eps and clear of sign noise. Every other parameter is unchanged,
    bit for bit, on both sides."""
    r = stage1_run
    t = r["runs"]["f32"]
    params = dict(t["trainer"].model.named_parameters())
    checked = 0
    for leaf in ("weight", "bias"):
        name = OOD_HEAD + leaf
        g = r["grads"][name].numpy() + 1e-4 * r["start"][name].numpy()
        sel = (np.abs(g) > 1e-6) & (np.abs(g) > 1e-2 * np.abs(g).max())
        np.testing.assert_allclose(params[name].detach().numpy()[sel], r["new"][name].numpy()[sel],
                                   rtol=0, atol=1e-3 * r["lr"])
        assert not torch.equal(params[name].detach(), t["before"][name])
        checked += int(sel.sum())
    assert checked > 100
    for name, p in params.items():
        if not name.startswith(OOD_HEAD):
            assert torch.equal(p.detach(), t["before"][name]), name
            assert torch.equal(r["new"][name], r["start"][name]), name


def test_set_stage_trainable_sets_match_trainable_mask():
    """Stage 0 trains ``trainable_params_name`` (``class_embed2``) with Adam,
    stage 1 ``trainable_params_name_update`` (all) with the AdamW groups: the
    port's trainable set against JAX's ``trainable_mask``, parameter by parameter."""
    jm = JaxMaskFormer(**MODEL)
    params = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                            jnp.zeros((1, *HW, 3)), train=False))["params"]
    cfg = _cfg(load_config)
    tr = TrainM2FOOD(cfg, model=MaskFormer(**MODEL), device="cpu")
    for stage, names in ((0, cfg.model.trainable_params_name),
                         (1, cfg.model.trainable_params_name_update)):
        tr.set_stage(stage)
        mask = flax.traverse_util.flatten_dict(jax_trainable_mask(params, names))
        want = {port_key(k) for k, v in mask.items() if v}
        trained = {n for n, p in tr.model.named_parameters() if p.requires_grad}
        in_opt = {id(p) for g in tr.optimizer.param_groups for p in g["params"]}
        assert trained == want
        assert in_opt == {id(p) for n, p in tr.model.named_parameters() if n in want}
        assert isinstance(tr.optimizer, torch.optim.AdamW if stage else torch.optim.Adam)
    assert len(want) == len(list(tr.model.parameters()))
    with pytest.raises(RuntimeError, match="stage 0"):
        tr.stage1_step(*synthetic_batch(1, CROP, K, seed=0))
    tr.set_stage(0)
    with pytest.raises(RuntimeError, match="stage 1"):
        tr.stage2_step(*synthetic_batch(1, CROP, K, seed=0))


def test_inference_classes_only_equals_the_first_k_channels(stage1_run):
    """``inference(..., _classes_only=True)`` gives the full semantic output's
    first K channels, which are JAX's, and the same anomaly score."""
    model = stage1_run["runs"]["f32"]["trainer"].model
    img = torch.from_numpy(synthetic_batch(1, HW, K, seed=5)[0])
    with torch.no_grad():
        out = model.eval()(img)
        sem_k, anomaly_k = inference(out, HW, num_classes=K, _classes_only=True)
        sem, anomaly = inference(out, HW, num_classes=K)
    assert sem_k.shape == (1, K, *HW) and sem.shape == (1, K + 12, *HW)
    assert torch.equal(sem_k, sem[:, :K]) and torch.equal(anomaly_k, anomaly)
    j_out = {k: jnp.asarray(out[k].numpy()) for k in
             ("pred_logits", "pred_masks", "pred_logits_ood", "pred_masks_ood")}
    sem_j, _ = jax_inference(j_out, HW, num_classes=K)
    np.testing.assert_allclose(sem_k.numpy(), np.asarray(sem_j)[:, :K], rtol=0, atol=1e-6)
