"""PyTorch port, GPipe (``multishiftseg_torch/core/pipeline.py``) on the CPU.

- ``gpipe`` against JAX's ``gpipe`` on its virtual CPU mesh (the same stack of
  4 dense tanh layers, f32, forward and gradients) and against the port's own
  sequential loop in float64 at 1e-12, for P in {2, 4} stages and 1, 2 or 4
  microbatches; every stage's device is the CPU.
- ``gpipe_encoder_apply`` on the deformable encoder layers against JAX's.
- ``auto_microbatches`` equals JAX's; the bad geometry raises as JAX's does.
- A ``TrainM2FOOD`` stage-2 step with ``pipeline_parallel = 2`` equals the
  sequential step, and its evaluation stays sequential.

The JAX weights are numpy draws, never a compiled init.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multishiftseg_tpu.core import pipeline as jax_pipeline
from multishiftseg_tpu.models.pixel_decoder import (DeformableEncoderLayer as JaxLayer,
                                                    _reference_points)

from multishiftseg_torch.core import pipeline
from multishiftseg_torch.core.config import load_config
from multishiftseg_torch.models.maskformer import MaskFormer
from multishiftseg_torch.models.pixel_decoder import DeformableEncoderLayer
from multishiftseg_torch.train.m2f_trainer import TrainM2FOOD, synthetic_batch

N_LAYERS, WIDTH, BATCH = 4, 6, 8
CPU = torch.device("cpu")


def dense_stack(rng):
    """Per-layer weight [D, D] and bias [D] of the 4-layer tanh stack."""
    return (0.5 * rng.randn(N_LAYERS, WIDTH, WIDTH), 0.1 * rng.randn(N_LAYERS, WIDTH))


class Dense(torch.nn.Module):
    def __init__(self, w, b, dtype):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(w, dtype=dtype))
        self.b = torch.nn.Parameter(torch.tensor(b, dtype=dtype))


def dense_apply(layer, state):
    return torch.tanh(state @ layer.w + layer.b)


def port_run(pipe, n_micro, w, b, x, cot, dtype):
    """(output, d x, d weights [L, D, D], d biases [L, D]) of the port: the
    GPipe schedule when ``pipe``, else the sequential loop."""
    layers = torch.nn.ModuleList(Dense(w[i], b[i], dtype) for i in range(N_LAYERS))
    xt = torch.tensor(x, dtype=dtype, requires_grad=True)
    if pipe:
        out = pipeline.gpipe(dense_apply, layers, xt, devices=[CPU] * pipe, n_micro=n_micro)
    else:
        out = xt
        for layer in layers:
            out = dense_apply(layer, out)
    out.backward(torch.tensor(cot, dtype=dtype))
    return (out.detach().numpy(), xt.grad.numpy(),
            np.stack([l.w.grad.numpy() for l in layers]),
            np.stack([l.b.grad.numpy() for l in layers]))


@pytest.mark.parametrize("pipe", [2, 4])
@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_gpipe_matches_jax_and_the_sequential_loop(pipe, n_micro):
    """Forward and gradients (input, every layer's weight and bias): against
    JAX's ``gpipe`` in f32 within 1e-5 of each output's scale (f32 sums in
    another order), against the sequential loop in float64 within 1e-12."""
    rng = np.random.RandomState(10 * pipe + n_micro)
    w, b = dense_stack(rng)
    x, cot = rng.randn(BATCH, WIDTH), rng.randn(BATCH, WIDTH)

    def jax_apply(lp, state):
        return jnp.tanh(state @ lp["w"] + lp["b"])

    mesh = jax_pipeline.make_pipe_mesh(pipe, pipe)

    def loss(params, xj):
        out = jax_pipeline.gpipe(jax_apply, params, xj, mesh=mesh, n_micro=n_micro)
        return jnp.sum(out * jnp.asarray(cot, jnp.float32)), out

    f32 = lambda a: jnp.asarray(a, jnp.float32)
    (_, out), (dp, dx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        {"w": f32(w), "b": f32(b)}, f32(x))
    want = [np.asarray(out), np.asarray(dx), np.asarray(dp["w"]), np.asarray(dp["b"])]
    got = port_run(pipe, n_micro, w, b, x, cot, torch.float32)
    for name, g, r in zip(("out", "dx", "dw", "db"), got, want):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-5 * np.abs(r).max(), err_msg=name)
    seq = port_run(0, 0, w, b, x, cot, torch.float64)
    for name, g, r in zip(("out", "dx", "dw", "db"), port_run(pipe, n_micro, w, b, x, cot,
                                                               torch.float64), seq):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-12, err_msg=name)


SHAPES = ((4, 6), (2, 3))
D_MODEL, D_FFN, HEADS, POINTS = 32, 64, 2, 2


def jax_layer_params(rng):
    """One JAX encoder layer's params as numpy draws in ``jax.eval_shape``'s
    shapes (offsets and weights given scale, so the points move)."""
    layer = JaxLayer(d_model=D_MODEL, d_ffn=D_FFN, n_levels=len(SHAPES), n_heads=HEADS,
                     n_points=POINTS)
    s = sum(h * w for h, w in SHAPES)
    ref = jnp.zeros((1, s, len(SHAPES), 2))
    shapes = jax.eval_shape(lambda: layer.init(jax.random.PRNGKey(0), jnp.zeros((1, s, D_MODEL)),
                                               jnp.zeros((1, s, D_MODEL)), ref, SHAPES))

    def draw(path, leaf):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        if "norm" in name and name.endswith("scale"):
            return (1.0 + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)

    return layer, jax.tree_util.tree_map_with_path(draw, shapes["params"])


def port_layer(params):
    """The port's ``DeformableEncoderLayer`` holding JAX layer ``params``."""
    layer = DeformableEncoderLayer(D_MODEL, D_FFN, len(SHAPES), HEADS, POINTS)
    t = lambda a: torch.tensor(np.asarray(a))
    sd = {}
    for name in ("sampling_offsets", "attention_weights", "value_proj", "output_proj"):
        sd[f"self_attn.{name}.weight"] = t(params["self_attn"][name]["kernel"]).T
        sd[f"self_attn.{name}.bias"] = t(params["self_attn"][name]["bias"])
    for name in ("linear1", "linear2"):
        sd[f"{name}.weight"] = t(params[name]["kernel"]).T
        sd[f"{name}.bias"] = t(params[name]["bias"])
    for name in ("norm1", "norm2"):
        sd[f"{name}.weight"] = t(params[name]["scale"])
        sd[f"{name}.bias"] = t(params[name]["bias"])
    layer.load_state_dict(sd)
    return layer


def test_gpipe_encoder_matches_jax():
    """``gpipe_encoder_apply`` over 4 deformable encoder layers in 2 stages of
    2 microbatches, training mode (the layers' remat), against JAX's on its
    virtual mesh: the output and d src within 1e-5 of scale (f32 sums in
    another order, the bilinear weights rounded alike)."""
    rng = np.random.RandomState(3)
    layer, _ = jax_layer_params(rng)
    params = [jax_layer_params(rng)[1] for _ in range(N_LAYERS)]
    s = sum(h * w for h, w in SHAPES)
    src, pos = rng.randn(4, s, D_MODEL).astype(np.float32), rng.randn(1, s, D_MODEL).astype(
        np.float32)
    ref = np.broadcast_to(_reference_points(SHAPES)[None, :, None, :],
                          (1, s, len(SHAPES), 2)).copy()
    cot = rng.randn(4, s, D_MODEL).astype(np.float32)
    stacked = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *params)
    mesh = jax_pipeline.make_pipe_mesh(2, 2)

    def loss(x):
        out = jax_pipeline.gpipe_encoder_apply(layer, stacked, x, jnp.asarray(pos),
                                               jnp.asarray(ref), SHAPES, mesh=mesh, n_micro=2,
                                               remat=True)
        return jnp.sum(out * cot), out

    (_, want), dsrc = jax.jit(jax.value_and_grad(loss, has_aux=True))(jnp.asarray(src))
    layers = torch.nn.ModuleList(port_layer(p) for p in params).train()
    xt = torch.tensor(src, requires_grad=True)
    out = pipeline.gpipe_encoder_apply(layers, xt, torch.tensor(pos), torch.tensor(ref), SHAPES,
                                       devices=[CPU, CPU], n_micro=2)
    out.backward(torch.tensor(cot))
    for g, r in ((out.detach().numpy(), np.asarray(want)), (xt.grad.numpy(), np.asarray(dsrc))):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-5 * np.abs(r).max())


def test_auto_microbatches_equals_jax():
    for batch in range(1, 33):
        for pipe in (1, 2, 3, 4, 8):
            assert (pipeline.auto_microbatches(batch, pipe)
                    == jax_pipeline.auto_microbatches(batch, pipe)), (batch, pipe)


@pytest.mark.parametrize("case", ["layers", "batch", "per_sample_pos", "devices"])
def test_bad_geometry_raises(case):
    """What JAX's ``gpipe`` refuses: layers not divisible by the stages, a
    batch not divisible by the microbatches, per-sample pos / reference
    points; and fewer devices than stages."""
    rng = np.random.RandomState(0)
    w, b = dense_stack(rng)
    layers = torch.nn.ModuleList(Dense(w[i], b[i], torch.float32) for i in range(N_LAYERS))
    x = torch.zeros(BATCH, WIDTH)
    if case == "layers":
        with pytest.raises(ValueError, match="not divisible by pipe=3"):
            pipeline.gpipe(dense_apply, layers, x, devices=[CPU] * 3, n_micro=1)
    elif case == "batch":
        with pytest.raises(ValueError, match="not divisible by n_micro=3"):
            pipeline.gpipe(dense_apply, layers, x, devices=[CPU] * 2, n_micro=3)
    elif case == "per_sample_pos":
        with pytest.raises(ValueError, match="batch-invariant"):
            pipeline.gpipe_encoder_apply(layers, x[None], torch.zeros(2, 1, WIDTH),
                                         torch.zeros(1, 1, 1, 2), [(1, 1)], devices=[CPU] * 2,
                                         n_micro=1)
    else:
        with pytest.raises(ValueError, match="only 1 devices"):
            pipeline.stage_devices(2, [CPU])
        assert pipeline.stage_devices(2, ["cpu", "cpu", "cpu"]) == [CPU, CPU]


M2F = dict(num_classes=19, hidden_dim=32, num_queries=20, nheads=4, dim_feedforward=64,
           dec_layers=3, mask_dim=32, transformer_enc_layers=2)
CROP = (64, 64)


def _trainer(pipe, micro=0):
    cfg = load_config("exps/m2f.yaml")
    cfg.data.crop_size, cfg.model.m2f.train_num_points, cfg.train.bf16 = CROP, 64, False
    cfg.loss.params["num_pair_samples"] = 256
    cfg.train.train_batch, cfg.train.pipeline_parallel = 2, pipe
    cfg.train.pipeline_microbatches = micro
    torch.manual_seed(0)
    model = MaskFormer(**M2F)
    with torch.no_grad():  # give the deformable heads a start off their zero init
        g = torch.Generator().manual_seed(1)
        for layer in model.sem_seg_head.pixel_decoder.transformer.encoder.layers:
            for lin in (layer.self_attn.sampling_offsets, layer.self_attn.attention_weights):
                lin.weight.copy_(0.1 * torch.randn(lin.weight.shape, generator=g))
    tr = TrainM2FOOD(cfg, model=model, device="cpu")
    tr.model.double()
    tr.set_stage(1)
    return tr


def test_pipelined_stage2_step_equals_the_sequential_step():
    """``pipeline_parallel = 2`` (the paired batch of 4 rows in 4
    microbatches, ``auto_microbatches``) against ``pipeline_parallel = 1``:
    the same weights, batch and draws, in float64. The deformable core
    computes in f32 on every device, and the microbatches group the float64
    sums before it otherwise, so its inputs can round to another f32 value:
    losses and the gradient norm within 1e-9, every gradient within 1e-6 of
    the largest, and the AdamW update (whose first step divides each gradient
    by its own size, and so magnifies the smallest gradients' differences)
    within 1e-4 of the learning rate. Before the step, the pipelined
    trainer's evaluation of one image (which 4 microbatches could not split)
    runs sequentially and equals the other's bit for bit."""
    batch = synthetic_batch(2, CROP, 19, seed=0)
    seq, pipe = _trainer(1), _trainer(2)
    assert pipe.model.sem_seg_head.pixel_decoder.pipeline[1] == 4
    img = synthetic_batch(1, CROP, 19, seed=1)[0]
    for a, b in zip(seq.eval_step(img), pipe.eval_step(img)):
        assert torch.equal(a, b)
    draws = seq.draws(4, CROP)
    got = {}
    for name, tr in (("seq", seq), ("pipe", pipe)):
        loss, parts, norm, _ = tr.stage2_step(*batch, draws=draws)
        got[name] = (float(loss), {k: float(v) for k, v in parts.items()}, float(norm),
                     {n: (p.grad.numpy().copy(), p.detach().numpy().copy())
                      for n, p in tr.model.named_parameters() if p.grad is not None})
    (l1, p1, n1, g1), (l2, p2, n2, g2) = got["seq"], got["pipe"]
    assert abs(l1 - l2) <= 1e-9 * abs(l1) and abs(n1 - n2) <= 1e-9 * n1
    for k in p1:
        assert abs(p1[k] - p2[k]) <= 1e-9 * max(abs(p1[k]), 1e-12), k
    assert set(g1) == set(g2)
    enc = [n for n in g1 if "encoder.layers" in n]
    assert enc and all(np.abs(g1[n][0]).max() > 0 for n in enc)
    scale = max(np.abs(g[0]).max() for g in g1.values())
    for n in g1:
        (ga, pa), (gb, pb) = g1[n], g2[n]
        assert np.abs(ga - gb).max() <= 1e-6 * scale, n
        assert np.abs(pa - pb).max() <= 1e-4 * seq.cfg.model.m2f.base_lr, n


def test_pipeline_refuses_an_indivisible_batch():
    """``pipeline_microbatches`` that does not divide the paired batch raises
    at construction, as JAX's trainer does."""
    with pytest.raises(ValueError, match="not divisible by pipeline_microbatches=3"):
        _trainer(2, micro=3)
