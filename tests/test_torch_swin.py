"""PyTorch port, the Swin backbone against the JAX package on the CPU.

The relative-position index and the shifted windows' masks bit for bit; a tiny
Swin (embed 24, depths 2/2/2/2, heads 2/4/8/16, window 7) on 2 x 60 x 92 images,
not multiples of 28, so every stage pads to window multiples and the last is
smaller than one window: in eval, in training with injected drop-path masks,
its gradients against ``jax.vjp``, and the converter round trip through
``convert_maskformer`` (the trainers' steps over it: ``test_torch_swin_steps.py``).

Weights are seeded numpy draws in the shapes of the JAX init (``jax.eval_shape``:
compiling the init would take most of the tests' time). JAX draws its
drop-path masks from its key; here ``multishiftseg_tpu.models.swin.drop_path``
is replaced, from the test, by one that takes the same numpy-made masks the
port gets, in the order the blocks call it.
"""

import contextlib

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

import multishiftseg_tpu.models.swin as jax_swin
from multishiftseg_tpu.convert.torch2jax import convert_maskformer

import multishiftseg_torch.models.swin as swin
from multishiftseg_torch.convert.from_jax import maskformer_from_jax

MICRO = dict(embed_dim=24, depths=(2, 2, 2, 2), num_heads=(2, 4, 8, 16), window_size=7)
IMG = (2, 60, 92)
FEATURES = ("res2", "res3", "res4", "res5")


def seeded_variables(module, seed, *args, **kwargs):
    """Variables in the shapes ``module.init`` gives, drawn with numpy from
    ``seed``: kernels He-normal by fan-in, norm scales 1 and biases 0, each
    with 0.01 noise; the deformable offsets' biases 0.5 px of noise; tables and
    embeddings 0.02 / 1.0 noise; running means 0.1 noise, variances 1 + 0.1 |noise|."""
    shapes = jax.eval_shape(lambda: module.init({"params": jax.random.PRNGKey(0)},
                                                *args, **kwargs))
    rng = np.random.RandomState(seed)
    flat = flax.traverse_util.flatten_dict(shapes)
    out = {}
    for k in sorted(flat):
        shape, leaf = flat[k].shape, k[-1]
        noise = rng.randn(*shape)
        if k[0] == "batch_stats":
            v = 1 + 0.1 * np.abs(noise) if leaf == "var" else 0.1 * noise
        elif leaf == "kernel":
            v = noise * np.sqrt(2.0 / np.prod(shape[:-1]))
        elif leaf == "scale":
            v = 1 + 0.01 * noise
        elif leaf == "bias":
            v = (0.5 if k[-2] == "sampling_offsets" else 0.01) * noise
        elif leaf == "relative_position_bias_table":
            v = 0.02 * noise
        else:  # the learned queries and level embeddings
            v = noise
        out[k] = np.asarray(v, np.float32)
    return flax.traverse_util.unflatten_dict(out)


def rel_err(ours, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(ours, np.float64) - ref).max() / max(np.abs(ref).max(), 1e-12))


@contextlib.contextmanager
def micro_swin():
    """``swin_micro`` (MICRO) registered as a backbone in both packages."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_swin.SWIN_CONFIGS, "micro", MICRO)
        mp.setitem(swin.SWIN_CONFIGS, "micro", MICRO)
        mp.setitem(swin.SWIN_FEATURE_CHANNELS, "micro",
                   {f"res{i + 2}": MICRO["embed_dim"] * 2 ** i for i in range(4)})
        yield


@contextlib.contextmanager
def jax_drop_path(masks):
    """JAX's drop path takes ``masks`` (numpy bool [calls, N]) in call order."""
    calls = iter(range(len(masks)))

    def drop_path(x, rate, rng):
        m = jnp.asarray(masks[next(calls)]).astype(x.dtype)
        return x * m.reshape((-1,) + (1,) * (x.ndim - 1)) / (1.0 - rate)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_swin, "drop_path", drop_path)
        yield
    assert next(calls, None) is None, "JAX made fewer drop-path calls than masks"


def drop_masks(model, batch, seed):
    """Seeded keep masks in the port's layout, with a dropped and a kept
    sample in every call of this batch."""
    rates = np.asarray(model.drop_path_rates())
    m = np.random.RandomState(seed).rand(len(rates), batch) < 1.0 - rates[:, None]
    m[:, 0], m[:, 1] = ~m[:, 1], m[:, 1]
    return m


# ---------------------------------------------------------------------------
# host-built tables


@pytest.mark.parametrize("ws", [3, 7, 12])
def test_relative_position_index_equals_jax(ws):
    ours = swin._relative_position_index(ws)
    ref = jax_swin._relative_position_index(ws)
    assert ours.shape == ref.shape == (ws * ws, ws * ws)
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("hp,wp,ws,shift", [(7, 7, 7, 3), (14, 21, 7, 3), (21, 28, 7, 3),
                                            (12, 12, 12, 6), (24, 36, 12, 6), (14, 7, 7, 0)])
def test_shift_masks_equal_jax(hp, wp, ws, shift):
    """(7, 7) and (12, 12): a map padded up from less than one window."""
    ours = swin._shift_attn_mask(hp, wp, ws, shift)
    ref = jax_swin._shift_attn_mask(hp, wp, ws, shift)
    if shift == 0:
        assert ours is None and ref is None
        return
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


# ---------------------------------------------------------------------------
# the backbone alone


@pytest.fixture(scope="module")
def micro():
    """(JAX module, perturbed variables, port module with the same weights, images)."""
    x = np.random.RandomState(0).randn(*IMG, 3).astype(np.float32)
    jm = jax_swin.SwinTransformer(**MICRO)
    variables = seeded_variables(jm, 1, jnp.asarray(x))
    port = swin.SwinTransformer(**MICRO)
    sd = maskformer_from_jax({"params": {"backbone": variables["params"]}})
    port.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()}, strict=True)
    return jm, variables, port, x


def _nchw(x):
    return np.asarray(x).transpose(0, 3, 1, 2)


def test_micro_swin_eval_matches_jax(micro):
    jm, variables, port, x = micro
    ref = jax.jit(lambda v, x: jm.apply(v, x))(variables, jnp.asarray(x))
    with torch.no_grad():
        ours = port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    hw = [(15, 23), (8, 12), (4, 6), (2, 3)]  # stage 4 is below one window
    for name, shape in zip(FEATURES, hw):
        assert tuple(ours[name].shape[2:]) == shape
        # 8 f32 blocks, LayerNorm's variance taken as E[x^2] - E[x]^2 by flax
        assert rel_err(ours[name].numpy(), _nchw(ref[name])) < 1e-4, name


def _train_run(micro, masks):
    """JAX's and the port's training forward with ``masks``, and their
    gradients (``jax.vjp`` against autograd) for a seeded cotangent."""
    jm, variables, port, x = micro
    cot = {n: np.random.RandomState(i + 5).randn(*s).astype(np.float32) for i, (n, s) in
           enumerate(zip(FEATURES, [(2, 15, 23, 24), (2, 8, 12, 48), (2, 4, 6, 96),
                                    (2, 2, 3, 192)]))}

    @jax.jit
    def fwd_bwd(v, x, cot):
        out, vjp = jax.vjp(lambda v, x: jm.apply(v, x, train=True,
                                                 rngs={"dropout": jax.random.PRNGKey(3)}), v, x)
        return out, vjp(cot)

    with jax_drop_path(masks):
        ref, (d_vars, d_x) = fwd_bwd(variables, jnp.asarray(x),
                                     {k: jnp.asarray(v) for k, v in cot.items()})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    port.train().zero_grad()
    ours = port(xt, torch.from_numpy(masks))
    torch.autograd.backward([ours[n] for n in FEATURES],
                            [torch.from_numpy(_nchw(cot[n])) for n in FEATURES])
    return ref, ours, d_vars, d_x, xt.grad


@pytest.fixture(scope="module")
def train_run(micro):
    masks = drop_masks(micro[2], IMG[0], seed=2)
    assert masks.shape == (14, 2)  # block 0's rate is 0
    return _train_run(micro, masks)


def test_micro_swin_train_with_drop_path_matches_jax(train_run):
    ref, ours, *_ = train_run
    for name in FEATURES:
        assert rel_err(ours[name].detach().numpy(), _nchw(ref[name])) < 1e-4, name


def test_micro_swin_gradients_match_jax_vjp(micro, train_run):
    """d input and every parameter's gradient within 1e-4 of its scale."""
    _, _, port, _ = micro
    _, _, d_vars, d_x, gx = train_run
    assert rel_err(gx.permute(0, 2, 3, 1).numpy(), d_x) < 1e-4
    ref = maskformer_from_jax({"params": {"backbone": d_vars["params"]}})
    got = {f"backbone.{n}": p.grad for n, p in port.named_parameters()}
    assert set(got) == set(ref)
    bad = [(n, rel_err(got[n].numpy(), r.numpy())) for n, r in ref.items()
           if rel_err(got[n].numpy(), r.numpy()) > 1e-4]
    assert not bad, bad[:5]


def test_drop_path_masks_from_the_generator(micro):
    port = micro[2]
    a = port.draw_drop_path_masks(64, torch.Generator().manual_seed(0), "cpu")
    b = port.draw_drop_path_masks(64, torch.Generator().manual_seed(0), "cpu")
    assert a.dtype == torch.bool and tuple(a.shape) == (14, 64)
    assert torch.equal(a, b)
    rates = np.asarray(port.drop_path_rates())
    np.testing.assert_allclose(rates[::2], np.linspace(0, 0.3, 8)[1:], rtol=1e-6)
    assert 0.5 < float(a.float().mean()) < 0.95
    port.train()
    with pytest.raises(ValueError, match="drop-path"):
        port(torch.zeros(1, 3, 28, 28))


def test_converter_round_trip(micro):
    """The port's ``state_dict`` through JAX's ``convert_maskformer`` gives the
    JAX variables back exactly, and carries no ``relative_position_index``."""
    _, variables, port, _ = micro
    sd = {f"backbone.{k}": v for k, v in port.state_dict().items()}
    assert not any("relative_position_index" in k for k in sd)
    back = flax.traverse_util.flatten_dict(convert_maskformer(sd)["params"]["backbone"])
    want = flax.traverse_util.flatten_dict(variables["params"])
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=str(k))


def test_loader_drops_relative_position_index(micro, tmp_path):
    """A stock checkpoint's index buffers are dropped; everything else stays strict."""
    from multishiftseg_torch.convert.torch_checkpoint import load_reference_weights

    port = micro[2]
    sd = dict(port.state_dict())
    sd["layers.0.blocks.0.attn.relative_position_index"] = torch.zeros(49, 49, dtype=torch.long)
    torch.save(sd, tmp_path / "w.pth")
    load_reference_weights(port, str(tmp_path / "w.pth"))
    sd["layers.0.blocks.0.attn.attn_mask"] = torch.zeros(1)
    torch.save(sd, tmp_path / "w.pth")
    with pytest.raises(RuntimeError, match="attn_mask"):
        load_reference_weights(port, str(tmp_path / "w.pth"))
