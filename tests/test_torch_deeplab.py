"""PyTorch port, DeepLab v3+ WRN-38 eval against the JAX package on the CPU.

The dilated 3x3 convolution and its gradients, the bottom-k pixel selection
(the two ops with CUDA kernels, here through their plain versions), the energy
score, the converter both ways, the parameter count of the full WRN-38, and the
eval forward of a tiny DeepWV3Plus (one block a module, narrow channels) at
256x256, whose 32x32 output-stride-8 maps leave the rate-12 and rate-24 taps
partly and the rate-36 taps wholly outside. The same numpy-seeded inputs go to
both frameworks.
"""

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from multishiftseg_tpu.convert.torch2jax import convert_deeplab
from multishiftseg_tpu.losses import rcl as jax_rcl
from multishiftseg_tpu.models.deeplab import DeepWV3Plus as JaxDeepLab
from multishiftseg_tpu.models.deeplab import init_ood_head_from_final as jax_init_ood_head
from multishiftseg_tpu.models.wider_resnet import WiderResNetA2 as JaxWRN
from multishiftseg_tpu.ops.dilated_conv import dilated_conv3x3 as jax_dilated_conv3x3
from multishiftseg_tpu.ops.scores import energy_score as jax_energy_score

from multishiftseg_torch.convert.from_jax import deeplab_from_jax
from multishiftseg_torch.core.config import load_config
from multishiftseg_torch.losses import rcl
from multishiftseg_torch.models.deeplab import DeepWV3Plus, init_ood_head_from_final
from multishiftseg_torch.models.layers import DilatedConv2d
from multishiftseg_torch.models.wider_resnet import WiderResNetA2
from multishiftseg_torch.ops import dilated_conv as dconv
from multishiftseg_torch.ops.scores import energy_score
from multishiftseg_torch.train.deeplab_trainer import TrainDeepLabOOD
from multishiftseg_torch.train.test_runner import build_deeplab_forward

TINY = dict(trunk_structure=(1, 1, 1, 1, 1, 1),
            trunk_channels=((8, 8), (8, 8), (16, 16), (16, 16), (8, 16, 32), (16, 32, 64)))


def perturbed(variables, seed):
    """Seeded numpy noise (0.05) on every leaf, so that no BatchNorm is the
    identity; running variances stay positive."""
    rng = np.random.RandomState(seed)
    flat = flax.traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, variables))
    out = {}
    for k in sorted(flat):
        noise = 0.05 * rng.randn(*flat[k].shape)
        out[k] = (flat[k] + (np.abs(noise) if k[-1] == "var" else noise)).astype(np.float32)
    return flax.traverse_util.unflatten_dict(out)


def tiny_variables(seed=1):
    jm = JaxDeepLab(num_classes=19, **TINY)
    v = jax.jit(lambda k: jm.init({"params": k}, jnp.zeros((1, 64, 64, 3)), train=False))(
        jax.random.PRNGKey(0))
    return jm, perturbed(v, seed)


# ---------------------------------------------------------------------------
# the dilated convolution


# (N, H, W, rate): H < rate < W (the vertical taps wholly outside), maps smaller
# than the rate (the centre tap only), larger than it, odd sizes
DCONV_CASES = [(2, 8, 30, 12), (2, 5, 7, 12), (1, 30, 30, 24), (1, 13, 29, 24),
               (2, 26, 26, 12), (1, 20, 50, 36)]


@pytest.mark.parametrize("case", DCONV_CASES)
def test_dilated_conv_plain_matches_jax(case):
    """Output and both gradients (``jax.vjp``) within 1e-5 of their absolute
    scale; the output also equals torch's own dilated ``conv2d``."""
    n, h, w, rate = case
    rng = np.random.RandomState(sum(case))
    x = rng.randn(n, h, w, 6).astype(np.float32)
    k = rng.randn(3, 3, 6, 5).astype(np.float32)
    g = rng.randn(n, h, w, 5).astype(np.float32)
    out_j, vjp = jax.vjp(lambda a, b: jax_dilated_conv3x3(a, b, rate), jnp.asarray(x),
                         jnp.asarray(k))
    dx_j, dk_j = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    kt = torch.from_numpy(k).requires_grad_()
    out = dconv.dilated_conv3x3(xt, kt, rate)
    out.backward(torch.from_numpy(g))
    scale = float(dconv.dilated_conv3x3_plain(xt.detach().abs(), kt.detach().abs(), rate).max())
    for got, want in ((out.detach(), out_j), (xt.grad, dx_j), (kt.grad, dk_j)):
        want = np.asarray(want)
        tol = 1e-5 * max(np.abs(want).max(), scale if got is out else 0.0)
        assert np.abs(got.numpy() - want).max() <= tol
    ref = torch.nn.functional.conv2d(xt.detach().permute(0, 3, 1, 2),
                                     kt.detach().permute(3, 2, 0, 1), padding=rate,
                                     dilation=rate).permute(0, 2, 3, 1)
    assert float((out.detach() - ref).abs().max()) <= 1e-5 * scale
    # the weight-gradient kernel's plain version: the same function
    torch.testing.assert_close(dconv.dilated_conv3x3_wgrad_plain(xt.detach(), torch.from_numpy(g),
                                                                 rate),
                               kt.grad.permute(0, 1, 3, 2).reshape(9, 5, 6), rtol=0,
                               atol=1e-5 * float(kt.grad.abs().max()))


# ---------------------------------------------------------------------------
# the bottom-k pixel selection


@pytest.mark.parametrize("case", ["ties", "zero", "one", "all"])
def test_bottom_k_sum_plain_matches_jax(case):
    """Keys with many ties at the threshold and +inf at invalid positions; the
    value within one ulp and the gradient (1 below the threshold, need / n_eq
    at it) exactly."""
    rng = np.random.RandomState(11)
    vals = (np.floor(rng.rand(997) * 40) / 16).astype(np.float32)
    valid = rng.rand(997) > 0.25
    keyed = np.where(valid, vals, np.inf).astype(np.float32)
    count = int(valid.sum())
    k = {"ties": int(0.8 * count), "zero": 0, "one": 1, "all": count}[case]
    val_j, grad_j = jax.value_and_grad(
        lambda v: jax_rcl._bottom_k_sum(v, jnp.asarray(keyed), jnp.int32(k)))(jnp.asarray(vals))
    v = torch.from_numpy(vals).requires_grad_()
    out = rcl._bottom_k_sum(v, torch.from_numpy(keyed), torch.tensor(k, dtype=torch.int32))
    out.backward()
    assert abs(float(out.detach()) - float(val_j)) <= np.spacing(np.float32(abs(float(val_j))))
    np.testing.assert_array_equal(v.grad.numpy(), np.asarray(grad_j))
    if case == "ties":  # the threshold is shared: some weights strictly inside (0, 1)
        assert ((v.grad > 0) & (v.grad < 1)).any()


def test_energy_score_matches_jax():
    logits = np.random.RandomState(12).randn(2, 19, 5, 7).astype(np.float32) * 4
    want = np.asarray(jax_energy_score(jnp.asarray(logits.transpose(0, 2, 3, 1))))
    got = energy_score(torch.from_numpy(logits), dim=1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the model


def test_wrn38_deeplab_parameter_count():
    """Shapes only, on the meta device: no weights are built."""
    with torch.device("meta"):
        model = DeepWV3Plus()
    assert sum(p.numel() for p in model.parameters()) == 137_108_800


def test_convs_route_as_the_jax_conv():
    """Only the ASPP's rate-12/24/36 3x3 convs take the dilated-conv op; every
    conv pads ``dilation * (k // 2)`` and has no bias."""
    with torch.device("meta"):
        model = DeepWV3Plus()
    routed = {n: m.dilation[0] for n, m in model.named_modules() if isinstance(m, DilatedConv2d)}
    assert routed == {"aspp.features.1.0": 12, "aspp.features.2.0": 24, "aspp.features.3.0": 36}
    convs = [m for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    assert {m.dilation[0] for m in convs} == {1, 2, 4, 12, 24, 36}
    for m in convs:
        assert m.bias is None
        assert m.padding == tuple(d * (k // 2) for d, k in zip(m.dilation, m.kernel_size))


@pytest.fixture(scope="module")
def tiny():
    return tiny_variables()


def test_deeplab_from_jax_round_trip(tiny):
    """A strict load, and ``convert_deeplab`` of the port's state dict gives
    the JAX tree back exactly."""
    _, variables = tiny
    model = DeepWV3Plus(**TINY)
    model.load_state_dict(deeplab_from_jax(variables), strict=True)
    back = flax.traverse_util.flatten_dict(convert_deeplab(model.state_dict()))
    want = flax.traverse_util.flatten_dict(variables)
    assert set(back) == set(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(back[key], arr, err_msg=str(key))


def test_deeplab_from_jax_is_strict(tiny):
    _, variables = tiny
    bad = {"params": dict(variables["params"], extra={"conv": {"kernel": np.zeros(1)}}),
           "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError, match="no port module"):
        deeplab_from_jax(bad)
    missing = {"params": variables["params"]}  # no running statistics
    with pytest.raises(RuntimeError, match="Missing key"):
        DeepWV3Plus(**TINY).load_state_dict(deeplab_from_jax(missing), strict=True)


def test_tiny_eval_forward_matches_jax(tiny):
    """``build_deeplab_forward`` in f32 against ``DeepWV3Plus.apply(train=False)``:
    score and logits within 1e-4 of their scale."""
    jm, variables = tiny
    x = np.random.RandomState(13).randn(2, 256, 256, 3).astype(np.float32)
    score_j, logit_j = jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables,
                                                                        jnp.asarray(x))
    model = DeepWV3Plus(**TINY)
    model.load_state_dict(deeplab_from_jax(variables), strict=True)
    cfg = load_config("exps/deeplab.yaml")
    cfg.train.bf16 = False
    score, logit = build_deeplab_forward(cfg, model=model, device="cpu")(x)
    assert score.dtype == logit.dtype == torch.float32
    assert tuple(score.shape) == (2, 256, 256) and tuple(logit.shape) == (2, 19, 256, 256)
    for got, want in ((score, np.asarray(score_j)),
                      (logit.permute(0, 2, 3, 1), np.asarray(logit_j))):
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


def test_tiny_trunk_matches_jax(tiny):
    """``WiderResNetA2`` alone: mod2's output and the trunk's, train mode off."""
    _, variables = tiny
    jw = JaxWRN(structure=TINY["trunk_structure"], channels=TINY["trunk_channels"])
    sub = {c: variables[c]["trunk"] for c in ("params", "batch_stats")}
    x = np.random.RandomState(14).randn(1, 96, 80, 3).astype(np.float32)
    m2_j, out_j = jw.apply(sub, jnp.asarray(x), train=False)
    trunk = WiderResNetA2(structure=TINY["trunk_structure"], channels=TINY["trunk_channels"])
    trunk.load_state_dict(deeplab_from_jax({c: {"trunk": v} for c, v in sub.items()}), strict=True)
    with torch.no_grad():
        m2, out = trunk.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    for got, want in ((m2, m2_j), (out, out_j)):
        want = np.asarray(want)
        assert np.abs(got.permute(0, 2, 3, 1).numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_init_ood_head_from_final_matches_jax(tiny):
    _, variables = tiny
    model = DeepWV3Plus(**TINY)
    model.load_state_dict(deeplab_from_jax(variables), strict=True)
    init_ood_head_from_final(model)
    want = deeplab_from_jax({"params": jax_init_ood_head(variables["params"]),
                             "batch_stats": variables["batch_stats"]})
    assert torch.equal(model.state_dict()["ood_head.weight"], want["ood_head.weight"])


def test_entry_points_need_the_card_unless_asked(monkeypatch):
    """No card: the eval forward and the trainer raise at their default device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = DeepWV3Plus(**TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_deeplab_forward(load_config("exps/deeplab.yaml"), model=model)
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainDeepLabOOD(load_config("exps/deeplab.yaml"), model=model)
