"""PyTorch port, the serving artifact (``multishiftseg_torch/deploy.py``) and the
kernels as ``torch.library`` custom ops, on the CPU.

- Both model families (tiny widths, JAX weights drawn with numpy in
  ``jax.eval_shape``'s shapes) exported with ``export_model`` and served by
  ``ServingModel`` from the artifacts alone, against JAX's ``model.apply`` and
  ``inference`` on the same padded image: an input smaller than the bucket
  covers the padding and the crop.
- The artifact: no parameter in the program, the ``__meta__`` entries, the
  refusals (oversize input, a key with the reserved prefix), the CLI.
- ``torch.library.opcheck`` on every ``mss::`` op at tiny shapes.
"""

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from multishiftseg_tpu import deploy as jax_deploy
from multishiftseg_tpu.models.deeplab import DeepWV3Plus as JaxDeepLab
from multishiftseg_tpu.models.maskformer import MaskFormer as JaxMaskFormer
from multishiftseg_tpu.models.maskformer import inference as jax_inference

from multishiftseg_torch import deploy
from multishiftseg_torch.convert.from_jax import deeplab_from_jax, maskformer_from_jax
from multishiftseg_torch.core.config import load_config
from multishiftseg_torch.models.deeplab import DeepWV3Plus
from multishiftseg_torch.models.maskformer import MaskFormer
from multishiftseg_torch.ops import library
from multishiftseg_torch.ops import scores

M2F = dict(num_classes=19, hidden_dim=32, num_queries=8, nheads=4, dim_feedforward=64,
           dec_layers=3, mask_dim=32, transformer_enc_layers=2)
DL_TINY = dict(trunk_structure=(1, 1, 1, 1, 1, 1),
               trunk_channels=((8, 8), (8, 8), (16, 16), (16, 16), (8, 16, 32), (16, 32, 64)))
# the image is smaller than its bucket (multiples of 128), so the program pads
IMG_HW = (100, 200)
BUCKET = (128, 256)


def seeded_variables(module, seed, *args, **kwargs):
    """Variables in the shapes ``module.init`` gives, drawn with numpy: kernels
    normal at 0.3 of He's scale by fan-in (at He's own scale the activations of
    these random, untrained stacks grow layer by layer, and sharp attention
    softmaxes magnify f32 rounding to 1e-4 of the outputs in both frameworks),
    norm scales 1 and biases 0 with 0.01 noise, the
    deformable offsets' biases 0.5 px of noise, embeddings 1.0, running
    variances 1 + 0.1 |noise|."""
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
            v = 0.3 * noise * np.sqrt(2.0 / np.prod(shape[:-1]))
        elif leaf == "scale":
            v = 1 + 0.01 * noise
        elif leaf == "bias":
            v = (0.5 if k[-2] == "sampling_offsets" else 0.01) * noise
        else:
            v = noise
        out[k] = np.asarray(v, np.float32)
    return flax.traverse_util.unflatten_dict(out)


def padded(cfg, img):
    """What the program sees: the [0, 1] image zero-padded to the bucket, then
    normalised with the config's mean and std (JAX ``ServingModel`` too)."""
    buf = np.zeros((img.shape[0], *BUCKET, 3), np.float32)
    buf[:, :img.shape[1], :img.shape[2]] = img
    return (buf - np.asarray(cfg.data.mean, np.float32)) / np.asarray(cfg.data.std, np.float32)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Both models exported for the CPU from the same JAX weights: (config,
    JAX model, variables, artifact prefix) by family."""
    out = tmp_path_factory.mktemp("artifacts")
    x = jnp.zeros((1, *BUCKET, 3))
    res = {}
    for name, jm, tm, convert in (
            ("m2f", JaxMaskFormer(**M2F), MaskFormer(**M2F), maskformer_from_jax),
            ("deeplab", JaxDeepLab(num_classes=19, **DL_TINY), DeepWV3Plus(**DL_TINY),
             deeplab_from_jax)):
        variables = seeded_variables(jm, 1, x, train=False)
        tm.load_state_dict(convert(variables), strict=True)
        cfg = load_config(f"exps/{name}.yaml")
        cfg.train.bf16 = False
        prefix = str(out / name)
        deploy.export_model(name, cfg, None, prefix, *IMG_HW, batch=2, device="cpu", module=tm)
        res[name] = (cfg, jm, variables, prefix)
    return res


@pytest.mark.parametrize("family", ["m2f", "deeplab"])
def test_served_outputs_match_jax(artifacts, family):
    """``ServingModel`` on a batch of 1 image (the program's batch is 2) of
    100 x 200 in a 128 x 256 bucket against JAX's forward on the same padded,
    normalised batch, cropped: within 1e-5, of the output's scale where that
    exceeds 1 (f32 sums in another order). M2F: (anomaly, sem) of JAX
    ``inference``; DeepLab: (score, logit NCHW)."""
    cfg, jm, variables, prefix = artifacts[family]
    img = np.random.RandomState(7).rand(1, *IMG_HW, 3).astype(np.float32)
    served = deploy.ServingModel(prefix)
    assert served.input_shape == (2, *BUCKET, 3)
    got = served(img)
    x = np.concatenate([padded(cfg, img), np.zeros((1, *BUCKET, 3), np.float32)])
    if family == "m2f":
        sem, anomaly = jax.jit(lambda v, a: jax_inference(jm.apply(v, a, train=False), BUCKET,
                                                          num_classes=19))(variables, x)
        want = (np.asarray(anomaly), np.asarray(sem))
    else:
        score, logit = jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, x)
        want = (np.asarray(score), np.asarray(logit).transpose(0, 3, 1, 2))
    h, w = IMG_HW
    assert got[0].shape == (1, h, w) and got[1].shape[0] == 1 and got[1].shape[2:] == (h, w)
    for g, r in ((got[0], want[0][:1, :h, :w]), (got[1], want[1][:1, :, :h, :w])):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-5 * max(1.0, np.abs(r).max()))


@pytest.mark.parametrize("family", ["m2f", "deeplab"])
def test_artifact_holds_no_weights(artifacts, family):
    """The program holds no parameter or buffer, nor the example inputs it was
    traced with: the weights are its runtime inputs, in the npz beside it
    under the ``state_dict``'s names, with the
    normalisation under ``__meta__/`` as JAX writes it. Every kernel of the
    forward is a call of its ``mss::`` op in the program."""
    cfg, _, _, prefix = artifacts[family]
    ep = deploy.load_exported(prefix + ".pt2")
    assert len(ep.state_dict) == 0 and ep.example_inputs is None
    assert not any(isinstance(c, torch.nn.Parameter) for c in ep.constants.values())
    weights = deploy.load_pytree_npz(prefix + ".npz")
    model = MaskFormer(**M2F) if family == "m2f" else DeepWV3Plus(**DL_TINY)
    assert set(weights) == set(model.state_dict())
    meta = deploy.load_npz_meta(prefix + ".npz")
    np.testing.assert_array_equal(meta["input_mean"], np.asarray(cfg.data.mean, np.float32))
    np.testing.assert_array_equal(meta["input_std"], np.asarray(cfg.data.std, np.float32))
    assert int(meta["normalization_baked"]) == 1
    jax_meta = jax_deploy.load_npz_meta(prefix + ".npz")  # JAX's reader reads them alike
    assert set(jax_meta) == set(meta) == {"input_mean", "input_std", "normalization_baked"}
    calls = {str(n.target) for gm in ep.graph_module.modules() if isinstance(
        gm, torch.fx.GraphModule) for n in gm.graph.nodes if str(n.target).startswith("mss.")}
    want = ({"mss.ms_deform_attn.default", "mss.mask_scores.default"} if family == "m2f"
            else {"mss.dilated_conv3x3.default"})
    assert calls == want


def test_serving_refuses_an_oversize_input(artifacts):
    served = deploy.ServingModel(artifacts["deeplab"][3])
    for shape in ((3, 100, 100, 3), (1, 129, 100, 3), (1, 100, 257, 3)):
        with pytest.raises(ValueError, match="exceeds exported"):
            served(np.zeros(shape, np.float32))


def test_npz_prefix_guard_and_round_trip(tmp_path):
    """A name holding the reserved ``__meta__/`` prefix is refused, as JAX's
    ``_flat_key`` refuses a ``/``; the rest round-trips exactly."""
    tree = {"a.weight": torch.randn(3, 2), "b.running_var": torch.rand(4)}
    deploy.save_pytree_npz(tree, str(tmp_path / "w.npz"), meta={"k": np.arange(3)})
    back = deploy.load_pytree_npz(str(tmp_path / "w.npz"))
    assert set(back) == set(tree) and all(torch.equal(back[k], tree[k]) for k in tree)
    np.testing.assert_array_equal(deploy.load_npz_meta(str(tmp_path / "w.npz"))["k"],
                                  np.arange(3))
    with pytest.raises(ValueError, match="reserved prefix"):
        deploy.save_pytree_npz({"x.__meta__/y": torch.zeros(1)}, str(tmp_path / "bad.npz"))


def test_cli_writes_both_artifacts(tmp_path):
    """``python -m multishiftseg_torch.deploy --model m2f ... --device cpu`` on
    a recipe narrowed by a YAML that includes ``exps/m2f.yaml`` (random init
    from its seed): a program without parameters, the weights, and a served
    output of the bucket's image size."""
    cfg = tmp_path / "narrow.yaml"
    cfg.write_text("base: {}\nmodel:\n  m2f:\n    backbone: resnet18\n    hidden_dim: 32\n"
                   "    mask_dim: 32\n    dim_feedforward: 64\n    num_queries: 8\n"
                   "    nheads: 4\n    dec_layers: 4\n    transformer_enc_layers: 1\n"
                   "train:\n  bf16: false\n".format(
                       __import__("os").path.abspath("exps/m2f.yaml")))
    prefix = str(tmp_path / "cli")
    deploy.main(["--model", "m2f", "--cfg", str(cfg), "--height", "64", "--width", "96",
                 "--device", "cpu", "--out", prefix])
    assert len(deploy.load_exported(prefix + ".pt2").state_dict) == 0
    anomaly, sem = deploy.ServingModel(prefix)(np.full((1, 64, 96, 3), 0.5, np.float32))
    assert anomaly.shape == (1, 64, 96) and sem.shape == (1, 19 + 8, 64, 96)
    assert np.isfinite(anomaly).all() and np.isfinite(sem).all()


# ---------------------------------------------------------------------------
# the custom ops


def _opcheck_cases():
    g = np.random.RandomState(0)
    t = lambda *s, grad=False, dtype=torch.float32: torch.tensor(
        g.rand(*s), dtype=dtype).requires_grad_(grad)
    levels = [2, 3, 1, 2]  # (2, 3) and (1, 2): S = 8
    value, loc, attn = t(1, 8, 2, 4, grad=True), t(1, 5, 2, 2, 2, 2, grad=True), t(
        1, 5, 2, 2, 2, grad=True)
    masks, probs = t(1, 3, 4, 5, grad=True), t(1, 3, 6, grad=True)
    x, kernel = t(1, 6, 7, 4, grad=True), t(3, 3, 4, 5, grad=True)
    ops = torch.ops.mss
    return {
        "ms_deform_attn": (ops.ms_deform_attn, (value, loc, attn, levels, False)),
        "ms_deform_attn_nearest": (ops.ms_deform_attn, (value.detach(), loc.detach(),
                                                        attn.detach(), levels, True)),
        "ms_deform_attn_backward": (ops.ms_deform_attn_backward, (
            value.detach(), loc.detach(), attn.detach(), t(1, 5, 8), levels)),
        "ms_deform_attn_quantize": (ops.ms_deform_attn_quantize, (value.detach(),)),
        "ms_deform_attn_int8_table": (ops.ms_deform_attn_int8_table, (value, loc, attn,
                                                                      levels)),
        "ms_deform_attn_approx": (ops.ms_deform_attn_approx, (
            value.detach(), loc.detach(), attn.detach(), levels, "nearest_topc", 3)),
        "mask_scores": (ops.mask_scores, (masks, probs, None, [7, 9], scores._ANOMALY)),
        "mask_scores_semantic": (ops.mask_scores, (masks.detach(), probs.detach(),
                                                   t(1, 3), [7, 9], scores._SEMANTIC)),
        "mask_scores_backward": (ops.mask_scores_backward, (
            masks.detach(), probs.detach(), t(1, 7, 9), [7, 9], True)),
        "dilated_conv3x3": (ops.dilated_conv3x3, (x, kernel, 2)),
        "dilated_conv3x3_backward": (ops.dilated_conv3x3_backward, (
            x.detach(), kernel.detach(), t(1, 6, 7, 5), 2, True, False)),
    }


@pytest.mark.parametrize("case", sorted(_opcheck_cases()))
def test_opcheck(case):
    """``torch.library.opcheck`` of every ``mss::`` op on the CPU: the schema,
    the fake implementation against the real one, the autograd registration
    (gradients where the op has a backward), and the op under
    ``aot_dispatch_dynamic``."""
    op, args = _opcheck_cases()[case]
    torch.library.opcheck(op, args)


def test_every_op_has_a_fake_and_both_devices():
    """Each ``mss::`` op: a fake implementation (what ``torch.export`` traces,
    and what a meta tensor gets), the plain version on the CPU, the kernel's
    launch on CUDA, autograd where the op has a backward; and every op is one
    of the opcheck cases."""
    from torch._library.simple_registry import singleton

    has = torch._C._dispatch_has_kernel_for_dispatch_key
    for name in library.OPS:
        qualname = f"{library.NAMESPACE}::{name}"
        assert singleton.find(qualname).fake_impl.kernel is not None, name
        assert all(has(qualname, key) for key in ("CPU", "CUDA", "Meta")), name
        assert has(qualname, "Autograd") == (name in (
            "ms_deform_attn", "ms_deform_attn_int8_table", "mask_scores", "dilated_conv3x3")), name
    assert ({op._qualified_op_name.split("::")[1] for op, _ in _opcheck_cases().values()}
            == set(library.OPS))
