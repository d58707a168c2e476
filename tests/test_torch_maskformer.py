"""PyTorch port, the whole eval slice: ``MaskFormer`` + ``inference`` and
``build_m2f_request_forward`` against the JAX package on the CPU, the converter round
trip through ``convert_maskformer``, and the metrics at the end of the path.

Narrow widths (hidden 32, 8 queries, 2 encoder and 3 decoder layers; R-50 at its
own widths) at 64x128. The JAX model is initialised from a seed and every leaf is
perturbed with seeded numpy noise before both sides get the same weights.
"""

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from multishiftseg_tpu.convert.torch2jax import convert_maskformer
from multishiftseg_tpu.evals.ood_metrics import eval_ood_measure as jax_eval_ood_measure
from multishiftseg_tpu.models.maskformer import MaskFormer as JaxMaskFormer
from multishiftseg_tpu.models.maskformer import inference as jax_inference
from multishiftseg_tpu.models.maskformer import preprocess as jax_preprocess

from multishiftseg_torch.convert.from_jax import maskformer_from_jax
from multishiftseg_torch.evals.ood_metrics import eval_ood_measure
from multishiftseg_torch.models.maskformer import MaskFormer, inference, preprocess
from multishiftseg_torch.ops.resize import resize_bilinear_nchw
from multishiftseg_torch.train.test_runner import build_m2f_request_forward

CFG = dict(num_classes=19, hidden_dim=32, num_queries=8, nheads=4, dim_feedforward=64,
           dec_layers=3, mask_dim=32, transformer_enc_layers=2)
H, W = 64, 128
OUT_KEYS = ("pred_logits", "pred_masks", "pred_logits_ood", "pred_masks_ood")


def _perturbed(variables, seed):
    """Seeded numpy noise on every leaf (0.01, as bench.py), 0.1 on the deformable
    offset/weight kernels, which the init sets to zero."""
    rng = np.random.RandomState(seed)
    flat = flax.traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, variables))
    out = {}
    for k in sorted(flat):
        scale = 0.1 if k[-2] in ("sampling_offsets", "attention_weights") else 0.01
        out[k] = (flat[k] + scale * rng.randn(*flat[k].shape)).astype(np.float32)
    return flax.traverse_util.unflatten_dict(out)


def _assert_close(ours, ref, rel):
    """|ours - ref| <= rel * max|ref|: the error scale of an f32 stack is the
    magnitude of its activations."""
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=0, atol=rel * scale)


@pytest.fixture(scope="module")
def slice_run():
    images = np.random.RandomState(0).randint(0, 256, (1, H, W, 3)).astype(np.uint8)
    jm = JaxMaskFormer(**CFG)
    x = jax_preprocess(jnp.asarray(images))
    variables = jax.jit(lambda k, x: jm.init({"params": k}, x, train=False))(
        jax.random.PRNGKey(0), x)
    variables = _perturbed(variables, 1)

    @jax.jit
    def jax_fwd(v, x):
        out, state = jm.apply(v, x, train=False, mutable=["intermediates"],
                              capture_intermediates=lambda mdl, _: mdl.name == "mask_embed")
        sem, anomaly = jax_inference(out, x.shape[1:3], num_classes=19)
        return out, state["intermediates"], sem, anomaly

    ref, inter, sem_ref, anomaly_ref = jax_fwd(variables, x)
    calls = inter["predictor"]["mask_embed"]["__call__"]

    port = MaskFormer(**CFG)
    port.load_state_dict(maskformer_from_jax(variables), strict=True)
    port.eval()
    embeds = []
    port.sem_seg_head.predictor.mask_embed.register_forward_hook(
        lambda mod, inp, out: embeds.append(out.numpy()))
    with torch.no_grad():
        xt = preprocess(torch.from_numpy(images))
        out = port(xt)
        mask_features = port.sem_seg_head.pixel_decoder(
            port.backbone(xt.permute(0, 3, 1, 2)))[0]
    return dict(images=images, variables=variables, port=port, ref=ref, out=out,
                sem_ref=np.asarray(sem_ref), anomaly_ref=np.asarray(anomaly_ref),
                # mask_embed: once before the layers, then once per layer in the
                # port and twice (class and OOD heads, same input) in JAX
                jax_embeds=([calls[0]] + list(calls[1::2]))[:CFG["dec_layers"]],
                embeds=embeds[:CFG["dec_layers"]], mask_features=mask_features)


def test_attention_masks_match_jax(slice_run):
    """Masked attention thresholds mask logits at 0 as hard booleans: a logit
    within rounding distance of 0 would flip a mask bit between frameworks and the
    decoders would diverge. Every deciding logit of this seed lies clear of 0
    compared with the frameworks' difference, and the masks agree."""
    r = slice_run
    h, w = r["mask_features"].shape[-2:]
    sizes = [(h // 8, w // 8), (h // 4, w // 4), (h // 2, w // 2)]  # strides 32, 16, 8

    def deciding(embeds):
        return [resize_bilinear_nchw(
            torch.einsum("nqc,nchw->nqhw", torch.as_tensor(np.array(e, np.float32)),
                         r["mask_features"]), sizes[i % 3]) for i, e in enumerate(embeds)]

    got, want = deciding(r["embeds"]), deciding(r["jax_embeds"])
    margin = min(float(x.abs().min()) for x in want)
    diff = max(float((g - x).abs().max()) for g, x in zip(got, want))
    assert margin > 10 * diff, f"mask logit {margin:.3g} vs difference {diff:.3g}"
    for i, (g, x) in enumerate(zip(got, want)):
        assert torch.equal(g > 0, x > 0), f"attention mask {i} differs"


def test_prediction_dict_matches_jax(slice_run):
    out, ref = slice_run["out"], slice_run["ref"]
    assert out["pred_logits"].shape == (1, 8, 20)
    assert out["pred_masks"].shape == (1, 8, H // 4, W // 4)
    assert len(out["aux_outputs"]) == len(ref["aux_outputs"]) == CFG["dec_layers"] - 1
    # R-50 + deformable encoder + decoder in f32, sums in another order; flax
    # norms take the variance as E[x^2] - E[x]^2
    for got, want in [(out, ref)] + list(zip(out["aux_outputs"], ref["aux_outputs"])):
        for k in OUT_KEYS:
            _assert_close(got[k].numpy(), want[k], 1e-4)


def test_inference_matches_jax(slice_run):
    with torch.no_grad():
        sem, anomaly = inference(slice_run["out"], (H, W), num_classes=19)
    assert sem.shape == (1, 19 + 8, H, W) and anomaly.shape == (1, H, W)
    # scores in [0, 1] after softmax x sigmoid
    np.testing.assert_allclose(sem.numpy(), slice_run["sem_ref"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(anomaly.numpy(), slice_run["anomaly_ref"], rtol=0, atol=1e-4)


def test_build_m2f_forward_matches_jax_and_reaches_metrics(slice_run):
    fwd = build_m2f_request_forward(slice_run["port"], device="cpu")
    anomaly, sem = fwd(slice_run["images"])
    np.testing.assert_allclose(anomaly.numpy(), slice_run["anomaly_ref"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(sem.numpy(), slice_run["sem_ref"], rtol=0, atol=1e-4)
    label = np.zeros((H, W), np.int64)
    label[16:40, 40:88] = 1  # a synthetic anomaly square
    ours = eval_ood_measure(anomaly[0].numpy(), label)
    ref = jax_eval_ood_measure(slice_run["anomaly_ref"][0], label, use_native=False)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-3)


def test_nearest_mode_forward_runs(slice_run):
    anomaly, sem = build_m2f_request_forward(slice_run["port"], device="cpu",
                                             sample_mode="nearest")(slice_run["images"])
    assert anomaly.shape == (1, H, W) and sem.shape == (1, 27, H, W)
    assert torch.isfinite(anomaly).all() and torch.isfinite(sem).all()


def test_unported_options_raise(slice_run):
    with pytest.raises(NotImplementedError):
        MaskFormer(backbone="swin_tiny")
    with pytest.raises(NotImplementedError):
        MaskFormer(predictor="vanilla")
    # both approximate tails at once (JAX lets score_topq win), an unknown mode
    with pytest.raises(ValueError, match="exclusive"):
        inference(slice_run["out"], (H, W), score_lowres=True, score_topq=4)
    with pytest.raises(ValueError, match="unknown sample_mode"):
        build_m2f_request_forward(slice_run["port"], device="cpu", sample_mode="bicubic")


def test_converter_round_trip_through_convert_maskformer():
    """port state_dict -> convert_maskformer -> maskformer_from_jax is the identity,
    and the JAX tree in the middle has the JAX MaskFormer's structure.
    ``convert_maskformer`` hard-codes 6 encoder layers."""
    cfg = dict(CFG, transformer_enc_layers=6)
    torch.manual_seed(0)
    sd = MaskFormer(**cfg).state_dict()
    variables = convert_maskformer(sd, dec_layers=cfg["dec_layers"])
    init = jax.eval_shape(lambda: JaxMaskFormer(**cfg).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, H, W, 3)), train=False))
    for col in ("params", "batch_stats"):
        got = {k: v.shape for k, v in flax.traverse_util.flatten_dict(variables[col]).items()}
        want = {k: v.shape for k, v in flax.traverse_util.flatten_dict(init[col]).items()}
        assert got == want, col
    back = maskformer_from_jax(variables)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    MaskFormer(**cfg).load_state_dict(back, strict=True)
