"""PyTorch port, the vanilla Mask2Former training path against the JAX package
on the CPU: the vanilla decoder alone and the whole vanilla ``MaskFormer`` on an
unpadded crop (with the margins of the attention masks' deciding logits), the
converter's vanilla names, the instance-mode matching and
``set_criterion_instance`` term by term under deep supervision
(``test_torch_instance_step.py`` holds one whole ``TrainM2FInstance`` step).

Tiny widths (hidden 32, 8 queries, 4 heads, 3 decoder layers, 2 encoder
layers; R-50 at its own widths), 8 classes (the instance recipe's), crops of
72x72 fed unpadded as the instance trainer does (R-50 levels 3, 5 and 9,
masks 18x18), 64 points, fp32. Weights come from the JAX init with seeded
numpy noise and go through ``maskformer_from_jax``; the criterion's draws are
the JAX key splits replayed (:func:`instance_jax_draws`).
"""

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from multishiftseg_tpu.losses import criterion as jax_criterion
from multishiftseg_tpu.losses.matcher import match as jax_match
from multishiftseg_tpu.models.maskformer import MaskFormer as JaxMaskFormer
from multishiftseg_tpu.models.transformer_decoder import (
    MultiScaleMaskedTransformerDecoder as JaxVanillaDecoder)

from multishiftseg_torch.convert.from_jax import maskformer_from_jax
from multishiftseg_torch.losses import criterion
from multishiftseg_torch.losses.matcher import match
from multishiftseg_torch.models.maskformer import MaskFormer
from multishiftseg_torch.models.transformer_decoder import MultiScaleMaskedTransformerDecoder
from multishiftseg_torch.ops.resize import resize_bilinear_nchw

K = 8
CFG = dict(num_classes=K, hidden_dim=32, num_queries=8, nheads=4, dim_feedforward=64,
           dec_layers=3, mask_dim=32, transformer_enc_layers=2)
CROP = (72, 72)
B, T, P = 2, 6, 64
OUT_KEYS = ("pred_logits", "pred_masks")


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


def _assert_close(ours, ref, rel):
    """|ours - ref| <= rel * max|ref|."""
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=0, atol=rel * scale)


def rel_err(ours, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(ours, np.float64) - ref).max() / max(np.abs(ref).max(), 1e-12))


def _assert_attention_masks_agree(got, want, sizes):
    """The masks layer i attends with come from prediction i's mask logits
    resized to ``sizes[i % 3]`` and thresholded at 0. Every deciding logit lies
    clear of 0 compared with the frameworks' difference, and the masks agree."""
    ours = [resize_bilinear_nchw(torch.as_tensor(np.array(m)), sizes[i % 3])
            for i, m in enumerate(got)]
    ref = [resize_bilinear_nchw(torch.as_tensor(np.array(m)), sizes[i % 3])
           for i, m in enumerate(want)]
    margin = min(float(x.abs().min()) for x in ref)
    diff = max(float((g - x).abs().max()) for g, x in zip(ours, ref))
    assert margin > 10 * diff, f"mask logit {margin:.3g} vs difference {diff:.3g}"
    for i, (g, x) in enumerate(zip(ours, ref)):
        assert torch.equal(g > 0, x > 0), f"attention mask {i} differs"


def instance_targets(seed, b=B, hw=CROP, t=T, n_valid=(4, 3)):
    """id_map [B, H, W] int32 (segments as overlapping rectangles, -1 ignore
    around them) and classes [B, T] int32: each image's first two segments
    share a class, the slots past its segments hold -1."""
    rng = np.random.RandomState(seed)
    h, w = hw
    id_map = -np.ones((b, h, w), np.int32)
    classes = -np.ones((b, t), np.int32)
    for i in range(b):
        for s in range(n_valid[i]):
            y0, x0 = rng.randint(0, h - 16), rng.randint(0, w - 16)
            id_map[i, y0:y0 + rng.randint(12, h // 2), x0:x0 + rng.randint(12, w // 2)] = s
        classes[i, :n_valid[i]] = rng.randint(0, K, n_valid[i])
        classes[i, 1] = classes[i, 0]
    return id_map, classes


def instance_jax_draws(key, batch, slots, cfg, n_aux=0):
    """The draws ``set_criterion_instance`` makes from ``key``, in the port's
    layout (``criterion_draws(..., slots=T)``): ``k_match, k_pts = split(key)``,
    the match points from ``k_match``; ``split(k_pts, B * T)``, each split again
    into the uncertain-point candidates and the fill; ``fold_in(key, 100 + i)``
    per auxiliary output."""
    uni = lambda k, shape: np.asarray(jax.random.uniform(k, shape))
    n_s = int(cfg.num_points * cfg.oversample_ratio)
    n_r = cfg.num_points - int(cfg.importance_sample_ratio * cfg.num_points)

    def one(rng):
        k_match, k_pts = jax.random.split(rng)
        pairs = [jax.random.split(k) for k in jax.random.split(k_pts, batch * slots)]
        return {"match_coords": uni(k_match, (batch, cfg.num_points, 2)),
                "uncertain_coords": np.stack([uni(a, (n_s, 2)) for a, _ in pairs]),
                "uncertain_rand": np.stack([uni(b, (n_r, 2)) for _, b in pairs])}

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


# ---------------------------------------------------------------------------
# the vanilla decoder and model


def test_vanilla_decoder_matches_jax():
    """The decoder alone on multi-scale inputs of odd sizes (3, 5, 9; masks
    18x18): predictions of every layer within 1e-4 of scale."""
    rng = np.random.RandomState(3)
    sizes = [(3, 3), (5, 5), (9, 9)]
    x = [rng.randn(1, h, w, 32).astype(np.float32) for h, w in sizes]
    mf = rng.randn(1, 18, 18, 32).astype(np.float32)
    kw = {k: CFG[k] for k in ("num_classes", "hidden_dim", "num_queries", "nheads",
                              "dim_feedforward", "dec_layers", "mask_dim")}
    dec = JaxVanillaDecoder(**kw)
    variables = _perturbed(dec.init(jax.random.PRNGKey(0), [jnp.asarray(a) for a in x],
                                    jnp.asarray(mf)), 4)
    ref = jax.jit(dec.apply)(variables, [jnp.asarray(a) for a in x], jnp.asarray(mf))
    port = MultiScaleMaskedTransformerDecoder(**kw)
    prefix = "sem_seg_head.predictor."
    sd = maskformer_from_jax({"params": {"predictor": variables["params"]}})
    port.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        out = port([torch.from_numpy(a).permute(0, 3, 1, 2) for a in x],
                   torch.from_numpy(mf).permute(0, 3, 1, 2))
    assert set(out) == {"pred_logits", "pred_masks", "aux_outputs"}
    assert len(out["aux_outputs"]) == len(ref["aux_outputs"]) == CFG["dec_layers"]
    _assert_attention_masks_agree([a["pred_masks"] for a in out["aux_outputs"]],
                                  [a["pred_masks"] for a in ref["aux_outputs"]], sizes)
    for got, want in [(out, ref)] + list(zip(out["aux_outputs"], ref["aux_outputs"])):
        for k in OUT_KEYS:
            _assert_close(got[k].numpy(), want[k], 1e-4)


@pytest.fixture(scope="module")
def jax_model():
    jm = JaxMaskFormer(**CFG, predictor="vanilla")
    variables = jax.jit(lambda k: jm.init({"params": k}, jnp.zeros((1, *CROP, 3)),
                                          train=False))(jax.random.PRNGKey(0))
    return jm, _perturbed(variables, 1)


def test_vanilla_maskformer_matches_jax_on_an_unpadded_crop(jax_model):
    """The whole model on a 72x72 image (not a multiple of 32): the converter
    loads the vanilla tree strictly, the attention masks agree with margin,
    and every output is within 1e-4 of scale (R-50, the deformable encoder
    and the decoder in f32, sums in another order)."""
    jm, variables = jax_model
    img = np.random.RandomState(2).randn(1, *CROP, 3).astype(np.float32)
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(img))
    port = MaskFormer(**CFG, predictor="vanilla")
    port.load_state_dict(maskformer_from_jax(variables), strict=True)
    port.eval()
    with torch.no_grad():
        x = torch.from_numpy(img)
        out = port(x)
        _, _, ms = port.sem_seg_head.pixel_decoder(port.backbone(x.permute(0, 3, 1, 2)))
    sizes = [tuple(t.shape[-2:]) for t in ms]
    assert sizes == [(3, 3), (5, 5), (9, 9)]
    assert out["pred_masks"].shape == (1, CFG["num_queries"], 18, 18)
    assert "pred_logits_ood" not in out
    _assert_attention_masks_agree([a["pred_masks"] for a in out["aux_outputs"]],
                                  [a["pred_masks"] for a in ref["aux_outputs"]], sizes)
    for got, want in [(out, ref)] + list(zip(out["aux_outputs"], ref["aux_outputs"])):
        for k in OUT_KEYS:
            _assert_close(got[k].numpy(), want[k], 1e-4)


def test_converter_reads_the_vanilla_names(jax_model):
    """Reference names: ``transformer_cross_attention_layers.{i}.multihead_attn``
    and ``.norm``, one class head, nothing of the GMA's."""
    sd = maskformer_from_jax(jax_model[1])
    pred = "sem_seg_head.predictor."
    for i in range(CFG["dec_layers"]):
        layer = f"{pred}transformer_cross_attention_layers.{i}."
        assert {layer + n for n in ("multihead_attn.in_proj_weight", "multihead_attn.in_proj_bias",
                                    "multihead_attn.out_proj.weight", "norm.weight")} <= set(sd)
    assert not any("class_embed2" in k or "foreground" in k or "background" in k for k in sd)
    assert set(sd) == set(MaskFormer(**CFG, predictor="vanilla").state_dict())


# ---------------------------------------------------------------------------
# instance matching and criterion


@pytest.mark.parametrize("q,t", [(8, 6), (100, 48)])
def test_instance_match_equals_jax(q, t):
    """Duplicate classes, -1 padding slots (BIG rows) and, at (100, 48), the
    recipe's full shape: the same assignment."""
    rng = np.random.RandomState(q + t)
    b, p = 3, 96
    logits = (2 * rng.randn(b, q, K + 1)).astype(np.float32)
    out_pts = (3 * rng.randn(b, q, p)).astype(np.float32)
    tgt_pts = (rng.rand(b, t, p) > 0.6).astype(np.float32)
    tgt_pts[:, :, ::7] = rng.rand(b, t, len(range(0, p, 7)))  # bilinear edge samples
    classes = rng.randint(0, K, (b, t)).astype(np.int32)
    classes[:, 1] = classes[:, 0]
    for i, n in enumerate((t, t - 2, t // 2)):
        classes[i, n:] = -1
    valid = classes >= 0
    ref = jax_match(jnp.asarray(logits), jnp.asarray(out_pts), jnp.asarray(tgt_pts),
                    jnp.asarray(valid), tgt_classes=jnp.asarray(classes))
    got = match(torch.from_numpy(logits), torch.from_numpy(out_pts), torch.from_numpy(tgt_pts),
                torch.from_numpy(valid), tgt_classes=torch.from_numpy(classes))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # an image's valid slots take distinct queries
    for i in range(b):
        assert len(set(got[i][valid[i]].tolist())) == int(valid[i].sum())


def crit_kw(**kw):
    """The instance recipe's criterion at 64 points."""
    base = dict(num_classes=K, num_points=P, class_weight=2.0, mask_weight=5.0,
                dice_weight=5.0, ood_weight=0.0, ood_loss="none",
                mask_loss_with_pixel_selection=False, deep_supervision=True)
    base.update(kw)
    return base


@pytest.mark.parametrize("deep", [True, False])
def test_set_criterion_instance_components_match_jax(deep):
    rng = np.random.RandomState(7)

    def outputs():
        return {"pred_logits": rng.randn(B, 8, K + 1).astype(np.float32),
                "pred_masks": (3 * rng.randn(B, 8, 18, 18)).astype(np.float32)}

    outs, outs_aux = outputs(), [outputs() for _ in range(3)]
    id_map, classes = instance_targets(8)
    jcfg = jax_criterion.CriterionConfig(**crit_kw(deep_supervision=deep))
    tcfg = criterion.CriterionConfig(**crit_kw(deep_supervision=deep))
    key = jax.random.PRNGKey(9)
    j_out = {k: jnp.asarray(v) for k, v in outs.items()}
    j_out["aux_outputs"] = [{k: jnp.asarray(v) for k, v in a.items()} for a in outs_aux]
    ref_total, ref = jax.jit(lambda o, m, c: jax_criterion.set_criterion_instance(
        o, m, c, key, jcfg))(j_out, jnp.asarray(id_map), jnp.asarray(classes))
    draws = to_torch(instance_jax_draws(key, B, T, jcfg, n_aux=3))
    t_out = to_torch(outs)
    t_out["aux_outputs"] = [to_torch(a) for a in outs_aux]
    total, losses, assignments = criterion.set_criterion_instance(
        t_out, torch.from_numpy(id_map), torch.from_numpy(classes), draws, tcfg)
    assert set(losses) == set(ref)
    assert len(losses) == (3 * 4 if deep else 3)
    # f32 sums over points in another order
    for k in ref:
        assert rel_err(float(losses[k]), float(ref[k])) < 1e-4, (k, float(losses[k]),
                                                                   float(ref[k]))
    assert rel_err(float(total), float(ref_total)) < 1e-4
    assert all(a.shape == (B, T) for a in assignments)


def test_instance_draws_follow_the_slots():
    cfg = criterion.CriterionConfig(**crit_kw())
    d = criterion.criterion_draws(torch.Generator().manual_seed(0), B, cfg, (0, 0), num_aux=2,
                                  slots=T)
    n_s = int(P * cfg.oversample_ratio)
    assert d["match_coords"].shape == (B, P, 2)
    assert d["uncertain_coords"].shape == (B * T, n_s, 2)
    assert d["uncertain_rand"].shape == (B * T, P - int(0.75 * P), 2)
    assert len(d["aux"]) == 2 and "rcl_noise" not in d and "orig_coords" not in d
