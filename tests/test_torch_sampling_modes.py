"""PyTorch port, the approximate eval modes against the JAX package on the CPU.

Every sample mode of ``ms_deform_attn_core`` (the port's plain versions)
against JAX's at f32: ``nearest_top{T}`` and ``nearest_top{T}c`` for T in
{1, 6, J}, ``shared`` and the int8 table, on regular and degenerate pyramids,
with random weights, all-equal weights (every selection rests on the tie rule)
and weights with zeros; the int8 table bit for bit; the mode parser; the
per-layer hybrid pixel decoder; ``inference`` with each approximate tail; and
the module at its zero-initialised weights (all equal: 1 / J).

Tolerance 1e-5 (atol and rtol): f32 sums of at most J + L weighted rows taken
in another order. A centroid (``nearest_top{T}c``, ``shared``) is an f32 sum
whose order differs between JAX and the port; where one lies within 1e-4 px of
a rounding boundary the two may take neighbouring pixels. Those outputs are
counted (at most a tenth of them) and left out; every other output is held to the
tolerance.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import flax
import jax
import jax.numpy as jnp

from multishiftseg_tpu.models import maskformer as jax_maskformer
from multishiftseg_tpu.models.pixel_decoder import MSDeformAttnPixelDecoder as JaxPixelDecoder
from multishiftseg_tpu.ops import ms_deform_attn as jax_msda

from multishiftseg_torch.convert.from_jax import maskformer_from_jax
from multishiftseg_torch.models import maskformer
from multishiftseg_torch.models.pixel_decoder import MSDeformAttnPixelDecoder
from multishiftseg_torch.ops import ms_deform_attn as msda
from multishiftseg_torch.ops import scores

from test_torch_kernels import near_rounding_boundary

N, M, D, LQ, P = 2, 4, 8, 7, 3
# (1, 5) and (4, 1) are the degenerate h == 1 / w == 1 levels a 32-px input side
# produces; J = L * P is 6 and 9
LEVEL_SETS = {"regular": [(6, 4), (3, 2)], "degenerate": [(1, 5), (4, 1), (3, 3)]}
MODES = ("nearest_top1", "nearest_top6", "nearest_topJ", "nearest_top1c", "nearest_top6c",
         "nearest_topJc", "shared", "int8")


def _inputs(seed, shapes, weights):
    rng = np.random.RandomState(seed)
    s = sum(h * w for h, w in shapes)
    value = rng.randn(N, s, M, D).astype(np.float32)
    # locations in [-0.1, 1.1]: some points fall outside the map
    loc = rng.rand(N, LQ, M, len(shapes), P, 2).astype(np.float32) * 1.2 - 0.1
    if weights == "equal":  # ties everywhere: the selection is the tie rule alone
        attn = np.full((N, LQ, M, len(shapes), P), 1.0 / (len(shapes) * P), np.float32)
    else:
        attn = rng.rand(N, LQ, M, len(shapes), P).astype(np.float32)
        if weights == "zeros":  # a third exactly 0, and some heads all 0
            attn[rng.rand(*attn.shape) < 0.33] = 0.0
            attn[:, 0, 0] = 0.0
        attn /= np.maximum(attn.reshape(N, LQ, M, -1).sum(-1), 1e-6).reshape(N, LQ, M, 1, 1)
    return value, loc, attn


def _mode(name, shapes):
    return name.replace("J", str(len(shapes) * P))


def _port(value, loc, attn, shapes, mode):
    args = (torch.from_numpy(value), shapes, torch.from_numpy(loc), torch.from_numpy(attn))
    if mode == "int8":
        return msda.ms_deform_attn_core(*args, "bilinear", quantize_table=True).numpy()
    return msda.ms_deform_attn_core(*args, mode).numpy()


def _jax(value, loc, attn, shapes, mode):
    args = (jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(attn))
    if mode == "int8":
        return np.asarray(jax_msda.ms_deform_attn_core(*args, quantize_table=True))
    return np.asarray(jax_msda.ms_deform_attn_core(*args, sample_mode=mode))


def assert_close_off_boundaries(ours, ref, loc, attn, shapes, mode):
    skip = near_rounding_boundary(loc, attn, shapes, mode)
    keep = ~np.repeat(skip, D, axis=-1).reshape(ours.shape)
    np.testing.assert_allclose(ours[keep], ref[keep], rtol=1e-5, atol=1e-5)
    return int(skip.sum())


@pytest.mark.parametrize("weights", ["random", "equal", "zeros"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("levels", sorted(LEVEL_SETS))
def test_core_mode_matches_jax(levels, mode, weights):
    shapes = LEVEL_SETS[levels]
    mode = _mode(mode, shapes)
    value, loc, attn = _inputs(0, shapes, weights)
    ours, ref = _port(value, loc, attn, shapes, mode), _jax(value, loc, attn, shapes, mode)
    assert ours.shape == ref.shape == (N, LQ, M * D)
    skipped = assert_close_off_boundaries(ours, ref, loc, attn, shapes, mode)
    assert skipped <= N * LQ * M // 10  # a near-boundary centroid is rare
    assert np.abs(ref).max() > 0.1  # the points really sample the maps


@pytest.mark.parametrize("levels", sorted(LEVEL_SETS))
def test_top_all_points_is_nearest(levels):
    """T = J keeps every point: ``nearest_top{J}`` and ``nearest_top{J}c`` are
    ``nearest`` up to f32 order (the JAX docstrings' reduction)."""
    shapes = LEVEL_SETS[levels]
    value, loc, attn = _inputs(1, shapes, "random")
    j = len(shapes) * P
    args = (torch.from_numpy(value), shapes, torch.from_numpy(loc), torch.from_numpy(attn))
    near = np.asarray(jax_msda.ms_deform_attn_core(
        jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(attn), sample_mode="nearest"))
    for mode in (f"nearest_top{j}", f"nearest_top{j}c"):
        np.testing.assert_allclose(msda.ms_deform_attn_core(*args, mode).numpy(), near,
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("levels", sorted(LEVEL_SETS))
def test_int8_gradients_match_jax_vjp(levels):
    """Under grad the int8 table goes through its op's autograd: d value,
    d loc and d attn equal ``jax.vjp`` of JAX's op with ``quantize_table``,
    whose custom VJP takes the exact bilinear gradients on the saved exact
    value. Tolerance 1e-5 of each gradient's scale: f32 sums of the same
    products in another order."""
    shapes = LEVEL_SETS[levels]
    value, loc, attn = _inputs(5, shapes, "random")
    g = np.random.RandomState(6).randn(N, LQ, M * D).astype(np.float32)
    tv, tl, ta = (torch.from_numpy(t).requires_grad_() for t in (value, loc, attn))
    out = msda.ms_deform_attn_core(tv, shapes, tl, ta, "bilinear", quantize_table=True)
    assert "mss_ms_deform_attn_int8_table" in type(out.grad_fn).__name__
    out.backward(torch.from_numpy(g))
    ref, vjp = jax.vjp(lambda v, l, a: jax_msda.ms_deform_attn_core(
        v, shapes, l, a, quantize_table=True), jnp.asarray(value), jnp.asarray(loc),
        jnp.asarray(attn))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    for ours, want in zip((tv.grad, tl.grad, ta.grad), vjp(jnp.asarray(g))):
        want = np.asarray(want)
        np.testing.assert_allclose(ours.numpy(), want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_int8_table_equals_jax_bit_for_bit(dtype):
    """The table and the scale of the expression at ``ms_deform_attn.py:135-139``,
    op by op: ``max |v| / 127`` and ``v / scale`` as IEEE divisions, rounding
    half to even. Compiled, XLA turns the division by the constant 127 into a
    multiply by its f32 reciprocal, one rounding step off in some channels
    (shown here); the port divides, as the expression says."""
    rng = np.random.RandomState(2)
    value = (rng.randn(2, 40, 4, 16) * rng.rand(1, 1, 1, 16) * 3).astype(np.float32)
    value[..., 5] = 0.0  # an all-zero channel: the scale floors at 1e-12
    tv = torch.from_numpy(value)
    jv = jnp.asarray(value)
    if dtype == "bfloat16":
        tv, jv = tv.to(torch.bfloat16), jv.astype(jnp.bfloat16)

    def expr(v):
        scale = jnp.maximum(jnp.max(jnp.abs(v.astype(jnp.float32)), axis=(0, 1, 2)) / 127.0,
                            1e-12)
        q = jnp.clip(jnp.round(v.astype(jnp.float32) / scale), -127, 127).astype(jnp.int8)
        return q, scale

    q, scale = msda.quantize_value_table_plain(tv)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    assert scale[5] == np.float32(1e-12) and int(q.abs().max()) == 127
    jq, jscale = expr(jv)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy().view(np.uint32), np.asarray(jscale).view(np.uint32))
    amax = tv.float().abs().amax(dim=(0, 1, 2)).numpy()
    compiled = np.asarray(jax.jit(expr)(jv)[1])
    np.testing.assert_array_equal(
        compiled[amax > 0], (amax * np.float32(1 / np.float32(127)))[amax > 0])


def test_nan_in_the_table_as_jax():
    """A NaN in value: its channel's scale is NaN and that channel's table 0,
    as JAX's expression gives (``jnp.max`` propagates it, XLA converts NaN to
    0); the other channels keep their scales and entries."""
    rng = np.random.RandomState(3)
    value = rng.randn(2, 30, 4, 8).astype(np.float32)
    value[1, 7, 2, 5] = np.nan
    jv = jnp.asarray(value)
    jscale = jnp.maximum(jnp.max(jnp.abs(jv), axis=(0, 1, 2)) / 127.0, 1e-12)
    jq = np.asarray(jnp.clip(jnp.round(jv / jscale), -127, 127).astype(jnp.int8))
    q, scale = msda.quantize_value_table_plain(torch.from_numpy(value))
    np.testing.assert_array_equal(q.numpy(), jq)
    assert not jq[..., 5].any()
    scale, jscale = scale.numpy(), np.asarray(jscale)
    np.testing.assert_array_equal(np.isnan(scale), np.arange(8) == 5)
    np.testing.assert_array_equal(scale[:5].view(np.uint32), jscale[:5].view(np.uint32))
    np.testing.assert_array_equal(scale[6:].view(np.uint32), jscale[6:].view(np.uint32))


def test_round_half_to_even_in_the_table():
    """A value at an exact half step rounds to the even integer, as jnp.round."""
    v = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5]).view(1, 7, 1, 1).expand(
        1, 7, 1, 1).contiguous()
    q, scale = msda.quantize_value_table_plain(v.view(1, 7, 1, 1))
    assert float(scale) == 1.0
    assert q.view(-1).tolist() == [127, 0, 2, 2, 0, -2, 126]


@pytest.mark.parametrize("mode", ["nearest_top", "nearest_topc", "nearest_top0",
                                  "nearest_top13", "nearest_top13c", "top6", "int8",
                                  "bicubic", "nearest_top6cc"])
def test_parser_rejects_what_jax_rejects(mode):
    with pytest.raises(ValueError):
        msda.parse_sample_mode(mode, 12)


def test_parser_accepts_what_jax_accepts():
    assert msda.parse_sample_mode("nearest_top12", 12) == ("nearest_top", 12)
    assert msda.parse_sample_mode("nearest_top06c", 12) == ("nearest_topc", 6)
    assert msda.parse_sample_mode("shared") == ("shared", 0)
    assert msda.parse_eval_sample_mode("int8") == ("bilinear", True)
    hybrid = msda.parse_eval_sample_mode("bilinear, nearest_top6c,shared", 12)
    assert hybrid == (("bilinear", "nearest_top6c", "shared"), False)
    with pytest.raises(ValueError):
        msda.parse_eval_sample_mode("bilinear,int8", 12)  # JAX's hybrid takes no int8
    with pytest.raises(ValueError):
        msda.ms_deform_attn_core(*(torch.zeros(1, 6, 1, 2), [(2, 3)]), torch.zeros(
            1, 1, 1, 1, 2, 2), torch.zeros(1, 1, 1, 1, 2), "nearest_top3")  # T > J = 2
    with pytest.raises(ValueError):  # JAX ignores the table outside bilinear; the port refuses
        msda.ms_deform_attn_core(torch.zeros(1, 6, 1, 2), [(2, 3)], torch.zeros(
            1, 1, 1, 1, 2, 2), torch.zeros(1, 1, 1, 1, 2), "nearest", quantize_table=True)


def _perturbed(variables, seed):
    rng = np.random.RandomState(seed)
    flat = flax.traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, variables))
    out = {}
    for k in sorted(flat):
        scale = 0.1 if k[-2] in ("sampling_offsets", "attention_weights") else 0.01
        out[k] = (flat[k] + scale * rng.randn(*flat[k].shape)).astype(np.float32)
    return flax.traverse_util.unflatten_dict(out)


@pytest.mark.parametrize("mode", ["nearest_top6c", "shared", "nearest_top4"])
def test_module_at_init_matches_jax(mode):
    """``MSDeformAttn`` with its zero-initialised weight head: every weight is
    exactly 1 / J, so the selection rests wholly on the tie rule."""
    shapes = [(4, 6), (2, 3)]
    s = sum(h * w for h, w in shapes)
    rng = np.random.RandomState(3)
    query = rng.randn(1, s, 32).astype(np.float32)
    src = rng.randn(1, s, 32).astype(np.float32)
    ref_pts = np.broadcast_to(rng.rand(1, s, 1, 2), (1, s, 2, 2)).astype(np.float32)
    jm = jax_msda.MSDeformAttn(d_model=32, n_levels=2, n_heads=4, n_points=3, sample_mode=mode)
    args = (jnp.asarray(query), jnp.asarray(ref_pts), jnp.asarray(src), shapes)
    variables = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), *args))
    ref = np.asarray(jm.apply(variables, *args))
    prefix = "sem_seg_head.pixel_decoder.transformer.encoder.layers.0.self_attn."
    sd = maskformer_from_jax(
        {"params": {"pixel_decoder": {"encoder_layer_0": {"self_attn": variables["params"]}}}})
    tm = msda.MSDeformAttn(d_model=32, n_levels=2, n_heads=4, n_points=3)
    tm.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    assert float(tm.attention_weights.weight.abs().max()) == 0.0
    with torch.no_grad():
        ours = tm(torch.from_numpy(query), torch.from_numpy(ref_pts), torch.from_numpy(src),
                  shapes, sample_mode=mode).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)


FEATURE_SHAPES = {"res2": (16, 32, 256), "res3": (8, 16, 512), "res4": (4, 8, 1024),
                  "res5": (2, 4, 2048)}
HYBRID = ("bilinear", "nearest_top6c", "shared")


@pytest.fixture(scope="module")
def decoder_pair():
    rng = np.random.RandomState(4)
    feats = {k: rng.randn(1, *s).astype(np.float32) for k, s in FEATURE_SHAPES.items()}
    jm = JaxPixelDecoder(conv_dim=32, mask_dim=32, transformer_enc_layers=3,
                         sample_mode=HYBRID)
    jf = {k: jnp.asarray(v) for k, v in feats.items()}
    variables = _perturbed(jax.jit(lambda k, f: jm.init(k, f))(jax.random.PRNGKey(0), jf), 5)
    ref = jax.jit(lambda v, f: jm.apply(v, f))(variables, jf)
    tm = MSDeformAttnPixelDecoder(conv_dim=32, mask_dim=32, transformer_enc_layers=3)
    tree = {col: {"pixel_decoder": sub} for col, sub in variables.items()}
    prefix = "sem_seg_head.pixel_decoder."
    tm.load_state_dict({k[len(prefix):]: v for k, v in maskformer_from_jax(tree).items()},
                       strict=True)
    return tm, {k: torch.from_numpy(v).permute(0, 3, 1, 2) for k, v in feats.items()}, ref


def test_hybrid_pixel_decoder_matches_jax(decoder_pair):
    tm, feats, (mask_ref, top_ref, ms_ref) = decoder_pair
    with torch.no_grad():
        mask, top, ms = tm(feats, sample_mode=HYBRID)
    scale = lambda r: 1e-4 * max(float(np.abs(np.asarray(r)).max()), 1e-6)
    np.testing.assert_allclose(mask.numpy(), np.asarray(mask_ref).transpose(0, 3, 1, 2),
                               rtol=0, atol=scale(mask_ref))
    for a, b in zip(ms, ms_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b).transpose(0, 3, 1, 2),
                                   rtol=0, atol=scale(b))


@pytest.mark.parametrize("modes", [("bilinear", "nearest"), ("bilinear",) * 4])
def test_hybrid_of_the_wrong_length_is_refused(decoder_pair, modes):
    tm, feats, _ = decoder_pair
    with pytest.raises(ValueError, match="3 entries"):
        tm(feats, sample_mode=modes)


def _head_outputs(seed, q=8, k=5, hw=(8, 10)):
    rng = np.random.RandomState(seed)
    cls = rng.randn(2, q, k + 1).astype(np.float32)
    cls[:, 0, 3] = 8.0  # a confident query keeps its extra channel
    cls_ood = rng.randn(2, q, k + 1).astype(np.float32)
    cls_ood[1, 2] = cls_ood[1, 5]  # two queries with equal peaks: the tie rule
    masks = (rng.randn(2, q, *hw) * 3).astype(np.float32)
    masks_ood = (rng.randn(2, q, *hw) * 3).astype(np.float32)
    return {"pred_logits": cls, "pred_masks": masks, "pred_logits_ood": cls_ood,
            "pred_masks_ood": masks_ood}


@pytest.mark.parametrize("tail", [dict(score_lowres=True), dict(score_topq=1),
                                  dict(score_topq=3), dict(score_topq=8)])
@pytest.mark.parametrize("out_hw", [(32, 40), (8, 10)])
def test_inference_tails_match_jax(tail, out_hw):
    """(8, 10) is the identity resize; Q = 8 keeps every query."""
    outs = _head_outputs(6)
    sem, anomaly = maskformer.inference({k: torch.from_numpy(v) for k, v in outs.items()},
                                        out_hw, num_classes=5, **tail)
    sem_ref, anomaly_ref = jax_maskformer.inference(
        {k: jnp.asarray(v) for k, v in outs.items()}, out_hw, num_classes=5, **tail)
    np.testing.assert_allclose(sem.numpy(), np.asarray(sem_ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(anomaly.numpy(), np.asarray(anomaly_ref), rtol=1e-5, atol=1e-6)


def test_top_queries_break_ties_as_jax_top_k():
    peak = np.array([[0.6, 0.9, 0.9, 0.55, 0.9, 0.6]], np.float32)
    # logits whose softmax peak order is that of `peak` (void last, always low)
    logits = np.log(np.stack([peak, 1 - peak, np.full_like(peak, 1e-3)], -1))
    _, idx = scores.top_queries(torch.from_numpy(logits), 4)
    probs = jax.nn.softmax(jnp.asarray(logits), -1)
    _, want = jax.lax.top_k(jnp.max(probs[..., :-1], -1), 4)
    assert idx.tolist() == np.asarray(want).tolist() == [[1, 2, 4, 0]]


def test_both_tails_are_refused():
    """JAX lets score_topq win silently (``maskformer.py:214``); the port raises."""
    outs = {k: torch.from_numpy(v) for k, v in _head_outputs(7).items()}
    with pytest.raises(ValueError, match="exclusive"):
        maskformer.inference(outs, (8, 10), num_classes=5, score_lowres=True, score_topq=3)
    with pytest.raises(ValueError, match="score_topq"):
        maskformer.inference(outs, (8, 10), num_classes=5, score_topq=9)  # > 8 queries


WARP_WIDTHS = chip_smoke.WARP_WIDTHS


@pytest.mark.parametrize("weights", ["random", "equal", "zeros"])
@pytest.mark.parametrize("mode", ["nearest_top6", "nearest_top6c", "nearest_topJc"])
@pytest.mark.parametrize("j", sorted(WARP_WIDTHS))
def test_top_modes_match_jax_at_warp_widths(j, mode, weights):
    """``nearest_top{T}[c]`` at the selection widths the card's kernel lays
    out differently (a head per 16 or per 32 lanes): the port's plain version
    against JAX's, held off the centroids' rounding boundaries as above."""
    shapes, p = WARP_WIDTHS[j]
    mode = mode.replace("J", str(j))
    rng = np.random.RandomState(j)
    s = sum(h * w for h, w in shapes)
    value = rng.randn(N, s, M, D).astype(np.float32)
    loc = rng.rand(N, LQ, M, len(shapes), p, 2).astype(np.float32) * 1.2 - 0.1
    attn = np.full((N, LQ, M, len(shapes), p), 1.0 / j, np.float32)
    if weights != "equal":
        attn = rng.rand(*attn.shape).astype(np.float32)
        if weights == "zeros":
            attn[rng.rand(*attn.shape) < 0.33] = 0.0
            attn[:, 0, 0] = 0.0
        attn /= np.maximum(attn.reshape(N, LQ, M, -1).sum(-1), 1e-6).reshape(N, LQ, M, 1, 1)
    ours, ref = _port(value, loc, attn, shapes, mode), _jax(value, loc, attn, shapes, mode)
    assert ours.shape == ref.shape == (N, LQ, M * D)
    skipped = assert_close_off_boundaries(ours, ref, loc, attn, shapes, mode)
    assert skipped <= N * LQ * M // 10
    assert np.abs(ref).max() > 0.1


@pytest.mark.parametrize("case", ["int8_eval", "int8_train", "int8_16_byte_rows",
                                  "int8_8_byte_rows", "bf16_32_byte_rows", "f32_32_byte_rows"])
def test_staged_levels_sizes_int8_and_32_byte_rows(case):
    """The forward kernel stages rows of the int8 table as it does bf16 and
    f32 ones, sized by their bytes: the eval pyramid's level 0 (2048 rows of
    32 bytes, 64 KB; levels 0-1 would take 320 KB), the training pyramid's
    levels 0-1 (77 KB), all three levels with 16-byte rows, none with rows of
    8 bytes (no whole 16-byte pieces)."""
    shapes, d, dtype, want = {
        "int8_eval": (chip_smoke.LEVELS, 32, torch.int8, 1),
        "int8_train": (chip_smoke.TRAIN_LEVELS, 32, torch.int8, 2),
        "int8_16_byte_rows": (chip_smoke.TRAIN_LEVELS, 16, torch.int8, 3),
        "int8_8_byte_rows": (chip_smoke.TRAIN_LEVELS, 8, torch.int8, 0),
        "bf16_32_byte_rows": (chip_smoke.LEVELS, 16, torch.bfloat16, 1),
        "f32_32_byte_rows": (chip_smoke.TRAIN_LEVELS, 8, torch.float32, 2),
    }[case]
    assert msda.staged_levels(shapes, d, dtype) == want
    # the same bytes a row stage the same levels whatever the type
    assert msda.staged_levels(shapes, d, dtype) == msda.staged_levels(
        shapes, d * torch.empty((), dtype=dtype).element_size(), torch.int8)


@pytest.mark.parametrize("case", ["bilinear_bf16", "int8", "nearest", "f32", "train_bf16",
                                  "off_16_bytes"])
def test_forward_staged_levels_choice(case):
    """The levels a forward launch stages for its table at the eval pyramid:
    level 0 of a bf16 table (128 KB) or of the int8 table (64 KB), none for
    ``nearest`` (one row a point), none for an f32 table (level 0 is 256 KB),
    levels 0-1 at the training pyramid; none for a table that does not start
    on a 16-byte boundary."""
    rng = np.random.RandomState(3)
    levels = chip_smoke.TRAIN_LEVELS if case == "train_bf16" else chip_smoke.LEVELS
    s = sum(h * w for h, w in levels)
    dtype = {"int8": torch.int8, "f32": torch.float32}.get(case, torch.bfloat16)
    table = torch.from_numpy(rng.randint(-9, 9, (1, s, 2, 32)).astype(np.float32)).to(dtype)
    if case == "off_16_bytes":
        table = torch.empty(table.numel() + 1, dtype=dtype)[1:].view(table.shape)
    want = {"bilinear_bf16": 1, "int8": 1, "nearest": 0, "f32": 0, "train_bf16": 2,
            "off_16_bytes": 0}[case]
    assert msda.forward_staged_levels(table, levels, nearest=case == "nearest") == want
