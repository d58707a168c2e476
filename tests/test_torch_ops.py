"""PyTorch port, ops layer: each op against its JAX counterpart on the CPU.

Inputs are made with numpy from a seed and handed to both frameworks. On the CPU
the port's kernel wrappers run their plain versions; the kernels themselves are
held against those plain versions on the card by ``test_torch_kernels.py``.
Tolerances are f32 tolerances unless a test states otherwise.
"""

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from multishiftseg_tpu.evals import ood_metrics as jax_metrics
from multishiftseg_tpu.losses import criterion as jax_criterion
from multishiftseg_tpu.losses import matcher as jax_matcher
from multishiftseg_tpu.losses import rcl as jax_rcl
from multishiftseg_tpu.models import maskformer as jax_maskformer
from multishiftseg_tpu.models.position_encoding import position_embedding_sine as jax_pos
from multishiftseg_tpu.ops import ms_deform_attn as jax_msda
from multishiftseg_tpu.ops import resize as jax_resize
from multishiftseg_tpu.ops import sampling as jax_sampling
from multishiftseg_tpu.ops import scores as jax_scores

from multishiftseg_torch.convert.from_jax import maskformer_from_jax
from multishiftseg_torch.evals import ood_metrics
from multishiftseg_torch.losses import criterion, matcher, rcl
from multishiftseg_torch.models.position_encoding import position_embedding_sine
from multishiftseg_torch.ops import launch_counts
from multishiftseg_torch.ops import ms_deform_attn as msda
from multishiftseg_torch.ops import resize, sampling, scores
from multishiftseg_torch.utils import resolve_device

N, M, D, LQ, P = 2, 4, 8, 7, 3
# (6, 4) and (3, 2) are ordinary levels; (1, 5) and (4, 1) are the degenerate
# h == 1 / w == 1 levels a 32-px input side produces (ms_deform_attn.py:166-172)
LEVEL_SETS = {"regular": [(6, 4), (3, 2)], "degenerate": [(1, 5), (4, 1), (3, 3)]}


def _msda_inputs(rng, shapes, d=D, avoid_ties=False):
    s = sum(h * w for h, w in shapes)
    value = rng.randn(N, s, M, d).astype(np.float32)
    # locations in [-0.1, 1.1]: some points fall outside the map
    loc = rng.rand(N, LQ, M, len(shapes), P, 2).astype(np.float32) * 1.2 - 0.1
    if avoid_ties:
        # keep points 1e-3 px away from the half-pixel rounding boundaries, where
        # grid_sample's round-half-even and floor(x + 0.5) may disagree
        size = np.array([[w, h] for h, w in shapes], np.float32)[None, None, None, :, None, :]
        px = loc * size - 0.5
        frac = px - np.floor(px)
        near = np.abs(frac - 0.5) < 1e-3
        loc = np.where(near, (px + 2e-3 + 0.5) / size, loc).astype(np.float32)
    attn = rng.rand(N, LQ, M, len(shapes), P).astype(np.float32)
    attn /= attn.reshape(N, LQ, M, -1).sum(-1).reshape(N, LQ, M, 1, 1)
    return value, loc, attn


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("size", [(12, 20), (3, 5)])
def test_resize_nhwc_and_nchw_match_jax(rng, align_corners, size):
    x = rng.randn(2, 6, 10, 3).astype(np.float32)
    ours = resize.resize_bilinear(torch.from_numpy(x), size, align_corners).numpy()
    ref = np.asarray(jax_resize.resize_bilinear(jnp.asarray(x), size, align_corners))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)
    xc = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    ours = resize.resize_bilinear_nchw(torch.from_numpy(xc), size, align_corners).numpy()
    ref = np.asarray(jax_resize.resize_bilinear_nchw(jnp.asarray(xc), size, align_corners))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hw", [(2, 4), (7, 5), (16, 32)])
def test_position_encoding_matches_jax(hw):
    # the same numpy formula on both sides: exact
    ours = position_embedding_sine(*hw, 32).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jax_pos(*hw, 32)))


@pytest.mark.parametrize("levels", sorted(LEVEL_SETS))
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_ms_deform_attn_core_matches_jax(rng, levels, mode):
    shapes = LEVEL_SETS[levels]
    value, loc, attn = _msda_inputs(rng, shapes, avoid_ties=mode == "nearest")
    ours = msda.ms_deform_attn_core(torch.from_numpy(value), shapes, torch.from_numpy(loc),
                                    torch.from_numpy(attn), mode).numpy()
    ref = np.asarray(jax_msda.ms_deform_attn_core(
        jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(attn), sample_mode=mode))
    # f32 sums of 12-24 weighted corner reads, taken in another order
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)
    assert np.abs(ref).max() > 0.1  # the points really sample the maps


def test_ms_deform_attn_core_rejects_unported_mode(rng):
    """Every mode of JAX's op is ported; one it does not know is refused."""
    value, loc, attn = _msda_inputs(rng, LEVEL_SETS["regular"])
    with pytest.raises(ValueError, match="unknown sample_mode"):
        msda.ms_deform_attn_core(torch.from_numpy(value), LEVEL_SETS["regular"],
                                 torch.from_numpy(loc), torch.from_numpy(attn), "bicubic")


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


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_ms_deform_attn_module_matches_jax(rng, mode):
    shapes = [(4, 6), (2, 3)]
    s = sum(h * w for h, w in shapes)
    c = 32
    query = rng.randn(1, s, c).astype(np.float32)
    src = rng.randn(1, s, c).astype(np.float32)
    ref_pts = np.broadcast_to(rng.rand(1, s, 1, 2), (1, s, 2, 2)).astype(np.float32)
    jm = jax_msda.MSDeformAttn(d_model=c, n_levels=2, n_heads=4, n_points=3,
                               sample_mode=mode)
    args = (jnp.asarray(query), jnp.asarray(ref_pts), jnp.asarray(src), shapes)
    variables = _perturbed(jm.init(jax.random.PRNGKey(0), *args), 1)
    ref = np.asarray(jm.apply(variables, *args))

    prefix = "sem_seg_head.pixel_decoder.transformer.encoder.layers.0.self_attn."
    sd = maskformer_from_jax(
        {"params": {"pixel_decoder": {"encoder_layer_0": {"self_attn": variables["params"]}}}})
    tm = msda.MSDeformAttn(d_model=c, n_levels=2, n_heads=4, n_points=3)
    tm.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        ours = tm(torch.from_numpy(query), torch.from_numpy(ref_pts), torch.from_numpy(src),
                  shapes, sample_mode=mode).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)


def _class_logits(rng, n=2, q=6, k=5):
    logits = rng.randn(n, q, k + 1).astype(np.float32)
    logits[:, 0, 3] = 8.0  # confident label 3 -> a kept extra channel
    logits[:, 1, 1] = 8.0  # confident but label 1 -> not kept
    return logits


def test_scores_match_jax(rng):
    cls = _class_logits(rng)
    masks = rng.randn(2, 6, 8, 10).astype(np.float32) * 3
    ours = scores.mask2former_semantic_logits(torch.from_numpy(cls), torch.from_numpy(masks))
    ref = jax_scores.mask2former_semantic_logits(jnp.asarray(cls), jnp.asarray(masks))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    ours = scores.mask2former_anomaly_score(torch.from_numpy(cls), torch.from_numpy(masks))
    ref = jax_scores.mask2former_anomaly_score(jnp.asarray(cls), jnp.asarray(masks))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    ours = scores.semantic_inference(torch.from_numpy(cls), torch.from_numpy(masks), 5)
    ref = jax_maskformer.semantic_inference(jnp.asarray(cls), jnp.asarray(masks), 5)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    assert np.abs(np.asarray(ref)[:, 5]).max() > 0  # query 0 is kept
    assert np.abs(np.asarray(ref)[:, 6]).max() == 0  # query 1 is not


@pytest.mark.parametrize("out_hw", [(32, 40), (8, 10)])
def test_upsampled_score_tail_matches_jax_inference(rng, out_hw):
    """The fused tail's CPU path against the JAX eval tail (resize then score);
    (8, 10) is the identity resize."""
    cls = _class_logits(rng)
    cls_ood = _class_logits(rng)
    masks = rng.randn(2, 6, 8, 10).astype(np.float32) * 3
    outputs = {"pred_logits": jnp.asarray(cls), "pred_masks": jnp.asarray(masks),
               "pred_logits_ood": jnp.asarray(cls_ood), "pred_masks_ood": jnp.asarray(masks)}
    sem_ref, anomaly_ref = jax_maskformer.inference(outputs, out_hw, num_classes=5)
    sem = scores.semantic_inference_upsampled(torch.from_numpy(cls), torch.from_numpy(masks),
                                              out_hw, 5)
    anomaly = scores.anomaly_score_upsampled(torch.from_numpy(cls_ood),
                                             torch.from_numpy(masks), out_hw)
    np.testing.assert_allclose(sem.numpy(), np.asarray(sem_ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(anomaly.numpy(), np.asarray(anomaly_ref), rtol=1e-5, atol=1e-6)


def test_ood_metrics_match_jax(rng):
    conf = np.round(rng.rand(4000), 2)  # rounding makes ties
    label = (rng.rand(4000) < 0.2).astype(np.int64)
    label[rng.rand(4000) < 0.05] = 255  # void pixels are excluded
    ours = ood_metrics.eval_ood_measure(conf, label)
    ref = jax_metrics.eval_ood_measure(conf, label, use_native=False)
    np.testing.assert_allclose(ours, ref, rtol=1e-12)
    assert ood_metrics.eval_ood_measure(conf, np.zeros_like(label)) is None


def test_resolve_device_refuses_absent_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_cpu_tensors_do_not_launch_kernels(rng):
    before = launch_counts()
    value, loc, attn = _msda_inputs(rng, LEVEL_SETS["regular"])
    msda.ms_deform_attn_core(torch.from_numpy(value), LEVEL_SETS["regular"],
                             torch.from_numpy(loc), torch.from_numpy(attn))
    # bf16 with 32 channels a head: shapes whose levels the card's kernel stages
    value, loc, attn = _msda_inputs(rng, LEVEL_SETS["regular"], d=32)
    assert msda.staged_levels(LEVEL_SETS["regular"], 32, torch.bfloat16) == 2
    msda.ms_deform_attn_core(torch.from_numpy(value).bfloat16(), LEVEL_SETS["regular"],
                             torch.from_numpy(loc), torch.from_numpy(attn).bfloat16())
    scores.anomaly_score_upsampled(torch.from_numpy(_class_logits(rng)),
                                   torch.randn(2, 6, 4, 5), (8, 10))
    assert launch_counts() == before


# ---------------------------------------------------------------------------
# the training slice's ops


@pytest.mark.parametrize("levels", sorted(LEVEL_SETS))
def test_ms_deform_attn_backward_matches_jax_vjp(rng, levels):
    """The backward's plain version against ``jax.vjp`` of the JAX op (its
    hand-written ``_core_vjp_bwd``). Random points lie off the integer pixel
    positions, where the two differ by design (one-sided slope there, 0 in JAX);
    some lie outside the map; ``degenerate`` has h == 1 and w == 1 levels."""
    shapes = LEVEL_SETS[levels]
    value, loc, attn = _msda_inputs(rng, shapes)
    g = rng.randn(N, LQ, M * D).astype(np.float32)
    _, vjp = jax.vjp(lambda v, lo, a: jax_msda.ms_deform_attn_core(v, shapes, lo, a),
                     jnp.asarray(value), jnp.asarray(loc), jnp.asarray(attn))
    refs = vjp(jnp.asarray(g))
    ours = msda.ms_deform_attn_backward(torch.from_numpy(value), shapes, torch.from_numpy(loc),
                                        torch.from_numpy(attn), torch.from_numpy(g))
    for got, ref in zip(ours, refs):
        ref = np.asarray(ref)
        # f32 sums of a few corner products in another order
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    assert (loc < 0).any() and (loc > 1).any()


@pytest.mark.parametrize("levels", sorted(LEVEL_SETS))
def test_ms_deform_attn_backward_many_points_on_one_pixel_matches_jax_vjp(rng, levels):
    """The oracle of the card's many-points-on-one-corner test: every query's
    points of a level in one pixel cell (fractions 0.3 to 0.7, off the integer
    positions), so each corner's d value sums all of them; the plain version
    against ``jax.vjp`` of the JAX op. f32 sums in another order."""
    shapes = LEVEL_SETS[levels]
    lq = 32
    value = rng.randn(N, sum(h * w for h, w in shapes), M, D).astype(np.float32)
    loc = np.empty((N, lq, M, len(shapes), P, 2), np.float32)
    for lid, (h, w) in enumerate(shapes):
        for axis, size in ((0, w), (1, h)):
            px = size // 2 + 0.3 + 0.4 * rng.rand(N, lq, M, P)
            loc[:, :, :, lid, :, axis] = (px + 0.5) / size
    attn = rng.rand(N, lq, M, len(shapes), P).astype(np.float32)
    g = rng.randn(N, lq, M * D).astype(np.float32)
    _, vjp = jax.vjp(lambda v, lo, a: jax_msda.ms_deform_attn_core(v, shapes, lo, a),
                     jnp.asarray(value), jnp.asarray(loc), jnp.asarray(attn))
    refs = vjp(jnp.asarray(g))
    ours = msda.ms_deform_attn_backward(torch.from_numpy(value), shapes, torch.from_numpy(loc),
                                        torch.from_numpy(attn), torch.from_numpy(g))
    for got, ref in zip(ours, refs):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    # the points of a level touch one cell: at most 4 rows a head and level get d value
    dv = ours[0].numpy().reshape(N, -1, M, D)
    assert ((np.abs(dv).sum(-1) > 0).sum(1) <= 4 * len(shapes)).all()


def test_ms_deform_attn_module_gradients_reach_the_projections(rng):
    """On the CPU the core is the differentiable plain version; every projection
    of the module gets a gradient."""
    shapes = [(4, 6), (2, 3)]
    s = sum(h * w for h, w in shapes)
    tm = msda.MSDeformAttn(d_model=32, n_levels=2, n_heads=4, n_points=3)
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(0.1 * torch.from_numpy(rng.randn(*p.shape).astype(np.float32)))
    q = torch.from_numpy(rng.randn(1, s, 32).astype(np.float32))
    ref = torch.from_numpy(rng.rand(1, s, 2, 2).astype(np.float32))
    tm(q, ref, q, shapes).square().sum().backward()
    for name, p in tm.named_parameters():
        assert float(p.grad.abs().max()) > 0, name


def test_point_sample_matches_jax(rng):
    img = rng.randn(2, 9, 13, 3).astype(np.float32)
    pts = (rng.rand(2, 40, 2) * 1.2 - 0.1).astype(np.float32)  # some points off the map
    ours = sampling.point_sample(torch.from_numpy(img), torch.from_numpy(pts)).numpy()
    ref = np.asarray(jax_sampling.point_sample(jnp.asarray(img), jnp.asarray(pts)))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)
    nchw = sampling.point_sample_nchw(torch.from_numpy(np.ascontiguousarray(
        img.transpose(0, 3, 1, 2))), torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(nchw, ref.transpose(0, 2, 1), rtol=1e-5, atol=1e-6)


def _samples_from_codes(labels, coords, k):
    """The card's sampling from the packed corner codes, in numpy: each
    point's block word of ``label_quads`` (all 255 where no corner is on the
    map), its four codes against each class, the bilinear weights summed in
    JAX's corner order in f32. labels [B, H, W]; coords [B, P, 2] -> [B, K, P]."""
    quads = criterion.label_quads_plain(torch.from_numpy(labels)).numpy().view(np.uint32)
    b, h, w = labels.shape
    x = coords[..., 0] * np.float32(w) - np.float32(0.5)
    y = coords[..., 1] * np.float32(h) - np.float32(0.5)
    x0, y0 = np.floor(x), np.floor(y)
    wx, wy = x - x0, y - y0
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    one = np.float32(1)
    weights = [(one - wx) * (one - wy), wx * (one - wy), (one - wx) * wy, wx * wy]
    inside = (x0 >= -1) & (x0 < w) & (y0 >= -1) & (y0 < h)
    word = np.where(inside, quads[np.arange(b)[:, None], (y0 + 1).clip(0, h),
                                  (x0 + 1).clip(0, w)], np.uint32(0xFFFFFFFF))
    out = np.zeros((b, k, coords.shape[1]), np.float32)
    for q, (dx, dy) in enumerate(((0, 0), (1, 0), (0, 1), (1, 1))):
        on = (x0 + dx >= 0) & (x0 + dx < w) & (y0 + dy >= 0) & (y0 + dy < h)
        wq = np.where(on, weights[q], np.float32(0))
        codes = (word >> np.uint32(8 * q)) & np.uint32(255)
        out += np.where(codes[:, None, :] == np.arange(k)[None, :, None], wq[:, None, :],
                        np.float32(0))
    return out


@pytest.mark.parametrize("entry", ["classes", "rows", "packed_codes"])
def test_label_points_match_jax(rng, entry):
    """Both entries on label maps with ignored ids, void and points off the map:
    every class at each map's points, and one class a row, the rows entry indexing maps by row // K from an
    offset instead of repeating them; and the samples the card takes from
    the packed corner codes (``label_quads``), emulated here."""
    k = 5
    labels = rng.randint(0, 7, (4, 9, 13)).astype(np.int32)
    labels[:, 0] = 255
    coords = (rng.rand(4, 30, 2) * 1.2 - 0.1).astype(np.float32)
    if entry == "classes":
        ours = criterion.sample_target_points(torch.from_numpy(labels),
                                              torch.from_numpy(coords), k)
        ref = jax_criterion.sample_target_points(jnp.asarray(labels), jnp.asarray(coords), k)
    elif entry == "packed_codes":
        labels[1, 2:4] = -1  # ignored pixels, as the instance recipes' id maps hold
        ours = _samples_from_codes(labels, coords, k)
        ref = jax_criterion.sample_target_points(jnp.asarray(labels), jnp.asarray(coords), k)
        np.testing.assert_allclose(ours, np.asarray(ref), rtol=0, atol=1e-6)
        return
    else:
        half = 2
        rows = (rng.rand(half * k, 30, 2) * 1.2 - 0.1).astype(np.float32)
        ids = np.tile(np.arange(k), half).astype(np.int32)
        ours = criterion.sample_class_points(torch.from_numpy(labels), torch.from_numpy(rows),
                                             torch.from_numpy(ids), rows_per_map=k,
                                             map_offset=2)
        ref = jax_criterion.sample_class_points(jnp.repeat(jnp.asarray(labels[2:]), k, axis=0),
                                                jnp.asarray(rows), jnp.asarray(ids))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    assert np.asarray(ref).max() > 0.5


def _costs(rng, b, t=19, q=100, p=64):
    logits = rng.randn(b, q, t + 1).astype(np.float32)
    out_pts = (3 * rng.randn(b, q, p)).astype(np.float32)
    tgt_pts = (rng.rand(b, t, p) > 0.6).astype(np.float32)
    valid = rng.rand(b, t) > 0.5
    valid[:, 0] = True
    return logits, out_pts, tgt_pts, valid


def test_match_costs_and_assignment_match_jax_and_scipy(rng):
    """Costs in f32 against the JAX costs; the assignment (rows = targets, about
    half at BIG) equals the JAX solver's, and on the valid rows it is an optimum
    by scipy."""
    from scipy.optimize import linear_sum_assignment as scipy_lsa

    logits, out_pts, tgt_pts, valid = _costs(rng, 6)
    w = dict(cost_class_w=5.0, cost_mask_w=10.0, cost_dice_w=10.0)
    ours = matcher.compute_match_cost(torch.from_numpy(logits), torch.from_numpy(out_pts),
                                      torch.from_numpy(tgt_pts), torch.from_numpy(valid), **w)
    ref = jax.vmap(lambda a, b, c, d: jax_matcher.compute_match_cost(
        a, b, c, d, w["cost_class_w"], w["cost_mask_w"], w["cost_dice_w"]))(
        jnp.asarray(logits), jnp.asarray(out_pts), jnp.asarray(tgt_pts), jnp.asarray(valid))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    got = matcher.match(torch.from_numpy(logits), torch.from_numpy(out_pts),
                        torch.from_numpy(tgt_pts), torch.from_numpy(valid), **w).numpy()
    want = np.asarray(jax_matcher.match(jnp.asarray(logits), jnp.asarray(out_pts),
                                        jnp.asarray(tgt_pts), jnp.asarray(valid), **w))
    np.testing.assert_array_equal(got, want)
    cost = np.asarray(ref)
    for i in range(len(cost)):
        rows = np.nonzero(valid[i])[0]
        sub = cost[i][:, rows].T  # valid targets x queries
        r, c = scipy_lsa(sub)
        assert sub[np.arange(len(rows)), got[i][rows]].sum() == pytest.approx(
            sub[r, c].sum(), rel=1e-6)


def test_linear_sum_assignment_plain_matches_jax_on_masked_problems(rng):
    """The solver alone on 19 x 100 problems with about half the rows at BIG
    (ties everywhere), the matcher's shape: the same assignment as the JAX
    solver, exactly."""
    cost = rng.rand(40, 19, 100).astype(np.float32)
    cost[rng.rand(40, 19) > 0.5] = jax_matcher.BIG
    ours = matcher.linear_sum_assignment(torch.from_numpy(cost)).numpy()
    ref = np.asarray(jax.vmap(jax_matcher.linear_sum_assignment)(jnp.asarray(cost)))
    np.testing.assert_array_equal(ours, ref)
    assert all(len(set(r)) == 19 for r in ours)


def test_linear_sum_assignment_plain_matches_jax_with_nan_and_inf_costs(rng):
    """Three scattered NaN or +inf entries a problem (never a whole row, on
    which both solvers would search forever), rows at BIG included: the same
    assignment as the JAX solver, exactly."""
    cost = rng.rand(20, 19, 100).astype(np.float32)
    cost[rng.rand(20, 19) > 0.5] = jax_matcher.BIG
    for i in range(len(cost)):
        for j, flat in enumerate(rng.choice(cost[i].size, 3, replace=False)):
            cost[i].flat[flat] = np.nan if j % 2 == 0 else np.inf
    ours = matcher.linear_sum_assignment_plain(torch.from_numpy(cost)).numpy()
    ref = np.asarray(jax.vmap(jax_matcher.linear_sum_assignment)(jnp.asarray(cost)))
    np.testing.assert_array_equal(ours, ref)
    assert all(len(set(r)) == 19 for r in ours)


@pytest.mark.parametrize("shape", [(7, 513), (114, 512), (600, 600)])
def test_assignment_shape_past_the_kernel_limit_raises(shape):
    """The wrapper's limit check, a pure function: the kernel holds at most
    512 columns and 232,448 bytes of shared memory a problem."""
    with pytest.raises(ValueError, match="assignment kernel"):
        matcher.check_assignment_shape(*shape)


@pytest.mark.parametrize("shape", [(19, 100), (100, 100), (113, 512), (1, 512)])
def test_assignment_shape_within_the_kernel_limit_passes(shape):
    """The main path (up to 100 targets by 100 queries) and the largest
    problems the kernel holds pass the check."""
    matcher.check_assignment_shape(*shape)
    assert matcher.assignment_shared_bytes(*shape) <= matcher.LSA_MAX_SHARED_BYTES


def test_assignment_limit_is_checked_before_the_kernel_loads(monkeypatch):
    """A tensor off the CPU past the limit raises before the library loads."""
    from multishiftseg_torch import _build

    def refuse(name):
        raise AssertionError(f"loaded {name}")

    monkeypatch.setattr(_build, "load", refuse)
    before = matcher.LAUNCHES["linear_sum_assignment"]
    with pytest.raises(ValueError, match="at most 512 columns"):
        matcher.linear_sum_assignment(torch.zeros(2, 7, 513, device="meta"))
    assert matcher.LAUNCHES["linear_sum_assignment"] == before


def test_bottom_k_sum_matches_jax(rng):
    vals = np.round(rng.rand(500).astype(np.float32) * 20) / 20  # ties at the threshold
    keyed = np.where(rng.rand(500) > 0.2, vals, np.inf).astype(np.float32)
    for k in (0, 1, 37, 200, 399):
        ours = rcl._bottom_k_sum(torch.from_numpy(vals), torch.from_numpy(keyed),
                                 torch.tensor(k))
        ref = jax_rcl._bottom_k_sum(jnp.asarray(vals), jnp.asarray(keyed), jnp.asarray(k))
        np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6, atol=1e-6)


def test_loss_score_tail_carries_gradients_like_jax(rng):
    """The differentiable score tail of the OOD loss (``criterion.py:455-463``):
    semantic logits at mask resolution, resized to the label map, max over
    classes. Gradients against ``jax.grad``."""
    cls = rng.randn(2, 6, 6).astype(np.float32)
    masks = (3 * rng.randn(2, 6, 8, 10)).astype(np.float32)
    w = rng.randn(2, 24, 30).astype(np.float32)

    def jax_loss(c, m):
        px = jax_resize.resize_bilinear(jax_scores.mask2former_semantic_logits(c, m), (24, 30))
        return jnp.sum(-jnp.max(px, axis=-1) * w)

    gc, gm = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(cls), jnp.asarray(masks))
    c = torch.from_numpy(cls).requires_grad_()
    m = torch.from_numpy(masks).requires_grad_()
    px = resize.resize_bilinear(scores.mask2former_semantic_logits(c, m), (24, 30))
    (-px.max(dim=-1).values * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(gc), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(m.grad.numpy(), np.asarray(gm), rtol=1e-4, atol=1e-5)
