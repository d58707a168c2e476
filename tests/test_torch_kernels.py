"""PyTorch port: the CUDA kernels against their plain PyTorch versions on the card,
and the port's card-only guards.

The kernel tests carry the ``cuda`` marker: they need a CUDA device and skip
without one (``-m cuda`` selects them). The rest run on the CPU. The file imports
neither JAX nor the JAX package, so it also runs where JAX is not installed:
``python -m pytest --noconftest tests/test_torch_kernels.py`` (the suite's
``conftest.py`` imports JAX).
"""

import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke
from multishiftseg_torch import _build
from multishiftseg_torch.evals import ood_metrics
from multishiftseg_torch.losses import criterion, matcher, rcl
from multishiftseg_torch.ops import dilated_conv as dconv
from multishiftseg_torch.ops import ms_deform_attn as msda
from multishiftseg_torch.ops import scores
from multishiftseg_torch.tools import forward_ab

REPO = Path(__file__).resolve().parents[1]

N, M, LQ, P = 2, 4, 7, 3
# (1, 5) and (4, 1) are the degenerate h == 1 / w == 1 levels a 32-px input side
# produces
LEVEL_SETS = {"regular": [(6, 4), (3, 2)], "degenerate": [(1, 5), (4, 1), (3, 3)]}


@pytest.fixture
def cuda():
    """The card, or a skip: decided at run time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels build with nvcc for sm_90a)")
    return torch.device("cuda")


def _msda_inputs(rng, shapes, d):
    s = sum(h * w for h, w in shapes)
    value = rng.randn(N, s, M, d).astype(np.float32)
    # locations in [-0.1, 1.1]: some points fall outside the map
    # (no point is kept off the nearest mode's half-pixel rounding boundaries:
    # kernel and plain version round x * W - 0.5 op by op and take the same
    # pixel there, see test_nearest_kernel_on_pixel_boundaries_equals_plain)
    loc = rng.rand(N, LQ, M, len(shapes), P, 2).astype(np.float32) * 1.2 - 0.1
    attn = rng.rand(N, LQ, M, len(shapes), P).astype(np.float32)
    attn /= attn.reshape(N, LQ, M, -1).sum(-1).reshape(N, LQ, M, 1, 1)
    return value, loc, attn


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 6])  # 16-byte channel groups, single channels
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("levels", sorted(LEVEL_SETS))
def test_ms_deform_attn_kernel_matches_plain(cuda, dtype, mode, levels, d):
    rng = np.random.RandomState(0)
    shapes = LEVEL_SETS[levels]
    value, loc, attn = _msda_inputs(rng, shapes, d)
    v = torch.from_numpy(value).to(cuda, dtype)
    lo = torch.from_numpy(loc).to(cuda)
    a = torch.from_numpy(attn).to(cuda, dtype)
    out = msda.ms_deform_attn_core(v, shapes, lo, a, mode)
    ref = msda.ms_deform_attn_core_plain(v, shapes, lo, a, mode)
    torch.cuda.synchronize()
    # f32: sum order only; bf16: both sides round the f32 sum once to bf16
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("classes", [19, 25])  # sums in 20 or 32 registers
@pytest.mark.parametrize("out_hw", [(64, 80), (16, 20), (37, 45)])
def test_mask_scores_kernel_matches_plain(cuda, out_hw, classes):
    rng = np.random.RandomState(1)
    logits = rng.randn(2, 6, classes + 1).astype(np.float32)
    logits[:, 0, 3] = 8.0  # a confident query keeps its extra channel
    cls = torch.from_numpy(logits).to(cuda)
    masks = torch.from_numpy(rng.randn(2, 6, 16, 20).astype(np.float32) * 3).to(cuda)
    sem = scores.semantic_inference_upsampled(cls, masks, out_hw, classes)
    sem_ref = scores.semantic_inference_upsampled_plain(cls, masks, out_hw, classes)
    anomaly = scores.anomaly_score_upsampled(cls, masks, out_hw)
    anomaly_ref = scores.anomaly_score_upsampled_plain(cls, masks, out_hw)
    torch.cuda.synchronize()
    # f32 throughout; sums over Q taken in another order
    torch.testing.assert_close(sem, sem_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(anomaly, anomaly_ref, rtol=1e-5, atol=1e-5)


# mask-tail shapes of the tiled forward: (N, Q, K, masks hw, output hw)
TAIL_FORWARD_CASES = {
    # 100 queries from staged windows, several tiles a block (the next tile's
    # window copied behind the current one)
    "q100_staged": (2, 100, 19, (64, 128), (256, 512)),
    # a downsample with 130 queries: the window does not fit, taps from global memory
    "q130_downsample_global": (2, 130, 19, (64, 80), (16, 20)),
    "q130_upsample": (1, 130, 19, (20, 24), (80, 96)),
    "ragged_tiles": (2, 100, 19, (10, 12), (37, 45)),  # not a multiple of 8 x 32
    "k1": (2, 12, 1, (16, 20), (64, 80)),
    "k32": (2, 12, 32, (16, 20), (64, 80)),
}


# (masks' h x w, output H x W, row windows): windows off the tiles' 16-row
# grid, one row, the last rows; an upsample (staged) and a downsample (taps
# from global memory)
TAIL_WINDOW_CASES = {"upsample": ((20, 24), (80, 96), [(0, 80), (16, 32), (7, 1), (23, 41),
                                                       (64, 16), (79, 1)]),
                     "downsample": ((48, 40), (24, 20), [(0, 24), (5, 7), (23, 1)])}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TAIL_WINDOW_CASES))
def test_mask_scores_row_window_matches_plain(cuda, case):
    """The forward's output-row window (the row-partitioned eval's slabs), in
    each mode, against the windowed plain version and the whole call's rows
    (1e-5, as the whole call)."""
    hw, out_hw, windows = TAIL_WINDOW_CASES[case]
    rng = np.random.RandomState(37)
    masks = torch.from_numpy(rng.randn(2, 12, *hw).astype(np.float32) * 3).to(cuda)
    probs = torch.softmax(torch.from_numpy(rng.randn(2, 12, 19).astype(np.float32)), -1)
    probs, keep = probs.to(cuda), torch.from_numpy(rng.rand(2, 12).astype(np.float32)).to(cuda)
    for mode in (0, 1, 2):
        k = keep if mode == 1 else None
        whole = torch.ops.mss.mask_scores(masks, probs, k, list(out_hw), mode)
        for row0, rows in windows:
            got = torch.ops.mss.mask_scores(masks, probs, k, list(out_hw), mode, row0, rows)
            plain = scores._tail_plain(masks, probs, k, list(out_hw), mode, row0, rows)
            torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(got, whole[..., row0:row0 + rows, :], rtol=1e-5,
                                       atol=1e-5)
    with pytest.raises(ValueError, match="outside a map"):
        torch.ops.mss.mask_scores(masks, probs, None, list(out_hw), 0, out_hw[0] - 1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TAIL_FORWARD_CASES))
def test_mask_scores_forward_tiles_match_plain(cuda, case):
    """The three forward modes (anomaly, semantic, classes only) of the tiled
    kernel against their plain versions: f32, sums over Q in another order and
    the fast sigmoid (1e-5)."""
    n, q, k, hw, out_hw = TAIL_FORWARD_CASES[case]
    rng = np.random.RandomState(31)
    logits = rng.randn(n, q, k + 1).astype(np.float32)
    logits[:, 0, min(3, k - 1)] = 8.0  # a confident query keeps its extra channel
    cls = torch.from_numpy(logits).to(cuda)
    masks = torch.from_numpy(rng.randn(n, q, *hw).astype(np.float32) * 3).to(cuda)
    got = [scores.anomaly_score_upsampled(cls, masks, out_hw),
           scores.semantic_inference_upsampled(cls, masks, out_hw, k),
           scores.semantic_inference_upsampled(cls, masks, out_hw, k, _classes_only=True)]
    want = [scores.anomaly_score_upsampled_plain(cls, masks, out_hw),
            scores.semantic_inference_upsampled_plain(cls, masks, out_hw, k),
            scores.semantic_inference_upsampled_plain(cls, masks, out_hw, k,
                                                      _classes_only=True)]
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_forward_kernels_alternate_shared_memory_sizes(cuda):
    """One kernel instance launched at a large, then a small, then the large
    shared-memory size again (the score tail at 100 and at 12 queries; the
    bilinear forward staging 128 KB and 1 KB): each launch keeps the room it
    needs, and each result matches its plain version."""
    rng = np.random.RandomState(41)
    for q in (100, 12, 100):
        cls = torch.from_numpy(rng.randn(1, q, 20).astype(np.float32)).to(cuda)
        masks = torch.from_numpy(3 * rng.randn(1, q, 24, 40).astype(np.float32)).to(cuda)
        got = scores.anomaly_score_upsampled(cls, masks, (96, 160))
        want = scores.anomaly_score_upsampled_plain(cls, masks, (96, 160))
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    big, small = [(32, 64), (8, 16)], [(4, 4), (8, 16)]
    for shapes in (big, small, big):
        assert msda.staged_levels(shapes, 32, torch.bfloat16) >= 1
        s = sum(h * w for h, w in shapes)
        v = torch.from_numpy(rng.randn(1, s, 8, 32).astype(np.float32)).to(cuda, torch.bfloat16)
        loc = torch.from_numpy(rng.rand(1, 300, 8, 2, 4, 2).astype(np.float32)).to(cuda)
        a = torch.from_numpy(rng.rand(1, 300, 8, 2, 4).astype(np.float32) / 8).to(
            cuda, torch.bfloat16)
        with torch.no_grad():
            got = msda.ms_deform_attn_core(v, shapes, loc, a)
        want = msda.ms_deform_attn_core_plain(v, shapes, loc, a)
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)


# level sets whose first 2, 1 or 0 levels a block stages (D = 32, bf16 and f32)
STAGING_LEVELS = {2: [(12, 16), (24, 32), (96, 128)], 1: [(24, 32), (96, 128), (12, 16)],
                  0: [(96, 128), (24, 32), (12, 16)]}


def _edge_points(rng, loc, shapes):
    """Put a third of the points where a staged level's rows end: on the last
    pixel of a level, and between it and the map's right or bottom edge (one
    corner in the map, one outside)."""
    n, lq, m, L, p, _ = loc.shape
    pick = rng.rand(n, lq, m, L, p) < 1 / 3
    for lid, (h, w) in enumerate(shapes):
        size = np.array([w, h], np.float32)
        edge = 1 - (0.1 + 0.6 * rng.rand(n, lq, m, p, 2).astype(np.float32)) / size
        loc[:, :, :, lid] = np.where(pick[:, :, :, lid, :, None], edge, loc[:, :, :, lid])
    return loc


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 6])  # 16-byte channel groups (staged), single channels
@pytest.mark.parametrize("staged", sorted(STAGING_LEVELS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bilinear_forward_staging_matches_plain(cuda, dtype, staged, d):
    """The bilinear forward with 0, 1 or 2 levels staged in shared memory,
    against the plain version: 2 images (blocks of one image must not read
    another's table), points outside the maps and on the staged levels' last
    rows; several query passes a block. f32: sum order; bf16: both sides round
    the f32 sum once."""
    shapes = STAGING_LEVELS[staged]
    assert msda.staged_levels(shapes, d, dtype) == (staged if d == 32 else 0)
    rng = np.random.RandomState(7 + staged)
    n, lq, m, p = 2, 1500, 4, 3
    s = sum(h * w for h, w in shapes)
    value = rng.randn(n, s, m, d).astype(np.float32)
    loc = rng.rand(n, lq, m, len(shapes), p, 2).astype(np.float32) * 1.2 - 0.1
    loc = _edge_points(rng, loc, shapes)
    attn = rng.rand(n, lq, m, len(shapes), p).astype(np.float32)
    attn /= attn.reshape(n, lq, m, -1).sum(-1).reshape(n, lq, m, 1, 1)
    v = torch.from_numpy(value).to(cuda, dtype)
    lo = torch.from_numpy(loc).to(cuda)
    a = torch.from_numpy(attn).to(cuda, dtype)
    before = msda.LAUNCHES["ms_deform_attn_bilinear"]
    with torch.no_grad():
        out = msda.ms_deform_attn_core(v, shapes, lo, a)
    ref = msda.ms_deform_attn_core_plain(v, shapes, lo, a)
    torch.cuda.synchronize()
    assert msda.LAUNCHES["ms_deform_attn_bilinear"] == before + 1
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


def _staging_case(rng, shapes, d, n=2, lq=1500, m=4, p=3):
    """value, locations (a third on the levels' last rows, see _edge_points)
    and weights summing to 1 a head."""
    s = sum(h * w for h, w in shapes)
    value = rng.randn(n, s, m, d).astype(np.float32)
    loc = rng.rand(n, lq, m, len(shapes), p, 2).astype(np.float32) * 1.2 - 0.1
    loc = _edge_points(rng, loc, shapes)
    attn = rng.rand(n, lq, m, len(shapes), p).astype(np.float32)
    attn /= attn.reshape(n, lq, m, -1).sum(-1).reshape(n, lq, m, 1, 1)
    return value, loc, attn


@pytest.mark.cuda
@pytest.mark.parametrize("mode_d", [("nearest", 32), ("nearest", 6), ("int8", 32),
                                    ("int8", 6), ("int8", 256)])
@pytest.mark.parametrize("staged", sorted(STAGING_LEVELS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nearest_and_int8_forward_staging_match_plain(cuda, dtype, staged, mode_d):
    """The head-major forward of ``nearest`` and of the int8 table at level
    sets whose first 2, 1 or 0 levels fit in shared memory, against the plain
    versions: 2 images, points outside the maps and on the levels' last rows,
    several query passes a block; D = 6 reads single channels, D = 256 in f32
    takes two channel passes. The wrapper stages those levels of the int8
    table (at most level 0 of its 256-byte rows at D = 256, none at D = 6)
    and none for ``nearest``. f32: sum order (and the int8 scale taken once a
    channel sum); bf16: both sides round the f32 sum once."""
    mode, d = mode_d
    shapes = STAGING_LEVELS[staged]
    rng = np.random.RandomState(40 + staged + d)
    value, loc, attn = _staging_case(rng, shapes, d)
    v = torch.from_numpy(value).to(cuda, dtype)
    lo = torch.from_numpy(loc).to(cuda)
    a = torch.from_numpy(attn).to(cuda, dtype)
    if mode == "int8":
        q, scale = msda.quantize_value_table(v)
        run = lambda: msda._ms_deform_attn_int8_cuda(q, scale, shapes, lo, a)
        ref = msda._bilinear_int8_plain(q, scale, shapes, lo, a)
        table, counter = q, "ms_deform_attn_int8"
        want = {32: staged, 6: 0, 256: min(staged, 1)}[d]
    else:
        run = lambda: msda._ms_deform_attn_cuda(v, shapes, lo, a, "nearest")
        ref = msda.ms_deform_attn_core_plain(v, shapes, lo, a, "nearest")
        table, counter, want = v, "ms_deform_attn_nearest", 0
    assert msda.forward_staged_levels(table, shapes, mode == "nearest") == want
    before = msda.LAUNCHES[counter]
    out = run()
    torch.cuda.synchronize()
    assert msda.LAUNCHES[counter] == before + 1
    assert out.dtype == dtype and out.shape == ref.shape
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [130, 160, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bilinear_forward_wide_heads_match_plain(cuda, dtype, d):
    """Heads wider than one pass of a query's threads covers (32 groups of 16
    bytes, or 128 single channels) take more channel passes: 130 channels
    (single channels, two passes), 160 and 256 (two passes in f32, one in
    bf16), level 0 staged where the rows are 16-byte pieces; against the
    plain version."""
    shapes = [(12, 16), (24, 32), (48, 64)]
    assert msda.staged_levels(shapes, d, dtype) == (0 if d == 130 else 1)
    rng = np.random.RandomState(d)
    n, lq, m, p = 2, 600, 2, 3
    s = sum(h * w for h, w in shapes)
    loc = rng.rand(n, lq, m, len(shapes), p, 2).astype(np.float32) * 1.2 - 0.1
    loc = _edge_points(rng, loc, shapes)
    attn = rng.rand(n, lq, m, len(shapes), p).astype(np.float32) / (len(shapes) * p)
    v = torch.from_numpy(rng.randn(n, s, m, d).astype(np.float32)).to(cuda, dtype)
    lo = torch.from_numpy(loc).to(cuda)
    a = torch.from_numpy(attn).to(cuda, dtype)
    before = msda.LAUNCHES["ms_deform_attn_bilinear"]
    with torch.no_grad():
        out = msda.ms_deform_attn_core(v, shapes, lo, a)
    ref = msda.ms_deform_attn_core_plain(v, shapes, lo, a)
    torch.cuda.synchronize()
    assert msda.LAUNCHES["ms_deform_attn_bilinear"] == before + 1
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("levels", ["regular", "degenerate", "main_path"])
def test_nearest_kernel_on_pixel_boundaries_equals_plain(cuda, dtype, levels):
    """Points exactly on pixel boundaries (x = j / W_l, y = j / H_l for every
    level): ``x * W - 0.5`` is then a half-pixel tie whose last bit picks the
    pixel, so the kernel must round the product before the subtraction, as the
    plain version and JAX do. Small integer values and weights of 1/16 make
    every sum exact in any order, so the outputs are equal bit for bit exactly
    when every point took the same pixel."""
    shapes = [(32, 64), (64, 128), (128, 256)] if levels == "main_path" else LEVEL_SETS[levels]
    rng = np.random.RandomState(30)
    lq, n_lev = 512, len(shapes)
    value = rng.randint(-8, 9, (1, sum(h * w for h, w in shapes), M, 8)).astype(np.float32)
    loc = np.empty((1, lq, M, n_lev, P, 2), np.float32)
    for lid, (h, w) in enumerate(shapes):
        for axis, size in ((0, w), (1, h)):
            j = rng.randint(0, size + 1, loc.shape[:3] + (P,)).astype(np.float32)
            loc[:, :, :, lid, :, axis] = j / np.float32(size)
    attn = np.full((1, lq, M, n_lev, P), 1 / 16, np.float32)
    v = torch.from_numpy(value).to(cuda, dtype)
    lo = torch.from_numpy(loc).to(cuda)
    a = torch.from_numpy(attn).to(cuda, dtype)
    before = msda.LAUNCHES["ms_deform_attn_nearest"]
    out = msda.ms_deform_attn_core(v, shapes, lo, a, "nearest")
    ref = msda.ms_deform_attn_core_plain(v, shapes, lo, a, "nearest")
    torch.cuda.synchronize()
    assert msda.LAUNCHES["ms_deform_attn_nearest"] == before + 1
    assert float(ref.float().abs().max()) > 0
    assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_backward_on_the_card_is_the_exact_one(cuda, dtype):
    """Under grad the int8 table's forward runs the quantize and int8 kernels
    and its backward the bilinear backward kernel on the saved exact value:
    the gradients equal ``ms_deform_attn_backward`` on the same inputs. d value
    sums by atomics in a run-dependent order: f32 1e-5 of scale; bf16 one
    rounding of that sum, 1e-2."""
    rng = np.random.RandomState(31)
    shapes = LEVEL_SETS["regular"]
    value, loc, attn = _msda_inputs(rng, shapes, 32)
    g = torch.from_numpy(rng.randn(N, LQ, M * 32).astype(np.float32)).to(cuda, dtype)
    v, lo, a = (torch.from_numpy(t).to(cuda) for t in (value, loc, attn))
    v, a = v.to(dtype).requires_grad_(), a.to(dtype).requires_grad_()
    lo.requires_grad_()
    before = dict(msda.LAUNCHES)
    msda.ms_deform_attn_core(v, shapes, lo, a, quantize_table=True).backward(g)
    want = msda.ms_deform_attn_backward(v.detach(), shapes, lo.detach(), a.detach(), g)
    torch.cuda.synchronize()
    for name, more in (("ms_deform_attn_quantize", 1), ("ms_deform_attn_int8", 1),
                       ("ms_deform_attn_bilinear_backward", 2), ("ms_deform_attn_bilinear", 0)):
        assert msda.LAUNCHES[name] == before[name] + more, name
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for got, ref in zip((v.grad, lo.grad, a.grad), want):
        assert got.dtype == ref.dtype
        torch.testing.assert_close(got.float(), ref.float(), rtol=tol,
                                   atol=tol * float(ref.float().abs().max()))


def _off_kinks(loc, shapes, margin=1e-3):
    """Move points ``margin`` px away from integer pixel positions, where the
    backward's location slope is one-sided and the two versions may take other
    sides after rounding."""
    size = np.array([[w, h] for h, w in shapes], np.float32)[None, None, None, :, None, :]
    px = loc * size - 0.5
    near = np.abs(px - np.round(px)) < margin
    return np.where(near, (px + 2 * margin + 0.5) / size, loc).astype(np.float32)


def _one_cell_locations(rng, shapes, lq):
    """Every query's points of a level inside one pixel cell (fractions 0.3 to
    0.7, off the integer positions), so that they all share its four corners;
    on an h == 1 or w == 1 level two of them lie outside the map."""
    loc = np.empty((N, lq, M, len(shapes), P, 2), np.float32)
    for lid, (h, w) in enumerate(shapes):
        for axis, size in ((0, w), (1, h)):
            px = size // 2 + 0.3 + 0.4 * rng.rand(N, lq, M, P)
            loc[:, :, :, lid, :, axis] = (px + 0.5) / size
    return loc


@pytest.mark.cuda
@pytest.mark.parametrize("points", ["random", "one_cell"])
@pytest.mark.parametrize("d", [32, 6, 40])  # 4-channel groups; single channels; 10 groups of 16
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("levels", sorted(LEVEL_SETS))
def test_ms_deform_attn_backward_kernel_matches_plain(cuda, dtype, levels, d, points):
    """``one_cell``: 512 queries put all their points of a level in one pixel
    cell, so each head's d value row at those corners takes 1536 atomic adds
    from many thread groups at once."""
    rng = np.random.RandomState(2)
    shapes = LEVEL_SETS[levels]
    if points == "random":
        lq = LQ
        value, loc, attn = _msda_inputs(rng, shapes, d)
        loc = _off_kinks(loc, shapes)
    else:
        lq = 512
        value = rng.randn(N, sum(h * w for h, w in shapes), M, d).astype(np.float32)
        loc = _one_cell_locations(rng, shapes, lq)
        attn = rng.rand(N, lq, M, len(shapes), P).astype(np.float32)
    g = rng.randn(N, lq, M * d).astype(np.float32)
    v = torch.from_numpy(value).to(cuda, dtype)
    lo = torch.from_numpy(loc).to(cuda)
    a = torch.from_numpy(attn).to(cuda, dtype)
    gt = torch.from_numpy(g).to(cuda, dtype)
    got = msda.ms_deform_attn_backward(v, shapes, lo, a, gt)
    want = msda.ms_deform_attn_backward_plain(v, shapes, lo, a, gt)
    torch.cuda.synchronize()
    assert [t.dtype for t in got] == [dtype, torch.float32, dtype]
    # f32: sums (atomics in d value) in another order; bf16: both round the f32
    # result once, one bf16 step (2^-8) of the largest entry
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for x, y in zip(got, want):
        scale = float(y.float().abs().max())
        torch.testing.assert_close(x.float(), y.float(), rtol=tol, atol=tol * scale)


@pytest.mark.cuda
def test_ms_deform_attn_autograd_on_the_card(cuda):
    """A loss through the module on the card reaches every projection (the
    kernel pair under the autograd Function), as the CPU's plain version does."""
    rng = np.random.RandomState(3)
    shapes = [(4, 6), (2, 3)]
    s = sum(h * w for h, w in shapes)
    torch.manual_seed(0)
    cpu = msda.MSDeformAttn(d_model=32, n_levels=2, n_heads=4, n_points=3)
    with torch.no_grad():
        for p in cpu.parameters():
            p.add_(0.1 * torch.from_numpy(rng.randn(*p.shape).astype(np.float32)))
    gpu = msda.MSDeformAttn(d_model=32, n_levels=2, n_heads=4, n_points=3).to(cuda)
    gpu.load_state_dict(cpu.state_dict())
    q = rng.randn(1, s, 32).astype(np.float32)
    ref = rng.rand(1, s, 2, 2).astype(np.float32)
    before = msda.LAUNCHES["ms_deform_attn_bilinear_backward"]
    for mod, dev in ((cpu, "cpu"), (gpu, cuda)):
        x = torch.from_numpy(q).to(dev)
        mod(x, torch.from_numpy(ref).to(dev), x, shapes).square().sum().backward()
    torch.cuda.synchronize()
    assert msda.LAUNCHES["ms_deform_attn_bilinear_backward"] == before + 1
    # f32 on both sides (TF32 off for the projections), sums in another order
    for (name, pc), (_, pg) in zip(cpu.named_parameters(), gpu.named_parameters()):
        assert float(pg.grad.abs().max()) > 0, name
        torch.testing.assert_close(pg.grad.cpu(), pc.grad, rtol=1e-4, atol=1e-4 * float(
            pc.grad.abs().max()))


# (2, 113, 512): the most columns and, at them, the most rows the kernel
# holds (232,344 bytes of shared memory a problem)
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 19, 100), (3, 5, 8), (2, 1, 1), (2, 7, 300),
                                   (2, 113, 512)])
def test_assignment_kernel_matches_plain(cuda, shape):
    """Rows at BIG (ties everywhere) included; the same assignment exactly."""
    rng = np.random.RandomState(4)
    cost = rng.rand(*shape).astype(np.float32)
    cost[rng.rand(*shape[:2]) > 0.5] = matcher.BIG
    c = torch.from_numpy(cost).to(cuda)
    got = matcher.linear_sum_assignment(c)
    want = matcher.linear_sum_assignment_plain(c)
    torch.cuda.synchronize()
    assert got.dtype == torch.int64
    assert torch.equal(got.cpu(), want.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 19, 100), (3, 5, 8), (2, 7, 300)])
def test_assignment_kernel_with_nan_and_inf_costs_matches_plain(cuda, shape):
    """Three scattered NaN or +inf entries a problem (never a whole row): a
    NaN never wins a step; the same assignment as the plain version."""
    rng = np.random.RandomState(41)
    b, r, c = shape
    cost = rng.rand(*shape).astype(np.float32)
    cost[rng.rand(b, r) > 0.5] = matcher.BIG
    for i in range(b):
        for j, flat in enumerate(rng.choice(r * c, 3, replace=False)):
            cost[i].flat[flat] = np.nan if j % 2 == 0 else np.inf
    ct = torch.from_numpy(cost).to(cuda)
    got = matcher.linear_sum_assignment(ct)
    want = matcher.linear_sum_assignment_plain(ct)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 7, 513), (2, 114, 512)])
def test_assignment_past_its_limit_raises_before_launch(cuda, shape):
    """One column past 512, or one row past the shared memory a problem may
    take: ValueError, and no launch."""
    before = matcher.LAUNCHES["linear_sum_assignment"]
    with pytest.raises(ValueError, match="assignment kernel"):
        matcher.linear_sum_assignment(torch.zeros(shape, device=cuda))
    assert matcher.LAUNCHES["linear_sum_assignment"] == before


def _launches(fn, calls=10):
    """(launch calls, device kernel names) of ``calls`` warm calls of ``fn`` in
    one profile between host pauses. The launch calls are the host's runtime
    records (``chip_smoke.launch_calls``): the card's profiler was seen to
    drop device events from windows this short, not these."""
    import time

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.25)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.25)
    return chip_smoke.launch_calls(prof), [
        e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)]


@pytest.mark.cuda
def test_assignment_is_one_kernel(cuda):
    """One assignment call at the stage-2 shapes runs exactly one kernel (it
    writes the int64 result itself)."""
    cost = torch.rand(16, 19, 100, device=cuda)
    launches, kernels = _launches(lambda: matcher.linear_sum_assignment(cost))
    assert launches == 10 and all("lsa_warp_kernel" in k for k in kernels), (launches, kernels)


@pytest.mark.cuda
def test_label_points_kernel_matches_plain(cuda):
    rng = np.random.RandomState(5)
    k = 19
    labels = rng.randint(0, 22, (4, 37, 45)).astype(np.int32)
    labels[:, :3] = 255
    lab = torch.from_numpy(labels).to(cuda)
    coords = torch.from_numpy((rng.rand(4, 300, 2) * 1.2 - 0.1).astype(np.float32)).to(cuda)
    got = criterion.sample_target_points(lab, coords, k)
    want = criterion.sample_target_points_plain(lab, coords, k)
    rows = torch.from_numpy((rng.rand(2 * k, 300, 2) * 1.2 - 0.1).astype(np.float32)).to(cuda)
    ids = torch.arange(k, device=cuda).repeat(2)
    got_r = criterion.sample_class_points(lab, rows, ids, rows_per_map=k, map_offset=2)
    want_r = criterion.sample_class_points_plain(lab, rows, ids, rows_per_map=k, map_offset=2)
    torch.cuda.synchronize()
    # a sum of at most four corner weights in f32, in another order
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    torch.testing.assert_close(got_r, want_r, rtol=0, atol=1e-6)


def _misaligned(x):
    """A contiguous copy of ``x`` that starts 8 bytes into a 16-byte word."""
    buf = torch.empty(x.numel() + 2, dtype=x.dtype, device=x.device)
    out = buf[2:].view(x.shape)
    out.copy_(x)
    assert out.data_ptr() % 16 == 8
    return out


# P below a block's 256 points (1, 7) or past it (302, 304: a block's points
# span rows and maps); coordinates 16-byte aligned or not
@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("p", [1, 7, 302, 304])
def test_label_points_edges_match_plain(cuda, p, aligned):
    """Both entries at coordinates exactly 0 and 1, on pixel centres and edges
    and off the map, on maps with -1 and 255 labels (a class no row asks
    for), against the plain versions; the rows entry's points run across
    rows and maps in one thread."""
    rng = np.random.RandomState(p + 10 * aligned)
    k, b, h, w = 7, 3, 11, 13
    labels = rng.randint(-1, k + 1, (b, h, w)).astype(np.int32)
    labels[:, :, :2] = 255
    labels[:, 0] = -1
    lab = torch.from_numpy(labels).to(cuda)
    edges = np.array([0.0, 1.0, -0.25, 1.25, 0.5 / w, 1 - 0.5 / w, 2.0 / w, 0.5], np.float32)

    def coords(rows):
        c = (rng.rand(rows * p, 2) * 1.4 - 0.2).astype(np.float32)
        grid = np.stack(np.meshgrid(edges, edges), -1).reshape(-1, 2)[:len(c)]
        c[:len(grid)] = grid
        t = torch.from_numpy(c.reshape(rows, p, 2)).to(cuda)
        return t if aligned else _misaligned(t)

    xy = coords(b)
    got = criterion.sample_target_points(lab, xy, k)
    want = criterion.sample_target_points_plain(lab, xy, k)
    rows = coords(2 * k)
    ids = torch.arange(k, device=cuda).repeat(2)
    got_r = criterion.sample_class_points(lab, rows, ids, rows_per_map=k, map_offset=1)
    want_r = criterion.sample_class_points_plain(lab, rows, ids, rows_per_map=k, map_offset=1)
    torch.cuda.synchronize()
    # a sum of at most four corner weights in f32, in another order
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    torch.testing.assert_close(got_r, want_r, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_label_points_outside_the_codes_match_plain(cuda):
    """Classes the packed codes cannot hold (255 and above, below 0) read the
    labels themselves: the classes entry with 260 classes, the rows entry
    with class ids -1, 255 and 300, on maps that hold those labels."""
    rng = np.random.RandomState(12)
    labels = rng.choice([-1, 0, 3, 254, 255, 259, 300], (2, 9, 14)).astype(np.int32)
    lab = torch.from_numpy(labels).to(cuda)
    xy = torch.from_numpy((rng.rand(2, 64, 2) * 1.2 - 0.1).astype(np.float32)).to(cuda)
    got = criterion.sample_target_points(lab, xy, 260)
    want = criterion.sample_target_points_plain(lab, xy, 260)
    ids = torch.tensor([-1, 255, 300, 3, 254, 259], device=cuda)
    rows = torch.from_numpy((rng.rand(6, 64, 2) * 1.2 - 0.1).astype(np.float32)).to(cuda)
    got_r = criterion.sample_class_points(lab, rows, ids, rows_per_map=3)
    want_r = criterion.sample_class_points_plain(lab, rows, ids, rows_per_map=3)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    torch.testing.assert_close(got_r, want_r, rtol=0, atol=1e-6)
    assert float(want[:, 259].max()) > 0.5
    assert all(float(want_r[i].max()) > 0.5 for i in range(6))


# (maps, height, width): odd widths (rows of codes padded to a multiple of 4),
# a one-row map, the stage-2 maps
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 11, 13), (2, 1, 7), (1, 5, 1), (16, 704, 704)])
def test_label_quads_match_plain(cuda, shape):
    """The pack writes the plain version's words bit for bit: every label in
    [0, 254] its own code, -1, 255 and above 255, and corners off the map,
    255."""
    rng = np.random.RandomState(13)
    labels = rng.choice([-1, 0, 1, 18, 200, 254, 255, 999], shape).astype(np.int32)
    lab = torch.from_numpy(labels).to(cuda)
    got = criterion.label_quads(lab)
    want = criterion.label_quads_plain(lab)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.cuda
def test_label_points_instance_slots_match_plain(cuda):
    """The instance criterion's shapes: segment id maps of 8 unpadded 700x700
    crops with -1 (ignore) pixels, T = 48 slots, 12544 points; the match's
    targets (every slot at every point) and the mask losses' rows (each
    (image, slot) pair on its own points)."""
    rng = np.random.RandomState(6)
    b, t, p = 8, 48, 12544
    ids = np.repeat(np.repeat(rng.randint(-1, t, (b, 44, 44)), 16, 1), 16, 2)[:, :700, :700]
    lab = torch.from_numpy(ids.astype(np.int32)).to(cuda)
    coords = torch.from_numpy(rng.rand(b, p, 2).astype(np.float32)).to(cuda)
    got = criterion.sample_target_points(lab, coords, t)
    want = criterion.sample_target_points_plain(lab, coords, t)
    rows = torch.from_numpy((rng.rand(b * t, p, 2) * 1.2 - 0.1).astype(np.float32)).to(cuda)
    slots = torch.arange(t, device=cuda).repeat(b)
    got_r = criterion.sample_class_points(lab, rows, slots, rows_per_map=t)
    want_r = criterion.sample_class_points_plain(lab, rows, slots, rows_per_map=t)
    torch.cuda.synchronize()
    # a sum of at most four corner weights in f32, in another order
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    torch.testing.assert_close(got_r, want_r, rtol=0, atol=1e-6)
    assert float(got.sum(1).max()) <= 1 + 1e-6 and float(got.sum(1).min()) == 0.0  # -1 pixels


@pytest.mark.cuda
def test_assignment_instance_shape_matches_plain(cuda):
    """The instance match: 8 problems of 48 target slots x 100 queries, costs
    from ``compute_match_cost`` with duplicate classes and -1 padding slots
    (rows at BIG), made once on the CPU and solved by the kernel and the plain
    version: the same assignment."""
    rng = np.random.RandomState(7)
    b, q, t, k, p = 8, 100, 48, 8, 256
    matcher.check_assignment_shape(t, q)
    classes = torch.from_numpy(rng.randint(0, k, (b, t)))
    for i in range(b):
        classes[i, 10 + 4 * i:] = -1  # 10..38 valid slots
    cost = matcher.compute_match_cost(
        torch.from_numpy(rng.randn(b, q, k + 1).astype(np.float32)),
        torch.from_numpy(3 * rng.randn(b, q, p).astype(np.float32)),
        torch.from_numpy((rng.rand(b, t, p) > 0.7).astype(np.float32)), classes >= 0,
        2.0, 5.0, 5.0, tgt_classes=classes).transpose(1, 2).contiguous()
    got = matcher.linear_sum_assignment(cost.to(cuda))
    want = matcher.linear_sum_assignment_plain(cost)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


# (N, H, W, Cin, Cout, rate): maps smaller and larger than the rate, H < rate <
# W, odd sizes, channel counts off the 8 / 64 / 128 / 256 tiles, taps wholly
# outside; the training map's width (88, not a multiple of the forward's 16-px
# tile columns) with Cin over four 64-channel blocks, the last partial; Cout
# above 256 and not a multiple of 8 (two 256-wide column tiles in the forward)
DCONV_CASES = [(2, 9, 30, 40, 24, 12), (1, 5, 7, 16, 8, 12), (2, 13, 29, 20, 5, 24),
               (1, 40, 70, 136, 136, 12), (3, 20, 20, 8, 16, 36), (1, 33, 17, 264, 256, 24),
               (2, 20, 88, 200, 48, 12), (1, 19, 37, 72, 300, 24)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DCONV_CASES)
def test_dilated_conv_kernels_match_plain(cuda, dtype, case):
    """Forward, weight gradient and input gradient (the forward kernel on the
    flipped, transposed weight) against the plain version's autograd."""
    torch.backends.cuda.matmul.allow_tf32 = False
    n, h, w, cin, cout, rate = case
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(n, h, w, cin).astype(np.float32)).to(cuda, dtype)
    k = torch.from_numpy(rng.randn(3, 3, cin, cout).astype(np.float32) / 30).to(cuda)
    g = torch.from_numpy(rng.randn(n, h, w, cout).astype(np.float32)).to(cuda, dtype)
    runs = []
    for fn in (dconv.dilated_conv3x3, dconv.dilated_conv3x3_plain):
        xi, ki = x.clone().requires_grad_(), k.clone().requires_grad_()
        out = fn(xi, ki, rate)
        out.backward(g)
        runs.append((out.detach(), xi.grad, ki.grad))
    torch.cuda.synchronize()
    assert runs[0][0].dtype == dtype and runs[0][2].dtype == torch.float32
    # the output's absolute scale: sum |x| |W| over the in-map taps
    scale = float(dconv.dilated_conv3x3_plain(x.abs().float(), k.abs(), rate).max())
    for got, want in zip(runs[0], runs[1]):
        ref = float(want.float().abs().max())
        if dtype == torch.float32:  # f32 sums in another order
            torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * max(scale, ref))
        else:  # both round one f32 sum to bf16 (the weight gradient: the plain one)
            torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                                       atol=1e-4 * ref)


@pytest.mark.cuda
def test_dilated_conv_skips_input_gradient_unless_asked(cuda):
    x = torch.randn(2, 16, 24, 32, device=cuda, dtype=torch.bfloat16)
    k = torch.randn(3, 3, 32, 16, device=cuda, requires_grad=True)
    before = dict(dconv.LAUNCHES)
    dconv.dilated_conv3x3(x, k, 12).float().sum().backward()
    assert dconv.LAUNCHES["dilated_conv3x3"] == before["dilated_conv3x3"] + 1
    assert dconv.LAUNCHES["dilated_conv3x3_wgrad"] == before["dilated_conv3x3_wgrad"] + 1
    assert k.grad is not None and float(k.grad.abs().max()) > 0


# "large": the main path's order of size; "beyond_stage": more keys than the
# kernel stages in shared memory on an H100 (about 7.3 M), the rest read from
# global memory in every pass; "beyond_valid": count < k <= n, the threshold
# at +inf; "beyond_n": k > n, threshold 0xFFFFFFFF
BOTTOM_K_CASES = ["ties", "zero", "one", "all", "large", "beyond_stage", "beyond_valid",
                  "beyond_n"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", BOTTOM_K_CASES)
def test_bottom_k_kernel_matches_plain(cuda, case):
    """The radix select finds the binary search's threshold bit for bit; the
    sum within f32 rounding; the gradient weights exactly."""
    rng = np.random.RandomState(7)
    n = {"large": 3_000_017, "beyond_stage": 9_000_011}.get(case, 5003)
    vals = (np.floor(rng.rand(n) * 64) / 16).astype(np.float32)  # many ties
    if case in ("large", "beyond_stage"):
        vals = rng.gamma(1.0, 2.0, n).astype(np.float32)
    valid = rng.rand(n) > 0.2
    keyed = np.where(valid, vals, np.inf).astype(np.float32)
    count = int(valid.sum())
    k = {"ties": int(0.8 * count), "zero": 0, "one": 1, "all": count,
         "large": int(0.8 * count), "beyond_stage": int(0.8 * count),
         "beyond_valid": (count + n) // 2, "beyond_n": n + 3}[case]
    if case == "beyond_stage":
        assert rcl.staged_fraction(n, cuda) < 1.0
    sn = torch.tensor(k, dtype=torch.int32, device=cuda)
    kt = torch.from_numpy(keyed).to(cuda)
    sums, grads = [], []
    for fn in (rcl._bottom_k_sum, rcl.bottom_k_sum_plain):
        v = torch.from_numpy(vals).to(cuda).requires_grad_()
        out = fn(v, kt, sn)
        out.backward(torch.tensor(1.5, device=cuda))
        sums.append(float(out.detach()))
        grads.append(v.grad)
    _, threshold, result = rcl.bottom_k_sum_cuda(torch.from_numpy(vals).to(cuda), kt, sn)
    torch.cuda.synchronize()
    bits = np.sort(keyed.view(np.uint32))
    want_t = 0 if k <= 0 else (0xFFFFFFFF if k > n else int(bits[k - 1]))
    assert int(threshold.item()) & 0xFFFFFFFF == want_t
    assert float(result[0]) == sums[0]
    np.testing.assert_allclose(sums[0], sums[1], rtol=1e-6, atol=1e-6)
    assert torch.equal(grads[0], grads[1])


@pytest.mark.cuda
def test_bottom_k_is_one_kernel(cuda):
    """A forward call at the main-path shapes (8 x 700 x 700) runs exactly one
    kernel: no fill, no second pass, no copy of the result."""
    g = torch.Generator(device=cuda).manual_seed(42)
    n = 8 * 700 * 700
    vals = -torch.rand(n, generator=g, device=cuda).log() * 2
    keyed = torch.where(torch.rand(n, generator=g, device=cuda) > 0.2, vals,
                        torch.full_like(vals, float("inf")))
    sn = (0.8 * torch.isfinite(keyed).sum()).to(torch.int32)
    launches, kernels = _launches(lambda: rcl._bottom_k_sum(vals, keyed, sn))
    assert launches == 10 and all("bk_select_sum" in k for k in kernels), (launches, kernels)


@pytest.mark.cuda
def test_bottom_k_replays_in_a_cuda_graph(cuda):
    """The forward captured in a CUDA graph and replayed on new keys, values
    and k: the plain version's threshold bit for bit and its sum."""
    g = torch.Generator(device=cuda).manual_seed(43)
    n = 8 * 700 * 700
    vals = torch.empty(n, device=cuda)
    keyed = torch.empty(n, device=cuda)
    sn = torch.zeros((), dtype=torch.int32, device=cuda)

    def draw(seed):
        g.manual_seed(seed)
        vals.copy_(-torch.rand(n, generator=g, device=cuda).log() * seed)
        keyed.copy_(torch.where(torch.rand(n, generator=g, device=cuda) > 0.1 * seed, vals,
                                torch.full_like(vals, float("inf"))))
        sn.copy_((0.8 * torch.isfinite(keyed).sum()).to(torch.int32))

    draw(1)
    rcl.bottom_k_sum_cuda(vals, keyed, sn)  # built and sized before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, threshold, _ = rcl.bottom_k_sum_cuda(vals, keyed, sn)
    for seed in (2, 3):
        draw(seed)
        graph.replay()
        want = rcl.bottom_k_sum_plain(vals, keyed, sn)
        kth = torch.sort(keyed.view(torch.int32).long() & 0xFFFFFFFF).values[int(sn) - 1]
        torch.cuda.synchronize()
        assert int(threshold) & 0xFFFFFFFF == int(kth)
        np.testing.assert_allclose(float(out), float(want), rtol=1e-6, atol=1e-6)


@pytest.fixture
def nccl_world_1(cuda):
    """A process group of one rank over NCCL on the card, torn down after."""
    import socket

    from multishiftseg_torch.core import mesh

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mesh.initialize_distributed(backend="nccl", init_method=f"tcp://localhost:{port}",
                                world_size=1, rank=0, local_rank=torch.cuda.current_device())
    yield cuda
    mesh.shutdown_distributed()


# "main": the main path's size (8 x 700 x 700); the rest 5003 values with
# many ties, "above_n": k > n (threshold 0xFFFFFFFF)
GLOBAL_BOTTOM_K_CASES = ["main", "ties", "zero", "one", "above_n"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", GLOBAL_BOTTOM_K_CASES)
def test_global_bottom_k_matches_plain(nccl_world_1, case):
    """The global route in a group of one rank: the threshold is the k-th
    smallest key (0 for k = 0, 0xFFFFFFFF for k > n), the sum within 1e-6
    of the plain version's, the gradient weights bit for bit."""
    cuda = nccl_world_1
    rng = np.random.RandomState(11)
    n = 8 * 700 * 700 if case == "main" else 5003
    vals = (rng.gamma(1.0, 2.0, n) if case == "main"
            else np.floor(rng.rand(n) * 64) / 16).astype(np.float32)
    valid = rng.rand(n) > 0.2
    keyed = np.where(valid, vals, np.inf).astype(np.float32)
    count = int(valid.sum())
    k = {"main": int(0.8 * count), "ties": int(0.8 * count), "zero": 0, "one": 1,
         "above_n": n + 3}[case]
    sn = torch.tensor(k, dtype=torch.int32, device=cuda)
    kt = torch.from_numpy(keyed).to(cuda)
    sums, grads = [], []
    for fn in (rcl.bottom_k_sum_global, rcl.bottom_k_sum_global_plain):
        v = torch.from_numpy(vals).to(cuda).requires_grad_()
        out = fn(v, kt, sn)
        out.backward(torch.tensor(1.5, device=cuda))
        sums.append(float(out.detach()))
        grads.append(v.grad)
    _, threshold, result = rcl.bottom_k_sum_global_cuda(torch.from_numpy(vals).to(cuda), kt, sn)
    torch.cuda.synchronize()
    bits = np.sort(keyed.view(np.uint32))
    want_t = 0 if k <= 0 else (0xFFFFFFFF if k > n else int(bits[k - 1]))
    assert int(threshold.item()) & 0xFFFFFFFF == want_t
    assert float(result[0]) == sums[0]
    assert abs(sums[0] - sums[1]) <= 1e-6 * max(abs(sums[1]), 1.0)
    assert torch.equal(grads[0], grads[1])


@pytest.mark.cuda
def test_global_bottom_k_is_four_kernels_and_three_all_reduces(nccl_world_1, monkeypatch):
    """A call of the global route at the main-path size runs at most four
    device kernels (no fill, no copy) between its three all-reduces."""
    cuda = nccl_world_1
    g = torch.Generator(device=cuda).manual_seed(44)
    n = 8 * 700 * 700
    vals = -torch.rand(n, generator=g, device=cuda).log() * 2
    keyed = torch.where(torch.rand(n, generator=g, device=cuda) > 0.2, vals,
                        torch.full_like(vals, float("inf")))
    sn = (0.8 * torch.isfinite(keyed).sum()).to(torch.int32)
    reduced = []
    all_reduce = torch.distributed.all_reduce
    monkeypatch.setattr(torch.distributed, "all_reduce",
                        lambda t, *a, **kw: (reduced.append(t.dtype), all_reduce(t, *a, **kw))[1])
    launches, kernels = _launches(lambda: rcl.bottom_k_sum_global_cuda(vals, keyed, sn))
    assert launches <= 40 and not any("memset" in k.lower() for k in kernels), (launches, kernels)
    assert reduced == [torch.int32, torch.int32, torch.float64] * 11


@pytest.mark.cuda
def test_tiny_deeplab_step_on_the_card_matches_cpu(cuda):
    """A stage-2 step of a tiny DeepLab in f32 (TF32 off): the card's kernels
    against the CPU's plain versions, same weights, batch and draws. A ReLU
    input within f32 rounding of 0 may take either side on either device and
    move a whole gradient path, so the CPU's step follows the card's ReLU
    branches (``relu_sign_hooks``): per trainable tensor, within 1e-3 of scale."""
    import copy

    from multishiftseg_torch.core.config import load_config
    from multishiftseg_torch.models.deeplab import DeepWV3Plus
    from multishiftseg_torch.train.deeplab_trainer import TrainDeepLabOOD, synthetic_batch
    from multishiftseg_torch.utils import relu_sign_hooks

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config(str(REPO / "exps" / "deeplab.yaml"))
    cfg.train.bf16 = False
    torch.manual_seed(0)
    base = DeepWV3Plus(trunk_structure=(1,) * 6, trunk_channels=(
        (8, 8), (8, 8), (16, 16), (16, 16), (8, 16, 32), (16, 32, 64)))
    batch = synthetic_batch(1, (160, 160), 19, seed=1)
    draws = TrainDeepLabOOD(cfg, model=copy.deepcopy(base), device="cpu").draws(2, (160, 160))
    runs, signs = {}, {}
    for side, dev in (("card", cuda), ("cpu", "cpu")):
        tr = TrainDeepLabOOD(cfg, model=copy.deepcopy(base), device=dev)
        tr.set_stage(1)
        signs[side] = {}
        hooks = relu_sign_hooks(tr.model, signs[side],
                                replay=signs["card"] if side == "cpu" else None)
        loss, _ = tr.step(*batch, draws={"rcl_noise": draws["rcl_noise"].to(dev),
                                         "dropout": {k: v.to(dev) for k, v in
                                                     draws["dropout"].items()}})
        for h in hooks:
            h.remove()
        runs[side] = (float(loss), {n: p.grad.double().cpu()
                                    for n, p in tr.model.named_parameters() if p.grad is not None})
    (l_gpu, g_gpu), (l_cpu, g_cpu) = runs["card"], runs["cpu"]
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
    assert set(g_cpu) == set(g_gpu) and "aspp.features.3.0.weight" in g_gpu
    for name, ref in g_cpu.items():
        err = float((g_gpu[name] - ref).abs().max()) / (float(ref.abs().max()) + 1e-30)
        assert err <= 1e-3, (name, err)


def _tail_case(rng, n=2, q=6, k=19, hw=(16, 20), out_hw=(64, 80), tie=False, ties=2,
               crop=None):
    logits = rng.randn(n, q, k + 1).astype(np.float32)
    if tie:  # the first `ties` classes equal and leading: their sums tie where they lead
        logits[..., :ties] = (3.0 + rng.rand(n, q).astype(np.float32))[..., None]
    probs = torch.softmax(torch.from_numpy(logits), -1)[..., :-1].contiguous()
    masks = torch.from_numpy((3 * rng.randn(n, q, *hw)).astype(np.float32))
    g = torch.from_numpy(rng.randn(n, *out_hw).astype(np.float32))
    if crop is not None:  # no gradient outside the crop: whole tiles without one
        g[:, crop[0]:] = 0
        g[:, :, crop[1]:] = 0
    if not tie:
        # zero the gradient where the top two class sums lie within f32 rounding
        # of each other: there the sum order decides which class gets it
        up = torch.sigmoid(scores.resize_bilinear_nchw(masks, out_hw))
        top2 = torch.einsum("bqk,bqhw->bhwk", probs, up).topk(2, dim=-1).values
        g = torch.where(top2[..., 0] - top2[..., 1] > 1e-4, g, torch.zeros_like(g))
    return masks, probs, g


@pytest.mark.cuda
@pytest.mark.parametrize("dmask", [False, True])
@pytest.mark.parametrize("case", ["k19", "k25_odd_shapes", "tie", "three_way_tie",
                                  "ragged_tiles_crop", "downsample_unstaged"])
def test_mask_scores_backward_kernel_matches_plain(cuda, case, dmask):
    """d probs (and d masks) of the anomaly tail: kernel against autograd of the
    plain version. Tolerance: 1e-5 of each entry's sum of absolute terms (the
    same backward with |g|), f32 sums in another order. The kernel's sums are
    in a fixed order, so two runs agree bit for bit, with or without d masks;
    tied classes get equal shares. ``three_way_tie`` ties three classes;
    ``ragged_tiles_crop`` has 75 x 100 outputs (not a multiple of the 8 x 32
    tile) and no gradient from row 60 or column 90 on (tiles skipped whole),
    100 queries from staged windows; ``downsample_unstaged`` reads its taps
    from global memory (its window does not fit in shared memory)."""
    rng = np.random.RandomState(11)
    kw = {"k19": {}, "k25_odd_shapes": dict(k=25, q=7, hw=(13, 9), out_hw=(37, 45)),
          "tie": dict(tie=True), "three_way_tie": dict(tie=True, ties=3, out_hw=(75, 100)),
          "ragged_tiles_crop": dict(q=100, hw=(19, 25), out_hw=(75, 100), crop=(60, 90)),
          "downsample_unstaged": dict(q=16, hw=(64, 80), out_hw=(16, 20))}[case]
    masks, probs, g = (t.to(cuda) for t in _tail_case(rng, **kw))
    out_hw = tuple(g.shape[1:])
    dp, dm = scores.mask_scores_backward(masks, probs, g, out_hw, dmask=dmask)
    dp2, dm2 = scores.mask_scores_backward(masks, probs, g, out_hw, dmask=dmask)
    dp_other, _ = scores.mask_scores_backward(masks, probs, g, out_hw, dmask=not dmask)
    want_p, want_m = scores.mask_scores_backward_plain(masks, probs, g, out_hw, dmask=dmask)
    abs_p, abs_m = scores.mask_scores_backward_plain(masks, probs, g.abs(), out_hw, dmask=dmask)
    torch.cuda.synchronize()
    assert torch.equal(dp, dp2) and torch.equal(dp, dp_other)
    assert bool(((dp - want_p).abs() <= 1e-5 * abs_p.abs() + 1e-30).all())
    assert float(abs_p.abs().max()) > 0
    if dmask:
        assert torch.equal(dm, dm2)
        assert bool(((dm - want_m).abs() <= 1e-5 * abs_m.abs() + 1e-30).all())
    else:
        assert dm is None
    ties = kw.get("ties", 2) if kw.get("tie") else 0
    for k in range(1, ties):
        assert torch.equal(dp[..., 0], dp[..., k]) and float(dp[..., 0].abs().max()) > 0


@pytest.mark.cuda
def test_anomaly_tail_autograd_on_the_card(cuda):
    """Gradients through ``anomaly_score_upsampled`` on the card (the softmax in
    torch autograd, the tail's backward kernel) against the CPU's autograd,
    with one backward launch; without a gradient for the mask logits, none is
    computed for them."""
    from multishiftseg_torch.ops import launch_counts, reset_launch_counts

    rng = np.random.RandomState(12)
    logits = rng.randn(2, 6, 20).astype(np.float32)
    masks = (3 * rng.randn(2, 6, 16, 20)).astype(np.float32)
    g = rng.randn(2, 64, 80).astype(np.float32)
    grads = {}
    for dev in ("cpu", cuda):
        c = torch.from_numpy(logits).to(dev).requires_grad_()
        m = torch.from_numpy(masks).to(dev).requires_grad_()
        reset_launch_counts()
        scores.anomaly_score_upsampled(c, m, (64, 80)).backward(torch.from_numpy(g).to(dev))
        grads[str(dev)] = (c.grad.cpu(), m.grad.cpu(), launch_counts()["mask_scores_backward"])
    (gc, gm, n_cpu), (kc, km, n_card) = grads["cpu"], grads[str(cuda)]
    assert n_cpu == 0 and n_card == 1
    torch.testing.assert_close(kc, gc, rtol=1e-4, atol=1e-5 * float(gc.abs().max()))
    torch.testing.assert_close(km, gm, rtol=1e-4, atol=1e-5 * float(gm.abs().max()))
    c = torch.from_numpy(logits).to(cuda).requires_grad_()
    m = torch.from_numpy(masks).to(cuda)
    scores.anomaly_score_upsampled(c, m, (64, 80)).sum().backward()
    assert c.grad is not None and m.grad is None


@pytest.mark.cuda
def test_semantic_classes_only_equals_the_first_k_channels(cuda):
    rng = np.random.RandomState(13)
    cls = torch.from_numpy(rng.randn(2, 6, 20).astype(np.float32)).to(cuda)
    masks = torch.from_numpy((3 * rng.randn(2, 6, 16, 20)).astype(np.float32)).to(cuda)
    full = scores.semantic_inference_upsampled(cls, masks, (64, 80), 19)
    only = scores.semantic_inference_upsampled(cls, masks, (64, 80), 19, _classes_only=True)
    torch.cuda.synchronize()
    assert only.shape == (2, 19, 64, 80) and torch.equal(only, full[:, :19])


def _hist_cases(rng):
    n = 921_600  # a 720x1280 map
    s = rng.rand(n).astype(np.float32)
    lab = rng.choice([0, 1, 255], size=n, p=[0.6, 0.25, 0.15]).astype(np.int32)
    yield "720x1280", s, lab, None
    yield "given_range", s, lab, (0.2, 0.7)  # pixels outside it
    yield "no_valid_pixel", s[:1000], np.full(1000, 255, np.int32), None
    yield "constant", np.full(5000, 0.3, np.float32), lab[:5000], None
    yield "one_pixel", s[:1], np.ones(1, np.int32), None
    yield "ragged", s[:100_003], lab[:100_003], None  # a slice not a multiple of 4
    nan = s.copy()
    nan[rng.randint(0, n, 3)] = np.nan  # a NaN score: the range is NaN, as JAX's
    yield "nan", nan, np.zeros(n, np.int32), None
    for name, v in (("pos_inf", np.inf), ("neg_inf", -np.inf)):
        bad = s.copy()  # an infinite range: (s - lo) / span is NaN or 0
        bad[np.flatnonzero(lab != 255)[rng.randint(0, 1000)]] = v
        yield name, bad, lab, None
    void = s.copy()  # a NaN score at a void pixel is not counted
    void[np.flatnonzero(lab == 255)[:5]] = np.nan
    yield "nan_at_void", void, lab, None
    yield "nan_given_range", nan, lab, (0.0, 1.0)


HIST_CASES = [c[0] for c in _hist_cases(np.random.RandomState(14))]


def _hist_case(name):
    return next(c for c in _hist_cases(np.random.RandomState(14)) if c[0] == name)


def _equal_ranges(got, want):
    return np.array_equal(np.array([float(v) for v in got]), np.array([float(v) for v in want]),
                          equal_nan=True)


@pytest.mark.cuda
def test_ood_hist_kernels_equal_plain(cuda):
    """The masked range and the histograms (8192 bins) equal the plain
    versions bit for bit, non-finite ranges included."""
    rng = np.random.RandomState(14)
    for name, s, lab, given in _hist_cases(rng):
        st, lt = torch.from_numpy(s), torch.from_numpy(lab)
        lo_p, hi_p = ood_metrics.masked_min_max_plain(st, lt)
        lo_k, hi_k = ood_metrics.masked_min_max(st.to(cuda), lt.to(cuda))
        assert _equal_ranges((lo_k, hi_k), (lo_p, hi_p)), name
        lo, hi = given or (lo_p, hi_p)
        want = ood_metrics.label_histograms_plain(st, lt, lo, hi, 8192)
        got = ood_metrics.label_histograms(st.to(cuda), lt.to(cuda),
                                           torch.as_tensor(lo).to(cuda),
                                           torch.as_tensor(hi).to(cuda), 8192)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b), name
        # float64 ends on the card: both converted before the launch, each
        # kept until it is queued (the two copies must not share a block)
        got = ood_metrics.label_histograms(st.to(cuda), lt.to(cuda),
                                           torch.as_tensor(lo).to(cuda, torch.float64),
                                           torch.as_tensor(hi).to(cuda, torch.float64), 8192)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b), name
        if given:  # the range by value
            got = ood_metrics.label_histograms(st.to(cuda), lt.to(cuda), *given, 8192)
            for a, b in zip(got, want):
                assert torch.equal(a.cpu(), b), name


@pytest.mark.cuda
@pytest.mark.parametrize("case", HIST_CASES)
def test_range_histograms_kernel_equals_the_plain_sequence(cuda, case):
    """Range and histograms in one launch: the plain range, then the plain
    histograms over it, bit for bit."""
    _, s, lab, _ = _hist_case(case)
    st, lt = torch.from_numpy(s), torch.from_numpy(lab)
    want = ood_metrics.range_histograms_plain(st, lt, 8192)
    got = ood_metrics.range_histograms(st.to(cuda), lt.to(cuda), 8192)
    assert _equal_ranges(got[:2], want[:2])
    for a, b in zip(got[2:], want[2:]):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,crop", [((768, 1280), (720, 1000)), ((96, 131), (90, 33))])
def test_ood_entries_read_a_cropped_view_in_place(cuda, shape, crop):
    """A crop of a padded map (rows ``shape[1]`` apart) through every entry:
    the plain versions' results, and one device kernel a call (no copy)."""
    rng = np.random.RandomState(18)
    full = torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(cuda)
    lab = rng.choice([0, 1, 255], size=crop, p=[0.6, 0.25, 0.15]).astype(np.int32)
    view = full[:crop[0], :crop[1]]
    assert not view.is_contiguous()
    lt, ld = torch.from_numpy(lab), torch.from_numpy(lab).to(cuda)
    want = ood_metrics.range_histograms_plain(view.cpu(), lt, 8192)
    got = ood_metrics.range_histograms(view, ld, 8192)
    assert _equal_ranges(got[:2], want[:2])
    assert _equal_ranges(ood_metrics.masked_min_max(view, ld), want[:2])
    hists = ood_metrics.label_histograms(view, ld, got[0], got[1], 8192)
    for a, b, c in zip(got[2:], hists, want[2:]):
        assert torch.equal(a.cpu(), c) and torch.equal(b.cpu(), c)
    launches, kernels = _launches(lambda: ood_metrics.range_histograms(view, ld, 8192))
    assert launches == 10 and all("ood_reduce_kernel" in k for k in kernels), (launches, kernels)


@pytest.mark.cuda
def test_range_histograms_past_the_staged_share(cuda):
    """A 4096x4096 map: more pixels than the blocks stage in shared memory (the
    rest re-read from global memory), the plain sequence's results."""
    g = torch.Generator(device=cuda).manual_seed(19)
    n = 4096 * 4096
    s = torch.rand(n, generator=g, device=cuda)
    lab = (torch.rand(n, generator=g, device=cuda) * 3).to(torch.int32)
    lab[lab == 2] = 255
    got = ood_metrics.range_histograms(s, lab, 8192)
    want = ood_metrics.range_histograms_plain(s.cpu(), lab.cpu(), 8192)
    assert _equal_ranges(got[:2], want[:2])
    for a, b in zip(got[2:], want[2:]):
        assert torch.equal(a.cpu(), b)
    assert int(got[2].sum() + got[3].sum()) == int(((lab == 0) | (lab == 1)).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["range", "histogram", "both"])
def test_ood_entries_are_one_kernel(cuda, entry):
    """Each entry at 720x1280 runs exactly one kernel a call: no fill, no
    stack, no finishing kernel."""
    g = torch.Generator(device=cuda).manual_seed(20)
    s = torch.rand(921_600, generator=g, device=cuda)
    lab = (torch.rand(921_600, generator=g, device=cuda) * 2).to(torch.int32)
    lo, hi = ood_metrics.masked_min_max(s, lab)
    fn = {"range": lambda: ood_metrics.masked_min_max(s, lab),
          "histogram": lambda: ood_metrics.label_histograms(s, lab, lo, hi, 8192),
          "both": lambda: ood_metrics.range_histograms(s, lab, 8192)}[entry]
    launches, kernels = _launches(fn)
    assert launches == 10 and all("ood_reduce_kernel" in k for k in kernels), (launches, kernels)


@pytest.mark.cuda
@pytest.mark.parametrize("labels_on", ["cuda", "numpy"])
def test_binned_meter_update_is_one_kernel_and_one_sync(cuda, labels_on):
    """A meter update on a crop of a padded map: one kernel and one copy to the
    host, which is the update's one host sync; numpy labels add one upload
    and no sync. The histograms equal the CPU meter's."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.RandomState(21)
    full = torch.from_numpy(rng.rand(768, 1280).astype(np.float32)).to(cuda)
    lab = rng.choice([0, 1, 255], size=(720, 1280)).astype(np.int32)
    labels = torch.from_numpy(lab).to(cuda) if labels_on == "cuda" else lab
    card, cpu = ood_metrics.BinnedOODMeter(), ood_metrics.BinnedOODMeter()
    card.update(full[:720], labels)
    cpu.update(full[:720].cpu(), lab)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            card.update(full[:720], labels)
    names = [e.name for e in prof.events()]
    launches = chip_smoke.launch_calls(prof)
    assert launches == 5 * (2 if labels_on == "cuda" else 3), names
    assert sum(n.startswith("cudaLaunch") for n in names) == 5
    assert chip_smoke.host_syncs(prof) == 5, [n for n in names if "Synchronize" in n]
    for a, b in zip(card._hists, cpu._hists):
        assert all(np.array_equal(x, y) for x, y in zip(a[:2], b[:2])) and a[2:] == b[2:]


@pytest.mark.cuda
def test_ood_histogram_past_its_limit_raises_before_launch(cuda):
    """More bins than a block's shared memory holds: ValueError, no launch."""
    s, lab = torch.rand(64, device=cuda), torch.zeros(64, dtype=torch.int32, device=cuda)
    before = dict(ood_metrics.LAUNCHES)
    with pytest.raises(ValueError, match="too many bins"):
        ood_metrics.label_histograms(s, lab, 0.0, 1.0, 40_000)
    with pytest.raises(ValueError, match="too many bins"):
        ood_metrics.range_histograms(s, lab, 40_000)
    assert ood_metrics.LAUNCHES == before


@pytest.mark.cuda
def test_range_histograms_replay_in_a_cuda_graph(cuda):
    """The one-launch range and histograms captured in a CUDA graph and
    replayed on new scores and labels: the plain sequence's results."""
    g = torch.Generator(device=cuda).manual_seed(22)
    n = 720 * 1280
    s = torch.empty(n, device=cuda)
    lab = torch.empty(n, dtype=torch.int32, device=cuda)

    def draw(seed):
        g.manual_seed(seed)
        s.copy_(torch.rand(n, generator=g, device=cuda) * seed)
        lab.copy_((torch.rand(n, generator=g, device=cuda) * 3).to(torch.int32))
        lab[lab == 2] = 255

    draw(1)
    ood_metrics.range_histograms(s, lab, 8192)  # loaded and configured before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ood_metrics.range_histograms(s, lab, 8192)
    for seed in (2, 3):
        draw(seed)
        graph.replay()
        want = ood_metrics.range_histograms_plain(s.cpu(), lab.cpu(), 8192)
        torch.cuda.synchronize()
        assert _equal_ranges(out[:2], want[:2])
        for a, b in zip(out[2:], want[2:]):
            assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_binned_meter_on_the_card_equals_the_cpu(cuda):
    rng = np.random.RandomState(15)
    card, cpu = ood_metrics.BinnedOODMeter(), ood_metrics.BinnedOODMeter()
    for h, w in ((120, 200), (64, 64), (90, 33)):
        s = torch.from_numpy(rng.rand(h, w).astype(np.float32))
        lab = rng.choice([0, 1, 255], size=(h, w)).astype(np.int32)
        card.update(s.to(cuda), lab)
        cpu.update(s, lab)
    for a, b in zip(card._hists, cpu._hists):
        assert all(np.array_equal(x, y) for x, y in zip(a[:2], b[:2])) and a[2:] == b[2:]
    assert card.compute() == cpu.compute()


@pytest.mark.cuda
def test_new_wrappers_raise_when_the_build_fails(cuda, monkeypatch):
    """On the card a failed build raises; no wrapper falls back to its plain version."""
    def fail(name):
        raise RuntimeError(f"nvcc failed for {name}")

    monkeypatch.setattr(_build, "load", fail)
    masks, probs, g = (t.to(cuda) for t in _tail_case(np.random.RandomState(16)))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        scores.mask_scores_backward(masks, probs, g, tuple(g.shape[1:]))
    c = torch.zeros(2, 6, 20, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        scores.anomaly_score_upsampled(c, masks, tuple(g.shape[1:]))
    s, lab = torch.rand(64, device=cuda), torch.zeros(64, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ood_metrics.masked_min_max(s, lab)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ood_metrics.BinnedOODMeter().update(s, lab.cpu().numpy())
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ood_metrics.BinnedOODMeter().update(s, lab)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ood_metrics.range_histograms(s, lab, 64)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ood_metrics.label_histograms(s, lab, 0.0, 1.0, 64)


# ---------------------------------------------------------------------------
# the int8 table and the approximate deformable modes


def near_rounding_boundary(loc, attn, shapes, mode):
    """``chip_smoke.near_rounding_boundary`` on numpy arrays: [N, Lq, M] bool,
    the outputs whose centroid lies within 1e-4 px of a rounding boundary."""
    return chip_smoke.near_rounding_boundary(torch, torch.from_numpy(loc),
                                             torch.from_numpy(attn), shapes, mode).numpy()


def _approx_inputs(rng, shapes, d, weights):
    value, loc, attn = _msda_inputs(rng, shapes, d)
    if weights == "equal":  # every selection rests on the tie rule
        attn = np.full_like(attn, 1.0 / (len(shapes) * P))
    elif weights == "zeros":  # a third exactly 0, one head all 0
        attn[rng.rand(*attn.shape) < 0.33] = 0.0
        attn[:, 0, 0] = 0.0
    return value, loc, attn


APPROX_MODES = ("nearest_top1", "nearest_top6", "nearest_topJ", "nearest_top1c",
                "nearest_top6c", "nearest_topJc", "shared")


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["random", "equal", "zeros"])
@pytest.mark.parametrize("d", [32, 6])  # 16-byte channel groups, single channels
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", APPROX_MODES)
@pytest.mark.parametrize("levels", sorted(LEVEL_SETS))
def test_approximate_kernels_match_plain(cuda, levels, mode, dtype, d, weights):
    """``nearest_top{T}`` / ``nearest_top{T}c`` (T in 1, 6, J) and ``shared``:
    the kernel against its plain version on the card. Tolerance: f32 1e-5,
    sums in another order; bf16 1e-2, both round one f32 sum to bf16. Outputs
    whose centroid lies within 1e-4 px of a rounding boundary may take the
    neighbouring pixel; those that do are counted and must be few, every
    other output is held."""
    rng = np.random.RandomState(20)
    shapes = LEVEL_SETS[levels]
    mode = mode.replace("J", str(len(shapes) * P))
    value, loc, attn = _approx_inputs(rng, shapes, d, weights)
    v = torch.from_numpy(value).to(cuda, dtype)
    lo = torch.from_numpy(loc).to(cuda)
    a = torch.from_numpy(attn).to(cuda, dtype)
    kind = msda.parse_sample_mode(mode)[0]
    before = msda.LAUNCHES[f"ms_deform_attn_{kind}"]
    out = msda.ms_deform_attn_core(v, shapes, lo, a, mode)
    ref = msda.ms_deform_attn_core_plain(v, shapes, lo, a, mode)
    torch.cuda.synchronize()
    assert msda.LAUNCHES[f"ms_deform_attn_{kind}"] == before + 1
    assert out.dtype == dtype and out.shape == (N, LQ, M * d)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    bad = ((out.float() - ref.float()).abs() > tol + tol * ref.float().abs()).cpu().numpy()
    near = near_rounding_boundary(loc, attn.astype(np.float32) if dtype == torch.float32
                                  else a.float().cpu().numpy(), shapes, mode)
    bad = bad.reshape(N, LQ, M, d).any(-1)
    assert not (bad & ~near).any()
    assert int(bad.sum()) <= 2


WARP_WIDTHS = chip_smoke.WARP_WIDTHS


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["random", "equal", "zeros"])
@pytest.mark.parametrize("d", [32, 6])  # 16-byte channel groups, single channels
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["nearest_top1", "nearest_top6", "nearest_topJ",
                                  "nearest_top6c", "nearest_topJc", "shared"])
@pytest.mark.parametrize("j", sorted(WARP_WIDTHS))
def test_top_kernel_at_warp_widths_matches_plain(cuda, j, mode, dtype, d, weights):
    """``nearest_top{T}[c]`` with a head's points on 16 lanes (J = 12, two
    heads a warp) and on 32 (J = 32, one head a warp), over 2400 heads (many
    blocks, a partial last one); ``shared`` with its points on 12 or 32 lanes
    over 602 queries (a warp each: many blocks, a partial last one). Random,
    all-equal (the tie rule alone) and zero weights (a third 0, some heads all
    0), against the plain version. Tolerance as
    ``test_approximate_kernels_match_plain``; outputs whose centroid lies
    within 1e-4 px of a rounding boundary may flip, at most max(2, 1 in
    10,000) of them."""
    shapes, p = WARP_WIDTHS[j]
    mode = mode.replace("J", str(j))
    rng = np.random.RandomState(j + d)
    # 602 = 2 x 7 x 43 queries: no power-of-two block of warps divides them
    n, lq, m = 2, 301 if mode == "shared" else 300, 4
    s = sum(h * w for h, w in shapes)
    value = rng.randn(n, s, m, d).astype(np.float32)
    loc = rng.rand(n, lq, m, len(shapes), p, 2).astype(np.float32) * 1.2 - 0.1
    attn = np.full((n, lq, m, len(shapes), p), 1.0 / j, np.float32)
    if weights != "equal":
        attn = rng.rand(*attn.shape).astype(np.float32)
        if weights == "zeros":
            attn[rng.rand(*attn.shape) < 0.33] = 0.0
            attn[:, 0, 0] = 0.0
        attn /= np.maximum(attn.reshape(n, lq, m, -1).sum(-1), 1e-6).reshape(n, lq, m, 1, 1)
    v = torch.from_numpy(value).to(cuda, dtype)
    lo = torch.from_numpy(loc).to(cuda)
    a = torch.from_numpy(attn).to(cuda, dtype)
    kind = msda.parse_sample_mode(mode)[0]
    before = msda.LAUNCHES[f"ms_deform_attn_{kind}"]
    out = msda.ms_deform_attn_core(v, shapes, lo, a, mode)
    ref = msda.ms_deform_attn_core_plain(v, shapes, lo, a, mode)
    torch.cuda.synchronize()
    assert msda.LAUNCHES[f"ms_deform_attn_{kind}"] == before + 1
    assert out.dtype == dtype and out.shape == (n, lq, m * d)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    bad = ((out.float() - ref.float()).abs() > tol + tol * ref.float().abs()).cpu().numpy()
    near = near_rounding_boundary(loc, a.float().cpu().numpy(), shapes, mode)
    bad = bad.reshape(n, lq, m, d).any(-1)
    assert not (bad & ~near).any()
    assert int(bad.sum()) <= max(2, bad.size // 10000)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shared_kernel_with_points_beyond_shared_memory_matches_plain(cuda, dtype):
    """``shared`` with 48 heads of 32 points: a query's 1,536 locations and
    weights, twice over for a warp's two buffers, do not fit in a block's
    shared memory, so the kernel reads them from global memory (and gathers
    48 x 32 channels in passes). Tolerance and flips as
    ``test_top_kernel_at_warp_widths_matches_plain``."""
    shapes, p = WARP_WIDTHS[32]
    rng = np.random.RandomState(51)
    n, lq, m, d = 2, 45, 48, 32
    value = rng.randn(n, sum(h * w for h, w in shapes), m, d).astype(np.float32)
    loc = rng.rand(n, lq, m, len(shapes), p, 2).astype(np.float32) * 1.2 - 0.1
    attn = rng.rand(n, lq, m, len(shapes), p).astype(np.float32)
    v = torch.from_numpy(value).to(cuda, dtype)
    lo = torch.from_numpy(loc).to(cuda)
    a = torch.from_numpy(attn / attn.reshape(n, lq, m, -1).sum(-1)[..., None, None]).to(
        cuda, dtype)
    out = msda.ms_deform_attn_core(v, shapes, lo, a, "shared")
    ref = msda.ms_deform_attn_core_plain(v, shapes, lo, a, "shared")
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    bad = ((out.float() - ref.float()).abs() > tol + tol * ref.float().abs()).cpu().numpy()
    near = near_rounding_boundary(loc, a.float().cpu().numpy(), shapes, "shared")
    bad = bad.reshape(n, lq, m, d).any(-1)
    assert not (bad & ~near).any()
    assert int(bad.sum()) <= max(2, bad.size // 10000)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["nearest_top6", "nearest_top6c", "shared"])
def test_top_kernel_takes_inputs_off_16_byte_alignment(cuda, mode):
    """Locations and weights that start 8 and 2 bytes past a 16-byte boundary
    (contiguous views into larger buffers; the selection reads a point's
    location as one float2 and its weight alone, ``shared`` copies a query's
    points in 16-byte pieces with 2-byte edges): the output equals that of
    the aligned inputs."""
    shapes, p = WARP_WIDTHS[12]
    rng = np.random.RandomState(50)
    n, lq, m, d = 2, 300, 4, 32
    value = torch.from_numpy(rng.randn(n, sum(h * w for h, w in shapes), m, d).astype(
        np.float32)).to(cuda, torch.bfloat16)
    loc = torch.from_numpy(rng.rand(n, lq, m, len(shapes), p, 2).astype(np.float32)).to(cuda)
    attn = torch.softmax(torch.from_numpy(rng.randn(n, lq, m, len(shapes) * p).astype(
        np.float32)), -1).view(n, lq, m, len(shapes), p).to(cuda, torch.bfloat16)
    loc_off = torch.empty(loc.numel() + 2, device=cuda)[2:].view(loc.shape).copy_(loc)
    attn_off = torch.empty(attn.numel() + 1, dtype=attn.dtype, device=cuda)[1:].view(
        attn.shape).copy_(attn)
    assert loc_off.data_ptr() % 16 == 8 and attn_off.data_ptr() % 16 == 2
    got = msda.ms_deform_attn_core(value, shapes, loc_off, attn_off, mode)
    want = msda.ms_deform_attn_core(value, shapes, loc, attn, mode)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(2, 300, 4, 32), (1, 977, 8, 30), (3, 50, 2, 256),
                                  (1, 43008, 8, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nan", [False, True])
def test_quantize_kernel_equals_plain_bit_for_bit(cuda, dtype, case, nan):
    """The int8 table and its scale, bit for bit: the max is order-free, the
    division IEEE and the rounding half to even on both sides. An all-zero
    channel floors its scale at 1e-12; exact half steps round to even. A NaN
    propagates to its channel's scale (any NaN's bits), whose table entries
    are 0."""
    rng = np.random.RandomState(21)
    value = (rng.randn(*case) * rng.rand(1, 1, 1, case[-1]) * 4).astype(np.float32)
    value[..., 1] = 0.0
    value[0, 0, 0, 2:6] = [0.5, 1.5, -2.5, 127.0]
    if nan:
        value[-1, -1, -1, 3] = np.nan
    v = torch.from_numpy(value).to(cuda, dtype)
    q, scale = msda.quantize_value_table(v)
    qp, sp = msda.quantize_value_table_plain(v)
    torch.cuda.synchronize()
    assert q.dtype == torch.int8 and scale.shape == (case[-1],)
    assert torch.equal(q, qp)
    assert torch.equal(scale.isnan(), sp.isnan()) and bool(scale.isnan().any()) == nan
    held = ~sp.isnan()
    assert torch.equal(scale[held].view(torch.int32), sp[held].view(torch.int32))
    if nan:
        assert not q[..., 3].any()


def _quantize_stage_bytes():
    """MSDA_Q_STAGE_BYTES of csrc/ms_deform_attn.cu: the bytes of value a
    quantize block holds in shared memory."""
    src = (REPO / "multishiftseg_torch" / "csrc" / "ms_deform_attn.cu").read_text()
    return int(re.search(r"#define MSDA_Q_STAGE_BYTES \((\d+) \* 1024\)", src).group(1)) * 1024


def _assert_quantize_is_plain(v):
    q, scale = msda.quantize_value_table(v)
    qp, sp = msda.quantize_value_table_plain(v)
    torch.cuda.synchronize()
    assert torch.equal(q, qp)
    assert torch.equal(scale.view(torch.int32), sp.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["under_capacity", "over_capacity", "prime_rows_d32",
                                  "prime_rows_d30", "unaligned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_kernel_at_capacity_edges_equals_plain(cuda, dtype, case):
    """The one-launch quantize, bit for bit: a table just under the grid's
    shared memory (every block's slice staged) and just over it (the rest of
    each slice read again from global memory); a prime row count (no block
    count divides it, slices start mid-row: at 30 channels, off the row
    boundaries); value and table off 16-byte alignment (single elements)."""
    d = 30 if case == "prime_rows_d30" else 32
    size = torch.empty((), dtype=dtype).element_size()
    msda.quantize_value_table(torch.zeros(1, 1, 1, d, dtype=dtype, device=cuda))
    capacity = msda._QUANTIZE_BLOCKS[cuda.index or 0] * (_quantize_stage_bytes() // size)
    rows = {"under_capacity": capacity // d - 8, "over_capacity": capacity // d + 40000,
            "prime_rows_d32": 100003, "prime_rows_d30": 100003, "unaligned": 7919}[case]
    g = torch.Generator(device=cuda).manual_seed(23)
    v = torch.randn(rows * d + 8, generator=g, device=cuda).to(dtype)
    v[:d] = torch.linspace(-3.5, 3.5, d)  # exact half steps of the scale
    if case == "unaligned":
        v = v[1:]
    v = v[:rows * d].view(1, rows, 1, d)
    assert (v.data_ptr() % 16 != 0) == (case == "unaligned")
    _assert_quantize_is_plain(v)


@pytest.mark.cuda
def test_quantize_is_one_kernel(cuda):
    """One quantize call launches exactly one kernel on the card (no fill, no
    second pass), at the eval shapes."""
    v = torch.randn(1, 43008, 8, 32, device=cuda).to(torch.bfloat16)
    launches, kernels = _launches(lambda: msda.quantize_value_table(v))
    assert launches == 10 and all("msda_quantize_kernel" in k for k in kernels), (launches,
                                                                                 kernels)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_replays_in_a_cuda_graph(cuda, dtype):
    """The quantize captured in a CUDA graph and replayed on new data gives the
    plain version's table and scale bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(24)
    v = (torch.randn(1, 43008, 8, 32, generator=g, device=cuda) * 3).to(dtype)
    msda.quantize_value_table(v)  # built and sized before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        q, scale = msda.quantize_value_table(v)
    for seed in (25, 26):
        g.manual_seed(seed)
        v.copy_(torch.randn(v.shape, generator=g, device=cuda) * seed)
        graph.replay()
        qp, sp = msda.quantize_value_table_plain(v)
        torch.cuda.synchronize()
        assert torch.equal(q, qp)
        assert torch.equal(scale.view(torch.int32), sp.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 6])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("levels", sorted(LEVEL_SETS))
def test_int8_forward_kernel_matches_plain(cuda, dtype, levels, d):
    rng = np.random.RandomState(22)
    shapes = LEVEL_SETS[levels]
    value, loc, attn = _msda_inputs(rng, shapes, d)
    v = torch.from_numpy(value).to(cuda, dtype)
    lo = torch.from_numpy(loc).to(cuda)
    a = torch.from_numpy(attn).to(cuda, dtype)
    before = dict(msda.LAUNCHES)
    out = msda.ms_deform_attn_core(v, shapes, lo, a, quantize_table=True)
    ref = msda.ms_deform_attn_core_plain(v, shapes, lo, a, quantize_table=True)
    torch.cuda.synchronize()
    assert msda.LAUNCHES["ms_deform_attn_quantize"] == before["ms_deform_attn_quantize"] + 1
    assert msda.LAUNCHES["ms_deform_attn_int8"] == before["ms_deform_attn_int8"] + 1
    # f32: sums in another order; bf16: both round one f32 sum to bf16
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_score_tails_on_the_card_match_plain(cuda):
    """``score_lowres`` (the tail kernel at the identity resize, then one
    resize) and ``score_topq`` (the tail kernel on the kept queries): f32, sums
    in another order. The identity resize reproduces the plain version's
    score exactly: each pixel reads its own texel with weight 1."""
    rng = np.random.RandomState(23)
    cls = torch.from_numpy(rng.randn(2, 10, 20).astype(np.float32)).to(cuda)
    masks = torch.from_numpy((3 * rng.randn(2, 10, 16, 20)).astype(np.float32)).to(cuda)
    ident = scores.anomaly_score_upsampled(cls, masks, (16, 20))
    ident_ref = scores.anomaly_score_upsampled_plain(cls, masks, (16, 20))
    low = scores.anomaly_score_lowres(cls, masks, (64, 80))
    low_ref = scores.resize_bilinear_nchw(ident_ref, (64, 80))
    before = scores.LAUNCHES["mask_scores_anomaly"]
    top = scores.anomaly_score_topq(cls, masks, (64, 80), 4)
    top_ref = scores.anomaly_score_topq_plain(cls, masks, (64, 80), 4)
    torch.cuda.synchronize()
    assert scores.LAUNCHES["mask_scores_anomaly"] == before + 1
    torch.testing.assert_close(ident, ident_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(low, low_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(top, top_ref, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# on the CPU: guards that stop a card run from silently losing gradients


def _meta_requiring_grad(*shapes, dtype=torch.float32):
    """Tensors that are not on the CPU, so the wrappers take their card route,
    without needing a card."""
    return [torch.zeros(s, device="meta", dtype=dtype).requires_grad_() for s in shapes]


class _CardRoute(TorchDispatchMode):
    """Sends each ``mss::`` op to the CUDA implementation the dispatcher holds
    for it, whatever its tensors' device: meta tensors then stand in for a
    card's (outside this mode a meta tensor takes the op's fake, which only
    states the outputs)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "mss":
            return func.redispatch(torch._C.DispatchKeySet(torch._C.DispatchKey.CUDA),
                                   *args, **(kwargs or {}))
        return func(*args, **(kwargs or {}))


def test_score_tail_refuses_grad_off_the_cpu(monkeypatch):
    """The semantic tail has no backward kernel: off the CPU it raises under
    grad. The anomaly tail has one: it goes to its kernel (here: the library
    loader, stubbed) under grad too."""
    cls, masks = _meta_requiring_grad((1, 4, 6), (1, 4, 3, 5))
    with pytest.raises(RuntimeError, match="no backward"):
        scores.semantic_inference_upsampled(cls, masks, (6, 10), num_classes=5)

    def refuse(name):
        raise _Sentinel(name)

    monkeypatch.setattr(_build, "load", refuse)
    with _CardRoute(), pytest.raises(_Sentinel, match="mask_scores"):
        scores.anomaly_score_upsampled(cls, masks, (6, 10))


def test_nearest_refuses_grad_off_the_cpu():
    value, loc, attn = _meta_requiring_grad((1, 8, 2, 4), (1, 3, 2, 1, 2, 2), (1, 3, 2, 1, 2))
    with pytest.raises(RuntimeError, match="no backward"):
        msda.ms_deform_attn_core(value, [(2, 4)], loc, attn, "nearest")


@pytest.mark.parametrize("mode", ["nearest_top1", "nearest_top2c", "shared"])
def test_approximate_modes_refuse_grad_off_the_cpu(mode):
    """Eval-only, as in JAX: no backward kernel, so under grad off the CPU
    every approximate mode raises, before any kernel is loaded."""
    value, loc, attn = _meta_requiring_grad((1, 8, 2, 4), (1, 3, 2, 1, 2, 2), (1, 3, 2, 1, 2))
    with pytest.raises(RuntimeError, match="no backward"):
        msda.ms_deform_attn_core(value, [(2, 4)], loc, attn, sample_mode=mode)
    with _CardRoute(), torch.no_grad(), pytest.raises(RuntimeError):  # the card route
        msda.ms_deform_attn_core(value, [(2, 4)], loc, attn, sample_mode=mode)


def test_int8_under_grad_reaches_its_function_off_the_cpu(monkeypatch):
    """The int8 table trains as JAX's does (the exact bilinear backward on the
    saved value): under grad off the CPU it is not refused but goes through its
    op's autograd to the quantize kernel (the library loader, stubbed)."""
    def refuse(name):
        raise _Sentinel(name)

    monkeypatch.setattr(_build, "load", refuse)
    value, loc, attn = _meta_requiring_grad((1, 8, 2, 4), (1, 3, 2, 1, 2, 2), (1, 3, 2, 1, 2))
    with _CardRoute(), pytest.raises(_Sentinel, match="ms_deform_attn"):
        msda.ms_deform_attn_core(value, [(2, 4)], loc, attn, quantize_table=True)


@pytest.mark.parametrize("mode", ["nearest_top1", "nearest_top2c", "shared", "int8"])
def test_approximate_modes_take_the_card_route_off_the_cpu(monkeypatch, mode):
    """Tensors that are not on the CPU go to the new kernels (the library
    loader, stubbed), never to the plain versions."""
    def refuse(name):
        raise _Sentinel(name)

    monkeypatch.setattr(_build, "load", refuse)
    value = torch.zeros(1, 8, 2, 4, device="meta")
    loc, attn = torch.zeros(1, 3, 2, 1, 2, 2, device="meta"), torch.zeros(1, 3, 2, 1, 2,
                                                                          device="meta")
    kw = dict(sample_mode="bilinear", quantize_table=True) if mode == "int8" else dict(
        sample_mode=mode)
    with _CardRoute(), pytest.raises(_Sentinel, match="ms_deform_attn"):
        msda.ms_deform_attn_core(value, [(2, 4)], loc, attn, **kw)


def test_approximate_modes_stay_off_the_cpu(monkeypatch):
    """CPU tensors take the plain versions in every mode and both score tails:
    no library is loaded and no launch is counted."""
    from multishiftseg_torch.ops import launch_counts, reset_launch_counts

    def refuse(name):
        raise _Sentinel(name)

    monkeypatch.setattr(_build, "load", refuse)
    reset_launch_counts()
    value, loc, attn = (torch.from_numpy(t) for t in _msda_inputs(
        np.random.RandomState(24), LEVEL_SETS["regular"], 8))
    for mode in ("nearest_top2", "nearest_top2c", "shared"):
        msda.ms_deform_attn_core(value, LEVEL_SETS["regular"], loc, attn, mode)
    msda.ms_deform_attn_core(value, LEVEL_SETS["regular"], loc, attn, quantize_table=True)
    masks, probs, _ = _tail_case(np.random.RandomState(25))
    cls = torch.randn(2, 6, 20)
    scores.anomaly_score_lowres(cls, masks, (64, 80))
    scores.anomaly_score_topq(cls, masks, (64, 80), 3)
    assert all(v == 0 for v in launch_counts().values())


class _Sentinel(Exception):
    pass


def test_new_kernels_take_the_card_route_off_the_cpu(monkeypatch):
    """Tensors that are not on the CPU go to the kernels (here: to the library
    loader, stubbed), never to the plain versions."""
    def refuse(name):
        raise _Sentinel(name)

    monkeypatch.setattr(_build, "load", refuse)
    x = torch.zeros(1, 4, 5, 8, device="meta")
    k = torch.zeros(3, 3, 8, 8, device="meta", requires_grad=True)
    with _CardRoute(), pytest.raises(_Sentinel, match="dilated_conv"):
        dconv.dilated_conv3x3(x, k, 12)
    v = torch.zeros(16, device="meta", requires_grad=True)
    with pytest.raises(_Sentinel, match="bottom_k"):
        rcl._bottom_k_sum(v, torch.zeros(16, device="meta"),
                          torch.zeros((), dtype=torch.int32, device="meta"))
    with pytest.raises(_Sentinel, match="bottom_k"):
        rcl.bottom_k_sum_global(v, torch.zeros(16, device="meta"),
                                torch.zeros((), dtype=torch.int32, device="meta"))
    criterion._LP_ENTRIES.clear()
    lab, xy = torch.zeros(2, 5, 6, device="meta"), torch.zeros(2, 8, 2, device="meta")
    with pytest.raises(_Sentinel, match="label_points"):
        criterion.sample_target_points(lab, xy, 3)
    with pytest.raises(_Sentinel, match="label_points"):
        criterion.sample_class_points(lab, xy, torch.zeros(2, device="meta"))
    masks, probs = torch.zeros(1, 4, 3, 5, device="meta"), torch.zeros(1, 4, 6, device="meta")
    with _CardRoute(), pytest.raises(_Sentinel, match="mask_scores"):
        scores.mask_scores_backward(masks, probs, torch.zeros(1, 6, 10, device="meta"),
                                    (6, 10), dmask=True)
    s_, l_ = torch.zeros(16, device="meta"), torch.zeros(16, dtype=torch.int32, device="meta")
    with pytest.raises(_Sentinel, match="ood_hist"):
        ood_metrics.masked_min_max(s_, l_)
    with pytest.raises(_Sentinel, match="ood_hist"):
        ood_metrics.label_histograms(s_, l_, torch.zeros((), device="meta"),
                                     torch.ones((), device="meta"), 8)
    with pytest.raises(_Sentinel, match="ood_hist"):
        ood_metrics.range_histograms(s_, l_, 8)
    with pytest.raises(_Sentinel, match="ood_hist"):
        ood_metrics.BinnedOODMeter(num_bins=8).update(s_, l_)


def test_label_quads_plain_holds_the_corner_labels():
    """The plain pack's word (qy, qx) holds the codes of the 2x2 block at
    pixel (qx - 1, qy - 1), in JAX's corner order: a label in [0, 254] as
    itself, anything else and a corner off the map as 255; rows padded to a
    multiple of 4 words."""
    rng = np.random.RandomState(14)
    labels = rng.choice([-1, 0, 7, 254, 255, 256], (2, 6, 9)).astype(np.int32)
    quads = criterion.label_quads_plain(torch.from_numpy(labels)).numpy().view(np.uint32)
    assert quads.shape == (2, 7, 12)

    def code(b, x, y):
        if not (0 <= x < 9 and 0 <= y < 6):
            return 255
        lab = labels[b, y, x]
        return int(lab) if 0 <= lab < 255 else 255

    for b in range(2):
        for qy in range(7):
            for qx in range(12):
                x0, y0 = qx - 1, qy - 1
                want = [code(b, x0, y0), code(b, x0 + 1, y0), code(b, x0, y0 + 1),
                        code(b, x0 + 1, y0 + 1)]
                word = int(quads[b, qy, qx])
                assert [(word >> (8 * q)) & 255 for q in range(4)] == want, (b, qy, qx)


def test_label_point_bound_counts_the_code_words_read():
    """``chip_smoke.code_word_index`` finds the word that holds each point's
    four corners (their codes, 255 off the map) wherever a corner is on the
    map, and ``code_sector_bytes`` counts each 32-byte sector of those words
    once."""
    rng = np.random.RandomState(15)
    labels = torch.from_numpy(rng.randint(-1, 5, (3, 10, 21)).astype(np.int32))
    quads = criterion.label_quads_plain(labels)
    coords = torch.from_numpy((rng.rand(6, 80, 2) * 1.4 - 0.2).astype(np.float32))
    maps = torch.tensor([0, 0, 1, 2, 2, 2])
    idx, reads = chip_smoke.code_word_index(labels, quads, coords, maps)
    cl, _ = criterion._corner_gather_labels(labels[maps], coords)
    codes = torch.where((cl >= 0) & (cl < 255), cl, torch.full_like(cl, 255))
    words = torch.take(quads, idx).view(-1)
    got = torch.stack([(words >> (8 * q)) & 255 for q in range(4)], -1).view(codes.shape)
    assert bool(reads.any()) and not bool(reads.all())
    assert torch.equal(got[reads], codes[reads])
    assert bool((codes[~reads] == 255).all())
    sectors = {int(i) // 8 for i in idx[reads]}
    assert chip_smoke.code_sector_bytes(torch, labels, quads, coords, maps) == 32 * len(sectors)


def test_global_bottom_k_route_is_four_launches_and_three_all_reduces(monkeypatch):
    """The global route's host sequence (its entries stubbed, meta tensors):
    round 0, its histogram all-reduced, round 1, its histogram all-reduced,
    the fold, its f64 sums and counts all-reduced, the result; one launch
    counted."""
    import contextlib

    calls = []

    def entry(name):
        return lambda *a: (calls.append((name, a[4] if name == "round" else None)), 0)[1]

    lay = rcl.GlobalLayout(h0=8, bins0=4096, h1=4104, bins1=4096, fold=8200, fold_len=514,
                           words=8200 + 2 * 514 * 3)
    kern = rcl._Kernel(forward=None, backward=None, global_round=entry("round"),
                       global_fold=entry("fold"), global_result=entry("result"), max_blocks=132,
                       stage_words=0, scratch_words=0, global_blocks=16, global_layout=lay)
    monkeypatch.setattr(rcl, "_kernel", lambda dev: kern)
    monkeypatch.setattr(rcl, "launch_device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: 0, raising=False)
    monkeypatch.setattr(rcl.dist, "all_reduce",
                        lambda t: calls.append(("all_reduce", (t.numel(), t.dtype))))
    before = rcl.LAUNCHES["bottom_k_sum_global"]
    v = torch.zeros(100, device="meta")
    rcl.bottom_k_sum_global_cuda(v, v, torch.zeros((), dtype=torch.int32, device="meta"))
    assert calls == [("round", 0), ("all_reduce", (4096, torch.int32)), ("round", 1),
                     ("all_reduce", (4096, torch.int32)), ("fold", None),
                     ("all_reduce", (514, torch.float64)), ("result", None)]
    assert rcl.LAUNCHES["bottom_k_sum_global"] == before + 1


def test_new_kernels_stay_off_the_cpu(monkeypatch):
    """CPU tensors take the plain versions: no library is loaded and no
    launch is counted."""
    from multishiftseg_torch.ops import launch_counts, reset_launch_counts

    def refuse(name):
        raise _Sentinel(name)

    monkeypatch.setattr(_build, "load", refuse)
    reset_launch_counts()
    masks, probs, g = _tail_case(np.random.RandomState(17))
    scores.mask_scores_backward(masks, probs, g, tuple(g.shape[1:]), dmask=True)
    c = torch.zeros(2, 6, 20, requires_grad=True)
    scores.anomaly_score_upsampled(c, masks, tuple(g.shape[1:])).sum().backward()
    meter = ood_metrics.BinnedOODMeter()
    lab = np.random.RandomState(0).randint(0, 2, (40, 30))
    meter.update(torch.rand(40, 30), lab)
    meter.update(torch.rand(50, 40)[:40, :30], torch.from_numpy(lab))
    assert meter.compute() is not None
    ood_metrics.range_histograms(torch.rand(64), torch.zeros(64, dtype=torch.int32), 16)
    ood_metrics.binned_ood_metrics(torch.rand(64), torch.zeros(64, dtype=torch.int32), 16)
    assert all(v == 0 for v in launch_counts().values())


@pytest.mark.parametrize("case", sorted(forward_ab.CASES))
def test_forward_ab_cases_run_the_main_path_shapes(case):
    """The A/B tool times each kernel at ``chip_smoke.py``'s pyramids, heads
    and points, the forward staging what the wrapper stages there: level 0 of
    a bf16 table at eval, levels 0-1 at training, none for an f32 table,
    30-channel rows, ``nearest``, ``shared`` or the quantize."""
    levels, images, dtype, d, kind = forward_ab.CASES[case]
    assert levels in (chip_smoke.LEVELS, chip_smoke.TRAIN_LEVELS)
    assert (forward_ab.HEADS, forward_ab.POINTS) == (chip_smoke.N_HEADS, chip_smoke.N_POINTS)
    assert kind in ("bilinear", "nearest", "shared", "quantize")
    table = torch.empty((1, sum(h * w for h, w in levels), forward_ab.HEADS, d), dtype=dtype)
    want = {"bf16_bilinear_eval": 1, "bf16_bilinear_train": 2}.get(case, 0)
    if kind in ("bilinear", "nearest"):
        assert msda.forward_staged_levels(table, levels, kind == "nearest") == want
    else:
        assert want == 0


@pytest.mark.parametrize("case", ["bf16_shared_eval", "bf16_quantize_eval",
                                  "f32_quantize_eval"])
def test_forward_ab_new_cases_take_chip_smoke_inputs(case):
    """``shared`` and the quantize are timed on the eval rows of
    ``chip_smoke.py``'s ``kernels`` phase: one 1024x2048 image, 8 heads of 32
    channels, the query per table row, bf16 (f32 for the quantize too)."""
    levels, images, dtype, d, kind = forward_ab.CASES[case]
    assert (levels, images, d) == (chip_smoke.LEVELS, 1, chip_smoke.HEAD_DIM)
    assert kind == case.split("_")[1]
    assert dtype == (torch.float32 if case.startswith("f32") else torch.bfloat16)


def test_forward_ab_ptxas_summary():
    """Each tree's build reports every kernel entry's registers and spill
    stores from nvcc's ``-Xptxas -v`` log; a function that is no entry adds
    no line."""
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z17msda_shared_kernelILi8EEvPKv' for 'sm_90a'
ptxas info    : Function properties for _Z17msda_shared_kernelILi8EEvPKv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 432 bytes cmem[0]
ptxas info    : Function properties for helper
    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function 'msda_quantize_kernel' for 'sm_90a'
ptxas info    : Function properties for msda_quantize_kernel
    104 bytes stack frame, 104 bytes spill stores, 96 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 400 bytes cmem[0]
"""
    assert forward_ab.ptxas_summary(log) == [
        "_Z17msda_shared_kernelILi8EEvPKv: 64 registers, 0 spill bytes",
        "msda_quantize_kernel: 40 registers, 104 spill bytes"]


def test_forward_ab_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        forward_ab.main(["--trees", str(REPO)])


@pytest.mark.parametrize("case", ["eval_bf16", "train_bf16", "eval_f32", "train_f32",
                                  "d6_bf16", "tight_budget"])
def test_staged_levels_choice(case):
    """The bilinear forward stages, from the coarsest level, the levels whose
    rows of one head fit in a block's shared memory: level 0 at the eval
    shapes in bf16 (128 KB), levels 0-1 at the training shapes (151 KB), none
    in f32 at the eval shapes (level 0 alone is 256 KB), none when a row is no
    whole number of 16-byte pieces."""
    eval_levels = chip_smoke.LEVELS
    train_levels = chip_smoke.TRAIN_LEVELS
    shapes, d, dtype, budget, want = {
        "eval_bf16": (eval_levels, 32, torch.bfloat16, msda.SMEM_BUDGET, 1),
        "train_bf16": (train_levels, 32, torch.bfloat16, msda.SMEM_BUDGET, 2),
        "eval_f32": (eval_levels, 32, torch.float32, msda.SMEM_BUDGET, 0),
        "train_f32": (train_levels, 32, torch.float32, msda.SMEM_BUDGET, 1),
        "d6_bf16": (train_levels, 6, torch.bfloat16, msda.SMEM_BUDGET, 0),
        "tight_budget": (train_levels, 32, torch.bfloat16, 22 * 22 * 64, 1),
    }[case]
    assert msda.staged_levels(shapes, d, dtype, budget) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_at_staged_shapes_stay_off_the_kernel(monkeypatch, dtype):
    """At shapes whose levels the card would stage, CPU tensors still take the
    plain bilinear version: no library is loaded and no launch is counted."""
    from multishiftseg_torch.ops import launch_counts, reset_launch_counts

    def refuse(name):
        raise _Sentinel(name)

    monkeypatch.setattr(_build, "load", refuse)
    reset_launch_counts()
    shapes = STAGING_LEVELS[2]
    assert msda.staged_levels(shapes, 32, dtype) == 2
    value, loc, attn = (torch.from_numpy(t) for t in _msda_inputs(
        np.random.RandomState(26), shapes, 32))
    out = msda.ms_deform_attn_core(value.to(dtype), shapes, loc, attn.to(dtype))
    assert out.shape == (N, LQ, M * 32) and out.dtype == dtype
    assert all(v == 0 for v in launch_counts().values())


def _imported_modules(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def test_port_and_chip_smoke_import_no_jax():
    pkg = REPO / "multishiftseg_torch"
    files = sorted(f for f in pkg.rglob("*.py") if "build" not in f.relative_to(pkg).parts)
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for name in _imported_modules(f):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "optax", "multishiftseg_tpu",
                                "tools"), (f, name)


# ---------------------------------------------------------------------------
# the custom ops (``ops/library.py``) on the card


def _op_case(name, dev):
    """(op, args on ``dev``, the same args on the CPU, the launch counters the
    op's CUDA implementation adds to, tolerance of scale) for ``name``."""
    g = np.random.RandomState(41)
    t = lambda *s: torch.from_numpy(g.rand(*s).astype(np.float32))
    levels = [6, 8, 3, 4]  # S = 60
    value, loc, attn = t(2, 60, 2, 32), t(2, 9, 2, 2, 4, 2), t(2, 9, 2, 2, 4)
    masks, probs = 4 * t(2, 5, 8, 10) - 2, t(2, 5, 6)
    x, kernel = t(1, 20, 24, 16), t(3, 3, 16, 8) - 0.5
    ops = torch.ops.mss
    cases = {
        "ms_deform_attn": (ops.ms_deform_attn, (value, loc, attn, levels, False),
                           {"ms_deform_attn_bilinear": 1}, 1e-5),
        "ms_deform_attn_backward": (ops.ms_deform_attn_backward,
                                    (value, loc, attn, t(2, 9, 64), levels),
                                    {"ms_deform_attn_bilinear_backward": 1}, 1e-4),
        "ms_deform_attn_quantize": (ops.ms_deform_attn_quantize, (value,),
                                    {"ms_deform_attn_quantize": 1}, 0.0),
        "ms_deform_attn_int8_table": (ops.ms_deform_attn_int8_table,
                                      (value, loc, attn, levels),
                                      {"ms_deform_attn_quantize": 1, "ms_deform_attn_int8": 1},
                                      1e-5),
        "ms_deform_attn_approx": (ops.ms_deform_attn_approx,
                                  (value, loc, attn, levels, "shared", 0),
                                  {"ms_deform_attn_shared": 1}, 1e-5),
        "mask_scores": (ops.mask_scores, (masks, probs, t(2, 5), [17, 23], scores._SEMANTIC),
                        {"mask_scores_semantic": 1}, 1e-5),
        "mask_scores_backward": (ops.mask_scores_backward,
                                 (masks, probs, t(2, 17, 23), [17, 23], True),
                                 {"mask_scores_backward": 1}, 1e-4),
        "dilated_conv3x3": (ops.dilated_conv3x3, (x, kernel, 6), {"dilated_conv3x3": 1}, 1e-5),
        "dilated_conv3x3_backward": (ops.dilated_conv3x3_backward,
                                     (x, kernel, t(1, 20, 24, 8), 6, True, True),
                                     {"dilated_conv3x3": 1, "dilated_conv3x3_wgrad": 1}, 1e-5),
    }
    op, args, counters, tol = cases[name]
    on = lambda a: a.to(dev) if isinstance(a, torch.Tensor) else a
    return op, tuple(on(a) for a in args), args, counters, tol


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ms_deform_attn", "ms_deform_attn_backward",
                                  "ms_deform_attn_quantize", "ms_deform_attn_int8_table",
                                  "ms_deform_attn_approx", "mask_scores",
                                  "mask_scores_backward", "dilated_conv3x3",
                                  "dilated_conv3x3_backward"])
def test_custom_op_on_the_card_matches_its_plain_version(cuda, name):
    """Each ``mss::`` op on CUDA tensors launches its kernel (its counters
    move) and equals the same op on the CPU (the plain version), f32: within
    1e-5 of scale (sums in another order; 1e-4 for the backwards, whose atomics
    and per-block partials sum in a run-dependent order), the quantize bit for
    bit."""
    from multishiftseg_torch.ops import launch_counts, library

    assert name in library.OPS
    op, args, cpu_args, counters, tol = _op_case(name, cuda)
    before = launch_counts()
    got = op(*args)
    torch.cuda.synchronize()
    after = launch_counts()
    assert {k: after[k] - before[k] for k in counters} == counters
    want = op(*cpu_args)
    got, want = (got, want) if isinstance(got, (tuple, list)) else ((got,), (want,))
    for a, b in zip(got, want):
        assert a.device.type == "cuda" and a.dtype == b.dtype and a.shape == b.shape
        a, b = a.cpu().float(), b.float()
        assert (a - b).abs().max() <= tol * max(float(b.abs().max()), 1e-6)
