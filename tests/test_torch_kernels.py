"""PyTorch port: the CUDA kernels against their plain PyTorch versions on the card,
and the port's card-only guards.

The kernel tests carry the ``cuda`` marker: they need a CUDA device and skip
without one (``-m cuda`` selects them). The rest run on the CPU. The file imports
neither JAX nor the JAX package, so it also runs where JAX is not installed:
``python -m pytest --noconftest tests/test_torch_kernels.py`` (the suite's
``conftest.py`` imports JAX).
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from multishiftseg_torch import _build
from multishiftseg_torch.evals import ood_metrics
from multishiftseg_torch.losses import criterion, matcher, rcl
from multishiftseg_torch.ops import dilated_conv as dconv
from multishiftseg_torch.ops import ms_deform_attn as msda
from multishiftseg_torch.ops import scores

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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 19, 100), (3, 5, 8), (2, 1, 1), (2, 7, 300)])
def test_assignment_kernel_matches_plain(cuda, shape):
    """Rows at BIG (ties everywhere) included; the same assignment exactly."""
    rng = np.random.RandomState(4)
    cost = rng.rand(*shape).astype(np.float32)
    cost[rng.rand(*shape[:2]) > 0.5] = matcher.BIG
    c = torch.from_numpy(cost).to(cuda)
    got = matcher.linear_sum_assignment(c)
    want = matcher.linear_sum_assignment_plain(c)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want.cpu())


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


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ties", "zero", "one", "all", "large"])
def test_bottom_k_kernel_matches_plain(cuda, case):
    """The radix select finds the binary search's threshold bit for bit; the
    sum within f32 rounding; the gradient weights exactly."""
    rng = np.random.RandomState(7)
    n = 3_000_017 if case == "large" else 5003
    vals = (np.floor(rng.rand(n) * 64) / 16).astype(np.float32)  # many ties
    if case == "large":
        vals = rng.gamma(1.0, 2.0, n).astype(np.float32)
    valid = rng.rand(n) > 0.2
    keyed = np.where(valid, vals, np.inf).astype(np.float32)
    count = int(valid.sum())
    k = {"ties": int(0.8 * count), "zero": 0, "one": 1, "all": count,
         "large": int(0.8 * count)}[case]
    sn = torch.tensor(k, dtype=torch.int32, device=cuda)
    kt = torch.from_numpy(keyed).to(cuda)
    sums, grads = [], []
    for fn in (rcl._bottom_k_sum, rcl.bottom_k_sum_plain):
        v = torch.from_numpy(vals).to(cuda).requires_grad_()
        out = fn(v, kt, sn)
        out.backward(torch.tensor(1.5, device=cuda))
        sums.append(float(out.detach()))
        grads.append(v.grad)
    _, _, work, result = rcl.bottom_k_sum_cuda(torch.from_numpy(vals).to(cuda), kt, sn)
    torch.cuda.synchronize()
    bits = np.sort(keyed.view(np.uint32))
    want_t = 0 if k <= 0 else int(bits[k - 1])
    assert int(work[257].item()) & 0xFFFFFFFF == want_t
    np.testing.assert_allclose(sums[0], sums[1], rtol=1e-6, atol=1e-6)
    assert torch.equal(grads[0], grads[1])


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
    nan = s.copy()
    nan[rng.randint(0, n, 3)] = np.nan  # a NaN score: the range is NaN, as JAX's
    yield "nan", nan, np.zeros(n, np.int32), None


@pytest.mark.cuda
def test_ood_hist_kernels_equal_plain(cuda):
    """The masked range and the histograms (8192 bins) equal the plain
    versions bit for bit."""
    rng = np.random.RandomState(14)
    for name, s, lab, given in _hist_cases(rng):
        st, lt = torch.from_numpy(s), torch.from_numpy(lab)
        lo_p, hi_p = ood_metrics.masked_min_max_plain(st, lt)
        lo_k, hi_k = ood_metrics.masked_min_max(st.to(cuda), lt.to(cuda))
        np.testing.assert_array_equal([float(lo_k), float(hi_k)], [float(lo_p), float(hi_p)],
                                      err_msg=name)
        if not np.isfinite(float(lo_p)) or not np.isfinite(float(hi_p)):
            continue
        lo, hi = given or (lo_p, hi_p)
        want = ood_metrics.label_histograms_plain(st, lt, lo, hi, 8192)
        got = ood_metrics.label_histograms(st.to(cuda), lt.to(cuda),
                                           torch.as_tensor(lo).to(cuda),
                                           torch.as_tensor(hi).to(cuda), 8192)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b), name


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
    with pytest.raises(_Sentinel, match="mask_scores"):
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
    with torch.no_grad(), pytest.raises(RuntimeError):  # to the card route, which fails on meta
        msda.ms_deform_attn_core(value, [(2, 4)], loc, attn, sample_mode=mode)


def test_int8_under_grad_reaches_its_function_off_the_cpu(monkeypatch):
    """The int8 table trains as JAX's does (the exact bilinear backward on the
    saved value): under grad off the CPU it is not refused but goes through its
    autograd Function to the quantize kernel (the library loader, stubbed)."""
    def refuse(name):
        raise _Sentinel(name)

    monkeypatch.setattr(_build, "load", refuse)
    value, loc, attn = _meta_requiring_grad((1, 8, 2, 4), (1, 3, 2, 1, 2, 2), (1, 3, 2, 1, 2))
    with pytest.raises(_Sentinel, match="ms_deform_attn"):
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
    with pytest.raises(_Sentinel, match="ms_deform_attn"):
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
    with pytest.raises(_Sentinel, match="dilated_conv"):
        dconv.dilated_conv3x3(x, k, 12)
    v = torch.zeros(16, device="meta", requires_grad=True)
    with pytest.raises(_Sentinel, match="bottom_k"):
        rcl._bottom_k_sum(v, torch.zeros(16, device="meta"),
                          torch.zeros((), dtype=torch.int32, device="meta"))
    masks, probs = torch.zeros(1, 4, 3, 5, device="meta"), torch.zeros(1, 4, 6, device="meta")
    with pytest.raises(_Sentinel, match="mask_scores"):
        scores.mask_scores_backward(masks, probs, torch.zeros(1, 6, 10, device="meta"),
                                    (6, 10), dmask=True)
    s_, l_ = torch.zeros(16, device="meta"), torch.zeros(16, dtype=torch.int32, device="meta")
    with pytest.raises(_Sentinel, match="ood_hist"):
        ood_metrics.masked_min_max(s_, l_)
    with pytest.raises(_Sentinel, match="ood_hist"):
        ood_metrics.label_histograms(s_, l_, torch.zeros((), device="meta"),
                                     torch.ones((), device="meta"), 8)


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
    meter.update(torch.rand(40, 30), np.random.RandomState(0).randint(0, 2, (40, 30)))
    assert meter.compute() is not None
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
