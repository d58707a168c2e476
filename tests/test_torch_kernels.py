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

from multishiftseg_torch import _build
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
    loc = rng.rand(N, LQ, M, len(shapes), P, 2).astype(np.float32) * 1.2 - 0.1
    # keep points 1e-3 px away from the half-pixel rounding boundaries, where
    # grid_sample's round-half-even and the kernel's floor(x + 0.5) may disagree
    size = np.array([[w, h] for h, w in shapes], np.float32)[None, None, None, :, None, :]
    px = loc * size - 0.5
    near = np.abs(px - np.floor(px) - 0.5) < 1e-3
    loc = np.where(near, (px + 2e-3 + 0.5) / size, loc).astype(np.float32)
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


def _off_kinks(loc, shapes, margin=1e-3):
    """Move points ``margin`` px away from integer pixel positions, where the
    backward's location slope is one-sided and the two versions may take other
    sides after rounding."""
    size = np.array([[w, h] for h, w in shapes], np.float32)[None, None, None, :, None, :]
    px = loc * size - 0.5
    near = np.abs(px - np.round(px)) < margin
    return np.where(near, (px + 2 * margin + 0.5) / size, loc).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 6, 40])  # one channel a lane; partial lanes; 2 chunks
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("levels", sorted(LEVEL_SETS))
def test_ms_deform_attn_backward_kernel_matches_plain(cuda, dtype, levels, d):
    rng = np.random.RandomState(2)
    shapes = LEVEL_SETS[levels]
    value, loc, attn = _msda_inputs(rng, shapes, d)
    loc = _off_kinks(loc, shapes)
    g = rng.randn(N, LQ, M * d).astype(np.float32)
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
# W, odd sizes, channel counts off the 8 / 32 / 128 tiles, taps wholly outside
DCONV_CASES = [(2, 9, 30, 40, 24, 12), (1, 5, 7, 16, 8, 12), (2, 13, 29, 20, 5, 24),
               (1, 40, 70, 136, 136, 12), (3, 20, 20, 8, 16, 36), (1, 33, 17, 264, 256, 24)]


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


# ---------------------------------------------------------------------------
# on the CPU: guards that stop a card run from silently losing gradients


def _meta_requiring_grad(*shapes, dtype=torch.float32):
    """Tensors that are not on the CPU, so the wrappers take their card route,
    without needing a card."""
    return [torch.zeros(s, device="meta", dtype=dtype).requires_grad_() for s in shapes]


def test_score_tail_refuses_grad_off_the_cpu():
    cls, masks = _meta_requiring_grad((1, 4, 6), (1, 4, 3, 5))
    with pytest.raises(RuntimeError, match="no backward"):
        scores.anomaly_score_upsampled(cls, masks, (6, 10))
    with pytest.raises(RuntimeError, match="no backward"):
        scores.semantic_inference_upsampled(cls, masks, (6, 10), num_classes=5)


def test_nearest_refuses_grad_off_the_cpu():
    value, loc, attn = _meta_requiring_grad((1, 8, 2, 4), (1, 3, 2, 1, 2, 2), (1, 3, 2, 1, 2))
    with pytest.raises(RuntimeError, match="no backward"):
        msda.ms_deform_attn_core(value, [(2, 4)], loc, attn, "nearest")


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
            assert root not in ("jax", "jaxlib", "flax", "optax", "multishiftseg_tpu"), (f, name)
