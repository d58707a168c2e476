#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``multishiftseg_torch``) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one CUDA
device and ``nvcc``; without a device, or without the package beside it, it
exits non-zero and prints no result. Phases, one JSON line each:

1. ``build``: compile every ``multishiftseg_torch/csrc/*.cu`` with nvcc for
   sm_90a, all sources at once, into the package's git-ignored ``build/``.
2. ``kernels``: each kernel entry point at the main-path shapes (Mask2Former R-50,
   1024x2048, batch 1) against its plain PyTorch version on the same inputs, with
   a stated tolerance; plus small inputs with a degenerate h == 1 level and with
   points outside the map. Median time of kernel and plain version, and the
   bound (the larger of bytes over 3.35 TB/s and f32 operations over
   67 TFLOP/s, counted from this run's inputs).
3. ``slice_parity``: the port's MaskFormer at full widths and a reduced image,
   in f32 with TF32 off, on the card (kernels) against the same weights on the
   CPU (plain versions).
4. ``serve``: ``build_m2f_request_forward`` on the full-width R-50 model in
   bf16 with 1024x2048 uint8 images made from a seed, 3 requests after warm-up
   in each setting of ``SERVE_SETTINGS`` (``bilinear``, ``nearest``, ``int8``,
   ``nearest_top6``, ``nearest_top6c``, ``shared``, a bilinear / nearest_top6c
   hybrid, ``nearest`` with ``score_lowres`` and with ``score_topq=32``), with
   the kernel launch counts of those requests (the setting's deformable
   entries, 6 a request, 3 + 3 for the hybrid, 6 quantize launches more for
   int8; one anomaly tail, on 32 queries for topq and at the identity resize
   for lowres; one semantic tail; nothing else), one profiled request and the
   OOD metrics of a synthetic label map (random weights: their values mean
   nothing).
5. ``train_parity``, once per seed of ``TRAIN_PARITY_SEEDS``: one stage-2 step
   of ``TrainM2FOOD`` (exps/m2f.yaml) at full widths on 2 pairs of 256x256
   crops, f32 with TF32 off, on the card (kernels) and on the CPU (plain
   versions) from the same weights, batch and CPU-made draws: the pixel
   decoder's outputs, the attention masks, the assignment, loss components,
   gradients per parameter group (both f32 steps against a float64 step on the
   CPU) and updated parameters.
6. ``train``: the stage-2 step at exps/m2f.yaml's settings (8 pairs of 700x700
   crops padded to 704, bf16 autocast, f32 master weights): 2 warm-up and 3
   timed steps, with the launch counts of the timed steps, the losses, the
   gradient norm, peak memory and one profiled step.

7. ``deeplab_parity``: the port's DeepLab v3+ WRN-38 at full widths and a
   256x512 image, in f32 with TF32 off, on the card (kernels) against the same
   weights on the CPU (plain versions): trunk output, score and logits.
8. ``deeplab_serve``: ``build_deeplab_forward`` at 1024x2048, batch 1, bf16
   autocast over f32 weights, 3 requests after 2 warm-up, with their launch
   counts (3 dilated convs a request, no other kernel) and one profiled request.
9. ``deeplab_train_parity``, once per seed of ``DL_TRAIN_PARITY_SEEDS``: one
   stage-0 and then one stage-1 step of ``TrainDeepLabOOD`` (exps/deeplab.yaml)
   at full widths on 2 pairs of 200x200 crops, f32 with TF32 off, card against
   CPU from the same weights, batch and CPU-made draws (RCL noise and dropout
   masks): losses, running statistics, updates, the frozen parameters, and the
   card's trainable gradients against a float64 CPU step (in stage 1 one that
   follows the card's ReLU branches), with the ReLU and pixel-selection flips
   between the f32 and float64 steps counted.
10. ``deeplab_train``: stage 0 and then stage 1 at exps/deeplab.yaml's settings
   (8 pairs of 700x700 crops, bf16 autocast, f32 master weights), each with 2
   warm-up and 3 timed steps, their launch counts and one profiled step.
11. ``stage1_parity``: one M2F stage-1 step (RCL on the anomaly score, Adam
   over ``class_embed2``) at full widths on 2 pairs of 256x256, f32 with TF32
   off, card against CPU from the same weights, batch and CPU-made RCL noise,
   the CPU attending with the card's attention masks: losses, the gradient
   against a float64 CPU step, the Adam update, every other parameter unchanged.
12. ``stage1_train``: stage 1 at exps/m2f.yaml's settings (8 pairs of 700x700
   padded to 704, bf16): 2 warm-up and 3 timed steps, launch counts, peak
   memory, one profiled step; then ``set_stage(1)`` and one stage-2 step.
13. ``validate``: ``TrainM2FOOD.valid`` and ``TrainDeepLabOOD.valid`` over 10
   in-memory images (6 at 720x1280, 4 at 1024x2048: two buckets), labels
   0/1/255: seconds per image, and the binned metrics against the exact ones
   on the same maps, within 2/8192.
14. ``evaluate``: the eval CLI (``test_runner.main``) for ``--model m2f`` and
   ``--model deeplab`` on a temporary RoadAnomaly21-layout folder (4 jpg
   images of 720x1280 with their label pngs) named in a temporary YAML, with
   a detectron2-style checkpoint of the seeded model and ``--save_outputs``;
   then the CLI with ``--sample_mode nearest_top6c --score_topq 32``, and
   ``multishiftseg_torch.tools.validate_release.qualify_sampling_modes`` over
   its six settings on the same folder against the ``bilinear`` run, writing
   the artifact, after which the gate must refuse exactly the settings
   recorded unqualified.

``slice_parity`` and ``train_parity`` run the CPU's decoder on the card's
attention masks, and hold every bit that differs to a logit within rounding of 0.

The ``kernels`` phase also holds the training slice's kernels at its shapes
(16 images at 704x704): the deformable-attention backward and the bilinear
forward (a row of its own beside the eval shapes'), the batched
assignment (and scipy's optimum on the valid rows) and the label points; and
DeepLab's: the ASPP's dilated conv at the eval shapes (its three rates timed
together, beside cuDNN's dilated ``conv2d`` in benchmark mode, channels-last
and NCHW) and at the training shapes (a row of its own, beside cuDNN's), its
weight gradient at the training shapes (beside cuDNN's), each with its
achieved TFLOP/s (the build line carries their registers and spills), and
the pixel selection, forward and backward, over 8 x 700 x 700 values, their
bounds at the bf16 tensor-core peak (989 TFLOP/s) where the tensor cores do
the work (the DeepLab profiles give the dilated conv's device time); stage
1's and validation's: the two forward score tails at
stage 1's shapes (the anomaly score, and the K class channels alone), the
anomaly tail's backward there (d probs alone, and with d masks) and with
forced ties, and
the binned metrics' masked range and 8192-bin histogram at 720x1280 and
1024x2048 (bit-for-bit equal to the plain versions); and the eval fast
paths' at the main-path shapes: the int8 table's quantize (bit for bit) and
forward, ``nearest_top6``, ``nearest_top6c`` and ``shared`` (the centroid modes
held off their rounding boundaries, flips counted), with f32 edge cases
(degenerate levels with 30 channels and points outside the map, all-equal
weights, T = J against ``nearest``). A kernel's ``launches``
are those of the main paths: ``serve``, ``deeplab_serve``, ``validate`` and
``evaluate`` for the eval kernels, the timed steps of ``train``,
``deeplab_train`` and ``stage1_train`` for the training kernels (the dilated
conv's and the bilinear deformable forward's rows split them: eval paths,
training steps), each path run
with the counts set to 0 just before it and read just after.

Then the ``{"kernels": [...]}`` line, the card's name and power limit as
``nvidia-smi`` gives them, and as the last line ``{"ok": true, "device": ...}``
when every check passed. Any failed check exits 1 without that line.
"""

import contextlib
import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

H, W = 1024, 2048
# main-path pyramid of the deformable encoder (strides 32, 16, 8 of 1024x2048)
LEVELS = [(H // 32, W // 32), (H // 16, W // 16), (H // 8, W // 8)]
N_HEADS, HEAD_DIM, N_POINTS = 8, 32, 4
QUERIES, CLASSES = 100, 19
# the stage-2 step (exps/m2f.yaml): 8 pairs of 700x700 crops padded to 704x704
TRAIN_PAIRS, CROP, TRAIN_HW = 8, (700, 700), (704, 704)
TRAIN_LEVELS = [(22, 22), (44, 44), (88, 88)]
TRAIN_POINTS = 12544
SEED = 0
# train_parity's weight and batch seeds: the gradient limit rests on several
TRAIN_PARITY_SEEDS = tuple(SEED + 10 * k for k in range(1, 7))
# A mask logit sums mask_dim (256) f32 products of inputs that carry every
# card-vs-CPU difference upstream; the logits agree "within rounding" where
# their difference is at most LOGIT_RTOL of the absolute scale
# sum_c |embed_c| |feature_c|, about 7x the worst-case rounding error of one
# 256-term f32 sum (256 x 2^-24 = 1.5e-5 of that scale)
LOGIT_RTOL = 1e-4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # H100 SXM data sheet, f32 outside the tensor cores
BF16_TC_OPS_PER_S = 989e12  # H100 SXM data sheet, dense bf16 on the tensor cores
# DeepLab v3+ WRN-38: the ASPP's dilated convs over the output-stride-8 map
# (4096 -> 256 channels); eval at 1024x2048 (a 128x256 map), training at
# exps/deeplab.yaml (8 pairs of 700x700 crops: 88x88 maps, 16 images)
DL_RATES, DL_CIN, DL_COUT = (12, 24, 36), 4096, 256
DL_EVAL_MAP, DL_TRAIN_MAP = (H // 8, W // 8), (88, 88)
DL_TRAIN_PAIRS, DL_CROP = 8, (700, 700)
# deeplab_train_parity's seeds: each costs seven full-width steps on the CPU
DL_TRAIN_PARITY_SEEDS = (SEED + 27, SEED + 37)
# M2F stage 1 (exps/m2f.yaml): the anomaly tail's backward at the stage-1 shapes,
# stride-4 masks of the 704x704 padded crops
S1_MASK_HW = (TRAIN_HW[0] // 4, TRAIN_HW[1] // 4)
# the binned validation metrics: 8192 bins; SMIYC RoadAnomaly21's validation
# images are 720x1280, Cityscapes-sized ones 1024x2048
NUM_BINS = 8192
VAL_HW = ((720, 1280), (1024, 2048))


_STARTED = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's carries the seconds since the script started."""
    if "phase" in obj:
        obj = {**obj, "at_seconds": time.perf_counter() - _STARTED}
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired, IndexError) as e:
        return f"nvidia-smi unavailable: {e}"


def median_ms(torch, fn, reps):
    """Median device time of ``fn`` over ``reps`` calls, one event pair each."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes, ops, ops_per_s=F32_OPS_PER_S):
    """The least time for ``nbytes`` at HBM rate and ``ops`` at ``ops_per_s``
    (default f32 outside the tensor cores), ms, and which of the two binds."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def msda_inputs(torch, levels, lq, dtype, device, seed, d=HEAD_DIM, avoid_ties=True,
                batch=1):
    """value, sampling locations and attention weights for ``levels``; locations
    in [-0.1, 1.1] of each map, so some points fall outside it."""
    g = np.random.RandomState(seed)
    s = sum(h * w for h, w in levels)
    value = torch.from_numpy(g.randn(batch, s, N_HEADS, d).astype(np.float32))
    loc = g.rand(batch, lq, N_HEADS, len(levels), N_POINTS, 2).astype(np.float32) * 1.2 - 0.1
    if avoid_ties:
        # nudge points 1e-3 px off the integer pixel positions, where the
        # bilinear backward's location slope is one-sided and the two versions'
        # rounding may pick other sides (the nearest mode's half-pixel ties need
        # no nudge: kernel and plain version round x * W - 0.5 op by op)
        size = np.array([[w, h] for h, w in levels], np.float32)[None, None, None, :, None, :]
        px = loc * size - 0.5
        frac = px - np.floor(px)
        near = np.minimum(frac, 1 - frac) < 1e-3
        loc = np.where(near, (px + 2e-3 + 0.5) / size, loc).astype(np.float32)
    logits = torch.from_numpy(g.randn(batch, lq, N_HEADS, len(levels) * N_POINTS).astype(
        np.float32))
    attn = torch.softmax(logits, -1).view(batch, lq, N_HEADS, len(levels), N_POINTS)
    return (value.to(device, dtype), torch.from_numpy(loc).to(device),
            attn.to(device, dtype))


def msda_ops(torch, loc, levels, mode, backward=False):
    """f32 operations these inputs need: per channel, 2 per in-bounds corner
    (bilinear) and 2 per in-bounds point (weight x value, accumulate). For the
    backward 4 per channel and in-bounds corner: one multiply-add of the dot
    product <g, corner value>, from which d attn and d loc follow per corner,
    and one multiply and one add into d value."""
    size = torch.tensor([[w, h] for h, w in levels], dtype=torch.float32, device=loc.device)
    px = loc * size[None, None, None, :, None, :] - 0.5
    x, y = px[..., 0], px[..., 1]
    wl, hl = size[None, None, None, :, None, 0], size[None, None, None, :, None, 1]
    if mode == "nearest":
        points = ((x > -0.5) & (x < wl - 0.5) & (y > -0.5) & (y < hl - 0.5)).sum()
        return int(points) * 2 * HEAD_DIM
    x0, y0 = torch.floor(x), torch.floor(y)
    corners = 0
    for dx in (0, 1):
        for dy in (0, 1):
            corners += int(((x0 + dx >= 0) & (x0 + dx < wl) & (y0 + dy >= 0)
                            & (y0 + dy < hl)).sum())
    points = int(((x > -1) & (x < wl) & (y > -1) & (y < hl)).sum())
    if backward:
        return 4 * corners * HEAD_DIM
    return (2 * corners + 2 * points) * HEAD_DIM


def label_sector_bytes(torch, labels, coords, maps):
    """Bytes of the 32-byte label-map sectors that hold the in-map corners of
    these points, each sector counted once. labels [B, H, W]; coords [R, P, 2];
    maps [R], the label map of each coordinate row."""
    _, h, w = labels.shape
    x0 = torch.floor(coords[..., 0] * w - 0.5).long()
    y0 = torch.floor(coords[..., 1] * h - 0.5).long()
    per_sector = 32 // labels.element_size()
    sectors = []
    for dx in (0, 1):
        for dy in (0, 1):
            ix, iy = x0 + dx, y0 + dy
            valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
            flat = (maps[:, None] * h + iy) * w + ix
            sectors.append(flat[valid] // per_sector)
    return int(torch.unique(torch.cat(sectors)).numel()) * 32


def phase_build():
    from multishiftseg_torch import _build

    t0 = time.perf_counter()
    report = _build.build()
    return {"phase": "build", "ok": True, "seconds": time.perf_counter() - t0,
            "sources": {k: {"seconds": v["seconds"],
                            "ptxas": v["ptxas"] if k == "dilated_conv" else v["ptxas"][:6]}
                        for k, v in report.items()},
            "nvidia_smi": nvidia_smi()}


def phase_kernels(torch):
    from multishiftseg_torch.ops import ms_deform_attn as msda
    from multishiftseg_torch.ops import scores

    dev = torch.device("cuda")
    rows, checks = {}, []

    def check(name, got, want, atol, rtol):
        """Pass where |got - want| <= atol + rtol * |want| everywhere; the
        relative error reported is the largest one over the reference's scale."""
        err = (got.float() - want.float()).abs()
        ok = bool((err <= atol + rtol * want.float().abs()).all())
        scale = float(want.float().abs().max())
        checks.append({"check": name, "max_abs_err": float(err.max()),
                       "max_rel_err": float(err.max()) / max(scale, 1e-30),
                       "atol": atol, "rtol": rtol, "ok": ok})
        return float(err.max())

    # deformable attention at the main-path shapes, bf16 as served. Tolerance:
    # both sides sum in f32 and round once to bf16, so they differ by at most
    # one bf16 step (2^-8 relative) plus f32 sum-order noise.
    lq = sum(h * w for h, w in LEVELS)
    value, loc, attn = msda_inputs(torch, LEVELS, lq, torch.bfloat16, dev, SEED)
    for mode, line in (("bilinear", 93), ("nearest", 236)):
        run = lambda: msda.ms_deform_attn_core(value, LEVELS, loc, attn, mode)
        plain = lambda: msda.ms_deform_attn_core_plain(value, LEVELS, loc, attn, mode)
        out, ref = run(), plain()
        torch.cuda.synchronize()
        err = check(f"ms_deform_attn_{mode}_main_shapes", out, ref, 1e-3, 1e-2)
        b_ms, b_by = bound(nbytes(value, loc, attn, out), msda_ops(torch, loc, LEVELS, mode))
        rows[f"ms_deform_attn_{mode}"] = {
            "name": f"ms_deform_attn_{mode}", "route": "cuda",
            "source": "multishiftseg_torch/csrc/ms_deform_attn.cu",
            "replaces": f"multishiftseg_tpu/ops/ms_deform_attn.py:{line}",
            # the eval paths; the training steps' launches are the
            # training-shape row's
            "paths": ("serve", "validate", "evaluate"), "max_abs_err": err,
            "ms": median_ms(torch, run, 50),
            "plain_ms": median_ms(torch, plain, 10), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}
        # f32 edge cases: a degenerate h == 1 / w == 1 pyramid (a 32-px side)
        # with points outside the map, and 30 channels a head (no 16-byte
        # channel groups: the kernel's one-channel path); f32 sums in another order
        edge = [(1, 5), (4, 1), (3, 3)]
        v32, l32, a32 = msda_inputs(torch, edge, 64, torch.float32, dev, SEED + 1, d=30)
        check(f"ms_deform_attn_{mode}_degenerate_levels",
              msda.ms_deform_attn_core(v32, edge, l32, a32, mode),
              msda.ms_deform_attn_core_plain(v32, edge, l32, a32, mode), 1e-5, 1e-5)
        outside = (l32 < 0) | (l32 > 1)
        checks[-1]["points_outside_map"] = int(outside.any(-1).sum())
    # nearest on exact pixel boundaries (x = j / W_l, y = j / H_l), main-path
    # shapes: the last bit of x * W - 0.5 picks the pixel, so kernel and plain
    # version must round alike. Integer values and weights of 1/16 keep every
    # sum exact in any order: bit for bit
    gb = np.random.RandomState(SEED + 3)
    vb = gb.randint(-8, 9, (1, lq, N_HEADS, HEAD_DIM)).astype(np.float32)
    lb = np.empty((1, lq, N_HEADS, len(LEVELS), N_POINTS, 2), np.float32)
    for lid, (h, w) in enumerate(LEVELS):
        for axis, size in ((0, w), (1, h)):
            j = gb.randint(0, size + 1, lb.shape[:3] + (N_POINTS,)).astype(np.float32)
            lb[:, :, :, lid, :, axis] = j / np.float32(size)
    vb, lb = torch.from_numpy(vb).to(dev, torch.bfloat16), torch.from_numpy(lb).to(dev)
    ab = torch.full(lb.shape[:-1], 1 / 16, dtype=torch.bfloat16, device=dev)
    out = msda.ms_deform_attn_core(vb, LEVELS, lb, ab, "nearest")
    ref = msda.ms_deform_attn_core_plain(vb, LEVELS, lb, ab, "nearest")
    torch.cuda.synchronize()
    check("ms_deform_attn_nearest_pixel_boundaries", out, ref, 0.0, 0.0)
    del vb, lb, ab, out, ref

    # score tail at the main-path shapes: f32 stride-4 masks to 1024x2048; the
    # sums over 100 queries differ only in order (f32)
    g = np.random.RandomState(SEED + 2)
    masks = torch.from_numpy(
        3 * g.randn(1, QUERIES, H // 4, W // 4).astype(np.float32)).to(dev)
    cls = g.randn(1, QUERIES, CLASSES + 1).astype(np.float32)
    cls[0, :5, 3] = 8.0  # five confident queries keep their extra channel
    cls = torch.from_numpy(cls).to(dev)
    for head, line in (("anomaly", "scores.py:39"), ("semantic", "scores.py:25")):
        if head == "anomaly":
            run = lambda: scores.anomaly_score_upsampled(cls, masks, (H, W))
            plain = lambda: scores.anomaly_score_upsampled_plain(cls, masks, (H, W))
        else:
            run = lambda: scores.semantic_inference_upsampled(cls, masks, (H, W), CLASSES)
            plain = lambda: scores.semantic_inference_upsampled_plain(cls, masks, (H, W),
                                                                      CLASSES)
        out, ref = run(), plain()
        torch.cuda.synchronize()
        err = check(f"mask_scores_{head}_main_shapes", out, ref, 1e-5, 1e-5)
        del ref
        per_q = 11 + 2 * CLASSES  # bilinear taps 7, sigmoid 4, contraction 2K
        ops = H * W * (QUERIES * per_q + (CLASSES + 1 if head == "anomaly" else QUERIES))
        in_bytes = nbytes(masks) + QUERIES * CLASSES * 4 + (QUERIES * 4 if head == "semantic" else 0)
        b_ms, b_by = bound(in_bytes + nbytes(out), ops)
        rows[f"mask_scores_{head}"] = {
            "name": f"mask_scores_{head}", "route": "cuda",
            "source": "multishiftseg_torch/csrc/mask_scores.cu",
            "replaces": f"multishiftseg_tpu/ops/{line}",
            "max_abs_err": err, "ms": median_ms(torch, run, 20),
            "plain_ms": median_ms(torch, plain, 5), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}
        del out
    approx_kernel_rows(torch, dev, rows, check, checks)
    train_kernel_rows(torch, dev, rows, check, checks)
    deeplab_kernel_rows(torch, dev, rows, check, checks)
    stage1_kernel_rows(torch, dev, rows, check, checks)
    ood_hist_rows(torch, dev, rows, checks)
    ok = all(c["ok"] for c in checks)
    return rows, {"phase": "kernels", "ok": ok, "checks": checks}


def near_rounding_boundary(torch, loc, attn, levels, mode, margin=1e-4):
    """[N, Lq, M] bool: outputs whose centroid (float64) lies within ``margin``
    px of a nearest-pixel boundary (c * W an integer), where f32 sums in
    another order may round to the neighbouring pixel: ``nearest_top{T}c``'s
    tail centroid of each (head, level), ``shared``'s point of each (level,
    point) for every head; none in the other modes. A centroid without mass
    is exactly 0 (or 0.5) in every version and is not counted. The CPU tests
    hold the port's centroid modes off the same outputs."""
    loc, a = loc.double(), attn.double()
    size = torch.tensor([[w, h] for h, w in levels], dtype=torch.float64, device=loc.device)
    n, lq, m, L, p = a.shape
    if mode != "shared" and not mode.endswith("c"):
        return torch.zeros((n, lq, m), dtype=torch.bool, device=loc.device)
    if mode == "shared":
        asum = a.sum(2)
        c = (loc * a[..., None]).sum(2) / asum.clamp_min(1e-12)[..., None]
        px = c * size[None, None, :, None, :]
        near = ((px - px.round()).abs() < margin).any(-1) & (asum > 1e-12)
        return near.reshape(n, lq, -1).any(-1)[:, :, None].expand(n, lq, m)
    top = int(mode[len("nearest_top"):-1])
    x = loc * size[None, None, None, :, None, :] - 0.5
    inb = ((x > -0.5) & (x < size[None, None, None, :, None, :] - 0.5)).all(-1)
    w = torch.where(inb, a, 0.0).reshape(n, lq, m, L * p)
    order = torch.sort(w, dim=-1, descending=True, stable=True).indices[..., :top]
    tail = w.scatter(-1, order, 0.0).reshape(n, lq, m, L, p)
    mass = tail.sum(-1)
    c = (tail[..., None] * loc).sum(-2) / mass.clamp_min(1e-12)[..., None]
    px = c * size[None, None, None, :, :]
    return (((px - px.round()).abs() < margin).any(-1) & (mass > 1e-12)).any(-1)


def check_off_boundaries(torch, checks, name, got, want, loc, attn, levels, mode, atol, rtol):
    """``check`` for a centroid mode: every output within atol + rtol |want|,
    except outputs whose centroid lies within 1e-4 px of a rounding boundary
    (:func:`near_rounding_boundary`); those off tolerance are counted (flips)."""
    n, lq, m = attn.shape[:3]
    err = (got.float() - want.float()).abs().view(n, lq, m, -1)
    bad = (err > atol + rtol * want.float().abs().view(n, lq, m, -1)).any(-1)
    near = near_rounding_boundary(torch, loc, attn.float(), levels, mode)
    held = err[~near]
    max_err = float(held.max()) if held.numel() else 0.0
    flips = int((bad & near).sum())
    checks.append({"check": name, "max_abs_err": max_err, "atol": atol, "rtol": rtol,
                   "outputs_near_boundary": int(near.sum()), "flipped_outputs": flips,
                   "ok": not bool((bad & ~near).any()) and flips <= max(2, bad.numel() // 10000)})
    return max_err


def msda_approx_ops(torch, loc, attn, levels, mode):
    """f32 operations these inputs need: 2 per channel and gathered in-map row
    (weight x value, accumulate); the top-T selection's J^2 comparisons a head
    and the tail centroids' 6 a point (centroid mode); the shared points' 6 a
    head and point."""
    n, lq, m, L, p = attn.shape
    size = torch.tensor([[w, h] for h, w in levels], dtype=torch.float32, device=loc.device)
    x = loc * size[None, None, None, :, None, :] - 0.5
    inb = ((x > -0.5) & (x < size[None, None, None, :, None, :] - 0.5)).all(-1)
    heads, J = n * lq * m, L * p
    if mode == "shared":
        return n * lq * J * m * 6 + int(inb.sum()) * 2 * HEAD_DIM
    top = int(mode[len("nearest_top"):].rstrip("c"))
    kept = int(inb.reshape(heads, J).sum(-1).clamp(max=top).sum())
    ops = heads * J * J + kept * 2 * HEAD_DIM
    if mode.endswith("c"):
        ops += heads * (J - top) * 6 + heads * L * 2 * HEAD_DIM
    return ops


def approx_kernel_rows(torch, dev, rows, check, checks):
    """The int8 table and the approximate deformable modes at the main-path
    shapes (1024x2048, batch 1, bf16): the quantize against its plain version
    bit for bit; the int8 forward, ``nearest_top6``, ``nearest_top6c`` and
    ``shared`` within one bf16 step plus f32 order noise, as the exact rows
    (the centroid modes off their rounding boundaries, flips counted); and f32
    edge cases: degenerate h == 1 / w == 1 levels with 30 channels a head and
    points outside the map, T = J against ``nearest``, all-equal weights."""
    from multishiftseg_torch.ops import ms_deform_attn as msda

    lq = sum(h * w for h, w in LEVELS)
    value, loc, attn = msda_inputs(torch, LEVELS, lq, torch.bfloat16, dev, SEED + 70,
                                   avoid_ties=False)
    src = "multishiftseg_torch/csrc/ms_deform_attn.cu"
    approx_src = "multishiftseg_torch/csrc/ms_deform_attn_approx.cu"
    replaces = "multishiftseg_tpu/ops/ms_deform_attn.py:"

    run_q = lambda: msda.quantize_value_table(value)
    plain_q = lambda: msda.quantize_value_table_plain(value)
    (q, scale), (qp, sp) = run_q(), plain_q()
    torch.cuda.synchronize()
    same = bool(torch.equal(q, qp)) and bool(torch.equal(scale.view(torch.int32),
                                                         sp.view(torch.int32)))
    checks.append({"check": "ms_deform_attn_quantize_main_shapes_bit_for_bit", "equal": same,
                   "max_abs_err": float((q.int() - qp.int()).abs().max()), "ok": same})
    # per element: abs and max, then divide, round, clamp
    b_ms, b_by = bound(nbytes(value, q, scale), 5 * value.numel())
    rows["ms_deform_attn_quantize"] = {
        "name": "ms_deform_attn_quantize", "route": "cuda", "source": src,
        "replaces": replaces + "130", "counter": "ms_deform_attn_quantize",
        "max_abs_err": float((q.int() - qp.int()).abs().max()), "ms": median_ms(torch, run_q, 50),
        "plain_ms": median_ms(torch, plain_q, 10), "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None}
    del qp, sp

    run_i = lambda: msda._ms_deform_attn_int8_cuda(q, scale, LEVELS, loc, attn)
    plain_i = lambda: msda._bilinear_int8_plain(q, scale, LEVELS, loc, attn).to(attn.dtype)
    out = run_i()
    torch.cuda.synchronize()
    err = check("ms_deform_attn_int8_main_shapes", out, plain_i(), 1e-3, 1e-2)
    # the bilinear forward's operations and one scale multiply per corner and channel
    size = torch.tensor([[w, h] for h, w in LEVELS], dtype=torch.float32, device=dev)
    px = loc * size[None, None, None, :, None, :] - 0.5
    points = int(((px[..., 0] > -1) & (px[..., 0] < size[:, 0, None])
                  & (px[..., 1] > -1) & (px[..., 1] < size[:, 1, None])).sum())
    ops = msda_ops(torch, loc, LEVELS, "bilinear") + 4 * points * HEAD_DIM
    b_ms, b_by = bound(nbytes(q, scale, loc, attn, out), ops)
    rows["ms_deform_attn_int8"] = {
        "name": "ms_deform_attn_int8", "route": "cuda", "source": src,
        "replaces": replaces + "221", "counter": "ms_deform_attn_int8",
        "max_abs_err": err, "ms": median_ms(torch, run_i, 50),
        "plain_ms": median_ms(torch, plain_i, 10), "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None}
    del q, scale, out

    for mode, line, counter in (("nearest_top6", 304, "ms_deform_attn_nearest_top"),
                                ("nearest_top6c", 375, "ms_deform_attn_nearest_topc"),
                                ("shared", 481, "ms_deform_attn_shared")):
        run = lambda: msda.ms_deform_attn_core(value, LEVELS, loc, attn, mode)
        plain = lambda: msda.ms_deform_attn_core_plain(value, LEVELS, loc, attn, mode)
        out = run()
        torch.cuda.synchronize()
        # both sides sum in f32 and round once to bf16: one bf16 step plus
        # f32 order noise, as the exact rows
        err = check_off_boundaries(torch, checks, f"ms_deform_attn_{mode}_main_shapes", out,
                                   plain(), loc, attn, LEVELS, mode, 1e-3, 1e-2)
        b_ms, b_by = bound(nbytes(value, loc, attn, out),
                           msda_approx_ops(torch, loc, attn, LEVELS, mode))
        rows[f"ms_deform_attn_{mode}"] = {
            "name": f"ms_deform_attn_{mode}", "route": "cuda", "source": approx_src,
            "replaces": replaces + str(line), "counter": counter, "max_abs_err": err,
            "ms": median_ms(torch, run, 50), "plain_ms": median_ms(torch, plain, 10),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        del out
    del value, loc, attn

    # f32 edge cases, f32 sums in another order (1e-5): a degenerate pyramid
    # (a 32-px side) with 30 channels a head (the one-channel path) and points
    # outside the map, in every mode; all-equal weights (the tie rule alone);
    # T = J against nearest
    edge = [(1, 5), (4, 1), (3, 3)]
    v32, l32, a32 = msda_inputs(torch, edge, 64, torch.float32, dev, SEED + 71, d=30,
                                avoid_ties=False)
    equal = torch.full_like(a32, 1.0 / a32[0, 0, 0].numel())
    outside = int(((l32 < 0) | (l32 > 1)).any(-1).sum())
    for mode in ("nearest_top6", "nearest_top6c", "shared"):
        for tag, a in (("degenerate_levels", a32), ("equal_weights", equal)):
            check_off_boundaries(torch, checks, f"ms_deform_attn_{mode}_{tag}",
                                 msda.ms_deform_attn_core(v32, edge, l32, a, mode),
                                 msda.ms_deform_attn_core_plain(v32, edge, l32, a, mode),
                                 l32, a, edge, mode, 1e-5, 1e-5)
            checks[-1]["points_outside_map"] = outside
    check("ms_deform_attn_int8_degenerate_levels",
          msda.ms_deform_attn_core(v32, edge, l32, a32, quantize_table=True),
          msda.ms_deform_attn_core_plain(v32, edge, l32, a32, quantize_table=True), 1e-5, 1e-5)
    near = msda.ms_deform_attn_core(v32, edge, l32, a32, "nearest")
    for mode in ("nearest_top12", "nearest_top12c"):
        check(f"ms_deform_attn_{mode}_all_points_is_nearest",
              msda.ms_deform_attn_core(v32, edge, l32, a32, mode), near, 1e-5, 1e-5)
    q32, s32 = msda.quantize_value_table(v32)
    qp32, sp32 = msda.quantize_value_table_plain(v32)
    same = bool(torch.equal(q32, qp32)) and bool(torch.equal(s32, sp32))
    checks.append({"check": "ms_deform_attn_quantize_degenerate_levels_bit_for_bit",
                   "equal": same, "ok": same})


def train_kernel_rows(torch, dev, rows, check, checks):
    """The training slice's kernels at the stage-2 shapes (16 images at 704x704)."""
    from multishiftseg_torch.losses import criterion, matcher
    from multishiftseg_torch.ops import ms_deform_attn as msda

    b = 2 * TRAIN_PAIRS
    # deformable backward, bf16 as trained. Tolerance: d value sums in f32 by
    # atomics in run-to-run order and both sides round once to bf16 (one bf16
    # step, 2^-8 relative); d loc and d attn reduce 32 channels in f32
    lq = sum(h * w for h, w in TRAIN_LEVELS)
    value, loc, attn = msda_inputs(torch, TRAIN_LEVELS, lq, torch.bfloat16, dev, SEED + 7,
                                   batch=b)
    g = torch.from_numpy(np.random.RandomState(SEED + 8).randn(
        b, lq, N_HEADS * HEAD_DIM).astype(np.float32)).to(dev, torch.bfloat16)
    run = lambda: msda.ms_deform_attn_backward(value, TRAIN_LEVELS, loc, attn, g)
    plain = lambda: msda.ms_deform_attn_backward_plain(value, TRAIN_LEVELS, loc, attn, g)
    got, want = run(), plain()
    torch.cuda.synchronize()
    errs = [check(f"ms_deform_attn_bilinear_backward_{n}_main_shapes", x, y, 1e-2 * float(
        y.float().abs().max()), 1e-2) for n, x, y in zip(("dvalue", "dloc", "dattn"), got, want)]
    del got, want
    ops = msda_ops(torch, loc, TRAIN_LEVELS, "bilinear", backward=True)
    out_bytes = nbytes(value) + nbytes(loc) + nbytes(attn)  # d value, d loc, d attn
    b_ms, b_by = bound(nbytes(value, loc, attn, g) + out_bytes, ops)
    rows["ms_deform_attn_bilinear_backward"] = {
        "name": "ms_deform_attn_bilinear_backward", "route": "cuda",
        "source": "multishiftseg_torch/csrc/ms_deform_attn.cu",
        "replaces": "multishiftseg_tpu/ops/ms_deform_attn.py:587",
        "max_abs_err": max(errs), "ms": median_ms(torch, run, 10),
        "plain_ms": median_ms(torch, plain, 3), "bound_ms": b_ms, "bound_by": b_by,
        # no single PyTorch call computes this function (grid_sample's backward
        # works per level on another layout and leaves the sum over points)
        "library_ms": None}
    # the bilinear forward at the same shapes, 6 launches in every M2F step;
    # tolerance as at the eval shapes (one bf16 step plus f32 order noise)
    run = lambda: msda.ms_deform_attn_core(value, TRAIN_LEVELS, loc, attn, "bilinear")
    plain = lambda: msda.ms_deform_attn_core_plain(value, TRAIN_LEVELS, loc, attn, "bilinear")
    with torch.no_grad():
        out = run()
        err = check("ms_deform_attn_bilinear_train_shapes", out, plain(), 1e-3, 1e-2)
        b_ms, b_by = bound(nbytes(value, loc, attn, out),
                           msda_ops(torch, loc, TRAIN_LEVELS, "bilinear"))
        rows["ms_deform_attn_bilinear_train_shapes"] = {
            "name": "ms_deform_attn_bilinear_train_shapes", "route": "cuda",
            "source": "multishiftseg_torch/csrc/ms_deform_attn.cu",
            "replaces": "multishiftseg_tpu/ops/ms_deform_attn.py:93",
            "counter": "ms_deform_attn_bilinear", "paths": ("train", "stage1_train"),
            "max_abs_err": err, "ms": median_ms(torch, run, 50),
            "plain_ms": median_ms(torch, plain, 5), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}
    del value, loc, attn, g, out

    # batched assignment: 16 problems of 19 targets x 100 queries, about half
    # the rows at BIG (classes absent from the image); exact equality
    rs = np.random.RandomState(SEED + 9)
    cost_np = rs.rand(b, CLASSES, QUERIES).astype(np.float32)
    cost_np[rs.rand(b, CLASSES) > 0.5] = matcher.BIG
    cost_np[:, 0] = rs.rand(b, QUERIES)  # every image has a valid row
    cost = torch.from_numpy(cost_np).to(dev)
    run = lambda: matcher.linear_sum_assignment(cost)
    steps = []
    want = matcher.linear_sum_assignment_plain(cost, steps)
    got = run()
    torch.cuda.synchronize()
    same = bool(torch.equal(got.cpu(), want.cpu()))
    from scipy.optimize import linear_sum_assignment as scipy_lsa

    optimal = True
    for i in range(b):
        valid = np.nonzero(cost_np[i, :, 0] < matcher.BIG)[0]
        r, c = scipy_lsa(cost_np[i][valid])
        ours = cost_np[i][valid, got[i].cpu().numpy()[valid]].sum()
        optimal &= bool(abs(ours - cost_np[i][valid][r, c].sum()) <= 1e-5 * abs(ours))
    checks.append({"check": "linear_sum_assignment_main_shapes", "equal_to_plain": same,
                   "scipy_optimal_on_valid_rows": optimal, "ok": same and optimal})
    # each Dijkstra step reduces over every column: about 5 f32 operations each
    b_ms, b_by = bound(nbytes(cost) + b * CLASSES * 4, sum(steps) * QUERIES * 5)
    rows["linear_sum_assignment"] = {
        "name": "linear_sum_assignment", "route": "cuda",
        "source": "multishiftseg_torch/csrc/assignment.cu",
        "replaces": "multishiftseg_tpu/losses/matcher.py:28",
        "max_abs_err": 0.0 if same else float("nan"), "ms": median_ms(torch, run, 20),
        "plain_ms": median_ms(torch, lambda: matcher.linear_sum_assignment_plain(cost), 3),
        "bound_ms": b_ms, "bound_by": b_by,
        # PyTorch has no assignment solver
        "library_ms": None}

    # label points on 16 label maps at 704x704: every class at the matcher's
    # points, and one class per row at the augmented half's clean candidates
    labels_np = rs.randint(0, CLASSES + 3, (b, *TRAIN_HW)).astype(np.int32)
    labels_np[:, :, CROP[1]:] = 255
    labels = torch.from_numpy(labels_np).to(dev)
    coords = torch.from_numpy(rs.rand(b, TRAIN_POINTS, 2).astype(np.float32)).to(dev)
    run = lambda: criterion.sample_target_points(labels, coords, CLASSES)
    plain = lambda: criterion.sample_target_points_plain(labels, coords, CLASSES)
    out = run()
    # at most four corner weights summed in f32, in another order
    err = check("label_points_classes_main_shapes", out, plain(), 1e-6, 0.0)
    n_rows = TRAIN_PAIRS * CLASSES
    rcoords = torch.from_numpy(rs.rand(n_rows, int(TRAIN_POINTS * 1.25), 2).astype(
        np.float32)).to(dev)
    ids = torch.arange(CLASSES, device=dev).repeat(TRAIN_PAIRS)
    err = max(err, check("label_points_rows_main_shapes",
                         criterion.sample_class_points(labels, rcoords, ids, CLASSES, TRAIN_PAIRS),
                         criterion.sample_class_points_plain(labels, rcoords, ids, CLASSES,
                                                             TRAIN_PAIRS), 1e-6, 0.0))
    # bytes: the label sectors the corners touch, the coordinates, the samples;
    # operations: 4 compares and 4 adds per point and class
    label_bytes = label_sector_bytes(torch, labels, coords, torch.arange(b, device=dev))
    b_ms, b_by = bound(label_bytes + nbytes(coords, out), b * TRAIN_POINTS * CLASSES * 8)
    rows["label_points"] = {
        "name": "label_points", "route": "cuda",
        "source": "multishiftseg_torch/csrc/label_points.cu",
        "replaces": "multishiftseg_tpu/losses/criterion.py:66",
        "max_abs_err": err, "ms": median_ms(torch, run, 20),
        "plain_ms": median_ms(torch, plain, 5), "bound_ms": b_ms, "bound_by": b_by,
        # the one-call equivalent, grid_sample of [B, K, H, W] one-hot masks,
        # takes other inputs (the masks, not the label map)
        "library_ms": None}


def in_map_taps(n, hw, rate):
    """Pixel-taps of a dilated 3x3 conv over n maps of ``hw`` whose shifted
    source lies in the map: the work the function needs."""
    from multishiftseg_torch.ops.dilated_conv import tap_windows

    return n * sum((sy.stop - sy.start) * (sx.stop - sx.start)
                   for _, _, sy, sx, _, _ in tap_windows(*hw, rate))


def deeplab_kernel_rows(torch, dev, rows, check, checks):
    """DeepLab's kernels at its main-path shapes: the ASPP's dilated conv at the
    eval shapes (its three rates timed together), its weight gradient and
    forward at the training shapes, and the pixel selection over 8 x 700 x 700
    CE values;
    then small and odd shapes. The conv bounds count in-map taps only, at the
    bf16 tensor-core peak."""
    import torch.nn.functional as F

    from multishiftseg_torch.losses import rcl
    from multishiftseg_torch.ops import dilated_conv as dconv

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions sum in f32
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    # forward, eval shapes, bf16 as served; the f32 master weights, which the
    # wrapper casts. Tolerance: both sides sum the same products in f32 and
    # round once to bf16, one bf16 step (2^-8) apart, plus f32 order noise
    x = torch.randn((1, *DL_EVAL_MAP, DL_CIN), generator=gen, device=dev).to(torch.bfloat16)
    ks = [torch.randn((3, 3, DL_CIN, DL_COUT), generator=gen, device=dev) / 96 for _ in DL_RATES]
    with torch.no_grad():
        run = lambda: [dconv.dilated_conv3x3(x, k, r) for k, r in zip(ks, DL_RATES)]
        plain = lambda: [dconv.dilated_conv3x3_plain(x, k, r) for k, r in zip(ks, DL_RATES)]
        outs, refs = run(), plain()
        torch.cuda.synchronize()
        err = max(check(f"dilated_conv3x3_rate{r}_eval_shapes", o, ref,
                        1e-3 * float(ref.float().abs().max()), 2 ** -7)
                  for r, o, ref in zip(DL_RATES, outs, refs))
        del refs
        times = (median_ms(torch, run, 10), median_ms(torch, plain, 2))
        # the library: cuDNN's dilated conv2d in bf16, in benchmark mode (its
        # first call per rate tries every algorithm), channels-last as served
        # and NCHW-contiguous; the faster layout is the row's yardstick
        cudnn = {}
        torch.backends.cudnn.benchmark = True
        for layout, fmt in (("channels_last", torch.channels_last),
                            ("nchw", torch.contiguous_format)):
            xc = x.permute(0, 3, 1, 2).contiguous(memory_format=fmt)
            wc = [k.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(memory_format=fmt)
                  for k in ks]
            lib = lambda: [F.conv2d(xc, w, padding=r, dilation=r) for w, r in zip(wc, DL_RATES)]
            t0 = time.perf_counter()
            lib()
            torch.cuda.synchronize()
            cudnn[layout] = {
                "first_call_s": time.perf_counter() - t0, "ms": median_ms(torch, lib, 2),
                "backend": str(torch._C._select_conv_backend(
                    xc, wc[0], None, [1, 1], [12, 12], [12, 12], False, [0, 0], 1))}
        torch.backends.cudnn.benchmark = False
        del xc, wc
    best = min(cudnn, key=lambda k: cudnn[k]["ms"])
    taps = sum(in_map_taps(1, DL_EVAL_MAP, r) for r in DL_RATES)
    flop = 2 * taps * DL_CIN * DL_COUT
    b_ms, b_by = bound(nbytes(x, *outs) + sum(k.numel() * 2 for k in ks), flop,
                       BF16_TC_OPS_PER_S)
    rows["dilated_conv3x3"] = {
        "name": "dilated_conv3x3", "route": "cuda",
        "source": "multishiftseg_torch/csrc/dilated_conv.cu",
        "replaces": "multishiftseg_tpu/ops/dilated_conv.py:19",
        "paths": ("deeplab_serve", "validate", "evaluate"),
        "max_abs_err": err, "ms": times[0], "plain_ms": times[1], "bound_ms": b_ms,
        "bound_by": b_by,
        # cuDNN's dilated conv2d, bf16, the faster layout: the same function
        "library_ms": cudnn[best]["ms"]}
    checks.append({"check": "dilated_conv3x3_eval_work", "in_map_pixel_taps": taps,
                   "tflop": flop / 1e12, "kernel_tflop_per_s": flop / times[0] / 1e9,
                   "library_tflop_per_s": flop / cudnn[best]["ms"] / 1e9,
                   "peak": "bf16 tensor cores, 989 TFLOP/s", "library": cudnn,
                   "library_layout": best, "ok": True})
    del x, outs

    # weight gradient, training shapes (16 x 88 x 88), bf16 inputs, f32 result
    # by atomics; tolerance: the same exact products summed in f32 in another order
    b = 2 * DL_TRAIN_PAIRS
    xt = torch.randn((b, *DL_TRAIN_MAP, DL_CIN), generator=gen, device=dev).to(torch.bfloat16)
    gt = (torch.randn((b, *DL_TRAIN_MAP, DL_COUT), generator=gen, device=dev) / 64).to(
        torch.bfloat16)
    run = lambda: [dconv.dilated_conv3x3_wgrad(xt, gt, r) for r in DL_RATES]
    plain = lambda: [dconv.dilated_conv3x3_wgrad_plain(xt, gt, r) for r in DL_RATES]
    got, want = run(), plain()
    torch.cuda.synchronize()
    err = max(check(f"dilated_conv3x3_wgrad_rate{r}_train_shapes", a, c,
                    1e-4 * float(c.abs().max()), 0.0) for r, a, c in zip(DL_RATES, got, want))
    del got, want
    xc, gc = xt.permute(0, 3, 1, 2), gt.permute(0, 3, 1, 2)
    library = lambda: [torch.nn.grad.conv2d_weight(xc, (DL_COUT, DL_CIN, 3, 3), gc, padding=r,
                                                   dilation=r) for r in DL_RATES]
    torch.backends.cudnn.benchmark = True  # the library at its best
    times = (median_ms(torch, run, 5), median_ms(torch, plain, 1), median_ms(torch, library, 3))
    torch.backends.cudnn.benchmark = False
    taps = sum(in_map_taps(b, DL_TRAIN_MAP, r) for r in DL_RATES)
    flop = 2 * taps * DL_CIN * DL_COUT
    b_ms, b_by = bound(nbytes(xt, gt) + len(DL_RATES) * 9 * DL_COUT * DL_CIN * 4, flop,
                       BF16_TC_OPS_PER_S)
    rows["dilated_conv3x3_wgrad"] = {
        "name": "dilated_conv3x3_wgrad", "route": "cuda",
        "source": "multishiftseg_torch/csrc/dilated_conv.cu",
        "replaces": "multishiftseg_tpu/ops/dilated_conv.py:19",
        "max_abs_err": err, "ms": times[0], "plain_ms": times[1], "bound_ms": b_ms,
        "bound_by": b_by,
        # cuDNN's weight gradient of the dilated conv2d, bf16 channels-last
        "library_ms": times[2]}
    checks.append({"check": "dilated_conv3x3_wgrad_train_work", "in_map_pixel_taps": taps,
                   "tflop": flop / 1e12, "kernel_tflop_per_s": flop / times[0] / 1e9,
                   "library_tflop_per_s": flop / times[2] / 1e9, "ok": True})
    del xc, gc
    # the forward at the training shapes, 3 launches a step (the tiles' 16
    # columns do not divide the 88-wide map); the eval check's tolerance, and
    # timed beside cuDNN's conv2d there (channels-last, benchmark mode)
    errs = []
    with torch.no_grad():
        for k, r in zip(ks, DL_RATES):
            out, ref = dconv.dilated_conv3x3(xt, k, r), dconv.dilated_conv3x3_plain(xt, k, r)
            torch.cuda.synchronize()
            errs.append(check(f"dilated_conv3x3_rate{r}_train_shapes", out, ref,
                              1e-3 * float(ref.float().abs().max()), 2 ** -7))
            del out, ref
        run = lambda: [dconv.dilated_conv3x3(xt, k, r) for k, r in zip(ks, DL_RATES)]
        plain = lambda: [dconv.dilated_conv3x3_plain(xt, k, r) for k, r in zip(ks, DL_RATES)]
        xc = xt.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        wc = [k.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
              for k in ks]
        library = lambda: [F.conv2d(xc, w, padding=r, dilation=r) for w, r in zip(wc, DL_RATES)]
        torch.backends.cudnn.benchmark = True
        times = (median_ms(torch, run, 5), median_ms(torch, plain, 1), median_ms(torch, library, 3))
        torch.backends.cudnn.benchmark = False
    taps = sum(in_map_taps(b, DL_TRAIN_MAP, r) for r in DL_RATES)
    flop = 2 * taps * DL_CIN * DL_COUT
    out_bytes = b * DL_TRAIN_MAP[0] * DL_TRAIN_MAP[1] * DL_COUT * 2
    b_ms, b_by = bound(nbytes(xt) + len(DL_RATES) * (out_bytes + 9 * DL_COUT * DL_CIN * 2),
                       flop, BF16_TC_OPS_PER_S)
    rows["dilated_conv3x3_train"] = {
        "name": "dilated_conv3x3_train", "route": "cuda",
        "source": "multishiftseg_torch/csrc/dilated_conv.cu",
        "replaces": "multishiftseg_tpu/ops/dilated_conv.py:19",
        "counter": "dilated_conv3x3", "paths": ("deeplab_train",),
        "max_abs_err": max(errs), "ms": times[0], "plain_ms": times[1], "bound_ms": b_ms,
        "bound_by": b_by,
        # cuDNN's dilated conv2d, bf16 channels-last: the same function
        "library_ms": times[2]}
    checks.append({"check": "dilated_conv3x3_train_work", "in_map_pixel_taps": taps,
                   "tflop": flop / 1e12, "kernel_tflop_per_s": flop / times[0] / 1e9,
                   "library_tflop_per_s": flop / times[2] / 1e9, "ok": True})
    del xt, gt, ks, xc, wc

    # pixel selection over the augmented half's CE values (8 x 700 x 700),
    # a fifth of them invalid (+inf keys); the threshold must equal the k-th
    # smallest key pattern, the sum agree within f32 rounding
    n = DL_TRAIN_PAIRS * DL_CROP[0] * DL_CROP[1]
    vals = -torch.rand(n, generator=gen, device=dev).log() * 2
    valid = torch.rand(n, generator=gen, device=dev) > 0.2
    keyed = torch.where(valid, vals, torch.full_like(vals, float("inf")))
    sn = (0.8 * valid.sum()).to(torch.int32)
    run = lambda: rcl._bottom_k_sum(vals, keyed, sn)
    plain = lambda: rcl.bottom_k_sum_plain(vals, keyed, sn)
    got, want = run(), plain()
    _, _, work, _ = rcl.bottom_k_sum_cuda(vals, keyed, sn)
    kth = torch.sort(keyed.view(torch.int32).long() & 0xFFFFFFFF).values[int(sn) - 1]
    torch.cuda.synchronize()
    err = check("bottom_k_sum_main_shapes", got, want, 0.0, 1e-6)
    same_t = (int(work[257]) & 0xFFFFFFFF) == int(kth)
    checks[-1].update(threshold_equal_kth_key=same_t, ok=checks[-1]["ok"] and same_t)
    # its backward, which every training step launches: the weights exactly
    grads = []
    for fn in (rcl._bottom_k_sum, rcl.bottom_k_sum_plain):
        v = vals.clone().requires_grad_()
        fn(v, keyed, sn).backward()
        grads.append(v.grad)
    torch.cuda.synchronize()
    check("bottom_k_sum_main_shapes_grad", grads[0], grads[1], 0.0, 0.0)
    checks[-1]["elements"] = n
    del grads
    b_ms, b_by = bound(nbytes(vals, keyed, sn, got), 2 * n)  # a compare and an add each
    rows["bottom_k_sum"] = {
        "name": "bottom_k_sum", "route": "cuda", "source": "multishiftseg_torch/csrc/bottom_k.cu",
        "replaces": "multishiftseg_tpu/losses/rcl.py:65",
        "max_abs_err": err, "ms": median_ms(torch, run, 20), "plain_ms": median_ms(torch, plain, 5),
        "bound_ms": b_ms, "bound_by": b_by,
        # no single PyTorch call computes it: topk / kthvalue find the k
        # smallest but neither shares the threshold's ties, and both take k
        # on the host
        "library_ms": None}

    # small and odd shapes: taps wholly outside the map, channels off the
    # tiles, f32 and bf16, the gradients through the autograd Function
    for dtype in (torch.float32, torch.bfloat16):
        for n_, h_, w_, cin, cout, r in ((1, 5, 7, 16, 8, 12), (2, 13, 29, 20, 5, 24),
                                         (3, 20, 20, 8, 16, 36)):
            xs = torch.randn((n_, h_, w_, cin), generator=gen, device=dev).to(dtype)
            kk = torch.randn((3, 3, cin, cout), generator=gen, device=dev) / 8
            gs = torch.randn((n_, h_, w_, cout), generator=gen, device=dev).to(dtype)
            res = []
            for fn in (dconv.dilated_conv3x3, dconv.dilated_conv3x3_plain):
                xi, ki = xs.clone().requires_grad_(), kk.clone().requires_grad_()
                o = fn(xi, ki, r)
                o.backward(gs)
                res.append((o.detach(), xi.grad, ki.grad))
            torch.cuda.synchronize()
            for part, a, c in zip(("out", "dx", "dw"), *res):
                ref = float(c.float().abs().max())
                # f32: order only; bf16: one rounding of an f32 sum apart
                atol, rtol = (1e-5 * ref, 0.0) if dtype == torch.float32 else (1e-4 * ref, 2 ** -7)
                check(f"dilated_conv3x3_{str(dtype)[6:]}_{n_}x{h_}x{w_}x{cin}to{cout}_rate{r}_{part}",
                      a, c, atol, rtol)
    for case in ("ties", "select_num_0"):
        q = torch.floor(torch.rand(5003, generator=gen, device=dev) * 40) / 16
        ok_ = torch.rand(5003, generator=gen, device=dev) > 0.25
        kq = torch.where(ok_, q, torch.full_like(q, float("inf")))
        sq = (0.8 * ok_.sum()).to(torch.int32) if case == "ties" else torch.zeros(
            (), dtype=torch.int32, device=dev)
        res = []
        for fn in (rcl._bottom_k_sum, rcl.bottom_k_sum_plain):
            v = q.clone().requires_grad_()
            out = fn(v, kq, sq)
            out.backward()
            res.append((out.detach(), v.grad))
        torch.cuda.synchronize()
        check(f"bottom_k_sum_{case}_sum", res[0][0], res[1][0], 1e-6, 1e-6)
        check(f"bottom_k_sum_{case}_grad", res[0][1], res[1][1], 0.0, 0.0)


def check_per_entry(checks, name, got, want, scale, rel):
    """Pass where |got - want| <= rel * scale entry by entry (``scale``: the
    entry's sum of absolute terms); report the largest ratio."""
    err = (got - want).abs()
    ok = bool((err <= rel * scale + 1e-30).all())
    checks.append({"check": name, "max_abs_err": float(err.max()),
                   "max_err_over_abs_terms": float((err / scale.clamp_min(1e-30)).max()),
                   "rel_of_abs_terms": rel, "ok": ok})
    return float(err.max())


def tail_backward_inputs(torch, dev, seed, n, hw, out_hw, crop=None, tie=False):
    """Mask logits [n, 100, *hw], class probabilities [n, 100, 19] and a
    gradient [n, *out_hw] of the anomaly score (zero outside ``crop``). Where
    the top two class sums lie within 1e-4 of each other, f32 sum order
    decides which class takes the gradient, so it is zeroed there (counted);
    ``tie`` makes classes 0 and 1 equal and leading instead."""
    from multishiftseg_torch.ops import scores

    g = np.random.RandomState(seed)
    logits = g.randn(n, QUERIES, CLASSES + 1).astype(np.float32)
    if tie:
        logits[..., 1] = logits[..., 0] = 3.0 + g.rand(n, QUERIES).astype(np.float32)
    probs = torch.softmax(torch.from_numpy(logits).to(dev), -1)[..., :-1].contiguous()
    masks = torch.from_numpy(3 * g.randn(n, QUERIES, *hw).astype(np.float32)).to(dev)
    grad = torch.from_numpy(g.randn(n, *out_hw).astype(np.float32)).to(dev)
    if crop is not None:
        grad[:, crop[0]:] = 0
        grad[:, :, crop[1]:] = 0
    zeroed = 0
    if not tie:
        with torch.no_grad():
            up = torch.sigmoid(scores.resize_bilinear_nchw(masks, out_hw))
            top2 = torch.einsum("bqk,bqhw->bhwk", probs, up).topk(2, dim=-1).values
            del up
            near = (top2[..., 0] - top2[..., 1]) <= 1e-4
            zeroed = int((near & (grad != 0)).sum())
            grad[near] = 0
            del top2, near
    return masks, probs, grad, zeroed


def stage1_kernel_rows(torch, dev, rows, check, checks):
    """Stage 1's score-tail kernels at its shapes (16 images, 176x176 masks to
    704x704). The two forward tails of every step, the anomaly score and the K
    class channels alone (the classes-only mode), against their plain versions
    (f32 sums in another order: 1e-5). The anomaly tail's backward (the gradient
    inside the 700x700 crop), d probs alone (the main path) and with d masks,
    against autograd of the plain version: each entry within 1e-5 of its sum of
    absolute terms (the same backward of |g|); and a small case with forced ties."""
    from multishiftseg_torch.ops import scores

    b = 2 * TRAIN_PAIRS
    g = np.random.RandomState(SEED + 33)
    fmasks = torch.from_numpy(3 * g.randn(b, QUERIES, *S1_MASK_HW).astype(np.float32)).to(dev)
    cls = torch.from_numpy(g.randn(b, QUERIES, CLASSES + 1).astype(np.float32)).to(dev)
    run_a = lambda: scores.anomaly_score_upsampled(cls, fmasks, TRAIN_HW)
    plain_a = lambda: scores.anomaly_score_upsampled_plain(cls, fmasks, TRAIN_HW)
    check("mask_scores_anomaly_stage1_shapes", run_a(), plain_a(), 1e-5, 1e-5)
    checks[-1].update(ms=median_ms(torch, run_a, 20))
    run_c = lambda: scores.semantic_inference_upsampled(cls, fmasks, TRAIN_HW, CLASSES,
                                                        _classes_only=True)
    plain_c = lambda: scores.semantic_inference_upsampled_plain(cls, fmasks, TRAIN_HW, CLASSES,
                                                                _classes_only=True)
    out = run_c()
    err = check("mask_scores_semantic_classes_stage1_shapes", out, plain_c(), 1e-5, 1e-5)
    checks[-1]["shape"] = list(out.shape)
    # per output pixel and query: bilinear taps 7, sigmoid 4, the K sums 2K
    ops = b * TRAIN_HW[0] * TRAIN_HW[1] * QUERIES * (11 + 2 * CLASSES)
    b_ms, b_by = bound(nbytes(fmasks) + b * QUERIES * CLASSES * 4 + nbytes(out), ops)
    rows["mask_scores_semantic_classes"] = {
        "name": "mask_scores_semantic_classes", "route": "cuda",
        "source": "multishiftseg_torch/csrc/mask_scores.cu",
        "replaces": "multishiftseg_tpu/ops/scores.py:25",
        "max_abs_err": err, "ms": median_ms(torch, run_c, 20),
        "plain_ms": median_ms(torch, plain_c, 3), "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None}
    del fmasks, cls, out
    masks, probs, grad, zeroed = tail_backward_inputs(torch, dev, SEED + 30, b, S1_MASK_HW,
                                                      TRAIN_HW, crop=CROP)
    run = lambda: scores.mask_scores_backward(masks, probs, grad, TRAIN_HW)
    run_m = lambda: scores.mask_scores_backward(masks, probs, grad, TRAIN_HW, dmask=True)
    plain = lambda: scores.mask_scores_backward_plain(masks, probs, grad, TRAIN_HW)
    dp, _ = run()
    again, _ = run()
    dp2, dm = run_m()
    want_p, want_m = scores.mask_scores_backward_plain(masks, probs, grad, TRAIN_HW, dmask=True)
    abs_p, abs_m = scores.mask_scores_backward_plain(masks, probs, grad.abs(), TRAIN_HW,
                                                     dmask=True)
    torch.cuda.synchronize()
    err = check_per_entry(checks, "mask_scores_backward_dprobs_stage1_shapes", dp, want_p,
                          abs_p.abs(), 1e-5)
    same = bool(torch.equal(dp, dp2)) and bool(torch.equal(dp, again))
    checks[-1].update(pixels_zeroed_near_ties=zeroed, same_as_with_dmask=bool(torch.equal(dp, dp2)),
                      two_runs_bit_for_bit=bool(torch.equal(dp, again)),
                      ok=checks[-1]["ok"] and same)
    check_per_entry(checks, "mask_scores_backward_dmask_stage1_shapes", dm, want_m, abs_m.abs(),
                    1e-5)
    del want_p, want_m, abs_p, abs_m, dm, dp2, again
    times = {"ms": median_ms(torch, run, 10), "dmask_ms": median_ms(torch, run_m, 5),
             "plain_ms": median_ms(torch, plain, 3)}
    checks.append({"check": "mask_scores_backward_stage1_times", **times, "ok": True})
    # operations the pixels with a gradient need: the forward's per query
    # (bilinear 7, sigmoid 4, the K sums 2K), the max over K, and a multiply
    # and an add into d probs per query and tied class
    pixels = int((grad != 0).sum())
    per_px = QUERIES * (11 + 2 * CLASSES) + CLASSES + 2 * QUERIES
    b_ms, b_by = bound(nbytes(masks, probs, grad) + nbytes(dp), pixels * per_px)
    rows["mask_scores_backward"] = {
        "name": "mask_scores_backward", "route": "cuda",
        "source": "multishiftseg_torch/csrc/mask_scores.cu",
        "replaces": "multishiftseg_tpu/ops/scores.py:39",
        "max_abs_err": err, "ms": times["ms"], "plain_ms": times["plain_ms"],
        "bound_ms": b_ms, "bound_by": b_by,
        # no single PyTorch call computes this gradient
        "library_ms": None}
    del masks, probs, grad, dp
    # forced ties, small: the tied classes share the gradient evenly
    masks, probs, grad, _ = tail_backward_inputs(torch, dev, SEED + 32, 2, (16, 20), (64, 80),
                                                 tie=True)
    dp, dm = scores.mask_scores_backward(masks, probs, grad, (64, 80), dmask=True)
    want_p, want_m = scores.mask_scores_backward_plain(masks, probs, grad, (64, 80), dmask=True)
    abs_p, abs_m = scores.mask_scores_backward_plain(masks, probs, grad.abs(), (64, 80),
                                                     dmask=True)
    torch.cuda.synchronize()
    check_per_entry(checks, "mask_scores_backward_forced_ties_dprobs", dp, want_p, abs_p.abs(), 1e-5)
    even = bool(torch.equal(dp[..., 0], dp[..., 1])) and float(dp[..., 0].abs().max()) > 0
    checks[-1].update(tied_classes_equal=even, ok=checks[-1]["ok"] and even)
    check_per_entry(checks, "mask_scores_backward_forced_ties_dmask", dm, want_m, abs_m.abs(), 1e-5)


def ood_hist_rows(torch, dev, rows, checks):
    """The masked score range and the 8192-bin label-split histogram of one
    map at 720x1280 (the rows' times) and 1024x2048, with void pixels: equal
    to the plain versions bit for bit."""
    from multishiftseg_torch.evals import ood_metrics as om

    rs = np.random.RandomState(SEED + 31)
    times = {}
    for hw in VAL_HW:
        n = hw[0] * hw[1]
        # scores shaped like an anomaly map: most low, the OOD ones higher
        lab = torch.from_numpy(rs.choice([0, 1, 255], size=n, p=[0.75, 0.1, 0.15]).astype(
            np.int32)).to(dev)
        s = torch.from_numpy(rs.beta(2, 5, n).astype(np.float32)).to(dev) + 0.3 * (lab == 1)
        lo, hi = om.masked_min_max(s, lab)
        lo_p, hi_p = om.masked_min_max_plain(s, lab)
        got = om.label_histograms(s, lab, lo, hi, NUM_BINS)
        want = om.label_histograms_plain(s, lab, lo_p, hi_p, NUM_BINS)
        torch.cuda.synchronize()
        same_range = float(lo) == float(lo_p) and float(hi) == float(hi_p)
        same_hist = all(bool(torch.equal(a, c)) for a, c in zip(got, want))
        checks.append({"check": f"ood_hist_{hw[0]}x{hw[1]}", "range_equal": same_range,
                       "histograms_equal": same_hist, "pixels": n,
                       "counted": int(got[0].sum() + got[1].sum()), "ok": same_range and same_hist})

        def library():
            # the same bin arithmetic (elementwise passes), then one bincount
            valid = (lab == 0) | (lab == 1)
            x = ((s - lo) / torch.clamp(hi - lo, min=1e-12) * NUM_BINS).clamp(0, NUM_BINS)
            bins = x.to(torch.int32).clamp(max=NUM_BINS - 1).long() + NUM_BINS * (lab == 0)
            return torch.bincount(torch.where(valid, bins, 2 * NUM_BINS), minlength=2 * NUM_BINS + 1)

        times[hw] = {
            "minmax_ms": median_ms(torch, lambda: om.masked_min_max(s, lab), 50),
            "minmax_plain_ms": median_ms(torch, lambda: om.masked_min_max_plain(s, lab), 20),
            "hist_ms": median_ms(torch, lambda: om.label_histograms(s, lab, lo, hi, NUM_BINS), 50),
            "hist_plain_ms": median_ms(torch, lambda: om.label_histograms_plain(
                s, lab, lo, hi, NUM_BINS), 20),
            "library_ms": median_ms(torch, library, 20),
            "valid": int(((lab == 0) | (lab == 1)).sum()), "bytes": nbytes(s, lab)}
        checks[-1].update({k: v for k, v in times[hw].items()})
    t = times[VAL_HW[0]]
    # bytes: each score and label read once (and the histograms written);
    # operations: a compare and a min and max per valid pixel, six for a bin
    b_mm = bound(t["bytes"] + 8, 3 * t["valid"])
    b_h = bound(t["bytes"] + 2 * NUM_BINS * 4, 6 * t["valid"])
    rows["ood_hist_minmax"] = {
        "name": "ood_hist_minmax", "route": "cuda", "source": "multishiftseg_torch/csrc/ood_hist.cu",
        "replaces": "multishiftseg_tpu/evals/ood_metrics.py:197", "max_abs_err": 0.0,
        "ms": t["minmax_ms"], "plain_ms": t["minmax_plain_ms"], "bound_ms": b_mm[0],
        "bound_by": b_mm[1],
        # no single PyTorch call takes the min and max over a label mask
        "library_ms": None}
    rows["ood_hist"] = {
        "name": "ood_hist", "route": "cuda", "source": "multishiftseg_torch/csrc/ood_hist.cu",
        "replaces": "multishiftseg_tpu/evals/ood_metrics.py:186", "max_abs_err": 0.0,
        "ms": t["hist_ms"], "plain_ms": t["hist_plain_ms"], "bound_ms": b_h[0], "bound_by": b_h[1],
        # torch.bincount over bin + 8192 x label, one call after the same
        # elementwise bin arithmetic (timed with it)
        "library_ms": t["library_ms"]}


def seeded_deeplab(torch, seed):
    """Port DeepWV3Plus (WRN-38, full widths) with seeded weights: the modules'
    own init from ``seed``, and numpy-seeded running statistics (mean 0.1 x
    noise, variance 1 + 0.1 x |noise|), so that no eval BatchNorm is the identity."""
    from multishiftseg_torch.models.deeplab import DeepWV3Plus

    torch.manual_seed(seed)
    model = DeepWV3Plus()
    g = np.random.RandomState(seed)
    with torch.no_grad():
        for name, t in sorted(model.named_buffers()):
            noise = torch.from_numpy((0.1 * g.randn(*t.shape)).astype(np.float32))
            t.add_(noise.abs() if name.endswith("running_var") else noise)
    return model.eval()


def seeded_model(torch, seed, **cfg):
    """Port MaskFormer with seeded weights: the modules' own init, then numpy
    noise on every entry (0.01; 0.1 on the deformable offset/weight heads, which
    init to zero)."""
    from multishiftseg_torch.models.maskformer import MaskFormer

    torch.manual_seed(seed)
    model = MaskFormer(**cfg)
    g = np.random.RandomState(seed)
    with torch.no_grad():
        for name, t in sorted(model.state_dict().items()):
            scale = 0.1 if ("sampling_offsets" in name or "attention_weights" in name) \
                and name.endswith("weight") else 0.01
            t.add_(torch.from_numpy((scale * g.randn(*t.shape)).astype(np.float32)))
    return model.eval()


def attention_mask_hooks(predictor, masks, replay=None):
    """Forward pre-hooks on the decoder's cross-attention layers: each appends
    the (fg, bg) attention masks its layer receives to ``masks`` (on the CPU).
    Given ``replay``, another run's ``masks``, the layer then attends with that
    run's masks instead of its own. Returns the hook handles."""
    def hook(module, args, i):
        masks.append((args[2].cpu(), args[3].cpu()))
        if replay is None:
            return None
        fg, bg = (m.to(args[2].device) for m in replay[i])
        return (*args[:2], fg, bg, *args[4:])

    return [layer.register_forward_pre_hook(lambda m, a, i=i: hook(m, a, i))
            for i, layer in enumerate(predictor.transformer_cross_attention_layers)]


def mask_logit_layers(torch, card, cpu, sizes):
    """The decoder's attention masks and the logits behind them, layer by layer,
    card against CPU.

    The decoder thresholds mask logits at 0 as hard booleans, so a logit within
    rounding of 0 may fall on the other side on the card. The CPU run attends
    with the card's masks (:func:`attention_mask_hooks`), so every layer stays
    comparable; this holds each bit that differs to a logit within rounding
    of 0. ``card`` and ``cpu`` hold the ``embeds`` of every mask prediction
    ([N, Q, C] f32 on the CPU), the ``mask_features`` [N, C, H, W] they multiply
    and the ``masks`` each run computed; layer i's logits are resized to
    ``sizes[i % 3]``, as the decoder does. Per layer: the bits that differ, the
    largest CPU |logit| at one, the largest logit difference, and that difference
    over the absolute scale sum_c |embed_c| |feature_c|. The layer is within
    rounding when the difference, and the CPU |logit| at each differing bit, are
    at most LOGIT_RTOL of that scale.
    """
    from multishiftseg_torch.ops.resize import resize_bilinear_nchw

    def logits(e, m, size):
        return resize_bilinear_nchw(torch.einsum("nqc,nchw->nqhw", e, m), size)

    layers = []
    for i, ((g_fg, g_bg), (c_fg, c_bg)) in enumerate(zip(card["masks"], cpu["masks"])):
        size = sizes[i % 3]
        lg = logits(card["embeds"][i], card["mask_features"], size)
        lc = logits(cpu["embeds"][i], cpu["mask_features"], size)
        scale = logits(cpu["embeds"][i].abs(), cpu["mask_features"].abs(), size)
        tol = LOGIT_RTOL * scale
        err = (lg - lc).abs()
        flip = ((g_fg != c_fg) | (g_bg != c_bg))[:, 0].reshape(lc.shape)
        layers.append({"flips": int(flip.sum()),
                       "max_abs_logit_at_flip": float(lc[flip].abs().max()) if flip.any() else None,
                       "max_logit_diff": float(err.max()),
                       "max_diff_over_scale": float((err / scale.clamp_min(1e-30)).max()),
                       "within_rounding": bool((err <= tol).all()
                                               and (lc[flip].abs() <= tol[flip]).all())})
    return layers


def phase_slice_parity(torch, hw=(256, 512)):
    """Full-width MaskFormer in f32: card with kernels vs CPU with plain versions."""
    from multishiftseg_torch.models.maskformer import inference, preprocess

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu_model = seeded_model(torch, SEED + 3)
    gpu_model = copy.deepcopy(cpu_model).cuda()
    images = np.random.RandomState(SEED + 4).randint(0, 256, (1, *hw, 3)).astype(np.uint8)

    def run(model, dev, replay=None):
        embeds, masks = [], []
        pred = model.sem_seg_head.predictor
        hooks = [pred.mask_embed.register_forward_hook(
            lambda m, i, o: embeds.append(o.float().cpu()))]
        hooks += attention_mask_hooks(pred, masks, replay)
        with torch.no_grad():
            x = preprocess(torch.from_numpy(images).to(dev))
            feats = model.backbone(x.permute(0, 3, 1, 2))
            mf, _, ms = model.sem_seg_head.pixel_decoder(feats)
            out = pred(ms, mf)
            sem, anomaly = inference(out, hw)
        for h in hooks:
            h.remove()
        cpu = lambda t: t.float().cpu()
        return dict(mask_features=cpu(mf), ms=[cpu(t) for t in ms],
                    out={k: cpu(out[k]) for k in ("pred_logits", "pred_masks",
                                                  "pred_logits_ood", "pred_masks_ood")},
                    raw_out=out, sem=cpu(sem), anomaly=cpu(anomaly), embeds=embeds,
                    masks=masks)

    g = run(gpu_model, "cuda")
    c = run(cpu_model, "cpu", replay=g["masks"])
    torch.cuda.synchronize()

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-6))

    res = {"phase": "slice_parity", "image_hw": list(hw), "widths": "full",
           "dtype": "float32", "tf32": False}
    # 1. pixel decoder (backbone + 6 deformable encoder layers + FPN): f32 on
    # both sides, conv algorithms and sums in another order
    res["pixel_decoder_rel_err"] = max([rel(g["mask_features"], c["mask_features"])]
                                       + [rel(a, b) for a, b in zip(g["ms"], c["ms"])])
    # 2. score tail: the card's kernels on the CPU run's predictions
    with torch.no_grad():
        out_c = {k: v.cuda() for k, v in c["raw_out"].items() if k != "aux_outputs"}
        sem_k, an_k = inference(out_c, hw)
    res["tail_max_abs_err"] = max(float((sem_k.cpu() - c["sem"]).abs().max()),
                                  float((an_k.cpu() - c["anomaly"]).abs().max()))
    # 3. the attention masks: a bit may differ only at a logit within rounding
    # of 0, and the CPU then attends with the card's bit
    layers = mask_logit_layers(torch, g, c, [tuple(t.shape[-2:]) for t in c["ms"]])
    res["attention_masks"] = layers
    # 4. end to end
    res["pred_rel_err"] = {k: rel(g["out"][k], c["out"][k]) for k in g["out"]}
    res["sem_max_abs_err"] = float((g["sem"] - c["sem"]).abs().max())
    res["anomaly_max_abs_err"] = float((g["anomaly"] - c["anomaly"]).abs().max())
    res["checks"] = {"pixel_decoder_rel_err<=1e-3": res["pixel_decoder_rel_err"] <= 1e-3,
                     "tail_max_abs_err<=1e-5": res["tail_max_abs_err"] <= 1e-5,
                     "mask_logits_within_rounding": all(x["within_rounding"] for x in layers),
                     "end_to_end": (max(res["pred_rel_err"].values()) <= 1e-3
                                    and res["sem_max_abs_err"] <= 1e-3
                                    and res["anomaly_max_abs_err"] <= 1e-3)}
    res["ok"] = bool(all(res["checks"].values()))
    return res


def profile_request(torch, fwd, image, focus=None):
    """``fwd(image)`` (a request, or a training step) once under torch.profiler:
    device time by kernel name (top 12), the device's busy share of the wall
    time and, with ``focus`` (a string or several), the device time of the
    kernels whose name holds each string and its share of the busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fwd(image)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for e in prof.events():
        # device kernels only: record_function ranges (the optimizer's step,
        # for one) also appear on the device timeline, spanning kernels and gaps
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (end - start) / 1e3, n + 1)
    busy, last = 0.0, None
    for start, end in sorted(spans):  # union of device intervals, us
        if last is None or start > last:
            busy += end - start
            last = end
        elif end > last:
            busy += end - last
            last = end
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    res = {"wall_ms": wall_ms, "device_busy_ms": busy / 1e3,
           "device_busy_share": busy / 1e3 / wall_ms if wall_ms else None,
           "device_events": len(spans), "device_kernel_ms_total": sum(v[0] for v in by_name.values()),
           "top_kernels": [{"name": k[:90], "ms": v[0], "count": v[1]} for k, v in top]}
    for name in (focus,) if isinstance(focus, str) else focus or ():
        ms = sum(v[0] for k, v in by_name.items() if name in k)
        res[f"{name}_ms"] = ms
        res[f"{name}_share_of_busy"] = ms * 1e3 / busy if busy else None
    return res


# the M2F steps' profiles: the device time of the deformable backward (stage 2)
# and of the anomaly tail's d-probs backward (stage 1), by kernel name
STEP_FOCUS = ("msda_backward_kernel", "mask_scores_bwd_dp_kernel")


# the serve phase's settings: (sample_mode, score_lowres, score_topq), and the
# deformable launches each request makes (6 encoder layers; the hybrid 3 + 3)
HYBRID = "bilinear,bilinear,bilinear,nearest_top6c,nearest_top6c,nearest_top6c"
SERVE_SETTINGS = {
    "bilinear": (("bilinear", False, 0), {"ms_deform_attn_bilinear": 6}),
    "nearest": (("nearest", False, 0), {"ms_deform_attn_nearest": 6}),
    "int8": (("int8", False, 0), {"ms_deform_attn_quantize": 6, "ms_deform_attn_int8": 6}),
    "nearest_top6": (("nearest_top6", False, 0), {"ms_deform_attn_nearest_top": 6}),
    "nearest_top6c": (("nearest_top6c", False, 0), {"ms_deform_attn_nearest_topc": 6}),
    "shared": (("shared", False, 0), {"ms_deform_attn_shared": 6}),
    "hybrid": ((HYBRID, False, 0), {"ms_deform_attn_bilinear": 3,
                                    "ms_deform_attn_nearest_topc": 3}),
    "nearest+lowres": (("nearest", True, 0), {"ms_deform_attn_nearest": 6}),
    "nearest+topq32": (("nearest", False, 32), {"ms_deform_attn_nearest": 6}),
}


@contextlib.contextmanager
def tail_launch_shapes(scores):
    """Record (Q, h, w, H, W) of every anomaly-tail launch of ``scores``."""
    seen, orig = [], scores._mask_scores_cuda

    def recording(masks, probs, keep, out_hw, mode):
        if mode == scores._ANOMALY:
            seen.append((*masks.shape[1:], *out_hw))
        return orig(masks, probs, keep, out_hw, mode)

    scores._mask_scores_cuda = recording
    try:
        yield seen
    finally:
        scores._mask_scores_cuda = orig


def phase_serve(torch, requests=3):
    """``build_m2f_request_forward`` in every setting of ``SERVE_SETTINGS``:
    launch counts per request (the setting's deformable entries, one anomaly
    and one semantic tail, nothing else; the anomaly tail at the identity
    resize for ``score_lowres`` and on 32 queries for ``score_topq``), finite
    outputs of the input's shape, latency, and one profiled request."""
    from multishiftseg_torch.evals.ood_metrics import eval_ood_measure
    from multishiftseg_torch.ops import launch_counts, reset_launch_counts, scores
    from multishiftseg_torch.train.test_runner import build_m2f_request_forward

    model = seeded_model(torch, SEED + 5).to(torch.bfloat16)
    h, w = H, W
    g = np.random.RandomState(SEED + 6)
    images = [g.randint(0, 256, (1, h, w, 3)).astype(np.uint8) for _ in range(requests)]
    label = np.zeros((h, w), np.int64)
    side = h // 4
    y0, x0 = g.randint(0, h - side), g.randint(0, w - side)
    label[y0:y0 + side, x0:x0 + side] = 1  # a seeded anomaly square
    res = {"phase": "serve", "model": "MaskFormer R-50 MSDeformAttn+GMA, full widths",
           "dtype": "bfloat16", "image_hw": [h, w], "batch": 1, "modes": {}}
    totals = {}
    ok = True
    n_queries = model.sem_seg_head.predictor.num_queries
    for name, ((mode, lowres, topq), deform) in SERVE_SETTINGS.items():
        fwd = build_m2f_request_forward(model, sample_mode=mode,
                                        score_lowres=lowres, score_topq=topq)
        for im in images[:2]:  # warm-up
            fwd(im)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        latencies, outs = [], []
        with tail_launch_shapes(scores) as tails:
            for im in images:
                t0 = time.perf_counter()
                anomaly, sem = fwd(im)
                torch.cuda.synchronize()
                latencies.append((time.perf_counter() - t0) * 1e3)
                outs.append((anomaly, sem))
        counts = launch_counts()
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        anomaly, sem = outs[-1]
        finite = all(bool(torch.isfinite(a).all() and torch.isfinite(s).all()) for a, s in outs)
        shapes_ok = (tuple(anomaly.shape) == (1, h, w)
                     and tuple(sem.shape) == (1, CLASSES + n_queries, h, w))
        want = {k: 0 for k in counts}
        want.update({k: v * requests for k, v in deform.items()})
        want.update(mask_scores_anomaly=requests, mask_scores_semantic=requests)
        # the anomaly tail: on Q queries (score_topq's), from the stride-4
        # masks of the /32-padded input, to the padded input or (score_lowres)
        # to the masks' own size
        mask_hw = (-(-h // 32) * 8, -(-w // 32) * 8)
        out_hw = mask_hw if lowres else (-(-h // 32) * 32, -(-w // 32) * 32)
        tails_ok = len(tails) == requests and all(
            t == (topq or n_queries, *mask_hw, *out_hw) for t in tails)
        counts_ok = counts == want and tails_ok
        metrics = eval_ood_measure(anomaly[0].float().cpu().numpy(), label)
        mode_ok = finite and shapes_ok and counts_ok and metrics is not None
        ok &= mode_ok
        res["modes"][name] = {
            "sample_mode": mode, "score_lowres": lowres, "score_topq": topq,
            "latency_ms": latencies, "images_per_s": requests / (sum(latencies) / 1e3),
            "launches": {k: v for k, v in counts.items() if v}, "launches_per_image_ok": counts_ok,
            "anomaly_tail_launches_q_h_w_H_W": [list(t) for t in tails[:1]],
            "finite": finite, "shapes_ok": shapes_ok,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "auroc_auprc_fpr95_random_weights": metrics, "ok": mode_ok,
            "profiled_request": profile_request(torch, fwd, images[0])}
    res["ok"] = ok
    return res, totals


def train_config(pairs, crop, bf16):
    from multishiftseg_torch.core.config import load_config

    cfg = load_config(str(Path(__file__).resolve().parent / "exps" / "m2f.yaml"))
    cfg.train.train_batch = pairs
    cfg.data.crop_size = tuple(crop)
    cfg.train.bf16 = bf16
    return cfg


def phase_train_parity(torch, seed, pairs=2, crop=(256, 256), card="cuda"):
    """One stage-2 step at full widths in f32 (TF32 off): the card with kernels
    against the CPU with plain versions, same weights, batch and CPU-made draws,
    all made from ``seed``; and the CPU's step in float64, which the gradients
    of both f32 steps are held against. (``card="cpu"`` rehearses the phase's
    control flow without a card.)"""
    from multishiftseg_torch.ops import launch_counts, reset_launch_counts
    from multishiftseg_torch.train.m2f_trainer import TrainM2FOOD, synthetic_batch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = train_config(pairs, crop, bf16=False)
    base = seeded_model(torch, seed)
    batch = synthetic_batch(pairs, crop, CLASSES, seed + 1)
    trainers = {"card": TrainM2FOOD(cfg, model=copy.deepcopy(base), device=card),
                "cpu": TrainM2FOOD(cfg, model=copy.deepcopy(base), device="cpu"),
                "cpu_f64": TrainM2FOOD(cfg, model=copy.deepcopy(base), device="cpu")}
    for tr in trainers.values():
        tr.set_stage(1)
    trainers["cpu_f64"].model.double()  # in place: the optimizer keeps the same parameters
    draws = trainers["cpu"].draws(2 * pairs, tuple(crop))  # CPU-made, used by both

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev) for v in tree]
        return tree.to(dev)

    runs = {}
    for side, tr in trainers.items():
        # the card runs first; the CPU steps then attend with the card's masks
        rec = {"embeds": [], "masks": []}

        def record_pixel_decoder(m, i, o, r=rec):
            r["mask_features"] = o[0].detach().float().cpu()
            r["ms"] = [t.detach().float().cpu() for t in o[2]]

        head = tr.model.sem_seg_head
        hooks = [head.predictor.mask_embed.register_forward_hook(
                     lambda m, i, o, r=rec: r["embeds"].append(o.detach().float().cpu())),
                 head.pixel_decoder.register_forward_hook(record_pixel_decoder)]
        hooks += attention_mask_hooks(head.predictor, rec["masks"],
                                      runs["card"]["masks"] if side != "card" else None)
        reset_launch_counts()
        try:
            loss, losses, gnorm, assign = tr.stage2_step(*batch, draws=to(draws, tr.device))
            if tr.device.type == "cuda":
                torch.cuda.synchronize()
            rec["launches"] = launch_counts()
        finally:
            for h in hooks:
                h.remove()
        rec.update(loss=float(loss), losses={k: float(v) for k, v in losses.items()},
                   gnorm=float(gnorm), assign=[a.cpu() for a in assign],
                   grads={n: p.grad.detach().float().cpu() for n, p in tr.model.named_parameters()},
                   params={n: p.detach().float().cpu() for n, p in tr.model.named_parameters()})
        runs[side] = rec
    g, c, f = runs["card"], runs["cpu"], runs["cpu_f64"]

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-6))

    res = {"phase": "train_parity", "seed": seed, "pairs": pairs, "crop": list(crop),
           "widths": "full", "dtype": "float32", "tf32": False, "launches": g["launches"],
           "losses_card": g["losses"], "losses_cpu": c["losses"],
           "grad_norm_card": g["gnorm"], "grad_norm_cpu": c["gnorm"]}
    # the pixel decoder's outputs, in the training forward: f32 on both sides,
    # conv algorithms and sums in another order (as slice_parity)
    res["pixel_decoder_rel_err"] = max([rel(g["mask_features"], c["mask_features"])]
                                       + [rel(a, b) for a, b in zip(g["ms"], c["ms"])])
    layers = mask_logit_layers(torch, g, c, [tuple(t.shape[-2:]) for t in c["ms"]])
    res["attention_masks"] = layers
    res["assignment_equal"] = all(torch.equal(a, b) for a, b in zip(g["assign"], c["assign"]))
    res["loss_rel_err"] = {k: abs(g["losses"][k] - v) / max(abs(v), 1e-12)
                           for k, v in c["losses"].items()}
    # per parameter group (backbone / rest, decay or not), the worst tensor by
    # the largest error of its gradient over its largest entry
    def grad_errs(a, b):
        out = {}
        for grp in trainers["cpu"].optimizer.param_groups:
            key = f"lr_x{grp['lr_mult']:g}_{'decay' if grp['decay'] else 'no_decay'}"
            errs = {n: float((a["grads"][n] - b["grads"][n]).abs().max())
                    / max(float(b["grads"][n].abs().max()), 1e-30) for n in grp["names"]}
            worst = max(errs, key=errs.get)
            out[key] = {"err": errs[worst], "tensor": worst}
        return out

    res["grad_rel_err_by_group"] = grad_errs(g, c)
    vs_f64 = {"card": grad_errs(g, f), "cpu": grad_errs(c, f)}
    res["grad_rel_err_vs_f64_by_group"] = vs_f64
    # the card's gradients reach every module upstream of the deformable core
    upstream = ("value_proj", "sampling_offsets", "attention_weights", "input_proj", "backbone")
    res["upstream_grads_nonzero"] = {
        t: all(float(v.abs().max()) > 0 for n, v in g["grads"].items() if t in n)
        for t in upstream}
    # the first AdamW step is about lr * sign(g): compare where the clipped
    # gradient is far above eps and clear of sign noise
    lr = cfg.model.m2f.base_lr
    clip = min(1.0, cfg.model.m2f.clip_gradients_value / c["gnorm"])
    upd = 0.0
    for n, gc in c["grads"].items():
        sel = ((gc * clip).abs() > 1e-6) & (gc.abs() > 1e-2 * gc.abs().max())
        if sel.any():
            upd = max(upd, float((g["params"][n][sel] - c["params"][n][sel]).abs().max()))
    res["param_update_max_abs_err"] = upd
    res["param_update_atol"] = 1e-2 * lr
    counts = g["launches"]
    # the same arithmetic on both sides; losses: f32 sums in another order.
    # Gradients: a ReLU input within f32 rounding of 0 takes either side and
    # moves the whole gradient path below it, on the card as on the CPU (up to
    # 1.3e-2 of a backbone tensor's scale between them; readings in PERF.md).
    # So each f32 step is held against the float64 step: in every group the
    # card's error may be at most 4x the CPU's, plus 1e-3 of scale.
    grad_ok = all(v["err"] <= 4 * vs_f64["cpu"][k]["err"] + 1e-3
                  for k, v in vs_f64["card"].items())
    res["checks"] = {
        "pixel_decoder_rel_err<=1e-3": res["pixel_decoder_rel_err"] <= 1e-3,
        "mask_logits_within_rounding": all(x["within_rounding"] for x in layers),
        "assignment_equal": res["assignment_equal"],
        "loss_rel_err<=1e-3": max(res["loss_rel_err"].values()) <= 1e-3,
        "grad_err_vs_f64<=4x_cpu+1e-3": grad_ok,
        "param_update_err<=1e-2*lr": upd <= 1e-2 * lr,
        "launches_ok": (counts["ms_deform_attn_bilinear"] == 6
                        and counts["ms_deform_attn_bilinear_backward"] == 6
                        and counts["linear_sum_assignment"] >= 1 and counts["label_points"] >= 4),
        "finite": all(np.isfinite(v) for v in list(g["losses"].values()) + [g["gnorm"]]),
        "upstream_grads_nonzero": all(res["upstream_grads_nonzero"].values())}
    res["ok"] = bool(all(res["checks"].values()))
    return res


def phase_train(torch, pairs=TRAIN_PAIRS, warmup=2, timed=3):
    """The stage-2 step at exps/m2f.yaml's settings in bf16 on the card."""
    from multishiftseg_torch.ops import launch_counts, reset_launch_counts
    from multishiftseg_torch.train.m2f_trainer import TrainM2FOOD, synthetic_batch

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"phase": "train", "model": "MaskFormer R-50 MSDeformAttn+GMA, full widths",
           "config": "exps/m2f.yaml", "dtype": "bfloat16 autocast, f32 master weights"}
    trainer = TrainM2FOOD(train_config(pairs, CROP, bf16=True),
                          model=seeded_model(torch, SEED + 12).train(), device="cuda")
    trainer.set_stage(1)
    batch = [torch.from_numpy(x).cuda() for x in synthetic_batch(pairs, CROP, CLASSES, SEED + 13)]
    for _ in range(warmup):
        trainer.stage2_step(*batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times, steps = [], []
    for _ in range(timed):
        t0 = time.perf_counter()
        loss, losses, gnorm, _ = trainer.stage2_step(*batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        steps.append({"loss": float(loss), "grad_norm": float(gnorm),
                      "losses": {k: float(v) for k, v in losses.items()}})
    counts = launch_counts()
    per_step = {k: v / timed for k, v in counts.items()}
    res.update(pairs=pairs, images_per_step=2 * pairs, crop=list(CROP), padded=list(TRAIN_HW),
               step_ms=times, images_per_s=2 * pairs * timed / (sum(times) / 1e3),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, steps=steps,
               launches=counts, launches_per_step=per_step)
    finite = all(np.isfinite(x["loss"]) and np.isfinite(x["grad_norm"])
                 and all(np.isfinite(v) for v in x["losses"].values()) for x in steps)
    launches_ok = (per_step["ms_deform_attn_bilinear"] == 6
                   and per_step["ms_deform_attn_bilinear_backward"] == 6
                   and per_step["linear_sum_assignment"] >= 1 and per_step["label_points"] >= 4
                   and counts["ms_deform_attn_nearest"] == 0
                   and counts["mask_scores_anomaly"] + counts["mask_scores_semantic"]
                   + counts["mask_scores_semantic_classes"] == 0)
    res["profiled_step"] = profile_request(torch, lambda _: trainer.stage2_step(*batch), None,
                                           focus=STEP_FOCUS)
    res["checks"] = {"finite": finite, "launches_ok": launches_ok}
    res["ok"] = bool(all(res["checks"].values()))
    return res, counts


def phase_deeplab_parity(torch, hw=(256, 512), card="cuda"):
    """Full-width WRN-38 DeepLab in f32 (TF32 off): the card (kernels) against
    the CPU (plain versions) from the same weights: trunk output, score, logits.
    (``card="cpu"`` rehearses the phase's control flow without a card.)"""
    from multishiftseg_torch.train.test_runner import build_deeplab_forward

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu_model = seeded_deeplab(torch, SEED + 21)
    gpu_model = copy.deepcopy(cpu_model)
    image = np.random.RandomState(SEED + 22).randn(1, *hw, 3).astype(np.float32)
    res = {"phase": "deeplab_parity", "model": "DeepLab v3+ WRN-38, full widths",
           "image_hw": list(hw), "dtype": "float32", "tf32": False}
    runs = {}
    for side, model, dev in (("card", gpu_model, card), ("cpu", cpu_model, "cpu")):
        trunk = []
        last = list(model.mod7.children())[-1]  # the trunk's last block
        hook = last.register_forward_hook(lambda m, i, o, t=trunk: t.append(o.float().cpu()))
        score, logit = build_deeplab_forward(deeplab_config(1, hw, bf16=False), model=model,
                                             device=dev)(image)
        hook.remove()
        runs[side] = {"trunk": trunk[0], "score": score.cpu(), "logit": logit.cpu()}

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-6))

    g, c = runs["card"], runs["cpu"]
    for k in ("trunk", "score", "logit"):
        res[f"{k}_rel_err"] = rel(g[k], c[k])
    res["score_abs_max"] = float(c["score"].abs().max())
    res["logit_abs_max"] = float(c["logit"].abs().max())
    # f32 on both sides; conv algorithms and sums in another order over 38
    # layers (the M2F slice's pixel decoder held 1e-3)
    res["checks"] = {f"{k}_rel_err<=1e-4": res[f"{k}_rel_err"] <= 1e-4
                     for k in ("trunk", "score", "logit")}
    res["checks"]["shapes"] = (tuple(g["score"].shape) == (1, *hw)
                               and tuple(g["logit"].shape) == (1, CLASSES, *hw))
    res["ok"] = bool(all(res["checks"].values()))
    return res


def phase_deeplab_serve(torch, requests=3):
    """``build_deeplab_forward`` at 1024x2048, batch 1, bf16 autocast over the
    f32 weights: 3 requests after 2 warm-up, with their launch counts."""
    from multishiftseg_torch.evals.ood_metrics import eval_ood_measure
    from multishiftseg_torch.ops import launch_counts, reset_launch_counts
    from multishiftseg_torch.train.test_runner import build_deeplab_forward

    torch.backends.cudnn.allow_tf32 = True
    fwd = build_deeplab_forward(deeplab_config(1, DL_CROP, bf16=True),
                                model=seeded_deeplab(torch, SEED + 23), device="cuda")
    g = np.random.RandomState(SEED + 24)
    images = [g.randn(1, H, W, 3).astype(np.float32) for _ in range(requests)]
    label = np.zeros((H, W), np.int64)
    label[H // 3:H // 2, W // 3:W // 2] = 1  # an anomaly rectangle
    for im in images[:2]:
        fwd(im)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    latencies, outs = [], []
    for im in images:
        t0 = time.perf_counter()
        score, logit = fwd(im)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
        outs.append((score, logit))
    counts = launch_counts()
    score, logit = outs[-1]
    finite = all(bool(torch.isfinite(a).all() and torch.isfinite(b).all()) for a, b in outs)
    shapes_ok = tuple(score.shape) == (1, H, W) and tuple(logit.shape) == (1, CLASSES, H, W)
    counts_ok = (counts["dilated_conv3x3"] == 3 * requests
                 and all(v == 0 for k, v in counts.items() if k != "dilated_conv3x3"))
    metrics = eval_ood_measure(score[0].float().cpu().numpy(), label)
    res = {"phase": "deeplab_serve", "model": "DeepLab v3+ WRN-38, full widths",
           "dtype": "bfloat16 autocast, f32 weights", "image_hw": [H, W], "batch": 1,
           "latency_ms": latencies, "images_per_s": requests / (sum(latencies) / 1e3),
           "launches": counts, "launches_per_image_ok": counts_ok, "finite": finite,
           "shapes_ok": shapes_ok, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "auroc_auprc_fpr95_random_weights": metrics,
           "profiled_request": profile_request(torch, fwd, images[0], focus="dconv")}
    res["ok"] = bool(finite and shapes_ok and counts_ok and metrics is not None)
    return res, counts


def deeplab_config(pairs, crop, bf16):
    from multishiftseg_torch.core.config import load_config

    cfg = load_config(str(Path(__file__).resolve().parent / "exps" / "deeplab.yaml"))
    cfg.train.train_batch = pairs
    cfg.data.crop_size = tuple(crop)
    cfg.train.bf16 = bf16
    return cfg


def relu_sign_flips(a, b):
    """ReLU units whose input lies on other sides of 0 in two runs (records of
    ``relu_sign_hooks``): the frozen trunk's, which move values by rounding
    only, and the head's, on the gradient path, by module."""
    per = {n: int((a[n] != b[n]).sum()) for n in a}
    head = {n: v for n, v in per.items() if v and not n.startswith("mod")}
    return {"trunk": sum(v for n, v in per.items() if n.startswith("mod")),
            "head": sum(head.values()), "head_modules": head}


def selected_pixels(torch, logit, tgt_aug, params):
    """The augmented half's pixel selection as ``rel_contrastive_loss`` makes
    it (keys below and at the k-th smallest) from a step's logits [2B, C, H, W]."""
    from multishiftseg_torch.losses import rcl

    t = torch.as_tensor(tgt_aug).long()
    valid = t < params.in_id
    ce = rcl._pixel_ce(logit[logit.shape[0] // 2:].permute(0, 2, 3, 1),
                       torch.where(valid, t, torch.full_like(t, params.void_id)), valid)
    keys = torch.where(valid, ce, torch.full_like(ce, float("inf"))).reshape(-1)
    bits = keys.view(torch.int32).long() & 0xFFFFFFFF
    k = int((params.selection_ratio * valid.sum()).to(torch.int32))
    return bits <= torch.sort(bits).values[k - 1]


def phase_deeplab_train_parity(torch, seed, pairs=2, crop=(200, 200), card="cuda"):
    """One stage-0 and then one stage-1 step of ``TrainDeepLabOOD`` at full
    widths in f32 (TF32 off): the card (kernels) against the CPU (plain
    versions), same weights, batch and CPU-made draws; and the CPU's step in
    float64. Stage 0's gradient (``ood_head``) crosses no ReLU and is held
    against float64 directly. Stage 1's crosses the head's ReLUs, where an
    input within f32 rounding of 0 moves a whole gradient path: the phase
    counts those flips (and the pixel selection's) between the steps, and
    holds the card's gradients against a float64 step on the card's ReLU
    branches (``relu_sign_hooks``). ``card="cpu"`` rehearses the control flow."""
    from multishiftseg_torch.ops import launch_counts, reset_launch_counts
    from multishiftseg_torch.train.deeplab_trainer import TrainDeepLabOOD, synthetic_batch
    from multishiftseg_torch.utils import relu_sign_hooks

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = deeplab_config(pairs, crop, bf16=False)
    base = seeded_deeplab(torch, seed)
    batch = synthetic_batch(pairs, crop, CLASSES, seed + 1)
    trainers = {"card": TrainDeepLabOOD(cfg, model=copy.deepcopy(base), device=card),
                "cpu": TrainDeepLabOOD(cfg, model=copy.deepcopy(base), device="cpu"),
                "cpu_f64": TrainDeepLabOOD(cfg, model=copy.deepcopy(base), device="cpu")}
    trainers["cpu_f64"].model.double()  # in place: the optimizer keeps the same parameters
    res = {"phase": "deeplab_train_parity", "seed": seed, "pairs": pairs, "crop": list(crop),
           "widths": "full", "dtype": "float32", "tf32": False, "stages": []}
    ok = True
    for stage in (0, 1):
        draws = trainers["cpu"].draws(2 * pairs, tuple(crop))  # CPU-made, used by all
        steps = list(trainers.items())
        if stage == 1:
            # the float64 step again from the same state, on the card's branches
            twin = TrainDeepLabOOD(cfg, model=copy.deepcopy(base), device="cpu")
            twin.model.double()
            twin.model.load_state_dict(trainers["cpu_f64"].model.state_dict())
            steps.append(("cpu_f64_card_branches", twin))
        runs, signs = {}, {}
        for side, tr in steps:
            tr.set_stage(stage)
            dev = tr.device
            # copies: .double() of a float64 tensor is the tensor itself
            snap = lambda t: t.detach().to("cpu", torch.float64, copy=True)
            before = {n: snap(p) for n, p in tr.model.named_parameters()}
            signs[side], out = {}, {}
            hooks = relu_sign_hooks(tr.model, signs[side], replay=signs["card"] if (
                side == "cpu_f64_card_branches") else None)
            hooks.append(tr.model.register_forward_hook(
                lambda m, a, o, out=out: out.update(logit=o[1].detach().float().cpu())))
            reset_launch_counts()
            loss, aux = tr.step(*batch, draws={"rcl_noise": draws["rcl_noise"].to(dev),
                                               "dropout": {k: v.to(dev) for k, v in
                                                           draws["dropout"].items()}})
            if dev.type == "cuda":
                torch.cuda.synchronize()
            for h in hooks:
                h.remove()
            runs[side] = {
                "launches": launch_counts(), "loss": float(loss),
                "aux": {k: float(v) for k, v in aux.items()},
                "grads": {n: snap(p.grad) for n, p in tr.model.named_parameters()
                          if p.grad is not None},
                "params": {n: snap(p) for n, p in tr.model.named_parameters()},
                "stats": {n: snap(b) for n, b in tr.model.named_buffers()},
                "selected": selected_pixels(torch, out["logit"], batch[3], tr.rcl_params)}
            runs[side]["delta"] = {n: runs[side]["params"][n] - before[n] for n in before}
        g, c, f = runs["card"], runs["cpu"], runs["cpu_f64"]
        ref = runs["cpu_f64_card_branches"] if stage == 1 else f

        def rel_errs(run, want):
            """Per trainable tensor, the error against ``want`` over its scale."""
            return {n: float((run["grads"][n] - w).abs().max()) / (float(w.abs().max()) + 1e-30)
                    for n, w in want["grads"].items()}

        vs_f64, vs_f64_cpu, vs_ref = rel_errs(g, f), rel_errs(c, f), rel_errs(g, ref)
        worst, worst_ref = max(vs_f64, key=vs_f64.get), max(vs_ref, key=vs_ref.get)
        stat_err = max(float((g["stats"][n] - v).abs().max() / v.abs().max().clamp_min(1e-12))
                       for n, v in c["stats"].items())
        # this step's update against the float64 step's on the same branches
        # (Adam's first step is about lr * sign(g)), where the gradient is far
        # above eps and clear of sign noise: an earlier step's sign noise, and
        # the card's and the CPU's other ReLU branches, stay out of it
        lr = cfg.train.lr if stage == 0 else cfg.train.lr_update
        upd = 0.0
        for name, gr in ref["grads"].items():
            # the gradient Adam sees, the L2 term added
            gr = gr + cfg.train.weight_decay * (ref["params"][name] - ref["delta"][name])
            sel = (gr.abs() > 1e-6) & (gr.abs() > 1e-2 * gr.abs().max())
            if sel.any():
                upd = max(upd, float((g["delta"][name][sel] - ref["delta"][name][sel]).abs().max()))
        upd_atol = 1e-2 * lr + 2.0 ** -21 * max(float(v.abs().max()) for v in c["params"].values())
        frozen_same = all(torch.equal(g["params"][n], c["params"][n]) and torch.equal(
            c["params"][n], base.state_dict()[n].double()) for n in c["params"] if n not in c["grads"])
        counts = g["launches"]
        pairs_ = (("card", "cpu_f64"), ("cpu", "cpu_f64"), ("card", "cpu"))
        st = {"stage": stage, "loss_card": g["loss"], "loss_cpu": c["loss"],
              "loss_f64": f["loss"], "aux_card": g["aux"], "aux_cpu": c["aux"],
              "trainable_tensors": len(vs_f64),
              "grad_err_vs_f64_worst": {"tensor": worst, "card": vs_f64[worst],
                                        "cpu": vs_f64_cpu[worst]},
              "relu_units": sum(int(m.numel()) for m in signs["card"].values()),
              "relu_sign_flips": {f"{a}_vs_{b}": relu_sign_flips(signs[a], signs[b])
                                  for a, b in pairs_},
              "selected_pixels": int(g["selected"].sum()),
              "selection_flips": {f"{a}_vs_{b}": int((runs[a]["selected"] != runs[b]["selected"]
                                                      ).sum()) for a, b in pairs_},
              "running_stat_rel_err": stat_err, "param_update_max_abs_err": upd,
              "param_update_atol": upd_atol, "launches": counts}
        if stage == 1:
            st["grad_err_vs_f64_on_card_branches_worst"] = {
                "tensor": worst_ref, "card": vs_ref[worst_ref]}
        st["checks"] = {
            "loss_rel_err<=1e-5": all(abs(g["aux"][k] - v) <= 1e-5 * max(abs(v), 1e-6)
                                      for k, v in c["aux"].items())
            and abs(g["loss"] - c["loss"]) <= 1e-5 * abs(c["loss"]),
            # stage 0: against the float64 step; stage 1: against the float64
            # step on the card's ReLU branches
            "grad_err_vs_f64<=1e-3": all(e <= 1e-3 for e in vs_ref.values()),
            "running_stats_rel_err<=1e-4": stat_err <= 1e-4,
            "param_update_err<=1e-2*lr+4ulp": upd <= upd_atol,
            "frozen_unchanged": frozen_same,
            "launches_ok": (card == "cpu" or (
                counts["dilated_conv3x3"] == 3 and counts["bottom_k_sum"] == 1
                and counts["dilated_conv3x3_wgrad"] == (3 if stage == 1 else 0))),
            "finite": bool(np.isfinite(g["loss"]))}
        st["ok"] = bool(all(st["checks"].values()))
        ok &= st["ok"]
        res["stages"].append(st)
    res["ok"] = bool(ok)
    return res


def phase_deeplab_train(torch, pairs=DL_TRAIN_PAIRS, warmup=2, timed=3):
    """Stage 0 and then stage 1 at exps/deeplab.yaml's settings (8 pairs of
    700x700 crops, bf16 autocast, f32 master weights) on the card: each with
    warm-up and timed steps, their launch counts and one profiled step."""
    from multishiftseg_torch.ops import launch_counts, reset_launch_counts
    from multishiftseg_torch.train.deeplab_trainer import TrainDeepLabOOD, synthetic_batch

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"phase": "deeplab_train", "model": "DeepLab v3+ WRN-38, full widths",
           "config": "exps/deeplab.yaml", "dtype": "bfloat16 autocast, f32 master weights",
           "pairs": pairs, "images_per_step": 2 * pairs, "crop": list(DL_CROP), "stages": []}
    trainer = TrainDeepLabOOD(deeplab_config(pairs, DL_CROP, bf16=True),
                              model=seeded_deeplab(torch, SEED + 25), device="cuda")
    batch = [torch.from_numpy(x).cuda() for x in synthetic_batch(pairs, DL_CROP, CLASSES,
                                                                 SEED + 26)]
    totals, ok = {}, True
    for stage in (0, 1):
        trainer.set_stage(stage)
        losses = [float(trainer.step(*batch)[0]) for _ in range(warmup)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        times, steps = [], []
        for _ in range(timed):
            t0 = time.perf_counter()
            loss, aux = trainer.step(*batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            steps.append({"loss": float(loss), **{k: float(v) for k, v in aux.items()}})
        counts = launch_counts()
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        per_step = {k: v / timed for k, v in counts.items()}
        losses += [x["loss"] for x in steps]
        finite = all(np.isfinite(v) for x in steps for v in x.values())
        launches_ok = (per_step["dilated_conv3x3"] == 3 and per_step["bottom_k_sum"] == 1
                       and per_step["dilated_conv3x3_wgrad"] == (3 if stage == 1 else 0)
                       and all(v == 0 for k, v in counts.items() if k not in (
                           "dilated_conv3x3", "dilated_conv3x3_wgrad", "bottom_k_sum")))
        st = {"stage": stage, "trainable": list(
                  (trainer.cfg.model.trainable_params_name,
                   trainer.cfg.model.trainable_params_name_update)[stage]),
              "lr": trainer.optimizer.param_groups[0]["lr"], "step_ms": times,
              "images_per_s": 2 * pairs * timed / (sum(times) / 1e3),
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "steps": steps,
              "losses_all_steps": losses, "losses_falling": losses[-1] < losses[0],
              "launches": counts, "launches_per_step": per_step,
              "profiled_step": profile_request(torch, lambda _: trainer.step(*batch), None,
                                               focus="dconv")}
        st["checks"] = {"finite": finite, "launches_ok": launches_ok}
        st["ok"] = bool(all(st["checks"].values()))
        ok &= st["ok"]
        res["stages"].append(st)
    res["ok"] = bool(ok)
    return res, totals


def phase_stage1_parity(torch, seed=SEED + 40, pairs=2, crop=(256, 256), card="cuda"):
    """One stage-1 step (``set_stage(0)``: RCL on the anomaly score, Adam over
    ``class_embed2``) at full widths in f32 (TF32 off): the card (kernels)
    against the CPU (plain versions), same weights, batch and CPU-made RCL
    noise, and the CPU's step in float64, which the card's gradient is held
    against. The CPU runs attend with the card's attention masks
    (``attention_mask_hooks``), whose flipped bits are counted. ``card="cpu"``
    rehearses the control flow."""
    from multishiftseg_torch.ops import launch_counts, reset_launch_counts
    from multishiftseg_torch.train.m2f_trainer import TrainM2FOOD, synthetic_batch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = train_config(pairs, crop, bf16=False)
    base = seeded_model(torch, seed)
    batch = synthetic_batch(pairs, crop, CLASSES, seed + 1)
    trainers = {"card": TrainM2FOOD(cfg, model=copy.deepcopy(base), device=card),
                "cpu": TrainM2FOOD(cfg, model=copy.deepcopy(base), device="cpu"),
                "cpu_f64": TrainM2FOOD(cfg, model=copy.deepcopy(base), device="cpu")}
    trainers["cpu_f64"].model.double()  # in place: the optimizer keeps the same parameters
    noise = trainers["cpu"].draws(2 * pairs, tuple(crop))["rcl_noise"]  # CPU-made, used by all
    head = "sem_seg_head.predictor.class_embed2."
    snap = lambda t: t.detach().to("cpu", torch.float64, copy=True)
    runs = {}
    for side, tr in trainers.items():
        masks = []
        hooks = attention_mask_hooks(tr.model.sem_seg_head.predictor, masks,
                                     runs["card"]["masks"] if side != "card" else None)
        before = {n: snap(p) for n, p in tr.model.named_parameters()}
        reset_launch_counts()
        try:
            loss, aux = tr.stage1_step(*batch, draws={"rcl_noise": noise.to(tr.device)})
            if tr.device.type == "cuda":
                torch.cuda.synchronize()
        finally:
            for h in hooks:
                h.remove()
        runs[side] = {
            "launches": launch_counts(), "masks": masks, "loss": float(loss),
            "aux": {k: float(v) for k, v in aux.items()},
            "grads": {n: snap(p.grad) for n, p in tr.model.named_parameters()
                      if p.grad is not None},
            "delta": {n: snap(p) - before[n] for n, p in tr.model.named_parameters()},
            "params": before}
    g, c, f = runs["card"], runs["cpu"], runs["cpu_f64"]
    flips = sum(int((a[0] != b[0]).sum() + (a[1] != b[1]).sum())
                for a, b in zip(g["masks"], runs["cpu"]["masks"]))
    grad_err = {n: float((g["grads"][n] - w).abs().max()) / float(w.abs().max())
                for n, w in f["grads"].items()}
    # Adam's first step is about lr * sign(g + wd * p): where that is far above
    # eps and clear of sign noise, the card's update meets the float64 step's
    lr, wd = cfg.train.lr, cfg.train.weight_decay
    upd = 0.0
    for n, gr in f["grads"].items():
        gr = gr + wd * f["params"][n]
        sel = (gr.abs() > 1e-6) & (gr.abs() > 1e-2 * gr.abs().max())
        upd = max(upd, float((g["delta"][n][sel] - f["delta"][n][sel]).abs().max()))
    frozen_same = all(float(v.abs().max()) == 0 for run in runs.values()
                      for n, v in run["delta"].items() if not n.startswith(head))
    counts = g["launches"]
    res = {"phase": "stage1_parity", "seed": seed, "pairs": pairs, "crop": list(crop),
           "widths": "full", "dtype": "float32", "tf32": False, "loss_card": g["loss"],
           "loss_cpu": c["loss"], "loss_f64": f["loss"], "aux_card": g["aux"], "aux_cpu": c["aux"],
           "attention_mask_bits_flipped": flips, "trainable": sorted(f["grads"]),
           "grad_err_vs_f64": grad_err,
           "grad_err_vs_f64_cpu_f32": {n: float((c["grads"][n] - w).abs().max())
                                       / float(w.abs().max()) for n, w in f["grads"].items()},
           "param_update_max_abs_err": upd, "param_update_atol": 1e-2 * lr, "launches": counts}
    res["checks"] = {
        "loss_rel_err<=1e-5": all(abs(g["aux"][k] - v) <= 1e-5 * max(abs(v), 1e-6)
                                  for k, v in c["aux"].items())
        and abs(g["loss"] - c["loss"]) <= 1e-5 * abs(c["loss"]),
        "only_class_embed2_trains": sorted(f["grads"]) == [head + "bias", head + "weight"],
        "grad_err_vs_f64<=1e-3": all(e <= 1e-3 for e in grad_err.values()),
        "param_update_err<=1e-2*lr": upd <= 1e-2 * lr,
        "others_unchanged": frozen_same,
        "launches_ok": card == "cpu" or (
            counts["mask_scores_backward"] == 1 and counts["mask_scores_anomaly"] == 1
            and counts["mask_scores_semantic_classes"] == 1
            and counts["mask_scores_semantic"] == 0 and counts["ms_deform_attn_bilinear"] == 6
            and counts["ms_deform_attn_bilinear_backward"] == 0),
        "finite": bool(np.isfinite(g["loss"]))}
    res["ok"] = bool(all(res["checks"].values()))
    return res


def phase_stage1_train(torch, pairs=TRAIN_PAIRS, warmup=2, timed=3):
    """Stage 1 at exps/m2f.yaml's settings (8 pairs of 700x700 crops padded to
    704, bf16 autocast, f32 master weights): 2 warm-up and 3 timed steps with
    their launch counts, peak memory and one profiled step; then
    ``set_stage(1)`` and one stage-2 step."""
    from multishiftseg_torch.ops import launch_counts, reset_launch_counts
    from multishiftseg_torch.train.m2f_trainer import TrainM2FOOD, synthetic_batch

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"phase": "stage1_train", "model": "MaskFormer R-50 MSDeformAttn+GMA, full widths",
           "config": "exps/m2f.yaml", "dtype": "bfloat16 autocast, f32 master weights",
           "pairs": pairs, "images_per_step": 2 * pairs, "crop": list(CROP),
           "padded": list(TRAIN_HW)}
    trainer = TrainM2FOOD(train_config(pairs, CROP, bf16=True),
                          model=seeded_model(torch, SEED + 41), device="cuda")
    batch = [torch.from_numpy(x).cuda() for x in synthetic_batch(pairs, CROP, CLASSES, SEED + 42)]
    frozen = "sem_seg_head.predictor.class_embed.weight"
    params = dict(trainer.model.named_parameters())
    start = {n: params[n].detach().clone() for n in (frozen, "sem_seg_head.predictor.class_embed2.weight")}
    losses = [float(trainer.stage1_step(*batch)[0]) for _ in range(warmup)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times, steps = [], []
    for _ in range(timed):
        t0 = time.perf_counter()
        loss, aux = trainer.stage1_step(*batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        steps.append({"loss": float(loss), **{k: float(v) for k, v in aux.items()}})
    counts = launch_counts()
    per_step = {k: v / timed for k, v in counts.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    profiled = profile_request(torch, lambda _: trainer.stage1_step(*batch), None,
                               focus=STEP_FOCUS)
    moved = {n: float((params[n].detach() - v).abs().max()) for n, v in start.items()}
    trainer.set_stage(1)
    reset_launch_counts()
    t0 = time.perf_counter()
    loss2, losses2, gnorm, _ = trainer.stage2_step(*batch)
    torch.cuda.synchronize()
    switch = {"stage2_step_ms": (time.perf_counter() - t0) * 1e3, "loss": float(loss2),
              "grad_norm": float(gnorm), "losses": {k: float(v) for k, v in losses2.items()},
              "launches": launch_counts(),
              "trainable_tensors": sum(p.requires_grad for p in trainer.model.parameters())}
    launches_ok = (per_step["mask_scores_backward"] == 1 and per_step["mask_scores_anomaly"] == 1
                   and per_step["mask_scores_semantic_classes"] == 1
                   and per_step["ms_deform_attn_bilinear"] == 6
                   and all(v == 0 for k, v in counts.items() if k not in (
                       "mask_scores_backward", "mask_scores_anomaly",
                       "mask_scores_semantic_classes", "ms_deform_attn_bilinear")))
    finite = all(np.isfinite(v) for x in steps for v in x.values())
    res.update(step_ms=times, images_per_s=2 * pairs * timed / (sum(times) / 1e3),
               peak_mem_gib=peak, steps=steps, losses_warmup=losses, launches=counts,
               launches_per_step=per_step, param_change_over_5_steps=moved,
               profiled_step=profiled, after_set_stage_1=switch)
    res["checks"] = {
        "finite": finite, "launches_ok": launches_ok,
        "only_class_embed2_moved": moved[frozen] == 0 and moved[
            "sem_seg_head.predictor.class_embed2.weight"] > 0,
        "stage2_step_after_switch": bool(np.isfinite(switch["loss"]) and np.isfinite(
            switch["grad_norm"]) and switch["launches"]["ms_deform_attn_bilinear_backward"] == 6)}
    res["ok"] = bool(all(res["checks"].values()))
    return res, counts


def synthetic_val_set(sizes, seed):
    """An in-memory validation set: normalised f32 images and label maps (an
    anomaly rectangle of 1, the rest 0, a tenth of the pixels void 255)."""
    g = np.random.RandomState(seed)
    items = []
    for i, (h, w) in enumerate(sizes):
        lab = np.zeros((h, w), np.int32)
        y0, x0 = g.randint(0, h // 2), g.randint(0, w // 2)
        lab[y0:y0 + h // 4, x0:x0 + w // 4] = 1
        lab[g.rand(h, w) < 0.1] = 255
        items.append((g.randn(h, w, 3).astype(np.float32), lab, f"val{i}"))

    class InMemory:
        def __len__(self):
            return len(items)

        def __getitem__(self, i):
            return items[i]

    return InMemory()


def phase_validate(torch, device="cuda", sizes=(VAL_HW[0],) * 6 + (VAL_HW[1],) * 4,
                   m2f=None, deeplab=None):
    """``TrainM2FOOD.valid`` and ``TrainDeepLabOOD.valid`` (bf16 autocast, full
    widths) over 10 in-memory images in two shape buckets. A first, untimed
    pass warms up each bucket and records the maps the meter sees (at its
    ``update``); a second pass with the plain meter is timed, and its launches
    are the path's. Both passes' binned metrics lie within 2 / 8192 of the
    exact ones on the recorded maps. ``device="cpu"`` with small models
    rehearses the control flow."""
    from multishiftseg_torch.evals.ood_metrics import BinnedOODMeter, eval_ood_measure
    from multishiftseg_torch.ops import launch_counts, reset_launch_counts
    from multishiftseg_torch.train import validation
    from multishiftseg_torch.train.deeplab_trainer import TrainDeepLabOOD
    from multishiftseg_torch.train.m2f_trainer import TrainM2FOOD

    torch.backends.cudnn.allow_tf32 = True
    ds = synthetic_val_set(sizes, SEED + 50)
    seen = []

    class RecordingMeter(BinnedOODMeter):
        def update(self, scores, labels):
            seen.append((scores.float().cpu().numpy().reshape(-1), np.asarray(labels).reshape(-1)))
            super().update(scores, labels)

    res = {"phase": "validate", "images": [list(hw) for hw in sizes], "bins": NUM_BINS,
           "models": {}}
    totals, ok = {}, True
    trainers = {
        "m2f": lambda: TrainM2FOOD(train_config(1, CROP, bf16=device != "cpu"),
                                   model=m2f or seeded_model(torch, SEED + 51), device=device),
        "deeplab": lambda: TrainDeepLabOOD(deeplab_config(1, DL_CROP, bf16=device != "cpu"),
                                           model=deeplab or seeded_deeplab(torch, SEED + 52),
                                           device=device)}
    sync = (lambda: None) if device == "cpu" else torch.cuda.synchronize
    keys = ("AUROC", "AUPRC", "FPR_TPR95")
    for name, make in trainers.items():
        tr = make()
        seen.clear()
        validation.BinnedOODMeter = RecordingMeter
        try:
            t0 = time.perf_counter()
            recorded = tr.valid(ds)  # untimed: warm-up of both buckets, maps recorded
            sync()
            cold = time.perf_counter() - t0
        finally:
            validation.BinnedOODMeter = BinnedOODMeter
        reset_launch_counts()
        t0 = time.perf_counter()
        metrics = tr.valid(ds)
        sync()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        exact = dict(zip(keys, eval_ood_measure(np.concatenate([s for s, _ in seen]),
                                                np.concatenate([lb for _, lb in seen]))))
        diff = {k: abs(metrics[k] - exact[k]) for k in keys}
        diff_recorded = {k: abs(recorded[k] - exact[k]) for k in keys}
        m = {"binned": metrics, "binned_recorded_pass": recorded, "exact": exact,
             "abs_diff": diff, "abs_diff_recorded_pass": diff_recorded, "seconds": seconds,
             "seconds_per_image": seconds / len(sizes),
             "first_pass_seconds_with_recording": cold, "maps": len(seen), "launches": counts}
        m["checks"] = {
            "within_2_bins": all(v <= 2 / NUM_BINS for v in list(diff.values())
                                 + list(diff_recorded.values())),
            "finite": all(np.isfinite(v) for v in metrics.values()),
            "every_map_metered": len(seen) == len(sizes),
            "launches_ok": device == "cpu" or (counts["ood_hist"] == len(sizes)
                                               and counts["ood_hist_minmax"] == len(sizes))}
        m["ok"] = bool(all(m["checks"].values()))
        ok &= m["ok"]
        res["models"][name] = m
        del tr
    res["ok"] = bool(ok)
    return res, totals


def phase_evaluate(torch, device="cuda", hw=VAL_HW[0], n_images=4, m2f=None, deeplab=None,
                   extra_yaml=None):
    """The eval CLI (``test_runner.main``), ``--model m2f`` and ``--model
    deeplab``, on a temporary SMIYC RoadAnomaly21 folder (jpg images and
    ``_labels_semantic.png`` labels, 4 images of 720x1280) named in a
    temporary YAML, with ``--weight_path`` a detectron2-style ``{"model": sd}``
    file of the seeded port model and ``--save_outputs``: finite metrics and
    artifacts of the images' shape; then :func:`evaluate_approximate` on the
    m2f run. ``device="cpu"`` with small models (and their widths in
    ``extra_yaml``) rehearses the control flow."""
    import os
    import tempfile

    import yaml
    from PIL import Image

    from multishiftseg_torch.ops import launch_counts, reset_launch_counts
    from multishiftseg_torch.train import test_runner

    res = {"phase": "evaluate", "images": n_images, "image_hw": list(hw), "models": {}}
    totals, ok, runs = {}, True, {}
    g = np.random.RandomState(SEED + 60)
    here = Path(__file__).resolve().parent
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "dataset_AnomalyTrack"
        (root / "images").mkdir(parents=True)
        (root / "labels_masks").mkdir()
        for i in range(n_images):
            Image.fromarray(g.randint(0, 256, (*hw, 3)).astype(np.uint8)).save(
                root / "images" / f"val{i}.jpg", quality=90)
            lab = np.zeros(hw, np.uint8)
            lab[hw[0] // 3:hw[0] // 2, hw[1] // 4:hw[1] // 2] = 1
            lab[g.rand(*hw) < 0.1] = 255
            Image.fromarray(lab).save(root / "labels_masks" / f"val{i}_labels_semantic.png")
        models = {"m2f": (m2f or (lambda: seeded_model(torch, SEED + 61)), "m2f.yaml"),
                  "deeplab": (deeplab or (lambda: seeded_deeplab(torch, SEED + 62)), "deeplab.yaml")}
        for name, (make, base) in models.items():
            cfg_path = Path(tmp) / f"{name}.yaml"
            y = {"base": str(here / "exps" / base), "data": {"anomaly_track_root": str(root)},
                 **((extra_yaml or {}).get(name, {}))}
            cfg_path.write_text(yaml.safe_dump(y))
            weights = Path(tmp) / f"{name}.pth"
            torch.save({"model": make().state_dict()}, weights)
            out = Path(tmp) / f"out_{name}"
            argv = ["--model", name, "--cfg", str(cfg_path), "--weight_path", str(weights),
                    "--test_dataset", "RoadAnomaly21", "--save_outputs", str(out),
                    "--device", device]
            os.chdir(tmp)  # the config loader writes ckpts/<id> under the working directory
            try:
                reset_launch_counts()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(sys.stderr):  # the CLI prints its results
                    results = test_runner.main(argv)
                seconds = time.perf_counter() - t0
                counts = launch_counts()
            finally:
                os.chdir(cwd)
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
            metrics = results.get("RoadAnomaly21", {})
            arts = sorted((out / "RoadAnomaly21").glob("*_anomaly.npy"))
            colors = sorted((out / "RoadAnomaly21").glob("*_pred_color.png"))
            shapes_ok = (len(arts) == n_images == len(colors)
                         and all(np.load(a).shape == tuple(hw) for a in arts)
                         and all(Image.open(c).size == (hw[1], hw[0]) for c in colors))
            m = {"metrics": metrics, "seconds_with_model_load": seconds,
                 "seconds_per_image_with_model_load": seconds / n_images, "launches": counts,
                 "artifacts": len(arts) + len(colors)}
            m["checks"] = {"metrics_finite": len(metrics) == 3 and all(
                np.isfinite(v) for v in metrics.values()), "artifacts_shape": shapes_ok}
            m["ok"] = bool(all(m["checks"].values()))
            ok &= m["ok"]
            res["models"][name] = m
            runs[name] = (cfg_path, weights, metrics)
        cfg_path, weights, metrics = runs["m2f"]
        approx, counts = evaluate_approximate(torch, device, tmp, root, cfg_path, weights, metrics)
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        res["approximate"] = approx
        ok &= approx["ok"]
    res["ok"] = bool(ok)
    return res, totals


def evaluate_approximate(torch, device, tmp, root, cfg_path, weights, bilinear):
    """The eval CLI in an approximate setting (``--sample_mode nearest_top6c
    --score_topq 32``), then ``multishiftseg_torch.tools.validate_release``'s
    ``qualify_sampling_modes`` over its ``QUAL_MODES`` on the same folder and
    weights against the ``bilinear`` CLI run's metrics (``bilinear``), the
    artifact written next to the weights; the gate then refuses exactly the
    settings recorded unqualified. Random weights: the verdicts mean nothing,
    the path is what is checked. Launch counts of the CLI run and of the
    qualification, each path run with the counts set to 0 just before it."""
    import os

    from multishiftseg_torch.core.config import load_config
    from multishiftseg_torch.ops import launch_counts, reset_launch_counts
    from multishiftseg_torch.tools import validate_release as vr
    from multishiftseg_torch.train import test_runner

    totals, res = {}, {}
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        argv = ["--model", "m2f", "--cfg", str(cfg_path), "--weight_path", str(weights),
                "--test_dataset", "RoadAnomaly21", "--device", device,
                "--sample_mode", "nearest_top6c", "--score_topq", "32"]
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            metrics = test_runner.main(argv).get("RoadAnomaly21", {})
        cli = {"argv_flags": argv[-4:], "metrics": metrics,
               "seconds_with_model_load": time.perf_counter() - t0, "launches": launch_counts()}
        cli["ok"] = len(metrics) == 3 and all(np.isfinite(v) for v in metrics.values())
        res["cli"] = cli

        cfg = load_config(str(cfg_path))
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            record = vr.qualify_sampling_modes(
                cfg, str(weights), "RoadAnomaly21", str(root),
                {k: 100.0 * v for k, v in bilinear.items()}, 0.5, device=device)
        qual = {"seconds": time.perf_counter() - t0, "launches": launch_counts(),
                "record": record}
        path = vr.write_qualification(str(weights), record)
        # the gate as build_m2f_forward runs it first; a refused setting must
        # also stop build_m2f_forward before it builds anything
        gate = {}
        for mode, rec in record["modes"].items():
            base, _, suffix = mode.partition("+")
            opts = dict(sample_mode=base, score_lowres=suffix == "lowres",
                        score_topq=int(suffix[4:]) if suffix.startswith("topq") else 0)
            try:
                test_runner.check_sampling_qualification(
                    str(weights), test_runner.qualification_key(**opts))
                gate[mode] = "allowed"
            except RuntimeError as e:
                if "REFUSED" not in str(e):
                    raise
                try:
                    test_runner.build_m2f_forward(cfg, str(weights), device=device, **opts)
                    gate[mode] = "refused by the gate, built by build_m2f_forward"
                except RuntimeError as e2:
                    gate[mode] = "refused" if "REFUSED" in str(e2) else repr(e2)
        qual["gate"] = gate
        qual["artifact_written"] = path.exists()
        qual["ok"] = path.exists() and set(record["modes"]) == set(vr.QUAL_MODES) and all(
            gate[m] == ("allowed" if r["qualified"] else "refused")
            for m, r in record["modes"].items())
        res["qualification"] = qual
    finally:
        os.chdir(cwd)
    for part in (cli, qual):
        for k, v in part["launches"].items():
            totals[k] = totals.get(k, 0) + v
        part["launches"] = {k: v for k, v in part["launches"].items() if v}
    res["ok"] = bool(cli["ok"] and qual["ok"])
    return res, totals


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        import multishiftseg_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})", file=sys.stderr)
        return 2

    phases = []
    build = phase_build()
    emit(build)
    phases.append(build)
    rows, kernels = phase_kernels(torch)
    emit(kernels)
    phases.append(kernels)
    parity = phase_slice_parity(torch)
    emit(parity)
    phases.append(parity)
    serve, launches = phase_serve(torch)
    emit(serve)
    phases.append(serve)
    for seed in TRAIN_PARITY_SEEDS:
        train_parity = phase_train_parity(torch, seed)
        emit(train_parity)
        phases.append(train_parity)
    train, train_launches = phase_train(torch)
    emit(train)
    phases.append(train)
    dl_parity = phase_deeplab_parity(torch)
    emit(dl_parity)
    phases.append(dl_parity)
    dl_serve, dl_launches = phase_deeplab_serve(torch)
    emit(dl_serve)
    phases.append(dl_serve)
    for seed in DL_TRAIN_PARITY_SEEDS:
        dl_train_parity = phase_deeplab_train_parity(torch, seed)
        emit(dl_train_parity)
        phases.append(dl_train_parity)
    dl_train, dl_train_launches = phase_deeplab_train(torch)
    emit(dl_train)
    phases.append(dl_train)
    s1_parity = phase_stage1_parity(torch)
    emit(s1_parity)
    phases.append(s1_parity)
    s1_train, s1_launches = phase_stage1_train(torch)
    emit(s1_train)
    phases.append(s1_train)
    validate, val_launches = phase_validate(torch)
    emit(validate)
    phases.append(validate)
    evaluate, eval_launches = phase_evaluate(torch)
    emit(evaluate)
    phases.append(evaluate)

    # each main path was run with the counts set to 0 just before it; a row
    # counts its counter over its paths (default: every path)
    paths = {"serve": launches, "train": train_launches, "deeplab_serve": dl_launches,
             "deeplab_train": dl_train_launches, "stage1_train": s1_launches,
             "validate": val_launches, "evaluate": eval_launches}
    for name, row in rows.items():
        row["launches"] = sum(paths[p].get(row.get("counter", name), 0)
                              for p in row.get("paths", paths))
    ok = all(p["ok"] for p in phases) and all(r["launches"] > 0 for r in rows.values())
    key_order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                 "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: r[k] for k in key_order} for r in rows.values()]})
    print(build["nvidia_smi"], flush=True)
    if not ok:
        failed = [p["phase"] for p in phases if not p["ok"]]
        print(f"chip_smoke: FAILED phases {failed}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
