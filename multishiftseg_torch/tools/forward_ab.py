"""Time deformable-attention kernels of several checkouts side by side on one
card: the forward (``msda_forward`` in ``csrc/ms_deform_attn.cu``, ``bilinear``
and ``nearest``), ``shared`` (``msda_forward_shared`` in
``csrc/ms_deform_attn_approx.cu``) and the int8 table's quantize
(``msda_quantize``).

Each checkout's two sources are built with the port's ``nvcc`` flags and
loaded into this one process. Every build runs on the same input tensors in
interleaved blocks, so neither the process nor where its tensors lie in memory
differs between them. A block is 25 calls queued behind a sleep kernel: the
card runs them back to back whatever the host's pace, and the block's median
interval is one call's device time.

    python -m multishiftseg_torch.tools.forward_ab --trees PARENT . [--rounds 10]

``--trees`` takes checkout roots, the first of them the reference; to time a
variant of a source, pass a copy of the checkout with that source edited.
Their ``msda_forward`` and ``msda_forward_shared`` must take this checkout's
arguments. The quantize runs each tree's whole device work a call: a tree
whose library has no ``msda_quantize_max_blocks`` takes the older entry,
which wants its scale zero-filled first (a fill launch) and runs three
kernels. Each forward build stages the levels this checkout's wrapper picks
(``ops.ms_deform_attn.forward_staged_levels``). Prints the card's name and
power limit, each tree's registers and spills a kernel, and one JSON line a
case; ``--out`` also writes them to a file.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from .. import _build
from ..ops import ms_deform_attn as msda

# the main path's pyramid at 1024x2048 (strides 32, 16, 8) and at the stage-2
# crops (704x704); 8 heads of 32 channels, 4 points a level
EVAL_LEVELS = [(32, 64), (64, 128), (128, 256)]
TRAIN_LEVELS = [(22, 22), (44, 44), (88, 88)]
HEADS, POINTS = 8, 4
SOURCES = ("ms_deform_attn", "ms_deform_attn_approx")
# name: (levels, images, table type, channels a head, kernel)
CASES = {
    "bf16_bilinear_eval": (EVAL_LEVELS, 1, torch.bfloat16, 32, "bilinear"),
    "f32_bilinear_eval": (EVAL_LEVELS, 1, torch.float32, 32, "bilinear"),
    "bf16_bilinear_eval_d30": (EVAL_LEVELS, 1, torch.bfloat16, 30, "bilinear"),
    "bf16_nearest_eval": (EVAL_LEVELS, 1, torch.bfloat16, 32, "nearest"),
    "bf16_bilinear_train": (TRAIN_LEVELS, 16, torch.bfloat16, 32, "bilinear"),
    "bf16_shared_eval": (EVAL_LEVELS, 1, torch.bfloat16, 32, "shared"),
    "bf16_quantize_eval": (EVAL_LEVELS, 1, torch.bfloat16, 32, "quantize"),
    "f32_quantize_eval": (EVAL_LEVELS, 1, torch.float32, 32, "quantize"),
}
# cycles the card sleeps before a block: longer than the host takes to queue
# the block's calls
QUEUE_AHEAD_CYCLES = 20_000_000


def ptxas_summary(log):
    """nvcc's ``-Xptxas -v`` log -> ``["entry: R registers, S spill bytes", ...]``."""
    rows, entry = [], None
    for line in log.splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and entry:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            rows.append(f"{entry}: {m.group(1)} registers, {spill} spill bytes")
            entry = None
    return rows


def build(tree: Path, out: Path):
    """``tree``'s two sources -> (``{source: library}``, the build's
    :func:`ptxas_summary`), built at once."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        src = tree / "multishiftseg_torch" / "csrc" / f"{name}.cu"
        lib = out / f"{name}.so"
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs, ptxas = {}, []
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {tree}/{name}.cu:\n{log[-4000:]}")
        libs[name] = ctypes.CDLL(str(lib))
        ptxas += ptxas_summary(log)
    return libs, ptxas


def inputs(levels, images, dtype, d, seed=0):
    """value [N, S, M, d], locations in [-0.1, 1.1] of each map (some
    outside) and softmax weights, one query a table row, on the card."""
    g = np.random.RandomState(seed)
    s = sum(h * w for h, w in levels)
    value = torch.from_numpy(g.randn(images, s, HEADS, d).astype(np.float32))
    loc = g.rand(images, s, HEADS, len(levels), POINTS, 2).astype(np.float32) * 1.2 - 0.1
    logits = torch.from_numpy(g.randn(images, s, HEADS, len(levels) * POINTS).astype(
        np.float32))
    attn = torch.softmax(logits, -1).view(images, s, HEADS, len(levels), POINTS)
    return value.cuda().to(dtype), torch.from_numpy(loc).cuda(), attn.cuda().to(dtype)


def _check(name, rc):
    if rc:
        raise RuntimeError(f"{name} failed: cudaError {rc}")


def caller(libs, kind, levels, value, loc, attn):
    """(a function running one call of ``kind`` with these libraries, returning
    its outputs; the levels it stages)."""
    n, s, m, d = value.shape
    lq, n_levels = loc.shape[1], len(levels)
    shapes = msda._levels(levels)
    code = msda._DTYPE_CODE[value.dtype]
    stream = torch.cuda.current_stream().cuda_stream
    if kind == "quantize":
        q = torch.empty(value.shape, dtype=torch.int8, device=value.device)
        lib = libs["ms_deform_attn"]
        if hasattr(lib, "msda_quantize_max_blocks"):
            lib.msda_quantize_max_blocks.restype = ctypes.c_int
            blocks = lib.msda_quantize_max_blocks()
            fn = lib.msda_quantize
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong,
                                                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            buf = torch.empty(d * (1 + blocks), dtype=torch.float32, device=value.device)

            def run():
                _check("msda_quantize", fn(value.data_ptr(), q.data_ptr(), buf.data_ptr(),
                                           buf.data_ptr() + 4 * d, blocks, n * s * m, d, code,
                                           stream))
                return q, buf[:d]
        else:
            # checkouts from before the quantize's single launch only: drop
            # this branch once no such checkout is compared
            fn = lib.msda_quantize
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                                   ctypes.c_int, ctypes.c_void_p]
            scale = torch.empty(d, dtype=torch.float32, device=value.device)

            def run():
                scale.zero_()  # the older wrapper's torch.zeros
                _check("msda_quantize", fn(value.data_ptr(), q.data_ptr(), scale.data_ptr(),
                                           n * s * m, d, code, stream))
                return q, scale
        return run, 0
    out = torch.empty((n, lq, m * d), dtype=value.dtype, device=value.device)
    if kind == "shared":
        fn = libs["ms_deform_attn_approx"].msda_forward_shared
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]

        def run():
            _check("msda_forward_shared", fn(value.data_ptr(), loc.data_ptr(), attn.data_ptr(),
                                             out.data_ptr(), n, s, m, d, lq, n_levels, POINTS,
                                             shapes, code, stream))
            return (out,)
        return run, 0
    nearest = kind == "nearest"
    staged = msda.forward_staged_levels(value, levels, nearest)
    fn = libs["ms_deform_attn"].msda_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

    def run():
        _check("msda_forward", fn(value.data_ptr(), loc.data_ptr(), attn.data_ptr(),
                                  out.data_ptr(), n, s, m, d, lq, n_levels, POINTS, shapes, code,
                                  int(nearest), staged, stream))
        return (out,)
    return run, staged


def block_ms(run, reps=25):
    """Median device time of one call over ``reps`` calls run back to back."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
    events[0].record()
    for i in range(reps):
        run()
        events[i + 1].record()
    events[-1].synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in zip(events, events[1:]))


def compare(runs, rounds):
    """Interleaved blocks (the order reversed every other round): each
    tree's block times, and against the first tree the pairs each was
    faster and slower in."""
    keys = list(runs)
    for run in runs.values():
        run()
    torch.cuda.synchronize()
    times = {k: [] for k in keys}
    order = keys + keys[::-1]
    for r in range(rounds):
        for k in (order if r % 2 == 0 else order[::-1]):
            times[k].append(block_ms(runs[k]))
    ref = times[keys[0]]
    q = statistics.quantiles(ref, n=4)
    return {"median_ms": {k: statistics.median(v) for k, v in times.items()},
            "min_ms": {k: min(v) for k, v in times.items()},
            "max_ms": {k: max(v) for k, v in times.items()},
            "faster_pairs": {k: sum(a < b for a, b in zip(v, ref)) for k, v in times.items()},
            "slower_pairs": {k: sum(a > b for a, b in zip(v, ref)) for k, v in times.items()},
            "reference_iqr_ms": q[2] - q[0], "blocks_ms": times}


def max_abs_diff(outs, ref):
    """The largest difference of any output (the quantize's table and scale
    compared as numbers)."""
    return max(float((o.float() - r.float()).abs().nan_to_num(float("inf")).max())
               if o.numel() else 0.0 for o, r in zip(outs, ref))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", required=True)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--cases", nargs="+", default=list(CASES), choices=list(CASES))
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("forward_ab: no CUDA device")
    work = _build.BUILD_DIR / "forward_ab"
    with ThreadPoolExecutor(len(args.trees)) as ex:
        built = list(ex.map(build, map(Path, args.trees),
                            [work / f"tree{i}" for i in range(len(args.trees))]))
    libs = {k: b[0] for k, b in zip(args.trees, built)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    lines = [smi.stdout.strip()]
    print(lines[0], flush=True)
    for k, (_, ptxas) in zip(args.trees, built):
        lines.append(json.dumps({"tree": k, "ptxas": ptxas}))
        print(lines[-1], flush=True)
    for case in args.cases:
        levels, images, dtype, d, kind = CASES[case]
        value, loc, attn = inputs(levels, images, dtype, d)
        runs = {}
        for k, lib in libs.items():
            runs[k], staged = caller(lib, kind, levels, value, loc, attn)
        outs = {k: [o.clone() for o in run()] for k, run in runs.items()}
        diff = {k: max_abs_diff(o, outs[args.trees[0]]) for k, o in outs.items()}
        row = {"case": case, "staged": staged, "max_abs_diff": diff,
               **compare(runs, args.rounds)}
        lines.append(json.dumps(row))
        print(lines[-1], flush=True)
        del value, loc, attn, outs, runs
        torch.cuda.empty_cache()
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
