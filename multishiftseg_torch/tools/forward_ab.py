"""Time the deformable-attention forward (``msda_forward`` in
``csrc/ms_deform_attn.cu``) of several checkouts side by side on one card.

Each checkout's ``csrc/ms_deform_attn.cu`` is built with the port's ``nvcc``
flags and loaded into this one process. Every build runs on the same input
tensors in interleaved blocks, so neither the process nor where its tensors
lie in memory differs between them. A block is 25 calls queued behind a
sleep kernel: the card runs them back to back whatever the host's pace, and
the block's median interval is one call's device time.

    python -m multishiftseg_torch.tools.forward_ab --trees PARENT . [--rounds 10]

``--trees`` takes checkout roots, the first of them the reference; their
``msda_forward`` must take this checkout's arguments. Each build stages the
levels this checkout's wrapper picks
(``ops.ms_deform_attn.forward_staged_levels``). Prints the card's name and
power limit and one JSON line a case; ``--out`` also writes them to a file.
"""

from __future__ import annotations

import argparse
import ctypes
import json
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
# name: (levels, images, table type, channels a head, nearest)
CASES = {
    "bf16_bilinear_eval": (EVAL_LEVELS, 1, torch.bfloat16, 32, False),
    "f32_bilinear_eval": (EVAL_LEVELS, 1, torch.float32, 32, False),
    "bf16_bilinear_eval_d30": (EVAL_LEVELS, 1, torch.bfloat16, 30, False),
    "bf16_nearest_eval": (EVAL_LEVELS, 1, torch.bfloat16, 32, True),
    "bf16_bilinear_train": (TRAIN_LEVELS, 16, torch.bfloat16, 32, False),
}
# cycles the card sleeps before a block: longer than the host takes to queue
# the block's calls
QUEUE_AHEAD_CYCLES = 20_000_000


def build(tree: Path, out: Path) -> Path:
    """``tree``'s ``ms_deform_attn.cu`` -> ``out``, a shared library."""
    src = tree / "multishiftseg_torch" / "csrc" / "ms_deform_attn.cu"
    r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out), str(src)],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{r.stderr[-4000:]}")
    return out


def load(path: Path):
    fn = ctypes.CDLL(str(path)).msda_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn


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


def caller(fn, levels, value, loc, attn, nearest):
    n, s, m, d = value.shape
    lq, n_levels = loc.shape[1], len(levels)
    staged = msda.forward_staged_levels(value, levels, nearest)
    out = torch.empty((n, lq, m * d), dtype=value.dtype, device=value.device)
    shapes = msda._levels(levels)
    code = msda._DTYPE_CODE[value.dtype]
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        rc = fn(value.data_ptr(), loc.data_ptr(), attn.data_ptr(), out.data_ptr(), n, s, m, d,
                lq, n_levels, POINTS, shapes, code, int(nearest), staged, stream)
        if rc:
            raise RuntimeError(f"msda_forward failed: cudaError {rc}")
        return out
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", required=True, type=Path)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--cases", nargs="+", default=list(CASES), choices=list(CASES))
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("forward_ab: no CUDA device")
    work = _build.BUILD_DIR / "forward_ab"
    work.mkdir(parents=True, exist_ok=True)
    names = [str(t) for t in args.trees]
    with ThreadPoolExecutor(len(names)) as ex:
        libs = list(ex.map(build, args.trees, [work / f"tree{i}.so" for i in range(len(names))]))
    fns = dict(zip(names, map(load, libs)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    lines = [smi.stdout.strip()]
    print(lines[0], flush=True)
    for case in args.cases:
        levels, images, dtype, d, nearest = CASES[case]
        value, loc, attn = inputs(levels, images, dtype, d)
        runs = {}
        for k, fn in fns.items():
            runs[k], staged = caller(fn, levels, value, loc, attn, nearest)
        outs = {k: run().clone() for k, run in runs.items()}
        diff = {k: float((o.float() - outs[names[0]].float()).abs().max())
                for k, o in outs.items()}
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
