"""Host time a call of the ``mss::`` ops on one card: each op called through
the dispatcher (as the port registers it, ``ops.custom_op``: ``torch.library``
``define`` / ``impl``), the same CUDA implementation registered through
``torch.library.custom_op`` instead (in a namespace of its own), and that
implementation called directly, which is the wrapper's own launch code.

The inputs are tiny, so the card runs each kernel in less time than the host
takes to issue the next: a block of calls issued back to back, then one
synchronisation, times the host's work a call. The variants run in
interleaved blocks in one process.

    python -m multishiftseg_torch.tools.op_overhead [--rounds 20] [--calls 200]

Prints the card's name and power limit, and one JSON line a case: the median
over rounds of each variant's microseconds a call.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from ..ops import dilated_conv as dconv
from ..ops import library  # noqa: F401  (registers the ops)
from ..ops import ms_deform_attn as msda
from ..ops import scores

LEVELS = [4, 8, 2, 4, 1, 2]  # S = 42
PROBE = "mss_overhead_probe"


def _inputs(device, grad):
    g = np.random.RandomState(0)
    t = lambda *s, dtype=torch.float32: torch.from_numpy(g.rand(*s).astype(np.float32)).to(
        device, dtype)
    value, loc, attn = t(1, 42, 8, 32), t(1, 16, 8, 3, 4, 2), t(1, 16, 8, 3, 4)
    if grad:
        for x in (value, loc, attn):
            x.requires_grad_()
    masks, probs = t(1, 10, 8, 8), t(1, 10, 19)
    x, kernel = t(1, 8, 8, 16, dtype=torch.bfloat16), t(3, 3, 16, 16, dtype=torch.bfloat16)
    return value, loc, attn, masks, probs, x, kernel


def _probe_ops():
    """The forward ops' CUDA implementations registered with
    ``torch.library.custom_op``, with the same fakes and autograd."""
    ops = {}
    specs = {
        "ms_deform_attn": (msda._core_cuda, msda._core_fake, msda._core_backward,
                           msda._core_setup,
                           "(Tensor value, Tensor sampling_locations, Tensor attention_weights, "
                           "int[] levels, bool nearest) -> Tensor"),
        "mask_scores": (scores._mask_scores_cuda, scores._tail_fake, scores._tail_backward,
                        scores._tail_setup,
                        "(Tensor masks, Tensor probs, Tensor? keep, int[] out_hw, int mode) "
                        "-> Tensor"),
        "dilated_conv3x3": (dconv._forward_cuda,
                            lambda x, kernel, rate: x.new_empty((*x.shape[:3],
                                                                 kernel.shape[-1])),
                            dconv._backward, dconv._setup,
                            "(Tensor x, Tensor kernel, int rate) -> Tensor"),
    }
    for name, (cuda, fake, backward, setup, schema) in specs.items():
        op = torch.library.custom_op(f"{PROBE}::{name}", cuda, mutates_args=(),
                                     device_types="cuda", schema=schema)
        op.register_fake(fake)
        op.register_autograd(backward, setup_context=setup)
        ops[name] = op
    return ops


def cases(device, grad, probe):
    value, loc, attn, masks, probs, x, kernel = _inputs(device, grad)
    mss, anomaly = torch.ops.mss, scores._ANOMALY
    out = {
        "ms_deform_attn_bilinear": {
            "direct": lambda: msda._core_cuda(value, loc, attn, LEVELS, False),
            "op": lambda: mss.ms_deform_attn(value, loc, attn, LEVELS, False),
            "custom_op": lambda: probe["ms_deform_attn"](value, loc, attn, LEVELS, False)},
        "mask_scores_anomaly": {
            "direct": lambda: scores._mask_scores_cuda(masks, probs, None, [16, 16], anomaly),
            "op": lambda: mss.mask_scores(masks, probs, None, [16, 16], anomaly),
            "custom_op": lambda: probe["mask_scores"](masks, probs, None, [16, 16], anomaly)},
        "dilated_conv3x3": {
            "direct": lambda: dconv._forward_cuda(x, kernel, 2),
            "op": lambda: mss.dilated_conv3x3(x, kernel, 2),
            "custom_op": lambda: probe["dilated_conv3x3"](x, kernel, 2)},
    }
    if not grad:
        out["ms_deform_attn_quantize"] = {
            "direct": lambda: msda._quantize_cuda(value),
            "op": lambda: mss.ms_deform_attn_quantize(value)}
    return out


def time_case(variants, rounds, calls):
    """Median over ``rounds`` of each variant's host microseconds a call."""
    for f in variants.values():
        f()
    torch.cuda.synchronize()
    us = {k: [] for k in variants}
    for _ in range(rounds):
        for name, f in variants.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                f()
            us[name].append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
    return {k: statistics.median(v) for k, v in us.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--calls", type=int, default=200)
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    device, probe = torch.device("cuda", 0), _probe_ops()
    for grad in (False, True):
        with torch.set_grad_enabled(grad):
            for name, variants in cases(device, grad, probe).items():
                us = time_case(variants, args.rounds, args.calls)
                print(json.dumps({"case": name, "inputs_require_grad": grad,
                                  "host_us_a_call": us}), flush=True)


if __name__ == "__main__":
    main()
