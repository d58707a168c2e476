"""Observability: loss meters, step timing, scalar curves and profiler traces.

Counterpart of ``multishiftseg_tpu/core/logging.py``. ``StepTimer.stop``
synchronises the device a step's result lives on (in place of
``jax.block_until_ready``), so a step's time includes its device work;
``StreamStepTimer`` times steps on the device's stream without waiting for
any, for a loop that must not stall its host; ``profiler_trace`` records a ``torch.profiler`` trace and exports it in the
Chrome format; ``log_compile_time`` logs a function's first call, which in the
port includes the first-use ``nvcc`` build of the kernels it launches.
``ScalarWriter`` writes the JAX package's ``step,tag,value`` CSV with ``%.8g``
values, so either package's ``ScalarWriter.read`` parses the other's file.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch

log = logging.getLogger(__name__)


def synchronize(result) -> None:
    """Wait for the device work behind ``result`` (tensors, or nested tuples,
    lists and dicts of them): the CUDA devices they live on are synchronised."""
    devices = set()

    def visit(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                visit(v)

    visit(result)
    for d in devices:
        torch.cuda.synchronize(d)


class RunningMeter:
    """Streaming mean of a scalar."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.sum += float(value) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class MultiRunningMeter:
    """A dict of :class:`RunningMeter`."""

    def __init__(self):
        self.meters: Dict[str, RunningMeter] = defaultdict(RunningMeter)

    def update(self, values: Dict[str, float], n: int = 1):
        for k, v in values.items():
            self.meters[k].update(v, n)

    def get_metric(self) -> Dict[str, float]:
        return {k: m.avg for k, m in self.meters.items()}

    def reset(self):
        self.meters.clear()


class StepTimer:
    """Wall-clock step timing with warm-up exclusion and items/s accounting."""

    def __init__(self, warmup_steps: int = 2):
        self.warmup_steps = warmup_steps
        self.steps = 0
        self.total_time = 0.0
        self.total_items = 0
        self.times = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None, items: int = 0) -> float:
        """End a step: waits for ``result``'s device work, so its time is in."""
        if result is not None:
            synchronize(result)
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        self.steps += 1
        self.times.append(dt)
        if self.steps > self.warmup_steps:
            self.total_time += dt
            self.total_items += items
        return dt

    @property
    def items_per_sec(self) -> float:
        return self.total_items / max(self.total_time, 1e-9)

    @property
    def avg_step_ms(self) -> float:
        return 1e3 * self.total_time / max(self.steps - self.warmup_steps, 1)


class StreamStepTimer:
    """Per-step times that make no step wait: on a CUDA device an event pair a
    step on the current stream (the step's span on the card), read by
    :meth:`times_ms` once the caller has waited for that stream anyway; on
    the CPU, whose work is done when a step returns, the wall clock."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._spans = []

    def _mark(self):
        if self.device.type != "cuda":
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self.device))
        return event

    def start(self):
        self._spans.append([self._mark(), None])

    def stop(self):
        self._spans[-1][1] = self._mark()

    def times_ms(self) -> list:
        """Each step's milliseconds (waits for the last step's end event)."""
        if self.device.type != "cuda":
            return [1e3 * (b - a) for a, b in self._spans]
        if self._spans:
            self._spans[-1][1].synchronize()
        return [a.elapsed_time(b) for a, b in self._spans]


class ScalarWriter:
    """Append-only scalar curves: ``<dir>/scalars.csv`` of ``step,tag,value``
    rows, flushed at every append so an interrupted run loses nothing."""

    def __init__(self, log_dir: str, filename: str = "scalars.csv"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, filename)
        new = not os.path.exists(self.path)
        self._f = open(self.path, "a")
        if new:
            self._f.write("step,tag,value\n")
            self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int):
        self._f.write(f"{int(step)},{tag},{float(value):.8g}\n")
        self._f.flush()

    def add_scalars(self, values: Dict[str, float], step: int):
        for tag, v in values.items():
            self.add_scalar(tag, v, step)

    def read(self) -> Dict[str, list]:
        """{tag: [(step, value), ...]} parsed back from the file."""
        out: Dict[str, list] = defaultdict(list)
        with open(self.path) as f:
            next(f, None)
            for line in f:
                step, tag, value = line.rstrip("\n").split(",", 2)
                out[tag].append((int(step), float(value)))
        return dict(out)

    def close(self):
        self._f.close()


@contextlib.contextmanager
def profiler_trace(log_dir: str, enabled: bool = True) -> Iterator[None]:
    """Record a ``torch.profiler`` trace (CPU, and CUDA when available) of the
    block and export it as ``<log_dir>/trace.json`` (Chrome / Perfetto)."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                     else [])
    with profile(activities=acts) as prof:
        yield
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


def log_compile_time(name: str):
    """Decorator logging the time of a function's first call (in the port: the
    kernels' first-use build and the first launch), its device work included."""

    def wrap(fn):
        called = {"n": 0}

        def inner(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if called["n"] == 0:
                synchronize(out)
                log.info("%s first call (build and first launch) took %.1fs", name,
                         time.perf_counter() - t0)
            called["n"] += 1
            return out

        return inner

    return wrap
