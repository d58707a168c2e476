"""Batching and device prefetch for the host-side datasets.

Counterpart of ``multishiftseg_tpu/data/loader.py``: a shuffling, epoch-based
loader that fetches samples from a thread pool and prefetches a bounded number
of batches, with the multi-host ``shard_index`` / ``shard_count`` slicing of
one seeded global shuffle. Where the JAX loader calls ``device_put``, this one
takes a ``device``:

- ``None``: batches of numpy arrays, as the JAX loader without ``device_put``;
- ``"cpu"``: CPU tensors sharing the stacked arrays' memory (no pinning);
  float64 arrays (the M2F pipeline's contrast jitter promotes to float64, as
  in the JAX package) become float32, as ``device_put`` makes them;
- ``"cuda"``: the producer thread stacks each batch into pinned host tensors
  and copies them with ``non_blocking=True`` on a side stream, recording an
  event; the consumer's current stream waits on that event before the batch
  is handed out, and ``record_stream`` keeps the device memory alive for the
  consumer's stream. Nothing moves to another device than the one asked for.

A worker's exception reaches the consumer; a consumer that breaks off sets
``stop``, which ends the producer. ``wait_seconds`` accumulates the time the
consumer spent blocked on the queue (the loader's wait a step).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..utils import resolve_device, tune_host_allocator


def _stack(samples):
    """Stack per-sample tuples into batched numpy arrays (lists for the rest)."""
    out = []
    for i in range(len(samples[0])):
        vals = [s[i] for s in samples]
        out.append(np.stack(vals) if isinstance(vals[0], np.ndarray) else vals)
    return tuple(out)


class Loader:
    """Shuffling, epoch-based loader with parallel sample fetch and prefetch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, drop_last: bool = True,
                 num_workers: int = 4, seed: int = 0, prefetch: int = 2, device=None,
                 shard_index: int = 0, shard_count: int = 1):
        """Every shard draws the same seeded global shuffle; a global batch is
        ``batch_size * shard_count`` samples, of which shard ``shard_index``
        fetches its contiguous ``batch_size`` slice (host-major). One
        ``default_rng(seed)`` is made per loader and each epoch's shuffle
        advances it."""
        tune_host_allocator()
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch
        self.device = None if device is None else resolve_device(device)
        if not 0 <= shard_index < shard_count:
            raise ValueError(f"shard_index {shard_index} outside 0..{shard_count - 1}")
        if shard_count > 1 and not drop_last:
            # a partial last global batch would give the shards different slice lengths
            raise ValueError("shard_count > 1 requires drop_last=True")
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.wait_seconds = 0.0

    def __len__(self):
        n = len(self.dataset)
        gb = self.batch_size * self.shard_count
        return n // gb if self.drop_last else -(-n // gb)

    def batch_indices(self):
        """This epoch's index slices (advances the shuffle's generator)."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        gb = self.batch_size * self.shard_count
        lo = self.shard_index * self.batch_size
        return [order[i * gb + lo:i * gb + lo + self.batch_size] for i in range(len(self))]

    def _to_device(self, batch, stream):
        """numpy batch -> tensors on ``self.device`` (and the copy's event on
        CUDA), float64 arrays as float32."""
        batch = tuple(b.astype(np.float32) if isinstance(b, np.ndarray) and b.dtype == np.float64
                      else b for b in batch)
        if self.device.type == "cpu":
            return tuple(torch.from_numpy(np.ascontiguousarray(b))
                         if isinstance(b, np.ndarray) else b for b in batch), None
        out = []
        with torch.cuda.stream(stream):
            for b in batch:
                if isinstance(b, np.ndarray):
                    host = torch.empty(b.shape, dtype=torch.from_numpy(b[:0]).dtype,
                                       pin_memory=True)
                    host.numpy()[...] = b
                    b = host.to(self.device, non_blocking=True)
                out.append(b)
            event = torch.cuda.Event()
            event.record(stream)
        return tuple(out), event

    def __iter__(self) -> Iterator[Tuple]:
        batches = self.batch_indices()
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        stream = (torch.cuda.Stream(self.device)
                  if self.device is not None and self.device.type == "cuda" else None)

        def put_or_stop(item) -> bool:
            # a bounded put that honours `stop`: an abandoned iterator must not
            # leave this thread parked in q.put holding prefetched batches
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idx in batches:
                        if stop.is_set():
                            return
                        batch = _stack(list(pool.map(self.dataset.__getitem__, idx)))
                        item = (batch, None) if self.device is None else self._to_device(
                            batch, stream)
                        if not put_or_stop(item):
                            return
            except BaseException as e:  # noqa: BLE001
                # a worker's exception must reach the consumer, not leave it
                # blocked in q.get() forever
                put_or_stop(e)
                return
            put_or_stop(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                self.wait_seconds += time.perf_counter() - t0
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                batch, event = item
                if event is not None:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(event)
                    for b in batch:
                        if isinstance(b, torch.Tensor):
                            b.record_stream(current)
                yield batch
        finally:
            stop.set()


def pad_to_multiple(img: np.ndarray, multiple: int = 32, mask: Optional[np.ndarray] = None,
                    mask_fill: int = 255):
    """Pad an HWC image (and HW mask) at the bottom and right to a multiple of
    ``multiple``. Returns the padded arrays and the original (h, w)."""
    h, w = img.shape[:2]
    ph, pw = (-h) % multiple, (-w) % multiple
    if ph or pw:
        img = np.pad(img, ((0, ph), (0, pw), (0, 0)))
        if mask is not None:
            mask = np.pad(mask, ((0, ph), (0, pw)), constant_values=mask_fill)
    return (img, mask, (h, w)) if mask is not None else (img, (h, w))
