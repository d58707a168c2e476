"""GPipe pipeline parallelism over the deformable encoder's layers.

Counterpart of ``multishiftseg_tpu/core/pipeline.py``. The pipelined unit is the
deformable encoder: ``transformer_enc_layers`` identical
``DeformableEncoderLayer`` blocks (``models/pixel_decoder.py``). Stage ``p`` owns
a contiguous slice of the layers and runs on ``devices[p]``; microbatches move
from stage to stage in the GPipe schedule of ``n_micro + P - 1`` ticks (bubble
fraction ``(P - 1) / (n_micro + P - 1)``). At tick ``t`` stage ``p`` runs
microbatch ``t - p``; a tick issues each stage's launches in turn, and CUDA
runs them asynchronously, so on several cards the stages overlap. Activations
move between stages with ``.to(device, non_blocking=True)``, which orders the
copy after the producing stage's work and before the consuming stage's.
Everything is PyTorch autograd, so the schedule is differentiable: the backward
runs through the same copies, each card's part on its own autograd thread.

As in JAX, GPipe runs in one process over its local devices (JAX refuses it
across processes, ``core/mesh.py:189-207``; so does ``core.mesh.check_parallelism``).
Equality with the sequential loop and with JAX's ``gpipe``, forward and
gradients, is tested in ``tests/test_torch_pipeline.py``.

The JAX module's functions and their counterparts:

- ``make_pipe_mesh`` (:39) -> :func:`stage_devices`;
- ``auto_microbatches`` (:74) -> :func:`auto_microbatches`, identical;
- ``gpipe`` (:114) -> :func:`gpipe`; ``gpipe_encoder_apply`` (:206) ->
  :func:`gpipe_encoder_apply`;
- ``stack_layer_params``, ``unstack_layer_params``, ``pack_encoder_stack``,
  ``unpack_encoder_stack``, ``is_packed``, ``stage_sharding`` (:51-112) -> none.
  JAX stacks the layers' parameters into ``[n_layers, ...]`` leaves that a mesh
  axis shards; here the layers stay the reference-named
  ``transformer.encoder.layers.{i}`` modules and a stage holds a slice of that
  ``ModuleList`` on its device, so checkpoints and optimizer state never change
  layout.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch


def stage_devices(pipe: int, devices: Optional[Sequence] = None) -> List[torch.device]:
    """The ``pipe`` stages' devices: the first ``pipe`` of ``devices``, by
    default the visible CUDA cards; refuses fewer than ``pipe``, as JAX's
    ``make_mesh`` refuses to truncate. An explicit list may repeat a device (a
    pipeline on one card, or on the CPU)."""
    if pipe < 1:
        raise ValueError(f"pipe = {pipe}: a pipeline has at least one stage")
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(count)]
    devs = [torch.device(d) for d in devices]
    if len(devs) < pipe:
        raise ValueError(f"stage_devices(pipe={pipe}) but only {len(devs)} devices "
                         f"({[str(d) for d in devs]}); refusing to run fewer stages")
    return devs[:pipe]


def auto_microbatches(local_batch: int, pipe: int) -> int:
    """Default GPipe microbatch count: the largest divisor of the batch that is
    <= 2 * pipe. More microbatches shrink the bubble ((P-1)/(n_micro+P-1)) but
    shrink each microbatch's launches; 2P is the classic sweet spot when the
    batch allows it."""
    target = 2 * pipe
    best = 1
    for m in range(1, local_batch + 1):
        if local_batch % m == 0 and m <= target:
            best = m
    return best


def check_geometry(n_layers: int, pipe: int, batch: Optional[int] = None,
                   n_micro: Optional[int] = None) -> None:
    """Refuse what JAX's ``gpipe`` refuses: layers not divisible by the stages,
    a batch not divisible by the microbatches."""
    if n_layers % pipe:
        raise ValueError(f"{n_layers} layers not divisible by pipe={pipe}")
    if n_micro is not None and n_micro < 1:
        raise ValueError(f"n_micro = {n_micro}: at least one microbatch")
    if batch is not None and n_micro is not None and batch % n_micro:
        raise ValueError(f"batch {batch} not divisible by n_micro={n_micro}")


def gpipe(layer_apply: Callable[..., torch.Tensor], layers: Sequence[torch.nn.Module],
          x: torch.Tensor, *, devices: Sequence[torch.device], n_micro: int,
          extras: Tuple[torch.Tensor, ...] = ()) -> torch.Tensor:
    """Run ``x`` through ``layers`` with the GPipe schedule over ``devices``.

    ``layer_apply(layer, state, *extras) -> state`` applies ONE layer.
    ``layers``: ``n_layers`` modules, divisible by ``P = len(devices)``; stage
    ``p`` applies ``layers[p * n_layers / P : (p + 1) * n_layers / P]`` on
    ``devices[p]``, where its parameters are expected to live. ``x``:
    ``[B, ...]``, ``B`` divisible by ``n_micro``. ``extras``: batch-invariant
    tensors (pos encodings, reference points, ...), copied once to each
    stage's device. Returns the output batch on ``x``'s device. Differentiable.
    """
    devices = [torch.device(d) for d in devices]
    pipe = len(devices)
    check_geometry(len(layers), pipe, x.shape[0], n_micro)
    per = len(layers) // pipe
    stages = [list(layers)[p * per:(p + 1) * per] for p in range(pipe)]
    stage_extras = [tuple(e.to(dev, non_blocking=True) for e in extras) for dev in devices]
    micro = x.chunk(n_micro)
    inflight: List[Optional[torch.Tensor]] = [None] * pipe
    outs: List[Optional[torch.Tensor]] = [None] * n_micro
    for t in range(n_micro + pipe - 1):
        # the last stage first: each stage takes what its predecessor finished
        # the tick before, and only then is that slot overwritten
        for p in reversed(range(pipe)):
            i = t - p
            if not 0 <= i < n_micro:
                continue
            state = (micro[i] if p == 0 else inflight[p - 1]).to(devices[p], non_blocking=True)
            for layer in stages[p]:
                state = layer_apply(layer, state, *stage_extras[p])
            if p == pipe - 1:
                outs[i] = state
            else:
                inflight[p] = state
    return torch.cat([o.to(x.device, non_blocking=True) for o in outs])


def gpipe_encoder_apply(layers: Sequence[torch.nn.Module], src: torch.Tensor,
                        pos: torch.Tensor, reference_points: torch.Tensor,
                        spatial_shapes: Sequence[Tuple[int, int]], *,
                        devices: Sequence[torch.device], n_micro: int,
                        sample_mode: str = "bilinear",
                        quantize_table: bool = False) -> torch.Tensor:
    """Pipeline the deformable encoder: ``layers`` are ``DeformableEncoderLayer``
    modules, ``src`` [B, S, C]; ``pos`` [1, S, C] and ``reference_points``
    [1, S, L, 2] are the batch-invariant extras, broadcast to each microbatch
    inside. Each layer runs its own training remat (the checkpointed segments
    around the deformable core) whenever it is in training mode under grad,
    as the sequential encoder does."""
    if pos.shape[0] != 1 or reference_points.shape[0] != 1:
        # per-sample pos / ref (e.g. padding masks or valid ratios) would be
        # silently dropped by broadcasting row 0: refuse instead
        raise ValueError(
            "gpipe_encoder_apply requires batch-invariant pos / reference_points "
            f"([1, S, ...]); got {pos.shape[0]=}, {reference_points.shape[0]=}")

    def layer_apply(layer, state, pos1, ref1):
        mb = state.shape[0]
        return layer(state, pos1.expand(mb, *pos1.shape[1:]),
                     ref1.expand(mb, *ref1.shape[1:]), spatial_shapes, sample_mode,
                     quantize_table)

    return gpipe(layer_apply, layers, src, devices=devices, n_micro=n_micro,
                 extras=(pos, reference_points))
