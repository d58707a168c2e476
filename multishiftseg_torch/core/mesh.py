"""Multi-process data parallelism: the process group, the split of the global
batch, and the collectives that make a training step one step over the global
batch.

Counterpart of ``multishiftseg_tpu/core/mesh.py``. JAX trains across
processes with one jitted program over global arrays, so every reduction of its
step (train-mode BatchNorm statistics, RCL's bottom-k, the criterion's
``num_masks``, the loss means) spans the global batch. Here each process holds
one card and its rows of the global batch, ``DistributedDataParallel`` averages
the gradients, and the steps reduce over the global batch through the
collectives below, whose backward sums the incoming gradient over the ranks
(:func:`all_sum`, :func:`gather_rows`). Every rank computes the same global
loss, so each rank's gradient is ``world`` times its rows' share of the global
gradient, and DDP's average of them is the global step's gradient exactly.
In a world of 1 (``torchrun --nproc_per_node 1``) the collectives are the
identity and the steps take their single-process routes (:func:`spans_ranks`):
only DDP's wrapper remains.

Launch one process a card with ``torchrun --nproc_per_node N -m
multishiftseg_torch.train.cli ...``; without a launch environment everything
here is the single-process identity.

The JAX module's functions and their counterparts:

- ``initialize_distributed`` (:231-273) -> :func:`initialize_distributed`;
- ``make_global_mesh`` (:276-294) -> the process group, one card a rank;
- ``make_train_mesh`` (:189-216), ``fit_mesh_to_batch``, ``make_mesh``,
  ``default_device_count`` -> :func:`check_train_batch` and
  :func:`check_parallelism` (one card a process: the data axis is the world);
- ``local_batch_slice`` (:297-303) -> :func:`local_batch_slice`;
- ``shard_batch``, ``shard_global_batch``, ``data_sharded``,
  ``replicated``, ``place_train_state`` -> the ``Loader``'s
  ``shard_index`` / ``shard_count`` and :func:`data_parallel` (DDP broadcasts
  rank 0's state when it wraps the model);
- ``spatial_sharding`` -> the evaluator's ``--spatial``, the next slice;
- ``tensor_parallel_shardings``, ``shard_params`` -> the next slice; until then
  ``model_parallel > 1`` raises (:func:`check_parallelism`);
- the mesh's ``pipe`` axis -> ``core/pipeline.py``: GPipe in one process over
  ``pipeline_parallel`` local devices, refused in a world above 1 as JAX
  refuses it across processes (``make_train_mesh``, :199-207);
- ``host_cpu_mesh`` -> none: the port's tests run gloo ranks on the CPU.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

# the ROADMAP item that ports tensor parallelism and the evaluator's --spatial
NEXT_SLICE = "ROADMAP.md Queue 1 item 4.3 (tensor parallelism and --spatial, the next slice)"


def is_distributed() -> bool:
    """True inside a process group (any world size)."""
    return dist.is_available() and dist.is_initialized()


def spans_ranks() -> bool:
    """True inside a process group of more than one rank: the global
    reductions take their collective routes only then, so a world of 1 runs
    the single-process step under DDP."""
    return process_count() > 1


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if is_distributed() else 1


def initialize_distributed(backend: Optional[str] = None, init_method: Optional[str] = None,
                           world_size: Optional[int] = None, rank: Optional[int] = None,
                           local_rank: Optional[int] = None) -> bool:
    """Join a multi-process launch; returns whether a process group is up.

    The arguments, or a ``torchrun`` environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``), say the launch; with
    neither this is a single process and nothing happens, as in JAX. The
    backend defaults to NCCL where CUDA is available and gloo elsewhere; with
    CUDA the rank binds to ``cuda:{local_rank}`` (``LOCAL_RANK``, else the
    rank). A failed initialisation raises: nothing carries on single-process."""
    if is_distributed():
        return True
    env = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if not (env or world_size is not None or rank is not None or init_method is not None):
        return False
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    rank = int(os.environ["RANK"]) if rank is None else rank
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return True


def shutdown_distributed() -> None:
    if is_distributed():
        dist.destroy_process_group()


def check_parallelism(train_cfg, pipelined: bool = False) -> None:
    """Refuse what the port cannot do, as ``make_mesh`` refuses a mesh it
    cannot build: tensor parallelism (``model_parallel``, the next slice); the
    GPipe schedule (``pipeline_parallel``, ``pipeline_microbatches``) in a
    world above 1, as JAX's ``make_train_mesh`` refuses it across processes,
    or in a trainer that has no deformable encoder to pipeline (``pipelined``
    False); and a device count other than the launch's: one card a process,
    times ``pipeline_parallel`` stages."""
    if train_cfg.model_parallel > 1:
        raise NotImplementedError(f"train.model_parallel = {train_cfg.model_parallel}: the "
                                  f"port trains data- and pipeline-parallel only; see "
                                  f"{NEXT_SLICE}")
    pipe = train_cfg.pipeline_parallel
    if (pipe > 1 or train_cfg.pipeline_microbatches) and process_count() > 1:
        raise ValueError(f"train.pipeline_parallel = {pipe}, pipeline_microbatches = "
                         f"{train_cfg.pipeline_microbatches}: GPipe runs in one process "
                         f"over its local devices; this launch has {process_count()}")
    if pipe > 1 and not pipelined:
        raise ValueError(f"train.pipeline_parallel = {pipe}: this trainer has no deformable "
                         "encoder to pipeline (the Mask2Anomaly trainer's msdeformattn "
                         "pixel decoder has)")
    devices = process_count() * max(pipe, 1)
    if train_cfg.num_devices and train_cfg.num_devices != devices:
        raise ValueError(f"train.num_devices = {train_cfg.num_devices}, but this launch has "
                         f"{process_count()} processes of one card each x {max(pipe, 1)} "
                         f"pipeline stages (torchrun --nproc_per_node sets the count)")


def check_train_batch(rows: int) -> int:
    """This rank's rows of ``rows`` (a paired trainer's per-half batch, or an
    unpaired one's batch); raises unless the world divides them
    (``make_train_mesh``)."""
    world = process_count()
    if rows % world:
        raise ValueError(f"per-half batch rows {rows} not divisible by the {world} "
                         f"processes of the launch")
    return rows // world


def local_batch_slice(global_batch: int) -> slice:
    """This process's contiguous slice of the global batch (the Loader's shard)."""
    per = check_train_batch(global_batch)
    return slice(process_index() * per, (process_index() + 1) * per)


def from_rank0(obj):
    """Rank 0's ``obj`` on every rank (a picklable value), so that the ranks
    take one decision; ``obj`` itself in a single process."""
    if not is_distributed():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier() -> None:
    if is_distributed():
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def data_parallel(model: torch.nn.Module,
                  previous: Optional[torch.nn.Module] = None) -> torch.nn.Module:
    """``model`` wrapped in DDP inside a process group, else ``model``. Wrap
    again whenever the trainable set or the parameters' type changes, passing
    the ``previous`` wrapper, whose gradient hooks are removed: DDP reduces the
    parameters that require gradients when it is built, so frozen ones stay
    out of the all-reduce (no ``find_unused_parameters``). Buffers are not
    broadcast: the global BatchNorm keeps them equal on every rank."""
    if not is_distributed():
        return model
    from torch.nn.parallel import DistributedDataParallel

    if isinstance(previous, DistributedDataParallel):
        previous._remove_autograd_hooks()

    device = next(model.parameters()).device
    ids = [device.index] if device.type == "cuda" else None
    return DistributedDataParallel(model, device_ids=ids, broadcast_buffers=False)


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g)
        return g


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks; its backward sums the gradient over the
    ranks. The identity in a world of 1."""
    if not spans_ranks():
        return x
    return _AllSum.apply(x)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x.sum()`` over the global batch."""
    return all_sum(x.sum())


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """``x.mean()`` over the global batch (every rank holds as many elements)."""
    if not spans_ranks():
        return x.mean()
    return all_sum(x.sum()) / (x.numel() * process_count())


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x.contiguous())
        ctx.rows = x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g)
        r = dist.get_rank()
        return g[r * ctx.rows:(r + 1) * ctx.rows]


def gather_rows(x: torch.Tensor, paired: bool = False) -> torch.Tensor:
    """The global batch of every rank's rows ``x`` (leading axis): in rank
    order, or for a paired batch ([clean ‖ augmented] on every rank) as
    [all clean ‖ all augmented], JAX's global row order. Differentiable; the
    backward sums the gradient over the ranks. ``x`` itself in a world of 1."""
    if not spans_ranks():
        return x
    if x.requires_grad:
        g = _GatherRows.apply(x)
    else:
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x.contiguous())
        g = torch.cat(parts)
    if not paired:
        return g
    w, n = process_count(), x.shape[0]
    return g.view(w, 2, n // 2, *x.shape[1:]).transpose(0, 1).reshape(w * n, *x.shape[1:])


def rank_rows(x: torch.Tensor, paired: bool, dim: int = 0) -> torch.Tensor:
    """This rank's rows of a global-batch tensor along ``dim``: its contiguous
    slice, or of each half of a paired batch ([all clean ‖ all augmented]) its
    slice of both, as [clean ‖ augmented]. Rows grouped by image (K slots an
    image) slice whole images."""
    w = process_count()
    if w == 1:
        return x
    r, halves = process_index(), 2 if paired else 1
    n = x.shape[dim]
    per = n // (halves * w)
    parts = [x.narrow(dim, h * (n // halves) + r * per, per) for h in range(halves)]
    return parts[0] if halves == 1 else torch.cat(parts, dim)


# criterion draws that cover one half of a paired batch (criterion.criterion_draws)
HALF_DRAWS = ("orig_coords", "clean_coords", "clean_rand")


def rank_draws(draws: dict, paired: bool) -> dict:
    """This rank's share of one step's global draws (every rank draws the
    global batch's from the same generator): the rows of its images, except
    RCL's ``rcl_noise``, which stays global (RCL pairs pixels over the global
    batch). Swin's ``drop_path`` masks are [calls, batch]; DeepLab's
    ``dropout`` a dict of [batch, C, 1, 1] masks."""
    if process_count() == 1:
        return draws
    out = {}
    for key, v in draws.items():
        if v is None or key == "rcl_noise":
            out[key] = v
        elif key == "aux":
            out[key] = [rank_draws(a, paired) for a in v]
        elif key == "dropout":
            out[key] = {name: rank_rows(m, paired) for name, m in v.items()}
        elif key == "drop_path":
            out[key] = rank_rows(v, paired, dim=1)
        else:
            out[key] = rank_rows(v, paired and key not in HALF_DRAWS)
    return out
