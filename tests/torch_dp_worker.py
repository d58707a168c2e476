"""Ranks of the port's data-parallel tests: each a gloo process on the CPU.

:func:`run_ranks` writes a job, spawns ``world`` ranks with
``torch.multiprocessing.spawn`` (each joins a gloo group over
``tcp://localhost``), and returns every rank's result. A job names one of
:data:`JOBS`: a trainer's step of a global batch (each rank takes its rows
and the global draws), or two ``train()`` runs across a resume. The ranks
import no JAX; the tests hold their results to the JAX package's
single-process steps.
"""

from __future__ import annotations

import os
import socket
from typing import Callable, Dict, List

import numpy as np
import torch


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(job: dict, workdir, world: int = 2) -> List[dict]:
    """Run ``job`` on ``world`` gloo ranks; returns their results in rank order."""
    import torch.multiprocessing as mp

    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, "job.pt")
    torch.save(job, path)
    mp.spawn(_rank, args=(world, free_port(), path), nprocs=world, join=True)
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _rank(rank: int, world: int, port: int, path: str) -> None:
    from multishiftseg_torch.core.mesh import initialize_distributed, shutdown_distributed

    torch.set_num_threads(2)
    initialize_distributed(backend="gloo", init_method=f"tcp://localhost:{port}",
                           world_size=world, rank=rank)
    try:
        job = torch.load(path, weights_only=False)
        out = JOBS[job["kind"]](job)
        torch.save(out, os.path.join(os.path.dirname(path), f"rank{rank}.pt"))
    finally:
        shutdown_distributed()


def _rows(arrays):
    """This rank's rows of each global-batch array (its Loader shard)."""
    from multishiftseg_torch.core.mesh import local_batch_slice

    return tuple(a[local_batch_slice(a.shape[0])] for a in arrays)


def _record(model, loss, parts) -> dict:
    return {"loss": float(loss), "parts": {k: float(v) for k, v in parts.items()},
            "grads": {n: p.grad.double().numpy().copy()
                      for n, p in model.named_parameters() if p.grad is not None},
            "params": {n: p.detach().double().numpy().copy()
                       for n, p in model.named_parameters()},
            "stats": {n: b.double().numpy().copy() for n, b in model.named_buffers()}}


def _trainer(job, dtype):
    """The job's trainer with its weights, in ``dtype`` (set before DDP wraps)."""
    from multishiftseg_torch.models.deeplab import DeepWV3Plus
    from multishiftseg_torch.models.maskformer import MaskFormer
    from multishiftseg_torch.train.deeplab_trainer import TrainDeepLabOOD
    from multishiftseg_torch.train.instance_trainer import TrainM2FInstance
    from multishiftseg_torch.train.m2f_trainer import TrainM2FOOD

    kind = job["kind"]
    if kind == "deeplab":
        tr = TrainDeepLabOOD(job["cfg"], model=DeepWV3Plus(**job["model"]), device="cpu")
    elif kind == "m2f_stage2":
        tr = TrainM2FOOD(job["cfg"], model=MaskFormer(**job["model"]), device="cpu")
    else:
        tr = TrainM2FInstance(job["cfg"], model=MaskFormer(**job["model"], predictor="vanilla"),
                              dataset_name="unused", device="cpu")
    tr.model.load_state_dict(job["state"], strict=True)
    tr.model.to(dtype)
    return tr


def deeplab_steps(job) -> Dict[str, List[dict]]:
    """By dtype: ``TrainDeepLabOOD.step`` in stage 0, then in stage 1, each
    with its draws."""
    out = {}
    for dtype in job["dtypes"]:
        tr = _trainer(job, dtype)
        runs = []
        for stage, draws in enumerate(job["draws"]):
            tr.set_stage(stage)
            loss, aux = tr.step(*_rows(job["batch"]), draws=draws)
            runs.append(_record(tr.model, loss, aux))
        out[str(dtype)] = runs
    return out


def m2f_step(job) -> Dict[str, dict]:
    """By dtype: one ``TrainM2FOOD.stage2_step`` or ``TrainM2FInstance.step``."""
    out = {}
    for dtype in job["dtypes"]:
        tr = _trainer(job, dtype)
        if job["kind"] == "m2f_stage2":
            tr.set_stage(1)
            loss, losses, grad_norm, _ = tr.stage2_step(*_rows(job["batch"]),
                                                        draws=job["draws"])
        else:
            tr.set_stage(0)
            loss, losses, grad_norm, _ = tr.step(*_rows(job["batch"]), draws=job["draws"])
        out[str(dtype)] = dict(_record(tr.model, loss, losses), grad_norm=float(grad_norm))
    return out


def train_and_resume(job) -> dict:
    """``TrainDeepLabOOD.train()`` for ``job["epochs"][0]`` epochs, then a new
    trainer resumed from ``last`` to ``job["epochs"][1]`` (each model drawn
    after ``torch.manual_seed(0)``); the refusals of an
    indivisible per-half batch and of tensor parallelism."""
    import copy

    from multishiftseg_torch.core.mesh import process_index
    from multishiftseg_torch.models.deeplab import DeepWV3Plus
    from multishiftseg_torch.train.deeplab_trainer import TrainDeepLabOOD

    out: Dict[str, object] = {}
    for i, (epochs, resume) in enumerate(zip(job["epochs"], (None, "last"))):
        cfg = copy.deepcopy(job["cfg"])
        cfg.train.n_epochs = epochs
        torch.manual_seed(0)
        tr = TrainDeepLabOOD(cfg, model=DeepWV3Plus(**job["model"]), device="cpu")
        out[f"best{i}"] = dict(tr.train(resume=resume))
        out[f"history{i}"] = [{k: h[k] for k in ("epoch", "stage", "loss", "steps", "images",
                                                 "saved", "metrics")} for h in tr.history]
        out[f"params{i}"] = {n: p.detach().numpy().copy() for n, p in tr.model.named_parameters()}
    out["rank"] = process_index()
    refusals = {}
    for name, edit in (("odd_batch", lambda c: setattr(c.train, "train_batch", 3)),
                       ("model_parallel", lambda c: setattr(c.train, "model_parallel", 2))):
        cfg = copy.deepcopy(job["cfg"])
        edit(cfg)
        try:
            TrainDeepLabOOD(cfg, model=DeepWV3Plus(**job["model"]), device="cpu")
            refusals[name] = None
        except (ValueError, NotImplementedError) as e:
            refusals[name] = f"{type(e).__name__}: {e}"
    out["refusals"] = refusals
    return out


def units(job) -> dict:
    """The global reductions on this rank's rows of global arrays: the bottom-k
    sum (its value and d sum / d values at each ``select_num``) and a
    train-mode BatchNorm (output rows, running statistics, and the gradients
    of this rank's share of ``sum(y * c)``)."""
    from multishiftseg_torch.core.mesh import local_batch_slice
    from multishiftseg_torch.losses.rcl import bottom_k_sum_global
    from multishiftseg_torch.models.layers import BatchNorm2d

    values = torch.from_numpy(job["values"])
    rows = local_batch_slice(values.shape[0])
    out = {"bottom_k": []}
    for k in job["select"]:
        v = values[rows].clone().requires_grad_(True)
        keyed = torch.where(torch.from_numpy(job["valid"][rows]), v.detach(),
                            torch.full_like(v, float("inf")))
        s = bottom_k_sum_global(v.reshape(-1), keyed.reshape(-1),
                                torch.tensor(k, dtype=torch.int32))
        s.backward()
        out["bottom_k"].append((float(s), v.grad.numpy().copy()))
    x = torch.from_numpy(job["bn_x"])
    rows = local_batch_slice(x.shape[0])
    bn = BatchNorm2d(x.shape[1]).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(job["bn_w"]))
        bn.bias.copy_(torch.from_numpy(job["bn_b"]))
    xl = x[rows].clone().requires_grad_(True)
    y = bn(xl)
    (y * torch.from_numpy(job["bn_c"][rows])).sum().backward()
    out["bn"] = {"y": y.detach().numpy(), "mean": bn.running_mean.numpy().copy(),
                 "var": bn.running_var.numpy().copy(), "dx": xl.grad.numpy(),
                 "dw": bn.weight.grad.numpy().copy(), "db": bn.bias.grad.numpy().copy()}
    # the same rows channels-last (DeepLab's layout on the card)
    xc = x[rows].clone().to(memory_format=torch.channels_last).requires_grad_(True)
    yc = bn(xc)
    (yc * torch.from_numpy(job["bn_c"][rows])).sum().backward()
    out["bn_channels_last"] = {
        "y": yc.detach().numpy(), "dx": xc.grad.numpy(),
        "kept": yc.is_contiguous(memory_format=torch.channels_last)
        and xc.grad.is_contiguous(memory_format=torch.channels_last)}
    return out


def world_of_one(job) -> dict:
    """Inside a group of one rank: whether the collectives are the identity,
    and a train-mode BatchNorm's output, gradients and running statistics
    and the bottom-k sum, each to be held bit for bit to one process's."""
    from multishiftseg_torch.core import mesh
    from multishiftseg_torch.losses.rcl import _bottom_k_sum

    x = torch.from_numpy(job["bn_x"])
    out = {"in_group": mesh.is_distributed(), "identity": mesh.all_sum(x) is x
           and mesh.gather_rows(x, paired=True) is x, "bn": batch_norm_run(job)}
    v = torch.from_numpy(job["values"]).reshape(-1)
    keyed = torch.where(torch.from_numpy(job["valid"]).reshape(-1), v,
                        torch.full_like(v, float("inf")))
    out["bottom_k"] = float(_bottom_k_sum(v, keyed, torch.tensor(777, dtype=torch.int32)))
    return out


def batch_norm_run(job) -> dict:
    """A train-mode BatchNorm on ``job``'s whole ``bn_x``: output, running
    statistics and the gradients of ``sum(y * bn_c)``."""
    from multishiftseg_torch.models.layers import BatchNorm2d

    bn = BatchNorm2d(job["bn_x"].shape[1]).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(job["bn_w"]))
        bn.bias.copy_(torch.from_numpy(job["bn_b"]))
    x = torch.from_numpy(job["bn_x"]).clone().requires_grad_(True)
    y = bn(x)
    (y * torch.from_numpy(job["bn_c"])).sum().backward()
    return {"y": y.detach().numpy(), "mean": bn.running_mean.numpy(),
            "var": bn.running_var.numpy(), "dx": x.grad.numpy(),
            "dw": bn.weight.grad.numpy(), "db": bn.bias.grad.numpy()}


JOBS: Dict[str, Callable[[dict], object]] = {
    "deeplab": deeplab_steps, "m2f_stage2": m2f_step, "instance": m2f_step,
    "train_and_resume": train_and_resume, "units": units, "world_of_one": world_of_one}


def same_params(runs: List[dict]) -> bool:
    """Every rank's run ends with the same parameters, bit for bit."""
    first = runs[0]["params"]
    return all(set(r["params"]) == set(first)
               and all(np.array_equal(r["params"][n], first[n]) for n in first)
               for r in runs[1:])
