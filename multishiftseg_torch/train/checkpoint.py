"""Checkpoints of both trainers: model, stage, optimizer, generator, epoch and
the best AUPRC.

Counterpart of ``multishiftseg_tpu/train/checkpoint.py`` (orbax there,
``torch.save`` here). A file holds the model's ``state_dict`` (BatchNorm
running statistics included), the stage and its optimizer's state, the
trainer's generator state and step count, and whatever the caller adds
(``epoch``, ``best_auprc``), so a restored trainer continues with the same
parameters, moments and random draws. :class:`CheckpointManager` keeps named
checkpoints (``last``, ``AUPRC_best``) under a directory and implements the
epoch loop's resume. In a process group only rank 0 writes, behind a barrier,
and every rank reads. A tensor-parallel trainer's model and optimizer state
are written and read in the unsharded layout (``core.tensor_parallel``), so a
checkpoint moves between any two ``model_parallel`` settings.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

import torch

from ..core.mesh import barrier, process_index
from ..core.tensor_parallel import load_optimizer_state_dict, optimizer_state_dict

log = logging.getLogger(__name__)


def save_checkpoint(path: str, trainer, generator: bool = True, **extra) -> str:
    """Write ``trainer``'s state to ``path`` (directories made as needed), its
    generator's unless ``generator`` is False, and ``extra`` entries."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    state = {"model": trainer.model.state_dict(), "stage": trainer.stage,
             "optimizer": optimizer_state_dict(trainer.model, trainer.optimizer),
             "step": trainer.n_steps, **extra}
    if generator:
        state["generator"] = trainer.generator.get_state()
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)  # a checkpoint is never left half written
    return path


def load_checkpoint(path: str, device) -> dict:
    """The entries of a checkpoint file, tensors on ``device``."""
    return torch.load(path, map_location=device, weights_only=True)


def restore_checkpoint(path: str, trainer) -> dict:
    """Load a :func:`save_checkpoint` file into ``trainer`` (strict): model,
    stage, optimizer, generator (when saved) and step count. Returns the
    file's entries."""
    state = load_checkpoint(path, trainer.device)
    trainer.model.load_state_dict(state["model"], strict=True)
    trainer.set_stage(int(state["stage"]))
    load_optimizer_state_dict(trainer.model, trainer.optimizer, state["optimizer"])
    if "generator" in state:
        trainer.generator.set_state(state["generator"].cpu())
    trainer.n_steps = int(state["step"])
    return state


class CheckpointManager:
    """Named checkpoints (``<directory>/<name>.pt``)."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory or "ckpts")
        os.makedirs(self.directory, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.directory, f"{name}.pt")

    def exists(self, name: str) -> bool:
        return os.path.isfile(self.path(name))

    def save(self, name: str, trainer, generator: bool = True, **extra) -> str:
        """Rank 0 writes; every rank returns after the file is complete."""
        if process_index() == 0:
            save_checkpoint(self.path(name), trainer, generator=generator, **extra)
        barrier()
        return self.path(name)

    def restore(self, name: str, device="cpu") -> dict:
        return load_checkpoint(self.path(name), device)

    def resume(self, trainer, name: Optional[str], start_epoch: int,
               warmup_epoch: int) -> Tuple[int, int]:
        """Set ``trainer`` up for the first epoch to run; returns (that epoch,
        its stage).

        Without a checkpoint ``name`` on disk: ``start_epoch``. With one: its
        model, the epoch after its ``epoch`` and its ``best_auprc`` as
        ``trainer.best["AUPRC"]`` (so a worse epoch cannot overwrite
        ``AUPRC_best``). The stage of the first epoch gets a fresh optimizer
        (``set_stage``); the saved optimizer and generator replace it only
        when the checkpoint holds both and was saved in that same stage, as a
        ``last`` from the final warmup epoch holds a stage-0 optimizer while
        the resumed epoch begins stage 1."""
        raw = None
        if name and self.exists(name):
            raw = self.restore(name, trainer.device)
            trainer.model.load_state_dict(raw["model"], strict=True)
            start_epoch = int(raw["epoch"]) + 1
            if "best_auprc" in raw:
                trainer.best["AUPRC"] = float(raw["best_auprc"])
            log.warning("resumed %s at epoch %d (best AUPRC %.4f)", name, start_epoch,
                        trainer.best["AUPRC"])
        stage = int(warmup_epoch >= 0 and start_epoch >= warmup_epoch)
        trainer.set_stage(stage)
        saved_stage = int(warmup_epoch >= 0 and raw is not None
                          and start_epoch - 1 >= warmup_epoch)
        if raw is not None and "generator" in raw and saved_stage == stage:
            load_optimizer_state_dict(trainer.model, trainer.optimizer, raw["optimizer"])
            trainer.generator.set_state(raw["generator"].cpu())
            trainer.n_steps = int(raw["step"])
            log.warning("restored the optimizer and generator state (full resume)")
        return start_epoch, stage
