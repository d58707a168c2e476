"""Checkpoints of the M2F trainer: model, stage, optimizer and generator state.

Counterpart of ``multishiftseg_tpu/train/checkpoint.py`` (orbax there,
``torch.save`` here): one file holds the model's ``state_dict``, the stage and
its optimizer's state, the trainer's generator state and its step count, so a
restored trainer continues with the same parameters, moments and random draws.
"""

from __future__ import annotations

import os

import torch


def save_checkpoint(path: str, trainer) -> str:
    """Write ``trainer``'s full state to ``path`` (directories made as needed)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"model": trainer.model.state_dict(),
                "stage": trainer.stage,
                "optimizer": trainer.optimizer.state_dict(),
                "generator": trainer.generator.get_state(),
                "step": trainer.step}, path)
    return path


def restore_checkpoint(path: str, trainer) -> None:
    """Load a :func:`save_checkpoint` file into ``trainer`` (strict)."""
    state = torch.load(path, map_location=trainer.device, weights_only=True)
    trainer.model.load_state_dict(state["model"], strict=True)
    trainer.set_stage(int(state["stage"]))
    trainer.optimizer.load_state_dict(state["optimizer"])
    trainer.generator.set_state(state["generator"].cpu())
    trainer.step = int(state["step"])
