"""Loading the reference's torch checkpoints into the port's modules.

The port's modules use the reference's ``state_dict`` key names, so a
checkpoint of the reference loads without a converter: :func:`load_torch_checkpoint`
unwraps it as ``multishiftseg_tpu/convert/torch2jax.py:322-336`` does, and
:func:`load_reference_weights` loads it strictly.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn as nn

_DP_PREFIX = "module."


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a torch checkpoint file, on the CPU: a ``state_dict``
    entry is unwrapped, and so is detectron2's ``{"model": sd, "iteration": ...}``
    wrapper (unless the file's own keys are model keys). Only tensors and plain
    containers are unpickled."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    if isinstance(state, dict) and isinstance(state.get("model"), dict) and not any(
        # the key "model" itself must not veto the unwrap (it starts with "mod")
        k != "model" and k.startswith(("mod", "backbone", "sem_seg_head"))
        for k in state
    ):
        state = state["model"]
    return state


def reference_state_dict(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``state`` with DataParallel's ``module.`` prefix stripped and the
    entries that are neither parameters nor buffers of the port dropped:
    torch BatchNorm's step counters (the port's BatchNorm has a fixed momentum),
    the loss module's buffers (detectron2's ``criterion.empty_weight``; the
    port's criterion is a function) and Swin's ``relative_position_index``
    buffers (index tables the port builds itself, as JAX skips them,
    ``torch2jax.py:150-151``). Every other key must match the port."""
    out = {}
    for k, v in state.items():
        k = k[len(_DP_PREFIX):] if k.startswith(_DP_PREFIX) else k
        if (k.endswith(("num_batches_tracked", "relative_position_index"))
                or k.startswith("criterion.")):
            continue
        out[k] = v
    return out


def load_reference_weights(model: nn.Module, path: str,
                           fill: Optional[Callable[[Dict[str, torch.Tensor]], None]] = None
                           ) -> None:
    """Load the checkpoint at ``path`` into ``model`` strictly. ``fill`` may add
    entries the reference can leave out, in place, before the load."""
    state = reference_state_dict(load_torch_checkpoint(path))
    if fill is not None:
        fill(state)
    model.load_state_dict(state, strict=True)
