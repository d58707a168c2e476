"""Device selection shared by the port's entry points, and the ReLU sign hooks
of the parity checks."""

from __future__ import annotations

import functools

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for the CPU.

    Raises when CUDA is asked for and absent; an entry point never carries on
    quietly on the CPU.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def relu_sign_hooks(model: torch.nn.Module, signs: dict, replay: dict = None) -> list:
    """Forward hooks on every ``nn.ReLU`` of ``model``: each stores its input's
    sign pattern (input > 0, on the CPU) in ``signs`` under the module's name.

    Given ``replay``, another run's ``signs``, each ReLU keeps the units that
    run kept instead of its own, so that a step follows that run's branch of
    the piecewise-linear model: two steps in different precisions or on
    different devices then differ by rounding alone, where an input within
    rounding of 0 would otherwise move a whole gradient path. Returns the
    handles; remove them after the step.
    """
    def hook(module, args, out, name):
        x = args[0]
        signs[name] = (x > 0).cpu()
        if replay is not None:
            return x * replay[name].to(x.device, x.dtype)
        return None

    return [m.register_forward_hook(functools.partial(hook, name=n))
            for n, m in model.named_modules() if isinstance(m, torch.nn.ReLU)]
