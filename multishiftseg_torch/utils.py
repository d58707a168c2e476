"""Device selection shared by the port's entry points, the host allocator's
tuning for the data pipeline, the ReLU sign hooks of the parity checks, and the
colouring of predictions."""

from __future__ import annotations

import functools

import numpy as np
import torch

# Cityscapes train id -> RGB (multishiftseg_tpu/data/cityscapes.py:72)
TRAIN_ID_COLORS = {
    0: (128, 64, 128), 1: (244, 35, 232), 2: (70, 70, 70), 3: (102, 102, 156),
    4: (190, 153, 153), 5: (153, 153, 153), 6: (250, 170, 30), 7: (220, 220, 0),
    8: (107, 142, 35), 9: (152, 251, 152), 10: (70, 130, 180), 11: (220, 20, 60),
    12: (255, 0, 0), 13: (0, 0, 142), 14: (0, 0, 70), 15: (0, 60, 100),
    16: (0, 80, 100), 17: (0, 0, 230), 18: (119, 11, 32),
}


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


_ALLOCATOR_TUNED = False


def tune_host_allocator() -> bool:
    """Keep large freed buffers in the glibc heap instead of returning them to
    the kernel (``M_MMAP_THRESHOLD`` and ``M_TRIM_THRESHOLD`` at 1 GiB), so the
    loader's batch-sized arrays do not fault in fresh pages every step, as
    ``multishiftseg_tpu/utils.py::tune_host_allocator``. glibc only; False
    elsewhere. Idempotent."""
    global _ALLOCATOR_TUNED
    if not _ALLOCATOR_TUNED:
        try:
            import ctypes

            libc = ctypes.CDLL("libc.so.6", use_errno=True)
            _ALLOCATOR_TUNED = bool(libc.mallopt(-3, 1 << 30) == 1      # M_MMAP_THRESHOLD
                                    and libc.mallopt(-1, 1 << 30) == 1)  # M_TRIM_THRESHOLD
        except OSError:
            return False
    return _ALLOCATOR_TUNED


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


def map2citycolor(pred: np.ndarray) -> np.ndarray:
    """Train-id prediction map [H, W] -> RGB [H, W, 3] uint8 (other ids black),
    as ``multishiftseg_tpu/utils.py::map2citycolor``."""
    out = np.zeros(pred.shape + (3,), np.uint8)
    for tid, color in TRAIN_ID_COLORS.items():
        out[pred == tid] = color
    return out
