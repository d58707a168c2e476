"""Device selection shared by the port's entry points, the host allocator's
tuning for the data pipeline, the ReLU sign hooks of the parity checks, and the
colouring of predictions."""

from __future__ import annotations

import contextlib
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


def relu_sign_hooks(model: torch.nn.Module, signs: dict, replay: dict = None,
                    flips: dict = None) -> list:
    """Record every ReLU that runs inside ``model``'s forward: ``nn.ReLU``
    modules and ``torch.nn.functional.relu`` calls alike (modules that hold
    the function as an attribute, e.g. an ``activation``, included). Each call
    stores its input's sign pattern (input > 0, on the CPU) in ``signs`` under
    the name of the innermost module running it, ``#n`` added for its n-th
    call after the first while the hooks are in place.

    Given ``replay``, another run's ``signs``, each ReLU keeps the units that
    run kept instead of its own, so that a step follows that run's branch of
    the piecewise-linear model: two steps in different precisions or on
    different devices then differ by rounding alone, where an input within
    rounding of 0 would otherwise move a whole gradient path. ``flips`` then
    receives, per call whose own signs differ, the units that differ and the
    largest |input| among them over the largest |input| of the call, which
    says whether each replayed branch lies within rounding of 0. A ReLU that a
    checkpointed segment recomputes in the backward keeps its forward call's
    branch: a module with a ``checkpoint_context`` (its checkpoints'
    ``context_fn``, as ``models.pixel_decoder``'s encoder layers hold) gets one
    that runs the recompute under the module's name. Returns the handles;
    remove them after the step (that also restores the function and the
    contexts).
    """
    functional = torch.nn.functional
    orig = functional.relu
    stack, seen, seen_again, recomputing = [], {}, {}, []

    def relu(x, inplace=False):
        if not stack:  # outside the model (a loss): untouched
            return orig(x, inplace=inplace)
        name = stack[-1]
        # a checkpointed segment's recompute takes its forward call's key and branch
        recompute = bool(recomputing)
        counts = seen_again if recompute else seen
        n = counts.get(name, 0)
        counts[name] = n + 1
        key = name if n == 0 else f"{name}#{n}"
        if recompute:
            if replay is None:
                return orig(x, inplace=inplace)
            keep = replay[key].to(x.device, x.dtype)
            return x.mul_(keep) if inplace else x * keep
        own = x > 0
        signs[key] = own.cpu()
        if replay is None:
            return orig(x, inplace=inplace)
        theirs = replay[key].to(x.device)
        if flips is not None:
            differ = own != theirs
            if differ.any():
                mag = x.detach().abs()
                flips[key] = {"units": int(differ.sum()), "max_abs_over_scale": float(
                    mag[differ].max() / mag.max().clamp_min(1e-30))}
        keep = theirs.to(x.dtype)
        return x.mul_(keep) if inplace else x * keep

    @contextlib.contextmanager
    def recompute_in(name):
        stack.append(name)
        recomputing.append(name)
        try:
            yield
        finally:
            recomputing.pop()
            stack.pop()

    held = [(m, k) for m in model.modules() for k, v in vars(m).items() if v is orig]
    contexts = [(name, m, m.checkpoint_context) for name, m in model.named_modules()
                if "checkpoint_context" in vars(m)]
    functional.relu = relu
    for m, k in held:
        setattr(m, k, relu)
    for name, m, _ in contexts:
        m.checkpoint_context = functools.partial(
            lambda name: (contextlib.nullcontext(), recompute_in(name)), name)

    class _Restore:
        def remove(self):
            functional.relu = orig
            for m, k in held:
                setattr(m, k, orig)
            for _, m, ctx in contexts:
                m.checkpoint_context = ctx

    def enter(module, args, name):
        stack.append(name)

    def leave(module, args, out):
        stack.pop()

    handles = [_Restore()]
    for name, m in model.named_modules():
        handles.append(m.register_forward_pre_hook(functools.partial(enter, name=name)))
        handles.append(m.register_forward_hook(leave))
    return handles


def map2citycolor(pred: np.ndarray) -> np.ndarray:
    """Train-id prediction map [H, W] -> RGB [H, W, 3] uint8 (other ids black),
    as ``multishiftseg_tpu/utils.py::map2citycolor``."""
    out = np.zeros(pred.shape + (3,), np.uint8)
    for tid, color in TRAIN_ID_COLORS.items():
        out[pred == tid] = color
    return out


def cached(cache: dict, key, make):
    """``cache[key]``, made by ``make()`` at its first use, outside inference
    mode: an inference tensor kept from an evaluation could not be saved for a
    later training step's backward. While ``torch.export`` or ``torch.compile``
    traces, a kept tensor is a constant of the trace, and one made there is a
    stand-in of the trace, so it is never kept."""
    if torch.compiler.is_compiling():
        return cache[key] if key in cache else make()
    if key not in cache:
        with torch.inference_mode(False):
            cache[key] = make()
    return cache[key]
