"""Ops with hand-written CUDA kernels, their plain versions, and launch counts.

The kernel entries of the eval and training paths are ``torch.library`` custom
ops under the ``mss`` namespace (:func:`custom_op`; ``ops.library`` imports
every module that defines one), so ``torch.export`` and graph capture see each
kernel as one opaque call: the CPU implementation is the plain version, the
CUDA implementation the ``ctypes`` launch, and a fake implementation states
the outputs' shapes and types without touching either.
"""

import contextlib
from typing import Callable, Dict, Optional

import torch

NAMESPACE = "mss"


def _counters():
    from ..evals import ood_metrics
    from ..losses import criterion, matcher, rcl
    from . import dilated_conv, ms_deform_attn, scores

    return (ms_deform_attn.LAUNCHES, scores.LAUNCHES, matcher.LAUNCHES, criterion.LAUNCHES,
            dilated_conv.LAUNCHES, rcl.LAUNCHES, ood_metrics.LAUNCHES)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per entry point since the last :func:`reset_launch_counts`."""
    return {k: v for counts in _counters() for k, v in counts.items()}


def reset_launch_counts() -> None:
    for counts in _counters():
        for k in counts:
            counts[k] = 0


@contextlib.contextmanager
def autograd_enabled():
    """Autograd, also inside an op's implementation: the dispatcher runs an
    implementation below the autograd keys, so a plain backward that takes
    autograd of its plain forward turns them back on (and grad mode) here."""
    key = torch._C.DispatchKey
    with torch._C._SetExcludeDispatchKeyGuard(key.AutogradFunctionality, False), \
            torch._C._SetExcludeDispatchKeyGuard(key.ADInplaceOrView, False), \
            torch.enable_grad():
        yield


# the registrations live as long as this library object
_LIBRARY = torch.library.Library(NAMESPACE, "DEF")


def custom_op(name: str, schema: str, plain: Callable, cuda: Callable, fake: Callable,
              backward: Optional[Callable] = None, setup_context: Optional[Callable] = None
              ) -> None:
    """Define ``mss::<name>`` with ``schema`` (its arguments and outputs):
    ``plain`` for CPU tensors, ``cuda`` (the kernel's launch) for CUDA tensors,
    ``fake`` (the outputs' shapes and types) for tracing and meta tensors, and
    with ``backward``, the op's autograd. The dispatcher calls each
    implementation directly: no per-call Python beyond it (and the autograd
    registration's, where there is one)."""
    _LIBRARY.define(name + schema)
    _LIBRARY.impl(name, plain, "CPU")
    _LIBRARY.impl(name, cuda, "CUDA")
    qualname = f"{NAMESPACE}::{name}"
    torch.library.register_fake(qualname, fake, lib=_LIBRARY)
    if backward is not None:
        torch.library.register_autograd(qualname, backward, setup_context=setup_context,
                                        lib=_LIBRARY)
