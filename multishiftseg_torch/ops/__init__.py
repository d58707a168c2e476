"""Ops with hand-written CUDA kernels, their plain versions, and launch counts."""

from typing import Dict


def _counters():
    from ..losses import criterion, matcher, rcl
    from . import dilated_conv, ms_deform_attn, scores

    return (ms_deform_attn.LAUNCHES, scores.LAUNCHES, matcher.LAUNCHES, criterion.LAUNCHES,
            dilated_conv.LAUNCHES, rcl.LAUNCHES)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per entry point since the last :func:`reset_launch_counts`."""
    return {k: v for counts in _counters() for k, v in counts.items()}


def reset_launch_counts() -> None:
    for counts in _counters():
        for k in counts:
            counts[k] = 0
