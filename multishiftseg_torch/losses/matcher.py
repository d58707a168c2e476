"""Hungarian matching for mask classification: costs in PyTorch, the assignment
on the card.

Counterpart of ``multishiftseg_tpu/losses/matcher.py``: the per-image cost
(class + point-sampled sigmoid-CE + dice, :112-156) is computed batched in f32,
and the minimum-cost assignment (``linear_sum_assignment``, :28-109) is the CUDA
kernel ``csrc/assignment.cu`` for CUDA tensors and the same algorithm in numpy
on the host for CPU tensors. Target slots are the K train ids, or, in
instance mode (``tgt_classes``), T segments of any classes, duplicates
allowed (:138-181); a slot that is absent or padding costs ``BIG`` against
every query. Rows of the
assignment problem are targets, columns are queries.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

BIG = 1e9

# Kernel launches (see ``ops.launch_counts``).
LAUNCHES = {"linear_sum_assignment": 0}


def linear_sum_assignment(cost: torch.Tensor) -> torch.Tensor:
    """Min-cost assignment of each of R rows to one of C columns (R <= C) for a
    batch of problems: cost [B, R, C] -> col4row [B, R] int64.

    Jonker-Volgenant shortest augmenting paths with dual potentials, row by row,
    ties to the lowest column: the JAX solver's algorithm and arithmetic, so the
    same assignment. The kernel for a CUDA tensor, the plain version on the host
    for a CPU tensor.
    """
    if cost.dim() != 3 or cost.shape[1] > cost.shape[2]:
        raise ValueError(f"expected cost [B, R, C] with R <= C, got {tuple(cost.shape)}")
    if cost.device.type == "cpu":
        return linear_sum_assignment_plain(cost)
    return _lsa_cuda(cost)


def linear_sum_assignment_plain(cost: torch.Tensor, steps: Optional[list] = None
                                ) -> torch.Tensor:
    """Plain version: the solver in numpy float32, one problem after another.
    ``steps``, when given, receives each problem's count of Dijkstra steps (the
    work this data needs: each step touches every column)."""
    c = cost.detach().float().cpu().numpy()
    out = (np.stack([_lsa_one(m, steps) for m in c]) if len(c)
           else np.zeros((0, c.shape[1]), np.int64))
    return torch.from_numpy(out.astype(np.int64)).to(cost.device)


def _lsa_one(cost: np.ndarray, steps: Optional[list] = None) -> np.ndarray:
    """``matcher.py:42-108`` for one [R, C] float32 problem, operation for operation."""
    r, c = cost.shape
    f32 = np.float32
    u = np.zeros(r, f32)
    v = np.zeros(c, f32)
    col4row = np.full(r, -1, np.int64)
    row4col = np.full(c, -1, np.int64)
    n_steps = 0
    for cur in range(r):
        shortest = np.full(c, np.inf, f32)
        parent = np.full(c, cur, np.int64)
        visited = np.zeros(c, bool)
        i, sink, minval = cur, -1, f32(0.0)
        while sink < 0:
            n_steps += 1
            reduced = ((cost[i] - u[i]) - v) + minval
            better = (reduced < shortest) & ~visited
            shortest = np.where(better, reduced, shortest)
            parent = np.where(better, i, parent)
            masked = np.where(visited, np.inf, shortest).astype(f32)
            j = int(np.argmin(masked))  # first occurrence, as jnp.argmin
            minval = masked[j]
            visited[j] = True
            if row4col[j] < 0:
                sink = j
            else:
                i = int(row4col[j])
        u[cur] = u[cur] + minval
        delta = (minval - shortest).astype(f32)
        for j in np.nonzero(visited & (row4col >= 0))[0]:
            u[row4col[j]] = u[row4col[j]] + delta[j]
        v = np.where(visited, v + (-delta), v).astype(f32)
        j = sink
        while True:
            i = int(parent[j])
            prev = int(col4row[i])
            row4col[j] = i
            col4row[i] = j
            j = prev
            if i == cur:
                break
    if steps is not None:
        steps.append(n_steps)
    return col4row


# The kernel's limits (``csrc/assignment.cu``): columns, and shared memory a
# problem (its cost copy, u and col4row), the H100's opt-in maximum a block.
LSA_MAX_COLUMNS = 512
LSA_MAX_SHARED_BYTES = 232448


def assignment_shared_bytes(r: int, c: int) -> int:
    """Shared memory the kernel takes for one R x C problem
    (``lsa_smem_bytes`` in ``csrc/assignment.cu``)."""
    return 4 * ((r * c + 6) & ~3) + 8 * r


def check_assignment_shape(r: int, c: int) -> None:
    """Raise ValueError, naming the limit, for a problem shape the kernel does
    not hold."""
    if c > LSA_MAX_COLUMNS:
        raise ValueError(f"the assignment kernel takes at most {LSA_MAX_COLUMNS} columns, "
                         f"got {c}")
    need = assignment_shared_bytes(r, c)
    if need > LSA_MAX_SHARED_BYTES:
        raise ValueError(f"the assignment kernel holds a problem in at most "
                         f"{LSA_MAX_SHARED_BYTES} bytes of shared memory (4 * R * C + 8 * R "
                         f"and alignment); {r} x {c} needs {need}")


_LSA_SOLVE = []  # the kernel's entry, once loaded


def launch_device(dev: torch.device):
    """``dev`` as the current device for a launch: no switch when it is
    already (the wrappers of these small kernels count their host time)."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _lsa_cuda(cost: torch.Tensor) -> torch.Tensor:
    if cost.dtype != torch.float32:
        raise TypeError(f"cost must be float32, got {cost.dtype}")
    b, r, c = cost.shape
    check_assignment_shape(r, c)
    cost = cost.contiguous()
    if not _LSA_SOLVE:
        from .._build import function

        _LSA_SOLVE.append(function("assignment", "lsa_solve",
                                   [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                                   + [ctypes.c_void_p]))
    dev = cost.device
    out = torch.empty((b, r), dtype=torch.int64, device=dev)
    with launch_device(dev):
        # the raw handle: building a torch Stream object costs host time
        rc = _LSA_SOLVE[0](cost.data_ptr(), out.data_ptr(), b, r, c,
                           torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError(f"lsa_solve failed: cudaError {rc}")
    LAUNCHES["linear_sum_assignment"] += 1
    return out


def batch_sigmoid_ce_cost(inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """[B, Q, P] logits x [B, T, P] targets -> [B, Q, T] mean BCE cost."""
    p = inputs.shape[-1]
    pos = F.softplus(-inputs)
    neg = F.softplus(inputs)
    return (pos @ targets.transpose(1, 2) + neg @ (1.0 - targets).transpose(1, 2)) / p


def batch_dice_cost(inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """[B, Q, P] logits x [B, T, P] targets -> [B, Q, T] dice cost."""
    probs = torch.sigmoid(inputs)
    numerator = 2.0 * (probs @ targets.transpose(1, 2))
    denominator = probs.sum(-1)[:, :, None] + targets.sum(-1)[:, None, :]
    return 1.0 - (numerator + 1.0) / (denominator + 1.0)


def compute_match_cost(pred_logits: torch.Tensor, out_points: torch.Tensor,
                       tgt_points: torch.Tensor, valid: torch.Tensor,
                       cost_class_w: float, cost_mask_w: float,
                       cost_dice_w: float,
                       tgt_classes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, Q, T] total matching cost; invalid slots cost ``BIG``. Semantic
    targets: slot t is class t. Instance targets: slot t is class
    ``tgt_classes[b, t]`` ([B, T] int, -1 for padding, which reads class 0 and
    is masked to ``BIG`` with the other invalid slots)."""
    probs = torch.softmax(pred_logits.float(), dim=-1)
    t = tgt_points.shape[1]
    out_points = out_points.float()
    if tgt_classes is None:
        cost_class = -probs[..., :t]
    else:
        idx = tgt_classes.long().clamp(0, probs.shape[-1] - 1)
        cost_class = -probs.gather(2, idx[:, None, :].expand(-1, probs.shape[1], -1))
    cost = (cost_class_w * cost_class
            + cost_mask_w * batch_sigmoid_ce_cost(out_points, tgt_points)
            + cost_dice_w * batch_dice_cost(out_points, tgt_points))
    return torch.where(valid[:, None, :], cost, torch.full_like(cost, BIG))


@torch.no_grad()
def match(pred_logits: torch.Tensor, out_points: torch.Tensor, tgt_points: torch.Tensor,
          valid: torch.Tensor, cost_class_w: float = 2.0, cost_mask_w: float = 5.0,
          cost_dice_w: float = 5.0, tgt_classes: Optional[torch.Tensor] = None
          ) -> torch.Tensor:
    """Batched matching -> the query of each target slot, [B, T] int64
    (``tgt_classes``: instance mode, see :func:`compute_match_cost`)."""
    cost = compute_match_cost(pred_logits, out_points, tgt_points, valid,
                              cost_class_w, cost_mask_w, cost_dice_w, tgt_classes)
    return linear_sum_assignment(cost.transpose(1, 2))  # rows = targets
