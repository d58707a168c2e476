"""Batched per-epoch validation shared by both trainers.

Counterpart of ``multishiftseg_tpu/train/validation.py``: the evaluator's
shape buckets (``test_runner.bucket_shape``, multiples of 128) and batch 4,
with every map reduced on its device by :class:`BinnedOODMeter` (its range and
histogram kernels, ``csrc/ood_hist.cu``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..evals.ood_metrics import BinnedOODMeter
from .test_runner import bucket_shape


def batched_valid(val_ds, score_fn: Callable[[torch.Tensor], torch.Tensor],
                  batch_size: int = 4) -> Optional[Dict[str, float]]:
    """Binned OOD metrics over ``val_ds`` with shape-bucketed batching.

    ``score_fn(imgs [B, Hb, Wb, 3] float32) -> anomaly [B, Hb, Wb]``. Items are
    ``(image [H, W, 3] normalised f32, labels [H, W], ...)``; images that share
    a padded bucket run in one batch, each map cropped back to its image before
    the meter. Datasets with an ``images`` path list are bucketed from the
    files' headers, others by decoding their items.
    """
    n = len(val_ds)
    if n == 0:
        return None

    buckets: Dict[Tuple[int, int], List[int]] = {}
    if hasattr(val_ds, "images"):
        from PIL import Image

        for i in range(n):
            with Image.open(val_ds.images[i]) as im:
                w, h = im.size
            buckets.setdefault(bucket_shape(h, w), []).append(i)
    else:  # no path list: probe by decoding (synthetic and test datasets)
        for i in range(n):
            h, w = val_ds[i][0].shape[:2]
            buckets.setdefault(bucket_shape(h, w), []).append(i)

    meter = BinnedOODMeter()
    for (bh, bw), idxs in buckets.items():
        for s in range(0, len(idxs), batch_size):
            chunk = [val_ds[i] for i in idxs[s:s + batch_size]]
            imgs = np.zeros((len(chunk), bh, bw, 3), np.float32)
            for j, item in enumerate(chunk):
                img = item[0]
                # buckets come from the on-disk size; a transform that enlarged
                # the image would break the bucketing contract
                assert img.shape[0] <= bh and img.shape[1] <= bw, (
                    f"transformed image {img.shape[:2]} exceeds its shape bucket "
                    f"({bh}, {bw}); the val transform must not enlarge images")
                imgs[j, :img.shape[0], :img.shape[1]] = img
            anomaly = score_fn(torch.from_numpy(imgs))
            for j, item in enumerate(chunk):
                h, w = item[0].shape[:2]
                meter.update(anomaly[j, :h, :w], item[1])
    res = meter.compute()
    if res is None:
        return None
    auroc, auprc, fpr = res
    return {"AUROC": auroc, "AUPRC": auprc, "FPR_TPR95": fpr}
