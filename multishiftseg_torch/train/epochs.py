"""The epoch loop both trainers share.

Counterpart of ``train`` in ``multishiftseg_tpu/train/m2f_trainer.py``
(:347-493) and ``multishiftseg_tpu/train/deeplab_trainer.py`` (:184-318), its
multi-process branch included (each rank loads its shard of the global batch,
only rank 0 writes the scalar curves and the checkpoints, every rank
validates, rank 0's metrics deciding the best checkpoint for all, and
every rank reads the checkpoints on resume): the datasets and a
shuffling :class:`Loader` onto the trainer's device, the resume from a named
checkpoint, the switch to stage 1 at ``warmup_epoch``, one validation a epoch,
the scalar curves, ``AUPRC_best`` on improvement and ``last`` every epoch.
Each epoch's steps, stage, times and metrics go to ``trainer.history``. As in
JAX, no step waits for the device (:func:`run_epoch`, which the instance
trainer's loop shares).
"""

from __future__ import annotations

import logging
import statistics
import time
from typing import Callable, Dict, Optional

from ..core.logging import ScalarWriter, StreamStepTimer
from ..core.mesh import from_rank0, process_count, process_index
from ..data.loader import Loader
from .checkpoint import CheckpointManager

log = logging.getLogger(__name__)


def run_epoch(trainer, loader: Loader, step: Callable) -> Dict[str, float]:
    """One epoch's steps over ``loader``: ``step(*batch)`` takes one batch
    (device tensors) and returns (its loss, its images). No step waits for
    the card: the epoch's ``float(loss)`` is its one wait, inside its time,
    and each step's span on the card comes from CUDA events read after it.
    Returns the epoch's steps, images, seconds, img_per_s, step_ms_median,
    loader_wait_s and loss. Raises when the loader yields no batch."""
    timer = StreamStepTimer(trainer.device)
    wait0, t0, n_img, loss = loader.wait_seconds, time.perf_counter(), 0, None
    for batch in loader:
        timer.start()
        loss, images = step(*batch)
        timer.stop()
        n_img += images
    if n_img == 0:
        raise RuntimeError(f"loader produced no batches (dataset size {len(loader.dataset)} "
                           f"< batch {loader.batch_size} with drop_last)")
    loss = float(loss)
    seconds = time.perf_counter() - t0
    step_ms = timer.times_ms()
    return {"steps": len(step_ms), "images": n_img, "seconds": seconds,
            "img_per_s": n_img / max(seconds, 1e-9), "step_ms_median": statistics.median(step_ms),
            "loader_wait_s": loader.wait_seconds - wait0, "loss": loss}


def train_epochs(trainer, start_epoch: int, resume: Optional[str],
                 step: Callable, epoch_scalars: Callable[[int, float], Dict[str, float]]
                 ) -> Dict[str, float]:
    """Run ``trainer`` from ``start_epoch`` (or from checkpoint ``resume``) to
    ``cfg.train.n_epochs``.

    ``step(stage, img_c, img_g, tgt_c, tgt_g)`` takes one paired batch (device
    tensors) and returns its loss; ``epoch_scalars(stage, img_per_s)`` adds the
    trainer's own scalars to ``train/loss``. Returns ``trainer.best``.
    """
    cfg = trainer.cfg
    writer = ScalarWriter(cfg.model_dir) if cfg.model_dir and process_index() == 0 else None
    ckpt = CheckpointManager(cfg.model_dir)
    train_ds, val_ds = trainer.build_datasets()
    loader = Loader(train_ds, batch_size=trainer.local_batch, shuffle=True, drop_last=True,
                    num_workers=cfg.data.num_workers, seed=cfg.train.seed, device=trainer.device,
                    shard_index=process_index(), shard_count=process_count())
    warmup = cfg.train.warmup_epoch
    start_epoch, stage = ckpt.resume(trainer, resume, start_epoch, warmup)
    trainer.history = []
    for epoch in range(start_epoch, cfg.train.n_epochs):
        if stage == 0 and warmup >= 0 and epoch >= warmup:
            stage = 1
            trainer.set_stage(1)
            log.warning("epoch %d: switched to stage 1", epoch)
        train_ds.set_epoch(epoch)
        rec = run_epoch(trainer, loader, lambda img_c, tgt_c, img_g, tgt_g: (
            step(stage, img_c, img_g, tgt_c, tgt_g), 2 * img_c.shape[0]))
        loss, img_per_s = rec["loss"], rec["img_per_s"]
        log.warning("epoch %d stage %d loss %.4f (%.1f img/s)", epoch, stage, loss, img_per_s)
        t1 = time.perf_counter()
        # every rank validates; rank 0's metrics decide, so that all ranks
        # take the same branch to the checkpoint's barrier
        metrics = from_rank0(trainer.valid(val_ds))
        valid_seconds = time.perf_counter() - t1
        log.warning("epoch %d %s", epoch, metrics)
        if writer is not None:
            writer.add_scalars({"train/loss": loss, **epoch_scalars(stage, img_per_s)}, epoch)
            if metrics:
                writer.add_scalars({f"val/{k}": float(v) for k, v in metrics.items()}, epoch)
        saved = ["last"]
        if metrics and metrics["AUPRC"] > trainer.best["AUPRC"]:
            trainer.best["AUPRC"] = metrics["AUPRC"]
            ckpt.save("AUPRC_best", trainer, generator=False, epoch=epoch,
                      best_auprc=trainer.best["AUPRC"])
            saved.insert(0, "AUPRC_best")
            log.warning("saved the best model for AUPRC (%.4f)", metrics["AUPRC"])
        # the fault-tolerance checkpoint, overwritten every epoch (--resume last)
        ckpt.save("last", trainer, epoch=epoch, best_auprc=trainer.best["AUPRC"])
        trainer.history.append({
            "epoch": epoch, "stage": stage, **rec,
            "optimizer": type(trainer.optimizer).__name__,
            "valid_seconds": valid_seconds, "metrics": metrics, "saved": saved})
    if writer is not None:
        writer.close()
    return trainer.best
