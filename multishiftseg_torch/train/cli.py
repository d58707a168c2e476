"""Training command line: the port's counterpart of
``multishiftseg_tpu/train/cli.py`` (the reference's ``train_deeplab.py`` /
``train_m2f.py``).

    python -m multishiftseg_torch.train.cli --model m2f --cfg exps/m2f.yaml \\
        --id exp0 [--weight_path pretrained.pth] [--resume last] [--device cuda]

Data-parallel over N cards of a host (one process a card, each taking
``train_batch / N`` of the global batch; ``core.mesh``):

    torchrun --nproc_per_node N -m multishiftseg_torch.train.cli --model m2f ...

With ``train.model_parallel: M`` (tensor parallelism,
``core/tensor_parallel.py``) each process drives M cards, so N cards take
``--nproc_per_node N/M``; process r binds to card ``r * M``.

It reads the recipe, then joins the launch (``initialize_distributed``, as
JAX's CLI does; NCCL, or gloo with ``--device cpu``); only rank 0 logs and
writes.

The log goes to ``cfg.log_dir/log.txt`` (``outputs/<id>/`` by default) and to
stderr; checkpoints and ``scalars.csv`` to ``cfg.model_dir`` (``ckpts/<id>/``).
It trains on the card unless ``--device cpu`` is given, and raises when CUDA is
asked for and absent. The vanilla Mask2Former recipes
(``exps/m2f_{instance,panoptic,semantic}.yaml``: ``instance_on``,
``panoptic_on`` or ``ood_finetune: false``) train :class:`TrainM2FInstance`;
``--run evaluate`` then reports its AP / PQ / mIoU on the val split.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Optional, Sequence


def trainer_class(model: str, cfg):
    """The trainer ``--model`` and the configuration select."""
    if model == "deeplab":
        from .deeplab_trainer import TrainDeepLabOOD

        return TrainDeepLabOOD
    m = cfg.model.m2f
    if m.instance_on or m.panoptic_on or not m.ood_finetune:
        from .instance_trainer import TrainM2FInstance

        return TrainM2FInstance
    from .m2f_trainer import TrainM2FOOD

    return TrainM2FOOD


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", choices=["deeplab", "m2f"], required=True)
    parser.add_argument("--cfg", default=None, help="experiment yaml")
    parser.add_argument("--id", default="exp", help="experiment id")
    parser.add_argument("--weight_path", default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--run", default="train")
    parser.add_argument("--start_epoch", type=int, default=0)
    parser.add_argument("--resume", default=None,
                        help="checkpoint name to resume from (last or AUPRC_best)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from ..core.config import load_config
    from ..core.mesh import initialize_distributed, process_index

    cfg = load_config(args.cfg, args.id)
    # a process drives model_parallel x pipeline_parallel cards from its first
    per_process = max(cfg.train.model_parallel, 1) * max(cfg.train.pipeline_parallel, 1)
    if initialize_distributed(backend="gloo" if args.device == "cpu" else None,
                              devices_per_process=per_process) and args.device == "cuda":
        import torch

        args.device = f"cuda:{torch.cuda.current_device()}"
    cfg.train.seed = args.seed
    os.makedirs(cfg.log_dir, exist_ok=True)
    root = logging.getLogger()
    handlers = []
    if process_index() == 0:
        handlers.append(logging.FileHandler(os.path.join(cfg.log_dir, "log.txt")))
        if not root.handlers:
            handlers.append(logging.StreamHandler())
    for h in handlers:
        h.setFormatter(logging.Formatter("[%(asctime)s] %(message)s"))
        root.addHandler(h)
    root.setLevel(logging.INFO)
    try:
        trainer = trainer_class(args.model, cfg)(cfg, weight_path=args.weight_path,
                                                 device=args.device)
        run_fn = getattr(trainer, args.run)
        if args.run == "train":
            result = run_fn(start_epoch=args.start_epoch, resume=args.resume)
        else:
            result = run_fn()
        logging.warning("done: %s", result)
        return result
    finally:
        for h in handlers:
            root.removeHandler(h)
            h.close()


if __name__ == "__main__":
    main()
