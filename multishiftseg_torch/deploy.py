"""Deployment: ahead-of-time export of the eval forwards with ``torch.export``.

Counterpart of ``multishiftseg_tpu/deploy.py``. The eval program is exported
once and served by a process that imports only ``torch``, numpy and this
module: no model zoo, no trainers, no config system. Every kernel of the
forward is a ``torch.library`` custom op (``ops/library.py``, imported here),
so the program calls the ``mss::`` ops by name and a replayed program launches
the same kernels, and counts the same launches, as the eager forward. Weights
travel beside the program as a flat ``.npz`` of the model's ``state_dict`` and
stay runtime inputs of the program (as JAX keeps ``variables`` a runtime
argument): the ``.pt2`` holds no parameter tensor and no example input, so one
artifact serves every fine-tune of an architecture; its constants are the
traced position embeddings and reference points, kept on the device.

A program is exported for one device (``cuda`` by default, ``cpu`` for the
tests): this is where JAX's ``platforms`` goes; there is no multi-device
artifact. Shapes are static: serving uses the eval buckets of
``train/test_runner.py`` (multiples of 128), one artifact a bucket.

Produces / consumes:
  <out>.pt2   the ``torch.export`` program (``torch.export.save``)
  <out>.npz   the weights, keyed by the ``state_dict``'s names, and the
              reserved ``__meta__/`` entries (input normalisation)

CLI:
  python -m multishiftseg_torch.deploy --model m2f --cfg exps/m2f.yaml \\
      --weight_path ckpt.pth --height 1024 --width 2048 --out m2f_1024x2048
"""

from __future__ import annotations

import argparse
import logging
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .ops import library  # noqa: F401  (registers the mss:: ops a program calls)

log = logging.getLogger(__name__)

_META_PREFIX = "__meta__/"


def save_pytree_npz(tree: Dict[str, torch.Tensor], path: str,
                    meta: Optional[dict] = None) -> None:
    """Write a flat ``{name: tensor}`` dict (a ``state_dict``) to an ``.npz``.

    ``meta``: an optional flat dict of small arrays written under the reserved
    ``__meta__/`` prefix; ignored by :func:`load_pytree_npz`, read back by
    :func:`load_npz_meta`. A name that contains the prefix could not be told
    from a meta entry and is refused, as JAX refuses a ``/`` in a path."""
    arrs = {}
    for key, value in tree.items():
        if _META_PREFIX in key:
            raise ValueError(f"key {key!r} contains the reserved prefix {_META_PREFIX!r}; "
                             "flat npz keys cannot round-trip it")
        arrs[key] = value.detach().cpu().numpy()
    for key, value in (meta or {}).items():
        arrs[_META_PREFIX + key] = np.asarray(value)
    np.savez(path, **arrs)


def load_pytree_npz(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    """The ``{name: tensor}`` dict written by :func:`save_pytree_npz`, on ``device``."""
    with np.load(path) as z:
        return {k: torch.from_numpy(z[k]).to(device) for k in z.files
                if not k.startswith(_META_PREFIX)}


def load_npz_meta(path: str) -> dict:
    """Read the reserved ``__meta__/`` entries written beside the weights."""
    with np.load(path) as z:
        return {k[len(_META_PREFIX):]: np.asarray(z[k])
                for k in z.files if k.startswith(_META_PREFIX)}


class _Program(torch.nn.Module):
    """``fwd(call, img)`` where ``call(*args)`` runs ``module`` with the weights
    given to :meth:`forward`. ``module`` is held outside the module tree, so
    none of its tensors becomes a constant of the exported program."""

    def __init__(self, fwd: Callable, module: torch.nn.Module):
        super().__init__()
        self._fwd = fwd
        object.__setattr__(self, "_module", module)

    def forward(self, weights: Dict[str, torch.Tensor], img: torch.Tensor):
        return self._fwd(lambda *a: torch.func.functional_call(self._module, weights, a), img)


def export_forward(fwd: Callable, module: torch.nn.Module, input_shape: Tuple[int, ...],
                   device="cuda") -> torch.export.ExportedProgram:
    """Export ``fwd(call, img)`` as a program of ``(weights, img)``: ``weights``
    is ``module``'s ``state_dict`` (parameters and buffers), a runtime input,
    and ``call(*args)`` runs ``module`` on them through
    ``torch.func.functional_call``. ``img``: f32 of ``input_shape``. Non-strict
    ``torch.export.export``, for ``device`` (JAX's ``platforms``)."""
    module = module.to(device).eval()
    weights = {k: v.detach() for k, v in module.state_dict().items()}
    img = torch.zeros(input_shape, dtype=torch.float32, device=device)
    program = _Program(fwd, module)
    with torch.no_grad():
        # one eager call fills the modules' caches of host-built constants
        # (position embeddings, reference points) on the device, where the
        # trace then keeps them: built in the trace, they would stay on the
        # host and be copied to the card at every call
        program(weights, img)
        return torch.export.export(program, (weights, img), strict=False)


def save_exported(exported: torch.export.ExportedProgram, path: str) -> None:
    """Write the program without the example inputs it was traced with: those
    are the weights, which travel in the npz."""
    exported.example_inputs = None
    torch.export.save(exported, path)


def load_exported(path: str) -> torch.export.ExportedProgram:
    return torch.export.load(path)


class ServingModel:
    """A loaded serving artifact: program + weights, callable on images.

    Imports nothing of the model zoo. ``__call__`` pads the batch to the
    exported static shape and crops the outputs back, the bucket discipline
    of ``OODEvaluator.test``. The program runs on the device it was exported
    for, where the weights are loaded."""

    def __init__(self, artifact_prefix: str):
        self.exported = load_exported(artifact_prefix + ".pt2")
        # the image is the program's last user input
        spec = [s for s in self.exported.graph_signature.input_specs
                if s.kind == torch.export.graph_signature.InputKind.USER_INPUT][-1]
        fake = next(n for n in self.exported.graph.nodes if n.name == spec.arg.name).meta["val"]
        self.input_shape = tuple(int(v) for v in fake.shape)
        self.device = fake.device
        self.weights = load_pytree_npz(artifact_prefix + ".npz", self.device)
        self.meta = load_npz_meta(artifact_prefix + ".npz")
        self._module = self.exported.module()

    @torch.inference_mode()
    def __call__(self, img: np.ndarray):
        """img: [N, H, W, 3] float32 RGB in [0, 1] (raw, NOT pre-normalised:
        :func:`export_model` bakes the training mean / std normalisation into
        the program; the constants travel in the npz under
        ``__meta__/input_{mean,std}``). N <= the exported batch, H / W <= the
        exported H / W. Returns (anomaly [N, H, W], sem [N, C, H, W]) for M2F,
        (score, logit) for DeepLab, as numpy f32 cropped to the input."""
        n, h, w = img.shape[:3]
        bn, bh, bw = self.input_shape[:3]
        if n > bn or h > bh or w > bw:
            raise ValueError(f"input {img.shape} exceeds exported {self.input_shape}")
        buf = torch.zeros(self.input_shape, dtype=torch.float32, device=self.device)
        buf[:n, :h, :w] = torch.as_tensor(np.asarray(img, np.float32)).to(self.device)
        first, second = self._module(self.weights, buf)
        return (first[:n, :h, :w].float().cpu().numpy(),
                second[:n, :, :h, :w].float().cpu().numpy())


def export_model(model: str, cfg, weight_path: Optional[str], out_prefix: str,
                 height: int, width: int, batch: int = 1, device="cuda",
                 module: Optional[torch.nn.Module] = None) -> str:
    """Build the eval forward as the test runner does, export it at the static
    bucket shape of ``(height, width)``, and write the two serving artifacts.

    The forward is ``build_m2f_forward``'s (``bilinear``, no approximate tail:
    ``(anomaly, sem)``) or ``build_deeplab_forward``'s (``(score, logit
    NCHW)``): the model from ``weight_path`` (or ``module``, or random init
    from ``cfg.train.seed``), bf16 autocast over f32 weights when
    ``cfg.train.bf16``. The eval pipeline's input normalisation
    (``Normalize(cfg.data.mean, cfg.data.std)``) is baked into the program, so
    a server without the config system takes raw [0, 1] images; the constants
    are also written under ``__meta__/input_{mean,std}``."""
    from .train import test_runner as tr

    bf16 = cfg.train.bf16

    def normalise(img):  # constants made on the program's device stay there
        mean = torch.tensor(cfg.data.mean, dtype=torch.float32, device=img.device)
        std = torch.tensor(cfg.data.std, dtype=torch.float32, device=img.device)
        return (img - mean) / std

    if model == "deeplab":
        from .train.deeplab_trainer import TrainDeepLabOOD

        net = TrainDeepLabOOD(cfg, weight_path, model=module, device=device).model

        def fwd(call, img):
            x = normalise(img).permute(0, 3, 1, 2)
            with torch.autocast(img.device.type, dtype=torch.bfloat16, enabled=bf16):
                return call(x)

    else:
        from .models.maskformer import inference
        from .train.m2f_trainer import TrainM2FOOD

        net = TrainM2FOOD(cfg, weight_path, model=module, device=device).model
        num_classes = net.num_classes

        def fwd(call, img):
            x = normalise(img)
            with torch.autocast(img.device.type, dtype=torch.bfloat16, enabled=bf16):
                outputs = call(x)
            sem, anomaly = inference(outputs, tuple(x.shape[1:3]), num_classes=num_classes)
            return anomaly, sem

    bh, bw = tr.bucket_shape(height, width)
    exported = export_forward(fwd, net, (batch, bh, bw, 3), device=device)
    save_exported(exported, out_prefix + ".pt2")
    save_pytree_npz(net.state_dict(), out_prefix + ".npz",
                    meta={"input_mean": np.asarray(cfg.data.mean, np.float32),
                          "input_std": np.asarray(cfg.data.std, np.float32),
                          "normalization_baked": np.asarray(1, np.int32)})
    log.info("exported %s @ (%d, %d, %d, 3) for %s -> %s.{pt2,npz}",
             model, batch, bh, bw, device, out_prefix)
    return out_prefix


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", choices=["deeplab", "m2f"], required=True)
    parser.add_argument("--cfg", default=None)
    parser.add_argument("--id", default="deploy")
    parser.add_argument("--weight_path", default=None)
    parser.add_argument("--height", type=int, default=1024)
    parser.add_argument("--width", type=int, default=2048)
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--device", default="cuda",
                        help="the device the program is exported for: cuda (default) or cpu")
    parser.add_argument("--out", required=True, help="artifact path prefix")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    from .core.config import load_config

    cfg = load_config(args.cfg, args.id)
    return export_model(args.model, cfg, args.weight_path, args.out, args.height, args.width,
                        args.batch, args.device)


if __name__ == "__main__":
    main()
