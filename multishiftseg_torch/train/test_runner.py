"""Whole-image eval forwards of both model families.

Counterpart of ``multishiftseg_tpu/train/test_runner.py::build_m2f_forward``
(:316-411) for the ``bilinear`` and ``nearest`` sample modes, and of
``build_deeplab_forward`` (:255-271). The config loader, the checkpoint loading,
the sampling-qualification gate and ``OODEvaluator`` are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..models.deeplab import DeepWV3Plus
from ..models.maskformer import MaskFormer, inference, preprocess
from ..ops.ms_deform_attn import SAMPLE_MODES
from ..utils import resolve_device


def build_m2f_forward(model: MaskFormer, device="cuda", sample_mode: str = "bilinear"
                      ) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """``fwd(images_uint8 [N, H, W, 3]) -> (anomaly [N, H, W], sem [N, K + Q, H, W])``.

    Moves ``model`` to ``device`` (CUDA unless the caller asks for the CPU) in
    eval mode; it keeps its parameter dtype (bf16 or f32). ``fwd`` normalises and
    pads the images to /32, runs the model and the fused score tail, and crops
    both outputs back to the input size. Outputs are f32 tensors on ``device``.
    """
    if sample_mode not in SAMPLE_MODES:
        raise NotImplementedError(f"sample_mode {sample_mode!r} is not ported; "
                                  f"choose from {SAMPLE_MODES}")
    device = resolve_device(device)
    model = model.to(device).eval()
    num_classes = model.num_classes

    @torch.inference_mode()
    def fwd(images_uint8):
        imgs = torch.as_tensor(images_uint8, device=device)
        if imgs.dtype != torch.uint8 or imgs.dim() != 4 or imgs.shape[-1] != 3:
            raise ValueError(f"expected uint8 [N, H, W, 3] images, got "
                             f"{imgs.dtype} {tuple(imgs.shape)}")
        h, w = imgs.shape[1:3]
        x = preprocess(imgs)
        outputs = model(x, deform_sample_mode=sample_mode)
        sem, anomaly = inference(outputs, x.shape[1:3], num_classes=num_classes)
        return anomaly[:, :h, :w], sem[..., :h, :w]

    return fwd


def build_deeplab_forward(model: DeepWV3Plus, device="cuda", bf16: bool = True
                          ) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """``fwd(images [N, H, W, 3] normalised f32) -> (score [N, H, W], logit
    [N, C, H, W])``, both f32 on ``device``.

    Moves ``model`` to ``device`` (CUDA unless the caller asks for the CPU) in
    eval mode, in the channels-last memory format on the card. With ``bf16`` the
    forward runs under autocast in bf16 over the model's f32 weights (the JAX
    model's ``dtype=bfloat16``); the energy score and the logits' resize stay f32.
    """
    device = resolve_device(device)
    model = model.to(device).eval()
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)

    @torch.inference_mode()
    def fwd(images):
        x = torch.as_tensor(images, device=device)
        if x.dtype != torch.float32 or x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError(f"expected normalised float32 [N, H, W, 3] images, got "
                             f"{x.dtype} {tuple(x.shape)}")
        with torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16):
            return model(x.permute(0, 3, 1, 2))

    return fwd
