"""MaskFormer meta-architecture (Mask2Anomaly variant): backbone -> pixel decoder ->
GMA transformer decoder, plus preprocessing and semantic / anomaly inference.

Counterpart of ``multishiftseg_tpu/models/maskformer.py`` for backbone
``resnet50``, pixel decoder ``msdeformattn`` and predictor ``gma``. Module names
follow the reference: ``backbone.*``, ``sem_seg_head.pixel_decoder.*``,
``sem_seg_head.predictor.*``. Images enter as ``[N, H, W, 3]``.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.scores import (anomaly_score_lowres, anomaly_score_topq,  # noqa: F401
                          anomaly_score_upsampled, semantic_inference,
                          semantic_inference_upsampled)
from .pixel_decoder import MSDeformAttnPixelDecoder
from .resnet import ResNet
from .transformer_decoder import MultiScaleMaskedTransformerDecoderGMA

PIXEL_MEAN = (123.675, 116.280, 103.530)
PIXEL_STD = (58.395, 57.120, 57.375)
SIZE_DIVISIBILITY = 32


class MaskFormerHead(nn.Module):
    """The reference's ``sem_seg_head``: pixel decoder + transformer predictor."""

    def __init__(self, pixel_decoder: nn.Module, predictor: nn.Module):
        super().__init__()
        self.pixel_decoder = pixel_decoder
        self.predictor = predictor


class MaskFormer(nn.Module):
    """Prediction dict of the GMA decoder for preprocessed ``[N, H, W, 3]`` images."""

    def __init__(self, num_classes: int = 19, backbone: str = "resnet50",
                 hidden_dim: int = 256, num_queries: int = 100, nheads: int = 8,
                 dim_feedforward: int = 2048, dec_layers: int = 9, mask_dim: int = 256,
                 transformer_enc_layers: int = 6, pixel_decoder: str = "msdeformattn",
                 predictor: str = "gma"):
        super().__init__()
        if backbone != "resnet50":
            raise NotImplementedError(f"backbone {backbone!r} is not ported")
        if pixel_decoder != "msdeformattn":
            raise NotImplementedError(f"pixel_decoder {pixel_decoder!r} is not ported")
        if predictor != "gma":
            raise NotImplementedError(f"predictor {predictor!r} is not ported")
        self.num_classes = num_classes
        self.backbone = ResNet(depth=50)
        # the JAX MaskFormer leaves the pixel decoder's 8 heads at their default
        self.sem_seg_head = MaskFormerHead(
            MSDeformAttnPixelDecoder(conv_dim=hidden_dim, mask_dim=mask_dim,
                                     transformer_enc_layers=transformer_enc_layers),
            MultiScaleMaskedTransformerDecoderGMA(
                num_classes=num_classes, hidden_dim=hidden_dim, num_queries=num_queries,
                nheads=nheads, dim_feedforward=dim_feedforward, dec_layers=dec_layers,
                mask_dim=mask_dim))

    def forward(self, images: torch.Tensor,
                deform_sample_mode: Union[str, Sequence[str]] = "bilinear",
                quantize_deform_table: bool = False) -> Dict[str, object]:
        """images: [N, H, W, 3], normalised and padded to /32 (:func:`preprocess`).
        ``deform_sample_mode``: a sample mode of ``ops.ms_deform_attn``
        (``bilinear``, exact, by default), or one per encoder layer;
        ``quantize_deform_table``: the int8 value table (``bilinear`` layers;
        one scale over the batch, as JAX's model)."""
        x = images.permute(0, 3, 1, 2).to(self.backbone.stem.conv1.weight.dtype)
        feats = self.backbone(x)
        mask_features, _, multi_scale = self.sem_seg_head.pixel_decoder(
            feats, deform_sample_mode, quantize_deform_table)
        return self.sem_seg_head.predictor(multi_scale, mask_features)


def preprocess(images_uint8: torch.Tensor, pixel_mean: Tuple[float, ...] = PIXEL_MEAN,
               pixel_std: Tuple[float, ...] = PIXEL_STD) -> torch.Tensor:
    """Normalise [N, H, W, 3] RGB (0-255) to f32 and pad bottom/right to /32."""
    mean = torch.tensor(pixel_mean, dtype=torch.float32, device=images_uint8.device)
    std = torch.tensor(pixel_std, dtype=torch.float32, device=images_uint8.device)
    x = (images_uint8.float() - mean) / std
    ph = (-x.shape[1]) % SIZE_DIVISIBILITY
    pw = (-x.shape[2]) % SIZE_DIVISIBILITY
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    return x


def inference(outputs: Dict[str, torch.Tensor], image_hw: Tuple[int, int],
              num_classes: int = 19, score_lowres: bool = False,
              score_topq: int = 0, _classes_only: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval tail at the padded image size: (sem [N, K + Q, H, W], anomaly [N, H, W]).

    Both heads go through the fused upsample-and-score path
    (``ops/scores.py``), a CUDA kernel on the card. The anomaly branch is
    differentiable on both devices (stage 1 trains through it). A caller that
    keeps only ``sem[:, :K]``, as the stage-1 step does, passes
    ``_classes_only``: sem is then [N, K, H, W] and the kept-query channels are
    never written.

    The approximate anomaly tails of JAX ``inference`` (:210-240), each to be
    qualified per checkpoint: ``score_lowres`` scores at mask resolution and
    resizes the score plane once (:func:`ops.scores.anomaly_score_lowres`);
    ``score_topq = Q`` scores the Q OOD queries with the largest non-void peak
    probability alone (:func:`ops.scores.anomaly_score_topq`). JAX lets
    ``score_topq`` win silently when both are set (:214); here setting both
    raises ``ValueError``.
    """
    if score_lowres and score_topq:
        raise ValueError("score_lowres and score_topq are exclusive; set one")
    sem = semantic_inference_upsampled(outputs["pred_logits"], outputs["pred_masks"],
                                       image_hw, num_classes, _classes_only=_classes_only)
    cls, masks = outputs["pred_logits_ood"], outputs["pred_masks_ood"]
    if score_topq:
        anomaly = anomaly_score_topq(cls, masks, image_hw, score_topq)
    elif score_lowres:
        anomaly = anomaly_score_lowres(cls, masks, image_hw)
    else:
        anomaly = anomaly_score_upsampled(cls, masks, image_hw)
    return sem, anomaly
