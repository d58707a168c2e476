"""MaskFormer meta-architecture (Mask2Anomaly variant): backbone -> pixel decoder ->
transformer decoder, plus preprocessing and semantic / anomaly inference.

Counterpart of ``multishiftseg_tpu/models/maskformer.py`` with its routings
(:73-136): backbone ``resnet{18,34,50,101,152}`` or ``swin_{tiny,small,base,
large}``; pixel decoder ``msdeformattn``, ``fpn`` or ``transformer_encoder``;
predictor ``gma`` (dual OOD heads), ``vanilla`` (no ``pred_*_ood`` keys) or
``standard`` (MaskFormer-v1, fed the pixel decoder's encoder feature). Module
names follow the reference: ``backbone.*``, ``sem_seg_head.pixel_decoder.*``,
``sem_seg_head.predictor.*``. Images enter as ``[N, H, W, 3]``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.scores import (anomaly_score_lowres, anomaly_score_topq,  # noqa: F401
                          anomaly_score_upsampled, semantic_inference,
                          semantic_inference_upsampled)
from .fpn_decoder import BasePixelDecoder, TransformerEncoderPixelDecoder
from .maskformer_v1_decoder import StandardTransformerDecoder
from .pixel_decoder import MSDeformAttnPixelDecoder
from .resnet import RESNET_STAGES, ResNet, resnet_feature_channels
from .swin import SWIN_CONFIGS, SWIN_FEATURE_CHANNELS, SwinTransformer
from .transformer_decoder import (MultiScaleMaskedTransformerDecoder,
                                  MultiScaleMaskedTransformerDecoderGMA)

PREDICTORS = {"gma": MultiScaleMaskedTransformerDecoderGMA,
              "vanilla": MultiScaleMaskedTransformerDecoder,
              "standard": StandardTransformerDecoder}
PIXEL_DECODERS = ("msdeformattn", "fpn", "transformer_encoder")

PIXEL_MEAN = (123.675, 116.280, 103.530)
PIXEL_STD = (58.395, 57.120, 57.375)
SIZE_DIVISIBILITY = 32


def build_backbone(name: str) -> Tuple[nn.Module, Dict[str, int]]:
    """(backbone, its res2..res5 channels) for ``resnet{N}`` (frozen BN,
    output stride 32) or ``swin_{tiny,small,base,large}``."""
    if name.startswith("resnet") and name[6:].isdigit() and int(name[6:]) in RESNET_STAGES:
        return ResNet(depth=int(name[6:])), resnet_feature_channels(int(name[6:]))
    if name.startswith("swin_") and name[5:] in SWIN_CONFIGS:
        return SwinTransformer(**SWIN_CONFIGS[name[5:]]), SWIN_FEATURE_CHANNELS[name[5:]]
    raise ValueError(f"unknown backbone {name!r}")


class MaskFormerHead(nn.Module):
    """The reference's ``sem_seg_head``: pixel decoder + transformer predictor."""

    def __init__(self, pixel_decoder: nn.Module, predictor: nn.Module):
        super().__init__()
        self.pixel_decoder = pixel_decoder
        self.predictor = predictor


class MaskFormer(nn.Module):
    """Prediction dict of the ``predictor`` decoder for preprocessed
    ``[N, H, W, 3]`` images (the GMA decoder over R-50 and the MSDeformAttn
    pixel decoder by default)."""

    def __init__(self, num_classes: int = 19, backbone: str = "resnet50",
                 hidden_dim: int = 256, num_queries: int = 100, nheads: int = 8,
                 dim_feedforward: int = 2048, dec_layers: int = 9, mask_dim: int = 256,
                 transformer_enc_layers: int = 6, pixel_decoder: str = "msdeformattn",
                 predictor: str = "gma"):
        super().__init__()
        if pixel_decoder not in PIXEL_DECODERS:
            raise ValueError(f"unknown pixel_decoder {pixel_decoder!r}")
        if predictor not in PREDICTORS:
            raise ValueError(f"unknown predictor {predictor!r}")
        self.num_classes = num_classes
        self.backbone, channels = build_backbone(backbone)
        self.pixel_decoder_name = pixel_decoder
        # the JAX MaskFormer leaves the pixel decoders' heads (8) at their default
        if pixel_decoder == "msdeformattn":
            pd = MSDeformAttnPixelDecoder(conv_dim=hidden_dim, mask_dim=mask_dim,
                                          transformer_enc_layers=transformer_enc_layers,
                                          feature_channels=channels)
        elif pixel_decoder == "fpn":
            pd = BasePixelDecoder(channels, conv_dim=hidden_dim, mask_dim=mask_dim)
        else:
            pd = TransformerEncoderPixelDecoder(channels, conv_dim=hidden_dim,
                                                mask_dim=mask_dim,
                                                transformer_enc_layers=transformer_enc_layers)
        self.predictor_name = predictor
        self.sem_seg_head = MaskFormerHead(pd, PREDICTORS[predictor](
            num_classes=num_classes, hidden_dim=hidden_dim, num_queries=num_queries,
            nheads=nheads, dim_feedforward=dim_feedforward, dec_layers=dec_layers,
            mask_dim=mask_dim))

    def draw_drop_path_masks(self, batch: int, generator: Optional[torch.Generator],
                             device) -> Optional[torch.Tensor]:
        """The backbone's drop-path keep masks for one training forward
        (Swin's; None for a ResNet, which has no stochastic depth)."""
        if isinstance(self.backbone, SwinTransformer):
            return self.backbone.draw_drop_path_masks(batch, generator, device)
        return None

    def forward(self, images: torch.Tensor,
                deform_sample_mode: Union[str, Sequence[str]] = "bilinear",
                quantize_deform_table: bool = False,
                drop_path_masks: Optional[torch.Tensor] = None) -> Dict[str, object]:
        """images: [N, H, W, 3], normalised; padded to /32 (:func:`preprocess`) for
        evaluation, or the unpadded crops of the instance trainer.
        ``deform_sample_mode``: a sample mode of ``ops.ms_deform_attn``
        (``bilinear``, exact, by default), or one per encoder layer;
        ``quantize_deform_table``: the int8 value table (``bilinear`` layers;
        one scale over the batch, as JAX's model); both for the
        ``msdeformattn`` pixel decoder. ``drop_path_masks``: a Swin backbone's
        keep masks in training (:meth:`draw_drop_path_masks`)."""
        deformable = self.pixel_decoder_name == "msdeformattn"
        if not deformable and (deform_sample_mode != "bilinear" or quantize_deform_table):
            raise ValueError(f"the {self.pixel_decoder_name} pixel decoder has no "
                             "deformable attention to sample")
        x = images.permute(0, 3, 1, 2).to(next(self.backbone.parameters()).dtype)
        if isinstance(self.backbone, SwinTransformer):
            feats = self.backbone(x, drop_path_masks)
        else:
            feats = self.backbone(x)
        pd = self.sem_seg_head.pixel_decoder
        if deformable:
            mask_features, encoder_feat, multi_scale = pd(feats, deform_sample_mode,
                                                          quantize_deform_table)
        else:
            mask_features, encoder_feat, multi_scale = pd(feats)
        if self.predictor_name == "standard":
            return self.sem_seg_head.predictor(encoder_feat, mask_features)
        return self.sem_seg_head.predictor(multi_scale, mask_features)


def maskformer_from_config(m) -> "MaskFormer":
    """The MaskFormer of a recipe's ``model.m2f`` section (``M2FModelConfig``),
    as both trainers build it: ``dec_layers - 1`` decoder layers (the config
    counts the learnable-query prediction), the configured backbone, pixel
    decoder and predictor (``transformer_decoder``)."""
    return MaskFormer(num_classes=m.num_classes, backbone=m.backbone, hidden_dim=m.hidden_dim,
                      num_queries=m.num_queries, nheads=m.nheads,
                      dim_feedforward=m.dim_feedforward, dec_layers=m.dec_layers - 1,
                      mask_dim=m.mask_dim, transformer_enc_layers=m.transformer_enc_layers,
                      pixel_decoder=m.pixel_decoder, predictor=m.transformer_decoder)


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
              score_topq: int = 0, _classes_only: bool = False,
              rows: Optional[Tuple[int, int]] = None
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
    raises ``ValueError``. ``rows = (row0, count)``: those rows of both
    outputs alone, with the whole image's coordinates (a slab of the
    row-partitioned eval, ``core/spatial.py``).
    """
    if score_lowres and score_topq:
        raise ValueError("score_lowres and score_topq are exclusive; set one")
    if "pred_logits_ood" not in outputs:
        raise ValueError("inference scores anomalies with the GMA decoder's OOD head; "
                         "the vanilla decoder has none")
    sem = semantic_inference_upsampled(outputs["pred_logits"], outputs["pred_masks"],
                                       image_hw, num_classes, _classes_only=_classes_only,
                                       rows=rows)
    cls, masks = outputs["pred_logits_ood"], outputs["pred_masks_ood"]
    if score_topq:
        anomaly = anomaly_score_topq(cls, masks, image_hw, score_topq, rows=rows)
    elif score_lowres:
        anomaly = anomaly_score_lowres(cls, masks, image_hw, rows=rows)
    else:
        anomaly = anomaly_score_upsampled(cls, masks, image_hw, rows=rows)
    return sem, anomaly
