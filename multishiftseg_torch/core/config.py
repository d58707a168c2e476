"""Typed configuration tree with YAML overlay.

The port's own copy of ``multishiftseg_tpu/core/config.py`` (the port imports
nothing of the JAX package): the same dataclass tree, defaults and knob names,
so the experiment YAMLs under ``exps/`` (``exps/m2f.yaml``, ...) load unchanged.
It collapses the reference's dual config system (EasyDict defaults + YAML overlay
in ``lib/configs/config.py:8-103`` and the detectron2 CfgNode extension in
``lib/network/mask2former/config.py:6-121``) into one dataclass tree.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import yaml


@dataclass
class DataConfig:
    # Mirrors reference lib/configs/config.py:19-29.
    train_ds: str = ""
    val_ds: str = ""
    class_num: int = 19
    in_channels: int = 3
    crop_size: Tuple[int, int] = (700, 700)
    num_workers: int = 8
    mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    anomaly_mix: bool = True
    mixup: bool = True
    # dataset roots (reference hardcodes these in lib/dataset/cityscapes.py:84-88)
    cityscapes_root: str = "./datasets/cityscapes"
    generation_root: str = "./datasets/DTWP_ADE_final"
    coco_root: str = "./datasets/coco/coco2017"
    road_anomaly_root: str = "./datasets/road_anomaly"
    anomaly_track_root: str = "./datasets/dataset_AnomalyTrack"
    obstacle_track_root: str = "./datasets/dataset_ObstacleTrack"
    muad_root: str = "./datasets/MUAD_challenge/test_sets/test_OOD"
    acdc_root: str = "./datasets/acdc_ood/"
    generated_subdir_names: Tuple[str, ...] = ("DTWP_ADE_final",)


@dataclass
class M2FModelConfig:
    """Mask2Former/Mask2Anomaly model hyper-parameters.

    Flattens the subset of detectron2 keys that the reference's shipped config
    (``configs/mask2former-cityscapes/semantic-segmentation/anomaly_ft.yaml``) actually
    exercises.
    """

    backbone: str = "resnet50"  # resnet{18,34,50,101,152} | swin_{tiny,small,base,large}
    freeze_at: int = 5  # MODEL.BACKBONE.FREEZE_AT
    pixel_mean: Tuple[float, float, float] = (123.675, 116.280, 103.530)
    pixel_std: Tuple[float, float, float] = (58.395, 57.120, 57.375)
    num_classes: int = 19
    # pixel decoder (SEM_SEG_HEAD.*)
    convs_dim: int = 256
    mask_dim: int = 256
    norm: str = "GN"
    transformer_enc_layers: int = 6
    common_stride: int = 4
    in_features: Tuple[str, ...] = ("res2", "res3", "res4", "res5")
    transformer_in_features: Tuple[str, ...] = ("res3", "res4", "res5")
    # transformer decoder (MASK_FORMER.*)
    hidden_dim: int = 256
    num_queries: int = 100
    nheads: int = 8
    dim_feedforward: int = 2048
    dec_layers: int = 10  # 9 decoder layers + 1 for learnable-query loss
    pre_norm: bool = False
    enforce_input_proj: bool = False
    size_divisibility: int = 32
    dropout: float = 0.0
    # loss (MASK_FORMER.*)
    deep_supervision: bool = True
    no_object_weight: float = 0.1
    class_weight: float = 2.0
    mask_weight: float = 5.0
    dice_weight: float = 5.0
    ood_weight: float = 1.0
    train_num_points: int = 12544
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.75
    # registry selections (MASK_FORMER.TRANSFORMER_DECODER_NAME /
    # SEM_SEG_HEAD.PIXEL_DECODER_NAME): gma = MultiScaleMaskedTransformerDecoder_GMA,
    # vanilla = MultiScaleMaskedTransformerDecoder, standard = StandardTransformerDecoder
    transformer_decoder: str = "gma"
    pixel_decoder: str = "msdeformattn"  # msdeformattn | fpn | transformer_encoder
    # test-time task switches (MASK_FORMER.TEST.*)
    semantic_on: bool = True
    instance_on: bool = False
    panoptic_on: bool = False
    # static padded per-image segment count for the instance/panoptic trainer
    # (TPU static-shape knob; the torch reference keeps dynamic shapes)
    max_instances: int = 48
    ood_finetune: bool = True
    ood_loss: str = "margin"  # margin | bce | RCL
    margin: float = 1.0
    anomaly_mix_ratio: float = 0.2
    # inference
    object_mask_threshold: float = 0.8
    overlap_threshold: float = 0.8
    min_size_test: int = 1024
    max_size_test: int = 2048
    # solver (SOLVER.*) for stage-2 official optimizer
    base_lr: float = 1e-5
    weight_decay: float = 0.05
    weight_decay_norm: float = 0.0
    weight_decay_embed: float = 0.0
    backbone_multiplier: float = 0.1
    clip_gradients_value: float = 0.01


@dataclass
class Mask2AnomalySwitches:
    # Mirrors reference lib/configs/config.py:39-47.
    use_official_loss: bool = False
    use_official_optimizer: bool = False
    use_official_params: bool = False
    use_official_train_mode: bool = False
    replace_official_odd_loss_with_RCL: bool = False
    deep_supervision: bool = False
    odd_weight: float = 1.0
    mask_loss_with_pixel_selection: bool = True


@dataclass
class ModelConfig:
    weight_path: Optional[str] = None
    backbone: str = "WideResNet38"
    trainable_params_name: Tuple[str, ...] = (".",)
    trainable_params_name_update: Optional[Tuple[str, ...]] = None
    mask2anomaly: Mask2AnomalySwitches = field(default_factory=Mask2AnomalySwitches)
    m2f: M2FModelConfig = field(default_factory=M2FModelConfig)


@dataclass
class TrainConfig:
    # Mirrors reference lib/configs/config.py:50-62.
    n_epochs: int = 100
    train_batch: int = 32
    valid_batch: int = 32
    test_batch: int = 1
    optimizer: str = "Adam"
    lr: float = 1e-2
    lr_update: Optional[float] = None
    momentum: float = 0.9
    weight_decay: float = 1e-4
    warmup_epoch: int = -1
    # TPU-native additions
    bf16: bool = True
    seed: int = 0
    num_devices: int = 0  # 0 = all local devices
    checkpoint_every: int = 1
    # tensor parallelism: size of the mesh's model axis; kernels whose trailing
    # (channel) dim >= model_parallel_min_size shard over it, and so do their
    # Adam moments / BN stats (core/mesh.py::tensor_parallel_shardings)
    model_parallel: int = 1
    model_parallel_min_size: int = 1024
    # pipeline parallelism (GPipe, core/pipeline.py): size of the mesh's pipe
    # axis. The M2F deformable encoder stack runs stage-sharded over it — each
    # device holds 1/pipe of the stacked encoder_layer_* params (and their
    # Adam moments), microbatches flow stage-to-stage over ICI. Composes with
    # model_parallel (dp x tp x pp mesh). Checkpoints stay in the per-layer
    # named layout on disk (AUPRC_best; converters in core/pipeline.py).
    pipeline_parallel: int = 1
    # microbatches per step for the GPipe schedule; 0 = auto (largest divisor
    # of the per-data-shard batch <= 2 * pipeline_parallel)
    pipeline_microbatches: int = 0


@dataclass
class LossConfig:
    name: str = ""
    params: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Config:
    data_dir: str = ""
    model_dir: str = ""
    log_dir: str = ""
    tb_dir: str = ""
    out_dir: str = ""
    dataset: str = ""
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    loss: LossConfig = field(default_factory=LossConfig)


def _coerce(value: Any, target: Any) -> Any:
    """Coerce a YAML value to the type of the dataclass default it overrides."""
    if isinstance(target, tuple) and isinstance(value, list):
        return tuple(value)
    if isinstance(target, bool) and isinstance(value, (int, bool)):
        return bool(value)
    if isinstance(target, float) and isinstance(value, (int, float)):
        return float(value)
    return value


def _update_dataclass(obj: Any, overrides: Dict[str, Any], path: str = "cfg") -> None:
    """Recursively apply a dict of overrides onto a dataclass tree.

    Unknown keys warn-and-continue (matching the reference's warn-and-add behaviour in
    ``lib/configs/config.py:80-96``) except that unknown keys in a typed node are stored
    on ``loss.params``-style dict fields only; elsewhere they are ignored with a warning.
    """
    import logging

    for key, value in overrides.items():
        if not dataclasses.is_dataclass(obj) and isinstance(obj, dict):
            obj[key] = value
            continue
        if not hasattr(obj, key):
            logging.getLogger(__name__).warning(
                "%s.%s is not in the default config; ignoring", path, key
            )
            continue
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            _update_dataclass(current, value, f"{path}.{key}")
        elif isinstance(current, dict) and isinstance(value, dict):
            current.update(value)
        else:
            setattr(obj, key, _coerce(value, current))


def load_config(yaml_path: Optional[str] = None, exp_id: Optional[str] = None) -> Config:
    """Build a Config from defaults + optional YAML overlay.

    Equivalent to the reference's ``update_config`` + ``default_complete``
    (``lib/configs/config.py:74-103``, ``lib/configs/parse_arg.py:27-35``).
    """
    cfg = Config()
    if yaml_path is not None:
        for overrides in _load_yaml_chain(yaml_path):
            _update_dataclass(cfg, overrides)
    if exp_id:
        if not cfg.model_dir:
            cfg.model_dir = str(pathlib.Path("ckpts") / exp_id)
        if not cfg.log_dir:
            cfg.log_dir = str(pathlib.Path("outputs") / exp_id)
        pathlib.Path(cfg.model_dir).mkdir(parents=True, exist_ok=True)
        pathlib.Path(cfg.log_dir).mkdir(parents=True, exist_ok=True)
        with open(pathlib.Path(cfg.model_dir) / "config.yaml", "w") as f:
            yaml.dump(to_dict(cfg), f)
    if not cfg.data_dir:
        cfg.data_dir = "data"
    return cfg


def _load_yaml_chain(yaml_path: str) -> list:
    """Resolve a ``base:`` include chain (detectron2 ``_BASE_`` role): returns the
    override dicts base-first. Base paths are relative to the including file."""
    with open(yaml_path) as f:
        overrides = yaml.safe_load(f) or {}
    base = overrides.pop("base", None)
    if base is None:
        return [overrides]
    base_path = pathlib.Path(yaml_path).parent / base
    return _load_yaml_chain(str(base_path)) + [overrides]


def to_dict(cfg: Any) -> Dict[str, Any]:
    """Dataclass tree -> plain JSON-serializable dict (for config snapshots)."""
    return json.loads(json.dumps(dataclasses.asdict(cfg), default=list))
