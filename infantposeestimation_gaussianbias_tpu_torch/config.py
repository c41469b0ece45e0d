"""Unified typed configuration, the port's own copy.

The same dataclass tree, defaults, named variants and YAML / dotted-path
override helpers as infantposeestimation_gaussianbias_tpu/config.py, kept
here so that the port imports nothing of the JAX package
(tests/test_torch_config.py holds the two equal, variant by variant).
Some fields (mesh layout, native loader, compile cache) configure parts of
the JAX package that the port has not taken over yet; they stay so that
one YAML file configures both packages.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .schemas import KeypointSchema, get_schema


@dataclass
class DataConfig:
    """Dataset + augmentation config (ref configs/config.py:16-43 and
    config.py DATA section)."""

    data_root: str = "data/coco/"
    train_ann: str = "annotations/person_keypoints_train2017.json"
    val_ann: str = "annotations/person_keypoints_val2017.json"
    train_img_prefix: str = "train2017/"
    val_img_prefix: str = "val2017/"

    # (width, height) like the reference (configs/config.py:25-28).
    input_size: Tuple[int, int] = (192, 256)
    heatmap_size: Tuple[int, int] = (48, 64)

    schema: str = "coco17"
    sigma: float = 2.0
    # bbox -> center/scale padding factor (ref datasets/coco_dataset.py).
    bbox_padding: float = 1.25

    # Augmentation (ref configs/config.py:102-106 + data/pose_transforms.py).
    flip_prob: float = 0.5
    vertical_flip_prob: float = 0.0
    half_body_prob: float = 0.3
    half_body_min_keypoints: int = 8
    rotation_factor: float = 40.0
    rotation_prob: float = 0.6
    scale_factor: Tuple[float, float] = (0.5, 1.5)
    shift_factor: float = 0.0  # Stack-B RandomBBoxTransform adds shift 0.16.
    shift_prob: float = 0.0
    # Photometric jitter (brightness, contrast, saturation), applied
    # on-device inside the fused train step; Stack-B trains with
    # (0.2, 0.2, 0.2) (ref data/coco_dataset.py:54).
    color_jitter: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    # Normalization (ImageNet stats, as the reference).
    pixel_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    pixel_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)

    use_gt_bbox: bool = True

    # Host loader: "auto" uses the native C++ fused JPEG-decode+warp
    # (data/pipeline.py, native/) when buildable, falling back to cv2;
    # "on" requires it; "off" forces the cv2 path.
    native_loader: str = "auto"
    # Training-aug only: DCT-scaled (1/2-1/8) JPEG decode when the crop
    # downsamples >=2x — ~2.3x decode speedup on large frames at the
    # cost of a (better-antialiased, but different) resample.  Val and
    # inference always use the exact decode.
    native_fast: bool = False

    @property
    def num_keypoints(self) -> int:
        return self.keypoint_schema.num_keypoints

    @property
    def keypoint_schema(self) -> KeypointSchema:
        return get_schema(self.schema)


@dataclass
class ModelConfig:
    """Model architecture config (ref configs/config.py:46-75)."""

    backbone: str = "hrnet_w32"  # hrnet_w32|hrnet_w48|hrformer_base|hrformer_small|litehrnet
    pretrained: str = ""
    head_type: str = "heatmap"  # heatmap | fusion | simcc
    hidden_dim: int = 256
    # SimCC head split factor (analysis/hrnet_improvements.py:145-224).
    simcc_split_ratio: float = 2.0
    # Norm layer: batchnorm matches the reference; groupnorm is the
    # sync-free alternative for very large data-parallel meshes.
    norm: str = "batchnorm"
    # Rematerialize exchange modules in the backward pass: trades
    # recompute for activation memory (the port: torch.utils.checkpoint
    # over each HRFormerModule).
    remat: bool = False
    # HRNet modules per exchange stage; empty = reference layout (1, 4, 3)
    # (ref models/hrnet.py:230-441).
    hrnet_stage_modules: Tuple[int, ...] = ()
    # Parameter / activation dtype policy: "float32" or "bfloat16".
    compute_dtype: str = "bfloat16"
    # The JAX package's switch for its Pallas kernels.  In the port the
    # W-MSA kernels (K1/K2) run on the card either way; use_pallas gates
    # the fused half-block kernels (K4/K5), which also need the
    # IPE_FUSED_BLOCK environment variable (models/hrformer.py).
    use_pallas: bool = True
    # HRFormer attention window size.  7 is the reference's value (and
    # the checkpoint-parity default); 8 gives 64-token windows that tile a
    # 64x48 stride-4 map with no padding.  Imported reference checkpoints
    # require 7.
    hrformer_window_size: int = 7
    # Loss selection + the six fusion-loss term weights
    # (ref configs/config.py:63-72).
    use_target_weight: bool = True
    heatmap_loss_weight: float = 1.0
    offset_loss_weight: float = 1.0
    peak_loss_weight: float = 0.5
    variance_loss_weight: float = 0.1
    overlap_loss_weight: float = 0.05
    shape_loss_weight: float = 0.05
    # Stack-B morphology loss weights (ref config.py LOSS section).
    morph_weight: float = 0.1
    morph_lambda: float = 1.0
    morph_mean_lambda: float = 0.5
    reg_weight: float = 0.5
    # Soft-argmax temperature (ref fusion_head.py:37-71 uses beta).
    softargmax_beta: float = 10.0
    # Local Gaussian refinement patch radius (ref fusion_head.py:74-128).
    refine_radius: int = 2


@dataclass
class TrainConfig:
    """Optimization schedule (ref configs/config.py:78-114)."""

    max_epochs: int = 210
    val_interval: int = 10
    global_batch_size: int = 32
    optimizer: str = "adamw"
    lr: float = 5e-4
    weight_decay: float = 0.01
    betas: Tuple[float, float] = (0.9, 0.999)
    momentum: float = 0.9  # for SGD variant
    warmup_epochs: int = 5
    warmup_lr: float = 5e-7
    lr_milestones: Tuple[int, ...] = (170, 200)
    lr_gamma: float = 0.1
    grad_clip_norm: float = 0.0  # 0 disables
    # Split each global batch into N sequential microbatches inside the
    # fused step (lax.scan), averaging gradients before the single
    # optimizer update — large effective batches on memory-limited chips.
    # BN batch-stats update per microbatch (torch grad-accum semantics).
    grad_accum_steps: int = 1
    seed: int = 42
    steps_per_epoch: int = 0  # 0 = derive from dataset size
    checkpoint_dir: str = "checkpoints/"
    save_every: int = 10
    # 'latest' is written every save_latest_interval epochs (the reference
    # writes it every epoch; raise for large models where the async save
    # still costs seconds per epoch).
    save_latest_interval: int = 1
    save_best: str = "AP"
    log_interval: int = 50
    deterministic_data: bool = True
    debug_nans: bool = False


@dataclass
class EvalConfig:
    """Evaluation / test-time config (ref configs/default.yaml TEST/EVAL)."""

    batch_size: int = 32
    flip_test: bool = True
    # The reference's executable flip-test does NOT shift
    # (models/pose_estimator.py:303-319); SHIFT_HEATMAP appears only in the
    # Stack-B YAML surface (configs/default.yaml:77) — flag kept, off by
    # default for parity with the executable path.
    shift_heatmap: bool = False
    # Stack-B fused decode alpha (ref config.py TEST.FUSION_ALPHA).
    fusion_alpha: float = 0.5
    adaptive_fusion: bool = True
    nms_threshold: float = 5.0
    conf_threshold: float = 0.3
    multi_scale: Tuple[float, ...] = (1.0,)
    # Decode method: "taylor" (argmax + Taylor sub-pixel), "quarter"
    # (argmax + 0.25 gradient-sign shift), "softargmax" (fusion decode).
    decode: str = "quarter"
    pck_threshold: float = 0.2


@dataclass
class TemporalConfig:
    """Video / temporal smoothing config (ref configs/default.yaml TEMPORAL)."""

    enabled: bool = False
    window_size: int = 5
    method: str = "gaussian"  # gaussian | moving_average | one_euro
    gaussian_sigma: float = 1.0


@dataclass
class ClinicalConfig:
    """Infant clinical analysis config (ref configs/default.yaml CLINICAL)."""

    enabled: bool = False
    asymmetry_threshold: float = 0.3
    low_activity_threshold: float = 5.0
    fps: float = 30.0


@dataclass
class ParallelConfig:
    """Device mesh layout of the JAX package (the port's multi-GPU layout
    is still to come; the reference is single-device)."""

    # Mesh axis sizes; 0/negative data axis means "use all devices".
    data_axis: int = 0
    model_axis: int = 1
    # Shard model hidden dims over the 'model' axis (demonstration TP).
    tensor_parallel: bool = False
    # Multi-host: the coordinator ("host:port"), process count and id.
    multihost: bool = False
    coordinator: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    temporal: TemporalConfig = field(default_factory=TemporalConfig)
    clinical: ClinicalConfig = field(default_factory=ClinicalConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    exp_name: str = "hrnet_w32_coco_256x192"
    output_dir: str = "outputs/"
    log_dir: str = "logs/"
    # The JAX package's persistent compilation cache ("" disables).
    compile_cache: str = "~/.cache/ipe_tpu/jax"


# ---------------------------------------------------------------------------
# dict / YAML round-trip
# ---------------------------------------------------------------------------

def to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        return {f.name: to_dict(getattr(cfg, f.name))
                for f in dataclasses.fields(cfg)}
    if isinstance(cfg, tuple):
        return [to_dict(v) for v in cfg]
    if isinstance(cfg, list):
        return [to_dict(v) for v in cfg]
    return cfg


def _coerce(value: Any, target: Any) -> Any:
    """Coerce a YAML/CLI value to the type of the current field value."""
    if isinstance(target, bool):
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(target, tuple):
        if isinstance(value, str):
            value = [v for v in value.replace(",", " ").split() if v]
        elem = target[0] if target else None
        if elem is None:
            # Empty-tuple default: infer int, then float, else keep string.
            def infer(v):
                for cast in (int, float):
                    try:
                        return cast(v)
                    except (TypeError, ValueError):
                        pass
                return v
            return tuple(infer(v) for v in value)
        return tuple(_coerce(v, elem) for v in value)
    if isinstance(target, float) and value is not None:
        return float(value)
    if isinstance(target, int) and not isinstance(value, bool) and value is not None:
        return int(value)
    return value


def merge_dict(cfg: Any, overrides: Dict[str, Any]) -> None:
    """Recursively merge a plain dict into a dataclass tree, in place."""
    names = {f.name for f in dataclasses.fields(cfg)}
    for key, value in overrides.items():
        key = key.lower()
        if key not in names:
            raise KeyError(f"Unknown config key {key!r} in {type(cfg).__name__}")
        current = getattr(cfg, key)
        if dataclasses.is_dataclass(current):
            if not isinstance(value, dict):
                raise TypeError(f"Expected mapping for config section {key!r}")
            merge_dict(current, value)
        else:
            setattr(cfg, key, _coerce(value, current))


def set_by_path(cfg: Config, path: str, value: Any) -> None:
    """Apply a dotted-path override, e.g. 'train.lr=1e-3'."""
    parts = path.split(".")
    node = cfg
    for p in parts[:-1]:
        node = getattr(node, p)
    current = getattr(node, parts[-1])
    if dataclasses.is_dataclass(current):
        raise TypeError(f"{path} refers to a config section, not a field")
    setattr(node, parts[-1], _coerce(value, current))


def load_yaml(path: str, base: Optional[Config] = None) -> Config:
    import yaml

    cfg = base if base is not None else Config()
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    merge_dict(cfg, raw)
    return cfg


def save_yaml(cfg: Config, path: str) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(to_dict(cfg), f, sort_keys=False)


def apply_overrides(cfg: Config, overrides: List[str]) -> Config:
    """Apply 'a.b.c=value' CLI override strings."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"Override {item!r} is not of the form key=value")
        path, value = item.split("=", 1)
        set_by_path(cfg, path.strip(), value.strip())
    return cfg


# ---------------------------------------------------------------------------
# Named variants (the reference's config.py:135-224 and
# configs/config.py:128-130)
# ---------------------------------------------------------------------------

def get_config() -> Config:
    return Config()


def get_hrnet_w32_config() -> Config:
    cfg = Config()
    cfg.model.backbone = "hrnet_w32"
    cfg.exp_name = "hrnet_w32_coco_256x192"
    return cfg


def get_hrnet_w48_config() -> Config:
    cfg = Config()
    cfg.model.backbone = "hrnet_w48"
    cfg.train.global_batch_size = 24
    cfg.exp_name = "hrnet_w48_coco_256x192"
    return cfg


def get_hrformer_base_config() -> Config:
    cfg = Config()
    cfg.model.backbone = "hrformer_base"
    cfg.model.head_type = "fusion"
    cfg.exp_name = "hrformer_base_coco_256x192"
    return cfg


def get_hrformer_small_config() -> Config:
    cfg = Config()
    cfg.model.backbone = "hrformer_small"
    cfg.model.head_type = "fusion"
    cfg.exp_name = "hrformer_small_coco_256x192"
    return cfg


def get_hrnet_w48_384_config() -> Config:
    """High-res W48 config (ref README.md:229: HRNet-W48 384x288,
    AP 76.3)."""
    cfg = get_hrnet_w48_config()
    cfg.data.input_size = (288, 384)
    cfg.data.heatmap_size = (72, 96)
    cfg.train.global_batch_size = 16
    cfg.exp_name = "hrnet_w48_coco_384x288"
    return cfg


def get_hrformer_base_384_config() -> Config:
    """High-res HRFormer-Base config (ref README.md:227: 384x288,
    AP 77.2)."""
    cfg = get_hrformer_base_config()
    cfg.data.input_size = (288, 384)
    cfg.data.heatmap_size = (72, 96)
    cfg.train.global_batch_size = 16
    cfg.exp_name = "hrformer_base_coco_384x288"
    return cfg


def get_lightweight_config() -> Config:
    """Fast-inference variant (ref config.py:187-198)."""
    cfg = Config()
    cfg.model.backbone = "litehrnet"
    cfg.data.input_size = (192, 192)
    cfg.data.heatmap_size = (48, 48)
    cfg.train.global_batch_size = 64
    cfg.train.lr = 2e-3
    cfg.exp_name = "litehrnet_192x192"
    return cfg


def get_preemie_config() -> Config:
    """Preterm-infant variant (ref config.py:203-224): 13 joints, smaller
    sigma, higher-res heatmaps, stronger morphology loss, gentler aug."""
    cfg = Config()
    cfg.data.schema = "infant13"
    cfg.data.input_size = (256, 256)
    cfg.data.heatmap_size = (128, 128)
    cfg.data.sigma = 1.5
    cfg.data.rotation_factor = 15.0
    cfg.data.scale_factor = (0.85, 1.15)
    # Stack-B trains with ColorJitter(0.2, 0.2, 0.2)
    # (ref data/coco_dataset.py:54).
    cfg.data.color_jitter = (0.2, 0.2, 0.2)
    cfg.model.morph_weight = 0.15
    cfg.model.morph_lambda = 1.2
    cfg.eval.fusion_alpha = 0.4
    cfg.temporal.enabled = True
    cfg.clinical.enabled = True
    cfg.exp_name = "preemie_hrnet_w32_256x256"
    return cfg


VARIANTS = {
    "default": get_config,
    "hrnet_w32": get_hrnet_w32_config,
    "hrnet_w48": get_hrnet_w48_config,
    "hrnet_w48_384": get_hrnet_w48_384_config,
    "hrformer_base": get_hrformer_base_config,
    "hrformer_base_384": get_hrformer_base_384_config,
    "hrformer_small": get_hrformer_small_config,
    "lightweight": get_lightweight_config,
    "preemie": get_preemie_config,
}


def get_variant(name: str) -> Config:
    try:
        return VARIANTS[name]()
    except KeyError:
        raise KeyError(f"Unknown config variant {name!r}; known: {sorted(VARIANTS)}") from None
