"""Typed configuration tree of the port: the dataclasses,
``default_config`` and ``from_toml`` of ``ultrasound_modeling_tpu/config.py``,
copied as they are (stdlib only), so that the port imports nothing of the
JAX package.  ``tests/test_torch_port_isolation.py`` holds every family's
``default_config`` equal to the original, field by field.

The reference keeps its configuration in a dotenv file exposing four path
constants (reference: config.py:8-14) and hardcodes every other knob inline in
each entry-point file (model hyperparameters as constructor defaults, data
paths as string literals, class-count switches — reference: MainNumpy.py:151-161,
VisionTransformer.py:193).  Here everything lives in one dataclass tree with
environment-variable overrides for the paths, and the model zoo is selected by
a config key.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple


def _env_path(name: str, default: str) -> str:
    return os.environ.get(name, default)


@dataclasses.dataclass(frozen=True)
class Paths:
    """Filesystem layout (reference: config.py:8-14, loaded from .env)."""

    raw_data: str = dataclasses.field(
        default_factory=lambda: _env_path("RAW_DATA_PATH", "data/raw"))
    processed_numpy: str = dataclasses.field(
        default_factory=lambda: _env_path("PROCESSED_NUMPY_PATH", "data/processed"))
    trained_models: str = dataclasses.field(
        default_factory=lambda: _env_path("TRAINED_MODELS_PATH", "data/models"))
    inference: str = dataclasses.field(
        default_factory=lambda: _env_path("INFERENCE_PATH", "data/inference"))

    def dataset_dir(self, objective: str) -> str:
        """'brainMask' or 'bleed' subdirectory (reference: DataFilePlayGround.py:252-255)."""
        return os.path.join(self.processed_numpy, objective)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset geometry and semantics.

    The ETL emits per-sample ``[256, 80, 12]`` = concat(label[1],
    displacement real[5] + imag[5], bMode[1]) wrapped in an extra list dim so
    files are ``[N, 1, 256, 80, 12]`` (reference: DataFilePlayGround.py:393,
    Dataset_2.py:31-43 strips it).
    """

    height: int = 256
    width: int = 80
    channels: int = 10          # displacement channels fed to the model
    num_classes: int = 3        # {0: outside brain, 1: brain, 2: bleed}
    # Augmentation toggles (reference: DataAugs.py:82-102 composition).
    augment: bool = True
    aug_flip: bool = False      # monolith variant enables fliplr (TBI_TransUNet.py:840-842)
    # Bad-patient exclusion list kept as config (reference: DataFilePlayGround.py:278-279).
    bad_patients: Tuple[int, ...] = (
        1, 14, 22, 23, 27, 28, 32, 34, 35, 36, 37, 38, 39, 44, 49, 69, 71, 78,
        82, 90, 98, 101, 121, 124, 128, 133, 136, 928)
    iph_patients: Tuple[int, ...] = (
        8, 9, 10, 12, 22, 47, 53, 62, 66, 67, 69, 74, 75, 78, 85, 89, 93, 101,
        105, 107, 110, 112, 113, 120, 121, 126, 129, 130, 133)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model-zoo entry.  ``name`` selects the family from models.registry."""

    name: str = "transunet"
    img_size: Tuple[int, int] = (256, 80)
    in_channels: int = 10
    num_classes: int = 3
    # ResNeSt constants (reference: VisionTransformer.py:100, TBI_ResNest.py:461).
    radix: int = 3
    kpaths: int = 3
    ksize: int = 3
    # TransUNet transformer constants (reference: VisionTransformer.py:10,61,154).
    hidden_size: int = 512
    num_heads: int = 4
    num_layers: int = 8
    mlp_dim: int = 2048
    grid: Tuple[int, int] = (16, 5)
    # Pure-ViT constants (reference: TBI_Transformer.py:17,94-96,150).
    vit_hidden: int = 1280
    vit_heads: int = 8
    vit_layers: int = 8
    vit_grid: Tuple[int, int] = (16, 10)
    # Parity default False: the reference's pos embeddings are constant
    # zeros (TBI_Transformer.py:106).  True = learnable (standard ViT).
    vit_learned_pos: bool = False
    vit_conv_stem: bool = False  # framework extension; see models/vit.py
    # Swin constants (reference: SwinTransformer.py:8-21,163).
    window: Tuple[int, int] = (4, 5)
    swin_embed_dim: int = 96
    swin_depths: Tuple[int, ...] = (2, 2, 6, 2)
    swin_heads: Tuple[int, ...] = (3, 6, 12, 24)
    # 'auto' = fused Pallas kernel on TPU (29% model speedup), XLA elsewhere.
    swin_attn_impl: str = "auto"  # 'auto' | 'xla' | 'pallas'
    # Global-attention impl for transunet/vit ('auto' | 'xla' | 'pallas').
    attn_impl: str = "auto"
    # TRAIN-path attention kernel for transunet/vit ('xla' | 'pallas' |
    # 'flash' | 'auto'): 'pallas' = fused forward that saves qkv/context/
    # probs for a hand-written bf16 backward (ops/pallas_kernels
    # .attention_train_fused; measured -11.2% on vit — saved-tensor
    # relayouts); 'flash' = LSE-only-saving attention core with a Pallas
    # backward (ops/pallas_kernels.flash_mha).  Default 'xla' (composed
    # autodiff) pending each variant's measured A/B.
    attn_train_impl: str = "xla"
    drop_path_rate: float = 0.1
    dropout_rate: float = 0.0
    # Numerics: compute dtype for the forward pass; params stay f32.
    compute_dtype: str = "float32"
    # Rematerialize transformer blocks in the backward pass (memory-bound
    # big-batch training).
    remat: bool = False
    # Rematerialize the conv stages (ResNeSt split-attention stages +
    # decoder blocks): the train step is HBM-bandwidth-bound (~11% MXU,
    # BASELINE.md), so recomputing stage forwards instead of persisting
    # their intermediates trades idle MXU FLOPs for HBM bytes.
    remat_conv: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization semantics (reference: VisionTransformer.py:204,235-245,
    MainNumpy.py:83-88, TBI_ResNest.py:382-412)."""

    batch_size: int = 32
    epochs: int = 50
    learning_rate: float = 1e-2
    # PiecewiseConstantDecay boundaries/scales (reference: MainNumpy.py:83-88).
    lr_boundaries: Tuple[int, ...] = (2000, 4000, 8000, 10000, 15000)
    lr_values: Tuple[float, ...] = (1.0, 0.3, 0.1, 0.03, 0.01, 0.003)
    # Decoupled weight decay (AdamW-style, scaled by the runtime lr so it
    # follows the piecewise schedule — the reference's scheduled wd lambda,
    # MainNumpy.py:87-88).  Default 0: the reference's AdamW import is
    # commented out, so its effective optimizer is plain Adam.
    weight_decay: float = 0.0
    clip_global_norm: float = 1.0     # reference: VisionTransformer.py:244
    # Adam first-moment storage dtype (None = f32).  "bfloat16" halves the
    # mu state (checkpoint/HBM capacity); measured latency-NEUTRAL on the
    # train step (state traffic is <1% of its HBM bytes — BASELINE round-4
    # harvest A/Bs).  The second moment stays f32 (it sits under a sqrt in
    # the update, where bf16's 8-bit mantissa would inject ~4e-3 relative
    # denominator noise).
    adam_mu_dtype: Optional[str] = None
    loss: str = "cce_smooth"          # cce_smooth | class_balanced | factor_scaled
    # Optional per-class scale override for the factor-family losses
    # (factor_scaled / pixelcnn / evaluator); None keeps the reference
    # constants.
    class_factor: Optional[Tuple[float, ...]] = None
    label_smoothing: float = 0.1
    eval_every_epochs: int = 5        # reference: MainNumpy.py:80
    # Reactive plateau decay (reference: TBI_ResNest.py:407-412).
    plateau_decay: float = 0.2
    lr_floor: float = 1e-5            # stop when lr < floor (TBI_ResNest.py:391)
    l2_regularization: float = 0.0    # ViT uses 1e-5 (TBI_Transformer.py:11)
    seed: int = 0
    # Run whole epochs as one lax.scan'd device program (zero per-step host
    # dispatch; lr held constant within an epoch, matching the reference's
    # per-epoch schedule reassignment — MainNumpy.py:83-88).
    scan_epochs: bool = False
    log_every: int = 100
    image_every: int = 491            # reference: MainNumpy.py:54
    image_every_eval: int = 23        # reference: MainNumpy.py:108-113
    checkpoint_every_steps: int = 1000
    max_checkpoints_to_keep: int = 3  # reference: TBI_ResNest.py:65


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh axes.  The reference is data-parallel only
    (MirroredStrategy — reference: MainParallel.py:16); ``data`` is the live
    axis; ``model`` is reserved for tensor-parallel extensions."""

    data: int = -1   # -1 = all available devices
    model: int = 1

    def axis_sizes(self, n_devices: int) -> Tuple[int, int]:
        d = self.data if self.data > 0 else max(1, n_devices // self.model)
        return d, self.model


@dataclasses.dataclass(frozen=True)
class Config:
    paths: Paths = dataclasses.field(default_factory=Paths)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def from_toml(path: str) -> Config:
    """Load a config tree from TOML: top-level tables ``paths/data/model/
    train/mesh``; missing keys keep their defaults (the reference's dotenv
    covers only the four paths — reference: config.py:8-14)."""
    import tomllib
    with open(path, "rb") as fh:
        raw = tomllib.load(fh)
    # Seed the base from the named family's defaults so a TOML that only
    # says `[model] name="mobileunet"` still gets that family's geometry /
    # loss / optimizer (in_channels 15, 256x64, pixelcnn loss, ...); the
    # TOML keys then override on top.
    family = raw.get("model", {}).get("name", "transunet")
    defaults = default_config(family)
    sections = {}
    for name, base in (("paths", defaults.paths), ("data", defaults.data),
                       ("model", defaults.model), ("train", defaults.train),
                       ("mesh", defaults.mesh)):
        if name in raw:
            clean = {k: tuple(v) if isinstance(v, list) else v
                     for k, v in raw[name].items()}
            base = dataclasses.replace(base, **clean)
        sections[name] = base
    return Config(**sections)


def default_config(model_name: str = "transunet", **overrides) -> Config:
    """Build a config for a model-zoo entry with per-family defaults."""
    model = ModelConfig(name=model_name)
    train = TrainConfig()
    if model_name == "resnest_unet":
        # Standalone ResNeSt U-Net defaults (reference: TBI_ResNest.py:455-470).
        # Geometry: the 6-pool U-Net needs /64-divisible dims; the reference
        # trains it on the 256x64x6 reshaped dataset (TBI_ResNest.py:267-270).
        model = dataclasses.replace(model, img_size=(256, 64), in_channels=6)
        train = dataclasses.replace(
            train, batch_size=64, learning_rate=5e-3, loss="class_balanced",
            eval_every_epochs=3, epochs=46)
    elif model_name == "vit":
        # attn_train_impl 'auto' -> the flash (LSE-saving) train attention
        # on TPU: measured +24.6% (b128) / +16.7% (b64) full-step win for
        # the 160-token pure ViT (BASELINE.md round 5); transunet stays
        # 'xla' (measured neutral, -0.1%/-0.6% — conv-dominated step).
        model = dataclasses.replace(model, attn_train_impl="auto")
        train = dataclasses.replace(train, batch_size=8, learning_rate=1e-3,
                                    l2_regularization=1e-5)
    elif model_name == "swin":
        # The reference ships the Swin backbone without a trainer
        # (SwinTransformer.py); 1e-2 (the TransUNet schedule) diverges —
        # use the conventional Swin fine-tune rate.
        train = dataclasses.replace(train, learning_rate=1e-3)
    elif model_name == "mobileunet":
        # 15-channel 256x64 variant (reference: TBIPixelCNN.py:15,21);
        # dual Adam 2e-3/2e-4 beta1=0.5 (reference: TBIPixelCNN.py:256-257).
        model = dataclasses.replace(model, img_size=(256, 64), in_channels=15)
        # per-class inverse-frequency + factor loss — the PixelCNN's own
        # my_loss_cat (reference: TBIPixelCNN.py:223-240), not the
        # TransUNet-family factor_scaled variant.
        train = dataclasses.replace(
            train, batch_size=256, learning_rate=2e-3, loss="pixelcnn",
            epochs=30)
    cfg = Config(model=model, train=train)
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg
