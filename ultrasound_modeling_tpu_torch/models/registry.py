"""Model zoo keyed by config name (PyTorch port of ``models/registry.py``).

Takes the port's ``ModelConfig`` (``config.py``, a copy of the JAX
package's) and builds each of the five families.
"""

from __future__ import annotations

import torch

from ultrasound_modeling_tpu_torch.config import ModelConfig

_DTYPES = {"float32": torch.float32, "f32": torch.float32,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def _attn_impl(impl: str) -> str:
    """JAX attn_impl -> the port's: 'auto'/'pallas' take the kernels (which
    run their plain versions on CPU tensors), 'xla' the composed path."""
    if impl in ("auto", "pallas"):
        return "kernel"
    if impl == "xla":
        return "composed"
    raise ValueError(f"unknown attn_impl {impl!r}")


def _attn_train_impl(impl: str) -> str:
    """JAX attn_train_impl -> the port's.  'auto' resolves off the TPU (the
    card included) to the composed path, as ``resolve_attn_train_impl``
    does; 'flash' is K3, 'pallas' K5."""
    if impl in ("auto", "xla"):
        return "composed"
    if impl in ("flash", "pallas"):
        return impl
    raise ValueError(f"unknown attn_train_impl {impl!r}")


def build_model(cfg: ModelConfig) -> torch.nn.Module:
    name = cfg.name
    if name in ("transunet", "vit") and cfg.dropout_rate:
        raise NotImplementedError(
            f"dropout_rate={cfg.dropout_rate} is not ported yet (the "
            f"default configs train without dropout): ROADMAP, \"Knobs the "
            f"port refuses\"")
    if name == "vit":
        from ultrasound_modeling_tpu_torch.models.vit import ViTSegmenter
        return ViTSegmenter(
            num_classes=cfg.num_classes, hidden_size=cfg.vit_hidden,
            num_heads=cfg.vit_heads, num_layers=cfg.vit_layers,
            grid=tuple(cfg.vit_grid), img_size=tuple(cfg.img_size),
            mlp_dim=cfg.mlp_dim, in_channels=cfg.in_channels,
            learned_pos=cfg.vit_learned_pos, conv_stem=cfg.vit_conv_stem,
            attn_impl=_attn_impl(cfg.attn_impl),
            attn_train_impl=_attn_train_impl(cfg.attn_train_impl),
            compute_dtype=_DTYPES[cfg.compute_dtype])
    if name == "transunet":
        from ultrasound_modeling_tpu_torch.models.transunet import TransUNet
        return TransUNet(
            num_classes=cfg.num_classes, hidden_size=cfg.hidden_size,
            num_heads=cfg.num_heads, num_layers=cfg.num_layers,
            mlp_dim=cfg.mlp_dim, grid=tuple(cfg.grid), radix=cfg.radix,
            kpaths=cfg.kpaths, ksize=cfg.ksize, in_channels=cfg.in_channels,
            attn_impl=_attn_impl(cfg.attn_impl),
            attn_train_impl=_attn_train_impl(cfg.attn_train_impl),
            compute_dtype=_DTYPES[cfg.compute_dtype])
    if name == "swin":
        # the JAX Swin has no dropout and no train-attention choice: its
        # attn_impl drives eval and train alike
        from ultrasound_modeling_tpu_torch.models.swin import SwinSegmenter
        return SwinSegmenter(
            num_classes=cfg.num_classes, img_size=tuple(cfg.img_size),
            in_channels=cfg.in_channels, embed_dim=cfg.swin_embed_dim,
            depths=tuple(cfg.swin_depths), num_heads=tuple(cfg.swin_heads),
            window=tuple(cfg.window), drop_path_rate=cfg.drop_path_rate,
            attn_impl=_attn_impl(cfg.swin_attn_impl),
            compute_dtype=_DTYPES[cfg.compute_dtype])
    # the two U-Nets' dropout is fixed by their architecture (0.5 in the
    # first decoder stages); cfg.dropout_rate does not reach it, as in JAX
    if name == "resnest_unet":
        from ultrasound_modeling_tpu_torch.models.resnest import ResNeStUNet
        return ResNeStUNet(
            num_classes=cfg.num_classes, ksize=cfg.ksize, radix=cfg.radix,
            kpaths=cfg.kpaths, in_channels=cfg.in_channels,
            compute_dtype=_DTYPES[cfg.compute_dtype])
    if name == "mobileunet":
        from ultrasound_modeling_tpu_torch.models.mobileunet import MobileUNet
        return MobileUNet(num_classes=cfg.num_classes,
                          in_channels=cfg.in_channels,
                          compute_dtype=_DTYPES[cfg.compute_dtype])
    raise KeyError(f"unknown model {name!r}")
