"""Post-training int8 weight-only quantization for serving (PyTorch port of
``infer/quantize.py``).

Kernel weights are stored int8 with a per-output-channel f32 scale and
dequantized on the device inside every forward, so the weights resident on
the device are int8 (the JAX package dequantizes inside its jitted forward).
Activations and the matmuls stay in the model's compute dtype: this is
weight-only (dequantize, then compute), so the accuracy lost is the int8
rounding of the weights alone.

The scales are taken in the flax layout, as the JAX package takes them:
the absmax runs over every axis but the last of the flax leaf.  So the
TransUNet's scan-stacked encoder kernels (``encoder/blocks/block/...``,
``[L, in, out]``) share one scale per output column across their layers,
and the ResNeSt stages' ``[K, R, kh, kw, in, out]`` kernels one per ``out``;
quantizing each torch tensor on its own would give other scales.  Each
forward dequantizes ``q * scale`` in f32 on the device, moves every leaf to
the torch layout there (``utils.checkpoint.bridge_leaf``: the
transposes, flips and the unstacking of the stacked blocks) and runs the model with those tensors
(``torch.func.functional_call``); under a bfloat16 compute dtype the model
casts as it always does.

Usage:
    fwd = make_quantized_forward(model, device)       # x -> probs
    # or through export:  cli export --quantize int8
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ultrasound_modeling_tpu_torch.utils.checkpoint import (
    bridge_leaf, to_flax)

# Leaves smaller than this stay f32: biases, norm scales/offsets, the
# relative-position bias tables — quantizing them saves ~nothing and they
# are precision-critical.
MIN_QUANT_SIZE = 4096


def _is_qleaf(x) -> bool:
    return isinstance(x, dict) and set(x.keys()) == {"q", "scale"}


def _quantize_leaf(w):
    """Symmetric per-output-channel (last axis) int8 quantization."""
    w = np.asarray(w)
    reduce_axes = tuple(range(w.ndim - 1))
    absmax = np.max(np.abs(w), axis=reduce_axes, keepdims=True)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return {"q": q, "scale": scale.astype(np.float32)}


def quantize_params(flat: Dict[str, np.ndarray],
                    min_size: int = MIN_QUANT_SIZE):
    """Quantize every kernel-like leaf (ndim >= 2, size >= min_size) of a
    flax-layout flat dict to {'q': int8, 'scale': f32 per-output-channel};
    other leaves pass through."""

    def visit(leaf):
        arr = np.asarray(leaf)
        if arr.ndim >= 2 and arr.size >= min_size and np.issubdtype(
                arr.dtype, np.floating):
            return _quantize_leaf(arr)
        return leaf

    return {k: visit(v) for k, v in flat.items()}


def quantized_fraction(qflat) -> float:
    """Fraction of parameter scalars stored int8 (coverage diagnostic)."""
    total = quant = 0
    for leaf in qflat.values():
        if _is_qleaf(leaf):
            quant += leaf["q"].size
            total += leaf["q"].size
        else:
            total += np.asarray(leaf).size
    return quant / max(total, 1)


class QuantizedForward(nn.Module):
    """``x -> probs`` of ``model`` (eval mode) with int8-resident weights on
    ``device`` (the model's by default).  Its buffers are all the device
    holds of the weights: each quantized flax leaf's ``q`` (int8) and
    ``scale``, and the other leaves and the model's own buffers as they
    are; ``model`` itself is not a submodule, its tensors stay where they
    are and are never read.  torch.export keeps the buffers, so an exported
    int8 forward carries int8 constants."""

    def __init__(self, model: nn.Module, device: Optional[torch.device] = None):
        super().__init__()
        if device is None:
            device = next(model.parameters()).device
        self.__dict__["model"] = model.eval()
        self.family = model.family
        qflat = quantize_params(to_flax(model.state_dict(), model.family))
        self.fraction = quantized_fraction(qflat)
        self.qkeys = [k for k, v in qflat.items() if _is_qleaf(v)]
        for i, k in enumerate(self.qkeys):
            for name, a in ((f"q{i}", qflat[k]["q"]), (f"s{i}", qflat[k]["scale"])):
                self.register_buffer(name, torch.from_numpy(
                    np.ascontiguousarray(a)).to(device))
        plain = {}
        for k, v in qflat.items():
            if not _is_qleaf(v):
                leaf = torch.from_numpy(np.array(v, np.float32, order="C"))
                for name, t in bridge_leaf(k, leaf, self.family):
                    plain[name] = t.clone(memory_format=torch.contiguous_format)
        # the model's non-persistent buffers (the Swin's index and masks)
        for name, b in model.named_buffers():
            plain.setdefault(name, b)
        self.names = list(plain)
        for i, name in enumerate(self.names):
            self.register_buffer(f"p{i}", plain[name].to(device))

    def resident_bytes(self) -> int:
        return sum(b.numel() * b.element_size() for b in self.buffers())

    def weights(self) -> Dict[str, torch.Tensor]:
        """The model's ``state_dict`` (and non-persistent buffers) on the
        device, the quantized leaves dequantized in f32."""
        out = {name: getattr(self, f"p{i}") for i, name in enumerate(self.names)}
        for i, k in enumerate(self.qkeys):
            w = getattr(self, f"q{i}").float() * getattr(self, f"s{i}")
            for name, t in bridge_leaf(k, w, self.family):
                out[name] = t.contiguous()
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(self.model, self.weights(), (x,))


def make_quantized_forward(model: nn.Module,
                           device: Optional[torch.device] = None):
    """``x -> probs`` with int8-resident weights (eval mode)."""
    qf = QuantizedForward(model, device)

    @torch.no_grad()
    def fwd(x: torch.Tensor) -> torch.Tensor:
        return qf(x)

    return fwd
