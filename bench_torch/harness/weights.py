"""Seeded weights for a model, made on the device in two large draws (one
normal, one uniform) and cut into leaves, so that the program and the
reference load the same numbers from the same seed and neither makes them.

Per leaf, by the layer it belongs to: conv, transposed-conv, dense and
split-attention kernels He-normal over their fan-in, the attention's query
and key projections too, so that its scores are of order one and the
softmax weighs the keys unevenly; norm scales 1 + 0.1 N;
BatchNorm running variances U[0.5, 1.5]; biases, running means and the
relative-position tables 0.1 N.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch import nn

from reference.layers import Conv, ConvTranspose, Linear

def _leaves(model: nn.Module) -> List[Tuple[str, torch.Size, str, float]]:
    """(state-dict name, shape, draw, scale) of every persistent leaf."""
    kind: Dict[str, Tuple[str, float]] = {}
    for mname, mod in model.named_modules():
        pre = f"{mname}." if mname else ""
        w = getattr(mod, "weight", None)
        if isinstance(w, torch.Tensor) and w.dim() > 1:
            if isinstance(mod, Conv):
                fan = w.shape[1] * w.shape[2] * w.shape[3]
            elif isinstance(mod, ConvTranspose):
                fan = w.shape[0] * w.shape[2] * w.shape[3]
            elif isinstance(mod, Linear):
                fan = w.shape[1]
            else:
                raise TypeError(f"no fan-in rule for {type(mod).__name__}")
            kind[pre + "weight"] = ("he", math.sqrt(2.0 / fan))
    out = []
    for name, t in model.state_dict().items():
        last = name.rsplit(".", 1)[-1]
        if name in kind:
            draw, scale = kind[name]
        elif last.endswith("_kernel"):          # split-attention stacks
            fan = (t.shape[2] * t.shape[3] * t.shape[4] if t.dim() == 6
                   else t.shape[-2])
            draw, scale = "he", math.sqrt(2.0 / fan)
        elif last == "running_var":
            draw, scale = "var", 1.0
        elif last.endswith("_scale") or (last == "weight" and t.dim() == 1):
            draw, scale = "scale", 0.1
        else:
            draw, scale = "small", 0.1
        out.append((name, t.shape, draw, scale))
    return out


def seeded_state_dict(model: nn.Module, seed: int, device: torch.device
                      ) -> Dict[str, torch.Tensor]:
    """Float32 weights for every persistent leaf of ``model`` from
    ``seed``, on ``device``."""
    leaves = _leaves(model)
    sizes = [math.prod(shape) for _, shape, _, _ in leaves]
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    uniform = torch.rand(sum(sizes), generator=gen, device=device)
    out, ofs = {}, 0
    for (name, shape, draw, scale), size in zip(leaves, sizes):
        z = normal[ofs:ofs + size].view(shape)
        if draw == "var":
            v = 0.5 + uniform[ofs:ofs + size].view(shape)
        elif draw == "scale":
            v = 1.0 + scale * z
        else:
            v = scale * z
        out[name] = v
        ofs += size
    return out
