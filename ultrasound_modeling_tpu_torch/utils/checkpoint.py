"""Weight bridge between the JAX package's flax variables and this port's
``state_dict``.

The exchange format is the JAX package's npz (``utils/checkpoint.py``
``flatten_params`` / ``save_params_npz``): one array per leaf under its
``'/'``-joined path.  Both collections travel in one file, so the keys are
``params/...`` and ``batch_stats/...``; on the JAX side::

    save_params_npz({"params": v["params"], "batch_stats": v["batch_stats"]},
                    "P.npz")

The torch module tree mirrors the flax tree name for name (including flax's
``LayerNorm_0`` / ``BatchNorm_0`` wrapper levels), so the mapping is
mechanical.  Per leaf:

* conv ``kernel`` HWIO            -> ``weight`` OIHW;
* ``ConvTranspose`` ``kernel``    -> ``weight`` ``[in, out, kh, kw]``, flipped
  on both spatial axes (flax applies the kernel unflipped; torch's
  ``conv_transpose2d`` is the true transpose — see models/common.py).
  Which modules are transposed depends on the family (``family``
  argument): the TransUNet's ``up`` and ``head``; none in the ViT, whose
  ``head`` is a plain 3x3 conv; the Swin's ``up_{i}``, ``up_final1`` and
  ``head``; the ResNeStUNet's ``upsample_{i}/t_conv`` and ``f_tran``; the
  MobileUNet's ``decoder_up_{i}/t_conv`` and ``decoder_head``.  A conv
  without a bias (the MobileUNet's) has no ``bias`` leaf on either side; a
  grouped (depthwise) kernel ``[kh, kw, 1, ch]`` becomes ``[ch, 1, kh,
  kw]`` like any other;
* Dense ``kernel`` ``[in, out]``  -> ``weight`` ``[out, in]``; the attention's
  ``{query,key,value,out}_kernel`` / ``_bias`` become the ``weight`` / ``bias``
  of the ``query`` / ``key`` / ``value`` / ``out`` linears, and the Swin
  attention's raw ``{qkv,proj}_kernel`` / ``_bias`` those of its ``qkv`` /
  ``proj`` linears;
* norm ``scale``                  -> ``weight``; BatchNorm ``mean`` / ``var``
  (``batch_stats``)               -> ``running_mean`` / ``running_var``; the
  split-attention stage's ``{branch1,branch2,attn}_norm_{mean,var}``
  (``batch_stats`` of the ResNeStUNet's stages) keep their names as
  buffers;
* the ``nn.scan``-stacked ``encoder/blocks/block/...`` ``[L, ...]`` leaves
  -> ``encoder.blocks.{i}....`` (one module per layer);
* every other leaf (the stacked ``[K, R, ...]`` split-attention params of
  ``models/resnest.py``, biases) keeps its name and shape.

Every step is a permutation, flip or split, so ``to_flax(from_flax(p)) == p``
exactly.
"""

from __future__ import annotations

import re
from typing import Callable, Dict

import numpy as np
import torch

# flax module names that are ConvTranspose layers, per family, as a
# pattern (models/transunet.py DecoderBlock.up, DecoderCup.head; the ViT
# has none; models/swin.py SwinSegmenter up_{i}, up_final1, head;
# models/resnest.py _Upsample.t_conv, ResNeStUNet.f_tran;
# models/mobileunet.py _Upsample.t_conv, MobileUNet.decoder_head).
CONV_TRANSPOSE = {"transunet": r"up|head", "vit": None,
                  "swin": r"up_\d+|up_final1|head",
                  "resnest_unet": r"t_conv|f_tran",
                  "mobileunet": r"t_conv|decoder_head"}
# batch_stats leaves that keep their names (the batch-norm split-attention
# stage's running statistics)
_STAT_LEAF = re.compile(r"_norm_(mean|var)$")
STACKED_PREFIX = "encoder/blocks/block/"
_ATTN_LEAF = re.compile(r"^(query|key|value|out|qkv|proj)_(kernel|bias)$")
_ATTN_PROJ = ("query", "key", "value", "out", "qkv", "proj")


def _transposed(family: str) -> Callable[[str], object]:
    """Whether a module name of ``family`` is a ConvTranspose layer."""
    if family not in CONV_TRANSPOSE:
        raise ValueError(f"unknown model family {family!r}; the bridge knows "
                         f"{sorted(CONV_TRANSPOSE)}")
    pattern = CONV_TRANSPOSE[family]
    return re.compile(pattern).fullmatch if pattern else (lambda name: None)


def _leaf_from_flax(parts, a: np.ndarray, transposed):
    """(torch path parts, torch array) for one flax leaf."""
    name = parts[-1]
    m = _ATTN_LEAF.match(name)
    if len(parts) >= 2 and parts[-2] == "attn" and m:
        proj, kind = m.groups()
        if kind == "kernel":
            return parts[:-1] + [proj, "weight"], a.T
        return parts[:-1] + [proj, "bias"], a
    if name == "kernel":
        if len(parts) >= 2 and transposed(parts[-2]):
            return parts[:-1] + ["weight"], a[::-1, ::-1].transpose(2, 3, 0, 1)
        if a.ndim == 4:
            return parts[:-1] + ["weight"], a.transpose(3, 2, 0, 1)
        if a.ndim == 2:
            return parts[:-1] + ["weight"], a.T
        raise ValueError(f"unexpected kernel rank {a.ndim} at {parts}")
    if name == "scale":
        return parts[:-1] + ["weight"], a
    return parts, a


def _attn_proj(parts) -> bool:
    return len(parts) >= 3 and parts[-3] == "attn" and parts[-2] in _ATTN_PROJ


def flax_path(parts, ndim: int):
    """The flax path parts of the torch leaf ``parts`` (its ``state_dict``
    key split on '.') holding an array of ``ndim`` dimensions."""
    name = parts[-1]
    if _attn_proj(parts):
        kind = "kernel" if name == "weight" else "bias"
        return parts[:-2] + [f"{parts[-2]}_{kind}"]
    if name == "weight":
        return parts[:-1] + ["kernel" if ndim in (2, 4) else "scale"]
    return parts


def _leaf_to_flax(parts, a: np.ndarray, transposed):
    """Inverse of :func:`_leaf_from_flax` on one torch leaf."""
    fparts = flax_path(parts, a.ndim)
    if _attn_proj(parts):
        return fparts, a.T if parts[-1] == "weight" else a
    if fparts[-1] == "kernel":
        if transposed(parts[-2]):
            return fparts, a.transpose(2, 3, 0, 1)[::-1, ::-1]
        return fparts, a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
    return fparts, a


def from_flax(flat: Dict[str, np.ndarray],
              family: str = "transunet") -> Dict[str, torch.Tensor]:
    """flax-layout ``{'params/a/b': array, 'batch_stats/...': array}`` of
    model ``family`` -> torch ``state_dict`` (float32 CPU tensors)."""
    transposed = _transposed(family)
    out: Dict[str, torch.Tensor] = {}

    def put(parts, a):
        out[".".join(parts)] = torch.from_numpy(
            np.array(a, dtype=np.float32, order="C"))

    for key, a in flat.items():
        col, _, path = key.partition("/")
        a = np.asarray(a)
        if col == "batch_stats":
            parts = path.split("/")
            leaf = {"mean": "running_mean", "var": "running_var"}.get(
                parts[-1], parts[-1])
            if leaf == parts[-1] and not _STAT_LEAF.search(leaf):
                raise KeyError(f"unknown batch_stats leaf {key!r}")
            put(parts[:-1] + [leaf], a)
            continue
        if col != "params":
            raise KeyError(f"unknown collection in {key!r}")
        if path.startswith(STACKED_PREFIX):
            rest = path[len(STACKED_PREFIX):].split("/")
            for i in range(a.shape[0]):
                put(*_leaf_from_flax(["encoder", "blocks", str(i)] + rest,
                                     a[i], transposed))
            continue
        put(*_leaf_from_flax(path.split("/"), a, transposed))
    return out


def to_flax(state_dict: Dict[str, torch.Tensor],
            family: str = "transunet") -> Dict[str, np.ndarray]:
    """torch ``state_dict`` of model ``family`` -> flax-layout flat dict
    (inverse of :func:`from_flax`)."""
    transposed = _transposed(family)
    out: Dict[str, np.ndarray] = {}
    stacked: Dict[str, Dict[int, np.ndarray]] = {}
    for key, t in state_dict.items():
        a = t.detach().to("cpu", torch.float32).numpy()
        parts = key.split(".")
        if parts[-1] in ("running_mean", "running_var"):
            leaf = "mean" if parts[-1] == "running_mean" else "var"
            out["batch_stats/" + "/".join(parts[:-1] + [leaf])] = a
            continue
        if _STAT_LEAF.search(parts[-1]):
            out["batch_stats/" + "/".join(parts)] = a
            continue
        if parts[:2] == ["encoder", "blocks"]:
            layer = int(parts[2])
            fparts, fa = _leaf_to_flax(parts[3:], a, transposed)
            stacked.setdefault("/".join(fparts), {})[layer] = fa
            continue
        fparts, fa = _leaf_to_flax(parts, a, transposed)
        out["params/" + "/".join(fparts)] = np.ascontiguousarray(fa)
    for rest, layers in stacked.items():
        out["params/" + STACKED_PREFIX + rest] = np.stack(
            [layers[i] for i in range(len(layers))])
    return out


def load_params_npz(path: str,
                    family: str = "transunet") -> Dict[str, torch.Tensor]:
    """Read a flax-layout npz (``params/...`` + ``batch_stats/...``) of
    model ``family`` into a torch ``state_dict``."""
    with np.load(path) as archive:
        return from_flax({k: archive[k] for k in archive.files}, family)


def save_params_npz(state_dict: Dict[str, torch.Tensor], path: str,
                    family: str = "transunet") -> None:
    """Write a torch ``state_dict`` of model ``family`` as a flax-layout
    npz."""
    np.savez(path, **to_flax(state_dict, family))


QK_DAMP = 0.05


def random_flax_variables(model: torch.nn.Module,
                          seed: int) -> Dict[str, np.ndarray]:
    """Random flax-layout variables for ``model``'s tree, drawn with numpy
    from ``seed`` (the stand-in for a trained checkpoint).

    Kernels are He-normal over their fan-in, norm scales near 1, biases and
    BatchNorm means small, BatchNorm variances in [0.5, 1.5].  The attention
    query/key kernels (the q and k columns of the Swin's ``qkv_kernel``) are
    damped by ``QK_DAMP``: random attention saturates
    the softmax and amplifies bf16 rounding chaotically, so the comparisons
    between bf16 paths stay in the smooth regime (as the JAX package's
    kernel tests do)."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, a in sorted(to_flax(model.state_dict(), model.family).items()):
        name = key.rsplit("/", 1)[-1]
        shape = a.shape
        if key.startswith("batch_stats/"):
            v = (rng.uniform(0.5, 1.5, shape) if name.endswith("var")
                 else 0.1 * rng.standard_normal(shape))
        elif name.endswith("kernel"):
            if len(shape) == 6:            # [K, R, kh, kw, in, out]
                fan_in = int(np.prod(shape[2:5]))
            elif len(shape) == 4 and "/blocks/" not in key and not name.startswith("attn_"):
                fan_in = int(np.prod(shape[:3]))   # HWIO conv
            else:                          # dense, possibly stacked
                fan_in = shape[-2]
            v = rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
            if name in ("query_kernel", "key_kernel"):
                v = v * QK_DAMP
            elif name == "qkv_kernel":     # [C, 3C]: the q and k columns
                v[:, :2 * shape[1] // 3] *= QK_DAMP
        elif name.endswith("scale"):
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            v = 0.1 * rng.standard_normal(shape)
        out[key] = v.astype(np.float32)
    return out
