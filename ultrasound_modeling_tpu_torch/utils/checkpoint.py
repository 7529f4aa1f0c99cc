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
exactly.  :func:`bridge_leaf` applies it to one leaf, a tensor on any
device: :func:`from_flax` on the host, the int8 forward on the card
(``infer/quantize.py``).

``Checkpointer`` saves and restores a training state (port of the JAX
package's ``Checkpointer``, one ``torch.save`` file per save).
"""

from __future__ import annotations

import os
import re
from typing import Any, Callable, Dict, List, Optional

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


def _flax_layout(parts, ndim: int, transposed):
    """(torch path parts, layout) of one flax leaf of ``ndim`` dimensions;
    the layout names the permutation of :data:`LAYOUTS` that takes the
    flax array to the torch one."""
    name = parts[-1]
    m = _ATTN_LEAF.match(name)
    if len(parts) >= 2 and parts[-2] == "attn" and m:
        proj, kind = m.groups()
        if kind == "kernel":
            return parts[:-1] + [proj, "weight"], "T"
        return parts[:-1] + [proj, "bias"], "same"
    if name == "kernel":
        if len(parts) >= 2 and transposed(parts[-2]):
            return parts[:-1] + ["weight"], "tconv"
        if ndim == 4:
            return parts[:-1] + ["weight"], "conv"
        if ndim == 2:
            return parts[:-1] + ["weight"], "T"
        raise ValueError(f"unexpected kernel rank {ndim} at {parts}")
    if name == "scale":
        return parts[:-1] + ["weight"], "same"
    return parts, "same"


# flax -> torch layouts: Dense [in, out] -> [out, in]; conv HWIO -> OIHW;
# ConvTranspose: flipped on both spatial axes, then [in, out, kh, kw]
LAYOUTS = {"same": lambda t: t, "T": lambda t: t.t(),
           "conv": lambda t: t.permute(3, 2, 0, 1),
           "tconv": lambda t: t.flip(0, 1).permute(2, 3, 0, 1)}


def bridge_leaf(key: str, a: torch.Tensor, family: str = "transunet"):
    """The torch ``state_dict`` entries ``(name, tensor)`` of the flax leaf
    ``key`` (``'params/...'`` or ``'batch_stats/...'``) of model
    ``family``: one, or one per layer for a scan-stacked leaf; each a view
    or a copy of ``a``, laid out by :data:`LAYOUTS`."""
    transposed = _transposed(family)
    col, _, path = key.partition("/")
    if col == "batch_stats":
        parts = path.split("/")
        leaf = {"mean": "running_mean", "var": "running_var"}.get(
            parts[-1], parts[-1])
        if leaf == parts[-1] and not _STAT_LEAF.search(leaf):
            raise KeyError(f"unknown batch_stats leaf {key!r}")
        return [(".".join(parts[:-1] + [leaf]), a)]
    if col != "params":
        raise KeyError(f"unknown collection in {key!r}")
    if path.startswith(STACKED_PREFIX):
        rest = path[len(STACKED_PREFIX):].split("/")
        out = []
        for i in range(a.shape[0]):
            tparts, layout = _flax_layout(["encoder", "blocks", str(i)] + rest,
                                          a.ndim - 1, transposed)
            out.append((".".join(tparts), LAYOUTS[layout](a[i])))
        return out
    tparts, layout = _flax_layout(path.split("/"), a.ndim, transposed)
    return [(".".join(tparts), LAYOUTS[layout](a))]


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
    """Inverse of :func:`bridge_leaf` on one torch leaf."""
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
    _transposed(family)      # raises on an unknown family, even for {}
    out: Dict[str, torch.Tensor] = {}
    for key, a in flat.items():
        leaf = torch.from_numpy(np.array(a, dtype=np.float32, order="C"))
        for name, t in bridge_leaf(key, leaf, family):
            out[name] = t.clone(memory_format=torch.contiguous_format)
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


class Checkpointer:
    """Saves and restores a training state — a nested dict of tensors,
    ints, floats and None (``train.loop.Trainer.checkpoint_state``) — as
    one ``ckpt_{step:010d}.pt`` per save (``torch.save``), keeping the
    newest ``max_to_keep`` (the JAX package's ``Checkpointer``, whose
    msgpack files hold the ``TrainState``)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:010d}.pt")

    def steps(self) -> List[int]:
        pat = re.compile(r"ckpt_(\d+)\.pt$")
        return sorted(int(m.group(1)) for m in map(pat.match,
                                                   os.listdir(self.directory))
                      if m)

    def save(self, state: Dict[str, Any], step: int) -> None:
        tmp = self.path(step) + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self.path(step))
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self.path(old))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, target: Dict[str, Any], step: Optional[int] = None,
                section: Optional[str] = None) -> Dict[str, Any]:
        """The checkpoint of ``step`` (the latest by default) in the
        structure of ``target``, each tensor on its template's device;
        ``section`` restores only that top-level entry (``'model'`` for
        serving) into ``target``.

        The file must hold exactly the template's keys, shapes and
        non-float dtypes, else this raises.  A floating-point tensor whose
        dtype differs from its template's is cast to it, with one printed
        line naming it (the JAX package casts every mismatch, silently).
        Generator states are CPU byte tensors of their generator's kind, so
        a train state written on the card resumes on the card; the model
        restores on either device."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        raw = torch.load(self.path(step), map_location="cpu",
                         weights_only=True)
        if section is not None:
            raw = raw[section]
        return _restore_like(target, raw, section or "")


def _restore_like(template: Any, raw: Any, where: str) -> Any:
    if isinstance(template, dict):
        if not isinstance(raw, dict):
            raise TypeError(f"{where}: checkpoint holds {type(raw).__name__}, "
                            f"want a dict")
        missing, extra = set(template) - set(raw), set(raw) - set(template)
        if missing or extra:
            raise KeyError(f"{where or 'checkpoint'}: missing "
                           f"{sorted(missing)[:5]}, extra {sorted(extra)[:5]}")
        return {k: _restore_like(template[k], raw[k], f"{where}/{k}")
                for k in template}
    if isinstance(template, (list, tuple)):
        if not isinstance(raw, (list, tuple)) or len(raw) != len(template):
            raise ValueError(f"{where}: checkpoint holds {type(raw).__name__} "
                             f"of another length")
        return [_restore_like(t, r, f"{where}/{i}")
                for i, (t, r) in enumerate(zip(template, raw))]
    if isinstance(template, torch.Tensor):
        if not isinstance(raw, torch.Tensor):
            raise TypeError(f"{where}: checkpoint holds "
                            f"{type(raw).__name__}, want a tensor")
        if raw.shape != template.shape:
            raise ValueError(f"{where}: shape {tuple(raw.shape)} in the "
                             f"checkpoint, {tuple(template.shape)} wanted")
        if raw.dtype != template.dtype:
            if not (raw.dtype.is_floating_point
                    and template.dtype.is_floating_point):
                raise TypeError(f"{where}: dtype {raw.dtype} in the "
                                f"checkpoint, {template.dtype} wanted")
            print(f"restore: cast {where} from {raw.dtype} to "
                  f"{template.dtype}", flush=True)
        return raw.to(template.device, template.dtype)
    if type(raw) is not type(template):
        raise TypeError(f"{where}: checkpoint holds {type(raw).__name__}, "
                        f"want {type(template).__name__}")
    return raw
