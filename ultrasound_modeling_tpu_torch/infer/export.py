"""Serving export: the trained forward as a self-contained artifact
(PyTorch port of ``infer/export.py``).

The reference ships trained models as whole Keras SavedModels (reference:
MainNumpy.py:177, TBIEvaluator.py:235-236); the JAX package lowers its
jitted forward to StableHLO with the weights baked in.  Here the eval-mode
forward is traced by ``torch.export`` under ``torch.no_grad()`` and written
with ``torch.export.save``: the program and its weights, with the
per-frame shape ``(H, W, C)`` and the batch recorded beside them
(``extra_files``).  Serving loads it with ``torch.export.load`` and calls
it without the model class or the config; it needs this package imported
only for the kernels' custom ops.  The weights stay on the device they
were exported on, so the artifact serves on that kind of device only (as
the JAX package's artifacts are tied to their platform).

Batch: by default the batch axis is exported symbolically (``Dim``), so one
artifact serves any batch size; an int pins it.  Both keep the kernels on
the card: K1 and K4's forward are custom ops (``ops/kernels.py``) that the
program calls as nodes, and the op chooses its launch at run time from the
shapes it is given.  (The JAX package forces its composed attention under
a symbolic batch only because a Pallas grid is fixed at lowering; the
custom ops have no such limit, and an artifact that traced the plain route
would hide the kernels.)  ``quantize='int8'`` exports the int8 forward of
``infer/quantize.py``, whose int8 weights are the artifact's constants.
"""

from __future__ import annotations

import json
from typing import Optional, Tuple

import torch
from torch.export import Dim

from ultrasound_modeling_tpu_torch.infer.quantize import QuantizedForward
from ultrasound_modeling_tpu_torch.ops import kernels  # noqa: F401  (registers the ops)

META = "meta.json"
MAX_BATCH = 65536
# the batch a symbolic export is traced at: 0 and 1 would specialize
TRACE_BATCH = 2


def export_forward(model_cfg, model: torch.nn.Module,
                   sample_shape: Tuple[int, ...], batch: Optional[int] = None,
                   quantize: Optional[str] = None
                   ) -> torch.export.ExportedProgram:
    """Export ``model``'s eval forward ``x -> probs`` on the device its
    weights lie on.  ``sample_shape`` is the per-frame shape (H, W, C);
    ``batch=None`` exports a symbolic batch axis (one artifact, any batch
    size), an int pins it.  ``quantize='int8'`` exports int8 weights
    (dequantized on the device in every call): ~4x smaller than f32.
    ``model_cfg`` is the config the model was built from."""
    if model_cfg.name != model.family:
        raise ValueError(f"config {model_cfg.name!r} for a {model.family} model")
    module = model.eval()
    if quantize:
        if quantize != "int8":
            raise ValueError(f"unknown quantize mode {quantize!r}")
        module = QuantizedForward(model)
    device = next(iter(module.buffers() if quantize else module.parameters())).device
    n = TRACE_BATCH if batch is None else int(batch)
    sample = torch.zeros((n, *sample_shape), dtype=torch.float32, device=device)
    dynamic = ({0: Dim("batch", min=1, max=MAX_BATCH)},) if batch is None else None
    with torch.no_grad():
        exported = torch.export.export(module, (sample,), dynamic_shapes=dynamic)
    # the artifact holds the program and its weights, not the sample it was
    # traced at (torch.export.save writes example inputs: 52 MB at b64)
    exported.example_inputs = None
    return exported


def save_exported(exported: torch.export.ExportedProgram, path: str) -> None:
    """Write the artifact, with its input's per-frame shape and batch (None
    when symbolic) recorded beside the program."""
    (spec,) = exported.graph_signature.user_inputs
    node = next(n for n in exported.graph.nodes if n.name == spec)
    shape = node.meta["val"].shape
    batch = shape[0] if isinstance(shape[0], int) else None
    meta = {"sample_shape": [int(d) for d in shape[1:]], "batch": batch}
    torch.export.save(exported, path, extra_files={META: json.dumps(meta)})


def load_exported(path: str, device: torch.device):
    """Load an artifact to run on ``device``; returns ``fn(x) -> probs``.

    The artifact holds the weights — no checkpoint, model class, or config
    is needed (the ``keras.models.load_model`` role —
    reference: TBIEvaluator.py:235-236)."""
    return load_exported_meta(path, device)[0]


def load_exported_meta(path: str, device: torch.device):
    """Like :func:`load_exported` but also returns the per-frame input shape
    ``(H, W, C)`` recorded in the artifact and its batch axis: ``None`` for
    a symbolic (any-size) batch, or the pinned int for a static export —
    callers that feed varying batch sizes (serve's padding buckets, infer's
    chunk loop) must pad to exactly that size when it is static.

    The program runs where its weights were exported, so an artifact
    serves only on that kind of device: one exported on the CPU would run
    the kernels' plain versions there however the caller's tensors lie,
    and one exported on the card needs the card.  A ``device`` of another
    kind raises; ``fn`` moves its input to ``device``."""
    extra = {META: ""}
    exported = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra[META])
    device = torch.device(device)
    held = {t.device for t in (*exported.state_dict.values(),
                               *exported.constants.values())
            if isinstance(t, torch.Tensor)}
    if any(d.type != device.type for d in held):
        raise ValueError(
            f"{path} was exported with its weights on "
            f"{sorted(str(d) for d in held)} and cannot run on {device}: "
            f"export it again with --device {device.type}")
    module = exported.module()

    @torch.no_grad()
    def fn(x: torch.Tensor) -> torch.Tensor:
        return module(x.to(device))

    return fn, tuple(meta["sample_shape"]), meta["batch"]
