"""Batch inference (PyTorch port of ``infer/evaluate.py``).

Inference is a batched forward on the device; the optional two-stage
brain-mask -> bleed cascade (reference: TBIEvaluator.py:221-232) runs both
models on the device without a round trip to the host; rendering stays on
the host (``infer/render.py``).  A forward here is ``x -> probs`` on
tensors of one device (``cli._make_forward``, ``infer/quantize.py``, a
loaded artifact of ``infer/export.py``).

Cascade semantics preserved: run the brain-mask model, round its class-0
probability map (``torch.round``: half to even, as ``jnp.round``), zero the
input displacement channels where the rounded mask says "outside brain",
then run the bleed model (reference: TBIEvaluator.py:226-229 — the reference
masks where ``mask[..., 0] == 1``, i.e. where P(outside) rounds to 1).

Composite probability map (reference: TBIEvaluator.py:249-252):
``probO = 1 - p0 - 0.5*p1 + p2`` in [0, 2] for the cone renderer.

``group_by_path``, ``split_eval_file``, ``load_archive`` and
``class_counts`` are numpy, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Callable, Tuple

import numpy as np
import torch

from ultrasound_modeling_tpu_torch.device import DEFAULT_DEVICE, resolve_device


def composite_probability(probs: torch.Tensor) -> torch.Tensor:
    """reference: TBIEvaluator.py:249-252."""
    return 1.0 - probs[..., 0] - 0.5 * probs[..., 1] + probs[..., 2]


def make_cascade(brain_forward: Callable, bleed_forward: Callable,
                 return_mask: bool = False):
    """Two-stage cascade (reference: TBIEvaluator.py:221-238).

    Both args are ``x -> probs`` callables (closed over their weights).
    With ``return_mask`` the cascade also returns the rounded brain mask
    (1 inside the brain) for the Brain_Mask display panel
    (reference: TBIEvaluator.py:301-307); it stays on the device.
    """

    @torch.no_grad()
    def cascade(x: torch.Tensor):
        mask_probs = brain_forward(x)
        outside = torch.round(mask_probs[..., 0])  # 1 where outside brain
        x = torch.where(outside[..., None] == 1.0, 0.0, x)
        probs = bleed_forward(x)
        if return_mask:
            return probs, 1.0 - outside
        return probs

    return cascade


def run_inference(forward: Callable, x: np.ndarray, batch_size: int = 16,
                  device=DEFAULT_DEVICE) -> np.ndarray:
    """Batched inference over a test set ``[N, H, W, C]`` -> probs
    ``[N, H, W, classes]`` on ``device`` (replaces the reference's
    process-per-image fan-out, TBIEvaluator.py:191-206); the final batch is
    padded with zeros to ``batch_size``."""
    device = resolve_device(device)
    n = x.shape[0]
    outs = []
    for start in range(0, n, batch_size):
        chunk = x[start:start + batch_size]
        pad = batch_size - chunk.shape[0]
        if pad:
            chunk = np.concatenate(
                [chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
        xt = torch.from_numpy(np.ascontiguousarray(chunk, np.float32))
        probs = forward(xt.to(device)).float().cpu().numpy()
        outs.append(probs[:batch_size - pad] if pad else probs)
    return np.concatenate(outs, axis=0)


def group_by_path(paths: np.ndarray):
    """Group consecutive test rows that share a path name — the cardiac-cycle
    batches of one scan (reference: TBIEvaluator.py:99-118 CardiacPreProcess
    walks the index forward while ``paths`` matches).

    Returns a list of ``(path, start, stop)``.
    """
    flat = [str(p[0] if getattr(p, "ndim", 0) else p) for p in paths]
    groups = []
    start = 0
    for i in range(1, len(flat) + 1):
        if i == len(flat) or flat[i] != flat[start]:
            groups.append((flat[start], start, i))
            start = i
    return groups


def cardiac_inference(forward: Callable, x: np.ndarray, paths: np.ndarray,
                      batch_size: int = 16, device=DEFAULT_DEVICE) -> list:
    """Per-scan cardiac-cycle inference: run all cycles of each scan as one
    batch and return ``[(path, probs [cycles, H, W, C])]`` (replaces the
    reference's Cardiac_Model process fan-out, TBIEvaluator.py:132-160)."""
    out = []
    for path, start, stop in group_by_path(paths):
        probs = run_inference(forward, x[start:stop], batch_size, device)
        out.append((path, probs))
    return out


def split_eval_file(raw: np.ndarray, index: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-image (x, y, bMode) extraction from a raw ETL test file
    (reference: TBIEvaluator.py:76-84 preProcess1)."""
    y = raw[index, :, :, :, 0].reshape(raw.shape[2], raw.shape[3])
    bmode = raw[index, :, :, :, -1].reshape(raw.shape[2], raw.shape[3])
    x = raw[index, :, :, :, 1:-1].reshape(
        1, raw.shape[2], raw.shape[3], -1)
    return x.astype(np.float32), y, bmode


def load_archive(archive_dir: str):
    """Load an ETL'd test archive folder (the evaluator's input product —
    reference: TBIEvaluator.py:177-181 loads ``TestingData.npy`` +
    ``TestingPaths.npy`` from the processed folder).

    Returns ``(x [N,H,W,C], y [N,H,W], bmode [N,H,W], paths [N] or None)``
    with preProcess1 channel semantics (label ch0, displacement 1:-1,
    bMode last — reference: TBIEvaluator.py:76-84).
    """
    raw = np.load(os.path.join(archive_dir, "TestingData.npy"))
    if raw.ndim == 5:   # [N, 1, H, W, 12] ETL layout (Dataset_2.py:31-43)
        raw = raw[:, 0]
    y = raw[..., 0].astype(np.float32)
    bmode = raw[..., -1].astype(np.float32)
    x = raw[..., 1:-1].astype(np.float32)
    paths = None
    ppath = os.path.join(archive_dir, "TestingPaths.npy")
    if os.path.isfile(ppath):
        paths = np.load(ppath)
    return x, y, bmode, paths


def class_counts(probs: np.ndarray, truth: np.ndarray, num_classes: int = 3):
    """Per-frame class-count summary + confusion matrix.

    ``probs`` ``[H,W,C]`` model output, ``truth`` ``[H,W]`` scalar soft label.
    Predicted class = argmax; true class = the label2vec thresholds rounded
    to a hard class (>=1.05 -> bleed, >0.95 -> brain — Dataset_2.py:6-20).
    Returns a dict with ``pred_counts``, ``true_counts`` (pixels per class)
    and ``confusion`` (rows = true, cols = predicted).  This is the
    quantitative form of the reference's visual checkCount/Display loop
    (reference: TBIEvaluator.py:319-325,357-373).
    """
    pred = np.argmax(probs, axis=-1)
    if num_classes == 2:
        # brain-mask task: labels are {0, 1} soft masks (the 2-class
        # label2vec branch, Dataset_2.py:14-19) — round at 0.5 so every
        # pixel lands in a class instead of silently vanishing from the
        # confusion totals.
        true = np.where(truth > 0.5, 1, 0)
    else:
        # argmax-consistent class: label2vec gives class_2 = label - 1
        # (for label >= 1.05), so the bleed channel only DOMINATES the
        # brain channel for label > 1.5 — counting >= 1.05 as "true
        # bleed" would log a model that matches its own training target
        # as missing bleed on every blur-softened boundary pixel.
        true = np.where(truth > 1.5, 2, np.where(truth > 0.95, 1, 0))
        true = np.minimum(true, num_classes - 1)
    conf = np.zeros((num_classes, num_classes), np.int64)
    for t in range(num_classes):
        for p in range(num_classes):
            conf[t, p] = int(np.sum((true == t) & (pred == p)))
    return {
        "pred_counts": [int(np.sum(pred == c)) for c in range(num_classes)],
        "true_counts": [int(np.sum(true == c)) for c in range(num_classes)],
        "confusion": conf,
    }
