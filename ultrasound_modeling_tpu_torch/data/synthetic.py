"""Synthetic dataset generator (port of ``data/synthetic.py``: numpy
only, the same arrays bit for bit for the same seed).

The JAX package's ``data/__init__.py`` imports its jax modules, so its
numpy-only ``synthetic`` cannot be imported on a machine without jax; the
port keeps its own copy.

Emits arrays with the exact on-disk convention of the reference ETL:
per-sample ``[256, 80, 12]`` = concat(label[1], displacement real[5] +
imag[5], bMode[1]), wrapped in an extra list dim so files are
``[N, 1, 256, 80, 12]`` (reference: DataFilePlayGround.py:393-402,
Dataset_2.py:31-43).  Labels are *soft* around {0,1,2} with blurred edges,
mimicking the Gaussian-blurred label maps the ETL produces
(reference: DataFilePlayGround.py:336-343).

Used by tests and the end-to-end smoke train; real data comes from
``data.etl``.
"""

from __future__ import annotations

import numpy as np


def _blur(x: np.ndarray, iters: int = 4) -> np.ndarray:
    """Cheap separable box blur (host-side; only used to soften synthetic labels)."""
    for _ in range(iters):
        x = (x
             + np.roll(x, 1, 0) + np.roll(x, -1, 0)
             + np.roll(x, 1, 1) + np.roll(x, -1, 1)) / 5.0
    return x


def make_sample(rng: np.random.Generator, height: int = 256, width: int = 80,
                n_disp: int = 10) -> np.ndarray:
    """One ``[H, W, n_disp + 2]`` sample: soft label, displacement, bMode."""
    yy, xx = np.mgrid[0:height, 0:width]
    cy = rng.uniform(0.40, 0.60) * height
    cx = rng.uniform(0.40, 0.60) * width
    ry = rng.uniform(0.28, 0.40) * height
    rx = rng.uniform(0.28, 0.42) * width
    brain = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) < 1.0

    label = brain.astype(np.float32)
    # Bleed blob inside the brain for ~half the samples.
    bleed = None
    if rng.uniform() < 0.5:
        by = cy + rng.uniform(-0.3, 0.3) * ry
        bx = cx + rng.uniform(-0.3, 0.3) * rx
        bry = rng.uniform(0.15, 0.35) * ry
        brx = rng.uniform(0.15, 0.35) * rx
        bleed = ((((yy - by) / bry) ** 2 + ((xx - bx) / brx) ** 2) < 1.0) & brain
        label = np.where(bleed, 2.0, label)
    label = _blur(label)
    if bleed is not None:
        # Re-stamp the bleed core after smoothing, like the real ETL
        # (reference: DataFilePlayGround.py:339-341).
        label = np.where(bleed, 2.0, label)
    # Zero outside the brain exactly, like the real ETL (data/etl.py
    # build_label: np.where(brain_resized == 0, 0.0, label)) — blurred
    # values surviving outside would make augment.erode_brain (outside =
    # label < 0.1) behave differently on synthetic vs real archives.
    label = np.where(brain, np.maximum(label, 0.96), 0.0)

    # Smooth displacement fields, zero-mean / max-abs-1 per channel then
    # zeroed outside the brain (reference: DataFilePlayGround.py:368-388).
    disp = rng.normal(size=(height, width, n_disp)).astype(np.float32)
    for c in range(n_disp):
        disp[:, :, c] = _blur(disp[:, :, c], 6)
    disp -= disp.mean(axis=(0, 1))
    maxabs = np.abs(disp).max(axis=(0, 1))
    maxabs[maxabs == 0] = 1.0
    disp /= maxabs
    if bleed is not None:
        # The physical premise of the task: clotted blood displaces less
        # than brain tissue under the cardiac pulse, so attenuate the
        # displacement amplitude inside the bleed.  Without this the bleed
        # class carries no input signal at all (the models see only the
        # displacement channels — Dataset_2.py:31-43 strips label and
        # bMode) and held-out bleed Dice measures memorization, not
        # learning.
        atten = rng.uniform(0.2, 0.4)
        disp = np.where(bleed[..., None], disp * atten, disp)
    disp = np.where(brain[..., None], disp, 0.0).astype(np.float32)

    bmode = _blur(rng.normal(size=(height, width)).astype(np.float32), 3)
    return np.concatenate(
        [label[..., None], disp, bmode[..., None]], axis=-1).astype(np.float32)


def make_raw_array(n: int, seed: int = 0, height: int = 256, width: int = 80,
                   n_disp: int = 10) -> np.ndarray:
    """``[N, 1, H, W, n_disp + 2]`` float array, matching the on-disk layout."""
    rng = np.random.default_rng(seed)
    out = np.stack([make_sample(rng, height, width, n_disp) for _ in range(n)])
    return out[:, None]  # the extra list dim from the ETL's .append([image])


def write_npy(path: str, n: int, seed: int = 0, **kw) -> None:
    np.save(path, make_raw_array(n, seed, **kw))
