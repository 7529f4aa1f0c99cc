"""Device-resident batch pipeline (PyTorch port of ``data/pipeline.py``).

The whole dataset moves to the device once (thousands of 256x80x10 float32
frames); batches are slices of it.  Cursor semantics are the reference's
(``Dataset_2.py:88-134``): ``next_train(bs)`` advances a cursor, returns
``terminator=True`` and resets when the end is reached, and substitutes the
tail window ``[-1-bs:-1]`` for a short final batch.

Left out: the out-of-core shard views (``native_loader``) and prefetch.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ultrasound_modeling_tpu_torch.data import synthetic
from ultrasound_modeling_tpu_torch.device import DEFAULT_DEVICE, resolve_device


def load_npy_pair(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Split a raw ``[N, 1, H, W, C+2]`` ETL file into (x, y): channel 0 is
    the label, the last (bMode) is not trained on."""
    raw = np.load(path, allow_pickle=True)
    return (raw[:, 0, :, :, 1:-1].astype(np.float32),
            raw[:, 0, :, :, 0].astype(np.float32))


class Dataset:
    """Train and test arrays on ``device`` (the card unless the caller asks
    for the CPU) with the reference's cursors."""

    def __init__(self, x_tr, y_tr, x_te, y_te, num_classes: int = 3,
                 device=DEFAULT_DEVICE):
        device = resolve_device(device)

        def put(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.float32)).to(device)

        self.x_tr, self.y_tr = put(x_tr), put(y_tr)
        self.x_te, self.y_te = put(x_te), put(y_te)
        self.num_tr = int(self.x_tr.shape[0])
        self.num_te = int(self.x_te.shape[0])
        self.idx_tr = 0
        self.idx_te = 0
        self.num_classes = num_classes
        self.height, self.width, self.channel = (int(s) for s in
                                                 self.x_tr.shape[1:])

    @classmethod
    def from_npy(cls, train_path: str, val_path: str, num_classes: int = 3,
                 device=DEFAULT_DEVICE) -> "Dataset":
        device = resolve_device(device)
        return cls(*load_npy_pair(train_path), *load_npy_pair(val_path),
                   num_classes, device)

    @classmethod
    def synthetic(cls, n_train: int = 32, n_test: int = 8, seed: int = 0,
                  height: int = 256, width: int = 80, n_disp: int = 10,
                  num_classes: int = 3, device=DEFAULT_DEVICE) -> "Dataset":
        device = resolve_device(device)
        raw_tr = synthetic.make_raw_array(n_train, seed, height, width, n_disp)
        raw_te = synthetic.make_raw_array(n_test, seed + 1, height, width,
                                          n_disp)
        return cls(raw_tr[:, 0, :, :, 1:-1], raw_tr[:, 0, :, :, 0],
                   raw_te[:, 0, :, :, 1:-1], raw_te[:, 0, :, :, 0],
                   num_classes, device)

    @staticmethod
    def _next(x, y, idx: int, n: int, batch_size: int, fix: bool):
        start, end = idx, idx + batch_size
        terminator = end >= n
        new_idx = start if fix else (0 if terminator else end)
        if end > n:
            # short final batch: the tail window (Dataset_2.py:104-105)
            return x[-1 - batch_size:-1], y[-1 - batch_size:-1], terminator, new_idx
        return x[start:end], y[start:end], terminator, new_idx

    def next_train(self, batch_size: int = 1, fix: bool = False):
        xb, yb, term, self.idx_tr = self._next(
            self.x_tr, self.y_tr, self.idx_tr, self.num_tr, batch_size, fix)
        return xb, yb, term

    def next_test(self, batch_size: int = 1):
        xb, yb, term, self.idx_te = self._next(
            self.x_te, self.y_te, self.idx_te, self.num_te, batch_size, False)
        return xb, yb, term
