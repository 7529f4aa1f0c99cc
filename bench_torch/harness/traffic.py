"""The one traffic generator: a mix file's parameters and the seed in, the
schedule of work out.  The program receives only the inputs it yields.

Kinds (the mix file's ``kind``):

* ``closed`` -- back-to-back batches of ``batch`` frames, drawn in a seeded
  order from a pool of ``pool_batches`` distinct batches;
* ``train``  -- the train step over a seeded set of ``batches`` distinct
  batches of ``batch`` frames, walked by the program's dataset cursor.

Every seed gets the same amount of work: the seed only orders the
batches.
"""

from __future__ import annotations

import numpy as np

KINDS = ("closed", "train")


def rng(seed: int, stream: int) -> np.random.Generator:
    """Independent host streams of one seed."""
    return np.random.default_rng([int(seed) % 2 ** 63, stream])


def closed_order(mix: dict, seed: int, n: int) -> np.ndarray:
    """The pool indices of the first ``n`` batches: seeded permutations of
    the pool, one after another."""
    pool = int(mix["pool_batches"])
    r = rng(seed, 1)
    reps = -(-n // pool)
    return np.concatenate([r.permutation(pool) for _ in range(reps)])[:n]
