"""Faults planted under the timed path, to show that the check catches
them (the tests under ``tests/`` and ``calibrate.py`` read them; a
benchmark run plants none).  Each takes what the flow hands it: the
serving callable (numpy frames -> probabilities) and the served model,
before the first call, and returns the callable, wrapped or not; or the
train step's objects, changed in place.
"""

from __future__ import annotations

import numpy as np
import torch

SETUP_STEPS = 4     # steps the training flow's set-up drives


def _queries_and_keys(model):
    """(query, key) projection pairs of every attention of a served model:
    the TransUNet's ``query`` and ``key`` layers (K1), the first and
    second thirds of the Swin's ``qkv`` layers (K4)."""
    params = dict(model.named_parameters())
    for name, p in params.items():
        if name.endswith(("query.weight", "query.bias")):
            yield p, params[name.replace("query.", "key.")]
        elif name.endswith(("qkv.weight", "qkv.bias")):
            d = p.shape[0] // 3
            yield p[:d], p[d:2 * d]


def answer_altered(forward, model):
    """The first frame of every device batch's answer replaced by the
    uniform distribution."""
    def f(x):
        out = np.array(forward(x))
        out[0] = 1.0 / out.shape[-1]
        return out
    return f


def half_batch_serve(forward, model):
    """Only the first half of each batch computed; its answers repeated
    for the rest."""
    def f(x):
        n = len(x)
        h = max(1, n // 2)
        out = forward(x[:h])
        return np.concatenate([out, out[:n - h]])[:n]
    return f


@torch.no_grad()
def scores_zeroed(forward, model):
    """Every attention's queries zeroed, so that its scores carry nothing
    of the frame: K1 averages the values evenly, K4 weighs them by the
    relative-position bias alone."""
    for q, _ in _queries_and_keys(model):
        q.zero_()
    return forward


@torch.no_grad()
def queries_keys_swapped(forward, model):
    """Every attention's query and key projections exchanged: each score
    matrix comes out transposed."""
    for q, k in _queries_and_keys(model):
        q_old = q.clone()
        q.copy_(k)
        k.copy_(q_old)
    return forward


def state_unchanged(trainer):
    """Each step computes the loss and gradients but leaves the weights and
    the optimizer's state as they were."""
    trainer.state.opt.step = lambda lr: None


def stale_after_setup(trainer):
    """The set-up's steps update the state; every later step, those of the
    window and after it, leaves it as it was (as a step captured once and
    replayed against stale state would)."""
    step, calls = trainer.state.opt.step, [0]

    def f(lr):
        calls[0] += 1
        if calls[0] <= SETUP_STEPS:
            step(lr)
    trainer.state.opt.step = f


def half_batch_train(trainer):
    """Each step sees the first half of its batch: the loss and gradients
    are the mean over that half."""
    step = trainer.step

    def f(state, x, y, lr):
        h = max(1, x.shape[0] // 2)
        return step(state, x[:h], y[:h], lr)
    trainer.step = f


SERVE = {"answer_altered": answer_altered, "half_batch": half_batch_serve,
         "scores_zeroed": scores_zeroed,
         "queries_keys_swapped": queries_keys_swapped}
TRAIN = {"state_unchanged": state_unchanged, "half_batch": half_batch_train,
         "stale_after_setup": stale_after_setup}


def for_kind(kind: str) -> dict:
    return TRAIN if kind == "train" else SERVE
