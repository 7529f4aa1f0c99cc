"""One run of a cell: set-up, the measured window, the stretch traced on
the device alone (every run on a card), the stretch with the host's ops
(with ``--trace 1``), then the check against the reference once the
program's state is freed.  Each traffic kind has its flow here; what a run
measured goes into an :class:`Outcome`, from which the metric readers take
their numbers.

Set-up builds exactly what the window drives and warms its shapes: the
first call of a shape pays the kernels' load (and, in a fresh checkout,
their build), cuDNN's plans and the allocator's growth.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from . import check, program, trace, traffic
from .data import frames_and_labels
from .weights import seeded_state_dict

TRACE_S = 2.0            # each traced stretch after the window
SAMPLES = 4              # device batches compared with the reference

# streams of one seed (the weights, the inputs, augmentation, drop path)
WEIGHTS, DATA, AUG, DROP = range(4)


def derive(seed: int, stream: int) -> int:
    return (int(seed) * 8 + stream) % 2 ** 63


@dataclasses.dataclass
class Outcome:
    kind: str
    setup_s: float = 0.0
    window_s: float = 0.0
    frames: int = 0
    attempted: int = 0
    failed: int = 0
    peak_bytes: int = 0
    card_frames: int = 0         # frames of the stretch traced on the device
    card_busy_s: float = 0.0     # alone, and the device's busy time in it
    trace: Optional[trace.TraceSummary] = None
    numbers: Dict[str, float] = dataclasses.field(default_factory=dict)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def _free(device):
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _traced(out: Outcome, device, stretch: Callable[[], int], traced: bool,
            cell) -> None:
    """After the window: ``stretch`` (which returns the frames it ran)
    traced on the device alone where a card is, for the device's busy time
    per frame; with ``--trace 1`` again with the host's ops."""
    alone = trace.device_only(device, stretch)
    if alone is not None:
        out.card_frames, out.card_busy_s = alone[3], alone[1]
    if traced:
        out.trace = trace.measure(device, stretch, cell.trace_ops(), alone)


def weights_for(cell, seed: int, device) -> dict:
    shapes = check.reference_model(cell, "f32", "meta")
    return seeded_state_dict(shapes, derive(seed, WEIGHTS), device)


def _inputs(cfg: dict, n: int, seed: int, device):
    h, w = cfg["model"]["img_size"]
    gen = torch.Generator(device=device).manual_seed(derive(seed, DATA))
    return frames_and_labels(n, h, w, cfg["model"]["in_channels"], gen, device)


# ---------------------------------------------------------------------------
# serving, back to back (closed loop)
# ---------------------------------------------------------------------------

def run_closed(cell, seed: int, seconds: float, traced: bool, device, t0: float,
               fault: Optional[Callable] = None) -> Outcome:
    mix, cfg = cell.traffic, cell.config
    bs, pool_n = int(mix["batch"]), int(mix["pool_batches"])
    out = Outcome("closed")
    weights = weights_for(cell, seed, device)
    model = program.build_model(cfg, weights, device)
    forward = program.serving_forward(model, device)
    if fault is not None:
        forward = fault(forward, model)
    x, _ = _inputs(cfg, bs * pool_n, seed, device)
    pool = [a for a in x.cpu().numpy().reshape(pool_n, bs, *x.shape[1:])]
    del x
    for b in range(2):
        forward(pool[b])
    _sync(device)
    out.setup_s = time.perf_counter() - t0
    r = traffic.rng(seed, 3)
    keep_at = np.sort(r.random(SAMPLES)) * 0.9 * seconds
    order = traffic.closed_order(mix, seed, 1 << 20)
    samples, i = [], 0
    start = time.perf_counter()
    while True:
        now = time.perf_counter() - start
        if now >= seconds:
            break
        idx = int(order[i])
        probs = forward(pool[idx])
        if len(samples) < len(keep_at) and now >= keep_at[len(samples)]:
            samples.append((pool[idx], probs))
        i += 1
    out.window_s = time.perf_counter() - start
    out.attempted, out.frames = i, i * bs

    def stretch():
        nonlocal i
        n, t1 = 0, time.perf_counter()
        while time.perf_counter() - t1 < TRACE_S:
            forward(pool[int(order[i])])
            i, n = i + 1, n + 1
        return n * bs
    _traced(out, device, stretch, traced, cell)
    out.peak_bytes = _peak(device)
    del model, forward
    _free(device)
    out.numbers = check.serve_readings(cell, weights, samples, device)
    return out


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

FOLLOWED = 3     # steps the reference follows


def _followed(tr_, bs: int) -> dict:
    """``FOLLOWED`` steps through the window's own call and feed, from the
    trainer's current state: their losses and learning rates, each leaf's
    norm of the first gradient as Adam got it (from its first moment after
    one step) and of its change over the steps, by parameter name."""
    names = [n for n, _ in tr_.model.named_parameters()]
    params = [p for _, p in tr_.model.named_parameters()]
    start = [p.detach().clone() for p in params]
    b1 = tr_.state.opt.b1
    losses, lrs, grad_norms = [], [], None
    for k in range(FOLLOWED):
        lrs.append(tr_.schedule(tr_.iteration))
        losses.append(tr_.run_step(bs))
        if k == 0:
            grad_norms = torch.stack([torch.linalg.vector_norm(m) / (1.0 - b1)
                                      for m in tr_.state.opt.mu])
    change = torch.stack([torch.linalg.vector_norm(p.detach() - s)
                          for p, s in zip(params, start)])
    return {"losses": [float(v) for v in losses], "lrs": lrs,
            "grad_norms": dict(zip(names, grad_norms.tolist())),
            "change_norms": dict(zip(names, change.tolist()))}


@torch.no_grad()
def _rewind(tr_, weights, seed: int) -> None:
    """The same trainer back at the seed's start, in place (the weights,
    Adam's moments and count, both generators, the data cursor and the
    schedule), so that steps after the window repeat the first ones."""
    tr_.model.load_state_dict(weights, strict=True)
    opt = tr_.state.opt
    opt.load_state_dict({"mu": [torch.zeros_like(m) for m in opt.mu],
                         "nu": [torch.zeros_like(v) for v in opt.nu],
                         "count": 0})
    tr_.state.gen.manual_seed(derive(seed, AUG))
    tr_.state.drop_gen.manual_seed(derive(seed, DROP))
    tr_.state.step = 0
    tr_.dataset.idx_tr = 0
    tr_.iteration = 0


def run_train(cell, seed: int, seconds: float, traced: bool, device, t0: float,
              fault: Optional[Callable] = None) -> Outcome:
    mix, cfg = cell.traffic, cell.config
    bs, nb = int(mix["batch"]), int(mix["batches"])
    out = Outcome("train")
    check.train_settings(cfg)       # refuses, before set-up, what it cannot follow
    weights = weights_for(cell, seed, device)
    data = _inputs(cfg, bs * nb, seed, device)
    gens = tuple(torch.Generator(device=device).manual_seed(derive(seed, s))
                 for s in (AUG, DROP))
    tr_ = program.trainer(cfg, weights, data, gens, device)
    if fault is not None:
        fault(tr_)
    del data
    first = _followed(tr_, bs)
    tr_.run_step(bs)
    _sync(device)
    out.setup_s = time.perf_counter() - t0
    steps = 0
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        tr_.run_step(bs)
        steps += 1
    _sync(device)
    out.window_s = time.perf_counter() - start
    out.attempted, out.frames = steps, steps * bs

    def stretch():
        n, t1 = 0, time.perf_counter()
        while time.perf_counter() - t1 < TRACE_S:
            tr_.run_step(bs)
            n += 1
        return n * bs
    _traced(out, device, stretch, traced, cell)
    out.peak_bytes = _peak(device)
    # the window's object, past its steps, repeats the followed steps
    _rewind(tr_, weights, seed)
    after = _followed(tr_, bs)
    del tr_
    _free(device)
    ref = reference_steps(cell, "f32", weights, seed, bs, nb, first["lrs"],
                          device)
    firsts, afters = (check.train_numbers(f, ref) for f in (first, after))
    out.numbers = {k: max(firsts[k], afters[k]) for k in firsts}
    out.numbers.update({f"first.{k}": v for k, v in firsts.items()})
    out.numbers.update({f"after.{k}": v for k, v in afters.items()})
    return out


def reference_steps(cell, mode: str, weights, seed: int, bs: int,
                    nb: int, lrs, device) -> dict:
    """The reference over the first ``len(lrs)`` batches of the cursor
    (of ``nb``), from the seed's weights, inputs and generators, under the
    configuration's train settings."""
    x, y = _inputs(cell.config, bs * nb, seed, device)
    batches = [(x[i * bs:(i + 1) * bs], y[i * bs:(i + 1) * bs])
               for i in range(len(lrs))]
    gens = tuple(torch.Generator(device=device).manual_seed(derive(seed, s))
                 for s in (AUG, DROP))
    return check.train_reference(cell, mode, weights, batches, lrs, gens,
                                 device)


def control_numbers(cell, seed: int, device) -> Dict[str, float]:
    """The numbers the check compares, read for the control (the
    reference one precision down) against the reference, at the cell's
    size: its first three steps, or four of its device batches."""
    cfg, mix = cell.config, cell.traffic
    weights = weights_for(cell, seed, device)
    mode = check.control_mode(cfg)
    if mix["kind"] == "train":
        bs, nb = int(mix["batch"]), int(mix["batches"])
        tc = cfg["train"]
        lrs = [tc["learning_rate"] * tc["lr_values"][0]] * FOLLOWED
        ref = reference_steps(cell, "f32", weights, seed, bs, nb, lrs, device)
        ctl = reference_steps(cell, mode, weights, seed, bs, nb, lrs, device)
        return check.train_numbers(ctl, ref)
    bs = int(mix["batch"])
    x, _ = _inputs(cfg, 4 * bs, seed, device)
    frames = list(x.cpu().numpy().reshape(4, bs, *x.shape[1:]))
    del x
    _free(device)
    ref = check.reference_outputs(cell, "f32", weights, frames, device)
    ctl = check.reference_outputs(cell, mode, weights, frames, device)
    return {"prob_rms_worst": check.worst_frame_rms(ctl, ref)}


FLOWS = {"closed": run_closed, "train": run_train}

