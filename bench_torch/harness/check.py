"""What decides ``correct``: the outputs of the timed path against the plain
reference (``bench_torch/reference``), which imports nothing of the
program and makes its own weights from the seed.

Numbers compared (each against its limit in ``checks/<cell>.json``):

* serving -- ``prob_rms_worst``: over a seeded sample of the answers the
  timed path returned, the largest per-frame root-mean-square difference
  between the served probabilities and the reference's;
* training -- the first three steps, which the set-up drove through the
  window's own step and feed, and three more through the same object
  after the window, rewound in place to the seed's start, each against
  the reference's three steps from the seed (the worse of the two
  readings counts): ``loss_rel``, the largest relative gap of a step's
  loss; ``grad_norm_gap``, the worst leaf's gap between the
  norms of the first gradient as Adam received it, over the larger of
  that leaf's and the median leaf's reference norm; ``update_norm_gap``,
  the same for the norm of each leaf's change over the three steps,
  leaving out leaves whose reference gradient is under a thousandth of
  the median leaf's (Adam moves those by round-off alone).

The control is the reference itself in the precision below the one the
configuration states (:data:`CONTROL`), read against the reference.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from reference.numerics import Numerics
from reference.train import follow, train_settings

CONTROL = {"bfloat16": "fp8", "float32": "tf32"}
REF_BLOCK = 16          # frames a reference forward


def reference_model(cell, mode: str, device) -> torch.nn.Module:
    """The reference of ``cell``'s family (``reference/<family>.py``), on
    ``device`` (``meta``: shapes only, for the weight draw)."""
    cls, mcfg = cell.reference, cell.config["model"]
    if torch.device(device).type == "meta":
        with torch.device("meta"):
            return cls(mcfg, Numerics(mode))
    return cls(mcfg, Numerics(mode)).to(device)


def control_mode(cfg: dict) -> str:
    return CONTROL[cfg["model"]["compute_dtype"]]


@torch.no_grad()
def reference_outputs(cell, mode: str, weights, frames: Sequence[np.ndarray],
                      device) -> List[np.ndarray]:
    model = reference_model(cell, mode, device).eval()
    model.load_state_dict(weights, strict=True)
    out = []
    with model.nx.active():
        for x in frames:
            parts = [model(torch.from_numpy(np.ascontiguousarray(
                x[i:i + REF_BLOCK])).to(device)).cpu().numpy()
                for i in range(0, len(x), REF_BLOCK)]
            out.append(np.concatenate(parts))
    del model
    return out


def worst_frame_rms(got: Sequence[np.ndarray], want: Sequence[np.ndarray]
                    ) -> float:
    """An empty sample reads ``inf``: a window that kept no answer proves
    nothing correct."""
    if len(got) == 0:
        return float("inf")
    worst = 0.0
    for a, b in zip(got, want, strict=True):
        if a is None or a.shape != b.shape:     # never answered, or malformed
            return float("inf")
        d = (a.astype(np.float64) - b).reshape(len(a), -1)
        rms = np.sqrt(np.mean(d * d, axis=1))
        worst = max(worst, float(np.max(rms)) if np.all(np.isfinite(rms))
                    else float("inf"))
    return worst


def serve_readings(cell, weights, samples: List[Tuple[np.ndarray, np.ndarray]],
                   device, control: bool = False) -> Dict[str, float]:
    """``samples``: (frames, served probabilities).  The program's reading
    and, with ``control``, the control's."""
    frames = [x for x, _ in samples]
    ref = reference_outputs(cell, "f32", weights, frames, device)
    out = {"prob_rms_worst": worst_frame_rms([p for _, p in samples], ref)}
    if control:
        ctl = reference_outputs(cell, control_mode(cell.config), weights,
                                frames, device)
        out["control.prob_rms_worst"] = worst_frame_rms(ctl, ref)
    return out


def _gap(prog: Dict[str, float], ref: Dict[str, float],
         keep: Optional[Sequence[str]] = None) -> float:
    names = list(ref) if keep is None else list(keep)
    med = float(np.median([ref[n] for n in ref]))
    worst = 0.0
    for n in names:
        if n not in prog:
            return float("inf")
        worst = max(worst, abs(prog[n] - ref[n]) / max(ref[n], med))
    return worst


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref``: ``losses``, ``grad_norms``, ``change_norms``
    (the latter two by leaf name)."""
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(prog["losses"], ref["losses"], strict=True))
    g = ref["grad_norms"]
    med = float(np.median(list(g.values())))
    moving = [n for n, v in g.items() if v >= 1e-3 * med]
    return {"loss_rel": float(loss_rel),
            "grad_norm_gap": _gap(prog["grad_norms"], g),
            "update_norm_gap": _gap(prog["change_norms"], ref["change_norms"],
                                    moving)}


def train_reference(cell, mode: str, weights, batches, lrs,
                    gens: Tuple[torch.Generator, torch.Generator], device
                    ) -> dict:
    """The reference step under the configuration's own train settings
    (``reference.train.train_settings``, which refuses by name what it has
    no plain version of)."""
    settings = train_settings(cell.config)
    model = reference_model(cell, mode, device)
    model.load_state_dict(weights, strict=True)
    out = follow(model, batches, lrs, gens, model.nx, settings)
    del model
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, dict]]:
    """Every limit's number must be finite and at most its limit."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name, float("inf"))
        good = bool(np.isfinite(v)) and v <= limit
        ok &= good
        checks[name] = {"value": v if np.isfinite(v) else None,
                        "limit": limit}
    return ok, checks
