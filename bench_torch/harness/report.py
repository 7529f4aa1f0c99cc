"""The result of a run: the metrics its cell asks for, read by each
metric's reader from the run's :class:`~harness.drive.Outcome`, the device,
the breakdown of a traced run and the numbers the check compared."""

from __future__ import annotations

import dataclasses
import subprocess
from typing import Optional

from .drive import Outcome

BREAKDOWN_TOP = 10      # entries a breakdown list of the result line holds


@dataclasses.dataclass
class Context:
    """What a metric reader sees."""
    cell: object
    outcome: Outcome

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def trace(self):
        return self.outcome.trace


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def device_info(device, outcome: Outcome, traced: bool) -> dict:
    import torch
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                     else "cpu"),
            "count": 1, "memory_peak_bytes": int(outcome.peak_bytes)}
    if device.type == "cuda":
        info["power_limit_w"] = power_limit_w()
    if traced and outcome.trace is not None:
        info["busy_s"] = outcome.trace.busy_s
        info["window_s"] = outcome.trace.window_s
    return info


def metrics(cell, outcome: Outcome, traced: bool) -> dict:
    ctx = Context(cell, outcome)
    out = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = cell.reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def line(cell, outcome: Outcome, traced: bool, device, correct: bool,
         checks: dict) -> dict:
    out = {"correct": bool(correct), "attempted": int(outcome.attempted),
           "failed": int(outcome.failed),
           "metrics": metrics(cell, outcome, traced),
           "device": device_info(device, outcome, traced)}
    if traced and outcome.trace is not None:
        out["breakdown"] = {
            k: [list(kv) for kv in getattr(outcome.trace, k)][:BREAKDOWN_TOP]
            for k in ("device_ops", "idle_gaps")}
    info = {"setup_s": outcome.setup_s, "window_s": outcome.window_s,
            "frames": outcome.frames}
    out["info"] = info
    out["checks"] = checks          # last: the numbers compared, by their limits
    return out
