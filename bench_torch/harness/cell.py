"""A cell and the files it is made of, found by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic mix; the rest lives in files of their own under the
benchmark's folder, so that a new cell, mix, configuration or metric is
new files and new entries, never an edit:

* ``configs/<config>.json``  -- the configuration as it is run (the file
  ``BENCHMARK.json`` gives); its ``family`` names the reference;
* ``reference/<family>.py``  -- the family's plain reference model, named
  ``MODEL`` in the file and built as ``MODEL(cfg["model"], numerics)``; a
  train cell's reference step (``reference/train.py``) follows the
  configuration's ``train`` settings and refuses those it has no plain
  version of;
* ``traffic/<mix>.json``     -- the mix's parameters, read by the one
  generator in :mod:`harness.traffic`;
* ``checks/<cell>.json``     -- each number the correctness check compares
  and its limit;
* ``metrics/<metric>.py``    -- one metric's reader, a function
  ``read(ctx)`` that returns a number or None (and, for a reader of the
  kernels under a host op, that op's name as ``OP``).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

import reference  # noqa: F401  (the package a reference file's imports resolve in)

BENCH_DIR = "bench_torch"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path
    reference: type             # the family's plain reference model

    def reader(self, metric: str) -> Callable:
        return load_metric(self.root, metric).read

    def trace_ops(self) -> List[str]:
        """The host ops (or autograd nodes) whose kernels this cell's
        per-layer readers read: each reader names its own as ``OP``."""
        ops = (getattr(load_metric(self.root, m["name"]), "OP", None)
               for m in self.per_layer)
        return sorted({op for op in ops if op})


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root / BENCHMARK.json`` with its files."""
    root = Path(root)
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{sorted(cells)}")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    base = root / BENCH_DIR
    config = _json(root / cfg_entry["file"])
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config=config,
        traffic_name=w["traffic"],
        traffic=_json(base / "traffic" / f"{w['traffic']}.json"),
        limits=_json(base / "checks" / f"{name}.json")["limits"],
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)],
        root=root, reference=load_reference(root, config["family"]))


def load_reference(root: Path, family: str) -> type:
    """``reference/<family>.py``'s ``MODEL``.  The file is a module of the
    ``reference`` package, so that it imports the shared layers as
    ``from .layers import ...``."""
    path = Path(root) / BENCH_DIR / "reference" / f"{family}.py"
    if not path.is_file():
        raise FileNotFoundError(
            f"no plain reference for family {family!r}: expected {path}")
    spec = importlib.util.spec_from_file_location(f"reference.{family}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not hasattr(mod, "MODEL"):
        raise LookupError(f"{path} names no MODEL (the family's reference "
                          f"model class)")
    return mod.MODEL


def load_metric(root: Path, metric: str) -> ModuleType:
    """``metrics/<metric>.py``: its ``read(ctx)`` returns the metric or
    None, and a reader of a trace names the op it reads as ``OP``."""
    path = Path(root) / BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
