"""A model family enters the benchmark from files alone: a configuration
whose ``family`` names ``reference/<family>.py``, that file's ``MODEL``,
a mix and a check.  No harness file names a family."""

import json
import re
import shutil

import numpy as np
import pytest
import torch

from conftest import BENCH
from harness import check, drive
from harness.cell import load_cell
from harness.weights import seeded_state_dict

CPU = torch.device("cpu")

PROBE_REFERENCE = '''"""A probe family: a conv, a norm and a dense layer."""
import torch
from torch import nn

from .layers import Conv, LayerNorm, Linear, gelu


class Probe(nn.Module):
    def __init__(self, cfg, nx):
        super().__init__()
        self.nx = nx
        self.stem = Conv(nx, cfg["in_channels"], cfg["width"], 3)
        self.norm = LayerNorm(cfg["width"], 1e-3)
        self.head = Linear(nx, cfg["width"], cfg["num_classes"])

    def forward(self, x):
        return torch.softmax(self.head(gelu(self.norm(self.stem(x)))), dim=-1)


MODEL = Probe
'''

PROBE_CONFIG = {
    "family": "probe", "source": "test",
    "model": {"name": "probe", "img_size": [16, 20], "in_channels": 10,
              "num_classes": 3, "width": 8, "compute_dtype": "float32"},
    "flops_per_frame": 1.0e6,
}


def _add_family(root, family, reference=PROBE_REFERENCE):
    """New files and entries only: a configuration, its reference, a mix,
    a check and a cell."""
    base = root / "bench_torch"
    cfg = dict(PROBE_CONFIG, family=family)
    (base / "configs" / f"{family}.json").write_text(json.dumps(cfg))
    if reference is not None:
        (base / "reference" / f"{family}.py").write_text(reference)
    (base / "traffic" / "probe_closed.json").write_text(
        json.dumps({"kind": "closed", "batch": 2, "pool_batches": 2}))
    cell = f"{family}.serve"
    (base / "checks" / f"{cell}.json").write_text(
        json.dumps({"limits": {"prob_rms_worst": 1e-6}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": family, "source": "test", "reduced": [],
                             "file": f"bench_torch/configs/{family}.json",
                             "why": "test"})
    bench["workloads"].append({"name": cell, "config": family,
                               "traffic": "probe_closed", "chips": 1,
                               "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return cell


@pytest.fixture
def checkout(tiny_root, tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(tiny_root, root)
    return root


def test_a_family_enters_from_files_alone(checkout):
    cell = load_cell(checkout, _add_family(checkout, "probe"))
    assert cell.reference.__name__ == "Probe"
    shapes = check.reference_model(cell, "f32", "meta")
    weights = seeded_state_dict(shapes, drive.derive(7, drive.WEIGHTS), CPU)
    assert set(weights) == set(shapes.state_dict())
    x, _ = drive._inputs(cell.config, 4, 7, CPU)
    frames = list(x.numpy().reshape(2, 2, *x.shape[1:]))
    ref = check.reference_outputs(cell, "f32", weights, frames, CPU)
    assert ref[0].shape == (2, 16, 20, 3)
    served = [(f, p.astype(np.float32)) for f, p in zip(frames, ref)]
    assert check.serve_readings(cell, weights, served, CPU)["prob_rms_worst"] \
        < 1e-6
    altered = [(f, np.full_like(p, 1.0 / 3.0)) for f, p in served]
    assert check.serve_readings(cell, weights, altered, CPU)["prob_rms_worst"] \
        > 1e-2


def test_a_missing_reference_file_is_named(checkout):
    name = _add_family(checkout, "nofile", reference=None)
    want = checkout / "bench_torch" / "reference" / "nofile.py"
    with pytest.raises(FileNotFoundError, match=re.escape(str(want))):
        load_cell(checkout, name)


def test_a_reference_without_model_is_named(checkout):
    name = _add_family(checkout, "nomodel",
                       reference=PROBE_REFERENCE.replace("MODEL = Probe", ""))
    want = checkout / "bench_torch" / "reference" / "nomodel.py"
    with pytest.raises(LookupError, match=re.escape(str(want))):
        load_cell(checkout, name)


def test_no_harness_file_names_a_family():
    configs = [json.loads(p.read_text())["family"]
               for p in (BENCH / "configs").glob("*.json")]
    sources = [BENCH / "run.py", *sorted((BENCH / "harness").glob("*.py"))]
    for path in sources:
        text = path.read_text()
        for family in configs:
            assert f'"{family}"' not in text and f"'{family}'" not in text, \
                (path, family)
