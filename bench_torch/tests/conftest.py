"""CPU rehearsal of the benchmark: tiny configurations of both families,
built as a checkout of their own (a ``BENCHMARK.json`` and the files under
``bench_torch/``), so that each test loads its cell from files alone."""

import copy
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

# two threads a process: under several test workers torch's default of a
# thread a core oversubscribes the CPU, and a window too slow to keep an
# answer is never correct
torch.set_num_threads(2)

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

TINY_MODEL = {
    "transunet": {"img_size": [64, 32], "radix": 2, "kpaths": 2,
                  "hidden_size": 64, "num_heads": 2, "num_layers": 1,
                  "mlp_dim": 128, "grid": [4, 2]},
    "swin": {"img_size": [64, 80], "swin_embed_dim": 32, "swin_depths": [2, 2],
             "swin_heads": [2, 4]},
}
TINY_TRAFFIC = {
    "tiny_closed": {"kind": "closed", "batch": 4, "pool_batches": 2},
    "tiny_train": {"kind": "train", "batch": 4, "batches": 4},
}
# (cell, config, traffic, limits): limits far above what a sound run reads
# on the CPU, far below what each fault reads
TINY_CELLS = [
    ("tiny_t.serve", "tiny_transunet", "tiny_closed", {"prob_rms_worst": 0.003}),
    ("tiny_s.serve", "tiny_swin", "tiny_closed", {"prob_rms_worst": 1e-5}),
    ("tiny_s.train", "tiny_swin", "tiny_train",
     {"loss_rel": 1e-5, "grad_norm_gap": 1e-5, "update_norm_gap": 1e-5}),
]


def _config(family: str) -> dict:
    cfg = json.loads((BENCH / "configs" / f"{family}.json").read_text())
    cfg["model"].update(TINY_MODEL[family])
    cfg["flops_per_frame"] = 1.0e6
    return cfg


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    """A checkout holding only test cells, from files."""
    root = tmp_path_factory.mktemp("checkout")
    base = root / "bench_torch"
    for d in ("metrics", "reference"):
        shutil.copytree(BENCH / d, base / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for d in ("configs", "traffic", "checks"):
        (base / d).mkdir(parents=True)
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    configs, cells = [], []
    for family in TINY_MODEL:
        name = f"tiny_{family}"
        (base / "configs" / f"{name}.json").write_text(json.dumps(_config(family)))
        configs.append({"name": name, "source": "test", "reduced": [],
                        "file": f"bench_torch/configs/{name}.json", "why": "test"})
    for name, mix in TINY_TRAFFIC.items():
        (base / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for cell, cfg, mix, limits in TINY_CELLS:
        (base / "checks" / f"{cell}.json").write_text(json.dumps({"limits": limits}))
        cells.append({"name": cell, "config": cfg, "traffic": mix, "chips": 1,
                      "why": "test"})
    bench = copy.deepcopy(real)
    bench.update(configs=configs, workloads=cells)
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one (run these "
        "on the card: python -m pytest bench_torch/tests -m cuda)")
