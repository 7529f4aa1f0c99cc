"""The harness driven end to end on the CPU at tiny sizes, from a checkout
of test-only files: the loader finds a cell's files by name, a sound run
is correct, every fault the check must catch makes ``correct`` false, a
``--trace 1`` line has the result line's keys, and a run without a card
prints nothing."""

import json
import subprocess
import sys
import time

import pytest
import torch

from conftest import BENCH, ROOT, TINY_CELLS
from harness import check, drive, faults, trace
from harness.cell import load_cell
from harness.report import line
from harness.drive import Outcome
from harness.trace import TraceSummary

import run

CPU = torch.device("cpu")
SEED = 2 ** 31 + 1234       # larger than 32 signed bits hold


def _run(root, name, fault=None, seconds=1.0):
    cell = load_cell(root, name)
    return run.run(cell, SEED, seconds, False, CPU, time.perf_counter(), fault)


def _host_device_only(device, stretch):
    """``trace.device_only`` where no card is: the stretch run, its host
    time standing in for the device's busy time."""
    t = time.perf_counter()
    frames = stretch()
    spent = time.perf_counter() - t
    return spent, spent, [], frames


@pytest.fixture
def stand_in_card(monkeypatch):
    monkeypatch.setattr(trace, "device_only", _host_device_only)
    monkeypatch.setattr(drive, "TRACE_S", 0.2)


def test_loader_finds_a_new_cell_mix_config_and_metric_from_files(
        tiny_root, stand_in_card):
    # one more metric, added as a file and an entry alone
    (tiny_root / "bench_torch" / "metrics" / "frames_seen.py").write_text(
        "def read(ctx):\n    return ctx.outcome.frames or None\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "frames_seen", "unit": "frames",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = load_cell(tiny_root, "tiny_t.serve")
    assert cell.config["model"]["hidden_size"] == 64
    assert cell.traffic["kind"] == "closed"
    assert set(cell.limits) == {"prob_rms_worst"}
    out = _run(tiny_root, "tiny_t.serve")
    assert out["metrics"]["frames_seen"]["value"] > 0
    assert {"device_frames_per_s", "setup_s"} <= set(out["metrics"])


@pytest.mark.parametrize("cell", [c[0] for c in TINY_CELLS])
def test_sound_run_is_correct(tiny_root, cell, stand_in_card):
    out = _run(tiny_root, cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    for c in out["checks"].values():
        assert c["value"] is not None and c["value"] <= c["limit"]
    assert out["metrics"]["device_frames_per_s"]["value"] > 0
    assert out["info"]["frames"] > 0 and out["info"]["window_s"] > 0


def test_without_a_card_the_device_rate_is_left_out(tiny_root):
    out = _run(tiny_root, "tiny_t.serve")
    assert out["correct"], out["checks"]
    assert "device_frames_per_s" not in out["metrics"]
    assert "setup_s" in out["metrics"]


FAULTS = [(cell, name) for cell, _, mix, _ in TINY_CELLS
          for name in faults.for_kind("train" if "train" in mix else "serve")]


@pytest.mark.parametrize("cell, fault", FAULTS)
def test_fault_makes_correct_false(tiny_root, cell, fault):
    kind = "train" if cell.endswith("train") else "serve"
    out = _run(tiny_root, cell, faults.for_kind(kind)[fault])
    assert not out["correct"], out["checks"]


def test_an_empty_sample_is_not_correct():
    assert check.worst_frame_rms([], []) == float("inf")


@pytest.mark.parametrize("fault", [None, "answer_altered"])
def test_a_window_that_kept_no_answer_is_not_correct(tiny_root, fault):
    # 1e-4 s ends before the window's first keep time: nothing is compared
    out = _run(tiny_root, "tiny_t.serve",
               fault and faults.for_kind("serve")[fault], seconds=1e-4)
    assert not out["correct"], out["checks"]
    assert out["checks"]["prob_rms_worst"]["value"] is None


def test_rewound_trainer_repeats_its_first_steps(tiny_root):
    # the steps after the window start again from the seed's state in
    # place: on the CPU they read exactly what the first steps read
    cell = load_cell(tiny_root, "tiny_s.train")
    out = drive.run_train(cell, SEED, 0.5, False, CPU, time.perf_counter())
    assert out.attempted > 0
    for name in cell.limits:
        assert out.numbers[f"after.{name}"] == out.numbers[f"first.{name}"]
        assert out.numbers[name] == out.numbers[f"first.{name}"]


def test_trace_line_has_the_result_keys(tiny_root):
    cell = load_cell(tiny_root, "tiny_t.serve")
    o = Outcome("closed", setup_s=3.0, window_s=2.0, frames=128, attempted=32)
    o.trace = TraceSummary(window_s=1.5, busy_s=1.2,
                           device_ops=[("k", 0.5)] * 12,
                           idle_gaps=[("host", 0.1)], calls={})
    out = line(cell, o, True, CPU, True, {"prob_rms_worst": {"value": 1e-3,
                                                              "limit": 5e-3}})
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert {"busy_s", "window_s", "platform", "kind", "count",
            "memory_peak_bytes"} <= set(out["device"])
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(out["breakdown"]["device_ops"]) <= 10
    # per-layer metrics only, none of them zero
    names = {m["name"] for m in cell.per_layer}
    assert set(out["metrics"]) <= names
    assert out["metrics"]["device_idle.serve"]["value"] == pytest.approx(20.0)
    assert out["metrics"]["mfu.serve"]["value"] > 0
    assert "k1_roofline.serve" not in out["metrics"]      # nothing to read
    json.dumps(out)


def test_run_without_a_card_exits_nonzero_and_prints_nothing(tmp_path):
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path)}
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "transunet.serve.b64", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_only_benchmark_files_without_the_program_print_nothing(tmp_path):
    (tmp_path / "BENCHMARK.json").write_text((ROOT / "BENCHMARK.json").read_text())
    subprocess.run(["cp", "-r", str(BENCH), str(tmp_path / "bench_torch")],
                   check=True)
    p = subprocess.run([sys.executable, "bench_torch/run.py", "--workload",
                        "transunet.serve.b64", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
