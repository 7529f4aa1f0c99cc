"""The cell ``vit.train.b8`` and its readers: the loader finds its files,
its trace reads K3's two records and the span ``attention.train``, the K3
readers' bounds at the cell's shapes are the hand-computed ones, each
reader reads nothing from a trace without its op, and a tiny ViT cell runs
correct through the train flow and prints the three metrics in a
``--trace 1`` rehearsal on the CPU."""

import json
import math
import shutil
import time

import pytest
import torch

from conftest import ROOT
from harness import drive, trace
from harness.cell import load_cell, load_metric
from harness.drive import Outcome
from harness.report import Context
from harness.trace import OpCall, TraceSummary
from test_spans import _cpu_measure

import run

CPU = torch.device("cpu")
SEED = 2 ** 31 + 1919
CELL = "vit.train.b8"
K3 = ("k3_roofline.train", "FlashMHA")
K3B = ("k3b_roofline.train", "FlashMHABackward")
SPAN = ("attention_device_ms.train", "port::attention.train")
NEW = dict([K3, K3B, SPAN])

# b8, N 160, C 1280, h 8, float32: the forward reads qkv [1280, 3840] and
# writes the context [1280, 1280] and the LSE [8, 8, 160]; the backward
# reads qkv, the LSE and the context gradient and writes dqkv [1280, 3840]
FWD_BYTES = 1280 * 3840 * 4 + 1280 * 1280 * 4 + 8 * 8 * 160 * 4   # 26,255,360
BWD_BYTES = 2 * 1280 * 3840 * 4 + 1280 * 1280 * 4 + 8 * 8 * 160 * 4
ONE = 2 * 8 * 8 * 160 * 160 * 160        # one product of every (b, head)
FWD_S = max(2 * ONE / 495e12, FWD_BYTES / 3.35e12)      # 7.8374 us, bytes
BWD_S = max(5 * ONE / 495e12, BWD_BYTES / 3.35e12)      # 13.706 us, bytes


@pytest.fixture(scope="module")
def cell():
    return load_cell(ROOT, CELL)


def _ctx(cell, calls, kind="train"):
    o = Outcome(kind)
    o.trace = TraceSummary(window_s=2.0, busy_s=1.5, device_ops=[],
                           idle_gaps=[], calls=calls)
    return Context(cell, o)


def test_loader_finds_every_file(cell):
    assert cell.config["family"] == "vit"
    assert cell.config["model"]["attn_train_impl"] == "flash"
    assert cell.traffic == {"kind": "train", "batch": 8, "batches": 8}
    assert set(cell.limits) == {"loss_rel", "grad_norm_gap", "update_norm_gap"}
    assert cell.reference.__name__ == "ViTSegmenter"
    assert cell.chips == 1
    assert {m["name"] for m in cell.end_to_end} == {
        "device_frames_per_s", "peak_mem_mib", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "window_frames_per_s.train", "mfu.train", "device_idle.train",
        "augment_ms.train", "forward_ms.train", "backward_ms.train",
        "optim_ms.train", *NEW}


def test_trace_reads_k3s_two_records_and_the_span(cell):
    assert set(NEW.values()) <= set(cell.trace_ops())


def test_k3_forward_bound_at_the_cells_shapes(cell):
    bound = load_metric(ROOT, K3[0]).bound
    recorded = [[1280, 3840], [], [], []]     # qkv, where torch records it
    assert bound(recorded, _ctx(cell, {})) == pytest.approx(FWD_S, rel=1e-12)
    assert bound([], _ctx(cell, {})) == pytest.approx(FWD_S, rel=1e-12)
    assert FWD_S == pytest.approx(7.8374e-6, rel=1e-4)


def test_k3_backward_bound_at_the_cells_shapes(cell):
    bound = load_metric(ROOT, K3B[0]).bound
    assert bound([[1280, 1280]], _ctx(cell, {})) == pytest.approx(BWD_S,
                                                                  rel=1e-12)
    assert bound([], _ctx(cell, {})) == pytest.approx(BWD_S, rel=1e-12)
    assert BWD_S == pytest.approx(13.706e-6, rel=1e-4)


@pytest.mark.parametrize("metric, op, shapes, bound_s", [
    (*K3, [], FWD_S), (*K3B, [[1280, 1280]], BWD_S)])
def test_roofline_is_the_bound_over_the_device_time(cell, metric, op, shapes,
                                                    bound_s):
    calls = {op: [OpCall(op, shapes, 10 * bound_s)] * 16}
    got = load_metric(ROOT, metric).read(_ctx(cell, calls))
    assert got == pytest.approx(10.0)


def test_attention_device_ms_is_the_mean_a_call(cell):
    op = SPAN[1]
    calls = {op: [OpCall(op, [], 1e-3), OpCall(op, [], 3e-3)]}
    assert load_metric(ROOT, SPAN[0]).read(_ctx(cell, calls)) == \
        pytest.approx(2.0)


@pytest.mark.parametrize("metric", sorted(NEW))
def test_each_reads_nothing_without_its_op(cell, metric):
    read = load_metric(ROOT, metric).read
    assert read(Context(cell, Outcome("train"))) is None        # --trace 0
    assert read(_ctx(cell, {})) is None
    other = {"WindowAttentionFusedBackward": [OpCall("w", [[64, 20, 96]], 1.0)]}
    assert read(_ctx(cell, other)) is None


TINY_VIT = {"img_size": [32, 16], "vit_grid": [4, 4], "vit_hidden": 64,
            "vit_heads": 4, "vit_layers": 2, "mlp_dim": 128}


@pytest.fixture
def tiny_vit_root(tiny_root, tmp_path):
    """The tiny checkout with a tiny ViT train cell added as files."""
    root = tmp_path / "checkout"
    shutil.copytree(tiny_root, root)
    base = root / "bench_torch"
    cfg = json.loads((ROOT / "bench_torch" / "configs" / "vit.json").read_text())
    cfg["model"].update(TINY_VIT)
    cfg["flops_per_frame"] = 1.0e6
    (base / "configs" / "tiny_vit.json").write_text(json.dumps(cfg))
    (base / "checks" / "tiny_v.train.json").write_text(json.dumps(
        {"limits": {"loss_rel": 2e-6, "grad_norm_gap": 5e-6,
                    "update_norm_gap": 5e-5}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_vit", "source": "test",
                             "reduced": [], "why": "test",
                             "file": "bench_torch/configs/tiny_vit.json"})
    bench["workloads"].append({"name": "tiny_v.train", "config": "tiny_vit",
                               "traffic": "tiny_train", "chips": 1,
                               "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_tiny_vit_cell_rehearses_the_trace(tiny_vit_root, monkeypatch):
    from ultrasound_modeling_tpu_torch.utils import tracing

    monkeypatch.setattr(trace, "measure", _cpu_measure)
    monkeypatch.setattr(drive, "TRACE_S", 0.5)
    tracing.clear()
    c = load_cell(tiny_vit_root, "tiny_v.train")
    out = run.run(c, SEED, 0.3, True, CPU, time.perf_counter())
    tracing.clear()
    assert out["correct"], out["checks"]
    got = out["metrics"]
    for name in NEW:
        assert math.isfinite(got[name]["value"]) and got[name]["value"] > 0, name
