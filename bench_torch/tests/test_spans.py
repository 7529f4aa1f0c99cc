"""The readers of the program's spans: the first traced stretch picked by
the ``TRACE_S`` rule and its medians, a gap of the device under a span
named by that span, and a ``--trace 1`` rehearsal of the tiny cells on
the CPU that prints each span metric where it applies."""

import math
import time

import pytest
import torch

from conftest import TINY_CELLS
from harness import drive, spans, trace
from harness.cell import load_cell
from test_metrics import _Ev

import run

CPU = torch.device("cpu")
SEED = 2 ** 31 + 77

SERVE = {"h2d_ms.serve", "enqueue_ms.serve", "d2h_ms.serve",
         "forward_device_ms.serve"}
TRAIN = {"augment_ms.train", "forward_ms.train", "backward_ms.train",
         "optim_ms.train"}


def _stretch(t0, n, scale):
    """``n`` steps from ``t0`` ns, each a ``train.step`` of 10 * scale ms
    with the children ``a`` (2) and ``b`` (8); returns records whose
    parents count from 0."""
    out, t = [], t0
    for _ in range(n):
        root = len(out)
        out.append(("train.step", -1, t, t + 10 * scale * 10 ** 6))
        out.append(("a", root, t, t + 2 * scale * 10 ** 6))
        out.append(("b", root, t + 2 * scale * 10 ** 6, t + 10 * scale * 10 ** 6))
        t += 10 * scale * 10 ** 6
    return out


def test_first_stretch_and_its_medians_from_two_stretches():
    first = _stretch(10 ** 18, 200, 1)             # 2 s of 10 ms steps
    t1 = first[-1][3] + 3 * 10 ** 9                 # the second, 3 s later
    second = [(n, p + len(first) if p >= 0 else -1, a, b)
              for n, p, a, b in _stretch(t1, 40, 5)]   # 5x slower
    recs = first + second
    picked = spans.first_stretch(recs, 2.0)
    assert picked == first
    assert spans.median_ms(picked, "train.step") == pytest.approx(10.0)
    assert spans.median_ms(picked, "a") == pytest.approx(2.0)
    assert spans.median_ms(picked, "b") == pytest.approx(8.0)
    assert spans.median_ms(second, "b") == pytest.approx(40.0)
    assert spans.median_ms(picked, "c") is None
    assert spans.first_stretch([], 2.0) == []
    # an open span (no end yet) is left out of a median
    assert spans.median_ms([("a", -1, 0, None), ("a", -1, 0, 10 ** 6)],
                           "a") == pytest.approx(1.0)


def test_a_list_that_dropped_spans_is_not_read(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    from ultrasound_modeling_tpu_torch.utils import tracing

    tracing.clear()
    monkeypatch.setattr(tracing, "MAX_RECORDS", 4)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(2):
                with tracing.span("train.step"):
                    with tracing.span("a"):
                        pass
        assert len(spans.program_records()) == 4 and tracing.dropped() == 0
        with profile(activities=[ProfilerActivity.CPU]):
            with tracing.span("train.step"):
                pass
        assert tracing.dropped() == 1 and len(tracing.records()) == 4
        assert spans.program_records() == []
    finally:
        tracing.clear()


def test_a_gap_under_a_span_alone_is_filed_under_the_span():
    events = [
        _Ev(trace.MARK, 0, 100, False),
        _Ev("port::serve.forward", 10, 50, False),
        _Ev("aten::empty", 31, 33, False),
        _Ev("k1", 0, 20, True), _Ev("k2", 40, 45, True),
        _Ev("k3", 70, 100, True),
    ]
    idle = dict(trace.summarize(events, []).idle_gaps)
    assert idle["port::serve.forward"] == pytest.approx(20e-6)   # 20..40
    assert idle["host"] == pytest.approx(25e-6)                  # 45..70


def _cpu_measure(device, stretch, ops_of_interest, alone=None):
    """``trace.measure`` where no card is: the stretch run twice under a
    profiler of the host (the spans record in both), the ops of interest
    read from the second with each call's host time standing in for its
    kernels' device time."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            stretch()
    calls = {op: [trace.OpCall(e.name, [], (e.time_range.end
                                            - e.time_range.start) / 1e6)
                  for e in prof.events() if e.name == op]
             for op in ops_of_interest}
    return trace.TraceSummary(window_s=1.0, busy_s=0.5, device_ops=[],
                              idle_gaps=[], calls=calls)


@pytest.mark.parametrize("cell", [c[0] for c in TINY_CELLS])
def test_trace_rehearsal_prints_the_span_metrics(tiny_root, cell, monkeypatch):
    from ultrasound_modeling_tpu_torch.utils import tracing

    monkeypatch.setattr(trace, "measure", _cpu_measure)
    monkeypatch.setattr(drive, "TRACE_S", 0.5)
    tracing.clear()
    c = load_cell(tiny_root, cell)
    assert "port::serve.forward" in c.trace_ops()
    out = run.run(c, SEED, 0.3, True, CPU, time.perf_counter())
    tracing.clear()
    assert out["correct"], out["checks"]
    want, other = (TRAIN, SERVE) if c.traffic["kind"] == "train" else (SERVE,
                                                                       TRAIN)
    got = out["metrics"]
    assert want <= set(got) and not other & set(got)
    for name in want:
        v = got[name]["value"]
        assert math.isfinite(v) and v > 0, name
        assert got[name]["unit"] == "ms"
