"""The reductions the benchmark's metrics rest on: the device's busy time
as a union of intervals, and the work counters against ``chip_smoke.py``'s."""

import importlib.util
import math

import pytest

from conftest import ROOT
from harness import readers, trace, work
from harness.drive import Outcome
from harness.report import Context


@pytest.mark.parametrize("intervals, busy, gap_total", [
    ([(0, 10), (20, 30)], 20, 80),
    ([(0, 10), (5, 15), (12, 18)], 18, 82),          # overlapping kernels
    ([(0, 100), (10, 20), (30, 40)], 100, 0),        # nested: never above 1
    ([(-5, 5), (95, 120)], 10, 90),                  # clipped to the window
])
def test_busy_is_the_union_of_device_intervals(intervals, busy, gap_total):
    assert trace.union_length(intervals, 0, 100) == pytest.approx(busy)
    gaps = trace.gaps(intervals, 0, 100)
    assert sum(b - a for a, b in gaps) == pytest.approx(gap_total)
    assert 1 - busy / 100 >= 0


@pytest.mark.parametrize("frames, busy, rate", [
    (640, 0.25, 2560.0), (320, 0.5, 640.0),
    (0, 0.0, None),                          # no stretch traced on a card
])
def test_device_rate_is_frames_over_the_busy_time(frames, busy, rate):
    o = Outcome("closed", window_s=51.0, frames=99_000, card_frames=frames,
                card_busy_s=busy)
    got = readers.device_frames_per_s(Context(None, o))
    assert got == (rate if rate is None else pytest.approx(rate))


class _Ev:
    def __init__(self, name, a, b, dev, kernels=(), children=(), shapes=()):
        from torch.autograd import DeviceType
        self.name = name
        self.time_range = type("R", (), {"start": a, "end": b})()
        self.device_type = DeviceType.CUDA if dev else DeviceType.CPU
        self.kernels = [type("K", (), {"duration": d})() for d in kernels]
        self.cpu_children = list(children)
        self.input_shapes = list(shapes)


def test_summary_attributes_kernels_to_ops_and_names_idle_gaps():
    op = "ultrasound_port::transformer_block"
    child = _Ev("aten::mm", 12, 14, False, kernels=[3.0])
    events = [
        _Ev(trace.MARK, 0, 100, False),
        _Ev(trace.MARK, 0, 100, True),        # the device-side annotation
        _Ev(op, 10, 20, False, kernels=[4.0], children=[child],
            shapes=[[64, 80, 512]]),
        child,
        _Ev("k1", 10, 30, True), _Ev("k2", 25, 40, True),
        _Ev("aten::copy_", 50, 90, False),
        _Ev("memcpy", 90, 95, True),
    ]
    s = trace.summarize(events, [op])
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(35e-6)
    assert s.calls[op][0].device_s == pytest.approx(7e-6)
    assert s.calls[op][0].input_shapes == [[64, 80, 512]]
    idle = dict(s.idle_gaps)
    assert idle["aten::copy_"] == pytest.approx(50e-6)
    assert idle["host"] == pytest.approx(15e-6)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("fn, args", [
    ("block_ops", (64, 80, 512, 4, 2048)),
    ("window_ops", (4096, 20, 96, 3)),
    ("window_ops", (64, 9, 768, 24)),
    ("window_bwd_ops", (2048, 20, 96, 3)),
    ("window_bwd_ops", (512, 20, 384, 12)),
])
def test_operation_counts_match_chip_smoke(fn, args):
    cs = _chip_smoke()
    mine = [o for o, _ in getattr(work, fn)(*args)]
    theirs = [o for o, _ in getattr(cs, fn)(*args)]
    assert mine == theirs


def test_peaks_are_the_published_ones():
    # a product is held to its operand type's tensor-core peak, never to a
    # peak derived from one recipe (chip_smoke's 3xTF32 495e12 / 3)
    ops = work.window_ops(4096, 20, 96, 3)
    assert {p for _, p in ops} == {495e12}
    assert {p for _, p in work.block_ops(64, 80, 512, 4, 2048)} == {989e12}
    t = work.bound_s([(989e12, 989e12)], 0.0)
    assert t == pytest.approx(1.0)
    assert work.bound_s([(1.0, 989e12)], 3.35e12) == pytest.approx(1.0)
    assert math.isclose(work.HBM_BYTES_S, 3.35e12)
