"""The port's spans (``utils.tracing``): off and free without a profiler;
under one, ``cli.make_forward``'s and the train step's phases as records
and as ``port::`` ranges of the trace, with every number the same as
without.  The ``cuda`` tests hold the records to the profiler's clock on
the card; this file imports no JAX, so that machine runs it on its own:

    python3 -m pytest --noconftest -q tests/test_torch_tracing.py
"""

import contextlib
import copy
import re
import statistics
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ultrasound_modeling_tpu_torch import cli
from ultrasound_modeling_tpu_torch.models import swin
from ultrasound_modeling_tpu_torch.train import losses, optim
from ultrasound_modeling_tpu_torch.train.step import TrainState, make_train_step
from ultrasound_modeling_tpu_torch.utils import tracing

torch.set_num_threads(2)

TINY = dict(num_classes=3, img_size=(32, 20), embed_dim=16, depths=(2, 2),
            num_heads=(2, 4), window=(2, 5), drop_path_rate=0.2)
SERVE = ["serve.h2d", "serve.forward", "serve.d2h"]
TRAIN = ["train.augment", "train.forward", "train.backward", "train.optim"]


@pytest.fixture(autouse=True)
def empty_records():
    tracing.clear()
    yield
    tracing.clear()


def _model():
    torch.manual_seed(3)
    return swin.SwinSegmenter(**TINY)


def _frames(b=2):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(b, 32, 20, 10)).astype(np.float32)
    y = rng.choice([0.0, 0.5, 1.0, 1.3, 2.0], size=(b, 32, 20)).astype(np.float32)
    return x, y


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _children(recs, parent):
    return [r[0] for r in recs if r[1] == parent]


def _check_tree(recs, root, names):
    """One outermost ``root`` whose children are ``names`` in order, each
    inside its parent and after the one before."""
    assert [r[0] for r in recs] == [root] + names
    (_, parent, start, end) = recs[0]
    assert parent == -1 and start <= end
    assert _children(recs, 0) == names
    t = start
    for _, _, a, b in recs[1:]:
        assert t <= a <= b <= end
        t = b


def test_span_without_a_profiler_records_nothing_and_opens_no_range(
        monkeypatch):
    def refuse(*_):
        raise AssertionError("a profiler range was opened")
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    first = tracing.span("a")
    assert tracing.span("b") is first          # one shared no-op
    with first:
        with tracing.span("c"):
            pass
    probs = cli.make_forward(_model().eval(), torch.device("cpu"))(_frames()[0])
    assert probs.shape == (2, 32, 20, 3)
    assert tracing.records() == [] and tracing.dropped() == 0


def test_make_forward_leaves_its_three_phases_under_a_profiler():
    fwd = cli.make_forward(_model().eval(), torch.device("cpu"))
    x = _frames()[0]
    with _cpu_profile() as prof:
        fwd(x)
    recs = tracing.records()
    _check_tree(recs, "serve.batch", SERVE)
    events = {e.name: e for e in prof.events()
              if e.name.startswith(tracing.PREFIX)}
    assert set(events) == {tracing.PREFIX + n for n in ["serve.batch"] + SERVE}
    batch = events["port::serve.batch"]
    assert [c.name for c in batch.cpu_children] == [
        tracing.PREFIX + n for n in SERVE]
    # the records lie on the profiler's clock: each begins after its range
    # opened (the host's time_ns against the trace's start and offsets)
    t0 = prof.profiler.kineto_results.trace_start_ns()
    for name, _, start, end in recs:
        ev = events[tracing.PREFIX + name]
        assert t0 + ev.time_range.start * 1e3 - 1e3 <= start
        assert end <= t0 + ev.time_range.end * 1e3 + 1e3


def _state(model):
    return TrainState(model, optim.Adam(model.parameters(), 1.0), 0,
                      torch.Generator().manual_seed(0),
                      torch.Generator().manual_seed(1))


def test_train_step_leaves_its_four_phases_under_a_profiler():
    model = _model()
    step = make_train_step(model, losses.cce_smooth, augment=True)
    x, y = (torch.from_numpy(a) for a in _frames())
    with _cpu_profile() as prof:
        step(_state(model), x, y, 1e-3)
    _check_tree(tracing.records(), "train.step", TRAIN)
    names = {e.name for e in prof.events()}
    assert {tracing.PREFIX + n for n in ["train.step"] + TRAIN} <= names


def test_spans_leave_every_number_as_it_was():
    """The served probabilities, the loss, the step's probabilities and the
    updated weights, bit for bit, with and without the spans recording."""
    x, y = _frames()
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    out = {}
    for traced in (False, True):
        model = _model()
        fwd = cli.make_forward(copy.deepcopy(model).eval(), torch.device("cpu"))
        step = make_train_step(model, losses.cce_smooth, augment=True)
        state = _state(model)
        with _cpu_profile() if traced else contextlib.nullcontext():
            probs = fwd(x)
            steps = [step(state, xt, yt, 1e-3) for _ in range(2)]
        out[traced] = (probs, steps, [p.detach().clone()
                                      for p in model.parameters()])
    assert tracing.records(), "the traced pass recorded nothing"
    (p0, s0, w0), (p1, s1, w1) = out[False], out[True]
    assert np.array_equal(p0, p1)
    for (l0, q0), (l1, q1) in zip(s0, s1):
        assert torch.equal(l0, l1) and torch.equal(q0, q1)
    assert all(torch.equal(a, b) for a, b in zip(w0, w1))


def test_record_cap_holds_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_RECORDS", 5)
    with _cpu_profile() as prof:
        for _ in range(4):
            with tracing.span("outer"):
                with tracing.span("inner"):
                    pass
    recs = tracing.records()
    assert [r[0] for r in recs] == ["outer", "inner"] * 2 + ["outer"]
    assert [r[1] for r in recs] == [-1, 0, -1, 2, -1]
    assert tracing.dropped() == 3
    # every span still opened its range on the trace
    ranges = [e for e in prof.events() if e.name.startswith(tracing.PREFIX)]
    assert len(ranges) == 8
    tracing.clear()
    assert tracing.records() == [] and tracing.dropped() == 0


def test_threads_recording_at_once_lose_no_record(monkeypatch):
    """More threads than cores open nested spans at once (the gate forced
    on: a profiler's state reaches only its own thread) with a short
    switch interval: every span is recorded or counted as dropped, and
    each inner record's parent is an outer record of its own thread."""
    import sys
    import threading

    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        lambda name: contextlib.nullcontext())
    monkeypatch.setattr(tracing, "MAX_RECORDS", 3000)
    n_threads, n = 8, 250

    def work(k):
        for _ in range(n):
            with tracing.span(f"outer{k}"):
                with tracing.span(f"inner{k}"):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    recs = tracing.records()
    assert len(recs) == 3000
    assert len(recs) + tracing.dropped() == 2 * n_threads * n
    for name, parent, start, end in recs:
        assert end is not None and start <= end
        if name.startswith("inner"):
            assert parent < 0 or recs[parent][0] == "outer" + name[5:]
        else:
            assert parent == -1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _conv_model(device):
    torch.manual_seed(0)
    conv = torch.nn.Conv2d(10, 3, 3, padding=1).to(device)
    return lambda x: torch.softmax(conv(x.permute(0, 3, 1, 2)), 1
                                   ).permute(0, 2, 3, 1)


@pytest.mark.cuda
def test_records_share_the_profilers_clock_on_the_card(cuda):
    """time.time_ns() is the profiler's host clock: each record begins
    within 50 us of its range's absolute start; the ranges are host events
    only, never drawn on the device's timeline."""
    from torch.autograd import DeviceType

    fwd = cli.make_forward(_conv_model(cuda), cuda)
    x = np.random.default_rng(0).normal(size=(64, 256, 80, 10)).astype(np.float32)
    fwd(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fwd(x)
    recs = tracing.records()
    _check_tree(recs, "serve.batch", SERVE)
    t0 = prof.profiler.kineto_results.trace_start_ns()
    port = [e for e in prof.events() if e.name.startswith(tracing.PREFIX)]
    assert all(e.device_type == DeviceType.CPU for e in port)
    host = {e.name: e for e in port}
    for name, _, start, _ in recs:
        ev_start = t0 + host[tracing.PREFIX + name].time_range.start * 1e3
        print(f"{name}: record - range start {(start - ev_start) / 1e3:.2f} us")
        assert abs(start - ev_start) <= 50e3


@pytest.mark.cuda
def test_records_are_kept_under_a_device_only_profiler(cuda):
    """A profile of the device alone (the stretch the host-clock metrics
    read) turns the spans on: ``_profiler_enabled()`` is true under it."""
    fwd = cli.make_forward(_conv_model(cuda), cuda)
    x = np.zeros((4, 256, 80, 10), np.float32)
    with profile(activities=[ProfilerActivity.CUDA]):
        assert torch.autograd._profiler_enabled()
        fwd(x)
    _check_tree(tracing.records(), "serve.batch", SERVE)


@pytest.mark.cuda
def test_span_cost_on_the_card_host(cuda, monkeypatch):
    """ns a span costs, entered and left 10^6 times: with no profiler
    (under 1 us) and under the device-only profiler (recording)."""
    n = 10 ** 6

    def cost():
        t = time.perf_counter_ns()
        for _ in range(n):
            with tracing.span("x"):
                pass
        return (time.perf_counter_ns() - t) / n

    off = cost()
    monkeypatch.setattr(tracing, "MAX_RECORDS", n)
    with profile(activities=[ProfilerActivity.CUDA]):
        on = cost()
    print(f"span ns: no profiler {off:.1f}, device-only profiler {on:.1f}")
    assert len(tracing.records()) == n
    assert off < 1000


def _host_us(fn, n):
    """Host us a call of ``fn`` takes to return, over ``n`` calls."""
    torch.cuda.synchronize()
    t = time.perf_counter_ns()
    for _ in range(n):
        fn()
    host = time.perf_counter_ns() - t
    torch.cuda.synchronize()
    return host / n / 1e3


def _profiler_costs(fn, n=3 * 10 ** 4, rounds=5):
    """Host us a call of ``fn`` takes with no profiler, under the
    device-only profiler (the stretch the host-clock span metrics read)
    and under the host-op profiler with shapes (the benchmark's second
    stretch): the least of ``rounds`` rounds of the three in turn."""
    _host_us(fn, n)
    off, dev, host = [], [], []
    for _ in range(rounds):
        off.append(_host_us(fn, n))
        with profile(activities=[ProfilerActivity.CUDA]):
            dev.append(_host_us(fn, n))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True):
            host.append(_host_us(fn, n))
    return min(off), min(dev), min(host)


@pytest.mark.cuda
def test_device_only_profiler_cost_a_launch(cuda):
    """Host us a kernel launch takes (a small add) with no profiler, under
    the device-only profiler and under the host-op profiler: the
    host-clock span metrics are read under the device-only one, whose
    activity records cost each launch more than no profiler, so a
    launch-bound phase carries that cost beyond an unprofiled window."""
    x = torch.zeros(1024, device=cuda)
    off, dev, host = _profiler_costs(lambda: x.add_(1.0))
    print(f"launch us: no profiler {off:.2f}, device-only profiler {dev:.2f}, "
          f"host-op profiler {host:.2f}")
    assert off < dev


@pytest.mark.cuda
def test_device_only_profiler_cost_an_op(cuda):
    """Host us an op that launches nothing (``x.view(-1)``) takes with no
    profiler, under the device-only profiler and under the
    host-op profiler: the device-only profiler still calls its hooks on
    every op, so a phase carries its cost per op, ops that launch nothing
    included; it has to cost less than the host-op profiler, which also
    records each op."""
    x = torch.zeros(1024, device=cuda)
    off, dev, host = _profiler_costs(lambda: x.view(-1))
    print(f"op us: no profiler {off:.2f}, device-only profiler {dev:.2f}, "
          f"host-op profiler {host:.2f}")
    assert dev < host


def _is_runtime(name: str) -> bool:
    """A CUDA runtime or driver call (``cudaLaunchKernel``,
    ``cuLaunchKernel``, ``cudaMemcpyAsync``, ...), not an op."""
    return re.match(r"cu(da)?[A-Z]", name) is not None


@pytest.mark.cuda
def test_train_phases_carry_the_device_only_profilers_cost(cuda):
    """The Swin's f32 train step at batch 32 (``profiling``'s
    ``swin:train-f32-k4``: the step of the benchmark's ``swin.train.b32``):
    the phases' medians under the device-only profiler, the ops and
    launches each phase runs (under the host-op profiler, by time, so
    autograd's thread counts in ``train.backward``), and those counts
    times that profiler's cost an op and a launch, beside the unprofiled
    step's wall.  The phases read under the profiler; the counts say how
    much of their excess over the wall is its cost."""
    from torch.autograd import DeviceType

    from ultrasound_modeling_tpu_torch import profiling
    from ultrasound_modeling_tpu_torch.models.common import full_f32_matmuls

    full_f32_matmuls()
    step, _ = profiling._cell_fn("swin", "train-f32-k4", cuda)
    for _ in range(3):
        step()

    def wall_ms(n=10):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / n * 1e3

    rounds, off, dev, recs = 3, [], [], []
    for _ in range(rounds):
        off.append(wall_ms())
        tracing.clear()
        with profile(activities=[ProfilerActivity.CUDA]):
            dev.append(wall_ms())
        recs += tracing.records()
    assert [r[0] for r in recs] == (["train.step"] + TRAIN) * 10 * rounds
    med = {name: statistics.median((b - a) / 1e6 for m, _, a, b in recs
                                   if m == name)
           for name in ["train.step"] + TRAIN}
    wall, wall_dev = statistics.median(off), statistics.median(dev)

    reps = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    host = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    phases = [(e.name[len(tracing.PREFIX):], e.time_range.start,
               e.time_range.end) for e in host
              if e.name[len(tracing.PREFIX):] in TRAIN]
    assert len(phases) == len(TRAIN) * reps
    ops, launches = dict.fromkeys(TRAIN, 0), dict.fromkeys(TRAIN, 0)
    for e in host:
        if e.name.startswith(tracing.PREFIX):
            continue
        at = e.time_range.start
        for name, a, b in phases:
            if a <= at <= b:
                if not _is_runtime(e.name):
                    ops[name] += 1
                elif "Launch" in e.name:
                    launches[name] += 1
                break

    x = torch.zeros(1024, device=cuda)
    op_off, op_dev, _ = _profiler_costs(lambda: x.view(-1))
    add_off, add_dev, _ = _profiler_costs(lambda: x.add_(1.0))
    per_op = op_dev - op_off                        # us
    per_launch = (add_dev - add_off) - per_op
    print(f"step wall ms, rounds in turn: no profiler "
          f"{', '.join(f'{v:.2f}' for v in off)}; device-only profiler "
          f"{', '.join(f'{v:.2f}' for v in dev)}; median slowdown "
          f"{wall_dev - wall:.2f} ms; train.step median {med['train.step']:.2f}")
    print(f"device-only profiler: {per_op:.2f} us an op ({op_off:.2f} -> "
          f"{op_dev:.2f}), {per_launch:.2f} us more a launch ({add_off:.2f} "
          f"-> {add_dev:.2f} a launching op)")
    total = cost_total = 0.0
    for name in TRAIN:
        o, k = ops[name] / reps, launches[name] / reps
        cost = (o * per_op + k * per_launch) / 1e3
        total += med[name]
        cost_total += cost
        print(f"{name}: median {med[name]:.2f} ms, {o:.0f} ops, {k:.0f} "
              f"launches, profiler {cost:.2f} ms, less it "
              f"{med[name] - cost:.2f} ms ({med[name] / wall:.1%} of the wall)")
        assert ops[name] >= launches[name] > 0
    print(f"phases {total:.2f} ms = {total / wall:.3f} of the unprofiled "
          f"wall; ops and launches times their cost {cost_total:.2f} ms of "
          f"the {wall_dev - wall:.2f} ms slowdown; phases less it "
          f"{total - cost_total:.2f} ms = {(total - cost_total) / wall:.3f}")
