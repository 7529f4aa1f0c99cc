"""The traced stretch of a run, read from ``torch.profiler``.

* ``busy_s``: the length of the union of the device's intervals (kernels,
  copies, fills) inside the traced window, so that overlapping kernels are
  counted once and the idle share never falls below 0;
* the device time of the kernels launched under a CPU op or an autograd
  node, its child ops' kernels included (the port launches its kernels
  from C entry points, which the profiler attaches to the innermost op):
  this reads the same work whatever implements it, and does not depend on
  kernel names;
* the breakdown: the device operations that took most time, and the
  longest idle stretches of the device by the innermost host op running
  at their middle.

Recording the host's ops slows the host several times over on a
launch-bound path (a Swin train step's ~1,300 launches), so the busy and
idle time come from a stretch traced on the device alone
(:func:`device_only`, which every run on a card makes: its frames over its
busy time are the end-to-end ``device_frames_per_s``), and the rest from a
second stretch with the host's ops (:func:`measure`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import heapq
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

MARK = "bench::traced_window"

Interval = Tuple[float, float]


def union_length(intervals: Sequence[Interval], lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` clipped to ``[lo, hi]``."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def gaps(intervals: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, end = [], lo
    for a, b in sorted(intervals):
        if a > end and a > lo:
            out.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return [(a, b) for a, b in out if b > a]


@dataclasses.dataclass
class OpCall:
    name: str
    input_shapes: list
    device_s: float


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    calls: Dict[str, List[OpCall]]

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def _device_s(ev) -> float:
    """Device seconds of the kernels under CPU event ``ev`` and its
    children."""
    us = sum(k.duration for k in ev.kernels)
    return us / 1e6 + sum(_device_s(c) for c in ev.cpu_children)


def summarize(events, ops_of_interest: Sequence[str], top: int = 10
              ) -> TraceSummary:
    """Reduce the profiler's ``events()`` of one traced window (marked by
    :data:`MARK`) to a :class:`TraceSummary`."""
    from torch.autograd import DeviceType

    # the mark is a host span; the profiler also draws it on the device's
    # timeline (a user annotation, no device work), which is left out
    mark = [e for e in events
            if e.name == MARK and e.device_type == DeviceType.CPU]
    if len(mark) != 1:
        raise RuntimeError(f"the trace holds {len(mark)} '{MARK}' marks")
    lo, hi = mark[0].time_range.start, mark[0].time_range.end
    dev, host = [], []
    per_name: Dict[str, float] = {}
    calls: Dict[str, List[OpCall]] = {n: [] for n in ops_of_interest}
    for e in events:
        if e.name == MARK:
            continue
        if e.device_type == DeviceType.CUDA:
            a, b = e.time_range.start, e.time_range.end
            dev.append((a, b))
            per_name[e.name] = per_name.get(e.name, 0.0) + (b - a) / 1e6
        else:
            host.append(e)
            if e.name in calls:
                calls[e.name].append(OpCall(e.name, list(e.input_shapes or []),
                                            _device_s(e)))
    busy_us = union_length(dev, lo, hi)
    if busy_us <= 0:
        raise RuntimeError("no device operation ran in the traced window")
    idle = _idle_by_host(gaps(dev, lo, hi), host)
    return TraceSummary(
        window_s=(hi - lo) / 1e6, busy_s=busy_us / 1e6,
        device_ops=sorted(per_name.items(), key=lambda kv: -kv[1])[:top],
        idle_gaps=sorted(idle.items(), key=lambda kv: -kv[1])[:top],
        calls=calls)


def _idle_by_host(idle: List[Interval], host) -> Dict[str, float]:
    """Idle seconds by the innermost host op running at each gap's middle
    (``host`` when none is): a sweep over the gaps in time order, holding
    the ops begun so far in a heap by start, latest first; an op that has
    ended before one middle has ended before every later one."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in host)
    heap: List[Tuple[float, float, str]] = []
    out: Dict[str, float] = {}
    i = 0
    for a, b in sorted(idle):
        mid = 0.5 * (a + b)
        while i < len(spans) and spans[i][0] <= mid:
            s, e, name = spans[i]
            heapq.heappush(heap, (-s, e, name))
            i += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        name = heap[0][2] if heap else "host"
        out[name] = out.get(name, 0.0) + (b - a) / 1e6
    return out


def device_summary(events, top: int = 10) -> Tuple[float, float, list]:
    """(window_s, busy_s, top device ops) of a stretch traced on the device
    alone: the window runs from its first device operation's start to its
    last one's end."""
    from torch.autograd import DeviceType

    dev = [(e.time_range.start, e.time_range.end, e.name) for e in events
           if e.device_type == DeviceType.CUDA and e.name != MARK]
    if not dev:
        raise RuntimeError("no device operation ran in the traced window")
    lo, hi = min(a for a, _, _ in dev), max(b for _, b, _ in dev)
    per_name: Dict[str, float] = {}
    for a, b, name in dev:
        per_name[name] = per_name.get(name, 0.0) + (b - a) / 1e6
    busy = union_length([(a, b) for a, b, _ in dev], lo, hi)
    return ((hi - lo) / 1e6, busy / 1e6,
            sorted(per_name.items(), key=lambda kv: -kv[1])[:top])


@contextlib.contextmanager
def _profiled(device, host: bool) -> Iterator[dict]:
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] if host else []
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    out: dict = {}
    with profile(activities=acts, record_shapes=host) as prof:
        if host:
            with torch.profiler.record_function(MARK):
                yield out
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
        else:
            yield out
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    out["events"] = prof.events()


def device_only(device, stretch: Callable[[], int]
                ) -> Optional[Tuple[float, float, list, int]]:
    """Run ``stretch`` traced on the device alone, which costs the host
    little: (window_s, busy_s, top device ops, the frames ``stretch``
    returns that it ran).  None where no card is."""
    if device.type != "cuda":
        return None
    with _profiled(device, host=False) as p:
        frames = stretch()
    return (*device_summary(p["events"]), frames)


def measure(device, stretch: Callable[[], int],
            ops_of_interest: Sequence[str], alone=None) -> TraceSummary:
    """The traced stretches of a ``--trace 1`` run: ``alone``, the result of
    :func:`device_only` (run here where it is not given), for the busy and
    idle time and the device's largest operations; then ``stretch`` again
    with the host's ops and their shapes recorded, which slows the host,
    for the device time of the kernels under each op of
    ``ops_of_interest`` and the host op running in each idle gap."""
    if alone is None:
        alone = device_only(device, stretch)
    window_s, busy_s, device_ops, _ = alone
    with _profiled(device, host=True) as p:
        stretch()
    host = summarize(p["events"], ops_of_interest)
    return TraceSummary(window_s=window_s, busy_s=busy_s,
                        device_ops=device_ops, idle_gaps=host.idle_gaps,
                        calls=host.calls)
