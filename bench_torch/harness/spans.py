"""Arithmetic of the readers of the program's own spans
(``ultrasound_modeling_tpu_torch.utils.tracing``): the host-clock medians
of one span over the first traced stretch, and the device time of the
kernels launched under a span.

The spans record only while a profiler runs, so a ``--trace 1`` run holds
the records of its two stretches (:func:`harness.trace.measure`).  The
first is traced on the device alone; the second also records the host's
ops, which slows the host several times over.  The host-clock readers take
the first: the records whose outermost span began within
:data:`harness.drive.TRACE_S` of the first record's start.  That profiler
still costs the host a hook on every op and an activity record on every
launch, so a phase reads longer there than in the untraced window.  A program
without the spans, or whose record list dropped spans, leaves nothing to
read, and the readers return None.
"""

from __future__ import annotations

import statistics
from typing import List, Optional, Sequence

from . import drive


def program_records() -> list:
    """The program's span records, ``(name, parent, start_ns, end_ns)``;
    none where the program has no spans, and none where its list reached
    its cap and dropped spans (``tracing.dropped()``), so that a truncated
    list is never read as a median."""
    try:
        from ultrasound_modeling_tpu_torch.utils import tracing
    except ImportError:
        return []
    recs = tracing.records()
    return [] if tracing.dropped() else recs


def first_stretch(records: Sequence[tuple], stretch_s: float) -> List[tuple]:
    """The records whose outermost span began within ``stretch_s`` seconds
    of the first record's start."""
    if not records:
        return []
    roots = []
    for name, parent, start, end in records:
        roots.append(start if parent < 0 else roots[parent])
    t0 = min(roots)
    return [r for r, root in zip(records, roots)
            if root - t0 < stretch_s * 1e9]


def median_ms(records: Sequence[tuple], name: str) -> Optional[float]:
    """Median host ms of the closed spans named ``name``."""
    ms = [(end - start) / 1e6 for n, _, start, end in records
          if n == name and end is not None]
    return statistics.median(ms) if ms else None


def host_ms(ctx, kind: str, name: str) -> Optional[float]:
    """Median host ms of span ``name`` over a traced run's first stretch."""
    if ctx.trace is None or ctx.outcome.kind != kind:
        return None
    return median_ms(first_stretch(program_records(), drive.TRACE_S), name)


def device_ms(ctx, kind: str, op: str) -> Optional[float]:
    """Mean device ms, a call, of the kernels launched under host op (or
    span range) ``op`` over the host-traced stretch."""
    tr = ctx.trace
    if tr is None or ctx.outcome.kind != kind or not tr.calls.get(op):
        return None
    calls = tr.calls[op]
    return 1e3 * sum(c.device_s for c in calls) / len(calls)
