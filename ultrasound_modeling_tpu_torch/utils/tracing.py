"""Spans of the port's host work, on ``torch.profiler``'s clock.

    with span("serve.h2d"):
        ...

marks one phase of a layer.  A running profiler is what turns the spans
on; there is no other switch:

* with no profiler running, ``span`` checks
  ``torch.autograd._profiler_enabled()`` and returns one shared no-op
  context: it opens no profiler range and records nothing;
* under a running profiler it opens the range ``port::<name>`` on the
  profiler's timeline, so that a trace shows each device gap and kernel
  inside the phase the host was in, and appends the record
  ``(name, parent, start_ns, end_ns)`` to a list in memory: ``parent`` is
  the index of the enclosing span's record in :func:`records` (-1 for an
  outermost span), and the times are ``time.time_ns()``, the wall clock
  the profiler stamps its host events with (an event's absolute start is
  the trace's ``trace_start_ns()`` plus its offset).

The range is a function-scope one (``torch._C._profiler._RecordFunctionFast``,
as torch marks its compiled graphs), not a user annotation
(``torch.profiler.record_function``): the profiler draws a user
annotation on the device's timeline too, as one interval from the first to
the last kernel launched inside it, and a reader that takes the union of
the device's intervals as its busy time would count every gap inside a
span as busy.

The list keeps the first :data:`MAX_RECORDS` records since the last
:func:`clear`, then counts the spans it drops (:func:`dropped`): a
non-zero count says the list is truncated, and its readers (the
benchmark's span metrics) then read nothing from it.  A profiler's state reaches only the thread
that started it (and the threads torch hands it to, such as autograd's),
so spans record in those; a span is the parent of the spans opened inside
it in its own thread, and the list is written under a lock.  Call
:func:`clear` between spans, never inside one.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import List, Optional, Tuple

import torch

MAX_RECORDS = 100_000
PREFIX = "port::"

Record = Tuple[str, int, int, Optional[int]]

_OFF = contextlib.nullcontext()
_records: List[list] = []
_dropped = 0
_lock = threading.Lock()        # the list, its length and the count
_local = threading.local()


class _Span:
    __slots__ = ("name", "_range", "_rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _dropped
        self._range = torch._C._profiler._RecordFunctionFast(PREFIX + self.name)
        self._range.__enter__()
        stack = _stack()
        with _lock:
            if len(_records) < MAX_RECORDS:
                index = len(_records)
                self._rec = [self.name, stack[-1] if stack else -1,
                             time.time_ns(), None]
                _records.append(self._rec)
            else:
                index, self._rec = -1, None
                _dropped += 1
        stack.append(index)
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            self._rec[3] = time.time_ns()
        _stack().pop()
        self._range.__exit__(*exc)
        return False


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str):
    """A context that marks ``name`` while a profiler runs, else nothing."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name)


def records() -> List[Record]:
    """A copy of the records, in the order the spans began (``end_ns`` is
    None for a span still open)."""
    with _lock:
        return [tuple(r) for r in _records]


def dropped() -> int:
    """Spans left unrecorded since the list reached :data:`MAX_RECORDS`:
    when not 0, :func:`records` holds only the first spans."""
    return _dropped


def clear() -> None:
    """Empty the records and the count of dropped spans."""
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0
