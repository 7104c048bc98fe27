"""The port's span record: where its own host time goes.

``span(name)`` is a context manager around one stage of the work (a PnR
stage, a design point's analysis, a ready-valid cycle's eager tail). It
records the name, start and end on ``time.perf_counter()``, the thread,
its id, its parent's id and a trace id, and keeps the closed span in one
bounded buffer. The parent is the innermost span open on the same
thread, or one handed over with ``parent=`` (work dispatched to another
thread). The trace id is given by a root (``dse.point`` gives its
design point's ``spec_digest``), else inherited from the parent, else
the span's own id, so every span of one design point shares it on every
thread.

Recording is always on. With no profiler running a span costs two clock
reads, a push and pop on a thread-local stack and a ``deque.append``.
While ``torch.profiler`` runs, a span also opens a ``record_function``
range of its name, so it shows on the profiler's clock beside the
kernels. The profiler sees such ranges only on the thread that started
it; the buffer sees every thread.

No span name starts with ``trace.`` or ``canalbench.``: those prefixes
belong to the benchmark's own spans.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Any, Dict, List, Optional

import torch

#: closed spans kept; once full, each new span pushes out the oldest. A
#: ready-valid cycle closes three, and ``RVFabric`` runs 1,000-1,300
#: cycles a second at Amber FULL on an H100 (the sweeps in one kernel
#: launch): a 45 s window of them is up to ~176,000 spans, ~50 MB at
#: ~280 B a span
CAPACITY = 1 << 19

_buffer: "collections.deque[Span]" = collections.deque(maxlen=CAPACITY)
_lock = threading.Lock()
_dropped = 0
_ids = itertools.count(1)
_local = threading.local()


class Span:
    """One span: open inside its ``with`` block, a record once closed.
    ``parent`` and ``trace`` hold ids once it is open (``parent`` None for
    a root)."""

    __slots__ = ("name", "attrs", "parent", "id", "trace", "thread",
                 "t0", "t1", "_range")

    def __init__(self, name: str, parent: Optional["Span"],
                 trace: Optional[str], attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self.parent = parent
        self.trace = trace
        self.t1 = None

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def __enter__(self) -> "Span":
        stack = _stack()
        parent = self.parent if self.parent is not None else (
            stack[-1] if stack else None)
        self.parent = None if parent is None else parent.id
        self.id = next(_ids)
        if self.trace is None:
            self.trace = self.id if parent is None else parent.trace
        self.thread = threading.get_ident()
        self._range = None
        if torch._C._autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter()
        _stack().pop()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        global _dropped
        with _lock:
            if len(_buffer) == _buffer.maxlen:
                _dropped += 1
            _buffer.append(self)


def _stack() -> List[Span]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def span(name: str, parent: Optional[Span] = None,
         trace: Optional[str] = None, **attrs) -> Span:
    """A span of ``name`` (``with span(...) as s``). ``parent``: a span
    open on another thread, for work handed over to this one; ``trace``:
    a root's trace id (default: the parent's, or the span's own id).
    ``attrs`` stay small: an app's name, an alpha, lanes, cycles."""
    return Span(name, parent, trace, attrs)


def current() -> Optional[Span]:
    """The innermost span open on this thread (to hand to another)."""
    stack = _stack()
    return stack[-1] if stack else None


def spans(name: Optional[str] = None, since: Optional[float] = None,
          until: Optional[float] = None) -> List[Span]:
    """Closed spans still in the buffer, oldest first: those of ``name``
    whose whole interval lies inside ``[since, until]``."""
    with _lock:
        kept = list(_buffer)
    return [s for s in kept
            if (name is None or s.name == name)
            and (since is None or s.t0 >= since)
            and (until is None or s.t1 <= until)]


def dropped() -> int:
    """Closed spans the buffer lost, oldest first, since the process
    started."""
    return _dropped
