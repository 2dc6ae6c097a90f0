"""The port's span record: one tree of timed spans a CLI job.

Switched by COMPAIRR_TIMING=1 (refresh() reads it; cli.main's job()
and every engine._PhaseTimer call it). Off, span(), record(), count()
and note() are one check of the module flag ON and allocate nothing:
span() hands back the shared NULL span, which is falsy, so a caller
guards work that only feeds a count with `if sp:`.

On, every span keeps its name, id, parent id, job id, thread ident,
start and end on time.perf_counter_ns() (CLOCK_MONOTONIC on Linux) and
a small dict of counts. Spans stay in memory until reset(). A root (a
span opened with no current span, such as a job) is always kept; each
root keeps at most CAP spans under it, and counts the rest as its
spans_dropped, so a runaway job loses its own detail and no other
job's. The current span is a contextvars variable, so a worker thread
started under contextvars.copy_context() (engine.prefetch_find_pairs)
records its spans under the span that started it.

Where torch is imported and torch.profiler is recording, an opened span
is also entered as torch.profiler.record_function(name), so it lands in
the Chrome trace beside the kernels, on the trace's own clock. record()
spans (phase laps) are known only at their end and stay in memory
alone.

This module imports no torch: host-only routes never load it.
"""

from __future__ import annotations

import contextvars
import itertools
import os
import sys
import threading
import time

ON = False
CAP = 200_000

_SPANS: list = []
_IDS = itertools.count(1)
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "compairr_span", default=None
)
_JOB_LOCK = threading.Lock()  # roots count from worker threads too


def refresh() -> bool:
    """Read COMPAIRR_TIMING into ON and return it."""
    global ON
    ON = os.environ.get("COMPAIRR_TIMING") == "1"
    return ON


class Span:
    """One timed span (see the module docstring). t1 is None while it
    is open. A Span is a context manager: entering opens it as the
    current span, leaving closes it."""

    __slots__ = ("name", "id", "parent", "job", "thread", "t0", "t1",
                 "counts", "_root", "_kept", "_token", "_rf")

    def __init__(self, name: str, parent):
        self.name = name
        self.id = next(_IDS)
        self.parent = parent.id if parent is not None else None
        self.job = parent.job if parent is not None else self.id
        self._root = parent._root if parent is not None else self
        self._kept = 0  # spans kept under it, on a root
        self.thread = threading.get_ident()
        self.t0 = self.t1 = None
        self.counts: dict = {}
        self._token = self._rf = None

    def count(self, key: str, n) -> None:
        """Add n to the count key."""
        self.counts[key] = self.counts.get(key, 0) + n

    def note(self, key: str, value) -> None:
        """Set key to value (a label, such as the route taken)."""
        self.counts[key] = value

    def __enter__(self):
        self._token = _CURRENT.set(self)
        if self._root is self:
            self.counts["spans_dropped"] = 0
        _keep(self)
        torch = sys.modules.get("torch")
        if torch is not None and torch.autograd.profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        _CURRENT.reset(self._token)


class _Null:
    """The span handed out while tracing is off: falsy, and every
    method does nothing."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def count(self, key, n) -> None:
        pass

    def note(self, key, value) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        pass


NULL = _Null()


def _keep(sp: Span) -> None:
    root = sp._root
    if root is sp:
        _SPANS.append(sp)
        return
    with _JOB_LOCK:
        if root._kept < CAP:
            root._kept += 1
            _SPANS.append(sp)
        else:
            root.count("spans_dropped", 1)


def job():
    """The root span of one CLI job (a new job id), whatever span is
    current; reads COMPAIRR_TIMING first."""
    if not refresh():
        return NULL
    return Span("job", None)


def span(name: str):
    """A span under the current one, to enter with `with`."""
    if not ON:
        return NULL
    return Span(name, _CURRENT.get())


def record(name: str, t0: int, t1: int):
    """A closed span from t0 to t1 (perf_counter_ns) under the current
    span: a phase known only at its end. Returns it, for its counts."""
    if not ON:
        return NULL
    parent = _CURRENT.get()
    sp = Span(name, parent)
    if parent is None:
        sp.job = None
    sp.t0, sp.t1 = t0, t1
    _keep(sp)
    return sp


def count(key: str, n) -> None:
    """Add n to a count of the current span."""
    if ON:
        sp = _CURRENT.get()
        if sp is not None:
            sp.count(key, n)


def note(key: str, value) -> None:
    """Set a label of the current span."""
    if ON:
        sp = _CURRENT.get()
        if sp is not None:
            sp.note(key, value)


def count_job(key: str, n) -> None:
    """Add n to a count of the current span's job (its root)."""
    if ON:
        sp = _CURRENT.get()
        if sp is not None:
            with _JOB_LOCK:
                sp._root.count(key, n)


def spans() -> list:
    """Every span kept since the last reset(), in the order opened."""
    return list(_SPANS)


def reset() -> None:
    """Forget every span kept."""
    _SPANS.clear()
