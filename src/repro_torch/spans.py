"""Spans of the port's layers on the profiler's clock.

A span marks one layer boundary of the main path: a stage
(``spectral.prepare``, ``spectral.embed``, ``spectral.cluster``), a phase
of a block-Lanczos step or cycle (``lanczos.orth``, ``lanczos.qr``,
``lanczos.restart``), the k-means seeding (``kmeans.seed``), or a point
where the host waits for the device (``host.sync``).

A span records only while a ``torch.profiler`` runs.  It then opens a range
of its name in the profiler's host timeline (a host operation, not a user
annotation: the profiler mirrors no such range onto the device's lane, so a
span adds no busy time to a trace) and, once CUDA is initialised, records a
CUDA event at entry and at exit on the stream that was current when the
thread's outermost span opened.  It never synchronises and never asks the
card whether an event has passed, except once at the end of a
``host.sync``: the host has just waited there, so every span closed before
it can be read, and its two events go back to a pool as a later span needs
them.  The rest are read after the one synchronisation in
:func:`records`.  A span's device seconds are the stream's time between
its two events: its work there, and any idle inside it.  The spans of a
profiled run are kept in the order they opened.  With no profiler running,
:func:`span` returns one shared no-op context and records nothing.
:func:`clock` is a span that also times its host seconds when no profiler
runs (a stage's ``StageReport.wall_s``)::

    from torch.profiler import ProfilerActivity, profile
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        pipeline.run(points, generator)
    for r in spans.records():
        print(r.name, r.attrs, r.device_s)
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

SYNC = "host.sync"


class Record(NamedTuple):
    name: str
    parent: Optional[int]  # index in records() of the innermost enclosing span
    start_s: float  # host, time.perf_counter()
    end_s: float
    attrs: Dict[str, int]
    # on the card: the stream's seconds between the span's two events (its
    # work there, and any idle inside it); else the host seconds
    device_s: float


class _Off:
    """The span while no profiler runs.  Its ``__enter__`` and ``__exit__``
    are a builtin that takes any arguments and returns ``""`` (falsy, so an
    exception passes through): a ``with`` then runs no Python frame, which
    halves the cost of a span on the hot path."""

    __slots__ = ()
    __enter__ = __exit__ = "".format


class _Thread:
    """A thread's open kept spans and their stream, its closed spans whose
    events are not read yet (in closing order; the first ``passed`` of them
    the stream has passed), and its pool of free events."""

    def __init__(self):
        self.stack: List[Span] = []
        self.stream = None
        self.unread: collections.deque = collections.deque()
        self.passed = 0
        self.free: list = []


def _here() -> _Thread:
    """The calling thread's :class:`_Thread`."""
    here = getattr(_local, "here", None)
    if here is None:
        here = _local.here = _Thread()
        with _lock:
            _threads.append(here)
    return here


_OFF = _Off()
_lock = threading.Lock()
_store: List["Span"] = []
_threads: List[_Thread] = []
_local = threading.local()


class Span:
    """One span.  Made while a profiler runs, it is kept: it goes into the
    store with a profiler range and, on the card, two CUDA events."""

    __slots__ = ("name", "attrs", "parent", "start_s", "end_s", "_kept", "_range", "_thread",
                 "_events", "_device_s")

    def __init__(self, name: str, attrs: Dict[str, int], kept: bool):
        self.name, self.attrs, self._kept = name, attrs, kept
        self.parent: Optional[Span] = None
        self.end_s = None
        self._range = self._events = self._device_s = None

    def __enter__(self) -> "Span":
        if self._kept:
            self._range = torch._C._profiler._RecordFunctionFast(self.name)
            self._range.__enter__()
            here = self._thread = _here()
            stack = here.stack
            self.parent = stack[-1] if stack else None
            if torch.cuda.is_initialized():
                if not stack or here.stream is None:
                    here.stream = torch.cuda.current_stream()
                self._events = _take_events(here)
                torch._C._CudaEventBase.record(self._events[0], here.stream)
            stack.append(self)
            _store.append(self)
        self.start_s = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.end_s = time.perf_counter()
        if self._kept:
            here = self._thread
            if self._events is not None:
                unread = here.unread
                # the host has waited: every span closed before has passed
                if self.name == SYNC and here.passed < len(unread) \
                        and unread[-1]._events[1].query():
                    here.passed = len(unread)
                torch._C._CudaEventBase.record(self._events[1], here.stream)
                unread.append(self)
            here.stack.pop()
            self._range.__exit__(*exc)
            self._range = None
        return None

    @property
    def host_s(self) -> float:
        """Host seconds from entry to exit."""
        return self.end_s - self.start_s

    def _read(self, free: list) -> None:
        """Device seconds from the two events, which the stream has passed;
        the events go back to ``free``."""
        start, end = self._events
        self._device_s = torch._C._CudaEventBase.elapsed_time(start, end) / 1e3
        free += self._events
        self._events = None


def _take_events(here: _Thread):
    """Two timing events: freed ones, after reading the oldest closed span
    the stream has passed, else new ones."""
    free = here.free
    if len(free) < 2 and here.passed:
        here.passed -= 1
        here.unread.popleft()._read(free)
    if len(free) >= 2:
        return free.pop(), free.pop()
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


def span(name: str, **attrs: int):
    """A span of ``name`` with small integer ``attrs``, fixed at entry; the
    shared no-op context while no profiler runs."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return Span(name, attrs, True)


def clock(name: str) -> Span:
    """A span of ``name`` that times its host seconds (``host_s``) whether
    or not a profiler runs; kept only while one does."""
    return Span(name, {}, _profiler._is_profiler_enabled)


def records() -> List[Record]:
    """The spans kept so far, in the order they opened (an open one with
    NaN for its end and device seconds).  Device seconds not read yet are
    read after one synchronisation.  Call it while no other thread is
    inside a span."""
    with _lock:
        kept = list(_store)
        if any(t.unread for t in _threads):
            torch.cuda.synchronize()
        for t in _threads:
            while t.unread:
                t.unread.popleft()._read(t.free)
            t.passed = 0
    at = {id(s): i for i, s in enumerate(kept)}
    nan = float("nan")
    return [Record(s.name, None if s.parent is None else at.get(id(s.parent)), s.start_s,
                   nan if s.end_s is None else s.end_s, s.attrs,
                   nan if s.end_s is None else
                   s.host_s if s._device_s is None else s._device_s)
            for s in kept]


def reset() -> None:
    """Empty the store (between two profiled runs in one process)."""
    with _lock:
        _store.clear()
        for t in _threads:
            t.unread.clear()
            t.passed = 0
