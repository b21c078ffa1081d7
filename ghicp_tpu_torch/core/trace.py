"""Host-clock spans of one ``register_pair`` call, on the profiler's clock
while a profiler runs.

:func:`record` makes a dict the call's record (``RegistrationOutput.
timings``).  Inside it, :func:`span` adds its host seconds to the record
under the dotted path of the spans open around it (``register``,
``register.solve``, ``register.solve.wait``); a span entered again adds
to what it holds, so a path sums every visit.  A span does not
synchronise.  :func:`stage` is a span that synchronises the device at
its end, the synchronisation timed as its child ``wait``; :func:`wait`
and :func:`read` mark the host's reads of device values (``int(t)``,
``bool(t)``, ``.cpu()``), so ``<path>.wait`` is the time the host spent
waiting on the card under ``<path>``.

While ``torch.profiler`` runs, a stage and each of its parts (a path of
at most ``RANGE_DEPTH`` names: ``register``, ``register.solve``) is also
the profiler range ``pipeline.<path>``, beside the device's kernels on
the trace's clock.  Deeper spans, which the streaming solve opens ~2,500
times a pair (its rounds' sweeps, compactions, resolutions and reads),
are timed but enter no range: a reader that labels each idle gap of the
device by the ranges open there pays for every range.  With no profiler
running no range is entered (one costs ~10 us of host time).

With no record active (the engine or a stage called directly) a span
records nothing and enters no range: it costs one context-variable read.
Each thread has its own record.
"""
from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Callable, Dict, Optional, TypeVar

import torch

PREFIX = "pipeline."
RANGE_DEPTH = 2       # the longest path, in names, that a range marks

_RECORD: contextvars.ContextVar[Optional["_Record"]] = (
    contextvars.ContextVar("ghicp_trace_record", default=None))

T = TypeVar("T")


class _Record:
    """The running call's timings and the paths of its open spans."""

    __slots__ = ("timings", "open")

    def __init__(self, timings: Dict[str, float]):
        self.timings = timings
        self.open: list = []


@contextlib.contextmanager
def record(timings: Dict[str, float]):
    """Make ``timings`` the record of the spans entered inside (in this
    thread), until the block ends."""
    token = _RECORD.set(_Record(timings))
    try:
        yield timings
    finally:
        _RECORD.reset(token)


class _Span:
    __slots__ = ("name", "rec", "path", "rf", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rec = self.rec = _RECORD.get()
        if rec is None:
            return self
        stack = rec.open
        self.path = path = (stack[-1] + "." + self.name) if stack \
            else self.name
        stack.append(path)
        self.rf = None
        if len(stack) <= RANGE_DEPTH and torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(PREFIX + path)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec is None:
            return False
        dt = time.perf_counter() - self.t0
        t = rec.timings
        t[self.path] = t.get(self.path, 0.0) + dt
        rec.open.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str) -> _Span:
    """A context manager: the block's host seconds under ``<open
    path>.<name>`` of the active record (nothing without one)."""
    return _Span(name)


def wait() -> _Span:
    """The span ``wait`` around a read of device values to the host."""
    return _Span("wait")


def read(conv: Callable[..., T], x) -> T:
    """``conv(x)`` (``int``, ``bool``, ``float``, ...) of a device value,
    timed as a :func:`wait`."""
    with _Span("wait"):
        return conv(x)


@contextlib.contextmanager
def stage(name: str, dev: torch.device):
    """A pipeline stage: a span whose block the device finishes before it
    ends (device work included), the synchronisation its child ``wait``."""
    with _Span(name):
        yield
        with _Span("wait"):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
