"""Spans and counters at the port's layer boundaries.

`span(name)` bounds one layer's work (`with span("encode.bilstm",
device=True): ...`), `count(name, n)` adds to a named counter, and
`request()` groups the spans of one caption call or served batch under
one id. Nothing is kept unless someone reads it:

  * `collect()` installs an in-memory `Collector` (one at a time, for the
    whole process). It keeps each span's name, parent (the span open
    around it on the same thread), request id, host start and end
    (`time.perf_counter_ns`) and, for a span opened with `device=True`,
    start and end CUDA events on the current stream; the counters, from
    every thread, behind one lock; and per request, the kernel wrappers'
    launches (their own `.launches` counters, read through
    `infer/graphs.py::LaunchLedger`, not counted again). `summary()`
    synchronises once and gives, per span name, the host, self and device
    milliseconds.
  * While a `torch.profiler` records, each span is also a
    `record_function` range named `cxg.<name>`. Its CPU events share the
    profile's timeline with the device events, so an idle gap of the card
    can be put down to the innermost span the host was in
    (`tools/trace_ops.py::program_attribution`).

With neither, `span` and `request` return one shared null context and
`count` returns: no allocation, no CUDA call, no `record_function`, no
lock. Under CUDA stream capture a span keeps host time only and records
no event, so that no event is baked into a graph; no span is opened
inside a decode loop's step.
"""

from __future__ import annotations

import itertools
import threading
import time
from contextlib import nullcontext
from typing import Optional

import torch
import torch.autograd.profiler as _autograd_profiler

PREFIX = "cxg."

_collector: Optional["Collector"] = None  # the installed collector, if any
_local = threading.local()  # .stack: this thread's open spans; .request: its request id
_ids = itertools.count(1)  # request ids
_NULL = nullcontext()


def profiling() -> bool:
    """Whether a `torch.profiler` is recording now."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str, device: bool = False):
    """A context manager bounding one layer's work; `device=True` also
    times it on the card (CUDA events on the current stream)."""
    if _collector is None and not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, device)


def request():
    """A context manager around one caption call or served batch: the
    spans opened inside it share one request id."""
    if _collector is None:
        return _NULL
    return _Request()


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` of the installed collector."""
    col = _collector
    if col is None:
        return
    with col.lock:
        col.counters[name] = col.counters.get(name, 0) + n


def collect() -> "Collector":
    """Install a new collector (in place of the one installed, which
    `close()` puts back) and return it; also a context manager."""
    global _collector
    col = Collector(_collector)
    _collector = col
    return col


def installed() -> Optional["Collector"]:
    """The installed collector, or None."""
    return _collector


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "device", "col", "rf", "parent", "request", "t0", "t1", "events")

    def __init__(self, name: str, device: bool):
        self.name, self.device = name, device
        self.col = self.rf = self.parent = self.events = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        col = self.col = _collector
        if col is not None:
            stack = _stack()
            self.parent = stack[-1] if stack else None
            if self.parent is not None:
                self.request = self.parent.request
            else:
                self.request = getattr(_local, "request", None) or next(_ids)
            stack.append(self)
            if (self.device and torch.cuda.is_initialized()
                    and not torch.cuda.is_current_stream_capturing()):
                self.events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
                self.events[0].record()
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        col = self.col
        if col is not None:
            self.t1 = time.perf_counter_ns()
            if self.events is not None:
                if torch.cuda.is_current_stream_capturing():
                    self.events = None  # ends inside a capture: host time only
                else:
                    self.events[1].record()
            _stack().pop()
            with col.lock:
                col.spans.append(self)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class _Request:
    __slots__ = ("prev", "before", "col")

    def __enter__(self):
        from controllable_xgating_torch.infer.graphs import LaunchLedger

        self.col = _collector
        self.prev = getattr(_local, "request", None)
        _local.request = next(_ids)
        self.before = LaunchLedger().read()
        return self

    def __exit__(self, *exc):
        from controllable_xgating_torch.infer.graphs import LaunchLedger

        _local.request = self.prev
        delta = LaunchLedger().since(self.before)
        with self.col.lock:
            self.col.requests += 1
            for n, d in delta.items():
                self.col.launches[n] = self.col.launches.get(n, 0) + d
        return False


class Collector:
    """Spans, counters and per-request kernel launches, in memory until
    read (`summary`) or dropped (`clear`)."""

    def __init__(self, previous: Optional["Collector"] = None):
        self.previous = previous
        self.lock = threading.Lock()
        self.spans: list = []
        self.counters: dict = {}
        self.launches: dict = {}
        self.requests = 0

    def clear(self) -> None:
        with self.lock:
            self.spans, self.counters, self.launches, self.requests = [], {}, {}, 0

    def close(self) -> None:
        """Uninstall: the collector installed before this one is again."""
        global _collector
        if _collector is self:
            _collector = self.previous

    def __enter__(self) -> "Collector":
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def summary(self) -> dict:
        """{"requests": closed `request()` blocks, "spans": {name: {"n",
        "host_ms", "self_ms", "device_ms"}}, "counters", "launches"}:
        sums over the spans kept (divide by "requests" for a per-request
        mean); "self_ms" is a span's host time less what its child spans
        cover, "device_ms" None for a name with no CUDA events. Waits
        once for the card where any span recorded events."""
        with self.lock:
            kept = list(self.spans)
            out = {"requests": self.requests, "counters": dict(self.counters),
                   "launches": dict(self.launches)}
        if any(s.events is not None for s in kept):
            torch.cuda.synchronize()
        covered: dict = {}
        for s in kept:
            if s.parent is not None:
                covered[id(s.parent)] = covered.get(id(s.parent), 0) + (s.t1 - s.t0)
        by_name: dict = {}
        for s in kept:
            d = by_name.setdefault(s.name, {"n": 0, "host_ms": 0.0, "self_ms": 0.0,
                                            "device_ms": None})
            d["n"] += 1
            d["host_ms"] += (s.t1 - s.t0) / 1e6
            d["self_ms"] += (s.t1 - s.t0 - covered.get(id(s), 0)) / 1e6
            if s.events is not None:
                d["device_ms"] = (d["device_ms"] or 0.0) + s.events[0].elapsed_time(s.events[1])
        out["spans"] = by_name
        return out
