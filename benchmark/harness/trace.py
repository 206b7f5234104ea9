"""Spans and the profiled sub-window of a traced run.

`EventSpans` times named spans with CUDA events on the current stream
and reads them once, after the window. `profile` runs a few repetitions
of a body under `torch.profiler` and returns what the per-layer metrics
and the result's `breakdown` read: the device's busy seconds inside the
profiled window, the window's seconds, the device operations by time,
the longest idle gaps named by the span the host was in at the gap's
start: the innermost of the program's spans (`cxg.<span>`, which
`utils/spans.py` opens as a `record_function` while a profiler records),
else the innermost of the benchmark's (`bench.<span>`), and the device
seconds of the host-to-card copies (`Memcpy HtoD ...`) inside the window.

A profile counts as complete only when its device events cover every
kernel launch, copy and set its runtime calls made, and every launch the
program's kernel wrappers counted (a frozen copy of the completeness
check of the port's `utils/profiling.py::call_device_ms`); an incomplete
profile is taken once more, and one still incomplete is returned with
`complete` False, which the idle metrics do not read.
"""

from __future__ import annotations

import torch

# runtime calls that each make one device event (a graph launch makes many)
API_CALLS = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
             "cudaMemcpyAsync", "cudaMemcpy", "cudaMemsetAsync"}
# per kernel wrapper of the program: a device kernel each launch makes under
# the bf16 policy, and how many events of it one launch makes
KERNEL_EVENTS = {"xgate": ("xgate_chain_kernel", 3), "pos_lstm": ("pos_lstm_wgmma_kernel", 1),
                 "attn_lstm": ("attn_rows_kernel", 1), "topk_tail": ("topk_chunk_wgmma_kernel", 1),
                 "xent_fwd": ("xent_fwd_kernel", 1), "xent_bwd": ("xent_bwd_kernel", 1),
                 "int8_vocab": ("int8_vocab_kernel", 1),
                 "topk_extract": ("topk_extract_wgmma_kernel", 1)}
SPAN_PREFIX = "bench."
PROGRAM_PREFIX = "cxg."
NO_SPAN = "outside the benchmark's spans"
COPY_PREFIX = "Memcpy HtoD"
TOP = 10


class EventSpans:
    """Named spans timed by CUDA events; `ms()` synchronises once."""

    def __init__(self):
        self._pending: dict = {}

    def start(self, name: str):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return name, ev

    def stop(self, token) -> None:
        name, ev = token
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self._pending.setdefault(name, []).append((ev, end))

    def ms(self) -> dict:
        torch.cuda.synchronize()
        return {n: [a.elapsed_time(b) for a, b in pairs] for n, pairs in self._pending.items()}

    def clear(self) -> None:
        self._pending.clear()


def _launch_counts() -> dict:
    from controllable_xgating_torch.ops import kernels

    return kernels.launch_counts()


def _kept_launches(names: list) -> dict:
    out: dict = {}
    for name in names:
        for wrapper, (kernel, per) in KERNEL_EVENTS.items():
            if kernel in name:
                out[wrapper] = out.get(wrapper, 0) + 1 / per
    return out


def _merge(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _span_at(spans: list, t: float):
    """The innermost of `spans` (name, start, end) covering host time t,
    or None."""
    best, width = None, float("inf")
    for name, s, e in spans:
        if s <= t <= e and e - s < width:
            best, width = name, e - s
    return best


def _gap_name(program: list, bench: list, t: float) -> str:
    """An idle gap starting at host time t, named by the innermost program
    span open then, else the innermost benchmark span, else NO_SPAN."""
    return _span_at(program, t) or _span_at(bench, t) or NO_SPAN


def _read(prof, launches: dict) -> dict:
    from torch.autograd import DeviceType

    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    calls = sum(e.name in API_CALLS for e in events)
    kept = _kept_launches([e.name for e in dev])
    complete = len(dev) >= max(calls, 1) and all(kept.get(n, 0) >= c - 1e-6
                                                 for n, c in launches.items())
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    host = [(e.name, e.time_range.start, e.time_range.end) for e in cpu
            if e.name.startswith(SPAN_PREFIX)]
    program = [(e.name, e.time_range.start, e.time_range.end) for e in cpu
               if e.name.startswith(PROGRAM_PREFIX)]
    win = [h for h in host if h[0] == SPAN_PREFIX + "window"]
    w0, w1 = (win[0][1], win[0][2]) if win else (min(e.time_range.start for e in events),
                                                  max(e.time_range.end for e in events))
    busy = _merge([(max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in dev
                   if e.time_range.end > w0 and e.time_range.start < w1])
    busy_us = sum(e - s for s, e in busy)
    gaps = []
    bench = [h for h in host if h[0] != SPAN_PREFIX + "window"]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            gaps.append((e - s, _gap_name(program, bench, s)))
    gaps.sort(reverse=True)
    by_name: dict = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    copy_us = sum(min(e.time_range.end, w1) - max(e.time_range.start, w0) for e in dev
                  if e.name.startswith(COPY_PREFIX) and e.time_range.end > w0
                  and e.time_range.start < w1)
    return {"complete": complete, "busy_s": busy_us / 1e6, "window_s": (w1 - w0) / 1e6,
            "device_ops": [[n, v / 1e6] for n, v in ops],
            "idle_gaps": [[n, g / 1e6] for g, n in gaps[:TOP]],
            "copy_s": copy_us / 1e6,
            "device_events": len(dev), "api_calls": calls,
            "launches": launches, "kept": kept}


def profile(body, reps: int, attempts: int = 2) -> dict:
    """Run `body()` `reps` times under the profiler inside a "bench.window"
    span, synchronised at both ends; retake while incomplete, up to
    `attempts` profiles in all. Returns `_read`'s summary with "reps" and
    "retakes"."""
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    out = None
    for attempt in range(attempts):
        torch.cuda.synchronize()
        before = _launch_counts()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(SPAN_PREFIX + "window"):
                for _ in range(reps):
                    body()
                torch.cuda.synchronize()
        after = _launch_counts()
        launches = {n: after[n] - before[n] for n in after if after[n] != before[n]}
        out = _read(prof, launches)
        out.update(reps=reps, retakes=attempt)
        if out["complete"]:
            break
    return out


def span(name: str):
    """A host span the profile's idle gaps are named by."""
    from torch.profiler import record_function

    return record_function(SPAN_PREFIX + name)
