"""Op-level device trace of the hot workloads.

Counterpart of the JAX package's `tools/trace_ops.py`: it captures a
`torch.profiler` trace (`utils/profiling.py::profile_trace`, Chrome
format, `*.pt.trace.json`) of the beam-5, greedy, XE-step or SCST-step
workload at the benchmark's shapes (`utils/timing.py`: 256 videos at
MSR-VTT width, random weights from seed 0, bf16 on the card), after one
settling call, and reduces it to the table that matters: device
microseconds per kernel, copy and set, by name, descending.

    # capture + table
    python -m controllable_xgating_torch.tools.trace_ops --workload beam --out /tmp/trace_beam
    # parse an existing trace only
    python -m controllable_xgating_torch.tools.trace_ops --parse /tmp/trace_beam

`parse_trace` stands where the JAX tool's `parse_xplanes` stood: it reads
every `*.pt.trace.json` (or `.json.gz`) under the directory with the
standard library, sums the durations of the device events (categories
`kernel`, `gpu_memcpy`, `gpu_memset`) by name and ranks them, and
returns the JAX keys (`total_device_us`, `ops` of `op` / `us` / `pct`)
with `devices`, the device ids seen, in place of `planes`. With no trace
it raises FileNotFoundError.

The program's spans (`utils/spans.py`) are in such a trace as CPU
ranges named `cxg.<span>` (a `--profile LOGDIR` trace of `cli.eval` or
`cli.train` has them too). `program_attribution` reads them on the
trace's one clock: the card's idle time put down to the innermost span
the host was in, and the runtime's launch calls likewise; each span's
host and idle time; the idle time under no span. `parse_trace` gives it
under `program` where the trace has such spans, and a capture adds the
collector's `summary()` of the traced calls (`spans`) and of the set-up
(`settle_spans`: `setup.init`, `setup.library` and the settling call's
graph captures).

The profiler does not always keep every kernel of a replayed CUDA graph.
So a capture's report also gives `port_kernel_events`, the launches of
the port's kernels that the trace's events account for, beside
`launches`, the wrappers' launch counts over the same span: where the
first falls short, the device total is short too.

Without a CUDA device a capture exits 1 unless `--device cpu` is given
(a CPU trace has no device events).
"""

from __future__ import annotations

import argparse
import bisect
import glob
import gzip
import json
import os

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# runtime calls that each start one device operation (a graph launch starts many)
LAUNCH_CALLS = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaMemcpyAsync", "cudaMemcpy", "cudaMemsetAsync"}
NO_SPAN = "(no program span)"


def _events(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data.get("traceEvents", []) if isinstance(data, dict) else data


def _merge(intervals) -> list:
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(spans: list) -> list:
    """(start, end, name) segments, in order, over which one span is the
    innermost open one (the latest started): the program's spans nest."""
    moments = sorted({t for _, s, e in spans for t in (s, e)})
    starts = sorted(spans, key=lambda x: x[1])
    active, segs, j = [], [], 0
    for a, b in zip(moments, moments[1:]):
        while j < len(starts) and starts[j][1] <= a:
            active.append(starts[j])
            j += 1
        active = [x for x in active if x[2] > a]
        if active:
            name = max(active, key=lambda x: (x[1], -x[2]))[0]
            if segs and segs[-1][2] == name and segs[-1][1] == a:
                segs[-1][1] = b
            else:
                segs.append([a, b, name])
    return segs


def program_attribution(events: list, prefix: str = "cxg.") -> dict:
    """The card's idle time and the runtime's launch calls of one Chrome
    trace, put down to the program's spans (CPU ranges named `prefix` +
    span). The window runs from the first span or device operation to the
    last; an idle gap is split where the innermost span changes. Times in
    microseconds: `idle_us_by_span` (the innermost span, or NO_SPAN),
    `launch_calls_by_span` (LAUNCH_CALLS by the innermost span at the
    call), and per span name `n`, `host_us` and `idle_us` (the card idle
    inside its intervals)."""
    spans, busy, calls = [], [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        s, e = float(ev.get("ts", 0.0)), float(ev.get("ts", 0.0)) + float(ev.get("dur", 0.0))
        name, cat = ev.get("name", ""), ev.get("cat")
        if cat in DEVICE_CATS:
            busy.append((s, e))
        elif cat == "user_annotation" and name.startswith(prefix):
            spans.append((name[len(prefix):], s, e))
        elif name in LAUNCH_CALLS:
            calls.append(s)
    if not spans:
        return {}
    w0 = min([s for _, s, _ in spans] + [s for s, _ in busy])
    w1 = max([e for _, _, e in spans] + [e for _, e in busy])
    merged = _merge(busy)
    edges = [w0] + [t for iv in merged for t in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    segs = _innermost(spans)
    idle: dict = {}
    i = 0
    for a, b in gaps:  # both lists in time order
        t = a
        while i < len(segs) and segs[i][1] <= a:
            i += 1
        k = i
        while t < b:
            if k < len(segs) and segs[k][0] < b:
                s0, s1, name = segs[k]
                if s0 > t:
                    idle[NO_SPAN] = idle.get(NO_SPAN, 0.0) + (s0 - t)
                    t = s0
                end = min(b, s1)
                idle[name] = idle.get(name, 0.0) + (end - t)
                t = end
                k += 1
            else:
                idle[NO_SPAN] = idle.get(NO_SPAN, 0.0) + (b - t)
                t = b
    seg_starts = [x[0] for x in segs]
    launches: dict = {}
    for c in calls:
        k = bisect.bisect_right(seg_starts, c) - 1
        name = segs[k][2] if k >= 0 and c < segs[k][1] else NO_SPAN
        launches[name] = launches.get(name, 0) + 1
    gap_starts = [a for a, _ in gaps]
    per: dict = {}
    for name, s, e in spans:
        d = per.setdefault(name, {"n": 0, "host_us": 0.0, "idle_us": 0.0})
        d["n"] += 1
        d["host_us"] += e - s
        k = max(bisect.bisect_right(gap_starts, s) - 1, 0)
        while k < len(gaps) and gaps[k][0] < e:
            d["idle_us"] += max(0.0, min(e, gaps[k][1]) - max(s, gaps[k][0]))
            k += 1
    busy_us = sum(min(e, w1) - max(s, w0) for s, e in merged)
    return {"window_us": w1 - w0, "busy_us": busy_us, "idle_us": w1 - w0 - busy_us,
            "idle_us_by_span": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
            "launch_calls_by_span": dict(sorted(launches.items(), key=lambda kv: -kv[1])),
            "spans": per}


def _add_attribution(total: dict, one: dict) -> dict:
    if not total or not one:
        return total or one
    for k in ("window_us", "busy_us", "idle_us"):
        total[k] += one[k]
    for k in ("idle_us_by_span", "launch_calls_by_span"):
        for name, v in one[k].items():
            total[k][name] = total[k].get(name, 0) + v
    for name, d in one["spans"].items():
        t = total["spans"].setdefault(name, {"n": 0, "host_us": 0.0, "idle_us": 0.0})
        for k in d:
            t[k] += d[k]
    return total


def parse_trace(logdir: str, top: int = 40) -> dict:
    """Device time by op name over every Chrome trace under `logdir`."""
    from controllable_xgating_torch.utils.profiling import kernel_event_launches

    paths = sorted(glob.glob(os.path.join(logdir, "**", "*.pt.trace.json"), recursive=True)
                   + glob.glob(os.path.join(logdir, "**", "*.pt.trace.json.gz"), recursive=True))
    if not paths:
        raise FileNotFoundError(f"no *.pt.trace.json under {logdir}")
    per_op: dict[str, float] = {}
    devices, kernel_names = set(), []
    program: dict = {}
    for path in paths:
        events = _events(path)
        program = _add_attribution(program, program_attribution(events))
        for ev in events:
            if ev.get("ph") != "X" or ev.get("cat") not in DEVICE_CATS:
                continue
            name = ev.get("name", "")
            per_op[name] = per_op.get(name, 0.0) + float(ev.get("dur", 0.0))
            devices.add((ev.get("args") or {}).get("device", ev.get("pid")))
            if ev["cat"] == "kernel":
                kernel_names.append(name)
    ranked = sorted(per_op.items(), key=lambda kv: -kv[1])
    total = sum(per_op.values())
    report = {
        "devices": sorted(devices, key=str),
        "total_device_us": round(total, 1),
        "ops": [{"op": k, "us": round(v, 1), "pct": round(100 * v / total, 2) if total else 0.0}
                for k, v in ranked[:top]],
        "port_kernel_events": kernel_event_launches(kernel_names),
    }
    if program:
        report["program"] = program
    return report


def _workload(workload: str, batch: int, dev):
    """A zero-arg call of the workload on `dev` (its inputs made once)."""
    import torch

    from controllable_xgating_torch.utils import timing

    cfg, params = timing.build(device=dev)
    if workload in ("beam", "greedy"):
        if workload == "beam":
            fn = timing.make_fn(cfg)
        else:
            from controllable_xgating_torch.infer.evaluator import make_greedy_caption_fn

            fn = make_greedy_caption_fn(cfg.model.max_pos_len, timing.MAX_LEN, early_stop=False)
        app, mot = (timing.put(x, dev) for x in timing.random_batch(cfg, batch))
        return lambda: fn(params, app, mot)[0]

    from controllable_xgating_torch.train.state import create_train_state, make_optimizer

    if workload == "xe":
        from controllable_xgating_torch.train.xe import make_xe_train_step

        full = cfg.replace_flat({"model.dropout": 0.5, "train.remat": True})
        step = make_xe_train_step(make_optimizer(full, 100), full, "joint")
        data = timing.bench_train_batch(full, batch, 5)
    elif workload == "scst":
        from controllable_xgating_torch.ops.cider_device import build_reward_tables
        from controllable_xgating_torch.tools.scst_breakdown import make_inputs
        from controllable_xgating_torch.train.scst import make_scst_train_step

        full = cfg
        caps, ncaps, data = make_inputs(full, batch)
        tables = build_reward_tables(caps, ncaps, list(range(batch)), device=dev)
        step = make_scst_train_step(make_optimizer(full, 100), full, tables)
    else:
        raise SystemExit(f"unknown workload {workload}")
    state = create_train_state(params, full)
    data = {k: timing.put(v, dev) for k, v in data.items()}
    state_box = [state]

    def run() -> torch.Tensor:
        state_box[0], metrics = step(state_box[0], data)
        return metrics["loss"]

    return run


def capture(workload: str, out: str, batch: int, reps: int, dev) -> dict:
    """Trace `reps` calls of the workload into `out` after one settling
    call: the wrappers' launch counts over the traced span ("launches")
    and the span collector's summary of the traced calls ("spans") and of
    the set-up ("settle_spans": the parameters' init, the kernel
    library's build or load and the settling call, which captures the
    decode graphs), one request a call."""
    from controllable_xgating_torch.ops import kernels
    from controllable_xgating_torch.utils import spans, timing
    from controllable_xgating_torch.utils.profiling import profile_trace

    with spans.collect() as settle:
        call = _workload(workload, batch, dev)
        with spans.request():
            timing.fence(call())  # build, capture, settle
    before = kernels.launch_counts()
    with spans.collect() as col, profile_trace(out):
        outs = []
        for _ in range(reps):
            with spans.request():
                outs.append(call())
        timing.fence(outs)
    launches = {n: c - before[n] for n, c in kernels.launch_counts().items() if c != before[n]}
    return {"launches": launches, "spans": col.summary(), "settle_spans": settle.summary()}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", choices=("beam", "greedy", "scst", "xe"), default="beam")
    p.add_argument("--out", default=None, help="trace logdir (capture mode)")
    p.add_argument("--parse", default=None, help="parse an existing trace logdir and exit")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--reps", type=int, default=8)
    p.add_argument("--top", type=int, default=40)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where to capture (default: the card; cpu only when asked)")
    args = p.parse_args(argv)

    if args.parse:
        report = parse_trace(args.parse, args.top)
        print(json.dumps(report, indent=2))
        return report
    if not args.out:
        p.error("--out LOGDIR required for capture")

    from controllable_xgating_torch.cli.common import runtime_device
    from controllable_xgating_torch.ops.precision import precision
    from controllable_xgating_torch.utils.config import Config

    dev, dtype = runtime_device(args.device, None, Config())
    with precision(dtype):
        got = capture(args.workload, args.out, args.batch, args.reps, dev)
    report = parse_trace(args.out, args.top)
    report.update(workload=args.workload, batch=args.batch, reps=args.reps, **got,
                  events_complete=all(report["port_kernel_events"].get(n, 0) >= c
                                      for n, c in got["launches"].items()))
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
