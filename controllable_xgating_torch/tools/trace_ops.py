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
import glob
import gzip
import json
import os

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _events(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data.get("traceEvents", []) if isinstance(data, dict) else data


def parse_trace(logdir: str, top: int = 40) -> dict:
    """Device time by op name over every Chrome trace under `logdir`."""
    from controllable_xgating_torch.utils.profiling import kernel_event_launches

    paths = sorted(glob.glob(os.path.join(logdir, "**", "*.pt.trace.json"), recursive=True)
                   + glob.glob(os.path.join(logdir, "**", "*.pt.trace.json.gz"), recursive=True))
    if not paths:
        raise FileNotFoundError(f"no *.pt.trace.json under {logdir}")
    per_op: dict[str, float] = {}
    devices, kernel_names = set(), []
    for path in paths:
        for ev in _events(path):
            if ev.get("ph") != "X" or ev.get("cat") not in DEVICE_CATS:
                continue
            name = ev.get("name", "")
            per_op[name] = per_op.get(name, 0.0) + float(ev.get("dur", 0.0))
            devices.add((ev.get("args") or {}).get("device", ev.get("pid")))
            if ev["cat"] == "kernel":
                kernel_names.append(name)
    ranked = sorted(per_op.items(), key=lambda kv: -kv[1])
    total = sum(per_op.values())
    return {
        "devices": sorted(devices, key=str),
        "total_device_us": round(total, 1),
        "ops": [{"op": k, "us": round(v, 1), "pct": round(100 * v / total, 2) if total else 0.0}
                for k, v in ranked[:top]],
        "port_kernel_events": kernel_event_launches(kernel_names),
    }


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
    call; the wrappers' launch counts over the traced span."""
    from controllable_xgating_torch.ops import kernels
    from controllable_xgating_torch.utils import timing
    from controllable_xgating_torch.utils.profiling import profile_trace

    call = _workload(workload, batch, dev)
    timing.fence(call())  # build, capture, settle
    before = kernels.launch_counts()
    with profile_trace(out):
        outs = [call() for _ in range(reps)]
        timing.fence(outs)
    return {n: c - before[n] for n, c in kernels.launch_counts().items() if c != before[n]}


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
        launches = capture(args.workload, args.out, args.batch, args.reps, dev)
    report = parse_trace(args.out, args.top)
    report.update(workload=args.workload, batch=args.batch, reps=args.reps, launches=launches,
                  events_complete=all(report["port_kernel_events"].get(n, 0) >= c
                                      for n, c in launches.items()))
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
