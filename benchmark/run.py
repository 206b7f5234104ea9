"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is found by name
(`benchmark/workloads/<cell>.json`); its entry kind drives the port
(`controllable_xgating_torch`) through its public entry points on the
cards the cell asks for, and the last line of stdout is the result: with
`--trace 0` the cell's end-to-end metrics, with `--trace 1` its per-layer
metrics, `correct` from the comparison with the plain reference, and
each compared number beside its limit under "checks". Without enough
CUDA devices it exits 1 and prints no result.
"""

from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# every build and kernel cache inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = os.path.join(ROOT, "build", "bench_cache", sub)

from benchmark.harness import core  # noqa: E402


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unread"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unread"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    core.check_imports("at start")
    bench = core.benchmark_spec()
    if args.workload not in {w["name"] for w in bench["workloads"]}:
        print(f"benchmark: no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 1
    cell = core.cell_spec(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"benchmark: cell {cell['name']} needs {cell['chips']} CUDA devices; "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    import controllable_xgating_torch  # noqa: F401  (fails where the program is missing)

    ctx = {"cell": cell, "seed": args.seed, "seconds": args.seconds, "trace": bool(args.trace),
           "device": "cuda:0", "t0": T0}
    out = core.entry(cell).run(ctx)
    core.check_imports("after the window")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(cell["chips"]), "power_limit": power_limit()}
    result = core.result_line(bench, cell, bool(args.trace), out, device)
    prof = out.get("profile")
    if args.trace and prof:
        print(f"profile: complete {prof['complete']} after {prof['retakes']} retakes, "
              f"{prof['device_events']} device events for {prof['api_calls']} runtime calls, "
              f"launches {prof['launches']} kept {prof['kept']}", file=sys.stderr)
    print(f"notes: {out.get('notes')}", file=sys.stderr)
    core.emit(result, out["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
