"""What every run shares: finding a cell and its pieces by name, the
import guard, the metrics' readers, and the result line.

A cell `<name>` is `workloads/<name>.json` (its configuration, traffic,
chips, entry kind, the limits of its comparison and its `why`); its
configuration is `configs/<config>.json`, its traffic
`traffic/<traffic>.json` (parameters, with the name of the generator in
`traffic/<generator>.py` that reads them), its entry `entries/<entry>.py`
and each metric `metrics/<metric>.py`. Nothing here names a cell.
"""

from __future__ import annotations

import hashlib
import importlib
import importlib.util
import json
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "controllable_xgating_tpu")


def banned_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of BANNED, compared whole."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in BANNED)


def check_imports(when: str) -> None:
    found = banned_modules()
    if found:
        raise SystemExit(f"benchmark: {when}: modules loaded that a run may not load: {found}")


def load_json(*parts) -> dict:
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def benchmark_spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_spec(name: str) -> dict:
    """The cell, with its configuration and traffic loaded under "model_cfg"
    and "traffic_cfg"."""
    cell = load_json("workloads", f"{name}.json")
    cell["name"] = name
    cell["model_cfg"] = load_json("configs", f"{cell['config']}.json")
    cell["traffic_cfg"] = load_json("traffic", f"{cell['traffic']}.json")
    return cell


def load_module(kind: str, name: str):
    """`benchmark/<kind>/<name>.py` as a module (names may hold dots)."""
    path = os.path.join(BENCH, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(cell: dict):
    return importlib.import_module(f"benchmark.entries.{cell['entry']}")


def traffic(cell: dict):
    return importlib.import_module(f"benchmark.traffic.{cell['traffic_cfg']['generator']}")


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (`tag`) of the run's seed."""
    h = hashlib.blake2b(f"{int(seed)}:{tag}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") >> 1


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries of BENCHMARK.json this cell reports: with trace,
    its per-layer metrics, else its end-to-end ones. A metric with a
    `workloads` key belongs to the cells it lists; a per-layer one without
    it, to every cell that reports the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    have = {m["name"] for m in e2e}

    def belongs(m):
        return cell in m["workloads"] if "workloads" in m else m["moves"] in have

    return [m for m in bench["per_layer"] if belongs(m)]


def read_metrics(entries: list, record: dict) -> dict:
    """{name: {"value", "unit"}} from each metric's reader; a reader that
    finds nothing to read returns None and its metric is left out."""
    out = {}
    for m in entries:
        value = load_module("metrics", m["name"]).read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(bench: dict, cell: dict, trace: bool, out: dict, device: dict) -> dict:
    """The result's keys from an entry's output: the cell's metrics for
    the mode, `device`, and with trace the profile's busy and window
    seconds and the breakdown."""
    metrics = read_metrics(cell_metrics(bench, cell["name"], trace), out["record"])
    device = {**device, "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": bool(out["correct"]), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": device}
    prof = out.get("profile")
    if trace and prof:
        device["busy_s"] = prof["busy_s"]
        device["window_s"] = prof["window_s"]
        result["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    return result


def emit(result: dict, checks: dict) -> None:
    """Print each compared number beside its limit as the last lines of
    stderr, and the result as the last line of stdout, `checks` last."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps({**result, "checks": checks}), flush=True)
