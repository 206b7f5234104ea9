"""A run's last line keeps to the contract; a run without a card fails
and prints no result; the import guard compares whole top-level names,
and the reference and the cost model load nothing of the program."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from benchmark.entries import caption_beam
from benchmark.harness import core
from benchmark.tests import tiny


def test_result_line_keys_as_the_contract_says(capsys):
    cell = tiny.caption_cell()
    out = caption_beam.run(tiny.ctx(cell))
    device = {"platform": "gpu", "kind": "a test's stand-in", "count": 1}
    result = core.result_line(core.benchmark_spec(), cell, False, out, device)
    core.emit(result, out["checks"])
    std = capsys.readouterr()
    line = json.loads(std.out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"captions_per_s", "caption_batch_p95_ms", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["checks"]) == {"caption_gap", "tag_gap", "score_gap", "beam_differs"}
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())
    assert std.err.strip().splitlines()[-1] == "correct: True"


def test_run_without_a_card_fails_with_no_result(tmp_path):
    # here torch has no CUDA: the run must refuse, not fall back to the CPU
    cmd = [sys.executable, "benchmark/run.py", "--workload", "msrvtt.beam5_b256",
           "--seed", str(2 ** 33 + 1), "--seconds", "1", "--trace", "0"]
    got = subprocess.run(cmd, cwd=core.ROOT, capture_output=True, text=True, timeout=120)
    assert got.returncode != 0 and got.stdout.strip() == ""
    assert "CUDA" in got.stderr


def test_guard_compares_whole_top_level_names(monkeypatch):
    assert core.banned_modules() == []
    for name in ("jaxline_like", "controllable_xgating_torch_x", "jax_free"):
        monkeypatch.setitem(sys.modules, name, object())
    assert core.banned_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "controllable_xgating_tpu.ops", object())
    assert core.banned_modules() == ["controllable_xgating_tpu", "jax"]


def test_reference_and_cost_load_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.caption, benchmark.cost\n"
            "tops = {m.split('.')[0] for m in sys.modules}\n"
            "bad = tops & {'controllable_xgating_torch', 'controllable_xgating_tpu', 'jax', "
            "'jaxlib', 'flax', 'optax', 'orbax'}\n"
            "print(sorted(bad))" % core.ROOT)
    got = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ""})
    assert got.returncode == 0 and got.stdout.strip() == "[]", got.stderr
