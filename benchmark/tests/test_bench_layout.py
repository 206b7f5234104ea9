"""The harness finds every piece of a cell by name, BENCHMARK.json keeps
to the benchmark's contract, and a cell, a configuration and a per-layer
metric are added by new files alone."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from benchmark.harness import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_contract_keys_and_limits():
    b = core.benchmark_spec()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    cells = len(b["workloads"])
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, cells // 4)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(n for n in names)) == len(names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(core.ROOT, c["file"]))
        f = json.load(open(os.path.join(core.ROOT, c["file"])))
        assert f["reduced"] == c["reduced"] and f["source"] == c["source"]
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
        assert w["chips"] in (1, 4)
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in b["end_to_end"])
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
    for w in b["workloads"]:
        got = {m["name"] for m in core.cell_metrics(b, w["name"], False)}
        assert "setup_s" in got and len(got) >= 2
        for m in core.cell_metrics(b, w["name"], True):
            assert m["moves"] in got, (w["name"], m["name"])
        assert core.cell_metrics(b, w["name"], True)


def test_every_piece_found_by_name():
    b = core.benchmark_spec()
    for w in b["workloads"]:
        cell = core.cell_spec(w["name"])
        assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
        assert cell["chips"] == w["chips"] and cell["why"] == w["why"]
        assert hasattr(core.entry(cell), "run") and hasattr(core.traffic(cell), "make")
        assert cell["limits"]
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(core.load_module("metrics", m["name"]).read)
        assert core.load_module("metrics", m["name"]).read({}) is None


def test_every_cell_file_loads():
    """Every workload file loads with every piece, and every metric file
    has a reader."""
    names = [f[:-5] for f in os.listdir(os.path.join(core.BENCH, "workloads")) if f.endswith(".json")]
    assert names
    for name in names:
        cell = core.cell_spec(name)
        assert hasattr(core.entry(cell), "run") and hasattr(core.traffic(cell), "make")
        assert NAME.match(name) and len(cell["why"]) <= 200 and cell["limits"]
    for f in os.listdir(os.path.join(core.BENCH, "metrics")):
        if f.endswith(".py"):
            assert callable(core.load_module("metrics", f[:-3]).read)


def test_a_cell_config_and_metric_added_as_files_only(tmp_path, monkeypatch):
    """A throwaway cell on a new configuration, with a new per-layer metric,
    is found and read from new files in a copy of the benchmark."""
    dst = tmp_path / "benchmark"
    shutil.copytree(core.BENCH, dst, ignore=shutil.ignore_patterns("__pycache__"))
    bench = core.benchmark_spec()
    before = {p: open(os.path.join(dst, p)).read() for p in
              ("workloads/msrvtt.beam5_b256.json", "configs/msrvtt.json")}
    cfg = json.load(open(dst / "configs" / "msrvtt.json"))
    cfg["model"]["motion_dim"] = 4096
    (dst / "configs" / "msvd_c3d.json").write_text(json.dumps(cfg))
    cell = json.load(open(dst / "workloads" / "msrvtt.beam5_b256.json"))
    cell["config"] = "msvd_c3d"
    (dst / "workloads" / "msvd_c3d.beam5_b256.json").write_text(json.dumps(cell))
    (dst / "metrics" / "calls.caption.py").write_text(
        "def read(rec):\n    return rec.get('calls')\n")
    bench["configs"].append({"name": "msvd_c3d", "source": "x", "file": "benchmark/configs/msvd_c3d.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "msvd_c3d.beam5_b256", "config": "msvd_c3d",
                               "traffic": "msrvtt_split_b256", "chips": 1, "why": "x"})
    bench["end_to_end"][0]["workloads"].append("msvd_c3d.beam5_b256")
    bench["per_layer"].append({"name": "calls.caption", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "whole call",
                               "moves": "captions_per_s", "workloads": ["msvd_c3d.beam5_b256"]})
    monkeypatch.setattr(core, "BENCH", str(dst))
    got = core.cell_spec("msvd_c3d.beam5_b256")
    assert got["model_cfg"]["model"]["motion_dim"] == 4096 and got["entry"] == "caption_beam"
    names = [m["name"] for m in core.cell_metrics(bench, "msvd_c3d.beam5_b256", True)]
    assert names == ["calls.caption"]
    assert core.read_metrics(core.cell_metrics(bench, "msvd_c3d.beam5_b256", True),
                             {"calls": 7}) == {"calls.caption": {"value": 7.0, "unit": "calls"}}
    assert all(open(os.path.join(dst, p)).read() == s for p, s in before.items())


@pytest.mark.parametrize("tag", ["weights", "traffic", "loader"])
def test_derived_seeds_differ_and_repeat(tag):
    big = 2 ** 33 + 12345
    assert core.derive(big, tag) == core.derive(big, tag)
    assert core.derive(big, tag) != core.derive(big + 1, tag)
    assert 0 <= core.derive(big, tag) < 2 ** 63
