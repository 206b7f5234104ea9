"""The per-layer metrics read from the program's spans and from the
profile's copies: each reader gives nothing without what it reads and the
per-call value from a summary made by hand; a traced run at a CPU size
keeps the program's set-up and window summaries, an untraced one installs
no collector; an idle gap is named by the program's span open at its
start before the benchmark's."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from benchmark.entries import caption_beam
from benchmark.harness import core, trace
from benchmark.tests import tiny


def _span(host_ms, device_ms=None, n=1):
    return {"n": n, "host_ms": host_ms, "self_ms": host_ms, "device_ms": device_ms}


SUMMARY = {
    "setup": {"requests": 2, "counters": {}, "launches": {},
              "spans": {"setup.init": _span(900.0), "beam.setup": _span(700.0),
                        "beam.capture": _span(600.0), "pos.capture": _span(300.0),
                        "bilstm.capture": _span(150.0)}},
    "window": {"requests": 4, "counters": {}, "launches": {},
               "spans": {"encode.bilstm": _span(20.0, 14.0, 4), "pos.rollout": _span(40.0, 30.0, 4),
                         "beam.setup": _span(20.0, None, 4), "pos.setup": _span(12.0, None, 4),
                         "bilstm.setup": _span(4.0, None, 4), "setup.library": _span(99.0),
                         "beam.wait": _span(16.0, None, 28), "pos.wait": _span(8.0, None, 28),
                         "beam.replay": _span(50.0, None, 28)}},
}
EXPECTED = {"bilstm_ms.caption": 3.5, "pos_rollout_ms.caption": 7.5,
            "loop_setup_ms.caption": 9.0, "host_wait_ms.caption": 6.0,
            "capture_s.caption": 1.05}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_program_span_readers(name):
    read = core.load_module("metrics", name).read
    assert read({}) is None and read({"calls": 3, "trace": True}) is None
    assert read({"program": SUMMARY}) == pytest.approx(EXPECTED[name])


def test_input_copy_reader():
    read = core.load_module("metrics", "input_copy_ms.caption").read
    prof = {"complete": True, "reps": 4, "copy_s": 0.0552}
    assert read({}) is None and read({"program": SUMMARY}) is None
    assert read({"profile": dict(prof, complete=False)}) is None
    assert read({"profile": prof}) == pytest.approx(13.8)


def test_traced_run_keeps_the_programs_spans():
    out = caption_beam.run(dict(tiny.ctx(tiny.caption_cell()), trace=True))
    rec = out["record"]
    assert out["correct"], out["checks"]
    win, setup = rec["program"]["window"], rec["program"]["setup"]
    assert win["requests"] == rec["calls"] and setup["requests"] == 2
    for name in ("encode", "encode.bilstm", "pos.rollout", "pos.setup", "pos.wait", "beam",
                 "beam.setup", "beam.wait", "beam.replay"):
        assert win["spans"][name]["n"] >= rec["calls"], name
    assert "setup.init" in setup["spans"] and "beam.setup" in setup["spans"]
    for name in ("loop_setup_ms.caption", "host_wait_ms.caption"):
        assert core.load_module("metrics", name).read(rec) > 0


def test_untraced_run_installs_no_collector(monkeypatch):
    from controllable_xgating_torch.utils import spans

    def refuse():
        raise AssertionError("an untraced run installed a collector")

    monkeypatch.setattr(spans, "collect", refuse)
    out = caption_beam.run(tiny.ctx(tiny.caption_cell()))
    assert out["correct"] and "program" not in out["record"] and spans.installed() is None


def _event(name, start, end, device=DeviceType.CPU):
    return SimpleNamespace(name=name, device_type=device, is_user_annotation=False,
                           time_range=SimpleNamespace(start=start, end=end))


def test_gaps_named_by_program_span_first():
    cuda = DeviceType.CUDA
    events = [_event("bench.window", 0, 100), _event("bench.call", 0, 90),
              _event("bench.decode", 40, 90), _event("cxg.beam", 40, 90),
              _event("cxg.beam.setup", 40, 60),
              _event("Memcpy HtoD (Pageable -> Device)", 5, 30, cuda),
              _event("kernel_a", 30, 40, cuda), _event("kernel_b", 70, 80, cuda),
              _event("Memcpy HtoD (Pinned -> Device)", 91, 92, cuda)]
    prof = SimpleNamespace(events=lambda: events)
    got = trace._read(prof, {})
    gaps = {name: s for name, s in got["idle_gaps"]}
    assert gaps == pytest.approx({"cxg.beam.setup": 30e-6, "bench.call": 5e-6, "cxg.beam": 11e-6,
                                  trace.NO_SPAN: 8e-6})
    assert len(got["idle_gaps"]) == 4
    assert got["copy_s"] == pytest.approx(26e-6)
    assert got["busy_s"] == pytest.approx(46e-6) and got["window_s"] == pytest.approx(100e-6)
