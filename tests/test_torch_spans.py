"""The port's spans and counters (`utils/spans.py`) and what reads them.

On the CPU: spans nest under their parent and share their request's id;
self time is a span's host time less its children's; counters are exact
from many threads; with no collector and no profiler a span, a request
and a count touch neither CUDA nor the profiler and allocate nothing;
under a CPU `torch.profiler` the spans are `cxg.*` ranges inside an
outer range, on the profile's clock; the decode loops' spans and
counters in the eager loop and the chunk runner; the caption path's
spans; the train loop's log fields; `tools/trace_ops.py`'s attribution
of idle time and launch calls to the innermost span. Marked `gpu` and
skipped without a card: a span inside a CUDA graph capture records no
event and the capture succeeds. This file imports no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_spans.py
"""

import json
import sys
import threading
import time
from types import SimpleNamespace

import pytest
import torch

from controllable_xgating_torch.infer import graphs
from controllable_xgating_torch.ops import kernels
from controllable_xgating_torch.tools import trace_ops
from controllable_xgating_torch.train import loop as t_loop
from controllable_xgating_torch.utils import spans
from controllable_xgating_torch.utils.config import Config
from controllable_xgating_torch.utils.logging import JsonlLogger


def kept(col) -> dict:
    """The collector's spans by name (one each)."""
    return {s.name: s for s in col.spans}


# --- the collector ---


def test_spans_nest_with_parent_and_request_id():
    with spans.collect() as col:
        with spans.request():
            with spans.span("call"):
                with spans.span("call.inner"):
                    pass
                with spans.span("call.next"):
                    pass
        with spans.span("alone"):
            pass
        with spans.request():
            with spans.span("second"):
                pass
    k = kept(col)
    assert k["call.inner"].parent is k["call"] and k["call.next"].parent is k["call"]
    assert k["call"].parent is None and k["alone"].parent is None
    assert k["call"].request == k["call.inner"].request == k["call.next"].request
    ids = {k["call"].request, k["alone"].request, k["second"].request}
    assert len(ids) == 3  # a span outside any request gets a fresh id
    got = col.summary()
    assert got["requests"] == 2
    assert {n: d["n"] for n, d in got["spans"].items()} == {
        "call": 1, "call.inner": 1, "call.next": 1, "alone": 1, "second": 1}
    assert all(d["device_ms"] is None for d in got["spans"].values())  # no card here
    assert spans.installed() is None


def test_self_time_is_the_span_less_its_children():
    with spans.collect() as col:
        with spans.span("outer"):
            time.sleep(0.002)
            for _ in range(2):
                with spans.span("outer.child"):
                    time.sleep(0.003)
                    with spans.span("outer.child.leaf"):
                        time.sleep(0.001)
    got = col.summary()["spans"]
    k = {s.name: s for s in col.spans if s.name != "outer.child"}
    children = [s for s in col.spans if s.name == "outer.child"]
    want = (k["outer"].t1 - k["outer"].t0 - sum(c.t1 - c.t0 for c in children)) / 1e6
    assert got["outer"]["self_ms"] == pytest.approx(want, rel=1e-12)
    assert got["outer"]["self_ms"] >= 2.0
    assert got["outer.child"]["self_ms"] == pytest.approx(
        got["outer.child"]["host_ms"] - got["outer.child.leaf"]["host_ms"], rel=1e-9)
    assert got["outer.child.leaf"]["self_ms"] == got["outer.child.leaf"]["host_ms"]


def test_counters_are_exact_from_many_threads():
    threads, each = 12, 3000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with spans.collect() as col:
            def work():
                for i in range(each):
                    spans.count("c")
                    spans.count("d", 2)
                    with spans.span("t"):
                        pass

            ts = [threading.Thread(target=work) for _ in range(threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(60)
                assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    got = col.summary()
    assert got["counters"] == {"c": threads * each, "d": 2 * threads * each}
    assert got["spans"]["t"]["n"] == threads * each


def test_requests_read_the_wrappers_launch_counters_once():
    with spans.collect() as col:
        with spans.request():
            kernels.WRAPPERS["attn_lstm"].launches += 3
        with spans.request():
            kernels.WRAPPERS["attn_lstm"].launches += 2
            kernels.WRAPPERS["topk_tail"].launches += 1
        kernels.WRAPPERS["attn_lstm"].launches += 7  # outside any request
    got = col.summary()
    assert got["requests"] == 2 and got["launches"] == {"attn_lstm": 5, "topk_tail": 1}


def test_collectors_nest_and_clear():
    with spans.collect() as outer:
        spans.count("a")
        with spans.collect() as inner:
            spans.count("b")
            assert spans.installed() is inner
        assert spans.installed() is outer
        spans.count("a")
        inner_got = inner.summary()["counters"]
        outer.clear()
        spans.count("c")
    assert inner_got == {"b": 1} and outer.summary()["counters"] == {"c": 1}
    assert spans.installed() is None


def test_dormant_spans_touch_neither_cuda_nor_the_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a dormant span called CUDA or the profiler")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", refuse)
    assert spans.installed() is None and not spans.profiling()
    made = [spans.span("x", device=True), spans.span("y"), spans.request()]
    assert all(m is made[0] for m in made)  # one shared null context: nothing allocated
    with spans.request():
        with spans.span("encode", device=True):
            spans.count("graphs.replays.beam")
    # the caption path's spans and the loops' under the chunk runner, dormant
    m = tiny_model()
    from controllable_xgating_torch.infer.beam import make_beam_caption_fn
    from controllable_xgating_torch.ops.dispatch import set_decode_graphs

    set_decode_graphs("chunks")
    try:
        make_beam_caption_fn(3, 5, 6)(m.params, *m.inputs)
    finally:
        set_decode_graphs(None)


def test_cpu_profiler_sees_cxg_ranges_inside_an_outer_range(tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.call"):
            with spans.span("encode", device=True):
                with spans.span("encode.bilstm", device=True):
                    torch.randn(64, 64) @ torch.randn(64, 64)
    assert not spans.profiling()
    ev = {e.name: e.time_range for e in prof.events()
          if e.name in ("bench.call", "cxg.encode", "cxg.encode.bilstm")}
    assert set(ev) == {"bench.call", "cxg.encode", "cxg.encode.bilstm"}
    assert ev["bench.call"].start <= ev["cxg.encode"].start <= ev["cxg.encode.bilstm"].start
    assert ev["cxg.encode.bilstm"].end <= ev["cxg.encode"].end <= ev["bench.call"].end
    mm = [e.time_range for e in prof.events() if e.name == "aten::mm"]
    assert mm and ev["cxg.encode.bilstm"].start <= mm[0].start <= ev["cxg.encode.bilstm"].end
    # the exported trace keeps them on its one clock, and the parser finds them
    path = tmp_path / "cpu.pt.trace.json"
    prof.export_chrome_trace(str(path))
    got = trace_ops.parse_trace(str(tmp_path))["program"]
    assert {n: d["n"] for n, d in got["spans"].items()} == {"encode": 1, "encode.bilstm": 1}
    assert got["busy_us"] == 0 and got["idle_us_by_span"]["encode.bilstm"] > 0


# --- the decode loops ---


class Countdown(graphs.StepLoop):
    """A loop whose row i finishes after steps[i] steps (CPU tensors)."""

    kind = "countdown"

    def __init__(self, steps):
        self.steps, self.device = torch.tensor(steps), torch.device("cpu")

    def prepare(self) -> dict:
        return {"steps": self.steps.clone()}

    def init(self) -> dict:
        return {"t": torch.zeros_like(self.steps), "ran": torch.zeros((), dtype=torch.long)}

    def step(self, carry: dict, t: int) -> None:
        live = carry["t"] < self.inp["steps"]
        carry["t"] = carry["t"] + live.long()
        carry["ran"] = carry["ran"] + 1

    def done(self, carry: dict) -> torch.Tensor:
        return (carry["t"] >= self.inp["steps"]).all()

    def finish(self, carry: dict) -> int:
        return int(carry["ran"])


@pytest.mark.parametrize("early_stop", [False, True])
@pytest.mark.parametrize("mode", ["chunks", False], ids=["chunks", "eager"])
def test_loops_count_chunks_and_keep_their_spans(mode, early_stop):
    """9 steps in chunks of 4 (3 chunks); every row done after 2 steps.
    The chunk runner counts the chunks it ran of those a call has (as
    `graphs.LAST` did); with `early_stop` it stops two chunks after the
    first that finished, reading one flag a chunk late. The eager loop
    counts no chunks; both keep setup, replay and finish spans, and a
    wait span per flag they read."""
    with spans.collect() as col:
        ran = graphs.run(Countdown([2, 1, 2]), 9, early_stop, graphs=mode)
    got = col.summary()
    counters, by_name = got["counters"], {n: d["n"] for n, d in got["spans"].items()}
    if mode == "chunks":
        assert ran == (8 if early_stop else 9)  # chunk 2 runs only if chunk 0 had not finished
        assert counters["graphs.replays.countdown"] == (2 if early_stop else 3)
        assert counters["graphs.chunks_of.countdown"] == 3
        assert "graphs.captures.countdown" not in counters
        n_replays = counters["graphs.replays.countdown"]
        assert by_name["countdown.wait"] == n_replays
    else:
        assert ran == (2 if early_stop else 9)
        assert not any(k.startswith("graphs.") for k in counters)
        n_replays = ran
        assert by_name.get("countdown.wait", 0) == (3 if early_stop else 0)
    assert by_name["countdown.setup"] == by_name["countdown.finish"] == 1
    assert by_name["countdown.replay"] == n_replays
    assert "countdown.capture" not in by_name


def test_graphed_loop_counts_a_capture_then_replays(monkeypatch):
    """The graphs' path (capture and replays stubbed: the CPU has none):
    one capture span and count at a key's first sight, inside the setup
    span; on the next call none, and one set-up replayed from the
    prologue; chunks replayed and waited on."""
    def capture(loop, chunks):
        loop.bind(loop.prepare())
        carry = loop.init()
        return SimpleNamespace(loop=loop, carry=carry, spans=chunks, capture_s=0.0,
                               pool_bytes=0, setup=lambda: None,
                               finish=lambda: loop.finish(carry))

    def replay(entry, early_stop):
        for _ in entry.spans:
            with spans.span("countdown.replay"):
                pass
        return len(entry.spans)

    monkeypatch.setattr(graphs, "resolve_mode", lambda *a: "graphs")
    monkeypatch.setattr(graphs, "_capture", capture)
    monkeypatch.setattr(graphs, "_replay", replay)
    monkeypatch.setattr(graphs, "copy_tree", lambda dst, src: None)
    graphs.clear()
    try:
        with spans.collect() as col:
            graphs.run(Countdown([1]), 6, False)
            first = col.summary()
            col.clear()
            graphs.run(Countdown([1]), 6, False)
            second = col.summary()
    finally:
        graphs.clear()
    assert first["counters"] == {"graphs.captures.countdown": 1,
                                 "graphs.replays.countdown": 2, "graphs.chunks_of.countdown": 2}
    assert second["counters"] == {"graphs.setups.countdown": 1,
                                  "graphs.replays.countdown": 2, "graphs.chunks_of.countdown": 2}
    assert first["spans"]["countdown.capture"]["n"] == 1
    assert "countdown.capture" not in second["spans"]
    assert first["spans"]["countdown.setup"]["self_ms"] < first["spans"]["countdown.setup"][
        "host_ms"]
    assert second["spans"]["countdown.replay"]["n"] == 2


# --- the caption path ---


def tiny_model():
    from controllable_xgating_torch.models.captioner import init_captioner

    cfg = Config().replace_flat({
        "model.app_dim": 12, "model.motion_dim": 10, "model.hidden_dim": 16,
        "model.embed_dim": 8, "model.attn_dim": 8, "model.pos_embed_dim": 8,
        "model.vocab_size": 30, "model.pos_vocab_size": 9, "model.num_frames": 4})
    params = init_captioner(cfg, seed=3, device="cpu")
    g = torch.Generator().manual_seed(5)
    return SimpleNamespace(params=params, inputs=(torch.randn(3, 4, 12, generator=g),
                                                  torch.randn(3, 4, 10, generator=g)))


@pytest.mark.parametrize("tags", ["rollout", "given", "mixed"])
def test_caption_call_spans(tags):
    """One beam caption call as a request: `encode` holds the fusion, the
    BiLSTM, the POS rollout or forward and the context; `beam` holds the
    loop's spans; the outputs are those of a call with no collector."""
    from controllable_xgating_torch.infer.beam import beam_search
    from controllable_xgating_torch.models.captioner import encode_for_inference

    m = tiny_model()
    kw = {}
    if tags != "rollout":
        kw["pos_tags"] = torch.randint(0, 9, (3, 5), generator=torch.Generator().manual_seed(1))
    if tags == "mixed":
        kw["use_tags"] = torch.tensor([True, False, True])

    def call():
        with torch.inference_mode():
            ctx, s, out_tags = encode_for_inference(m.params, *m.inputs, max_pos_len=5,
                                                    early_stop=True, **kw)
            return beam_search(m.params.decoder, ctx, s, 3, 6, early_stop=True), out_tags

    want = call()
    with spans.collect() as col:
        with spans.request():
            got = call()
    assert all(torch.equal(a, b) for a, b in zip((*got[0], got[1]), (*want[0], want[1])))
    parent = {s.name: (s.parent.name if s.parent else None) for s in col.spans}
    pos = {"rollout": ["pos.rollout"], "given": ["pos.forward"],
           "mixed": ["pos.rollout", "pos.forward"]}[tags]
    for child in ["encode.fuse", "encode.bilstm", *pos, "encode.context"]:
        assert parent[child] == "encode"
    assert parent["encode"] is None and parent["beam"] is None
    for name in ("beam.setup", "beam.finish", "beam.replay", "beam.wait"):
        assert parent[name] == "beam"
    if "pos.rollout" in pos:
        assert parent["pos.setup"] == "pos.rollout"
    assert len({s.request for s in col.spans}) == 1 and col.summary()["requests"] == 1


@pytest.mark.parametrize("mode", ["chunks", pytest.param("graphs", marks=pytest.mark.gpu)])
def test_bilstm_loop_spans_nest_under_encode_bilstm(mode):
    """Over 26 frames the encoder's BiLSTM runs as a loop of 7 chunks
    (the chunk runner on the CPU, the captured graphs on the card): its
    `bilstm.*` spans nest under `encode.bilstm` and every call counts 7
    replays of 7 chunks; on the card the first call captures and the
    second does not."""
    from controllable_xgating_torch.infer import graphs as t_graphs
    from controllable_xgating_torch.models.captioner import encode_for_inference
    from controllable_xgating_torch.ops.dispatch import set_decode_graphs

    if mode == "graphs" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda:0" if mode == "graphs" else "cpu")
    m = tiny_model()
    params = m.params.to(dev)
    g = torch.Generator().manual_seed(6)
    app, mot = torch.randn(3, 26, 12, generator=g), torch.randn(3, 26, 10, generator=g)
    t_graphs.clear()
    set_decode_graphs("chunks" if mode == "chunks" else None)
    try:
        calls = []
        for _ in range(2):
            with spans.collect() as col, spans.request(), torch.inference_mode():
                encode_for_inference(params, app.to(dev), mot.to(dev), max_pos_len=5)
            calls.append(col)
    finally:
        set_decode_graphs(None)
        t_graphs.clear()
    for i, col in enumerate(calls):
        parent = {s.name: (s.parent.name if s.parent else None) for s in col.spans}
        names = {n for n in parent if n.startswith("bilstm.")}
        assert {"bilstm.setup", "bilstm.replay", "bilstm.finish"} <= names
        for n in names - {"bilstm.capture"}:
            assert parent[n] == "encode.bilstm", n
        counters = col.summary()["counters"]
        assert counters["graphs.replays.bilstm"] == counters["graphs.chunks_of.bilstm"] == 7
        assert col.summary()["spans"]["bilstm.replay"]["n"] == 7
        captured = counters.get("graphs.captures.bilstm", 0)
        assert captured == (1 if mode == "graphs" and i == 0 else 0)
        if captured:
            assert parent["bilstm.capture"] == "bilstm.setup"


# --- the train loop's log line ---


class Batches:
    batch_size = 2

    def steps_per_epoch(self) -> int:
        return 3

    def __iter__(self):
        return iter([{"i": i} for i in range(6)])


def test_train_loop_logs_its_spans_under_a_collector(tmp_path):
    cfg = Config().replace_flat({"train.eval_every_epochs": 1000, "train.log_every_steps": 1,
                                 "data.num_prefetch": 2})
    step = lambda state, batch: (state, {"loss": torch.zeros(())})
    for traced in (False, True):
        path = tmp_path / f"{traced}.jsonl"
        with JsonlLogger(str(path), echo=False) as jsonl:
            if traced:
                with spans.collect() as col:
                    t_loop.train_loop(SimpleNamespace(step=0), step, Batches(), None, None,
                                      None, cfg, epochs=1, jsonl=jsonl)
                    left = col.summary()
            else:
                t_loop.train_loop(SimpleNamespace(step=0), step, Batches(), None, None, None,
                                  cfg, epochs=1, jsonl=jsonl)
        lines = [json.loads(x) for x in path.read_text().splitlines()]
        assert len(lines) == 3
        for line in lines:
            if traced:
                assert {"batch_wait_ms", "prefetch_depth"} <= set(line)
                assert line["batch_wait_ms"] >= 0 and 0 <= line["prefetch_depth"] <= 2
                assert "allreduce_ms" not in line  # no process group
            else:
                assert not {"batch_wait_ms", "prefetch_depth", "allreduce_ms"} & set(line)
    assert left["spans"] == {}  # each log line drops what it read


def test_span_fields_read_the_allreduce():
    with spans.collect() as col:
        for depth in (2, 1):
            with spans.span("train.batch_wait"):
                spans.count("prefetch.depth", depth)
            with spans.span("train.allreduce", device=True):
                time.sleep(0.001)
        got = t_loop._span_fields()
    assert set(got) == {"batch_wait_ms", "prefetch_depth", "allreduce_ms"}
    assert got["prefetch_depth"] == 1.5 and got["allreduce_ms"] >= 1.0
    assert col.summary()["spans"] == {}
    assert t_loop._span_fields() == {}  # no collector


# --- the trace's attribution ---


def x(cat, name, ts, dur, **kw):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, **kw}


def test_attribution_puts_each_gap_under_its_innermost_span():
    """Spans encode [0, 100) > encode.bilstm [10, 60), beam [120, 200) >
    beam.replay [130, 140), beam.wait [150, 190); device busy [5, 20),
    [40, 45), [70, 110), [135, 160). Idle: [0, 5) encode, [20, 40) and
    [45, 60) encode.bilstm, [60, 70) encode, [110, 120) none, [120, 130)
    beam, [130, 135) beam.replay, [160, 190) beam.wait, [190, 200) beam."""
    events = [
        x("user_annotation", "cxg.encode", 0, 100), x("user_annotation", "cxg.encode.bilstm", 10, 50),
        x("user_annotation", "cxg.beam", 120, 80), x("user_annotation", "cxg.beam.replay", 130, 10),
        x("user_annotation", "cxg.beam.wait", 150, 40), x("user_annotation", "bench.encode", 0, 100),
        x("kernel", "k1", 5, 15), x("kernel", "k2", 40, 5), x("gpu_memcpy", "copy", 70, 40),
        x("kernel", "k3", 135, 25),
        x("cuda_runtime", "cudaLaunchKernel", 4, 1), x("cuda_runtime", "cudaLaunchKernel", 12, 1),
        x("cuda_runtime", "cudaLaunchKernel", 30, 1), x("cuda_runtime", "cudaMemcpyAsync", 65, 1),
        x("cuda_runtime", "cudaGraphLaunch", 131, 1), x("cuda_runtime", "cudaLaunchKernel", 112, 1),
        x("cpu_op", "aten::mm", 11, 30),
    ]
    got = trace_ops.program_attribution(events)
    assert got["window_us"] == 200 and got["busy_us"] == 85 and got["idle_us"] == 115
    assert got["idle_us_by_span"] == {"encode": 15, "encode.bilstm": 35, trace_ops.NO_SPAN: 10,
                                      "beam": 20, "beam.replay": 5, "beam.wait": 30}
    assert got["launch_calls_by_span"] == {"encode": 2, "encode.bilstm": 2, trace_ops.NO_SPAN: 1}
    assert got["spans"]["encode"] == {"n": 1, "host_us": 100, "idle_us": 50}
    assert got["spans"]["encode.bilstm"] == {"n": 1, "host_us": 50, "idle_us": 35}
    assert got["spans"]["beam.wait"] == {"n": 1, "host_us": 40, "idle_us": 30}
    assert "bench.encode" not in got["spans"]
    assert trace_ops.program_attribution([x("kernel", "k", 0, 5)]) == {}


def test_parse_trace_sums_the_attribution_over_its_traces(tmp_path):
    """`parse_trace` adds the attribution of every trace that has spans."""
    events = [x("user_annotation", "cxg.beam", 0, 10), x("kernel", "k", 2, 3),
              x("cuda_runtime", "cudaLaunchKernel", 1, 1)]
    for name, evs in (("a", events), ("b", events), ("c", [x("kernel", "k", 0, 4)])):
        (tmp_path / f"{name}.pt.trace.json").write_text(json.dumps({"traceEvents": evs}))
    got = trace_ops.parse_trace(str(tmp_path))["program"]
    assert got["window_us"] == 20 and got["idle_us"] == 14
    assert got["idle_us_by_span"] == {"beam": 14} and got["launch_calls_by_span"] == {"beam": 2}
    assert got["spans"] == {"beam": {"n": 2, "host_us": 20, "idle_us": 14}}


# --- on the card ---


@pytest.mark.gpu
def test_span_inside_a_graph_capture_records_no_event():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda:0")
    x_in = torch.ones(64, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        y = x_in * 2  # warm-up off the default stream, as captures want
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with spans.collect() as col:
        with spans.span("outside", device=True):
            with torch.cuda.graph(graph, stream=side):
                with spans.span("inside", device=True):
                    y = x_in * 2 + 1
        graph.replay()
        got = col.summary()
    torch.cuda.synchronize()
    assert torch.equal(y, torch.full_like(x_in, 3.0))
    k = kept(col)
    assert k["inside"].events is None and got["spans"]["inside"]["device_ms"] is None
    assert k["outside"].events is not None and got["spans"]["outside"]["device_ms"] >= 0.0
