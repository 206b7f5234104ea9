"""The port's decode loops split as the reference's scan and run through
the chunk runner of `infer/graphs.py`, vs the JAX package, on the CPU.

`set_decode_graphs("chunks")` runs every loop as the card runs it, in
chunks of 4 steps with the early exit read at chunk granularity, but
with the chunks stepped eagerly (the CPU has no CUDA graphs). Greedy
(with `vocab_q` and the `lanes` opt-in), beam (every tail, `return_all`,
the length penalty, `vocab_q`), diverse beam, ensembles of one and of two
architectures and the POS rollout must give JAX's tokens and tags exactly,
under `early_stop=True` (JAX's while loop) and against its scan, at
lengths 4 does not divide; scores and psi within rtol 1e-5, atol 1e-6.
Then the cache key, the launch accounting on fake counters, the runner's
early exit, and that the CPU never takes graphs.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_xgating_tpu.infer import beam as j_beam
from controllable_xgating_tpu.infer import ensemble as j_ens
from controllable_xgating_tpu.infer import evaluator as j_eval
from controllable_xgating_tpu.infer import greedy as j_greedy
from controllable_xgating_tpu.models import captioner as j_cap
from controllable_xgating_tpu.models import pos_generator as j_pos
from controllable_xgating_tpu.utils.config import Config
from controllable_xgating_torch.experiments import int8_vocab_matmul as t_q
from controllable_xgating_torch.infer import beam as t_beam
from controllable_xgating_torch.infer import ensemble as t_ens
from controllable_xgating_torch.infer import evaluator as t_eval
from controllable_xgating_torch.infer import graphs
from controllable_xgating_torch.infer import greedy as t_greedy
from controllable_xgating_torch.models import captioner as t_cap
from controllable_xgating_torch.models import pos_generator as t_pos
from controllable_xgating_torch.models.decoder import DecodeContext
from controllable_xgating_torch.ops import kernels
from controllable_xgating_torch.ops.dispatch import set_decode_graphs, set_fused_kernels
from controllable_xgating_torch.ops.precision import precision
from controllable_xgating_torch.utils import spans
from experiments import int8_vocab_matmul as j_q
from test_torch_ensemble import ALT, BASE
from test_torch_quant import make_cfg, numpy_params

torch.set_num_threads(1)
T = torch.from_numpy
MAX_POS = 7
LENGTHS = [9, 7]  # 4 divides neither: a short last chunk
SCORE_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture
def chunks():
    """Every loop through the chunk runner, for this test only, under a
    span collector (yielded) that counts the chunks run."""
    set_decode_graphs("chunks")
    try:
        with spans.collect() as col:
            yield col
    finally:
        set_decode_graphs(None)


@pytest.fixture(scope="module")
def m():
    """Both packages' weights (vocab 40, captions of mixed lengths), a
    batch of 3 videos with ragged frame masks, its decode contexts and
    both packages' quantized projections; two more members of the
    ensemble test's widths, one of another architecture."""
    jp, tp = numpy_params(make_cfg(40), 61, eos_bias=0.6)
    rng = np.random.default_rng(62)
    app = rng.standard_normal((3, 5, 12)).astype(np.float32)
    mot = rng.standard_normal((3, 5, 10)).astype(np.float32)
    mask = np.array([[1, 1, 1, 1, 1], [1, 1, 1, 0, 0], [1, 1, 0, 0, 0]], np.float32)
    jctx, jsum, _ = j_cap.encode_for_inference(
        jp, jnp.asarray(app), jnp.asarray(mot), jnp.asarray(mask), max_pos_len=MAX_POS)
    tctx, tsum, _ = t_cap.encode_for_inference(tp, T(app), T(mot), T(mask), max_pos_len=MAX_POS)
    e0, e1, ea = (numpy_params(Config().replace_flat(c), s) for c, s in
                  ((BASE, 63), (BASE, 64), (ALT, 65)))
    erng = np.random.default_rng(66)
    e_in = (erng.standard_normal((4, 4, 10)).astype(np.float32),
            erng.standard_normal((4, 4, 8)).astype(np.float32),
            np.array([[1, 1, 1, 1], [1, 1, 1, 0], [1, 1, 0, 0], [1, 1, 1, 1]], np.float32))
    return SimpleNamespace(
        jp=jp, tp=tp, j_in=(app, mot, mask), t_in=tuple(map(T, (app, mot, mask))),
        jctx=jctx, jsum=jsum, tctx=tctx, tsum=tsum,
        jq=j_q.quantize_vocab_proj(jp.decoder.w_out, jp.decoder.b_out),
        tq=t_q.quantize_vocab_proj(tp.decoder.w_out, tp.decoder.b_out),
        ej=(e0[0], e1[0], ea[0]), et=(e0[1], e1[1], ea[1]), ej_in=e_in,
        et_in=tuple(map(T, e_in)),
    )


def assert_same(tout, jout_stop, jout_scan):
    """Caption outputs: tokens and tags (first and last) equal to both of
    JAX's, scores (a middle output) close."""
    for jout in (jout_stop, jout_scan):
        assert len(tout) == len(jout)
        np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
        np.testing.assert_array_equal(tout[-1].numpy(), np.asarray(jout[-1]))
        if len(tout) == 3:
            np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]), **SCORE_TOL)


def ran_chunks(col, max_len: int, kind: str) -> None:
    """The test's one loop of `kind` went through the chunk runner."""
    counters = col.summary()["counters"]
    of, ran = counters[f"graphs.chunks_of.{kind}"], counters[f"graphs.replays.{kind}"]
    assert of == -(-max_len // 4) and 1 <= ran <= of


# --- greedy ---


@pytest.mark.parametrize("max_len", LENGTHS)
@pytest.mark.parametrize("kw", [{}, {"block_unk": True}], ids=["greedy", "block_unk"])
def test_greedy_caption_fn_chunked_matches_jax(m, chunks, max_len, kw):
    jout = [j_eval.make_greedy_caption_fn(MAX_POS, max_len, early_stop=es, **kw)(m.jp, *m.j_in)
            for es in (True, False)]
    tout = t_eval.make_greedy_caption_fn(MAX_POS, max_len, **kw)(m.tp, *m.t_in)
    assert_same(tout, *jout)
    ran_chunks(chunks, max_len, "greedy")


@pytest.mark.parametrize("max_len", LENGTHS)
@pytest.mark.parametrize("opt", ["vocab_q", "lanes"])
def test_greedy_decode_chunked_matches_jax(m, chunks, max_len, opt):
    jkw, tkw = ({"vocab_q": m.jq}, {"vocab_q": m.tq}) if opt == "vocab_q" else \
        ({"lanes": True}, {"lanes": True})
    jout = [j_greedy.greedy_decode(m.jp.decoder, m.jctx, m.jsum, max_len, early_stop=es, **jkw)
            for es in (True, False)]
    tout = t_greedy.greedy_decode(m.tp.decoder, m.tctx, m.tsum, max_len, fused=True,
                                  early_stop=True, **tkw)
    assert_same((tout,), (jout[0],), (jout[1],))
    ran_chunks(chunks, max_len, "greedy")


# --- beam ---


@pytest.mark.parametrize("max_len", LENGTHS)
@pytest.mark.parametrize("mode", ["lanes", "grouped", "block", "flat"])
@pytest.mark.parametrize("kw", [{}, {"return_all": True, "length_penalty": 1.0}],
                         ids=["best", "return_all_lp"])
def test_beam_caption_fn_chunked_matches_jax(m, chunks, max_len, mode, kw):
    jout = [j_beam.make_beam_caption_fn(4, MAX_POS, max_len, topk_mode=mode, early_stop=es,
                                        **kw)(m.jp, *m.j_in) for es in (True, False)]
    tout = t_beam.make_beam_caption_fn(4, MAX_POS, max_len, topk_mode=mode, **kw)(m.tp, *m.t_in)
    assert_same(tout, *jout)
    ran_chunks(chunks, max_len, "beam")


@pytest.mark.parametrize("max_len", LENGTHS)
@pytest.mark.parametrize("return_all", [False, True])
def test_beam_vocab_q_chunked_matches_jax(m, chunks, max_len, return_all):
    jout = [j_beam.beam_search(m.jp.decoder, m.jctx, m.jsum, 5, max_len, early_stop=es,
                               vocab_q=m.jq, return_all=return_all) for es in (True, False)]
    tout = t_beam.beam_search(m.tp.decoder, m.tctx, m.tsum, 5, max_len, fused=True,
                              early_stop=True, vocab_q=m.tq, return_all=return_all)
    ran_chunks(chunks, max_len, "beam")
    for jt, js in jout:
        np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jt))
        np.testing.assert_allclose(tout[1].numpy(), np.asarray(js), **SCORE_TOL)


@pytest.mark.parametrize("max_len", LENGTHS)
def test_diverse_beam_chunked_matches_jax(m, chunks, max_len):
    kw = dict(diversity_groups=3, diversity_penalty=0.7, return_all=True)
    jout = [j_beam.make_beam_caption_fn(6, MAX_POS, max_len, early_stop=es, **kw)(m.jp, *m.j_in)
            for es in (True, False)]
    tout = t_beam.make_beam_caption_fn(6, MAX_POS, max_len, **kw)(m.tp, *m.t_in)
    assert_same(tout, *jout)
    ran_chunks(chunks, max_len, "beam")


# --- ensembles ---


@pytest.mark.parametrize("max_len", LENGTHS)
@pytest.mark.parametrize("beam", [1, 4], ids=["greedy", "beam4"])
@pytest.mark.parametrize("arch", ["same", "cross"])
def test_ensemble_chunked_matches_jax(m, chunks, max_len, beam, arch):
    kw = {"return_all": True} if beam > 1 else {}
    if arch == "same":
        jfn = j_ens.make_ensemble_caption_fn(beam, MAX_POS, max_len, early_stop=True, **kw)
        jscan = j_ens.make_ensemble_caption_fn(beam, MAX_POS, max_len, early_stop=False, **kw)
        jparams, tparams = j_ens.stack_params(m.ej[:2]), m.et[:2]
    else:
        jfn = j_ens.make_hetero_ensemble_caption_fn(beam, MAX_POS, max_len, early_stop=True, **kw)
        jscan = j_ens.make_hetero_ensemble_caption_fn(beam, MAX_POS, max_len, early_stop=False,
                                                      **kw)
        jparams, tparams = (m.ej[0], m.ej[2]), (m.et[0], m.et[2])
    tout = t_ens.make_ensemble_caption_fn(beam, MAX_POS, max_len, **kw)(tparams, *m.et_in)
    assert_same(tout, jfn(jparams, *m.ej_in), jscan(jparams, *m.ej_in))
    ran_chunks(chunks, max_len, "beam" if beam > 1 else "ensemble_greedy")


# --- the POS rollout ---


@pytest.mark.parametrize("max_len", LENGTHS)
@pytest.mark.parametrize("fused", [None, True], ids=["plain", "kernel_wrapper"])
def test_pos_rollout_chunked_matches_jax(m, chunks, max_len, fused):
    jout = [j_pos.pos_greedy_generate(m.jp.pos, m.jsum, max_len, early_stop=es)
            for es in (True, False)]
    tags, psi = t_pos.pos_greedy_generate(m.tp.pos, m.tsum, max_len, early_stop=True,
                                          fused=fused)
    ran_chunks(chunks, max_len, "pos")
    for jtags, jpsi in jout:
        np.testing.assert_array_equal(tags.numpy(), np.asarray(jtags))
        np.testing.assert_allclose(psi.numpy(), np.asarray(jpsi), **SCORE_TOL)


# --- the chunk runner ---


def test_chunk_spans():
    assert [list(s) for s in graphs.chunk_spans(9)] == [[0, 1, 2, 3], [4, 5, 6, 7], [8]]
    assert [len(s) for s in graphs.chunk_spans(28)] == [4] * 7
    assert [list(s) for s in graphs.chunk_spans(3)] == [[0, 1, 2]]


@pytest.mark.parametrize("done_at,early_stop,want", [
    (None, True, 7), (0, True, 2), (2, True, 4), (5, True, 7), (0, False, 7)])
def test_drive_reads_each_flag_one_chunk_late(done_at, early_stop, want):
    """Chunk i runs unless chunk i - 2's flag says done: a loop done in
    chunk j runs chunks 0 .. j + 1; without early_stop every chunk runs,
    and no flag is read."""
    ran, read = [], []

    def finished(i):
        read.append(i)
        assert i + 1 < len(ran)  # written a chunk ago, the next one already queued
        return done_at is not None and i >= done_at

    assert graphs.drive(7, ran.append, finished, early_stop) == want
    assert ran == list(range(want))
    assert read == ([] if not early_stop else list(range(want - 1 if want < 7 else 5)))


def test_early_stop_leaves_after_the_chunk_that_finished(m, chunks):
    """With EOS favoured every row stops within the first chunk: the runner
    replays two chunks of 3 and gives the eager loop's tokens."""
    with torch.no_grad():
        tp = m.tp
        b_out = tp.decoder.b_out.clone()
        tp.decoder.b_out[2] += 50.0  # EOS
        try:
            got = t_greedy.greedy_decode(tp.decoder, m.tctx, m.tsum, 9, early_stop=True)
            counters = chunks.summary()["counters"]
            assert counters["graphs.replays.greedy"] == 2
            assert counters["graphs.chunks_of.greedy"] == 3
            want = t_greedy.greedy_decode(tp.decoder, m.tctx, m.tsum, 9, early_stop=True,
                                          graphs=False)
        finally:
            tp.decoder.b_out.copy_(b_out)
    assert torch.equal(got, want) and (got[:, 0] == 2).all()


# --- the key ---


def greedy_key(tp, ctx, summary, **kw):
    return t_greedy.RolloutLoop(tp.decoder, ctx, summary, 9, None, 1.0, kw.get("fused", True),
                                False, None, None).key()


def test_key_changes_with_what_a_capture_bakes_in(m):
    """The key moves with the compute policy, the kernel setting, the
    shapes, the presence of a frame mask and a swapped parameter tensor,
    and with nothing else: new inputs of the same shapes and an in-place
    update of the parameters keep it."""
    tp, ctx, s = m.tp, m.tctx, m.tsum
    base = greedy_key(tp, ctx, s)
    same_shape = DecodeContext(*(None if x is None else x + 1 for x in ctx))
    assert greedy_key(tp, same_shape, s * 2) == base
    with torch.no_grad():
        tp.decoder.w_out.mul_(1.0)
    assert greedy_key(tp, ctx, s) == base
    with precision("bfloat16"):
        assert greedy_key(tp, ctx, s) != base
    try:
        set_fused_kernels(False)
        assert greedy_key(tp, ctx, s) != base
    finally:
        set_fused_kernels(None)
    assert greedy_key(tp, ctx, s, fused=False) != base
    assert greedy_key(tp, ctx._replace(frame_mask=None), s) != base
    assert greedy_key(tp, DecodeContext(*(None if x is None else x[:2] for x in ctx)),
                      s[:2]) != base
    old = tp.decoder.b_out
    try:
        tp.decoder.b_out = torch.nn.Parameter(old.detach().clone())
        assert greedy_key(tp, ctx, s) != base
    finally:
        tp.decoder.b_out = old
    assert greedy_key(tp, ctx, s) == base


def test_keys_differ_across_loops_and_options(m):
    tp, ctx, s = m.tp, m.tctx, m.tsum
    beam = lambda **kw: t_beam.BeamLoop(
        (tp.decoder,), (ctx,), (s,), kw.get("k", 4), 9, kw.get("lp", 0.0), True, False,
        kw.get("mode", "grouped"), kw.get("ra", False), None, 0, kw.get("groups", 0), 0.5).key()
    keys = [beam(), beam(k=5), beam(lp=1.0), beam(mode="flat"), beam(ra=True),
            beam(k=6, groups=3), greedy_key(tp, ctx, s),
            t_pos.PosRolloutLoop(tp.pos, s, 9, True).key()]
    assert len(set(keys)) == len(keys)
    assert beam() == beam()


# --- launch accounting ---


class FakeCounter:
    def __init__(self, n=0):
        self.launches = n


def test_launch_ledger_replays_what_capture_counted():
    """Counters a and b at 3 and 5; the warm-up counts 2 of a, chunk 0's
    capture 4 of a and 4 of b, chunk 1's 1 of a; the counters are put back,
    and three replays of both chunks add 3 x (5 a, 4 b)."""
    counters = {"a": FakeCounter(3), "b": FakeCounter(5), "c": FakeCounter(0)}
    ledger = graphs.LaunchLedger(counters)
    start = ledger.read()
    counters["a"].launches += 2  # warm-up
    deltas = []
    for da, db in ((4, 4), (1, 0)):
        before = ledger.read()
        counters["a"].launches += da
        counters["b"].launches += db
        deltas.append(ledger.since(before))
    assert deltas == [{"a": 4, "b": 4}, {"a": 1}]
    ledger.write(start)
    assert ledger.read() == {"a": 3, "b": 5, "c": 0}
    for _ in range(3):
        for d in deltas:
            ledger.add(d)
    assert ledger.read() == {"a": 18, "b": 17, "c": 0}


def test_launch_ledger_defaults_to_the_kernel_wrappers():
    ledger = graphs.LaunchLedger()
    assert ledger.counters is kernels.WRAPPERS
    kernels.reset_launch_counts()
    assert ledger.read() == kernels.launch_counts()


# --- the CPU never takes graphs ---


def test_cpu_never_takes_graphs(m, monkeypatch):
    """Auto and the global setting's auto pick the eager loop for CPU
    tensors (no capture is attempted, no key is cached); forced graphs
    on CPU tensors raise; autograd keeps a CUDA call eager too."""
    def no_graphs(*a, **k):
        raise AssertionError("a CPU call tried to capture a CUDA graph")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", no_graphs)
    graphs.clear()
    with spans.collect() as col:
        t_beam.make_beam_caption_fn(4, MAX_POS, 9)(m.tp, *m.t_in)
        t_eval.make_greedy_caption_fn(MAX_POS, 9)(m.tp, *m.t_in)
    counters = col.summary()["counters"]
    assert graphs.cache_info() == [] and not any(k.startswith("graphs.") for k in counters)
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    assert graphs.resolve_mode(None, cpu, False) == "eager"
    assert graphs.resolve_mode(False, cpu, False) == "eager"
    assert graphs.resolve_mode(None, cuda, False) == "graphs"
    assert graphs.resolve_mode(None, cuda, True) == "eager"
    assert graphs.resolve_mode(False, cuda, False) == "eager"
    assert graphs.resolve_mode(True, cuda, True) == "graphs"
    with pytest.raises(ValueError, match="CUDA tensors"):
        graphs.resolve_mode(True, cpu, False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_greedy.greedy_decode(m.tp.decoder, m.tctx, m.tsum, 9, graphs=True)
    try:
        set_decode_graphs(False)
        assert graphs.resolve_mode(None, cuda, False) == "eager"
        assert graphs.resolve_mode(True, cuda, False) == "graphs"
    finally:
        set_decode_graphs(None)


def test_pos_rollout_under_gradient_stays_eager(m):
    """SCST differentiates through psi: with grad on and parameters that
    require it, the rollout is the eager loop and psi carries gradient."""
    pos = m.tp.pos
    loop = t_pos.PosRolloutLoop(pos, m.tsum, 9, None)
    assert not loop.needs_grad()
    try:
        pos.requires_grad_(True)
        assert loop.needs_grad()
        with torch.no_grad():
            assert not loop.needs_grad()
        _, psi = t_pos.pos_greedy_generate(pos, m.tsum, 9)
        assert psi.requires_grad
        psi.sum().backward()
        assert pos.w_psi.grad is not None and pos.lstm.whh.grad is not None
    finally:
        pos.requires_grad_(False)
        pos.zero_grad(set_to_none=True)


def test_copy_tree_refuses_other_shapes():
    dst = {"a": [torch.zeros(2), None], "n": 3}
    graphs.copy_tree(dst, {"a": [torch.ones(2), None], "n": 3})
    assert torch.equal(dst["a"][0], torch.ones(2))
    for bad in ({"a": [torch.ones(3), None], "n": 3}, {"a": [torch.ones(2), None], "n": 4},
                {"a": [torch.ones(2)], "n": 3}):
        with pytest.raises(ValueError):
            graphs.copy_tree(dst, bad)


# --- keys held for a serving engine's life ---


class CountedLoop(graphs.StepLoop):
    """A loop whose key is its number (nothing to step)."""

    kind = "counted"

    def __init__(self, i: int):
        self.i, self.device = i, torch.device("cpu")

    def key_options(self) -> tuple:
        return (self.i,)

    def prepare(self) -> dict:
        return {}

    def init(self) -> dict:
        return {}

    def finish(self, carry: dict) -> int:
        return self.i


def test_held_keys_are_never_evicted(monkeypatch):
    """Keys a thread runs inside `adding_to(keys)` join `keys`; while
    `keys` is held they are never evicted and do not count against
    MAX_KEYS (a second round over them captures nothing, whatever ran in
    between); released, they are ordinary LRU keys again. The capture and
    replay are stubbed: the CPU has no CUDA graphs."""
    captured = []

    def capture(loop, inp, spans):
        captured.append(loop.i)
        loop.bind(inp)
        return SimpleNamespace(loop=loop, carry={}, spans=[], capture_s=0.0, pool_bytes=0)

    monkeypatch.setattr(graphs, "resolve_mode", lambda *a: "graphs")
    monkeypatch.setattr(graphs, "_capture", capture)
    monkeypatch.setattr(graphs, "_replay", lambda entry, early_stop: 0)
    monkeypatch.setattr(graphs, "MAX_KEYS", 2)
    graphs.clear()
    keys: set = set()
    graphs.hold(keys)
    try:
        with graphs.adding_to(keys):
            assert [graphs.run(CountedLoop(i), 4, False) for i in (0, 1, 2)] == [0, 1, 2]
        for i in (3, 4, 5, 6):  # another caller's keys: an LRU of MAX_KEYS
            graphs.run(CountedLoop(i), 4, False)
        assert captured == [0, 1, 2, 3, 4, 5, 6] and len(keys) == 3
        assert len(graphs.cache_info()) == 3 + graphs.MAX_KEYS
        with graphs.adding_to(keys):
            for i in (0, 1, 2):
                graphs.run(CountedLoop(i), 4, False)
        graphs.run(CountedLoop(3), 4, False)  # evicted while unheld: captured again
        assert captured == [0, 1, 2, 3, 4, 5, 6, 3]
    finally:
        graphs.release(keys)
    assert len(graphs.cache_info()) == graphs.MAX_KEYS
    graphs.clear()
