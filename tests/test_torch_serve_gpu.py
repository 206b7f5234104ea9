"""The serving engine (`controllable_xgating_torch/serve/engine.py`) on the
card, through the kernels and the decode loops' CUDA graphs.

Marked `gpu`: every test skips without a CUDA device. A small captioner
(EOS favoured, so the early exit is exercised) serves beam 5 in buckets
(1, 4, 16):
  * after warm-up, a served batch replays graphs (no capture, chunks
    replayed) although the parameters require grad: the dispatcher
    decodes with grad off;
  * a second round over every bucket after `warmup()` captures nothing,
    even after more than MAX_KEYS other keys went through the cache;
  * an engine built without warm-up captures each bucket's keys in its
    dispatcher while the completion thread waits on the previous batch's
    event, without error, and serves the warmed engine's tokens;
  * under f32 and bf16, each served batch equals the offline library
    call (`encode_for_inference` with `use_tags`, then `beam_search`,
    kernels on) on the same padded bucket batch: tokens and tags exactly,
    scores within rtol 1e-6 (the same kernels on the same operands), and
    its launches equal the offline call's, K2 included on a batch of
    controlled rows only.
This file imports no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_serve_gpu.py
"""

import threading

import numpy as np
import pytest
import torch

from controllable_xgating_torch.ops import kernels
from controllable_xgating_torch.ops.precision import precision

pytestmark = pytest.mark.gpu
BUCKETS = (1, 4, 16)
WAIT = 300


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels build with nvcc for sm_90a)")
    from controllable_xgating_torch.infer import graphs

    graphs.clear()
    kernels.reset_launch_counts()
    return torch.device("cuda:0")


class Model:
    """A small captioner on the card, its vocabularies and seeded
    requests (ragged frame counts, a quarter controlled)."""

    def __init__(self, dev, seed=3):
        from controllable_xgating_torch.data.vocab import EOS, Vocab
        from controllable_xgating_torch.models.captioner import init_captioner
        from controllable_xgating_torch.utils.config import Config

        self.cfg = Config().replace_flat({
            "model.app_dim": 40, "model.motion_dim": 24, "model.hidden_dim": 64,
            "model.embed_dim": 32, "model.attn_dim": 48, "model.pos_embed_dim": 32,
            "model.vocab_size": 500, "model.pos_vocab_size": 20, "model.num_frames": 6,
            "model.max_pos_len": 9, "eval.max_decode_len": 10, "eval.beam_size": 5,
        })
        self.params = init_captioner(self.cfg, seed=seed, device=dev).requires_grad_(False)
        with torch.no_grad():
            self.params.decoder.b_out[EOS] += 2.0
            self.params.pos.b_out[EOS] += 2.0
        self.vocab = Vocab([f"w{i}" for i in range(496)])
        self.tags = [f"t{i}" for i in range(16)]
        self.pos_vocab = Vocab(self.tags)

    def requests(self, n, seed=0):
        rng = np.random.default_rng(seed)
        out = []
        for i in range(n):
            t = int(rng.integers(3, 10))  # below, at and above num_frames
            tags = None
            if i % 4 == 1:
                tags = [self.tags[j] for j in rng.integers(0, 16, int(rng.integers(2, 7)))]
            out.append(dict(app=rng.normal(size=(t, 40)).astype(np.float32),
                            motion=rng.normal(size=(t, 24)).astype(np.float32),
                            nframes=int(rng.integers(1, t + 1)), pos_tags=tags))
        return out

    def engine(self, **kw):
        from controllable_xgating_torch.serve.engine import ServingEngine

        return ServingEngine(self.params, self.cfg, self.vocab, self.pos_vocab, mode="beam",
                             buckets=BUCKETS, **kw)

    def offline(self, app, motion, mask, tags, use_tags):
        """The library call on one padded bucket batch -> (packed like the
        engine's, launches)."""
        from controllable_xgating_torch.infer.beam import beam_search
        from controllable_xgating_torch.models.captioner import encode_for_inference

        m, ev = self.cfg.model, self.cfg.eval
        before = kernels.launch_counts()
        with torch.inference_mode():
            ctx, summary, tags_out = encode_for_inference(
                self.params, app.float(), motion.float(), mask, pos_tags=tags,
                max_pos_len=m.max_pos_len, fused=True, early_stop=True, use_tags=use_tags)
            toks, scores = beam_search(self.params.decoder, ctx, summary, ev.beam_size,
                                       ev.max_decode_len, ev.length_penalty, fused=True,
                                       early_stop=True)
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        return (toks.int(), tags_out.int(), scores), {n: after[n] - before[n] for n in after}


def record(eng):
    """Wrap the engine's device seam: each call's inputs, packed output and
    launches are appended to the returned list."""
    orig, calls = eng._fn, []

    def recording(params, *inputs):
        before = kernels.launch_counts()
        out = orig(params, *inputs)
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        calls.append(([None if x is None else x.clone() for x in inputs], out.clone(),
                      {n: after[n] - before[n] for n in after}))
        return out

    eng._fn = recording
    return calls


def submit_all(eng, reqs, threads=4):
    """Submit `reqs` from `threads` threads at once -> their Futures, in order."""
    futs = [None] * len(reqs)
    barrier = threading.Barrier(threads)

    def producer(k):
        barrier.wait(30)
        for i in range(k, len(reqs), threads):
            futs[i] = eng.submit(**reqs[i])

    ts = [threading.Thread(target=producer, args=(k,)) for k in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(WAIT)
        assert not t.is_alive()
    return futs


def test_served_batches_replay_graphs(dev):
    """After warm-up, a served batch replays the decode loops' graphs,
    although the parameters require grad and the dispatcher thread starts
    with grad mode on."""
    from controllable_xgating_torch.utils import spans

    m = Model(dev)
    m.params.requires_grad_(True)
    seen = []
    with m.engine(max_wait_ms=20.0) as eng, spans.collect() as col:
        eng.warmup()
        orig = eng._fn

        def spy(*a):  # the dispatcher is the one thread that runs batches
            before = col.summary()["counters"]
            out = orig(*a)
            after = col.summary()["counters"]
            seen.append((torch.is_grad_enabled(),
                         {k: v - before.get(k, 0) for k, v in after.items()}))
            return out

        eng._fn = spy
        for f in submit_all(eng, m.requests(6)):
            f.result(timeout=WAIT)
    assert seen
    for grad, ran in seen:
        assert not grad and ran.get("graphs.replays.beam", 0) > 0
        assert not any(v for k, v in ran.items() if k.startswith("graphs.captures."))


def test_no_capture_after_warmup(dev):
    """Every bucket's keys are captured by warmup() and held: a round over
    every bucket afterwards captures nothing, even after more than
    MAX_KEYS other keys went through the cache."""
    from controllable_xgating_torch.infer import graphs
    from controllable_xgating_torch.infer.greedy import greedy_decode
    from controllable_xgating_torch.models.captioner import encode_for_inference

    m = Model(dev)
    with m.engine(max_wait_ms=50.0) as eng:
        eng.warmup()
        assert len(eng._keys) == 3 * len(BUCKETS)  # the BiLSTM's, the POS rollout's, beam's
        entries = {id(e) for e in graphs._CACHE.values()}
        # other callers' keys: greedy at batch sizes no bucket has
        with torch.inference_mode():
            for b in range(17, 18 + graphs.MAX_KEYS):
                x = torch.randn(b, 6, 40, device=dev), torch.randn(b, 6, 24, device=dev)
                ctx, summary, _ = encode_for_inference(m.params, *x, max_pos_len=9, fused=True)
                greedy_decode(m.params.decoder, ctx, summary, 10, fused=True, early_stop=True)
        captured = []
        orig = eng._fn

        def spy(*a):
            n = len(graphs.cache_info())
            out = orig(*a)
            captured.append(len(graphs.cache_info()) - n)
            return out

        eng._fn = spy
        reqs = m.requests(sum(BUCKETS))
        start = 0
        for b in BUCKETS:  # one batch per bucket
            futs = [eng.submit(**r) for r in reqs[start:start + b]]
            assert {f.result(timeout=WAIT).batch_size for f in futs} == {b}
            start += b
        assert captured == [0] * len(BUCKETS)
        assert entries <= {id(e) for e in graphs._CACHE.values()}


def gated_groups(eng, groups):
    """Serve `groups` (lists of requests, one bucket each) so that each
    group's batch is dispatched while the previous batch's completion
    waits on its event: the device seam blocks until the next group is
    queued, and a 0.3 s device sleep after each batch delays its event.
    Returns (the results in order, [captured while the previous event was
    pending] per batch)."""
    from controllable_xgating_torch.infer import graphs

    orig = eng._fn
    entered, go = threading.Semaphore(0), [threading.Event() for _ in groups]
    state = {"i": 0, "prev": None}
    overlap = []

    def gated(*a):
        i = state["i"]
        state["i"] += 1
        entered.release()
        if not go[i].wait(WAIT):
            raise RuntimeError("gate never opened")
        pending = state["prev"] is not None and not state["prev"].query()
        n = len(graphs.cache_info())
        out = orig(*a)
        overlap.append(pending and len(graphs.cache_info()) > n)
        torch.cuda._sleep(int(0.3 * 1.98e9))  # ~0.3 s at the H100's boost clock
        state["prev"] = torch.cuda.Event()
        state["prev"].record()
        return out

    eng._fn = gated
    futs = [[eng.submit(**r) for r in groups[0]]]
    assert entered.acquire(timeout=WAIT)
    for i in range(1, len(groups)):
        futs.append([eng.submit(**r) for r in groups[i]])  # queued behind batch i - 1
        go[i - 1].set()
        assert entered.acquire(timeout=WAIT)  # batch i collected, in the seam
    go[-1].set()
    return [[f.result(timeout=WAIT) for f in fs] for fs in futs], overlap


def test_unwarmed_engine_captures_while_a_batch_is_in_flight(dev):
    """No warm-up: each bucket's first batch captures its keys in the
    dispatcher while the completion thread waits on the previous batch's
    event (the capture runs in thread_local mode); nothing fails, and the
    tokens are the warmed engine's."""
    from controllable_xgating_torch.infer import graphs

    m = Model(dev)
    reqs = m.requests(sum(BUCKETS), seed=1)
    groups, start = [], 0
    for b in BUCKETS:
        groups.append(reqs[start:start + b])
        start += b
    with precision("bfloat16"):
        with m.engine(max_wait_ms=50.0) as cold:
            got, overlap = gated_groups(cold, groups)
        graphs.clear()
        with m.engine(max_wait_ms=50.0) as warm:
            warm.warmup()
            want, _ = gated_groups(warm, groups)
    assert overlap[1:] == [True] * (len(BUCKETS) - 1), overlap
    for b, gs, ws in zip(BUCKETS, got, want):
        assert [r.batch_size for r in gs] == [b] * b
        assert [(r.caption, r.pos_sequence, r.score) for r in gs] == \
            [(r.caption, r.pos_sequence, r.score) for r in ws]


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
def test_served_batches_equal_the_offline_call(dev, policy):
    """Concurrent mixed requests: every served batch equals the offline
    library call on the same padded bucket batch, with the same launches;
    a batch of controlled rows only still rolls the POS generator (K2)."""
    m = Model(dev)
    reqs = m.requests(24, seed=2)
    controlled = [dict(r, pos_tags=["t1", "t2"]) for r in m.requests(3, seed=3)]
    with precision(policy):
        with m.engine(max_wait_ms=5.0) as eng:
            eng.warmup()
            calls = record(eng)
            for f in submit_all(eng, reqs):
                f.result(timeout=WAIT)
            for f in submit_all(eng, controlled, threads=1):
                f.result(timeout=WAIT)
        assert len(calls) >= 2
        for inputs, packed, launches in calls:
            (toks, tags, scores), want = m.offline(*inputs)
            nb, lp = toks.shape[1], tags.shape[1]
            assert torch.equal(packed[:, :nb], toks)
            assert torch.equal(packed[:, nb:nb + lp], tags)
            torch.testing.assert_close(packed[:, -1].view(torch.float32), scores,
                                       rtol=1e-6, atol=0.0)
            assert launches == want
            assert launches["xgate"] == 1 and launches["pos_lstm"] > 0
            assert launches["attn_lstm"] > 0 and launches["topk_tail"] > 0
        assert bool(calls[-1][0][4].all())  # the last batch: controlled rows only
