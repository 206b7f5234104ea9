"""The port's serving engine and HTTP front-end (`controllable_xgating_torch/
serve/`) on the CPU: the contracts of `tests/test_serve.py`, at its tiny
config, then parity with the JAX package on bridged parameters.

The engine's contract: any interleaving of concurrent single-video
requests — mixed free-run and POS-controlled, any arrival pattern, any
bucket padding — produces the captions, POS sequences and scores the
port's offline path produces for the same inputs (rows are independent
under the decoder): tokens exactly, scores within rtol 1e-5, atol 1e-6.
Against the JAX package's offline path (`encode_for_inference` with
`use_tags`, then `greedy_decode` / `beam_search`, or its ensemble caption
function) on the same numpy weights: captions, POS sequences,
`controlled` and n-best lists equal, scores within rtol 1e-5, atol 1e-6.
No JAX engine is built: the JAX side is one batched offline call.

Every `Future.result` and thread join has a timeout; every engine closes
in a `finally` (or its `with`).
"""

import copy
import http.client
import json
import random
import sys
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_xgating_tpu.infer import beam as j_beam
from controllable_xgating_tpu.infer import ensemble as j_ens
from controllable_xgating_tpu.infer import greedy as j_greedy
from controllable_xgating_tpu.models import captioner as j_cap
from controllable_xgating_tpu.utils.config import Config as JConfig
from controllable_xgating_torch.data.vocab import Vocab, pad_encode
from controllable_xgating_torch.infer import graphs
from controllable_xgating_torch.infer.beam import beam_search
from controllable_xgating_torch.infer.greedy import greedy_decode
from controllable_xgating_torch.models.captioner import encode_for_inference
from controllable_xgating_torch.ops.dispatch import fused_enabled
from controllable_xgating_torch.ops.precision import compute_dtype, precision
from controllable_xgating_torch.serve.engine import (
    DeadlineExceeded,
    EngineOverloaded,
    ServingEngine,
)
from controllable_xgating_torch.serve.server import serve
from controllable_xgating_torch.utils.config import Config
from test_torch_quant import numpy_params

torch.set_num_threads(1)
WORDS = [f"w{i}" for i in range(16)]
TAGS = ["DT", "NN", "VBZ", "VBG", "IN"]
FLAT = {
    "model.app_dim": 10, "model.motion_dim": 8, "model.hidden_dim": 12,
    "model.embed_dim": 8, "model.attn_dim": 10, "model.pos_embed_dim": 10,
    "model.vocab_size": 4 + len(WORDS), "model.pos_vocab_size": 4 + len(TAGS),
    "model.num_frames": 5, "model.max_pos_len": 8,
    "eval.max_decode_len": 9, "eval.beam_size": 3,
}
SCORE_TOL = dict(rtol=1e-5, atol=1e-6)
WAIT = 120  # seconds: every Future.result and join


class Setup:
    def __init__(self):
        self.cfg = Config().replace_flat(FLAT)
        self.jcfg = JConfig().replace_flat(FLAT)
        self.jp, self.params = numpy_params(self.jcfg, seed=5)
        self.vocab, self.pos_vocab = Vocab(WORDS), Vocab(TAGS)
        rng = np.random.default_rng(0)
        self.feats = [
            (rng.normal(size=(5, 10)).astype(np.float32),
             rng.normal(size=(5, 8)).astype(np.float32))
            for _ in range(6)
        ]

    def engine(self, params=None, **kw):
        return ServingEngine(self.params if params is None else params, self.cfg, self.vocab,
                             self.pos_vocab, **kw)

    def tag_ids(self, tags):
        return np.array([pad_encode(self.pos_vocab, tags, self.cfg.model.max_pos_len)], np.int64)

    def expected(self, app, motion, tags=None, mode="greedy", nframes=None, nbest=0):
        """The port's offline single-video path, with the kernel setting
        the CLIs pass (`fused_enabled()`: on the CPU the kernels' plain
        versions) -> (caption, pos sequence, score or None, n-best list or
        None)."""
        m, ev, fused = self.cfg.model, self.cfg.eval, fused_enabled()
        nf = app.shape[0] if nframes is None else nframes
        mask = (np.arange(m.num_frames) < nf).astype(np.float32)[None]
        with torch.inference_mode():
            ctx, summary, tags_out = encode_for_inference(
                self.params, torch.from_numpy(app[None]), torch.from_numpy(motion[None]),
                torch.from_numpy(mask),
                pos_tags=None if tags is None else torch.from_numpy(self.tag_ids(tags)),
                max_pos_len=m.max_pos_len, fused=fused, early_stop=True,
            )
            if mode == "greedy":
                toks = greedy_decode(self.params.decoder, ctx, summary, ev.max_decode_len,
                                     fused=fused, early_stop=True)
                score = None
            else:
                toks, score = beam_search(self.params.decoder, ctx, summary, ev.beam_size,
                                          ev.max_decode_len, ev.length_penalty, fused=fused,
                                          early_stop=True, return_all=bool(nbest))
        pos = " ".join(self.pos_vocab.decode(tags_out[0].tolist()))
        if nbest:
            lst = [(self.vocab.decode_str(toks[0, n].tolist()), float(score[0, n]))
                   for n in range(nbest)]
            return lst[0][0], pos, lst[0][1], lst
        return (self.vocab.decode_str(toks[0].tolist()), pos,
                None if score is None else float(score[0]), None)


@pytest.fixture(scope="module")
def setup():
    return Setup()


def assert_result(res, want):
    caption, pos, score, nbest = want
    assert res.caption == caption and res.pos_sequence == pos
    if score is None:
        assert res.score is None
    else:
        np.testing.assert_allclose(res.score, score, **SCORE_TOL)
    if nbest is not None:
        assert [c for c, _ in res.nbest] == [c for c, _ in nbest]
        np.testing.assert_allclose([s for _, s in res.nbest], [s for _, s in nbest], **SCORE_TOL)


# --- equality with the port's offline path ---


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_engine_matches_offline_path(setup, mode):
    """Concurrent mixed free/controlled requests from several threads ==
    the offline per-video decode (tokens exactly, scores to 1e-5)."""
    reqs = [
        (setup.feats[0], None),
        (setup.feats[1], ["DT", "NN", "VBZ"]),
        (setup.feats[2], None),
        (setup.feats[3], ["NN", "VBG", "IN", "DT", "NN"]),
        (setup.feats[4], None),
        (setup.feats[5], ["DT", "NN"]),
    ]
    out = [None] * len(reqs)
    with setup.engine(mode=mode, buckets=(1, 2, 4), max_wait_ms=20.0) as eng:
        def producer(ids):
            for i in ids:
                (a, m), t = reqs[i]
                out[i] = eng.submit(a, m, pos_tags=t)

        threads = [threading.Thread(target=producer, args=(ids,)) for ids in ((0, 3), (1, 4), (2, 5))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
            assert not t.is_alive()
        results = [f.result(timeout=WAIT) for f in out]
    for ((app, mot), tags), res in zip(reqs, results):
        assert_result(res, setup.expected(app, mot, tags, mode))
        assert res.controlled == (tags is not None)
        if tags is not None:
            assert res.pos_sequence.split()[: len(tags)] == tags


def test_bucket_padding_does_not_change_results(setup):
    """The same request answered solo (bucket=1) and ridden in a padded
    bucket (n=3 -> bucket 4) must caption identically."""
    app, mot = setup.feats[0]
    with setup.engine(mode="greedy", buckets=(1,), max_wait_ms=1.0) as eng:
        solo = eng.caption(app, mot, timeout=WAIT).caption
    with setup.engine(mode="greedy", buckets=(4,), max_wait_ms=50.0) as eng:
        futs = [eng.submit(*setup.feats[i]) for i in (0, 1, 2)]
        padded = [f.result(timeout=WAIT) for f in futs]
    assert padded[0].caption == solo
    assert all(r.batch_size == 4 for r in padded)


def test_variable_frames_and_nframes(setup):
    """Requests with T != num_frames are fitted like the FeatureStore; the
    pad region must not influence the caption (mask flows through), and
    T > num_frames subsamples as the offline store does."""
    app, mot = setup.feats[0]
    short_app, short_mot = app[:3], mot[:3]
    garbage_app = np.concatenate([short_app, 100.0 * np.ones((2, 10), np.float32)])
    garbage_mot = np.concatenate([short_mot, 100.0 * np.ones((2, 8), np.float32)])
    long_app = np.concatenate([app, app[::-1]])  # T = 10 -> 5 frames kept
    long_mot = np.concatenate([mot, mot[::-1]])
    with setup.engine(mode="greedy", buckets=(1,), max_wait_ms=1.0) as eng:
        a = eng.caption(short_app, short_mot, timeout=WAIT).caption
        b = eng.caption(garbage_app, garbage_mot, nframes=3, timeout=WAIT).caption
        c = eng.caption(long_app, long_mot, nframes=6, timeout=WAIT)
    assert a == b == setup.expected(garbage_app, garbage_mot, nframes=3)[0]
    idx = np.linspace(0, 9, 5).round().astype(np.int64)
    assert_result(c, setup.expected(long_app[idx], long_mot[idx], nframes=int((idx < 6).sum())))


def test_stats_and_validation(setup):
    eng = setup.engine(mode="greedy", buckets=(1, 2), max_wait_ms=1.0)
    try:
        with pytest.raises(ValueError, match="unknown POS tags"):
            eng.submit(*setup.feats[0], pos_tags=["NOTATAG"])
        with pytest.raises(ValueError):
            eng.submit(setup.feats[0][0][:2], setup.feats[0][1][:3])  # mismatched T
        with pytest.raises(ValueError, match="feature dims"):
            eng.submit(setup.feats[0][0][:, :5], setup.feats[0][1])  # wrong Da
        with pytest.raises(ValueError, match="nframes"):
            eng.submit(*setup.feats[0], nframes=0)
        with pytest.raises(ValueError, match="deadline_ms"):
            eng.submit(*setup.feats[0], deadline_ms=0)
        with pytest.raises(ValueError, match="timeout must be positive"):
            eng.caption(*setup.feats[0], timeout=0)
        with pytest.raises(ValueError, match="timeout must be positive"):
            eng.caption(*setup.feats[0], timeout=-1)
        eng.caption(*setup.feats[0], timeout=WAIT)
        s = eng.stats()
        assert s["requests"] == 1 and s["batches"] == 1
        assert s["latency_ms_p50"] is not None
        assert 0 < s["mean_batch_occupancy"] <= 1
        assert set(s) == {
            "mode", "ensemble_members", "nbest", "buckets", "requests", "batches",
            "mean_batch_occupancy", "latency_ms_p50", "latency_ms_p99", "queue_depth",
            "rejected", "cancelled", "deadline_expired", "deadline_shed_predicted",
            "deadline_completed", "late_completions", "shed_margin_live",
            "est_claim_to_done_ms", "slot_ms_by_bucket", "deferred", "batches_in_flight",
        }
    finally:
        eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(*setup.feats[0])


@pytest.mark.parametrize("case", ["mode", "buckets", "shed_margin", "n_members"])
def test_constructor_refuses_bad_arguments(setup, case):
    kw = {"mode": dict(mode="sample"), "buckets": dict(buckets=(4, 1)),
          "shed_margin": dict(shed_margin=0.0), "n_members": dict(n_members=2)}[case]
    with pytest.raises(ValueError):
        setup.engine(**kw)


# --- the device calls' thread state ---


def test_dispatcher_decodes_without_autograd(setup):
    """Grad mode is per thread, and a caller's parameters may require grad
    (a trainer's): every device call of the dispatcher runs with grad off,
    so the decode loops keep their graphs on the card
    (graphs.resolve_mode)."""
    params = copy.deepcopy(setup.params).requires_grad_(True)
    seen = []
    with setup.engine(params, mode="beam", buckets=(2,), max_wait_ms=1.0) as eng:
        orig = eng._fn

        def spy(*a):
            seen.append(torch.is_grad_enabled())
            out = orig(*a)
            seen.append(out.requires_grad)
            return out

        eng._fn = spy
        res = eng.caption(*setup.feats[0], timeout=WAIT)
    assert seen == [False, False]
    assert_result(res, setup.expected(*setup.feats[0], mode="beam"))


@pytest.mark.parametrize("built,later", [("float32", "bfloat16"), ("bfloat16", "float32")])
def test_policy_is_fixed_at_construction(setup, built, later):
    """The compute policy is one process-global setting; the engine takes
    it at construction and its dispatcher computes under it, whatever the
    caller's thread sets later."""
    before = compute_dtype()
    with precision(built):
        eng = setup.engine(mode="beam", buckets=(1, 2), max_wait_ms=1.0)
    try:
        with precision(later):
            got = [eng.caption(*f, timeout=WAIT) for f in setup.feats[:3]]
            assert compute_dtype() == getattr(torch, later)
    finally:
        eng.close()
    assert compute_dtype() == before
    with precision(built):
        want = [setup.expected(*f, mode="beam") for f in setup.feats[:3]]
    with precision(later):
        other = [setup.expected(*f, mode="beam")[2] for f in setup.feats[:3]]
    for res, w in zip(got, want):
        assert res.caption == w[0] and res.score == w[2]  # the same arithmetic
    assert [r.score for r in got] != other  # the two policies do differ here


# --- the HTTP front-end ---


def post(base, payload, timeout=WAIT):
    req = urllib.request.Request(base + "/caption", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        return 200, json.loads(urllib.request.urlopen(req, timeout=timeout).read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_server_roundtrip(setup):
    """Raw-feature POST through the stdlib server -> same caption as the
    offline path; /healthz, /stats and /metrics respond; bad requests get
    400, an expired budget 503."""
    app, mot = setup.feats[5]
    with setup.engine(mode="greedy", buckets=(1, 2), max_wait_ms=2.0) as eng:
        httpd = serve(eng, "127.0.0.1", 0)   # ephemeral port
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            code, resp = post(base, {"app": app.tolist(), "motion": mot.tolist(),
                                     "pos_tags": "DT NN VBZ"})
            assert code == 200
            want = setup.expected(app, mot, ["DT", "NN", "VBZ"])
            assert resp["caption"] == want[0] and resp["pos_sequence"] == want[1]
            assert resp["controlled"] is True and resp["batch_size"] == 1
            assert resp["score"] is None and "nbest" not in resp

            ok = json.loads(urllib.request.urlopen(base + "/healthz", timeout=30).read())
            assert ok == {"ok": True}
            prom = urllib.request.urlopen(base + "/metrics", timeout=30).read().decode()
            assert "# TYPE cxg_serve_requests counter" in prom
            assert "cxg_serve_requests 1.0" in prom
            assert "# TYPE cxg_serve_latency_ms_p99 gauge" in prom
            stats = json.loads(urllib.request.urlopen(base + "/stats", timeout=30).read())
            assert stats["requests"] >= 1

            code, detail = post(base, {"pos_tags": "DT"}, timeout=30)
            assert code == 400
            # an already-expired budget (deadline_ms: 0) is the RETRYABLE
            # deadline-exceeded outcome (503), not a malformed request
            code, detail = post(base, {"app": app.tolist(), "motion": mot.tolist(),
                                       "deadline_ms": 0}, timeout=30)
            assert code == 503 and detail["retry"] is True
        finally:
            httpd.shutdown()
            httpd.server_close()
            t.join(30)
    assert not t.is_alive()


def test_http_404_drains_body_on_keepalive(setup):
    """POST to an unknown route must drain the request body before
    responding: under HTTP/1.1 keep-alive, unread body bytes would be
    parsed as the NEXT request on the same connection."""
    app, mot = setup.feats[5]
    with setup.engine(mode="greedy", buckets=(1, 2), max_wait_ms=2.0) as eng:
        httpd = serve(eng, "127.0.0.1", 0)
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=WAIT)
        try:
            junk = json.dumps({"noise": "x" * 100_000}).encode()
            conn.request("POST", "/bogus", body=junk,
                         headers={"Content-Type": "application/json"})
            r1 = conn.getresponse()
            assert r1.status == 404
            r1.read()
            body = json.dumps({"app": app.tolist(), "motion": mot.tolist()}).encode()
            conn.request("POST", "/caption", body=body,
                         headers={"Content-Type": "application/json"})
            r2 = conn.getresponse()
            assert r2.status == 200
            assert json.loads(r2.read())["caption"] == setup.expected(app, mot)[0]
        finally:
            conn.close()
            httpd.shutdown()
            httpd.server_close()
            t.join(30)


# --- shedding, deadlines and cancellation ---


def gate(eng):
    """Replace the engine's device seam by one that waits for a gate:
    (entered, gate) events."""
    orig_fn = eng._fn
    entered, opened = threading.Event(), threading.Event()

    def gated_fn(*a):
        entered.set()
        if not opened.wait(30.0):
            raise RuntimeError("gate never opened")
        return orig_fn(*a)

    eng._fn = gated_fn
    return entered, opened


def test_cancelled_and_expired_requests_never_reach_device(setup):
    """A request whose Future was cancelled, or whose queue deadline
    passed, is shed at dispatch (its row freed and backfilled from the
    queue), not computed for a dead client."""
    feats = setup.feats
    with setup.engine(mode="greedy", buckets=(2,), max_wait_ms=100.0) as eng:
        entered, opened = gate(eng)
        fut_a = eng.submit(*feats[0])  # occupies the dispatcher at the gate
        assert entered.wait(30.0)
        fut_b = eng.submit(*feats[1])  # cancelled
        fut_c = eng.submit(*feats[2])
        fut_d = eng.submit(*feats[3])  # backfills B's row
        fut_e = eng.submit(*feats[4], deadline_ms=10.0)  # lapses while queued
        assert fut_b.cancel()
        time.sleep(0.05)
        opened.set()
        for fut, f in ((fut_a, feats[0]), (fut_c, feats[2]), (fut_d, feats[3])):
            assert fut.result(timeout=WAIT).caption == setup.expected(*f)[0]
        assert fut_b.cancelled()
        with pytest.raises(DeadlineExceeded):
            fut_e.result(timeout=WAIT)
        s = eng.stats()
        # the device saw A (padded) then [C, D]: 3 live requests, 2 batches
        assert s["requests"] == 3
        assert s["batches"] == 2
        assert s["cancelled"] == 1
        assert s["deadline_expired"] == 1


def test_unmeetable_deadline_is_shed_predictively(setup):
    """A request claimed young still goes stale inside the device
    pipeline: the engine compares the remaining budget with its measured
    claim->result latency and sheds the unmeetable at dispatch."""
    feats = setup.feats
    with setup.engine(mode="greedy", buckets=(2,), max_wait_ms=10.0) as eng:
        orig_fn = eng._fn

        def slow_fn(*a):
            time.sleep(0.25)
            return orig_fn(*a)

        eng._fn = slow_fn
        eng.submit(*feats[0]).result(timeout=WAIT)  # calibrates the estimate
        assert eng.stats()["est_claim_to_done_ms"] >= 250.0
        fut = eng.submit(*feats[1], deadline_ms=150.0)
        with pytest.raises(DeadlineExceeded, match="predicted"):
            fut.result(timeout=WAIT)
        res = eng.submit(*feats[2], deadline_ms=5000.0).result(timeout=WAIT)
        assert res.caption == setup.expected(*feats[2])[0]
        s = eng.stats()
        assert s["deadline_expired"] == 1
        assert s["deadline_shed_predicted"] == 1


def test_deadline_downshifts_bucket(setup):
    """When the largest bucket's measured latency outlives a deadline, the
    dispatcher rides a smaller bucket whose latency fits the budget."""
    feats = setup.feats
    with setup.engine(mode="greedy", buckets=(1, 4), max_wait_ms=40.0) as eng:
        eng.warmup()
        orig_fn = eng._fn

        def size_proportional_fn(params_, app, *rest):
            time.sleep(0.15 * app.shape[0])  # 0.6 s at bucket 4, 0.15 at 1
            return orig_fn(params_, app, *rest)

        eng._fn = size_proportional_fn
        warm = [eng.submit(*feats[i % len(feats)]) for i in range(4)]
        assert {w.result(timeout=WAIT).batch_size for w in warm} == {4}
        assert 4 in eng.stats()["slot_ms_by_bucket"]
        res = eng.submit(*feats[1], deadline_ms=500.0).result(timeout=WAIT)
        assert res.batch_size == 1
        assert res.caption == setup.expected(*feats[1])[0]
        assert eng.stats()["deadline_shed_predicted"] == 0


def test_stale_slot_estimate_is_revived_by_fresh_buckets(setup):
    """Past the TTL, _predict_slot demotes a stale bucket estimate and
    rescales from the nearest fresh bucket; with nothing fresh it falls
    back to the stale table, never to 0."""
    with setup.engine(mode="greedy", buckets=(1, 4)) as eng:
        eng._SLOT_TTL_S = 0.05  # instance shadow of the class constant
        t = time.monotonic()
        eng._ewma_slot_s[4] = (10.0, t)
        eng._ewma_slot_s[1] = (0.01, t)
        assert eng._predict_slot(4) == 10.0
        time.sleep(0.08)
        eng._ewma_slot_s[1] = (0.01, time.monotonic())
        assert eng._predict_slot(4) == pytest.approx(0.04)
        time.sleep(0.08)
        assert eng._predict_slot(4) == 10.0


def test_diversity_misconfig_fails_at_construction(setup):
    bad = setup.cfg.replace_flat({"eval.diversity_groups": 2})  # beam_size 3
    with pytest.raises(ValueError, match="must divide"):
        ServingEngine(setup.params, bad, setup.vocab, setup.pos_vocab, mode="beam",
                      buckets=(2,))


def test_caption_timeout_sheds_queued_row(setup):
    """caption(timeout=...) propagates the timeout as a queue deadline and
    cancels on timeout, so a timed-out caller's row is never computed."""
    feats = setup.feats
    with setup.engine(mode="greedy", buckets=(1,), max_wait_ms=1.0) as eng:
        entered, opened = gate(eng)
        fut_a = eng.submit(*feats[0])
        assert entered.wait(30.0)
        with pytest.raises(TimeoutError):
            eng.caption(*feats[1], timeout=0.05)
        opened.set()
        fut_a.result(timeout=WAIT)
        res = eng.caption(*feats[2], timeout=WAIT)
        assert res.caption == setup.expected(*feats[2])[0]
        s = eng.stats()
        assert s["requests"] == 2
        assert s["cancelled"] + s["deadline_expired"] == 1


def test_load_shedding(setup):
    """With max_queue set, submit() raises EngineOverloaded once the queue
    is full; accepted requests complete."""
    eng = setup.engine(mode="greedy", buckets=(2,), max_wait_ms=200.0, max_queue=3)
    try:
        futs, rejected = [], 0
        for i in range(30):
            try:
                futs.append(eng.submit(*setup.feats[i % len(setup.feats)]))
            except EngineOverloaded:
                rejected += 1
        assert rejected > 0
        for f in futs:
            assert isinstance(f.result(timeout=WAIT).caption, str)
        assert eng.stats()["rejected"] == rejected
    finally:
        eng.close()


def test_device_failure_reaches_the_futures(setup):
    """A failing device call resolves every Future of its batch with the
    error; the engine keeps serving."""
    with setup.engine(mode="greedy", buckets=(2,), max_wait_ms=20.0) as eng:
        orig_fn = eng._fn
        calls = []

        def failing_fn(*a):
            calls.append(1)
            if len(calls) == 1:
                raise RuntimeError("capture failed")
            return orig_fn(*a)

        eng._fn = failing_fn
        futs = [eng.submit(*f) for f in setup.feats[:2]]
        for f in futs:
            with pytest.raises(RuntimeError, match="capture failed"):
                f.result(timeout=WAIT)
        assert eng.caption(*setup.feats[2], timeout=WAIT).caption == \
            setup.expected(*setup.feats[2])[0]


# --- n-best and ensembles ---


def test_nbest_serving(setup):
    """nbest=2 (beam): results carry 2 scored best-first hypotheses equal
    to the offline return_all path; nbest[0] == (caption, score) and the
    best caption matches the nbest=0 engine. Greedy+nbest and
    nbest>beam_size reject."""
    with pytest.raises(ValueError, match="beam"):
        setup.engine(mode="greedy", nbest=2)
    with pytest.raises(ValueError, match="beam_size"):
        setup.engine(mode="beam", nbest=setup.cfg.eval.beam_size + 1)

    def captions(nbest):
        with setup.engine(mode="beam", buckets=(2,), max_wait_ms=30.0, nbest=nbest) as eng:
            futs = [eng.submit(a, m) for a, m in setup.feats[:2]]
            return [f.result(timeout=WAIT) for f in futs]

    plain, nb = captions(0), captions(2)
    for f, p0, r in zip(setup.feats[:2], plain, nb):
        assert len(r.nbest) == 2
        assert r.nbest[0] == (r.caption, r.score)
        assert r.caption == p0.caption
        assert abs(r.score - p0.score) < 1e-5
        assert r.nbest[0][1] >= r.nbest[1][1]
        assert_result(r, setup.expected(*f, mode="beam", nbest=2))


def test_ensemble_nbest_serving(setup):
    """A [p, p] ensemble with nbest=2 returns the single model's scored
    list (the members' mean of identical log-probs is exact)."""

    def run(p, n_members):
        with setup.engine(p, mode="beam", buckets=(2,), max_wait_ms=30.0, nbest=2,
                          n_members=n_members) as eng:
            futs = [eng.submit(a, m) for a, m in setup.feats[:2]]
            res = [f.result(timeout=WAIT) for f in futs]
            assert eng.stats()["ensemble_members"] == n_members
            return res

    single = run(setup.params, 0)
    ens = run((setup.params, setup.params), 2)
    for s, e in zip(single, ens):
        assert len(e.nbest) == 2
        assert [c for c, _ in e.nbest] == [c for c, _ in s.nbest]
        for (_, es), (_, ss) in zip(e.nbest, s.nbest):
            assert abs(es - ss) < 1e-4


# --- the dispatcher's conservation law under churn ---


def test_dispatcher_conservation_stress(setup):
    """Randomized multi-producer churn against a deliberately slow device
    seam: every Future resolves exactly once, the counters sum to the
    submissions, the drain is complete, and no worker thread leaks."""
    n_threads, per_thread = 4, 40
    feats = setup.feats
    eng = setup.engine(mode="greedy", buckets=(1, 4), max_wait_ms=2.0, max_queue=8)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # more interleavings of the three threads' state
    try:
        eng.warmup()
        real_fn = eng._fn

        def slow_fn(*a):
            time.sleep(0.004)
            return real_fn(*a)

        eng._fn = slow_fn
        futures, rejected = [], [0]
        lock = threading.Lock()

        def producer(seed: int) -> None:
            rng = random.Random(seed)
            for _ in range(per_thread):
                app, mot = feats[rng.randrange(len(feats))]
                tags = ["DT", "NN", "VBZ"] if rng.random() < 0.2 else None
                dl = rng.choice([None, rng.uniform(1.0, 20.0), 30_000.0])
                try:
                    fut = eng.submit(app, mot, pos_tags=tags, deadline_ms=dl)
                except EngineOverloaded:
                    with lock:
                        rejected[0] += 1
                    continue
                if rng.random() < 0.25:
                    time.sleep(rng.uniform(0.0, 0.003))
                    fut.cancel()  # may lose the race with claim — both fine
                with lock:
                    futures.append(fut)
                time.sleep(rng.uniform(0.0, 0.002))

        threads = [threading.Thread(target=producer, args=(1000 + i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
            assert not t.is_alive()
        eng.close(timeout=60.0)
        assert not eng._dispatcher.is_alive(), "dispatcher thread leaked"
        assert not eng._finisher.is_alive(), "completion thread leaked"

        n_ok = n_cancelled = n_expired = 0
        for fut in futures:
            assert fut.done(), "a Future never resolved"
            if fut.cancelled():
                n_cancelled += 1
                continue
            exc = fut.exception(timeout=0)
            if exc is None:
                assert fut.result().caption is not None
                n_ok += 1
            elif isinstance(exc, DeadlineExceeded):
                n_expired += 1
            else:
                raise AssertionError(f"unexpected Future resolution: {exc!r}") from exc
        assert n_ok + n_cancelled + n_expired == len(futures)
        assert len(futures) + rejected[0] == n_threads * per_thread
        st = eng.stats()
        assert st["requests"] == n_ok
        assert st["cancelled"] == n_cancelled
        assert st["deadline_expired"] == n_expired
        assert st["rejected"] == rejected[0]
        assert st["deadline_shed_predicted"] <= st["deadline_expired"]
        assert st["queue_depth"] == 0
        assert st["batches_in_flight"] == 0
        assert n_ok > 0
    finally:
        sys.setswitchinterval(switch)
        eng.close(timeout=10.0)


# --- the adaptive shed margin ---


def test_adaptive_margin_control_law(setup):
    """_update_margin rises multiplicatively under late completions, decays
    slowly toward the configured floor when clean, is bounded above, and
    is inert for deadline-free traffic."""
    eng = setup.engine(mode="greedy", buckets=(1,), shed_margin=1.0, adaptive_margin=True)
    try:
        assert eng.stats()["shed_margin_live"] == 1.0
        eng._update_margin(0, 0)
        assert eng._margin == 1.0
        for _ in range(50):
            eng._update_margin(1, 1)
        assert eng._margin == pytest.approx(eng._MARGIN_MAX)
        for _ in range(20_000):
            eng._update_margin(0, 4)
        assert eng._margin == pytest.approx(1.0)
        eng2 = setup.engine(mode="greedy", buckets=(1,), shed_margin=1.3, adaptive_margin=True)
        try:
            for _ in range(10_000):
                eng2._update_margin(0, 4)
            assert eng2._margin == pytest.approx(1.3)
        finally:
            eng2.close(timeout=10.0)
    finally:
        eng.close(timeout=10.0)


def test_late_completion_counters_and_adaptive_rise(setup):
    """A request claimed before its deadline but finished after it counts
    as a late completion, and (adaptive) raises the live margin."""
    eng = setup.engine(mode="greedy", buckets=(1,), max_wait_ms=1.0, adaptive_margin=True)
    try:
        eng.warmup()
        real_fn = eng._fn

        def slow_fn(*a):
            time.sleep(0.12)
            return real_fn(*a)

        eng._fn = slow_fn
        fut = eng.submit(*setup.feats[1], deadline_ms=30.0)
        res2 = fut.result(timeout=WAIT)
        res = eng.caption(*setup.feats[0], timeout=WAIT)
        assert res.caption is not None
        st = eng.stats()
        assert st["deadline_completed"] >= 2
        assert st["late_completions"] >= 1
        assert st["shed_margin_live"] > 1.0
        assert res2.latency_ms > 30.0
    finally:
        eng.close(timeout=30.0)


def test_adaptive_margin_never_latches_at_max(setup):
    """If the raised margin sheds ALL deadline traffic, the wall-clock
    decay still brings the margin back to the floor, but not while late
    completions are recent."""
    eng = setup.engine(mode="greedy", buckets=(1,), shed_margin=1.0, adaptive_margin=True)
    try:
        eng._margin = eng._MARGIN_MAX
        eng._t_last_late = time.monotonic() - 10.0
        for _ in range(1000):
            eng._t_last_decay = 0.0
            eng._decay_margin_on_quiet()
        assert eng._margin == pytest.approx(1.0)
        eng._t_last_late = time.monotonic()
        eng._margin = eng._MARGIN_MAX
        eng._t_last_decay = 0.0
        eng._decay_margin_on_quiet()
        assert eng._margin == pytest.approx(eng._MARGIN_MAX)
    finally:
        eng.close(timeout=10.0)


def test_default_shed_margin(setup):
    """The default shed margin is 1.3, the adaptive margin opt-in."""
    eng = setup.engine(mode="greedy", buckets=(1,))
    try:
        assert eng.shed_margin == pytest.approx(1.3)
        assert eng._margin == pytest.approx(1.3)
        assert not eng.adaptive_margin
    finally:
        eng.close(timeout=10.0)


def test_engine_holds_its_graph_keys_until_closed(setup):
    """The engine's key set is held in the graph cache from construction
    to close()."""
    eng = setup.engine(mode="greedy", buckets=(1,))
    try:
        assert any(k is eng._keys for k in graphs._HELD)
    finally:
        eng.close(timeout=10.0)
    assert not any(k is eng._keys for k in graphs._HELD)


# --- parity with the JAX package on bridged parameters ---

MIXED = [(0, None), (1, ["DT", "NN", "VBZ"]), (2, None), (3, ["NN", "VBG", "IN", "DT", "NN"]),
         (4, None)]


def jax_offline(setup, jp, rows, mode, nbest=0, members=0):
    """The JAX package's offline path on one batch of `rows` [(feature
    index, tags or None)]: (tokens [B, L] or [B, n, L], tags [B, Lp],
    scores [B] / [B, n] or None) as numpy."""
    m, ev = setup.jcfg.model, setup.jcfg.eval
    app = jnp.asarray(np.stack([setup.feats[i][0] for i, _ in rows]))
    mot = jnp.asarray(np.stack([setup.feats[i][1] for i, _ in rows]))
    mask = jnp.ones((len(rows), m.num_frames), jnp.float32)
    if members:
        fn = j_ens.make_ensemble_caption_fn(ev.beam_size if mode == "beam" else 1,
                                            m.max_pos_len, ev.max_decode_len,
                                            return_all=bool(nbest))
        out = fn(jp, app, mot, mask)
        if nbest:
            return np.asarray(out[0])[:, :nbest], np.asarray(out[2]), np.asarray(out[1])[:, :nbest]
        return np.asarray(out[0]), np.asarray(out[1]), None
    tags = np.stack([setup.tag_ids(t)[0] if t else np.zeros(m.max_pos_len, np.int64)
                     for _, t in rows]).astype(np.int32)
    use = jnp.asarray([t is not None for _, t in rows])
    ctx, summary, tags_out = j_cap.encode_for_inference(
        jp, app, mot, mask, pos_tags=jnp.asarray(tags), max_pos_len=m.max_pos_len,
        early_stop=True, use_tags=use)
    if mode == "greedy":
        toks = j_greedy.greedy_decode(jp.decoder, ctx, summary, ev.max_decode_len,
                                      early_stop=True)
        return np.asarray(toks), np.asarray(tags_out), None
    toks, scores = j_beam.beam_search(jp.decoder, ctx, summary, ev.beam_size, ev.max_decode_len,
                                      ev.length_penalty, early_stop=True,
                                      return_all=bool(nbest))
    if nbest:
        return np.asarray(toks)[:, :nbest], np.asarray(tags_out), np.asarray(scores)[:, :nbest]
    return np.asarray(toks), np.asarray(tags_out), np.asarray(scores)


def served(setup, params, rows, **kw):
    with setup.engine(params, buckets=(1, 2, 4), max_wait_ms=20.0, **kw) as eng:
        futs = [eng.submit(*setup.feats[i], pos_tags=t) for i, t in rows]
        return [f.result(timeout=WAIT) for f in futs]


def assert_matches_jax(setup, results, rows, jout, nbest=0):
    toks, tags, scores = jout
    for i, ((_, t), res) in enumerate(zip(rows, results)):
        assert res.controlled == (t is not None)
        assert res.pos_sequence == " ".join(setup.pos_vocab.decode(tags[i].tolist()))
        if nbest:
            assert [c for c, _ in res.nbest] == [setup.vocab.decode_str(toks[i, n].tolist())
                                                 for n in range(nbest)]
            np.testing.assert_allclose([s for _, s in res.nbest], scores[i], **SCORE_TOL)
            assert res.caption == res.nbest[0][0]
        else:
            assert res.caption == setup.vocab.decode_str(toks[i].tolist())
        if scores is None:
            assert res.score is None
        else:
            np.testing.assert_allclose(res.score, scores[i, 0] if nbest else scores[i],
                                       **SCORE_TOL)


@pytest.mark.parametrize("mode,nbest", [("greedy", 0), ("beam", 0), ("beam", 3)],
                         ids=["greedy", "beam", "nbest"])
def test_served_matches_jax(setup, mode, nbest):
    """Mixed free-run and controlled requests, served in padded buckets,
    against the JAX package's offline batch on the same numpy weights."""
    results = served(setup, setup.params, MIXED, mode=mode, nbest=nbest)
    assert_matches_jax(setup, results, MIXED, jax_offline(setup, setup.jp, MIXED, mode, nbest),
                       nbest)


@pytest.fixture(scope="module")
def two_members(setup):
    jp1, tp1 = numpy_params(setup.jcfg, seed=6)
    return j_ens.stack_params([setup.jp, jp1]), (setup.params, tp1)


@pytest.mark.parametrize("mode,nbest", [("greedy", 0), ("beam", 2)], ids=["greedy", "nbest"])
def test_served_ensemble_matches_jax(setup, two_members, mode, nbest):
    """A two-member ensemble (each member on its own K1-K3 path) served
    against the JAX package's stacked ensemble caption function."""
    jstack, members = two_members
    rows = [(i, None) for i in range(5)]
    results = served(setup, members, rows, mode=mode, nbest=nbest, n_members=2)
    assert_matches_jax(setup, results, rows,
                       jax_offline(setup, jstack, rows, mode, nbest, members=2), nbest)


def test_http_server_takes_many_connections_at_once(setup):
    """64 clients connecting at the same moment are all served: the
    listen backlog (socketserver's default is 5) does not reset them."""
    app, mot = setup.feats[5]
    body = json.dumps({"app": app.tolist(), "motion": mot.tolist()}).encode()
    with setup.engine(mode="greedy", buckets=(1, 4, 16, 64), max_wait_ms=5.0) as eng:
        httpd = serve(eng, "127.0.0.1", 0)
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        conns = [http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=WAIT)
                 for _ in range(64)]
        barrier, codes, lock = threading.Barrier(64), [], threading.Lock()

        def client(conn):
            barrier.wait(30)
            try:
                conn.request("POST", "/caption", body=body,
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                resp.read()
                code = resp.status
            except OSError as e:
                code = repr(e)
            with lock:
                codes.append(code)

        ts = [threading.Thread(target=client, args=(c,)) for c in conns]
        try:
            for c in ts:
                c.start()
            for c in ts:
                c.join(WAIT)
                assert not c.is_alive()
        finally:
            for c in conns:
                c.close()
            httpd.shutdown()
            httpd.server_close()
            t.join(30)
    assert codes == [200] * 64


# --- data-parallel serving over a mesh (the JAX package's config 5 tests) ---


def mesh4():
    from controllable_xgating_torch.parallel.mesh import make_mesh

    return make_mesh(devices=["cpu"] * 4)


MESH_ROWS = [(i % 6, ["DT", "NN"] if i == 2 else None) for i in range(5)]


def served_on_mesh(setup, params, mesh, rows=MESH_ROWS, **kw):
    with setup.engine(params, buckets=(8,), max_wait_ms=40.0, mesh=mesh, **kw) as eng:
        futs = [eng.submit(*setup.feats[i], pos_tags=t) for i, t in rows]
        return [f.result(timeout=WAIT) for f in futs]


def assert_same_results(got, want):
    for g, w in zip(got, want):
        assert (g.caption, g.pos_sequence, g.controlled) == (w.caption, w.pos_sequence,
                                                             w.controlled)
        if w.score is not None:
            np.testing.assert_allclose(g.score, w.score, **SCORE_TOL)
        if w.nbest is not None:
            assert [c for c, _ in g.nbest] == [c for c, _ in w.nbest]


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_mesh_dp_serving_matches_single_device(setup, mode):
    """The engine over a mesh of four CPU entries (parameters replicated,
    every bucket batch split into blocks of 2 rows) captions as the
    single-device engine and as the JAX offline path; a bucket the mesh
    does not divide is refused."""
    single = served_on_mesh(setup, setup.params, None, mode=mode)
    sharded = served_on_mesh(setup, setup.params, mesh4(), mode=mode)
    assert_same_results(sharded, single)
    assert_matches_jax(setup, sharded, MESH_ROWS, jax_offline(setup, setup.jp, MESH_ROWS, mode))
    with pytest.raises(ValueError, match="not divisible"):
        setup.engine(buckets=(2,), mesh=mesh4())
    with pytest.raises(ValueError, match=r"buckets \[6\] not divisible by the 4-device mesh"):
        setup.engine(buckets=(4, 6, 8), mesh=mesh4())


def test_mesh_ensemble_serving_matches_single_device(setup, two_members):
    """Ensemble serving over the mesh (members replicated, batch split)
    captions as the unsharded ensemble engine and as JAX's ensemble."""
    jstack, members = two_members
    single = served_on_mesh(setup, members, None, mode="greedy", n_members=2)
    sharded = served_on_mesh(setup, members, mesh4(), mode="greedy", n_members=2)
    assert_same_results(sharded, single)
    rows = [(i, None) for i, _ in MESH_ROWS]
    free = served_on_mesh(setup, members, mesh4(), rows, mode="greedy", n_members=2)
    assert_matches_jax(setup, free, rows, jax_offline(setup, jstack, rows, "greedy", members=2))


def test_mesh_nbest_serving_matches_single_device(setup):
    """n-best over the mesh: the packed multi-row layout survives the
    split (lists and scores equal the unsharded engine's and JAX's)."""
    rows = [(i, None) for i in range(3)]
    single = served_on_mesh(setup, setup.params, None, rows, mode="beam", nbest=2)
    sharded = served_on_mesh(setup, setup.params, mesh4(), rows, mode="beam", nbest=2)
    assert_same_results(sharded, single)
    for g, w in zip(sharded, single):
        np.testing.assert_allclose([s for _, s in g.nbest], [s for _, s in w.nbest], **SCORE_TOL)
    assert_matches_jax(setup, sharded, rows, jax_offline(setup, setup.jp, rows, "beam", 2), 2)


def test_mesh_engine_warms_and_serves_every_bucket(setup):
    """warmup() runs every bucket over the mesh; a full bucket of 8 and a
    single request (bucket 4: a row a device) both answer as offline."""
    with setup.engine(mode="greedy", buckets=(4, 8), max_wait_ms=40.0, mesh=mesh4()) as eng:
        eng.warmup()
        futs = [eng.submit(*setup.feats[i % 6]) for i in range(8)]
        full = [f.result(timeout=WAIT) for f in futs]
        solo = eng.caption(*setup.feats[3], timeout=WAIT)
        stats = eng.stats()
    for i, res in enumerate(full):
        assert_result(res, setup.expected(*setup.feats[i % 6]))
    assert_result(solo, setup.expected(*setup.feats[3]))
    assert solo.batch_size == 4 and stats["requests"] == 9
