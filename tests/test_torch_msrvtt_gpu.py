"""The port's caption and training paths at MSR-VTT width, on the card.

Marked `gpu`: every test skips without a CUDA device. The widths are
`configs/msrvtt.json`'s with vocab 10000 and 35 POS tags (the JAX bench's
MSR-VTT sizes), the weights random and seeded, the inputs 256 seeded
videos of 26 frames, half of them padded in time. At these sizes K4 merges
79 vocab chunks under bf16 (20 under f32), K3 runs 20 row tiles and K4
10, and K5 takes the step's [8640, 10000] logits, which the narrow
captioners of the other files never reach; the decode loops replay CUDA graphs captured at these
shapes and are held against their eager loops. Bounds: the kernel path's
captions equal the plain path's on at least 98% of the videos under f32
(the kernels sum in another order, so near-ties of random weights flip
a few); everything else is exact or at the bound its docstring names.
This file imports no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_msrvtt_gpu.py
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from controllable_xgating_torch.ops import kernels
from controllable_xgating_torch.ops.dispatch import set_fused_kernels
from controllable_xgating_torch.ops.precision import precision

pytestmark = pytest.mark.gpu
B, T, K, MAX_LEN = 256, 26, 5, 28
VOCAB, POS_VOCAB = 10000, 35
AGREE_MIN = 0.98
TRAIN_VIDEOS = 128  # two batches of 64 an epoch
PATH = ("xgate", "pos_lstm", "attn_lstm")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels build with nvcc for sm_90a)")
    return torch.device("cuda:0")


def msrvtt_config(path="configs/msrvtt.json", **over):
    from controllable_xgating_torch.utils.config import load_config

    return load_config(path, {"model.vocab_size": VOCAB, "model.pos_vocab_size": POS_VOCAB,
                              **over})


class Store:
    """Features in memory: the `get_batch` / `frame_mask` interface of the
    port's feature stores."""

    def __init__(self, app, motion, counts):
        self.app, self.motion, self.counts = app, motion, counts

    def get_batch(self, idx):
        return self.app[idx], self.motion[idx]

    def frame_mask(self, idx):
        return (np.arange(self.app.shape[1])[None] < self.counts[idx][:, None]).astype(np.float32)


def draw_features(rng, n, da, dm):
    """n videos' (app, motion, frame counts), half of them padded in time."""
    app = rng.normal(size=(n, T, da)).astype(np.float32)
    mot = rng.normal(size=(n, T, dm)).astype(np.float32)
    return app, mot, np.where(rng.random(n) < 0.5, T, rng.integers(T // 2, T, n))


def draw_captions(rng, n, s):
    """n x s captions and POS tag sequences: BOS, 5-25 ids, EOS, PAD; int32."""
    words = rng.integers(6, MAX_LEN - 1, (n, s))[..., None]
    col = np.arange(MAX_LEN)[None, None, :]
    caps = np.where(col <= words, rng.integers(4, VOCAB, (n, s, MAX_LEN)), 0)
    pos = np.where(col <= words, rng.integers(4, POS_VOCAB, (n, s, MAX_LEN)), 0)
    for arr in (caps, pos):
        arr[..., 0] = 1
        np.put_along_axis(arr, words, 2, axis=-1)
    return caps.astype(np.int32), pos.astype(np.int32)


def draw_videos(rng, n, s, da, dm):
    """(app, motion, frame counts, caps, pos, ncaps): n videos with s
    captions each, s // 2 .. s of them real."""
    app, mot, counts = draw_features(rng, n, da, dm)
    caps, pos = draw_captions(rng, n, s)
    return app, mot, counts, caps, pos, rng.integers(s // 2, s + 1, n)


def corpus(cfg, seed=0):
    """B videos (zero past their frame count) and 3 references each over a
    10000-word vocabulary, as `evaluate_split` reads them."""
    from controllable_xgating_torch.data.vocab import Vocab

    rng = np.random.default_rng(seed)
    app, mot, counts = draw_features(rng, B, cfg.model.app_dim, cfg.model.motion_dim)
    live = np.arange(T)[None, :, None] < counts[:, None, None]
    caps = np.zeros((B, 3, MAX_LEN), np.int64)
    caps[:, :, 0], caps[:, :, 9] = 1, 2
    caps[:, :, 1:9] = rng.integers(4, VOCAB, (B, 3, 8))
    info = SimpleNamespace(splits={"test": list(range(B))}, video_ids=[f"video{i}" for i in range(B)],
                           vocab=Vocab([f"w{i}" for i in range(VOCAB - 4)]))
    return Store(app * live, mot * live, counts), {"caps": caps, "ncaps": np.full(B, 3)}, info


def on_card(store, dev):
    idx = np.arange(B)
    return (*(torch.as_tensor(x, device=dev) for x in store.get_batch(idx)),
            torch.as_tensor(store.frame_mask(idx), device=dev))


@pytest.fixture(scope="module")
def msrvtt(card):
    from controllable_xgating_torch.models.captioner import init_captioner

    cfg = msrvtt_config()
    store, labels, info = corpus(cfg)
    return SimpleNamespace(cfg=cfg, params=init_captioner(cfg, seed=0, device=card), store=store,
                           labels=labels, info=info, x=on_card(store, card), dev=card)


def caption_fn(beam, fused=None):
    from controllable_xgating_torch.infer.beam import make_beam_caption_fn
    from controllable_xgating_torch.infer.evaluator import make_greedy_caption_fn

    if beam:
        return make_beam_caption_fn(K, MAX_LEN, MAX_LEN, fused=fused)
    return make_greedy_caption_fn(MAX_LEN, MAX_LEN, fused=fused)


def counted(fn):
    """(fn(), the kernel launches it made)."""
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, kernels.launch_counts()


def call(make, params, x, fused):
    """The caption function `make()` builds under the kernel setting `fused`
    (a factory reads it when it builds), called on x."""
    set_fused_kernels(fused)
    try:
        out = make()(params, *x)
    finally:
        set_fused_kernels(None)
    torch.cuda.synchronize()
    return out


def split(params, m, fn, **kw):
    """`evaluate_split` of the B videos with `fn` -> (metrics, captions)."""
    from controllable_xgating_torch.infer.evaluator import evaluate_split

    return evaluate_split(params, m.store, m.labels, m.info, split="test", batch_size=B,
                          max_len=MAX_LEN, max_pos_len=MAX_LEN, caption_fn=fn, **kw)


def finite(metrics, caps):
    return len(caps) == B and all(math.isfinite(v) for v in metrics.values())


def agreement(a, b):
    return (a == b).all(-1).float().mean().item()


def tokens_ok(t):
    return t.shape == (B, MAX_LEN) and int(t.min()) >= 0 and int(t.max()) < VOCAB


@pytest.mark.parametrize("beam", [True, False], ids=["beam5", "greedy"])
def test_caption_path_launches_its_kernels_and_agrees_with_the_plain_path(msrvtt, beam):
    """Through `evaluate_split` under bf16 every kernel of the path
    launches and the metrics are finite; the kernel path's tokens lie in
    the vocabulary under f32 and bf16 and equal the plain path's on >= 98%
    of the videos under f32."""
    m = msrvtt
    with precision("bfloat16"):
        (metrics, caps), got = counted(lambda: split(m.params, m, caption_fn(beam)))
    assert all(got[n] for n in PATH + (("topk_tail",) if beam else ())), got
    assert finite(metrics, caps), metrics
    for policy in ("float32", "bfloat16"):
        with precision(policy):
            a, b = (call(lambda: caption_fn(beam), m.params, m.x, f)[0] for f in (None, False))
        assert tokens_ok(a) and tokens_ok(b)
        if policy == "float32":
            assert agreement(a, b) >= AGREE_MIN


@pytest.mark.parametrize("beam", [False, True], ids=["greedy", "beam5"])
def test_quantized_path(msrvtt, beam):
    """`vocab_q` through `tools/quant_ab.py`'s caption function: under bf16
    K7 launches once a step, K4 never, K1-K3 as on the unquantized path;
    under f32 its kernel and plain paths agree on >= 98% of the videos."""
    from controllable_xgating_torch.experiments.int8_vocab_matmul import quantize_vocab_proj
    from controllable_xgating_torch.tools.quant_ab import make_fn

    m = msrvtt
    vq = quantize_vocab_proj(m.params.decoder.w_out, m.params.decoder.b_out)
    with precision("bfloat16"):
        _, base = counted(lambda: split(m.params, m, caption_fn(beam)))
        (metrics, caps), got = counted(lambda: split(m.params, m, make_fn(m.cfg, beam, vq)))
    assert got["int8_vocab"] == MAX_LEN and got["topk_tail"] == 0, got
    assert all(got[n] == base[n] for n in PATH), (got, base)
    assert finite(metrics, caps), metrics
    with precision("float32"):
        a, b = (call(lambda: make_fn(m.cfg, beam, vq), m.params, m.x, f)[0] for f in (None, False))
    assert tokens_ok(a) and tokens_ok(b)
    assert agreement(a, b) >= AGREE_MIN


@pytest.mark.parametrize("policy", ["bfloat16", "float32"])
def test_full_log_softmax_tails_give_equal_tokens(msrvtt, policy):
    """Beam 5 on the plain path through each tail that forms the full
    log-softmax: grouped, flat and block give the same tokens."""
    from controllable_xgating_torch.infer.beam import make_beam_caption_fn

    m = msrvtt
    with precision(policy):
        toks = {mode: make_beam_caption_fn(K, MAX_LEN, MAX_LEN, fused=False, topk_mode=mode)(
            m.params, *m.x[:2])[0] for mode in ("grouped", "flat", "block")}
    assert torch.equal(toks["flat"], toks["grouped"]) and torch.equal(toks["block"], toks["grouped"])


def test_beam10_routes_to_the_grouped_tail(msrvtt):
    """Beam 10 is wider than K4's k <= 8: `auto` takes the grouped tail
    (no K4 launch) and gives its tokens under bf16; under f32 the kernel
    path agrees with the plain grouped tail on >= 98% of the videos."""
    from controllable_xgating_torch.infer.beam import make_beam_caption_fn

    m = msrvtt
    run = lambda fused, mode: make_beam_caption_fn(10, MAX_LEN, MAX_LEN, fused=fused,
                                                   topk_mode=mode)(m.params, *m.x)[0]
    with precision("bfloat16"):
        auto, got = counted(lambda: run(None, "auto"))
        grouped = run(None, "grouped")
    assert got["topk_tail"] == 0 and all(got[n] for n in PATH), got
    assert auto.shape == (B, MAX_LEN) and torch.equal(auto, grouped)
    with precision("float32"):
        assert agreement(run(None, "auto"), run(False, "grouped")) >= AGREE_MIN


# the cross-architecture member: concat fusion, no psi, other widths
ALT = {"model.fusion": "concat", "model.pos_guidance": False, "model.hidden_dim": 384,
       "model.embed_dim": 256, "model.attn_dim": 256, "model.pos_embed_dim": 256}


@pytest.mark.parametrize("alt", [False, True], ids=["same-architecture", "cross-architecture"])
def test_ensemble_beam5_through_evaluate_split(msrvtt, alt):
    """A two-member ensemble at beam 5 (bf16): K3 once per member a step,
    K1 once per xgate-mode member, K2 for each member, no K4, finite
    metrics, a run of all 28 steps; under f32 the kernel path agrees with
    the plain path on >= 98% of the videos."""
    from controllable_xgating_torch.data.vocab import EOS
    from controllable_xgating_torch.infer.ensemble import make_ensemble_caption_fn
    from controllable_xgating_torch.models.captioner import init_captioner

    m = msrvtt
    other = (init_captioner(m.cfg.replace_flat(ALT), seed=2, device=m.dev) if alt
             else init_captioner(m.cfg, seed=1, device=m.dev))
    members = (m.params, other)
    make = lambda: make_ensemble_caption_fn(K, MAX_LEN, MAX_LEN)
    with precision("bfloat16"):
        (metrics, caps), got = counted(lambda: split(members, m, make()))
        tokens = call(make, members, m.x, None)[0]
    assert finite(metrics, caps), metrics
    assert not bool((tokens == EOS).any(1).all())  # the counts below need a full run
    assert got["attn_lstm"] == 2 * MAX_LEN and got["xgate"] == 2 - alt, got
    assert got["topk_tail"] == 0 and got["pos_lstm"] >= 2, got
    with precision("float32"):
        assert agreement(call(make, members, m.x, None)[0],
                         call(make, members, m.x, False)[0]) >= AGREE_MIN


def test_diverse_beam6_in_three_groups(msrvtt):
    """Beam 6 in 3 groups: one group is the plain beam; K1-K3 and no K4
    launch; at penalty 1e3 the groups' first words are disjoint after one
    step and each video keeps 3 distinct first words after all; under f32
    the kernel path agrees with the plain path on >= 98% of the videos."""
    from controllable_xgating_torch.data.vocab import PAD
    from controllable_xgating_torch.infer.beam import make_beam_caption_fn

    m = msrvtt
    div = lambda g, pen=0.5, length=MAX_LEN, **kw: lambda: make_beam_caption_fn(
        6, MAX_LEN, length, diversity_groups=g, diversity_penalty=pen, **kw)
    with precision("bfloat16"):
        assert torch.equal(call(div(1), m.params, m.x, None)[0], call(div(0), m.params, m.x, None)[0])
        _, got = counted(lambda: call(div(3), m.params, m.x, None))
        first = call(div(3, 1e3, length=1, return_all=True), m.params, m.x, None)[0][:, :, 0]
        full = call(div(3, 1e3, return_all=True), m.params, m.x, None)[0][:, :, 0]
    assert got["topk_tail"] == 0 and all(got[n] for n in PATH), got
    assert all(len(set(r)) == 6 for r in first.tolist())
    assert all(len(set(r) - {PAD}) >= 3 for r in full.tolist())
    with precision("float32"):
        assert agreement(call(div(3), m.params, m.x, None)[0],
                         call(div(3), m.params, m.x, False)[0]) >= AGREE_MIN


def test_ensemble_identity_at_msrvtt_width(msrvtt):
    """Under f32 through the kernels, the ensemble [p, p]: its beam-5
    n-best equals the single model's on the grouped tail (tokens and
    lengths equal, scores within rtol 1e-6, atol 0), and its greedy
    tokens equal the single model's."""
    from controllable_xgating_torch.infer.beam import make_beam_caption_fn
    from controllable_xgating_torch.infer.ensemble import make_ensemble_caption_fn
    from controllable_xgating_torch.infer.evaluator import make_greedy_caption_fn

    m = msrvtt
    pair = (m.params, m.params)
    with precision("float32"):
        single = call(lambda: make_beam_caption_fn(K, MAX_LEN, MAX_LEN, topk_mode="grouped",
                                                   return_all=True), m.params, m.x, None)
        ens = call(lambda: make_ensemble_caption_fn(K, MAX_LEN, MAX_LEN, return_all=True),
                   pair, m.x, None)
        g1 = call(lambda: make_greedy_caption_fn(MAX_LEN, MAX_LEN), m.params, m.x, None)[0]
        g2 = call(lambda: make_ensemble_caption_fn(1, MAX_LEN, MAX_LEN), pair, m.x, None)[0]
    assert torch.equal(ens[0], single[0]) and torch.equal(ens[2], single[2])
    torch.testing.assert_close(ens[1], single[1], rtol=1e-6, atol=0.0)
    assert torch.equal(g1, g2)


# the graphed paths: whole caption calls, then the loops alone on one encoding
GRAPHED = ["beam5", "greedy", "beam5-int8", "greedy-int8", "ensemble-beam5", "diverse-beam6",
           "beam5-loop", "greedy-loop", "pos-rollout"]


def graphed_path(m, path):
    """`path`'s call on the 256 videos, built now under the current policy
    (the factories read the kernel setting when they build; a loop alone
    runs on an encoding made now), through the kernels."""
    from controllable_xgating_torch.experiments.int8_vocab_matmul import quantize_vocab_proj
    from controllable_xgating_torch.infer.beam import beam_search, make_beam_caption_fn
    from controllable_xgating_torch.infer.ensemble import make_ensemble_caption_fn
    from controllable_xgating_torch.infer.greedy import greedy_decode
    from controllable_xgating_torch.models.captioner import encode_for_inference, init_captioner
    from controllable_xgating_torch.models.pos_generator import pos_greedy_generate
    from controllable_xgating_torch.tools.quant_ab import make_fn

    p = m.params
    if path in ("beam5-loop", "greedy-loop", "pos-rollout"):
        with torch.inference_mode():
            ctx, summary, _ = encode_for_inference(p, *m.x, max_pos_len=MAX_LEN, fused=True)
        loop = {
            "beam5-loop": lambda: beam_search(p.decoder, ctx, summary, K, MAX_LEN, fused=True,
                                              early_stop=True),
            "greedy-loop": lambda: greedy_decode(p.decoder, ctx, summary, MAX_LEN, fused=True,
                                                 early_stop=True),
            "pos-rollout": lambda: pos_greedy_generate(p.pos, summary, MAX_LEN, early_stop=True,
                                                       fused=True),
        }[path]
        return torch.inference_mode()(loop)
    if path.endswith("int8"):
        fn = make_fn(m.cfg, path.startswith("beam"),
                     quantize_vocab_proj(p.decoder.w_out, p.decoder.b_out))
    elif path == "ensemble-beam5":
        fn, p = make_ensemble_caption_fn(K, MAX_LEN, MAX_LEN), \
            (p, init_captioner(m.cfg, seed=1, device=m.dev))
    elif path == "diverse-beam6":
        fn = make_beam_caption_fn(6, MAX_LEN, MAX_LEN, diversity_groups=3)
    else:
        fn = caption_fn(path == "beam5")
    return lambda: fn(p, *m.x)


def decode_graphs(fn, on):
    """fn() with the decode loops graphed (`on`) or eager, under a span
    collector -> (its outputs as a tuple, keys captured, chunks replayed)."""
    from controllable_xgating_torch.ops.dispatch import set_decode_graphs
    from controllable_xgating_torch.utils import spans

    set_decode_graphs(None if on else False)
    try:
        with spans.collect() as col:
            out = fn()
            torch.cuda.synchronize()
    finally:
        set_decode_graphs(None)
    counters = col.summary()["counters"]
    total = lambda what: sum(v for k, v in counters.items() if k.startswith(f"graphs.{what}."))
    return (out if isinstance(out, tuple) else (out,)), total("captures"), total("replays")


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", GRAPHED)
def test_graphed_equals_eager_at_msrvtt_width(msrvtt, path, policy):
    """Each path's decode loops replayed as CUDA graphs (`infer/graphs.py`)
    against its eager loops (`set_decode_graphs(False)`), through the
    kernels over the 256 videos: beam 5 (the lanes tail), greedy, both
    with `vocab_q`, the ensemble's beam 5, diverse beam 6 in 3 groups, and
    beam 5's, greedy's and the POS rollout's loops alone. On the capturing
    call and on a replay, tokens and tags equal the eager call's and the
    floats (scores, psi) are within rtol 1e-6, atol 0 (the same kernels on
    the same operands: only the launch mechanism differs); the replay
    captures nothing and launches what the eager call launches."""
    from controllable_xgating_torch.infer import graphs

    with precision(policy):
        fn = graphed_path(msrvtt, path)
        graphs.clear()  # the keys cached next are this path's
        (want, _, eager_replays), eager = counted(lambda: decode_graphs(fn, False))
        assert eager_replays == 0
        for replay in (False, True):
            (got, captures, replays), launches = counted(lambda: decode_graphs(fn, True))
            assert replays > 0 and (captures == 0) == replay, (captures, replays)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                if a.dtype.is_floating_point:
                    torch.testing.assert_close(a, b, rtol=1e-6, atol=0.0)
                else:
                    assert torch.equal(a, b)
        assert launches == eager and any(eager.values()), (launches, eager)


# kernel launches a warm beam-5 caption call makes outside its graphs' launches:
# K1, the summary, the decode context, the raw inputs' copies and the outputs' clones
MAX_EAGER_LAUNCHES = 64
KERNEL_LAUNCH_CALLS = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                       "cuLaunchKernelEx"}


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
def test_warm_beam_call_launches_little_outside_its_graphs(msrvtt, policy):
    """A warm beam-5 caption call over the 256 videos, profiled: its three
    loops (the BiLSTM, the POS rollout, the decode) each replay a prologue,
    their chunks and an epilogue, so that the host's own kernel launches
    (runtime calls, `KERNEL_LAUNCH_CALLS`) are at most
    MAX_EAGER_LAUNCHES, against the graph launches."""
    from torch.profiler import ProfilerActivity, profile

    from controllable_xgating_torch.utils import spans

    m = msrvtt
    with precision(policy):
        fn = caption_fn(True)
        for _ in range(2):
            fn(m.params, *m.x)
        torch.cuda.synchronize()
        with spans.collect() as col, profile(activities=[ProfilerActivity.CPU,
                                                          ProfilerActivity.CUDA]) as prof:
            fn(m.params, *m.x)
            torch.cuda.synchronize()
    counters = col.summary()["counters"]
    names = [e.name for e in prof.events()]
    eager = sum(n in KERNEL_LAUNCH_CALLS for n in names)
    graph_launches = names.count("cudaGraphLaunch")
    chunks = sum(v for k, v in counters.items() if k.startswith("graphs.replays."))
    print(f"{policy}: {eager} kernel launches outside graphs, {graph_launches} graph launches, "
          f"{chunks} chunks")
    assert not any(k.startswith("graphs.captures.") for k in counters), counters
    assert all(counters.get(f"graphs.setups.{k}") == 1 for k in ("bilstm", "pos", "beam"))
    assert graph_launches == chunks + 2 * 3, (graph_launches, chunks)
    assert 0 < eager <= MAX_EAGER_LAUNCHES, eager


def test_mesh_eval(msrvtt):
    """`evaluate_split` over a mesh of two entries (two cards, or the one
    card twice): K1 once a block, K2-K4 launched, finite metrics; each
    block's tokens equal the call at the block's batch (bf16 and f32), and
    under f32 the sharded tokens agree with the 256-video call on >= 98%
    of the videos (the batch size changes sums on the card)."""
    from controllable_xgating_torch.infer.evaluator import sharded_call
    from controllable_xgating_torch.parallel.mesh import make_mesh, replicate, shard_rows

    m = msrvtt
    mesh = make_mesh(2) if torch.cuda.device_count() >= 2 else make_mesh(devices=[m.dev, m.dev])
    with precision("bfloat16"):
        (metrics, caps), got = counted(lambda: split(m.params, m, caption_fn(True), mesh=mesh))
    assert all(got[n] for n in PATH + ("topk_tail",)) and got["xgate"] == mesh.size, got
    assert finite(metrics, caps), metrics
    reps, idx = replicate(m.params, mesh), np.arange(B)
    host = (*m.store.get_batch(idx), m.store.frame_mask(idx))
    for policy in ("bfloat16", "float32"):
        with precision(policy):
            fn = caption_fn(True)
            tokens = sharded_call(fn, reps, mesh, *host)[0]
            for d, sl in zip(mesh.devices, shard_rows(B, mesh)):
                want = fn(reps[d], *(torch.as_tensor(x[sl], device=d) for x in host))[0].cpu()
                assert torch.equal(tokens[sl], want), (policy, sl)
            whole = fn(m.params, *m.x)[0].cpu()
        if policy == "float32":
            assert agreement(tokens, whole) >= AGREE_MIN


def test_served_videos_agree_with_the_offline_call(msrvtt):
    """The 256 videos served from 4 threads by an engine at buckets 1, 4,
    16 and 64 (beam 5, f32) caption as the 256-video offline call on >=
    98% of the videos."""
    from concurrent.futures import ThreadPoolExecutor

    from controllable_xgating_torch.data.vocab import Vocab
    from controllable_xgating_torch.serve.engine import ServingEngine

    m = msrvtt
    app, mot = m.store.get_batch(np.arange(B))
    with precision("float32"):
        tags = Vocab([f"t{i}" for i in range(POS_VOCAB - 4)])
        with ServingEngine(m.params, m.cfg, m.info.vocab, tags, mode="beam",
                           buckets=(1, 4, 16, 64)) as eng:
            eng.warmup()
            with ThreadPoolExecutor(4) as pool:
                futs = list(pool.map(lambda i: eng.submit(app=app[i], motion=mot[i],
                                                          nframes=int(m.store.counts[i])), range(B)))
            served = [f.result(timeout=300) for f in futs]
        toks = caption_fn(True)(m.params, *m.x)[0].cpu().numpy()
    same = [r.caption == m.info.vocab.decode_str(t) for r, t in zip(served, toks)]
    assert np.mean(same) >= AGREE_MIN


@pytest.mark.parametrize("label", ["config5 beam5", "config5 greedy", "c3d beam5"])
def test_config5_and_c3d_paths(card, label):
    """Config 5 (decoder Hd 1024) and the C3D widths (motion 4096) over
    the 256 videos: through `evaluate_split` (bf16) K1 once, K2 and K3 28
    times, K4 28 times in beam 5 (the lanes tail at Hd 1024), finite
    metrics; under f32 K1 once a call and >= 98% agreement with the plain
    path. At C3D what changes is K1's input, so K1 is held inside the
    path: its encoder under the plain decoder against the plain path, and
    the kernel path against itself with the plain encoder."""
    from controllable_xgating_torch.infer.beam import beam_search
    from controllable_xgating_torch.models.captioner import encode_for_inference, init_captioner

    c3d, beam = label.startswith("c3d"), "beam" in label
    cfg = (msrvtt_config("configs/msvd_c3d.json") if c3d
           else msrvtt_config(**{"model.decoder_hidden_mult": 2}))
    params = init_captioner(cfg, seed=0, device=card)
    assert (params.encoder.xgate.wm.shape[0] == 4096) if c3d else (params.decoder.hidden_dim == 1024)
    store, labels, info = corpus(cfg)
    m = SimpleNamespace(store=store, labels=labels, info=info)
    with precision("bfloat16"):
        (metrics, caps), got = counted(lambda: split(params, m, caption_fn(beam)))
    want = {"xgate": 1, "pos_lstm": MAX_LEN, "attn_lstm": MAX_LEN,
            **({"topk_tail": MAX_LEN} if beam else {})}
    assert {n: got[n] for n in want} == want, got
    assert finite(metrics, caps), metrics
    x = on_card(store, card)
    with precision("float32"):
        a, k1 = counted(lambda: caption_fn(beam)(params, *x)[0])
        if c3d:
            enc = {f: encode_for_inference(params, *x, max_pos_len=MAX_LEN, fused=f)
                   for f in (True, False)}
            dec = lambda e, f: beam_search(params.decoder, enc[e][0], enc[e][1], K, MAX_LEN,
                                           fused=f)[0]
            agree = min(agreement(dec(True, False), dec(False, False)),
                        agreement(dec(True, True), dec(False, True)))
        else:
            agree = agreement(a, caption_fn(beam, False)(params, *x)[0])
    assert k1["xgate"] == 1 and agree >= AGREE_MIN


def train_batches(cfg, seed=1):
    """TrainBatchIterator over TRAIN_VIDEOS seeded videos (`draw_videos`)."""
    from controllable_xgating_torch.data.loader import TrainBatchIterator

    app, mot, counts, caps, pos, ncaps = draw_videos(
        np.random.default_rng(seed), TRAIN_VIDEOS, cfg.data.seqs_per_video, cfg.model.app_dim,
        cfg.model.motion_dim)
    return TrainBatchIterator(Store(app, mot, counts), caps, pos, ncaps, np.arange(TRAIN_VIDEOS),
                              cfg.data.batch_size, cfg.data.caps_per_video_train, seed=0)


def fresh(cfg, dev):
    """A train state from `init_captioner(seed=0)` and the joint XE step."""
    from controllable_xgating_torch.models.captioner import init_captioner
    from controllable_xgating_torch.train.state import create_train_state, make_optimizer
    from controllable_xgating_torch.train.xe import make_xe_train_step

    state = create_train_state(init_captioner(cfg, seed=0, device=dev), cfg)
    tx = make_optimizer(cfg, TRAIN_VIDEOS // cfg.data.batch_size, "joint")
    return state, make_xe_train_step(tx, cfg, "joint")


def test_xe_steps_launch_k5_and_learn(card):
    """Six joint steps of 64 x 5 under bf16 at dropout 0.5: K5 forward and
    backward once a step, finite metrics; then ten steps on one batch at
    dropout 0: the loss falls."""
    cfg = msrvtt_config()
    batches = iter(train_batches(cfg))
    with precision("bfloat16"):
        state, step = fresh(cfg, card)
        kernels.reset_launch_counts()
        for _ in range(6):
            state, m = step(state, next(batches))
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert counts["xent_fwd"] == counts["xent_bwd"] == 6, counts
        assert all(math.isfinite(float(v)) for v in m.values()), m
        batch = next(batches)
        state, step = fresh(cfg.replace_flat({"model.dropout": 0.0}), card)
        losses = [float(step(state, batch)[1]["loss"]) for _ in range(10)]
    assert losses[-1] < losses[0], losses


def test_xe_step_kernels_match_plain_path(card):
    """One f32 step (label smoothing 0.1, dropout 0.5) through K5 and
    through the plain path from the same state, batch and generator: loss
    and grad norm within rtol 1e-4, Adam's first moments of all parameters
    within a relative norm of 1e-5, the updated parameters within 1e-5."""
    cfg = msrvtt_config(**{"train.label_smoothing": 0.1})
    batches = iter(train_batches(cfg))
    batch = [next(batches) for _ in range(7)][-1]
    res = []
    with precision("float32"):
        for fused in (None, False):
            set_fused_kernels(fused)
            try:
                state, step = fresh(cfg, card)
                state, m = step(state, batch)
            finally:
                set_fused_kernels(None)
            ps = list(state.params.parameters())
            res.append((m, [p.detach().clone() for p in ps],
                        torch.cat([state.opt_state.state[p]["exp_avg"].flatten() for p in ps])))
    (mk, pk, gk), (mp, pp, gp) = res
    for key in ("loss", "grad_norm"):
        assert math.isclose(mk[key].item(), mp[key].item(), rel_tol=1e-4), key
    assert (gk - gp).norm() <= 1e-5 * gp.norm()
    assert max((a - b).abs().max().item() for a, b in zip(pk, pp)) <= 1e-5


def test_config5_xe_steps_with_and_without_prefetch(card):
    """Config 5's XE step (64 x 5): under bf16 K5 once a step whether the
    batches come through the train loop's prefetch (`DevicePut`, depth 2)
    or not; under f32 at dropout 0 the losses of 5 steps are equal bit for
    bit either way."""
    from controllable_xgating_torch.data.features import DevicePut, PrefetchIterator

    cfg = msrvtt_config(**{"model.decoder_hidden_mult": 2})

    def losses(c, prefetch, steps):
        state, step = fresh(c, card)
        src = iter(train_batches(c))
        it = PrefetchIterator(src, DevicePut(card), depth=2) if prefetch else src
        try:
            out = [step(state, next(it))[1]["loss"].item() for _ in range(steps)]
        finally:
            if prefetch:
                it.close()
        return out

    for prefetch in (True, False):
        with precision("bfloat16"):
            _, got = counted(lambda: losses(cfg, prefetch, 4))
        assert got["xent_fwd"] == got["xent_bwd"] == 4, (prefetch, got)
    c0 = cfg.replace_flat({"model.dropout": 0.0})
    with precision("float32"):
        assert losses(c0, True, 5) == losses(c0, False, 5)


# SCST at MSR-VTT's caption scale: 10000 videos x 20 captions, df over the
# 6513 of its train split
SCST_VIDEOS, SCST_DF_VIDEOS, SCST_CAPS, SCST_STEPS = 10000, 6513, 20, 5


@pytest.fixture(scope="module")
def scst_tables(card):
    """(caps, the host tables, the reward tables on the card)."""
    from controllable_xgating_torch.ops import cider_device as cd

    caps, _ = draw_captions(np.random.default_rng(4), SCST_VIDEOS, SCST_CAPS)
    host = cd.host_tables(caps, np.full(SCST_VIDEOS, SCST_CAPS, np.int32), range(SCST_DF_VIDEOS))
    return caps, host, cd.precompute_ref_stats(host.to(card))


def id_words(ids) -> str:
    """Token ids -> "w<id> ..." up to EOS, without PAD and BOS: the host
    scorer's strings (a bijection on words)."""
    out = []
    for t in ids.tolist():
        if t == 2:
            break
        if t > 2:
            out.append(f"w{t}")
    return " ".join(out)


def test_cider_d_reward_at_msrvtt_caption_scale(card, scst_tables):
    """The reward on the card over 256 candidates (a third their video's
    own reference, a third it with every third word replaced, a third
    random) against the port on the CPU from the same df table (atol
    1e-5), and the first 64 against the host `CiderDScorer` on strings
    (rtol 1e-4, atol 1e-5, the JAX package's device-vs-host bar)."""
    import dataclasses

    from controllable_xgating_torch.metrics.cider import CiderDScorer, compute_doc_freq
    from controllable_xgating_torch.ops import cider_device as cd

    caps, host, tables = scst_tables
    rng = np.random.default_rng(5)
    vids = rng.choice(SCST_VIDEOS, 256, replace=False)
    cand = np.zeros((256, MAX_LEN), np.int32)
    for i, v in enumerate(vids):
        ref = caps[v, rng.integers(0, SCST_CAPS), 1:]
        if i % 3 < 2:
            cand[i, :MAX_LEN - 1] = ref
            if i % 3 == 1:
                every3 = ref[::3]
                cand[i, :MAX_LEN - 1:3] = np.where(every3 > 2, rng.integers(4, VOCAB, len(every3)),
                                                   every3)
        else:
            n = int(rng.integers(5, 26))
            cand[i, :n], cand[i, n] = rng.integers(4, VOCAB, n), 2
    cand = torch.as_tensor(cand)
    got = cd.cider_d_device(tables, cand.to(card), torch.as_tensor(vids, device=card)).cpu()
    cpu = cd.precompute_ref_stats(dataclasses.replace(host, ref_caps=host.ref_caps[vids],
                                                      ref_counts=host.ref_counts[vids]))
    want = cd.cider_d_device(cpu, cand, torch.arange(len(vids)))
    assert torch.isfinite(got).all() and (got - want).abs().max().item() <= 1e-5
    df, num = compute_doc_freq({v: [id_words(caps[v, j]) for j in range(SCST_CAPS)]
                                for v in range(SCST_DF_VIDEOS)})
    scorer = CiderDScorer(df=df, df_num_segments=num)
    host_scores = [scorer.score({0: [id_words(caps[v, j]) for j in range(SCST_CAPS)]},
                                {0: [id_words(c)]})[0] for c, v in zip(cand.numpy()[:64], vids[:64])]
    np.testing.assert_allclose(got.numpy()[:64], host_scores, rtol=1e-4, atol=1e-5)


def test_scst_steps(card, scst_tables):
    """Each realization (separate rollouts, the paired rollout), 1 + 5
    steps of 64 videos under bf16 on the reward tables at caption scale:
    in the 5 steps K3 28 times a step and no other kernel, finite metrics,
    the POS generator bitwise unchanged; then the greedy baseline's f32
    tokens through K3 equal the plain path's on >= 98% of a batch."""
    from controllable_xgating_torch.infer.greedy import greedy_decode
    from controllable_xgating_torch.models.captioner import init_captioner
    from controllable_xgating_torch.train.scst import make_scst_train_step, scst_context
    from controllable_xgating_torch.train.state import create_train_state, make_optimizer

    cfg = msrvtt_config()
    bs = cfg.data.batch_size
    rng = np.random.default_rng(6)
    app, mot, counts = draw_features(rng, (1 + SCST_STEPS) * bs, cfg.model.app_dim,
                                     cfg.model.motion_dim)
    mask = (np.arange(T)[None, :] < counts[:, None]).astype(np.float32)
    vids = rng.choice(SCST_DF_VIDEOS, len(mask), replace=False).astype(np.int32)
    batches = [{"app": app[i:i + bs] * mask[i:i + bs, :, None],
                "motion": mot[i:i + bs] * mask[i:i + bs, :, None],
                "frame_mask": mask[i:i + bs], "video_indices": vids[i:i + bs]}
               for i in range(0, len(mask), bs)]
    for paired in (False, True):
        c = cfg.replace_flat({"train.scst_paired_rollout": paired})
        with precision("bfloat16"):
            state = create_train_state(init_captioner(c, seed=0, device=card), c)
            pos0 = [p.detach().clone() for p in state.params.pos.parameters()]
            step = make_scst_train_step(make_optimizer(c, 100, "scst"), c, scst_tables[2])
            state, _ = step(state, batches[0])
            metrics, got = counted(lambda: [step(state, b)[1] for b in batches[1:]])
        assert got == {n: MAX_LEN * SCST_STEPS if n == "attn_lstm" else 0 for n in got}, got
        assert all(math.isfinite(float(v)) for mm in metrics for v in mm.values())
        assert all(torch.equal(a, b) for a, b in zip(state.params.pos.parameters(), pos0))
    with precision("float32"), torch.no_grad():
        b = {k: torch.as_tensor(v, device=card) for k, v in batches[0].items()}
        ctx, summary = scst_context(state.params, b, MAX_LEN)
        toks = [greedy_decode(state.params.decoder, ctx, summary, MAX_LEN, fused=f)
                for f in (True, False)]
    assert agreement(*toks) >= AGREE_MIN
