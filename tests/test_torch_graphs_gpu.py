"""The decode loops as replayed CUDA graphs (`infer/graphs.py`) against
their eager loops, on the card.

Marked `gpu`: every test skips without a CUDA device. For each graphed
path (greedy, its `lanes` opt-in and `vocab_q`; beam on each tail, with
`return_all` and the length penalty, with `vocab_q`; diverse beam; an
ensemble's beam and greedy; the POS rollout; the controllability study's
free and controlled call), under the f32 and the bf16 policy, through
the kernels: the graphed tokens equal the eager loop's
exactly and scores are within rtol 1e-6 (the same kernels on the same
operands: only the launch mechanism differs), on the capturing call and
on a replay; a call on other inputs equals eager (the static buffers are
refreshed); after an in-place update of every parameter graphed equals
eager on the new weights (the kernels' weight operands are made again on
every call); a parameter swapped for a new tensor makes a new key; a
call counts the kernel launches the eager call counts. A capture that
fails raises and caches nothing. This file imports no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graphs_gpu.py
"""

import pytest
import torch

from controllable_xgating_torch.ops import kernels
from controllable_xgating_torch.ops.precision import precision

pytestmark = pytest.mark.gpu
MAX_LEN, MAX_POS = 10, 9  # 4 divides neither: a short last chunk


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels build with nvcc for sm_90a)")
    from controllable_xgating_torch.infer import graphs

    graphs.clear()
    kernels.reset_launch_counts()
    return torch.device("cuda:0")


def model(dev, seed=3, **over):
    """A small captioner on the card whose captions end at mixed steps
    (EOS favoured), so that the early exit is exercised."""
    from controllable_xgating_torch.data.vocab import EOS
    from controllable_xgating_torch.models.captioner import init_captioner
    from controllable_xgating_torch.utils.config import Config

    cfg = Config().replace_flat({
        "model.app_dim": 40, "model.motion_dim": 24, "model.hidden_dim": 64,
        "model.embed_dim": 32, "model.attn_dim": 48, "model.pos_embed_dim": 32,
        "model.vocab_size": 500, "model.pos_vocab_size": 20, "model.num_frames": 6, **over,
    })
    p = init_captioner(cfg, seed=seed, device=dev).requires_grad_(False)
    p.decoder.b_out[EOS] += 2.0
    p.pos.b_out[EOS] += 2.0
    return p


def inputs(dev, seed=4):
    gd = torch.Generator(device=dev).manual_seed(seed)
    app = torch.randn(8, 6, 40, generator=gd, device=dev)
    mot = torch.randn(8, 6, 24, generator=gd, device=dev)
    mask = (torch.arange(6, device=dev)[None, :] < torch.tensor(
        [6, 6, 5, 4, 6, 3, 6, 2], device=dev)[:, None]).float()
    return app, mot, mask


def contexts(members, x):
    """Each member's (ctx, summary), encoded through the kernels with the
    eager POS rollout (which the "pos" path holds against its graphs)."""
    from controllable_xgating_torch.models.captioner import encode_for_inference
    from controllable_xgating_torch.ops.dispatch import decode_graphs_setting, set_decode_graphs

    prev = decode_graphs_setting()
    set_decode_graphs(False)
    try:
        with torch.inference_mode():
            return [encode_for_inference(p, *x, max_pos_len=MAX_POS, fused=True,
                                         early_stop=True)[:2] for p in members]
    finally:
        set_decode_graphs(prev)


def quantized(p):
    from controllable_xgating_torch.experiments.int8_vocab_matmul import quantize_vocab_proj

    return quantize_vocab_proj(p.decoder.w_out, p.decoder.b_out)


def call(path: str, members, x, g, vq=None, early_stop=True):
    """One graphed (`g=True`) or eager (`g=False`) call of `path` on
    members' encodings of x: a tuple of output tensors."""
    from controllable_xgating_torch.infer.beam import beam_search
    from controllable_xgating_torch.infer.ensemble import ensemble_greedy_decode
    from controllable_xgating_torch.infer.greedy import greedy_decode
    from controllable_xgating_torch.models.pos_generator import pos_greedy_generate

    enc = contexts(members, x)
    (ctx, s), p = enc[0], members[0]
    beam = lambda k, **kw: beam_search(p.decoder, ctx, s, k, MAX_LEN, fused=True,
                                       early_stop=early_stop, graphs=g, **kw)
    with torch.inference_mode():
        out = {
            "greedy": lambda: greedy_decode(p.decoder, ctx, s, MAX_LEN, fused=True,
                                            early_stop=early_stop, graphs=g),
            "greedy-lanes": lambda: greedy_decode(p.decoder, ctx, s, MAX_LEN, fused=True,
                                                  early_stop=early_stop, lanes=True, graphs=g),
            "greedy-int8": lambda: greedy_decode(p.decoder, ctx, s, MAX_LEN, fused=True,
                                                 early_stop=early_stop, vocab_q=vq, graphs=g),
            "beam-lanes": lambda: beam(5, topk_mode="lanes"),
            "beam-grouped": lambda: beam(5, topk_mode="grouped"),
            "beam-block": lambda: beam(5, topk_mode="block"),
            "beam-flat": lambda: beam(5, topk_mode="flat"),
            "beam-return_all": lambda: beam(5, return_all=True, length_penalty=1.0),
            "beam-int8": lambda: beam(5, vocab_q=vq),
            "beam-diverse": lambda: beam(6, diversity_groups=3, return_all=True),
            "ensemble-beam": lambda: beam_search(
                tuple(m.decoder for m in members), tuple(e[0] for e in enc),
                tuple(e[1] for e in enc), 4, MAX_LEN, fused=True, early_stop=early_stop,
                return_all=True, n_members=len(members), graphs=g),
            "ensemble-greedy": lambda: ensemble_greedy_decode(
                tuple(m.decoder for m in members), tuple(e[0] for e in enc),
                tuple(e[1] for e in enc), MAX_LEN, early_stop=early_stop, fused=True,
                graphs=g),
            "pos": lambda: pos_greedy_generate(p.pos, s, MAX_POS, early_stop=early_stop,
                                               fused=True, graphs=g),
        }[path]()
    torch.cuda.synchronize()
    return out if isinstance(out, tuple) else (out,)


def graphed(fn):
    """fn() under a span collector: its output and, summed over the kinds
    of loop it ran, whether a key was captured, the chunks replayed and
    the chunks the calls had."""
    from controllable_xgating_torch.utils import spans

    with spans.collect() as col:
        out = fn()
    counters = col.summary()["counters"]
    total = lambda what: sum(v for k, v in counters.items() if k.startswith(f"graphs.{what}."))
    return out, {"captured": total("captures") > 0, "chunks": total("replays"),
                 "of": total("chunks_of")}


def same(got, want):
    """Token outputs equal, float outputs (scores, psi) within rtol 1e-6."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if a.dtype.is_floating_point:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=0.0)
        else:
            assert torch.equal(a, b)


PATHS = ["greedy", "greedy-lanes", "greedy-int8", "beam-lanes", "beam-grouped", "beam-block",
         "beam-flat", "beam-return_all", "beam-int8", "beam-diverse", "ensemble-beam",
         "ensemble-greedy", "pos"]


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", PATHS)
def test_graphed_equals_eager(dev, path, policy):
    from controllable_xgating_torch.infer import graphs

    other = {"model.hidden_dim": 48, "model.fusion": "concat"}  # another architecture
    members = [model(dev)] + ([model(dev, seed=5, **other)] if path.startswith("ensemble")
                              else [])
    vq = quantized(members[0]) if path.endswith("int8") else None
    x, y = inputs(dev), inputs(dev, seed=9)
    n_steps = MAX_POS if path == "pos" else MAX_LEN
    with precision(policy):
        want = call(path, members, x, False, vq)
        for replay in (False, True):  # the capturing call, then a replay
            kernels.reset_launch_counts()
            got, last = graphed(lambda: call(path, members, x, True, vq))
            same(got, want)
            assert last["captured"] is not replay
            # early stop: the chunks replayed, up to two past the one that finished
            assert last["chunks"] <= last["of"] == -(-n_steps // 4)
            if path != "pos":
                assert kernels.launch_counts()["attn_lstm"] == \
                    len(members) * min(n_steps, 4 * last["chunks"])
        # every step run: a call counts the launches the eager call counts
        outs, counts = [], []
        for g in (False, True):
            kernels.reset_launch_counts()
            outs.append(call(path, members, x, g, vq, early_stop=False))
            counts.append(kernels.launch_counts())
        same(outs[1], outs[0])
        same(outs[0], want)
        assert counts[1] == counts[0] and counts[0]["attn_lstm" if path != "pos" else "pos_lstm"]
        # other inputs: the static buffers are refreshed
        got, last = graphed(lambda: call(path, members, y, True, vq))
        same(got, call(path, members, y, False, vq))
        assert not last["captured"]
        # every parameter updated in place: the key holds, the operands are made again
        with torch.no_grad():
            for m in members:
                for q in m.parameters():
                    q.mul_(1.05).add_(0.01)
        got, last = graphed(lambda: call(path, members, x, True, vq))
        same(got, call(path, members, x, False, vq))
        assert not last["captured"]
        # a parameter swapped for a new tensor: a new key, the right result
        for m in members:
            m.decoder.w_out = torch.nn.Parameter(m.decoder.w_out.detach() * 0.9,
                                                 requires_grad=False)
            m.pos.w_out = torch.nn.Parameter(m.pos.w_out.detach() * 0.9, requires_grad=False)
        n = len(graphs.cache_info())
        got, last = graphed(lambda: call(path, members, x, True, vq))
        assert last["captured"] and len(graphs.cache_info()) == n + 1
        same(got, call(path, members, x, False, vq))


def test_graphs_follow_the_switch_and_the_lru(dev):
    """Auto takes graphs on the card; set_decode_graphs(False) the eager
    loop; keys beyond 16 evict the oldest."""
    from controllable_xgating_torch.infer import graphs
    from controllable_xgating_torch.ops.dispatch import set_decode_graphs

    p = model(dev)
    x = inputs(dev)
    _, last = graphed(lambda: call("greedy", [p], x, None))
    assert last["captured"] and len(graphs.cache_info()) == 1
    try:
        set_decode_graphs(False)
        _, last = graphed(lambda: call("greedy", [p], x, None))
    finally:
        set_decode_graphs(None)
    assert last == {"captured": False, "chunks": 0, "of": 0}
    for n in [n for n in range(1, 19) if n != 8]:  # 17 more batch sizes: 18 keys, 16 kept
        call("greedy", [p], tuple(t.repeat(3, 1)[:n] if t.dim() == 2 else t.repeat(3, 1, 1)[:n]
                                  for t in x), True)
    info = graphs.cache_info()
    assert len(info) == graphs.MAX_KEYS and all(e["pool_bytes"] >= 0 for e in info)


def test_a_failed_capture_raises_and_caches_nothing(dev, monkeypatch):
    from controllable_xgating_torch.infer import graphs

    p = model(dev)
    x = inputs(dev)
    want = call("beam-lanes", [p], x, False)
    kernels.reset_launch_counts()
    contexts([p], x)
    encoding = kernels.launch_counts()  # K1 and the eager POS rollout's K2
    kernels.reset_launch_counts()

    real = graphs._steps

    def failing(loop, carry, span):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("injected capture failure")
        return real(loop, carry, span)

    monkeypatch.setattr(graphs, "_steps", failing)
    with pytest.raises(RuntimeError, match="injected capture failure"):
        call("beam-lanes", [p], x, True)
    assert graphs.cache_info() == []
    # the warm-up's launches were taken back
    assert kernels.launch_counts() == encoding and encoding["attn_lstm"] == 0
    monkeypatch.undo()
    same(call("beam-lanes", [p], x, True), want)


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
def test_controllability_study_graphed_equals_eager(dev, policy):
    """The study's device call (`tools/controllability_eval.py`), free and
    under a template, replayed as graphs against the eager loops: tokens
    equal; a free-run call launches K1, K2 and K3, a controlled one K1 and
    K3 and no POS step."""
    from types import SimpleNamespace

    from controllable_xgating_torch.ops.dispatch import decode_graphs_setting, set_decode_graphs
    from controllable_xgating_torch.tools.controllability_eval import make_study_decoder

    cfg = SimpleNamespace(model=SimpleNamespace(max_pos_len=MAX_POS),
                          eval=SimpleNamespace(max_decode_len=MAX_LEN))
    run = make_study_decoder(model(dev), cfg)
    app, mot, _ = inputs(dev)
    gd = torch.Generator(device=dev).manual_seed(7)
    tmpl = torch.randint(4, 20, (8, MAX_POS), generator=gd, device=dev)
    tmpl[:, 6:] = 0  # PAD after six tags
    prev = decode_graphs_setting()
    try:
        with precision(policy):
            outs = {}
            for graphed in (False, True, True):  # eager, then capture and replay
                set_decode_graphs(None if graphed else False)
                for name, tags in (("free", None), ("controlled", tmpl)):
                    kernels.reset_launch_counts()
                    tokens = run(app, mot, tags)
                    torch.cuda.synchronize()
                    got = kernels.launch_counts()
                    assert got["xgate"] and got["attn_lstm"], got
                    assert bool(got["pos_lstm"]) == (name == "free"), got
                    assert tokens.shape == (8, MAX_LEN)
                    if (name, False) in outs:
                        assert torch.equal(tokens, outs[name, False]), (name, graphed)
                    outs[name, graphed] = tokens
    finally:
        set_decode_graphs(prev)
