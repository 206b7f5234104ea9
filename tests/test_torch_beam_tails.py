"""Beam's `flat` and `block` candidate tails, `row_topk_block`, beam's
route past the lanes tail's k limit, and the logits top-k by iterative
extraction (K6), the port vs the JAX package on the CPU in f32.

Tokens must equal the JAX package's; scores, values and logsumexps are
held at rtol 1e-5. Inputs are numpy draws handed to both packages.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_xgating_tpu.data.vocab import BOS, EOS, PAD
from controllable_xgating_tpu.infer import beam as j_beam
from controllable_xgating_torch.experiments.logits_topk import logits_topk_extract
from controllable_xgating_torch.infer import beam as t_beam
from controllable_xgating_torch.ops import kernels
from controllable_xgating_torch.ops.kernels.topk_extract import logits_topk_extract_kernel
from controllable_xgating_torch.ops.kernels.topk_tail import NEG
from experiments.pallas_logits_topk import logits_topk_pallas
from test_torch_quant import make_cfg, numpy_params

torch.set_num_threads(1)
T = torch.from_numpy
MAX_LEN, MAX_POS = 9, 8


def planted(r=4, v=3000, seed=0):
    """[r, v] rows with ties planted across 128-wide blocks and in the
    ragged last block (3000 = 23 x 128 + 56), including ties at the k-th
    place that a kept lower block must win."""
    x = np.random.default_rng(seed).normal(size=(r, v)).astype(np.float32)
    x[0, [5, 300, 2999, 1000, 2950]] = 10.0            # five-way tie, two in the last block
    x[1, [130, 131, 2900, 2998]] = 9.0                  # tie at the k-th place
    x[1, [7, 700, 1900]] = 9.5
    x[2, 2944:] = 8.0                                   # the whole ragged block ties,
    x[2, 2900] = 8.5                                    # and its clamped window overlaps a kept block
    x[3, :] = 1.0                                       # one value everywhere
    x[3, [2000, 2500]] = 2.0
    return x


@pytest.mark.parametrize("v,k", [(3000, 5), (3000, 1), (2561, 5), (640, 5), (2560, 5)],
                         ids=["v3000_k5", "v3000_k1", "just_over", "small", "at_cutoff"])
def test_row_topk_block_equals_lax_top_k(v, k):
    """Exact, tie order included, against lax.top_k and the JAX
    row_topk_block; v <= 4 * k * 128 takes the plain top-k."""
    x = planted(v=v) if v == 3000 else np.random.default_rng(v).normal(size=(5, v)).astype(np.float32)
    if v != 3000:
        x[:, [1, v // 2, v - 1]] = 5.0
    rv, ri = jax.lax.top_k(jnp.asarray(x), k)
    bv, bi = j_beam.row_topk_block(jnp.asarray(x), k)
    tv, ti = t_beam.row_topk_block(T(x), k)
    for want_v, want_i in ((rv, ri), (bv, bi)):
        np.testing.assert_array_equal(tv.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(want_i))
    if v == 3000 and k == 5:
        assert ti[0].tolist() == [5, 300, 1000, 2950, 2999]
        assert ti[2].tolist() == [2900, 2944, 2945, 2946, 2947]
        assert ti[3].tolist() == [2000, 2500, 0, 1, 2]


@pytest.fixture(scope="module", params=[40, 3000], ids=["vocab40", "vocab3000"])
def setup(request):
    cfg = make_cfg(request.param)
    jp, tp = numpy_params(cfg, 31)
    rng = np.random.default_rng(32)
    app = rng.standard_normal((3, 5, 12)).astype(np.float32)
    mot = rng.standard_normal((3, 5, 10)).astype(np.float32)
    mask = np.array([[1, 1, 1, 1, 1], [1, 1, 1, 0, 0], [1, 1, 0, 0, 0]], np.float32)
    return jp, tp, (app, mot, mask), tuple(map(T, (app, mot, mask)))


@pytest.mark.parametrize("mode", ["flat", "block"])
@pytest.mark.parametrize("kw", [
    {}, {"return_all": True}, {"length_penalty": 1.0, "return_all": True},
    {"block_unk": True, "early_stop": False},
], ids=["default", "return_all", "length_penalty", "block_unk"])
def test_beam_tail_matches_jax(setup, mode, kw):
    jp, tp, j_in, t_in = setup
    jout = j_beam.make_beam_caption_fn(5, MAX_POS, MAX_LEN, topk_mode=mode, **kw)(jp, *j_in)
    tout = t_beam.make_beam_caption_fn(5, MAX_POS, MAX_LEN, topk_mode=mode, **kw)(tp, *t_in)
    assert len(jout) == len(tout)
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    np.testing.assert_array_equal(tout[-1].numpy(), np.asarray(jout[-1]))
    if kw.get("return_all"):
        np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]), rtol=1e-5, atol=1e-6)


def test_beam_tails_agree(setup):
    """grouped, flat and block: the same tokens and scores on the plain
    path, and no top-K kernel wrapper called."""
    _, tp, _, t_in = setup
    kernels.reset_launch_counts()
    outs = [t_beam.make_beam_caption_fn(5, MAX_POS, MAX_LEN, fused=False, topk_mode=m,
                                        return_all=True)(tp, *t_in)
            for m in ("grouped", "flat", "block")]
    for other in outs[1:]:
        assert torch.equal(other[0], outs[0][0]) and torch.equal(other[2], outs[0][2])
        torch.testing.assert_close(other[1], outs[0][1], rtol=1e-6, atol=0.0)
    assert kernels.launch_counts() == {n: 0 for n in kernels.WRAPPERS}


_JAX_GROUPED: dict = {}


@pytest.mark.parametrize("mode", ["auto", "lanes"])
@pytest.mark.parametrize("beam_size", [9, 10, 16])
def test_beam_routes_past_the_lanes_limit(setup, monkeypatch, beam_size, mode):
    """A beam wider than the top-K kernel's MAX_K takes the grouped tail, on
    auto and on an explicit "lanes", decided from the shape: with a
    stand-in for the kernel wrapper that refuses k > MAX_K as the card
    does, `beam_search(fused=True)` never calls it and gives the grouped
    tail's tokens and scores, and the JAX package's grouped beam's."""
    from controllable_xgating_torch.ops.kernels.topk_tail import MAX_K

    jp, tp, j_in, t_in = setup
    calls, real = [], t_beam.logits_topk

    def card_like(h, w_out, b_out, k, *args, **kwargs):
        calls.append(k)
        if k > MAX_K:
            raise ValueError(f"topk_tail kernel takes 1 <= k <= {MAX_K}, got {k}")
        return real(h, w_out, b_out, k, *args, **kwargs)

    monkeypatch.setattr(t_beam, "logits_topk", card_like)
    run = lambda m: t_beam.make_beam_caption_fn(beam_size, MAX_POS, MAX_LEN, fused=True,
                                                topk_mode=m, return_all=True)(tp, *t_in)
    got, grouped = run(mode), run("grouped")
    assert calls == []
    for a, b in zip(got, grouped):
        assert torch.equal(a, b)
    key = (tp.decoder.w_out.shape[1], beam_size)
    if key not in _JAX_GROUPED:
        _JAX_GROUPED[key] = j_beam.make_beam_caption_fn(
            beam_size, MAX_POS, MAX_LEN, topk_mode="grouped", return_all=True)(jp, *j_in)
    jout = _JAX_GROUPED[key]
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jout[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(jout[2]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(jout[1]), rtol=1e-5, atol=1e-6)


def _jax_reference(h, w, b, k):
    logits = (h @ w + b).at[:, PAD].set(-1e30).at[:, BOS].set(-1e30)
    rv, ri = jax.lax.top_k(logits, k)
    return rv, ri, jax.nn.logsumexp(logits, axis=1)


def test_logits_topk_extract_matches_pallas_kernel():
    """K6's plain version and wrapper against the JAX Pallas kernel in
    interpret mode and against lax.top_k, at the JAX test's shapes."""
    key = jax.random.PRNGKey(9)
    r, hd, v, k = 6, 12, 40, 5
    h = np.array(jax.random.normal(key, (r, hd)))
    w = np.array(jax.random.normal(jax.random.fold_in(key, 1), (hd, v)))
    b = np.array(jax.random.normal(jax.random.fold_in(key, 2), (v,)))
    pv, pi, pl = logits_topk_pallas(jnp.asarray(h), jnp.asarray(w), jnp.asarray(b), k,
                                    interpret=True)
    rv, ri, rl = _jax_reference(jnp.asarray(h), jnp.asarray(w), jnp.asarray(b), k)
    np.testing.assert_array_equal(np.asarray(pi), np.asarray(ri))
    kernels.reset_launch_counts()
    for fused in (True, False):
        vals, idx, lse = logits_topk_extract(T(h), T(w), T(b), k, fused=fused)
        assert idx.dtype == torch.int64 and vals.shape == (r, k) and lse.shape == (r,)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(pi))
        np.testing.assert_allclose(vals.numpy(), np.asarray(pv), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(lse.numpy(), np.asarray(pl), rtol=1e-5, atol=1e-5)
    assert kernels.launch_counts()["topk_extract"] == 0  # CPU tensors: the plain version


def test_logits_topk_extract_planted_ties():
    """Equal logits across the vocab: ids come out ascending as with
    lax.top_k, PAD and BOS never win, and the masked specials add nothing
    to the logsumexp."""
    r, hd, v, k = 3, 8, 3000, 5
    h = np.ones((r, hd), np.float32)
    w = np.zeros((hd, v), np.float32)
    b = np.zeros((v,), np.float32)
    b[[PAD, BOS, 7, 40, 1500, 2999]] = 1.0
    w[:, 2000] = 0.125  # 1.0 from the product: ties the planted biases
    rv, ri, rl = _jax_reference(jnp.asarray(h), jnp.asarray(w), jnp.asarray(b), k)
    vals, idx, lse = logits_topk_extract_kernel(T(h), T(w), T(b), k)
    assert idx.tolist() == [[7, 40, 1500, 2000, 2999]] * r
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    np.testing.assert_allclose(vals.numpy(), np.asarray(rv), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(rl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.log(5 * np.e + (v - 7)), rtol=1e-6)


def _forced_eos(tp, boost):
    """A copy of the port's weights with EOS's bias raised by `boost`."""
    p = copy.deepcopy(tp)
    with torch.no_grad():
        p.decoder.b_out[EOS] += boost
    return p


def _planted_step(v, k, seed=5):
    """One lanes step's inputs at t = 2 over 3 videos: video 0's rows 0 and
    1 live with equal cum and equal logits (every candidate of row 0 ties
    one of row 1's), and two tokens tied at every row's top; video 1's
    rows 0 and 1 finished; video 2 at its first step (row 0 live, the rest
    at -1e30). Returns (carry, logits [3k, V], h_new, c_new)."""
    b, hd, max_len, t = 3, 6, 5, 2
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(b * k, v, generator=g)
    logits[:, [7, 11]] = 4.0  # the top two of every row tie
    cum = -torch.rand(b, k, generator=g) * 3.0
    finished = torch.zeros(b, k, dtype=torch.bool)
    if k > 1:
        logits[1] = logits[0]
        cum[0, :2] = 0.0  # the video's best rows
        finished[1, :2] = True
    cum[2, 1:] = NEG
    hist = torch.randint(4, v, (b, k, max_len), generator=g)
    hist[:, :, t:] = PAD
    carry = dict(
        h=[torch.zeros(b * k, hd)], c=[torch.zeros(b * k, hd)],
        tok=hist[:, :, t - 1].clone(), cum=cum, finished=finished,
        lengths=torch.full((b, k), t, dtype=torch.long), hist=hist,
        reg_score=torch.tensor([NEG, -2.5, NEG]),
        reg_tokens=torch.randint(4, v, (b, max_len), generator=g),
    )
    return carry, logits, torch.randn(b * k, hd, generator=g), torch.randn(b * k, hd, generator=g)


LANES_CASES = [dict(kind="beam", k=k, lp=lp, eos=eos) for k in (1, 5, 8) for lp in (0.0, 0.6)
               for eos in (0.0, 4.0)] + [dict(kind="ties", k=k, lp=0.6, eos=0.0) for k in (1, 5, 8)]


@pytest.mark.parametrize("case", LANES_CASES, ids=[
    f"{c['kind']}_k{c['k']}_lp{c['lp']}" + ("_eos" if c["eos"] else "") for c in LANES_CASES])
def test_lanes_select_plain_equals_the_grouped_tail(setup, case):
    """The lanes step's plain version (`lanes_select_plain` on
    `logits_topk`'s candidates) against the grouped tail, which forms its
    candidates from the whole log-softmax and shares the merge and the
    reorder: tokens equal, scores within 1e-5. "beam": `beam_search` on
    seeded weights (EOS raised by 1, or by 5: captions that end at the
    first steps, so finished rows and the register are live), return_all;
    "ties": one step with planted ties (`_planted_step`), where the lower
    flat index wins: of two equal candidates the one of row 0."""
    from controllable_xgating_torch.infer.greedy import mask_special_tokens
    from controllable_xgating_torch.ops.kernels.topk_tail import (
        lanes_select_plain,
        logits_topk,
        merge_survivors,
        reorder_beams,
        topk,
    )

    _, tp, _, t_in = setup
    k, lp = case["k"], case["lp"]
    if case["kind"] == "beam":
        params = _forced_eos(tp, case["eos"])
        run = lambda m: t_beam.make_beam_caption_fn(
            k, MAX_POS, MAX_LEN, length_penalty=lp, fused=True, topk_mode=m, early_stop=False,
            return_all=True)(params, *t_in)
        got, want = run("lanes"), run("grouped")
        assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)
        return
    v = tp.decoder.w_out.shape[1]
    carry, logits, h_new, c_new = _planted_step(v, k)
    b, t = carry["cum"].shape[0], 2
    got = lanes_select_plain({**carry, "hist": carry["hist"].clone()}, t,
                             *logits_topk(logits, torch.eye(v), torch.zeros(v), k), h_new, c_new,
                             lp)
    fin_col = carry["finished"].reshape(b * k)[:, None]
    cont = torch.where(torch.arange(v) == PAD, 0.0, NEG)
    logp = torch.log_softmax(mask_special_tokens(logits), -1)
    cand = carry["cum"].reshape(b * k)[:, None] + torch.where(fin_col, cont, logp)
    want = reorder_beams(carry, t, *merge_survivors(*topk(cand, k), k), [h_new], [c_new], lp)
    for name in ("tok", "finished", "lengths", "hist", "reg_tokens", "h", "c"):
        a, w = (got[name], want[name]) if name not in ("h", "c") else (got[name][0], want[name][0])
        assert torch.equal(a, w), name
    for name in ("cum", "reg_score"):
        torch.testing.assert_close(got[name], want[name], rtol=1e-5, atol=1e-5)
    assert got["tok"][0, 0] == 7 and got["tok"][2, 0] == 7  # the lower of two tied ids
    if k > 1:
        # video 0's four best candidates tie in pairs: row 0's words 7 and
        # 11, then row 1's, in flat order
        assert torch.equal(got["h"][0][:4], h_new[[0, 0, 1, 1]])
        assert got["tok"][0, :4].tolist() == [7, 11, 7, 11]
