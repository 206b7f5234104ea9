"""The port's ensemble decoding (`infer/ensemble.py`, `beam_search`'s
`n_members`) vs the JAX package's stacked and cross-architecture paths, on
the CPU.

Three members from seeded numpy draws carried to both packages by the
weight bridge: two of one architecture and one of another (concat fusion,
no psi guidance, other widths), at the widths of
`tests/test_ensemble_hetero.py`. Tokens and POS tags must be equal, scores
within rtol 1e-5 / atol 1e-6; a `[p, p]` ensemble must give the port's own
single model's tokens exactly and its scores within rtol 1e-6.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_xgating_tpu.infer import ensemble as j_ens
from controllable_xgating_tpu.infer import evaluator as j_eval
from controllable_xgating_tpu.utils.config import Config
from controllable_xgating_torch.data.vocab import EOS
from controllable_xgating_torch.infer import beam as t_beam
from controllable_xgating_torch.infer import ensemble as t_ens
from controllable_xgating_torch.infer import evaluator as t_eval
from controllable_xgating_torch.models.captioner import encode_for_inference
from test_torch_quant import numpy_params

torch.set_num_threads(1)
MAX_LEN, MAX_POS = 9, 6
BASE = {
    "model.app_dim": 10, "model.motion_dim": 8, "model.hidden_dim": 12, "model.embed_dim": 8,
    "model.attn_dim": 10, "model.pos_embed_dim": 10, "model.vocab_size": 40,
    "model.pos_vocab_size": 12, "model.num_frames": 4,
}
# another architecture on the same vocab: concat fusion, no psi, other widths
ALT = {**BASE, "model.fusion": "concat", "model.pos_guidance": False, "model.hidden_dim": 10,
       "model.embed_dim": 10, "model.attn_dim": 8}
SCORE_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def m():
    cfg, alt = Config().replace_flat(BASE), Config().replace_flat(ALT)
    j0, t0 = numpy_params(cfg, 40)
    j1, t1 = numpy_params(cfg, 41)
    ja, ta = numpy_params(alt, 42)
    rng = np.random.default_rng(43)
    app = rng.standard_normal((4, 4, 10)).astype(np.float32)
    mot = rng.standard_normal((4, 4, 8)).astype(np.float32)
    mask = np.array([[1, 1, 1, 1], [1, 1, 1, 0], [1, 1, 0, 0], [1, 1, 1, 1]], np.float32)
    tags = rng.integers(4, 12, (4, MAX_POS)).astype(np.int32)
    tags[:, 4] = 2  # EOS
    tags[:, 5] = 0
    return SimpleNamespace(
        cfg=cfg, alt=alt, j=(j0, j1, ja), t=(t0, t1, ta), j_in=(app, mot, mask),
        t_in=tuple(map(torch.from_numpy, (app, mot, mask))), tags=tags,
    )


def assert_same(tout, jout, score_tol=SCORE_TOL):
    """Caption-function outputs: tokens and tags equal, scores close."""
    assert len(tout) == len(jout)
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    np.testing.assert_array_equal(tout[-1].numpy(), np.asarray(jout[-1]))
    if len(tout) == 3:
        np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]), **score_tol)


# --- stack_params and combine_logp ---


def test_stack_params_returns_the_members(m):
    t0, t1, _ = m.t
    assert t_ens.stack_params([t0, t1]) == (t0, t1)


@pytest.mark.parametrize("which,match", [
    ("one", "at least two"),
    ("architecture", "differ in architecture"),
    ("shapes", "differ in parameter shapes"),
])
def test_stack_params_refusals(m, which, match):
    """Both packages refuse one member, members of two architectures, and
    members of one architecture at other widths."""
    wide = numpy_params(Config().replace_flat({**BASE, "model.hidden_dim": 14}), 44)
    pick = {"one": [0], "architecture": [0, 2], "shapes": [0, "wide"]}[which]
    for pkg, members in ((t_ens, m.t), (j_ens, m.j)):
        side = 0 if pkg is j_ens else 1
        with pytest.raises(ValueError, match=match):
            pkg.stack_params([wide[side] if i == "wide" else members[i] for i in pick])


@pytest.mark.parametrize("block_unk", [False, True])
def test_combine_logp_matches_jax(block_unk):
    rng = np.random.default_rng(45)
    logits = (rng.standard_normal((3, 5, 40)) * 4).astype(np.float32)
    want = np.asarray(j_ens.combine_logp(jnp.asarray(logits), block_unk))
    got = t_ens.combine_logp(torch.from_numpy(logits), block_unk)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    # a sequence of members is the same as the stacked tensor
    assert torch.equal(t_ens.combine_logp(list(torch.from_numpy(logits)), block_unk), got)


# --- [p, p]: the single model exactly ---


@pytest.mark.parametrize("early_stop,block_unk", [(False, False), (True, False), (False, True),
                                                  (True, True)])
def test_identity_greedy(m, early_stop, block_unk):
    t0 = m.t[0]
    single = t_eval.make_greedy_caption_fn(MAX_POS, MAX_LEN, early_stop=early_stop,
                                           block_unk=block_unk)(t0, *m.t_in)
    ens = t_ens.make_ensemble_caption_fn(1, MAX_POS, MAX_LEN, early_stop=early_stop,
                                         block_unk=block_unk)((t0, t0), *m.t_in)
    assert torch.equal(ens[0], single[0]) and torch.equal(ens[1], single[1])
    assert (single[0] == EOS).any()


@pytest.mark.parametrize("kw", [{}, {"return_all": True, "length_penalty": 1.0},
                                {"block_unk": True, "early_stop": False}],
                         ids=["best", "return_all_lp", "block_unk"])
def test_identity_beam(m, kw):
    t0 = m.t[0]
    single = t_beam.make_beam_caption_fn(4, MAX_POS, MAX_LEN, topk_mode="grouped", **kw)(
        t0, *m.t_in)
    ens = t_ens.make_ensemble_caption_fn(4, MAX_POS, MAX_LEN, **kw)((t0, t0), *m.t_in)
    assert torch.equal(ens[0], single[0]) and torch.equal(ens[-1], single[-1])
    if kw.get("return_all"):
        np.testing.assert_allclose(ens[1].numpy(), single[1].numpy(), rtol=1e-6, atol=0)


# --- two members against the JAX package ---


@pytest.mark.parametrize("beam,kw", [
    (1, {}),
    (1, {"early_stop": False, "block_unk": True}),
    (4, {}),
    (4, {"return_all": True, "length_penalty": 0.8}),
], ids=["greedy", "greedy_block_unk", "beam4", "beam4_return_all"])
def test_same_architecture_matches_jax_stacked(m, beam, kw):
    j0, j1, _ = m.j
    jout = j_ens.make_ensemble_caption_fn(beam, MAX_POS, MAX_LEN, **kw)(
        j_ens.stack_params([j0, j1]), *m.j_in)
    tout = t_ens.make_ensemble_caption_fn(beam, MAX_POS, MAX_LEN, **kw)(m.t[:2], *m.t_in)
    assert_same(tout, jout)


@pytest.mark.parametrize("beam,kw", [
    (1, {}),
    (1, {"early_stop": False}),
    (4, {}),
    (4, {"return_all": True}),
], ids=["greedy", "greedy_scan", "beam4", "beam4_return_all"])
def test_cross_architecture_matches_jax_hetero(m, beam, kw):
    j0, _, ja = m.j
    jout = j_ens.make_hetero_ensemble_caption_fn(beam, MAX_POS, MAX_LEN, **kw)(
        (j0, ja), *m.j_in)
    tout = t_ens.make_hetero_ensemble_caption_fn(beam, MAX_POS, MAX_LEN, **kw)(
        (m.t[0], m.t[2]), *m.t_in)
    assert_same(tout, jout)


def test_hetero_of_one_architecture_equals_stacked(m):
    """JAX's tuple path and its stacked path on the same two members, and
    the port's one path: all three the same n-best."""
    j0, j1, _ = m.j
    kw = dict(return_all=True)
    stacked = j_ens.make_ensemble_caption_fn(3, MAX_POS, MAX_LEN, **kw)(
        j_ens.stack_params([j0, j1]), *m.j_in)
    hetero = j_ens.make_hetero_ensemble_caption_fn(3, MAX_POS, MAX_LEN, **kw)((j0, j1), *m.j_in)
    port = t_ens.make_hetero_ensemble_caption_fn(3, MAX_POS, MAX_LEN, **kw)(m.t[:2], *m.t_in)
    assert_same(port, stacked)
    assert_same(port, hetero)


def test_three_members_match_jax_hetero(m):
    jout = j_ens.make_hetero_ensemble_caption_fn(3, MAX_POS, MAX_LEN, return_all=True)(
        m.j, *m.j_in)
    tout = t_ens.make_ensemble_caption_fn(3, MAX_POS, MAX_LEN, return_all=True)(m.t, *m.t_in)
    assert_same(tout, jout)


@pytest.mark.parametrize("beam", [1, 4])
def test_controlled_ensemble_matches_jax(m, beam):
    """Every member guided by the same user tags; the tags come back."""
    j0, j1, _ = m.j
    jout = j_ens.make_ensemble_caption_fn(beam, MAX_POS, MAX_LEN)(
        j_ens.stack_params([j0, j1]), *m.j_in, jnp.asarray(m.tags))
    tout = t_ens.make_ensemble_caption_fn(beam, MAX_POS, MAX_LEN)(
        m.t[:2], *m.t_in, torch.from_numpy(m.tags).long())
    assert_same(tout, jout)
    np.testing.assert_array_equal(tout[-1].numpy(), m.tags)


def test_members_of_another_vocab_are_refused(m):
    t0 = m.t[0]
    _, other = numpy_params(Config().replace_flat({**BASE, "model.vocab_size": 41}), 46)
    encs = [encode_for_inference(p, *m.t_in, max_pos_len=MAX_POS) for p in (t0, other)]
    with pytest.raises(ValueError, match="disagree on vocab"):
        t_beam.beam_search((t0.decoder, other.decoder), tuple(e[0] for e in encs),
                           tuple(e[1] for e in encs), 3, MAX_LEN, n_members=2)
    with pytest.raises(ValueError, match="n_members=3"):
        t_beam.beam_search((t0.decoder, t0.decoder), (encs[0][0],) * 2, (encs[0][1],) * 2, 3,
                           MAX_LEN, n_members=3)


def test_ensemble_refuses_lanes_and_vocab_q(m):
    t0 = m.t[0]
    ctx, summary, _ = encode_for_inference(t0, *m.t_in, max_pos_len=MAX_POS)
    args = ((t0.decoder,) * 2, (ctx,) * 2, (summary,) * 2, 3, MAX_LEN)
    with pytest.raises(ValueError, match="does not support ensembles"):
        t_beam.beam_search(*args, n_members=2, topk_mode="lanes")
    with pytest.raises(ValueError, match="vocab_q is not supported"):
        t_beam.beam_search(*args, n_members=2, vocab_q=object())
    with pytest.raises(ValueError, match="return_all requires"):
        t_ens.make_ensemble_caption_fn(1, MAX_POS, MAX_LEN, return_all=True)


@pytest.mark.parametrize("members", [(0, 1), (0, 2)], ids=["same_arch", "cross_arch"])
def test_auto_dispatch_matches_jax(m, members):
    """`make_auto_ensemble_caption_fn` on what `restore_ensemble_params`
    returns: the JAX package picks its stacked or its tuple path; the port
    runs its one path, with the same captions."""
    jp = tuple(m.j[i] for i in members)
    if members == (0, 1):
        jp = j_ens.stack_params(list(jp))
    tp = tuple(m.t[i] for i in members)
    jout = j_ens.make_auto_ensemble_caption_fn(jp, 4, MAX_POS, MAX_LEN, return_all=True)(
        jp, *m.j_in)
    tout = t_ens.make_auto_ensemble_caption_fn(tp, 4, MAX_POS, MAX_LEN, return_all=True)(
        tp, *m.t_in)
    assert_same(tout, jout)


# --- evaluate_split on an ensemble ---


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from controllable_xgating_tpu.data.corpus import load_labels
    from controllable_xgating_tpu.data.features import FeatureStore
    from controllable_xgating_tpu.data.fixtures import make_fixture_corpus

    out = str(tmp_path_factory.mktemp("ens_corpus"))
    info = make_fixture_corpus(
        out, num_videos=14, num_frames=5, app_dim=12, motion_dim=10, caps_per_video=3,
        seqs_per_video=4, max_caption_len=10, seed=5,
    )
    cfg = Config().replace_flat({
        "model.app_dim": 12, "model.motion_dim": 10, "model.hidden_dim": 16,
        "model.embed_dim": 12, "model.attn_dim": 12, "model.pos_embed_dim": 12,
        "model.vocab_size": len(info.vocab), "model.pos_vocab_size": len(info.pos_vocab),
        "model.num_frames": 5,
    })
    pairs = [numpy_params(cfg, s, eos_bias=2.0) for s in (47, 48)]
    return (info, load_labels(out), FeatureStore(out + "/features.h5", num_frames=5),
            tuple(p[0] for p in pairs), tuple(p[1] for p in pairs))


@pytest.mark.parametrize("beam", [1, 3], ids=["greedy", "beam3"])
def test_evaluate_split_on_an_ensemble_matches_jax(corpus, beam):
    info, labels, store, jps, tps = corpus
    kw = dict(split="val", batch_size=3, max_len=10, max_pos_len=10)  # padded last batch
    jm, jc = j_eval.evaluate_split(
        j_ens.stack_params(list(jps)), store, labels, info,
        caption_fn=j_ens.make_ensemble_caption_fn(beam, 10, 10), **kw)
    tm, tc = t_eval.evaluate_split(
        tps, store, labels, info, caption_fn=t_ens.make_ensemble_caption_fn(beam, 10, 10), **kw)
    assert tc == jc
    assert set(tm) == set(jm) >= {"Bleu_4", "METEOR", "ROUGE_L", "CIDEr", "CIDErD"}
    for k in jm:
        assert tm[k] == pytest.approx(jm[k], rel=1e-12, abs=1e-12), k


def test_evaluate_split_nbest_on_an_ensemble(corpus):
    """The n-best evaluation takes an ensemble's tuple too; its rank-0
    captions are `evaluate_split`'s beam captions."""
    info, labels, store, _, tps = corpus
    fn = t_ens.make_ensemble_caption_fn(3, 10, 10, return_all=True)
    best, oracle, lists = t_eval.evaluate_split_nbest(tps, store, labels, info, fn, 3,
                                                      split="val", batch_size=4)
    _, caps = t_eval.evaluate_split(tps, store, labels, info, split="val", batch_size=4,
                                    caption_fn=t_ens.make_ensemble_caption_fn(3, 10, 10))
    assert {v: l[0][0] for v, l in lists.items()} == caps
    assert oracle["CIDErD"] >= best["CIDErD"]
