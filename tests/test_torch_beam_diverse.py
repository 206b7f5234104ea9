"""The port's diverse beam search (`beam_search(diversity_groups=...)`) vs
the JAX package's, on the CPU.

Seeded numpy weights carried to both packages by the weight bridge. G <= 1
must be the plain beam exactly; G > 1 must give JAX's tokens and, within
rtol 1e-5 / atol 1e-6, its raw scores. The Hamming histogram counts a
token once per live beam that chose it: the small-vocabulary cases below
make two beams of one group pick the same token, and a spy checks that
they did.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from controllable_xgating_tpu.infer import beam as j_beam
from controllable_xgating_tpu.infer import ensemble as j_ens
from controllable_xgating_tpu.utils.config import Config
from controllable_xgating_torch.data.vocab import PAD
from controllable_xgating_torch.infer import beam as t_beam
from controllable_xgating_torch.infer import ensemble as t_ens
from controllable_xgating_torch.infer.score import sequence_logprob
from controllable_xgating_torch.models.captioner import encode_for_inference
from test_torch_quant import numpy_params

torch.set_num_threads(1)
MAX_LEN, MAX_POS = 8, 6
SCORE_TOL = dict(rtol=1e-5, atol=1e-6)


def cfg_of(vocab: int) -> Config:
    return Config().replace_flat({
        "model.app_dim": 10, "model.motion_dim": 8, "model.hidden_dim": 12,
        "model.embed_dim": 8, "model.attn_dim": 10, "model.pos_embed_dim": 10,
        "model.vocab_size": vocab, "model.pos_vocab_size": 12, "model.num_frames": 4,
    })


@pytest.fixture(scope="module", params=[40, 12], ids=["vocab40", "vocab12"])
def m(request):
    """Vocab 12 (8 words) makes beams of one group collide on a token."""
    jp, tp = numpy_params(cfg_of(request.param), 50)
    rng = np.random.default_rng(51)
    app = rng.standard_normal((4, 4, 10)).astype(np.float32)
    mot = rng.standard_normal((4, 4, 8)).astype(np.float32)
    mask = np.array([[1, 1, 1, 1], [1, 1, 1, 0], [1, 1, 0, 0], [1, 1, 1, 1]], np.float32)
    t_in = tuple(map(torch.from_numpy, (app, mot, mask)))
    ctx, summary, _ = encode_for_inference(tp, *t_in, max_pos_len=MAX_POS)
    return SimpleNamespace(jp=jp, tp=tp, j_in=(app, mot, mask), t_in=t_in, ctx=ctx,
                           summary=summary, vocab=request.param)


@pytest.fixture
def collisions(monkeypatch):
    """Spy on the group selection: counts the steps where two live beams of
    one group (not the last) chose the same token."""
    seen = {"steps": 0}
    real = t_beam._diverse_select

    def spy(cand, finished, groups, penalty):
        scores, beams, toks = real(cand, finished, groups, penalty)
        kg = cand.shape[1] // groups
        live = ~torch.gather(finished, 1, beams)
        for j in range(groups - 1):
            for b in range(cand.shape[0]):
                t = toks[b, j * kg:(j + 1) * kg][live[b, j * kg:(j + 1) * kg]].tolist()
                seen["steps"] += len(t) != len(set(t))
        return scores, beams, toks

    monkeypatch.setattr(t_beam, "_diverse_select", spy)
    return seen


@pytest.mark.parametrize("groups", [0, 1])
@pytest.mark.parametrize("return_all", [False, True])
def test_one_group_is_the_plain_beam(m, groups, return_all):
    ref = t_beam.beam_search(m.tp.decoder, m.ctx, m.summary, 4, MAX_LEN, return_all=return_all)
    got = t_beam.beam_search(m.tp.decoder, m.ctx, m.summary, 4, MAX_LEN, return_all=return_all,
                             diversity_groups=groups, diversity_penalty=5.0)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_refusals(m):
    with pytest.raises(ValueError, match="must divide"):
        t_beam.beam_search(m.tp.decoder, m.ctx, m.summary, 5, MAX_LEN, diversity_groups=3)
    with pytest.raises(ValueError, match=">= 0"):
        t_beam.beam_search(m.tp.decoder, m.ctx, m.summary, 4, MAX_LEN, diversity_groups=2,
                           diversity_penalty=-1.0)


@pytest.mark.parametrize("beam,groups,kw", [
    (4, 2, {"return_all": True}),
    (4, 2, {}),
    (4, 2, {"return_all": True, "early_stop": False, "length_penalty": 1.0}),
    (6, 3, {"return_all": True, "block_unk": True}),
    (8, 2, {"return_all": True}),
], ids=["k4g2_all", "k4g2_best", "k4g2_scan_lp", "k6g3_block_unk", "k8g2_all"])
def test_diverse_beam_matches_jax(m, collisions, beam, groups, kw):
    div = dict(diversity_groups=groups, diversity_penalty=0.7)
    jout = j_beam.make_beam_caption_fn(beam, MAX_POS, MAX_LEN, **div, **kw)(m.jp, *m.j_in)
    tout = t_beam.make_beam_caption_fn(beam, MAX_POS, MAX_LEN, **div, **kw)(m.tp, *m.t_in)
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    np.testing.assert_array_equal(tout[-1].numpy(), np.asarray(jout[-1]))
    if kw.get("return_all"):
        np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]), **SCORE_TOL)
    if m.vocab == 12 and beam == 8:
        # the accumulating histogram is exercised: beams of one group met
        assert collisions["steps"] > 0


def test_histogram_counts_each_choosing_beam():
    """Group 0's two live beams both choose token 3: group 1's candidate
    (row 2, token 3) is penalised twice (2 x 0.6 = 1.2 > its lead of 1.0
    over token 4) and loses its place to (row 2, token 4); counted once
    (0.6) it would keep it. A finished beam's choice adds nothing."""
    neg = -1e30
    cand = torch.full((1, 4, 6), neg)
    cand[0, 0, 3], cand[0, 1, 3] = -1.0, -1.5  # group 0 -> token 3 twice
    cand[0, 2, 3], cand[0, 2, 4] = -2.0, -3.0  # group 1: 3 leads 4 by 1.0
    cand[0, 3, 5] = -2.5
    finished = torch.zeros((1, 4), dtype=torch.bool)
    scores, beams, toks = t_beam._diverse_select(cand, finished, 2, 0.6)
    assert toks.tolist() == [[3, 3, 5, 4]] and beams.tolist() == [[0, 1, 3, 2]]
    assert scores.tolist() == [[-1.0, -1.5, -2.5, -3.0]]  # raw, not penalised
    finished[0, 1] = True  # one of the two choosers has finished: one count
    _, _, toks = t_beam._diverse_select(cand, finished, 2, 0.6)
    assert toks.tolist() == [[3, 3, 5, 3]]


def test_saturating_penalty_separates_the_groups_first_tokens(m):
    toks, _ = t_beam.beam_search(m.tp.decoder, m.ctx, m.summary, 4, MAX_LEN, return_all=True,
                                 diversity_groups=2, diversity_penalty=1e9)
    for row in toks[:, :, 0].tolist():
        assert len({t for t in row if t != PAD}) >= 2, row


def test_raw_scores_equal_sequence_logprob(m):
    """The penalty biases selection only: each returned row's score is its
    teacher-forced log-probability."""
    toks, scores = t_beam.beam_search(m.tp.decoder, m.ctx, m.summary, 4, MAX_LEN,
                                      return_all=True, diversity_groups=2,
                                      diversity_penalty=0.7)
    plain, _ = t_beam.beam_search(m.tp.decoder, m.ctx, m.summary, 4, MAX_LEN, return_all=True)
    assert not torch.equal(toks, plain)
    for j in range(toks.shape[1]):
        lp, _ = sequence_logprob(m.tp, *m.t_in, toks[:, j], max_pos_len=MAX_POS)
        np.testing.assert_allclose(scores[:, j].numpy(), lp.numpy(), rtol=1e-5, atol=1e-5)


def test_lanes_is_ignored_under_diversity(m):
    kw = dict(return_all=True, diversity_groups=2, diversity_penalty=0.7)
    lanes = t_beam.make_beam_caption_fn(4, MAX_POS, MAX_LEN, topk_mode="lanes", **kw)(
        m.tp, *m.t_in)
    grouped = t_beam.make_beam_caption_fn(4, MAX_POS, MAX_LEN, topk_mode="grouped", **kw)(
        m.tp, *m.t_in)
    for a, b in zip(lanes, grouped):
        assert torch.equal(a, b)


def test_diverse_ensemble_matches_jax(m):
    jp2, tp2 = numpy_params(cfg_of(m.vocab), 52)
    kw = dict(return_all=True, diversity_groups=2, diversity_penalty=0.7)
    jout = j_ens.make_ensemble_caption_fn(4, MAX_POS, MAX_LEN, **kw)(
        j_ens.stack_params([m.jp, jp2]), *m.j_in)
    tout = t_ens.make_ensemble_caption_fn(4, MAX_POS, MAX_LEN, **kw)((m.tp, tp2), *m.t_in)
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]), **SCORE_TOL)
    np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))
