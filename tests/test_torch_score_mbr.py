"""The port's sequence scorer (`infer/score.py`) and MBR selection
(`infer/mbr.py`) vs the JAX package's, on the CPU.

`sequence_logprob` on seeded numpy weights carried to both packages by the
weight bridge: log-probs within rtol 1e-5 / atol 1e-6, lengths equal; a
beam's n-best rescored by its own model gives back the beam's scores.
`mbr_select` on seeded pools with duplicates: the same choices, utilities
within 1e-9 (the JAX side may take its native ROUGE-L).
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controllable_xgating_tpu.infer import mbr as j_mbr
from controllable_xgating_tpu.infer import score as j_score
from controllable_xgating_tpu.utils.config import Config
from controllable_xgating_torch.data.vocab import EOS, PAD
from controllable_xgating_torch.infer import beam as t_beam
from controllable_xgating_torch.infer import mbr as t_mbr
from controllable_xgating_torch.infer import score as t_score
from test_torch_quant import numpy_params

torch.set_num_threads(1)
MAX_LEN, MAX_POS, VOCAB = 9, 6, 30


@pytest.fixture(scope="module")
def m():
    cfg = Config().replace_flat({
        "model.app_dim": 10, "model.motion_dim": 8, "model.hidden_dim": 12,
        "model.embed_dim": 8, "model.attn_dim": 10, "model.pos_embed_dim": 10,
        "model.vocab_size": VOCAB, "model.pos_vocab_size": 12, "model.num_frames": 4,
    })
    jp, tp = numpy_params(cfg, 60)
    rng = np.random.default_rng(61)
    app = rng.standard_normal((5, 4, 10)).astype(np.float32)
    mot = rng.standard_normal((5, 4, 8)).astype(np.float32)
    mask = np.array([[1, 1, 1, 1], [1, 1, 1, 0], [1, 1, 0, 0], [1, 1, 1, 1], [1, 0, 0, 0]],
                    np.float32)
    # hypotheses: words, EOS at varied places (or none), PAD after, and one
    # row that goes on past its EOS
    toks = rng.integers(4, VOCAB, (5, MAX_LEN))
    for row, eos in enumerate((3, 8, 1, None, 5)):
        if eos is not None:
            toks[row, eos] = EOS
            toks[row, eos + 1:] = PAD
    toks[4, 6:] = rng.integers(4, VOCAB, MAX_LEN - 6)
    toks[2, 0] = 3  # UNK, which block_unk masks
    return SimpleNamespace(jp=jp, tp=tp, j_in=(app, mot, mask),
                           t_in=tuple(map(torch.from_numpy, (app, mot, mask))), toks=toks)


@pytest.mark.parametrize("block_unk", [False, True])
def test_sequence_logprob_matches_jax(m, block_unk):
    jl, jn = j_score.sequence_logprob(m.jp, *m.j_in, jnp.asarray(m.toks, jnp.int32),
                                      max_pos_len=MAX_POS, block_unk=block_unk)
    tl, tn = t_score.make_sequence_scorer(MAX_POS, block_unk=block_unk)(
        m.tp, *m.t_in, torch.from_numpy(m.toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert tn.tolist() == [4, 9, 2, 9, 6]


@pytest.mark.parametrize("kw", [{}, {"block_unk": True, "early_stop": False}],
                         ids=["default", "block_unk"])
def test_nbest_scores_equal_their_rescoring(m, kw):
    toks, scores, _ = t_beam.make_beam_caption_fn(4, MAX_POS, MAX_LEN, return_all=True, **kw)(
        m.tp, *m.t_in)
    b, k, L = toks.shape
    rep = lambda x: x.repeat_interleave(k, dim=0)
    lp, n = t_score.make_sequence_scorer(MAX_POS, block_unk=kw.get("block_unk", False))(
        m.tp, *map(rep, m.t_in), toks.reshape(b * k, L))
    np.testing.assert_allclose(lp.reshape(b, k).numpy(), scores.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(n.reshape(b, k).numpy(), (toks != PAD).sum(-1).numpy())


# --- MBR ---

WORDS = "a man is playing guitar on stage the woman cooking food in kitchen dog runs".split()


@pytest.fixture(scope="module")
def pools():
    """Ten pools of 2-8 candidates, with duplicates and one single-string
    pool, and posterior weights for each."""
    rng = np.random.default_rng(62)
    out, weights = {}, {}
    for v in range(10):
        base = [" ".join(rng.choice(WORDS, rng.integers(3, 8))) for _ in range(rng.integers(2, 5))]
        pool = [base[i] for i in rng.integers(0, len(base), rng.integers(2, 9))]
        out[f"video{v}"] = pool
        weights[f"video{v}"] = list(rng.random(len(pool)) + 0.01)
    out["video10"] = ["a man is playing"] * 3
    weights["video10"] = [0.2, 0.3, 0.5]
    return out, weights


@pytest.mark.parametrize("utility", ["ROUGE_L", "CIDErD"])
@pytest.mark.parametrize("weighted", [False, True], ids=["frequency", "posterior"])
def test_mbr_select_matches_jax(pools, utility, weighted):
    pool, weights = pools
    w = weights if weighted else None
    want = j_mbr.mbr_select(pool, utility=utility, weights=w)
    got = t_mbr.mbr_select(pool, utility=utility, weights=w)
    assert got.keys() == want.keys()
    for vid in want:
        assert got[vid][0] == want[vid][0], vid
        assert abs(got[vid][1] - want[vid][1]) <= 1e-9, vid
    assert got["video10"] == ("a man is playing", 1.0)


@pytest.mark.parametrize("pool,kw,match", [
    ({"v": ["a b"]}, {"utility": "BLEU"}, "ROUGE_L or CIDErD"),
    ({"v": []}, {}, "empty candidate pool"),
    ({"v": ["a b", "c"]}, {"weights": {"v": [1.0]}}, "must align"),
    ({"v": ["a b", "c"]}, {"weights": {"v": [0.0, 0.0]}}, "must sum > 0"),
], ids=["utility", "empty", "misaligned", "zero_mass"])
def test_mbr_select_refusals(pool, kw, match):
    for pkg in (t_mbr, j_mbr):
        with pytest.raises(ValueError, match=match):
            pkg.mbr_select(pool, **kw)
