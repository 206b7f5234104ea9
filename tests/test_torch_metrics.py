"""The port's own copies of the JAX package's framework-free modules vs
the originals, on the same inputs: the metric harness (BLEU, METEOR,
ROUGE-L, CIDEr, CIDEr-D, on the pure-Python path), the PTB tokenizer, the
vocabulary and the config loader.

METEOR and ROUGE-L of the JAX package may run through its native C++
library, which tests/test_native_text.py holds equal to the Python path
within rel 1e-9; that is the bound here.
"""

import os

import numpy as np
import pytest

from controllable_xgating_tpu.data import tokenizer as j_tok
from controllable_xgating_tpu.data import vocab as j_vocab
from controllable_xgating_tpu.metrics import harness as j_harness
from controllable_xgating_tpu.utils import config as j_config
from controllable_xgating_torch.data import tokenizer as t_tok
from controllable_xgating_torch.data import vocab as t_vocab
from controllable_xgating_torch.metrics import harness as t_harness
from controllable_xgating_torch.utils import config as t_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["a", "man", "is", "playing", "guitar", "the", "woman", "cooks", "food", "dog",
         "runs", "in", "park", "two", "people", "are", "talking", "about", "car", "plays"]


def captions(seed, keys=12, refs=4):
    """{key: [ref strings]}, {key: [one candidate]} of seeded random words;
    some candidates empty or repeating a reference."""
    rng = np.random.default_rng(seed)
    sent = lambda: " ".join(rng.choice(WORDS, rng.integers(3, 11)))
    gts = {f"v{i}": [sent() for _ in range(refs)] for i in range(keys)}
    res = {k: [sent()] for k in gts}
    res["v0"] = [gts["v0"][1]]
    res["v1"] = [""]
    return gts, res


def assert_same_scores(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-9, abs=1e-12), k


@pytest.mark.parametrize("metrics", [None, ("CIDEr",), ("Bleu_4", "METEOR")],
                         ids=["all", "cider", "bleu_meteor"])
def test_language_eval_matches_jax(metrics):
    gts, res = captions(0)
    want = j_harness.language_eval(gts, res, metrics=metrics)
    got = t_harness.language_eval(gts, res, metrics=metrics)
    assert_same_scores(got, want)
    if metrics is None:
        assert {"Bleu_4", "METEOR", "ROUGE_L", "CIDEr", "CIDErD"} <= set(got)


def test_language_eval_per_key_and_retokenize_match_jax():
    gts, res = captions(1)
    gts["v2"] = ["A man, playing the guitar!", "The dog's running (fast)."]
    res["v2"] = ["a man plays guitar."]
    want, want_detail = j_harness.language_eval(gts, res, retokenize=True, per_key=True)
    got, got_detail = t_harness.language_eval(gts, res, retokenize=True, per_key=True)
    assert_same_scores(got, want)
    assert got_detail.keys() == want_detail.keys()
    for k in want_detail:
        assert_same_scores(got_detail[k], want_detail[k])


def test_language_eval_meteor_synonyms_match_jax():
    gts, res = captions(2)
    syn = [["man", "people"], ["cooks", "plays"]]
    want = j_harness.language_eval(gts, res, metrics=("METEOR",), meteor_synonyms=syn)
    got = t_harness.language_eval(gts, res, metrics=("METEOR",), meteor_synonyms=syn)
    assert_same_scores(got, want)


def test_language_eval_rejects_candidates_without_references():
    gts, res = captions(3)
    res["extra"] = ["a dog"]
    with pytest.raises(KeyError, match="without references"):
        t_harness.language_eval(gts, res)


@pytest.mark.parametrize("text", [
    "A man is playing a guitar.", "\"Two dogs,\" she said -- can't stop!",
    "It's (really) [odd]; isn't it?", "The car's wheels... gonna go", "",
])
def test_tokenizer_matches_jax(text):
    assert t_tok.ptb_tokenize(text) == j_tok.PTBTokenizer().tokenize_python(text)
    assert t_tok.PTBTokenizer().tokenize_raw(text) == j_tok.PTBTokenizer().tokenize_raw(text)


def test_vocab_encode_decode_save_load_match_jax(tmp_path):
    seqs = [s.split() for s in ("a man is cooking", "a man plays a guitar", "dogs run",
                                "a dog runs in a park", "man runs")]
    jv, tv = j_vocab.Vocab.build(seqs, min_freq=2), t_vocab.Vocab.build(seqs, min_freq=2)
    assert tv.to_list() == jv.to_list()
    toks = "a man runs to the moon".split()
    assert tv.encode(toks) == jv.encode(toks)
    ids = [1, 5, 4, 0, 3, 2, 6]
    assert tv.decode(ids) == jv.decode(ids) and tv.decode_str(ids) == jv.decode_str(ids)
    assert tv.decode(ids, stop_at_eos=False) == jv.decode(ids, stop_at_eos=False)
    assert t_vocab.pad_encode(tv, toks, 6) == j_vocab.pad_encode(jv, toks, 6)
    assert (t_vocab.PAD, t_vocab.BOS, t_vocab.EOS, t_vocab.UNK) == (
        j_vocab.PAD, j_vocab.BOS, j_vocab.EOS, j_vocab.UNK)
    jv.save(str(tmp_path / "v.json"))
    assert t_vocab.Vocab.load(str(tmp_path / "v.json")).to_list() == jv.to_list()


def test_label_arrays_to_strings_match_jax():
    vocab = t_vocab.Vocab(WORDS)
    rng = np.random.default_rng(4)
    caps = rng.integers(0, len(vocab), (3, 4, 7))
    caps[..., 0] = 1
    ncaps = np.array([4, 2, 1])
    keys = ["a", "b", "c"]
    jv = j_vocab.Vocab(WORDS)
    assert t_harness.gts_from_label_array(vocab, caps, ncaps, keys) == \
        j_harness.gts_from_label_array(jv, caps, ncaps, keys)
    assert t_harness.decode_token_array(vocab, caps[:, 0]) == \
        j_harness.decode_token_array(jv, caps[:, 0])


@pytest.mark.parametrize("overrides", [None, {"model.hidden_dim": "64", "train.remat": "true",
                                              "eval.metrics": ["CIDEr"]}])
def test_load_config_matches_jax(overrides):
    path = os.path.join(REPO, "configs", "msrvtt.json")
    got = t_config.load_config(path, overrides)
    want = j_config.load_config(path, overrides)
    assert got.to_dict() == want.to_dict()
    assert got.model.vocab_size == 0 and got.data.caps_per_video_train == 5
    with pytest.raises(KeyError, match="unknown config field"):
        t_config.load_config(path, {"model.no_such_field": 1})


def test_parse_cli_overrides_matches_jax():
    argv = ["--model.hidden_dim", "1024", "--train.lr=1e-3", "--eval.beam_size", "3"]
    assert t_config.parse_cli_overrides(argv) == j_config.parse_cli_overrides(argv)
    with pytest.raises(ValueError, match="missing a value"):
        t_config.parse_cli_overrides(["--model.hidden_dim"])
