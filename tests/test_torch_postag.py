"""The port's rule-based Penn tagger (`controllable_xgating_torch/data/postag.py`)
against the JAX package's: every case of `tests/test_postag.py` on both,
and equal tags (exactly: the tagger is pure string rules) on every caption
of a `linear` and a `syntax` fixture corpus, tokenized by the port's
tokenizer as `preprocess_corpus` tokenizes them."""

import numpy as np
import pytest

from controllable_xgating_tpu.data import fixtures as j_fixtures
from controllable_xgating_tpu.data import postag as j_postag
from controllable_xgating_torch.data import postag as t_postag
from controllable_xgating_torch.data.tokenizer import PTBTokenizer

CASES = {
    "simple_caption": ("a man is playing guitar", ["DT", "NN", "VBZ", "VBG", "NN"]),
    "third_person_verb": ("a woman walks down the street", ["DT", "NN", "VBZ", "IN", "DT", "NN"]),
    "plural_nouns_kept": ("two dogs are running", ["CD", "NNS", "VBP", "VBG"]),
    "adjectives_and_adverbs": ("a small dog runs quickly", ["DT", "JJ", "NN", "VBZ", "RB"]),
    "rule_tagger_default": ("a man is running", ["DT", "NN", "VBZ", "VBG"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tag_tokens_cases(case):
    text, want = CASES[case]
    assert t_postag.tag_tokens(text.split()) == want == j_postag.tag_tokens(text.split())


def test_to_infinitive():
    tags = t_postag.tag_tokens("a boy tries to play football".split())
    assert tags[-3:] == ["TO", "VB", "NN"]


def test_ing_noun_exception():
    assert t_postag.tag_tokens("a man enters the building".split())[-1] == "NN"


def test_extra_lexicon_override():
    assert t_postag.PennTagger(extra_lexicon={"zork": "VB"}).tag(["zork"]) == ["VB"]
    # the override is the tagger's own: the default tagger is untouched
    assert t_postag.tag_tokens(["zork"]) == j_postag.tag_tokens(["zork"])


def test_all_tags_in_penn_set():
    sent = "the three young girls are singing a beautiful song on stage".split()
    assert all(t in t_postag.PENN_TAGS for t in t_postag.tag_tokens(sent))
    assert t_postag.PENN_TAGS == j_postag.PENN_TAGS


def fixture_captions(monkeypatch, tmp_path, feature_map: str) -> list[list[str]]:
    """The raw captions the JAX fixture generator hands `preprocess_corpus`,
    PTB-tokenized."""
    seen = {}

    def record(captions, splits, out_dir, **kw):
        seen.update(captions)
        return real(captions, splits, out_dir, **kw)

    real = j_fixtures.preprocess_corpus
    monkeypatch.setattr(j_fixtures, "preprocess_corpus", record)
    j_fixtures.make_fixture_corpus(str(tmp_path), num_videos=150, num_frames=3, app_dim=8,
                                   motion_dim=8, caps_per_video=12, seqs_per_video=4,
                                   max_caption_len=16, feature_map=feature_map, seed=5)
    tok = PTBTokenizer()
    return [tok.tokenize(c) for caps in seen.values() for c in caps]


@pytest.mark.parametrize("feature_map", ["linear", "syntax"])
def test_tags_equal_jax_on_fixture_captions(monkeypatch, tmp_path, feature_map):
    sents = fixture_captions(monkeypatch, tmp_path, feature_map)
    assert len(sents) == 150 * 12
    extra = {"guitar": "NN", "plays": "VBZ"}
    for t_tagger, j_tagger in ((t_postag.PennTagger(), j_postag.PennTagger()),
                               (t_postag.PennTagger(extra), j_postag.PennTagger(extra))):
        got = [t_tagger.tag(s) for s in sents]
        assert got == [j_tagger.tag(s) for s in sents]
    # the corpus exercises the context rules, not just the lexicon
    used = {t for s in sents for t in t_postag.tag_tokens(s)}
    assert {"EX", "VBZ", "VBG", "DT", "NN", "IN"} <= used
    assert np.mean([len(s) for s in sents]) > 3
