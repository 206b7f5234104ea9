"""The port's `preprocess_corpus` (`controllable_xgating_torch/data/corpus.py`)
against the JAX package's on the same captions: info.json equal as a dict,
labels.npz arrays equal in value and dtype (exactly: both are integer ids
from the same tokenizer, tagger and vocab rules), with the rule tagger, a
trained perceptron tagger and an adopted vocabulary; duplicate split
membership and missing captions refused by both."""

import json
import os

import numpy as np
import pytest

from controllable_xgating_tpu.data import corpus as j_corpus
from controllable_xgating_tpu.data.postag_perceptron import PerceptronTagger as JTagger
from controllable_xgating_torch.cli import prepro as t_prepro
from controllable_xgating_torch.data import corpus as t_corpus
from controllable_xgating_torch.data.postag import PennTagger
from controllable_xgating_torch.data.postag_perceptron import PerceptronTagger
from controllable_xgating_torch.data.vocab import BOS, EOS, PAD, UNK

CAPTIONS = {
    "v0": ["A man is running.", "The man runs fast.", "a man is running ."],
    "v1": ["A dog is swimming in the water.", "There is a dog swimming", ""],
    "v2": ["A man is swimming.", "A young girl can't sing (badly)!"],
    "v3": ["Two women are cooking food in a kitchen", "the women cook"],
    "v4": ["a cat plays with a ball", "A cat is playing with a red ball."],
}
SPLITS = {"train": ["v0", "v1", "v3"], "val": ["v4"], "test": ["v2"]}


def assert_same_corpus(t_dir: str, j_dir: str) -> None:
    with open(os.path.join(t_dir, "info.json")) as a, open(os.path.join(j_dir, "info.json")) as b:
        assert json.load(a) == json.load(b)
    t, j = t_corpus.load_labels(t_dir), j_corpus.load_labels(j_dir)
    assert sorted(t) == sorted(j) == ["caps", "ncaps", "pos"]
    for k in t:
        assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, k
        np.testing.assert_array_equal(t[k], j[k])


def both(tmp_path, name, t_kw=None, j_kw=None, **kw):
    """Run both packages' preprocess_corpus; return the two infos."""
    dirs = [str(tmp_path / f"{name}_t"), str(tmp_path / f"{name}_j")]
    ti = t_corpus.preprocess_corpus(CAPTIONS, SPLITS, dirs[0], **kw, **(t_kw or {}))
    ji = j_corpus.preprocess_corpus(CAPTIONS, SPLITS, dirs[1], **kw, **(j_kw or {}))
    assert_same_corpus(*dirs)
    return ti, ji, dirs


@pytest.mark.parametrize("kw", [
    dict(min_word_freq=1, max_caption_len=12, seqs_per_video=4),
    dict(min_word_freq=2, max_caption_len=6, seqs_per_video=2),  # truncation, UNKs
    dict(),  # the defaults: 28 x 20
])
def test_default_tagger_equals_jax(tmp_path, kw):
    ti, ji, _ = both(tmp_path, "rules", **kw)
    assert ti.vocab.to_list() == ji.vocab.to_list()
    assert ti.pos_vocab.to_list()[4:] == list(t_corpus.PENN_TAGS)


def test_perceptron_tagger_equals_jax(tmp_path):
    rule = PennTagger()
    sents = [(s.split(), rule.tag(s.split())) for s in
             ["a man is running", "the dog swims in the water", "a cat plays with a ball",
              "two women cook food"] * 5]
    ti, _, _ = both(tmp_path, "perc", t_kw={"tagger": PerceptronTagger().train(sents)},
                    j_kw={"tagger": JTagger().train(sents)},
                    min_word_freq=1, max_caption_len=12, seqs_per_video=3)
    # the trained tagset is the POS vocab
    assert ti.pos_vocab.to_list()[4:] == sorted({t for _, g in sents for t in g})


def test_vocab_adoption_equals_jax(tmp_path):
    src = t_corpus.preprocess_corpus(
        {"s0": ["a man is running", "the man runs"], "s1": ["a dog is swimming in the water"]},
        {"train": ["s0", "s1"], "val": [], "test": []}, str(tmp_path / "src"), min_word_freq=1,
        max_caption_len=12, seqs_per_video=4)
    jvocab = j_corpus.CorpusInfo.load(str(tmp_path / "src" / "info.json")).vocab
    ti, _, dirs = both(tmp_path, "adopt", t_kw={"vocab": src.vocab}, j_kw={"vocab": jvocab},
                       min_word_freq=1, max_caption_len=12, seqs_per_video=4)
    assert ti.vocab.idx_to_word == src.vocab.idx_to_word
    labels = t_corpus.load_labels(dirs[0])
    # v2's first caption: "a man is swimming" all in the adopted vocab;
    # v3's words "two women ..." mostly not -> UNK
    row = ti.video_ids.index("v2")
    assert ti.vocab.decode(labels["caps"][row, 0]) == ["a", "man", "is", "swimming"]
    row = ti.video_ids.index("v3")
    ids = [int(i) for i in labels["caps"][row, 0] if int(i) not in (PAD, BOS, EOS)]
    assert ids[0] == UNK and ids.count(UNK) >= 3


def test_preprocess_small_roundtrip(tmp_path):
    info = t_corpus.preprocess_corpus(
        {"v0": ["A man is running.", "The man runs fast."], "v1": ["A dog is swimming."],
         "v2": ["A man is swimming."]},
        {"train": ["v0", "v1"], "val": [], "test": ["v2"]}, str(tmp_path), min_word_freq=1,
        max_caption_len=12, seqs_per_video=4)
    labels = t_corpus.load_labels(str(tmp_path))
    assert labels["caps"].shape == (3, 4, 12) and labels["ncaps"].tolist() == [2, 1, 1]
    ids = labels["caps"][0, 0]
    assert info.vocab.decode(ids) == ["a", "man", "is", "running"] and ids[0] == BOS
    n_words = int((ids != PAD).sum()) - 2
    assert int((labels["pos"][0, 0] != PAD).sum()) - 2 == n_words
    back = t_corpus.CorpusInfo.load(str(tmp_path / "info.json"))
    assert back.video_ids == ["v0", "v1", "v2"]
    assert back.splits == {"train": [0, 1], "val": [], "test": [2]}


@pytest.mark.parametrize("splits,match", [
    ({"train": ["v0"], "val": ["v0"], "test": []}, "more than one split"),
    ({"train": ["v0", "v0"]}, "more than one split"),
    ({"train": ["v0"], "test": ["nope"]}, "captions missing"),
])
def test_bad_splits_refused(tmp_path, splits, match):
    for mod in (t_corpus, j_corpus):
        with pytest.raises(ValueError, match=match):
            mod.preprocess_corpus({"v0": ["a man runs."]}, splits, str(tmp_path / mod.__name__))


def test_prepro_cli_captions_equal_jax(tmp_path, capsys):
    from controllable_xgating_tpu.cli import prepro as j_prepro

    (tmp_path / "caps.json").write_text(json.dumps(CAPTIONS))
    (tmp_path / "splits.json").write_text(json.dumps(SPLITS))
    args = ["--captions", str(tmp_path / "caps.json"), "--splits", str(tmp_path / "splits.json"),
            "--max_caption_len", "9", "--seqs_per_video", "3", "--min_word_freq", "1"]
    t_prepro.main(["--out", str(tmp_path / "t"), *args])
    j_prepro.main(["--out", str(tmp_path / "j"), *args])
    assert_same_corpus(str(tmp_path / "t"), str(tmp_path / "j"))
    t_line, j_line = (json.loads(line) for line in capsys.readouterr().out.splitlines())
    assert t_line.pop("out") != j_line.pop("out") and t_line == j_line
    # --vocab_from on captions
    t_prepro.main(["--out", str(tmp_path / "t2"), *args,
                   "--vocab_from", str(tmp_path / "t" / "info.json")])
    j_prepro.main(["--out", str(tmp_path / "j2"), *args,
                   "--vocab_from", str(tmp_path / "j" / "info.json")])
    assert_same_corpus(str(tmp_path / "t2"), str(tmp_path / "j2"))
    with pytest.raises(SystemExit):
        t_prepro.main(["--out", str(tmp_path / "t3"), "--captions", str(tmp_path / "caps.json")])
