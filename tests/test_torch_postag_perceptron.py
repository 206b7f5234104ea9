"""The port's averaged-perceptron tagger and tagger trainer against the JAX
package's: every case of `tests/test_postag_perceptron.py` on the port;
equal sentences and seed give equal weights (exactly: both round the
averaged weights to 6 decimals from the same float sums), lexicon, tagset
and tags; a model saved by either package loads in the other with equal
tags; `train_tagger` -> `cli.prepro --tagger perceptron` writes the JAX
CLIs' model file, info.json and labels.npz."""

import json
import random

import numpy as np
import pytest

from controllable_xgating_tpu.cli import prepro as j_prepro
from controllable_xgating_tpu.data.postag_perceptron import PerceptronTagger as JTagger
from controllable_xgating_torch.cli import prepro as t_prepro
from controllable_xgating_torch.data.postag import PennTagger, tag_tokens
from controllable_xgating_torch.data.postag_perceptron import PerceptronTagger
from controllable_xgating_torch.tools import train_tagger as t_train_tagger
from tools import train_tagger as j_train_tagger

# a tiny context-sensitive grammar: "duck" is NN after a determiner but VB
# after "to" — unlearnable by a pure word->tag lexicon
NOUNS = ["man", "woman", "dog", "duck", "park", "ball"]
VERBS = ["runs", "walks", "jumps", "plays"]
BASES = ["duck", "run", "walk", "play"]
ADJS = ["big", "small", "red", "old"]


def synth_corpus(n, seed):
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        form = rng.randrange(3)
        if form == 0:  # a ADJ NOUN VERB -> DT JJ NN VBZ
            toks = ["a", rng.choice(ADJS), rng.choice(NOUNS), rng.choice(VERBS)]
            tags = ["DT", "JJ", "NN", "VBZ"]
        elif form == 1:  # the NOUN wants to BASE -> DT NN VBZ TO VB
            toks = ["the", rng.choice(NOUNS), "wants", "to", rng.choice(BASES)]
            tags = ["DT", "NN", "VBZ", "TO", "VB"]
        else:  # NOUN and NOUN VERB -> NN CC NN VBZ
            toks = [rng.choice(NOUNS), "and", rng.choice(NOUNS), rng.choice(VERBS)]
            tags = ["NN", "CC", "NN", "VBZ"]
        out.append((toks, tags))
    return out


@pytest.fixture(scope="module")
def trained():
    return PerceptronTagger().train(synth_corpus(300, seed=1), epochs=5)


def test_learns_heldout(trained):
    acc = trained.evaluate(synth_corpus(100, seed=2))
    assert acc >= 0.99, f"held-out accuracy {acc}"


def test_context_disambiguation(trained):
    assert trained.tag(["a", "big", "duck", "runs"]) == ["DT", "JJ", "NN", "VBZ"]
    assert trained.tag(["the", "man", "wants", "to", "duck"]) == ["DT", "NN", "VBZ", "TO", "VB"]


def test_save_load_roundtrip(trained, tmp_path):
    path = str(tmp_path / "tagger.json")
    trained.save(path)
    loaded = PerceptronTagger.load(path)
    for toks, _ in synth_corpus(50, seed=3):
        assert loaded.tag(toks) == trained.tag(toks)
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        json.dump({"something": "else"}, f)
    with pytest.raises(ValueError, match="not a perceptron tagger"):
        PerceptronTagger.load(bad)


def test_untrained_raises():
    with pytest.raises(RuntimeError, match="untrained"):
        PerceptronTagger().tag(["a", "man"])


def caption_sentences(n, rng):
    subj = ["man", "woman", "girl", "boy", "dog", "group"]
    ger = ["running", "dancing", "cooking", "singing", "playing"]
    obj = ["guitar", "food", "music", "ball", "song"]
    place = ["park", "kitchen", "stage", "street", "room"]
    return [["a", rng.choice(subj), rng.choice(["is", "was"]), rng.choice(ger),
             rng.choice(obj), "in", "the", rng.choice(place)] for _ in range(n)]


def test_clones_rule_tagger_on_captions():
    rng = random.Random(0)
    rule = PennTagger()
    train = [(s, rule.tag(s)) for s in caption_sentences(200, rng)]
    tagger = PerceptronTagger().train(train, epochs=5)
    held = [(s, rule.tag(s)) for s in caption_sentences(100, rng)]
    assert tagger.evaluate(held) >= 0.98


def test_rule_tagger_still_default():
    assert tag_tokens(["a", "man", "is", "running"]) == ["DT", "NN", "VBZ", "VBG"]


@pytest.mark.parametrize("seed,epochs,min_freq", [(0, 5, 5), (7, 3, 2), (3, 1, 1000)])
def test_training_equals_jax(seed, epochs, min_freq):
    """The same sentences, seed and lexicon rule give the same model: the
    seeded shuffle, the closed lexicon and the averaged weights."""
    rng = random.Random(seed)
    rule = PennTagger()
    data = synth_corpus(150, seed=seed) + [(s, rule.tag(s)) for s in caption_sentences(80, rng)]
    t = PerceptronTagger().train(data, epochs=epochs, seed=seed, lexicon_min_freq=min_freq)
    j = JTagger().train(data, epochs=epochs, seed=seed, lexicon_min_freq=min_freq)
    assert t.tags == j.tags and t.lexicon == j.lexicon and t.weights == j.weights
    assert (min_freq == 1000) == (not t.lexicon)
    held = [s for s, _ in synth_corpus(60, seed=seed + 100)] + caption_sentences(40, rng)
    assert [t.tag(s) for s in held] == [j.tag(s) for s in held]
    assert t.evaluate(data) == j.evaluate(data)


def test_models_load_across_packages(tmp_path):
    data = synth_corpus(200, seed=9)
    held = [s for s, _ in synth_corpus(80, seed=10)]
    t_path, j_path = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    PerceptronTagger().train(data, seed=4).save(t_path)
    JTagger().train(data, seed=4).save(j_path)
    with open(t_path) as a, open(j_path) as b:
        assert json.load(a) == json.load(b)
    for path in (t_path, j_path):
        t, j = PerceptronTagger.load(path), JTagger.load(path)
        assert [t.tag(s) for s in held] == [j.tag(s) for s in held]


def test_train_tagger_and_prepro_equal_jax(tmp_path, capsys):
    """`train_tagger` -> model file -> `cli.prepro --tagger perceptron`:
    the port's model file, report and corpus equal the JAX tools'; the POS
    vocab is the trained tagset."""
    lines = [" ".join(f"{w}_{t}" for w, t in zip(toks, tags))
             for toks, tags in synth_corpus(200, seed=4)]
    train_file = tmp_path / "train.txt"
    train_file.write_text("\n".join(lines))
    reports, models = [], []
    for name, mod in (("t", t_train_tagger), ("j", j_train_tagger)):
        model = str(tmp_path / f"tagger_{name}.json")
        mod.main(["--train", str(train_file), "--out", model, "--heldout", str(train_file),
                  "--epochs", "4", "--seed", "2"])
        reports.append({k: v for k, v in json.loads(capsys.readouterr().out).items() if k != "out"})
        with open(model) as f:
            models.append(json.load(f))
    assert reports[0] == reports[1] and reports[0]["heldout_acc"] >= 0.99
    assert models[0] == models[1]

    caps = {f"v{i}": ["a big duck runs.", "The man wants to duck!", "a zebra walks"]
            for i in range(6)}
    splits = {"train": ["v0", "v1", "v2", "v3"], "val": ["v4"], "test": ["v5"]}
    (tmp_path / "caps.json").write_text(json.dumps(caps))
    (tmp_path / "splits.json").write_text(json.dumps(splits))
    outs = {}
    for name, main in (("t", t_prepro.main), ("j", j_prepro.main)):
        out = outs[name] = str(tmp_path / f"corpus_{name}")
        main(["--out", out, "--captions", str(tmp_path / "caps.json"),
              "--splits", str(tmp_path / "splits.json"), "--min_word_freq", "1",
              "--max_caption_len", "10", "--seqs_per_video", "2",
              "--tagger", "perceptron", "--tagger_model", str(tmp_path / "tagger_t.json")])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [{k: v for k, v in p.items() if k != "out"} for p in printed][0] == \
        {k: v for k, v in printed[1].items() if k != "out"}
    infos = [json.load(open(outs[n] + "/info.json")) for n in "tj"]
    assert infos[0] == infos[1]
    assert set(infos[0]["pos_vocab"][4:]) == {"DT", "JJ", "NN", "VBZ", "TO", "VB", "CC"}
    labels = [np.load(outs[n] + "/labels.npz") for n in "tj"]
    assert labels[0].files == labels[1].files
    for k in labels[0].files:
        np.testing.assert_array_equal(labels[0][k], labels[1][k])
        assert labels[0][k].dtype == labels[1][k].dtype


def test_prepro_perceptron_needs_a_model(tmp_path):
    (tmp_path / "c.json").write_text(json.dumps({"v0": ["a man runs"]}))
    (tmp_path / "s.json").write_text(json.dumps({"train": ["v0"]}))
    with pytest.raises(SystemExit):
        t_prepro.main(["--out", str(tmp_path / "o"), "--captions", str(tmp_path / "c.json"),
                       "--splits", str(tmp_path / "s.json"), "--tagger", "perceptron"])


READ_TAGGED_CASES = {
    # slash-format words with underscores split at the rightmost separator
    "mixed_separators": ("new_york/NNP is/VBZ nice/JJ\na_DT dog_NN runs_VBZ\n\n",
                         [(["new_york", "is", "nice"], ["NNP", "VBZ", "JJ"]),
                          (["a", "dog", "runs"], ["DT", "NN", "VBZ"])]),
    "slash_in_word": ("1/2_CD cup_NN\n", [(["1/2", "cup"], ["CD", "NN"])]),
    "no_suffix": ("plainword\n", "suffix"),
    "empty_tag": ("a_DT dog_\n", "suffix"),
    "empty_word": ("_DT dog_NN\n", "suffix"),
    "no_sentences": ("\n  \n", "no tagged sentences"),
}


@pytest.mark.parametrize("case", list(READ_TAGGED_CASES))
def test_read_tagged_edge_cases(tmp_path, case):
    text, want = READ_TAGGED_CASES[case]
    f = tmp_path / "t.txt"
    f.write_text(text)
    if isinstance(want, str):
        for mod in (t_train_tagger, j_train_tagger):
            with pytest.raises(ValueError, match=want):
                mod.read_tagged(str(f))
    else:
        assert t_train_tagger.read_tagged(str(f)) == want == j_train_tagger.read_tagged(str(f))
