"""The port's native host runtime
(`controllable_xgating_torch/utils/native.py`) against its own Python
paths and the JAX package, on the CPU.

Tokens and stems must be equal; METEOR (with and without a synonym
table) and ROUGE-L within rel 1e-9 (`tests/test_native_text.py`'s bar);
the df table of the native builder bit for bit the port's numpy build,
and the reward tables bit for bit the JAX package's. The JAX package's
native library is compared only where it is already built and current
(its `make` is then a no-op); its Python paths, which its own tests hold
equal to its library, always.

These tests skip only where no C++ compiler is on PATH: where one is,
the library must build, or they fail.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from controllable_xgating_tpu.data.tokenizer import PTBTokenizer as JTokenizer
from controllable_xgating_tpu.metrics.meteor import MeteorScorer as JMeteor
from controllable_xgating_tpu.metrics.meteor import meteor_single as j_meteor_single
from controllable_xgating_tpu.metrics.rouge import RougeScorer as JRouge
from controllable_xgating_tpu.metrics.stemmer import stem as j_stem
from controllable_xgating_tpu.ops import cider_device as j_cd
from controllable_xgating_tpu.utils import native as j_native
from controllable_xgating_torch.data.fixtures import ACTIONS, PLACES, SUBJECTS
from controllable_xgating_torch.data.tokenizer import PTBTokenizer
from controllable_xgating_torch.infer import mbr
from controllable_xgating_torch.metrics.meteor import MeteorScorer, meteor_single
from controllable_xgating_torch.metrics.rouge import RougeScorer
from controllable_xgating_torch.metrics.stemmer import stem
from controllable_xgating_torch.ops import cider_device as t_cd
from controllable_xgating_torch.utils import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.skipif(native.compiler() is None, reason="no C++ compiler on PATH")

TRICKY = [
    "A man is playing guitar.",
    "He doesn't sing, but they're dancing!",
    "the dog's ball (in red) -- wait... what?",
    'She said "hello" and left; obviously.',
    "cannot stop, gonna run, wanna play",
    "2 dogs run 3.5 miles at 5:30",
    "I'll we've you're it's don't won't",
    "the end.",
    "",
    "   spaces   everywhere   ",
]
GROUPS = [("man", "guy"), ("woman", "lady"), ("chef", "cook"), ("singer", "performer")]


def corpus_sentences() -> list:
    out = []
    for subj in SUBJECTS:
        for verb, _v3, obj in ACTIONS[:6]:
            for place in PLACES[:4]:
                out.append(" ".join([subj[0], verb] + [w for w in (obj, place) if w]) + ".")
    return out


def jax_native_current() -> bool:
    """The JAX package's library is built and newer than its sources, so
    loading it runs no build (its `make` is a no-op)."""
    so = os.path.join(ROOT, "native", "libcxg_native.so")
    srcs = [os.path.join(ROOT, "native", f) for f in ("cxg_native.cpp", "cxg_text.cpp")]
    return (os.path.exists(so) and all(os.path.getmtime(so) >= os.path.getmtime(s) for s in srcs)
            and j_native.available())


def test_library_builds_under_build_and_loads():
    """Where a compiler exists the port's library builds (never silently
    falls back) into build/native/, not native/."""
    assert native.available(), "the port's native library did not build or load"
    path = native.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == os.path.join(ROOT, "build", "native")


def test_compiler_prefers_path_over_a_cxx_wrapper(monkeypatch, tmp_path):
    """g++ on PATH comes before `$CXX`: a wrapper there may link libstdc++
    statically, and that build crashes in the tokenizer beside numpy's
    shared libstdc++."""
    wrapper = tmp_path / "g++-wrapper"
    wrapper.write_text("#!/bin/sh\nexit 1\n")
    wrapper.chmod(0o755)
    monkeypatch.setenv("CXX", str(wrapper))
    assert native.compiler() == shutil.which("g++")
    monkeypatch.setenv("PATH", str(tmp_path))
    assert native.compiler() == str(wrapper)


def test_tokens_equal_python_and_jax():
    tok, jtok = PTBTokenizer(), JTokenizer()
    jax_lib = jax_native_current()
    for sent in TRICKY + corpus_sentences():
        got = native.ptb_tokenize(sent)
        assert got == tok.tokenize_python(sent) == jtok.tokenize_python(sent), sent
        assert tok.tokenize(sent) == got
        if jax_lib:
            assert j_native.ptb_tokenize(sent) == got, sent


def test_stems_equal_python_and_jax():
    words = set()
    for sent in corpus_sentences() + TRICKY:
        words.update(PTBTokenizer().tokenize_python(sent))
    words.update(["running", "caresses", "ponies", "relational", "rationalization",
                  "probability", "conditional", "triplicate", "allowance", "inference"])
    jax_lib = jax_native_current()
    for w in sorted(words):
        assert native.porter_stem(w) == stem(w) == j_stem(w), w
        if jax_lib:
            assert j_native.porter_stem(w) == stem(w), w


def caption_pairs(seed: int, n: int = 60):
    """{key: refs}, {key: [hyp]} of seeded fixture sentences, tokenized."""
    sents = corpus_sentences()
    tok = PTBTokenizer()
    rng = np.random.default_rng(seed)
    pick = lambda: " ".join(tok.tokenize_python(sents[rng.integers(len(sents))]))
    gts, res = {}, {}
    for i in range(n):
        res[f"v{i}"] = [pick()]
        gts[f"v{i}"] = [pick() for _ in range(int(rng.integers(1, 4)))]
    return gts, res


@pytest.mark.parametrize("synonyms", [None, GROUPS], ids=["exact-stem", "synonyms"])
def test_meteor_scorer_native_matches_python_and_jax(synonyms):
    gts, res = caption_pairs(0)
    gts["syn0"], res["syn0"] = ["a man is cooking food", "the lady sings"], ["a guy is cooking"]
    gts["syn1"], res["syn1"] = ["a chef is singing"], ["the cook is a performer"]
    got, per = MeteorScorer(synonyms=synonyms).score(gts, res)
    py, per_py = MeteorScorer(use_native=False, synonyms=synonyms).score(gts, res)
    jx, per_jx = JMeteor(use_native=False, synonyms=synonyms).score(gts, res)
    assert got == pytest.approx(py, rel=1e-9) and py == pytest.approx(jx, rel=1e-12)
    np.testing.assert_allclose(per, per_py, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(per_py, per_jx, rtol=1e-12, atol=0)
    if synonyms:  # the table moves some score: the synonym stage ran natively
        assert got > MeteorScorer().score(gts, res)[0]


def test_rouge_scorer_native_matches_python_and_jax():
    gts, res = caption_pairs(1)
    scorer = RougeScorer()
    got, per = scorer.score(gts, res)
    want = [scorer.score_single(gts[k], res[k][0]) for k in res]
    np.testing.assert_allclose(per, want, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(want, [JRouge().score_single(gts[k], res[k][0]) for k in res],
                               rtol=1e-12, atol=0)
    assert got == pytest.approx(sum(want) / len(want), rel=1e-9)


def test_mbr_rouge_similarity_takes_the_native_path():
    a, b = "a man is playing a guitar", "a guy plays the guitar on stage"
    assert mbr._pair_sim_rouge(a, b) == pytest.approx(RougeScorer().score_single([b], a), rel=1e-9)
    assert mbr._pair_sim_rouge(a, b) == native.rouge_l(a, [b], 1.2)


def test_tokenizer_and_stemmer_fuzz():
    """`tests/test_native_text.py`'s seeded character-level fuzz on the
    port's library: arbitrary strings tokenize, random words stem, as the
    Python paths do."""
    tok = PTBTokenizer()
    rng = np.random.default_rng(42)
    alpha = list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789")
    punct = list(".,;:!?\"'()[]{}<>-/\\&%$#@*+=~`^_|") + [
        "...", "--", "''", "``", "n't", "'s", "'re", "'ll", "'ve", "'d", "'m"]
    ws = [" ", "  ", "\t"]
    for _ in range(800):
        parts = []
        for _ in range(int(rng.integers(0, 25))):
            r = rng.random()
            if r < 0.5:
                parts.append("".join(rng.choice(alpha) for _ in range(int(rng.integers(1, 9)))))
            elif r < 0.8:
                parts.append(str(rng.choice(punct)))
            else:
                parts.append(str(rng.choice(ws)))
            if rng.random() < 0.7:
                parts.append(" ")
        s = "".join(parts)
        assert native.ptb_tokenize(s) == tok.tokenize_python(s), repr(s)
    letters = list("abcdefghijklmnopqrstuvwxyz'")
    for _ in range(4000):
        w = "".join(rng.choice(letters) for _ in range(int(rng.integers(1, 14))))
        assert native.porter_stem(w) == stem(w), repr(w)


def test_meteor_rouge_fuzz_word_soup():
    """Word soups (morphological variants, junk, empty hypotheses and
    references), native against Python and the JAX package's Python."""
    vocab = ["cat", "cats", "run", "running", "ran", "dog", "dogs", "play", "played", "playing",
             "a", "the", "is", "was", "happy", "happiness", "xqz", "qq"]
    scorer = RougeScorer()
    rng = np.random.default_rng(7)
    for _ in range(300):
        hyp = " ".join(str(rng.choice(vocab)) for _ in range(int(rng.integers(0, 15))))
        refs = [" ".join(str(rng.choice(vocab)) for _ in range(int(rng.integers(0, 15))))
                for _ in range(int(rng.integers(1, 4)))]
        want = meteor_single(hyp, refs)
        assert want == j_meteor_single(hyp, refs)
        assert native.meteor(hyp, refs) == pytest.approx(want, rel=1e-9, abs=1e-12), (hyp, refs)
        assert native.rouge_l(hyp, refs, scorer.beta) == pytest.approx(
            scorer.score_single(refs, hyp), rel=1e-9, abs=1e-12), (hyp, refs)


def seeded_caps(seed: int, n: int = 60, s: int = 6, length: int = 14):
    """Token-id captions [n, s, length] as the labels hold them (BOS, words
    with the odd UNK, EOS, PAD tail), and real-caption counts, from a seed."""
    rng = np.random.default_rng(seed)
    caps = rng.integers(3, 90, size=(n, s, length)).astype(np.int32)
    words = rng.integers(1, length - 2, size=(n, s))
    col = np.arange(length)[None, None, :]
    caps[col > words[..., None] + 1] = 0
    caps[..., 0] = 1
    np.put_along_axis(caps, words[..., None] + 1, 2, axis=-1)
    return caps, rng.integers(1, s + 1, size=n).astype(np.int32)


@pytest.mark.parametrize("seed,videos", [
    (0, list(range(40))), (1, [0, 3, 3, 7, 11, 59]), (2, []),
], ids=["train-split", "repeated-video", "empty"])
def test_df_table_native_equals_numpy_and_jax_bit_for_bit(seed, videos):
    """The native builder's sorted (h1, h2, df) is the port's numpy table
    (`_df_table`, keys h1 << 32 | h2) bit for bit, and the reward tables
    are the JAX package's."""
    caps, ncaps = seeded_caps(seed)
    keys, df = t_cd._df_table(caps, ncaps, videos)
    h1, h2, df_native = native.build_df(caps, ncaps, videos)
    np.testing.assert_array_equal((h1.astype(np.uint64) << np.uint64(32)) | h2, keys)
    np.testing.assert_array_equal(df_native.view(np.uint32), df.view(np.uint32))
    assert keys.dtype == np.uint64 and df.dtype == np.float32
    t = t_cd.host_tables(caps, ncaps, videos)
    jt = j_cd.build_reward_tables(caps, ncaps, videos)
    np.testing.assert_array_equal(t.table_rows.numpy(), np.asarray(jt.table_rows).astype(np.int64))
    np.testing.assert_array_equal(t.table_dir.numpy(), np.asarray(jt.table_dir))
    assert (t.dir_bits, t.bucket_steps) == (jt.dir_bits, jt.bucket_steps)


def test_native_cider_d_matches_the_device_reward():
    """The native batch CIDEr-D on token ids against `cider_d_device` on the
    CPU over the same tables (`tests/test_native.py`'s bar: rtol 1e-4,
    atol 1e-5): half the candidates a reference of their own video."""
    import torch

    caps, ncaps = seeded_caps(3, n=24)
    n = caps.shape[0]
    tables = t_cd.build_reward_tables(caps, ncaps, list(range(n)), device="cpu")
    rng = np.random.default_rng(4)
    cands = np.zeros((n, 14), np.int32)
    for v in range(n):
        if v % 2 == 0:
            cands[v, :13] = caps[v, 0, 1:]
        else:
            k = int(rng.integers(2, 9))
            cands[v, :k] = rng.integers(4, 30, k)
            cands[v, k] = 2
    want = t_cd.cider_d_device(tables, torch.from_numpy(cands), torch.arange(n)).numpy()
    rows = tables.table_rows.numpy().astype(np.uint32)
    got = native.cider_d(cands, np.arange(n, dtype=np.int32), caps, ncaps, rows[:, 0], rows[:, 1],
                         rows[:, 2].view(np.float32), float(tables.log_n))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert (want[::2] > 0).all()


BUILD = """
import sys
from controllable_xgating_torch.utils import native
native.build_dir = lambda: sys.argv[1]
print(native.available(), native.library_path())
"""


def test_two_processes_building_at_once_both_load(tmp_path):
    """Two interpreters build the library into an empty directory at the
    same moment: one compiles under the lock, the other waits and loads
    the same file; no temporary file is left."""
    out = str(tmp_path / "native")
    env = {**os.environ, "PYTHONPATH": ROOT}
    procs = [subprocess.Popen([sys.executable, "-c", BUILD, out], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    results = [p.communicate(timeout=600) for p in procs]
    lines = [r[0].strip().splitlines()[-1] for r in results]
    assert all(p.returncode == 0 for p in procs), results
    assert lines[0] == lines[1] and lines[0].startswith("True "), lines
    assert sorted(os.listdir(out)) == [".lock", os.path.basename(lines[0].split()[1])]
