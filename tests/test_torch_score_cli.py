"""The port's standalone scorer (`controllable_xgating_torch/cli/score.py`,
`metrics/bootstrap.py`) against the JAX package's: every case of
`tests/test_score_cli.py` on the port, and the JSON the two CLIs print
equal for each input shape, `--per_video`, `--oracle`, `--bootstrap N
--seed s` (the same draws), `--compare`, retokenization and METEOR's
synonym table. Floats are held to rel 1e-12 (the port's pure-Python
scorers against the JAX package's, which may take its native library:
another summation order at most); everything else exactly."""

import json
import math

import pytest

from controllable_xgating_tpu.cli import score as j_score
from controllable_xgating_torch.cli import prepro as t_prepro
from controllable_xgating_torch.cli import score as t_score
from controllable_xgating_torch.metrics.harness import language_eval

REL = 1e-12


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("score_corpus"))
    t_prepro.main([
        "--out", d, "--fixtures", "--fixture_videos", "12",
        "--fixture_frames", "4", "--fixture_app_dim", "8",
        "--fixture_motion_dim", "6", "--max_caption_len", "12",
        "--seqs_per_video", "4",
    ])
    return d


@pytest.fixture(scope="module")
def gts(corpus_dir):
    return t_score.load_corpus_references(corpus_dir, "test")


def assert_close(got, want, path="$"):
    if isinstance(want, float) or isinstance(got, float):
        assert math.isclose(got, want, rel_tol=REL, abs_tol=0.0), (path, got, want)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), (path, got, want)
        for k in want:
            assert_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)


def run(main, argv, capsys):
    capsys.readouterr()
    main(argv)
    return json.loads(capsys.readouterr().out)


def both(argv, capsys):
    """The port's JSON, held equal to the JAX CLI's on the same argv."""
    got = run(t_score.main, argv, capsys)
    assert_close(got, run(j_score.main, argv, capsys))
    return got


def dump(obj, path) -> str:
    with open(path, "w") as f:
        json.dump(obj, f)
    return str(path)


def test_self_score_is_perfect_bleu1(corpus_dir, gts, tmp_path, capsys):
    cpath = dump({k: v[0] for k, v in gts.items()}, tmp_path / "cand.json")
    out = both(["--candidates", cpath, "--data_dir", corpus_dir, "--split", "test"], capsys)
    assert out["n_scored"] == len(gts)
    m = out["metrics"]
    assert m["Bleu_1"] == pytest.approx(1.0)
    assert set(m) == {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr",
                      "CIDErD"}
    assert m["CIDEr"] > 1.0


def test_input_shapes_agree(corpus_dir, gts, tmp_path, capsys):
    """dict-of-str, dict-of-list, COCO list, eval-output and n-best shapes
    give the same metrics, each equal to the JAX CLI's; a references file
    equals the corpus references."""
    cand = {k: v[0] for k, v in gts.items()}
    shapes = {
        "plain": cand,
        "lists": {k: [v] for k, v in cand.items()},
        "coco": [{"image_id": k, "caption": v} for k, v in cand.items()],
        "evalout": {"metrics": {}, "split": "test", "captions": cand},
        "nbest": {"captions": {k: [{"caption": v, "score": -1.0},
                                   {"caption": "zzz", "score": -2.0}] for k, v in cand.items()}},
    }
    outs = {}
    for name, obj in shapes.items():
        path = dump(obj, tmp_path / f"{name}.json")
        outs[name] = both(["--candidates", path, "--data_dir", corpus_dir, "--split", "test",
                           "--metrics", "Bleu_4,CIDEr"], capsys)["metrics"]
    assert all(o == outs["plain"] for o in outs.values())
    assert set(outs["plain"]) == {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "CIDEr", "CIDErD"}
    rpath = dump(gts, tmp_path / "refs.json")
    from_file = both(["--candidates", str(tmp_path / "plain.json"), "--references", rpath,
                      "--retokenize", "no", "--metrics", "Bleu_4,CIDEr"], capsys)["metrics"]
    assert from_file == outs["plain"]


def test_bad_candidate_shapes(tmp_path):
    for obj, match in (({"v0": ["a", "b"]}, "exactly one candidate"),
                       ([{"image_id": "v0", "caption": "a"}, {"image_id": "v0", "caption": "b"}],
                        "duplicate"),
                       ("just a string", "expected a JSON object")):
        path = dump(obj, tmp_path / "bad.json")
        for mod in (t_score, j_score):
            with pytest.raises(ValueError, match=match):
                mod.load_candidates(path)


def test_retokenize_auto_normalizes_raw_text(tmp_path, capsys):
    cpath = dump({"v0": "A man, plays GUITAR.", "v1": "The dog (a puppy) can't run!"},
                 tmp_path / "c.json")
    rpath = dump({"v0": ["a man plays guitar"], "v1": "the dog can not run"},
                 tmp_path / "r.json")
    out = both(["--candidates", cpath, "--references", rpath, "--metrics", "Bleu_4"], capsys)
    forced = both(["--candidates", cpath, "--references", rpath, "--metrics", "Bleu_4",
                   "--retokenize", "no"], capsys)
    assert forced["metrics"]["Bleu_1"] < out["metrics"]["Bleu_1"]
    one = dump({"v0": "A man, plays GUITAR."}, tmp_path / "one.json")
    out = both(["--candidates", one, "--references", rpath, "--metrics", "Bleu_4"], capsys)
    assert out["metrics"]["Bleu_1"] == pytest.approx(1.0)


def test_missing_reference_errors(corpus_dir, tmp_path, capsys):
    cpath = dump({"no_such_video": "a man plays guitar"}, tmp_path / "c.json")
    for main in (t_score.main, j_score.main):
        with pytest.raises(SystemExit, match="no references"):
            main(["--candidates", cpath, "--data_dir", corpus_dir, "--split", "test"])
    with pytest.raises(SystemExit):  # usage: both reference sources
        t_score.main(["--candidates", cpath, "--data_dir", corpus_dir, "--references", cpath])
    with pytest.raises(SystemExit):  # usage: --split without --data_dir
        t_score.main(["--candidates", cpath, "--references", cpath, "--split", "test"])
    capsys.readouterr()


def test_per_video_scores(corpus_dir, gts, tmp_path, capsys):
    keys = sorted(gts)
    cand = {k: gts[k][0] for k in keys}
    cand[keys[0]] = gts[keys[1]][0]  # one deliberately wrong caption
    cpath = dump(cand, tmp_path / "c.json")
    paths = [str(tmp_path / "per_t.json"), str(tmp_path / "per_j.json")]
    out = run(t_score.main, ["--candidates", cpath, "--data_dir", corpus_dir, "--split", "test",
                             "--per_video", paths[0], "--out", str(tmp_path / "o.json")], capsys)
    want = run(j_score.main, ["--candidates", cpath, "--data_dir", corpus_dir, "--split", "test",
                              "--per_video", paths[1]], capsys)
    assert_close(out, want)
    detail, j_detail = (json.load(open(p)) for p in paths)
    assert_close(detail, j_detail)
    assert json.load(open(tmp_path / "o.json")) == out
    assert set(detail) == set(gts)
    mean_cider = sum(d["CIDEr"] for d in detail.values()) / len(detail)
    assert mean_cider == pytest.approx(out["metrics"]["CIDEr"], abs=1e-9)
    assert detail[keys[0]]["CIDEr"] < min(detail[k]["CIDEr"] for k in keys[1:])
    res = {k: [v] for k, v in cand.items()}
    lib, lib_detail = language_eval({k: gts[k] for k in res}, res, per_key=True)
    assert lib == out["metrics"] and lib_detail == detail


def test_coco_annotation_references(tmp_path, capsys):
    rpath = dump({"annotations": [
        {"image_id": "v0", "caption": "a man plays guitar"},
        {"image_id": "v0", "caption": "a person plays an instrument"},
        {"image_id": "v1", "caption": "a dog runs"},
    ]}, tmp_path / "r.json")
    cpath = dump({"v0": "a man plays guitar", "v1": "a dog runs"}, tmp_path / "c.json")
    out = both(["--candidates", cpath, "--references", rpath, "--metrics", "Bleu_4"], capsys)
    assert out["n_scored"] == 2 and out["metrics"]["Bleu_1"] == pytest.approx(1.0)


def test_oracle_over_nbest(corpus_dir, gts, tmp_path, capsys):
    keys = sorted(gts)
    lists = {k: [{"caption": "zzz " + gts[k][0], "score": -1.0},
                 {"caption": gts[k][0], "score": -2.0},
                 {"caption": gts[keys[0]][0], "score": -3.0}] for k in keys}
    cpath = dump({"split": "test", "captions": lists}, tmp_path / "nb.json")
    out = both(["--candidates", cpath, "--data_dir", corpus_dir, "--split", "test",
                "--oracle", "3", "--oracle_metric", "cider-d"], capsys)
    assert out["oracle"]["n"] == 3 and out["oracle"]["metric"] == "CIDErD"
    assert out["oracle"]["metrics"]["CIDErD"] > out["metrics"]["CIDErD"]
    for argv in (["--oracle", "4"], ["--oracle", "2", "--oracle_metric", "nope"]):
        with pytest.raises(SystemExit):
            t_score.main(["--candidates", cpath, "--data_dir", corpus_dir, *argv])
    plain = dump({k: gts[k][0] for k in keys}, tmp_path / "plain.json")
    with pytest.raises(SystemExit):
        t_score.main(["--candidates", plain, "--data_dir", corpus_dir, "--oracle", "2"])
    assert t_score.load_nbest_lists(plain) is None
    capsys.readouterr()


@pytest.mark.parametrize("seed", [0, 5])
def test_bootstrap_ci_and_paired_compare(corpus_dir, tmp_path, capsys, seed):
    """The whole corpus (12 videos): intervals bracket the point estimate,
    an identical comparison gives delta 0 and p ~1, a uniformly worse one
    a positive delta and the smoothed p 2/(n+1); each JSON equal to the
    JAX CLI's (the same `default_rng(seed)` draws)."""
    gts = t_score.load_corpus_references(corpus_dir, None)
    cand = {k: v[0] for k, v in gts.items()}
    cpath = dump(cand, tmp_path / "cand.json")
    base = ["--candidates", cpath, "--data_dir", corpus_dir, "--seed", str(seed)]
    out = both(base + ["--bootstrap", "60", "--metrics", "CIDEr"], capsys)
    bs = out["bootstrap"]
    assert bs["n"] == 60 and bs["seed"] == seed
    lo, hi = bs["ci95"]["CIDEr"]
    assert lo <= out["metrics"]["CIDEr"] <= hi and lo < hi

    out = both(base + ["--bootstrap", "40", "--compare", cpath, "--metrics", "CIDEr"], capsys)
    d = out["compare"]["delta"]["CIDEr"]
    assert d["mean"] == 0.0 and d["ci95"] == [0.0, 0.0]
    assert d["p_value"] == pytest.approx(1.0, abs=0.05)

    wpath = dump({k: "zzz qqq xxx" for k in cand}, tmp_path / "worse.json")
    out = both(base + ["--bootstrap", "40", "--compare", wpath], capsys)
    d = out["compare"]["delta"]["CIDEr"]
    assert d["mean"] > 0 and d["ci95"][0] > 0
    assert d["p_value"] == pytest.approx(2.0 / 41.0, abs=1e-6)
    assert out["compare"]["metrics"]["CIDEr"] == pytest.approx(0.0, abs=1e-9)
    assert set(out["bootstrap"]["ci95"]) == set(out["metrics"])

    ppath = dump(dict(list(cand.items())[:-1]), tmp_path / "partial.json")
    with pytest.raises(SystemExit, match="same video ids"):
        t_score.main(base + ["--bootstrap", "5", "--compare", ppath])
    with pytest.raises(SystemExit):
        t_score.main(base + ["--compare", cpath])


def bootstrap_inputs(corpus_dir):
    gts = t_score.load_corpus_references(corpus_dir, None)
    keys = sorted(gts)
    res = {k: [gts[k][0]] for k in keys}
    res[keys[0]] = [""]  # empty candidate: zero norms, zero BLEU length
    res[keys[1]] = ["zebra qqq " + gts[keys[1]][0]]  # ref-unseen n-grams
    res2 = {k: [gts[k][-1]] for k in keys}
    return gts, res, res2


@pytest.mark.parametrize("metrics", [None, ("CIDEr",), ("Bleu_4", "ROUGE_L"), "CIDErD", "METEOR"])
def test_fast_bootstrap_matches_direct_path_and_jax(corpus_dir, metrics):
    """The port's fast bootstrap gives the direct path's per-resample
    metrics (rel 1e-9: summation order) and the JAX package's fast rows
    (rel 1e-12), on the same draws."""
    gts, res, res2 = bootstrap_inputs(corpus_dir)
    fast, fast2 = t_score.bootstrap_metrics(gts, res, res2, 25, 7, metrics, fast=True)
    slow, slow2 = t_score.bootstrap_metrics(gts, res, res2, 25, 7, metrics, fast=False)
    jax, jax2 = j_score.bootstrap_metrics(gts, res, res2, 25, 7, metrics, fast=True)
    assert len(fast) == len(slow) == 25
    for fa, sl in list(zip(fast, slow)) + list(zip(fast2, slow2)):
        assert set(fa) == set(sl)
        for m in sl:
            assert fa[m] == pytest.approx(sl[m], rel=1e-9, abs=1e-12), m
    assert_close(fast, jax)
    assert_close(fast2, jax2)


def test_bootstrap_of_nothing_is_zero():
    from controllable_xgating_torch.metrics.bootstrap import FastPairedBootstrap

    gts = {"a": ["a man runs"], "b": ["a dog runs"]}
    fb = FastPairedBootstrap(gts, {k: ["a man runs"] for k in gts})
    row, row2 = fb.resample([])
    assert row2 is None and set(row.values()) == {0.0} and len(row) == 8


def test_meteor_synonyms(corpus_dir, gts, tmp_path, capsys):
    keys = sorted(gts)
    cand = {k: gts[k][0].replace("man", "guy").replace("plays", "performs") for k in keys}
    cpath = dump(cand, tmp_path / "c.json")
    syn = tmp_path / "syn.txt"
    syn.write_text("man guy fellow\nplays performs\n")
    base = ["--candidates", cpath, "--data_dir", corpus_dir, "--split", "test",
            "--metrics", "METEOR"]
    plain = both(base, capsys)
    with_syn = both(base + ["--meteor_synonyms", str(syn), "--bootstrap", "20"], capsys)
    assert with_syn["metrics"]["METEOR"] >= plain["metrics"]["METEOR"]
