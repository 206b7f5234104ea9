"""The port's study tools vs the JAX package's, on the CPU.

- `tools/ablation_grid.py`: with `run` stubbed on both sides (the stub
  writes what each stage would), every cell issues the JAX tool's
  commands, up to module names and `--platform` -> `--device`, and the
  results are equal; one real smoke run of two cells through the port's
  CLIs (subprocesses on the CPU), whose results are finite and equal to
  what the JAX tool assembles from the same files (its stages find their
  markers and skip). The four-cell run is marked slow.
- `tools/ablation_report.py`, `tools/grid_subset_report.py` and
  `tools/style_template_analysis.py` on the same input files as the JAX
  tools: the same output (their numbers are rounded to 4 decimals, the
  underlying statistics equal to rel 1e-12); `tools/meteor_sensitivity.py`
  on the fixtures: the same report (rel 1e-9).

`tools/psi_diversity.py` is held in `tests/test_torch_checkpoint_tools.py`,
on its bridged checkpoint.
"""

import contextlib
import io
import json
import math
import os
import shutil

import numpy as np
import pytest

from controllable_xgating_torch.cli import prepro as t_prepro
from controllable_xgating_torch.data.fixtures import make_fixture_corpus
from controllable_xgating_torch.tools import ablation_grid as t_grid
from controllable_xgating_torch.tools import ablation_report as t_report
from controllable_xgating_torch.tools import grid_subset_report as t_subset
from controllable_xgating_torch.tools import meteor_sensitivity as t_meteor
from controllable_xgating_torch.tools import style_template_analysis as t_style
from tools import ablation_grid as j_grid
from tools import ablation_report as j_report
from tools import grid_subset_report as j_subset
from tools import meteor_sensitivity as j_meteor
from tools import style_template_analysis as j_style

CELLS = ("xgate_pos", "concat_pos", "xgate_nopos", "concat_nopos")


def run_cli(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def assert_close(got, want, rel):
    """Nested JSON values equal, floats within `rel`."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            assert_close(got[k], want[k], rel)
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_close(g, w, rel)
    elif isinstance(want, float):
        assert math.isclose(got, want, rel_tol=rel, abs_tol=0.0), (got, want)
    else:
        assert got == want


# --- the grid's commands, run stubbed ---

def stub_run(calls: list):
    """A `run` that records each command and writes what its stage would:
    an eval's eval_test.json, the controllability study's JSON."""

    def run(cmd, log_path, retries=1, capture_stdout=False):
        calls.append(list(cmd))
        n = len(calls)
        if "--split" in cmd:
            ck = cmd[cmd.index("--checkpoint_dir") + 1]
            os.makedirs(ck, exist_ok=True)
            with open(os.path.join(ck, "eval_test.json"), "w") as f:
                json.dump({"metrics": {"Bleu_4": n / 100, "CIDEr": n / 10, "CIDErD": n / 20}}, f)
        if capture_stdout:
            return json.dumps({"free_run_tag_agreement": 0.25, "controlled_tag_agreement": n / 40,
                               "videos": 9, "agreement_by_mode": {"lcs": {"x": n}}})
        return None

    return run


def normalize(cmd: list, pkg: str) -> tuple:
    """(stage module, arguments) of a command, `--platform` as `--device`."""
    if cmd[1] == "-m":
        module, args = cmd[2].replace(pkg + ".", ""), cmd[3:]
    else:  # the JAX grid runs its study as a script
        module, args = "tools." + os.path.basename(cmd[1])[:-3], cmd[2:]
    args = ["--device" if a == "--platform" else {"tpu": "cuda"}.get(a, a) for a in args]
    return module, args


@pytest.mark.parametrize("jax_args,port_args", [
    ([], []),
    (["--smoke"], ["--smoke"]),
    (["--recipe", "medium", "--platform", "tpu"], ["--recipe", "medium", "--device", "cuda"]),
    (["--smoke", "--platform", "cpu", "--cells", "concat_pos,xgate_nopos"],
     ["--smoke", "--device", "cpu", "--cells", "concat_pos,xgate_nopos"]),
], ids=["flagship", "smoke", "medium-device", "two-cells"])
def test_grid_commands_match_jax(tmp_path, monkeypatch, jax_args, port_args):
    results, commands = {}, {}
    for name, mod, args, pkg in (("jax", j_grid, jax_args, "controllable_xgating_tpu"),
                                 ("port", t_grid, port_args, "controllable_xgating_torch")):
        calls = []
        monkeypatch.setattr(mod, "run", stub_run(calls))
        monkeypatch.setattr(mod, "RECIPE", mod.RECIPE)  # main() rebinds it
        out = str(tmp_path / "grid")  # one path for both, emptied between
        run_cli(mod.main, ["--data_dir", "data/x", "--out", out, *args])
        with open(os.path.join(out, "grid_results.json")) as f:
            results[name] = json.load(f)
        commands[name] = [normalize(c, pkg) for c in calls]
        assert sorted(os.listdir(os.path.join(out, "concat_pos" if "--cells" in args
                                              else "xgate_pos"))) == [
            "caption", "caption.done", "controllability.json", "eval_caption.done",
            "eval_scst.done", "pos.done", "scst", "scst.done"]
        shutil.rmtree(out)
    assert commands["port"] == commands["jax"]
    assert results["port"] == results["jax"]
    assert len(results["port"]) == (2 if "--cells" in port_args else 4)


# --- one real smoke run of the grid ---

@pytest.fixture(scope="module")
def smoke_corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("grid_corpus"))
    run_cli(t_prepro.main, ["--out", d, "--fixtures", "--fixture_videos", "16",
                            "--fixture_frames", "5", "--fixture_app_dim", "12",
                            "--fixture_motion_dim", "8", "--max_caption_len", "12",
                            "--seqs_per_video", "4"])
    return d


def check_smoke_grid(data: str, out: str, cells: list) -> None:
    text = run_cli(t_grid.main, ["--data_dir", data, "--out", out, "--smoke",
                                 "--cells", ",".join(cells)])
    assert "[grid] ALL_DONE" in text
    with open(os.path.join(out, "grid_results.json")) as f:
        results = json.load(f)
    assert [f"{c['fusion']}_{'pos' if c['pos_guidance'] else 'nopos'}" for c in results] == cells
    for cell in results:
        for key in ("caption_metrics", "scst_metrics"):
            assert cell[key] and all(math.isfinite(v) for v in cell[key].values())
        ctrl = cell["controllability"]
        assert ctrl["videos"] > 0
        assert 0.0 <= ctrl["controlled_tag_agreement"] <= 1.0
        assert set(ctrl["agreement_by_mode"]) == {"position", "lcs"}
    # JAX's grid assembles the same cells from the same files: its stages
    # find their .done markers and its study its capture
    want = [j_grid.run_cell(data, out, c.split("_")[0], c.endswith("_pos")) for c in cells]
    assert results == want


def test_grid_smoke_run_two_cells(smoke_corpus, tmp_path):
    check_smoke_grid(smoke_corpus, str(tmp_path / "grid"), ["xgate_pos", "concat_nopos"])


@pytest.mark.slow  # 24 CLI processes on the CPU (~2 min)
def test_grid_smoke_run_four_cells(smoke_corpus, tmp_path):
    check_smoke_grid(smoke_corpus, str(tmp_path / "grid"), list(CELLS))


# --- reports on the same input files ---

@pytest.fixture(scope="module")
def study_inputs(tmp_path_factory):
    """A syntax-map corpus with corrupted videos (fixture_meta has both
    flags), candidate files for the four cells on its test split, and a
    grid_results.json."""
    root = tmp_path_factory.mktemp("reports")
    data = str(root / "corpus")
    make_fixture_corpus(data, num_videos=80, num_frames=4, app_dim=8, motion_dim=6,
                        caps_per_video=5, seqs_per_video=5, max_caption_len=16,
                        feature_map="syntax", corrupt_prob=0.4)
    from controllable_xgating_torch.cli.score import load_corpus_references

    gts = load_corpus_references(data, "test")
    rng = np.random.default_rng(3)
    grid, results, files = root / "grid", [], {}
    for i, cell in enumerate(CELLS):
        caps = {}
        for vid, refs in gts.items():
            words = refs[int(rng.integers(len(refs)))].split()
            keep = [w for w in words if rng.random() > 0.1 * i] or words[:1]
            caps[vid] = " ".join(keep)
        d = grid / cell / "scst"
        d.mkdir(parents=True)
        files[cell] = str(d / "eval_test.json")
        with open(files[cell], "w") as f:
            json.dump({"captions": caps, "metrics": {}}, f)
        fusion, psi = cell.split("_")
        ctrl = {"free_run_tag_agreement": 0.1 * i, "controlled_tag_agreement": 0.2 + 0.1 * i,
                "videos": len(gts)}
        if i % 2:
            ctrl["agreement_by_mode"] = {"lcs": {"free_run_tag_agreement": 0.3,
                                                 "controlled_tag_agreement": 0.5 + 0.01 * i}}
        results.append({"fusion": fusion, "pos_guidance": psi == "pos",
                        "caption_metrics": {"Bleu_4": 0.1 + i, "CIDEr": 0.5 * i},
                        "scst_metrics": {"Bleu_4": 0.2, "CIDEr": 0.7 + i, "CIDErD": 0.6},
                        "controllability": ctrl})
    with open(grid / "grid_results.json", "w") as f:
        json.dump(results, f)
    return data, str(grid), files, gts


def test_ablation_report_matches_jax(study_inputs):
    data, grid, _, _ = study_inputs
    argv = [os.path.join(grid, "grid_results.json"), "--data_dir", data, "--bootstrap", "200",
            "--seed", "4"]
    assert run_cli(t_report.main, argv) == run_cli(j_report.main, argv)
    for n, seed in ((100, 0), (57, 9)):
        assert_close(t_report.significance(grid, data, n, seed),
                     j_report.significance(grid, data, n, seed), 1e-12)
    sub = t_report.subset_breakdown(grid, data, list(CELLS))
    assert len(sub) == 4 and sub == j_report.subset_breakdown(grid, data, list(CELLS))
    with open(os.path.join(grid, "grid_results.json")) as f:
        results = json.load(f)
    assert t_report.render(results) == j_report.render(results)
    assert t_report.render(results[:1]) == j_report.render(results[:1])


@pytest.mark.parametrize("extra", [["--interaction"], ["--subset_key", "style",
                                                       "--pair", "xgate_pos:concat_pos"]],
                         ids=["corrupted", "style"])
def test_grid_subset_report_matches_jax(study_inputs, tmp_path, extra):
    data, _, files, _ = study_inputs
    cells = [f"--cell={c}={files[c]}" for c in CELLS]
    outs = {}
    for name, main in (("port", t_subset.main), ("jax", j_subset.main)):
        md = str(tmp_path / f"{name}.md")
        outs[name] = (run_cli(main, ["--data_dir", data, "--split", "test", *cells,
                                     "--bootstrap", "150", "--seed", "2", "--out", md, *extra]),
                      open(md).read())
    assert outs["port"] == outs["jax"]
    assert "Paired deltas" in outs["port"][0]


def test_subset_statistics_match_jax(study_inputs):
    data, _, files, gts = study_inputs
    from controllable_xgating_torch.cli.score import load_candidates

    a, b = load_candidates(files["xgate_pos"]), load_candidates(files["concat_nopos"])
    flags = t_subset.corrupted_flags(os.path.join(data, "fixture_meta.json"))
    assert flags == j_subset.corrupted_flags(os.path.join(data, "fixture_meta.json"))
    corr = [k for k in sorted(a) if flags[k]]
    clean = [k for k in sorted(a) if not flags[k]]
    assert corr and clean
    for metric in ("CIDEr", "Bleu_4"):
        assert_close(t_subset.paired_delta(gts, a, b, 120, 1, metric),
                     j_subset.paired_delta(gts, a, b, 120, 1, metric), 1e-12)
        assert_close(t_subset.interaction_delta(gts, a, b, corr, clean, 120, 1, metric),
                     j_subset.interaction_delta(gts, a, b, corr, clean, 120, 1, metric), 1e-12)


def test_style_template_analysis_matches_jax(study_inputs, tmp_path):
    data, _, files, gts = study_inputs
    with open(os.path.join(data, "fixture_meta.json")) as f:
        meta = json.load(f)["videos"]
    caps = json.load(open(files["xgate_pos"]))["captions"]
    free = json.load(open(files["concat_nopos"]))["captions"]
    studies = [{"template": t, "captions": [
        {"video_id": v, "free": free[v], "controlled": caps[v]} for v in sorted(caps)]}
        for t in ("DT NN VBZ VBG DT NN IN DT NN", "IN DT NN DT NN VBZ DT NN")]
    cap_path = tmp_path / "capture.json"
    cap_path.write_text(json.dumps({"per_template": studies}))
    argv = ["--capture", str(cap_path), "--meta", os.path.join(data, "fixture_meta.json"),
            "--out", str(tmp_path / "out.md")]
    got = run_cli(t_style.main, argv)
    assert got == run_cli(j_style.main, argv)
    rows = json.loads(got.splitlines()[-1])["rows"]
    assert {(r["template_style"], r["video_style"]) for r in rows} == {(0, 0), (0, 1), (1, 0),
                                                                       (1, 1)}
    assert sum(r["n"] for r in rows) == 2 * len(caps) and set(meta) >= set(caps)
    old = tmp_path / "old.json"
    old.write_text(json.dumps({"template": "DT NN", "captions": [{"free": "a",
                                                                  "controlled": "b"}]}))
    with pytest.raises(SystemExit):
        t_style.main(["--capture", str(old), "--meta", os.path.join(data, "fixture_meta.json")])


def test_meteor_sensitivity_matches_jax():
    argv = ["--videos", "60", "--seed", "3", "--drops", "4"]
    assert_close(json.loads(run_cli(t_meteor.main, argv)),
                 json.loads(run_cli(j_meteor.main, argv)), 1e-9)
    pairs = t_meteor.corpus_pairs(20, 1)
    assert pairs == j_meteor.corpus_pairs(20, 1)
    for kw in ({}, {"use_stem": False}, {"function_words": frozenset()}):
        assert math.isclose(t_meteor.corpus_score(pairs, **kw), j_meteor.corpus_score(pairs, **kw),
                            rel_tol=1e-9)
