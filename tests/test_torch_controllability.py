"""The port's controllability study (`controllable_xgating_torch/tools/
controllability_eval.py`) and style readout (`tools/style_accuracy.py`)
against the JAX package's tools, on the CPU.

The checkpoint is trained by the JAX train CLI (joint XE, a few epochs on
a `syntax` fixture corpus at small widths) and bridged to the port as
`tests/test_torch_cli.py` bridges its fixture (numpy -> `bridge.from_numpy`
-> the port's `CheckpointManager`). Both tools decode the test split free
and under each template: the captions must be equal and the agreements of
both modes equal (exactly: they are computed from equal strings by equal
taggers). `--rescore_captions` is held equal on the port's capture.
"""

import json
import os

import pytest
import torch

from controllable_xgating_tpu.cli import prepro as j_prepro
from controllable_xgating_tpu.cli import train as j_train
from controllable_xgating_torch.data import features as t_features
from controllable_xgating_torch.data.postag import PennTagger
from controllable_xgating_torch.tools import controllability_eval as t_ce
from controllable_xgating_torch.tools import style_accuracy as t_style
from test_torch_cli import JAX_FLAGS, bridge_checkpoint, run_cli
from tools import controllability_eval as j_ce
from tools import style_accuracy as j_style

torch.set_num_threads(1)
SMALL = [
    "--model.hidden_dim", "24", "--model.embed_dim", "16", "--model.attn_dim", "16",
    "--model.pos_embed_dim", "16", "--model.num_frames", "5", "--model.dropout", "0.0",
    "--data.batch_size", "8", "--data.caps_per_video_train", "3",
    "--eval.max_decode_len", "12",
]
# 7 steps an epoch at a constant rate, val eval every 6 epochs
TRAIN = ["--data.batch_size", "4", "--train.lr", "1e-2", "--train.lr_decay_every_epochs", "100",
         "--train.eval_every_epochs", "6", "--train.log_every_steps", "1000"]
TEMPLATES = "EX VBZ DT NN VBG NN;DT NN VBZ NN;DT JJ NN VBZ VBG"


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(data_dir, JAX checkpoint dir, port checkpoint dir) of a JAX-trained
    joint checkpoint."""
    from controllable_xgating_tpu.cli import common as j_common

    root = str(tmp_path_factory.mktemp("study"))
    data = os.path.join(root, "corpus")
    run_cli(j_prepro.main, [
        "--out", data, "--fixtures", "--fixture_videos", "40", "--fixture_frames", "5",
        "--fixture_app_dim", "16", "--fixture_motion_dim", "12", "--fixture_feature_map",
        "syntax", "--max_caption_len", "12", "--seqs_per_video", "4"])
    t_features.main([data])
    ck = os.path.join(root, "ck_jax")
    run_cli(j_train.main, ["--data_dir", data, "--checkpoint_dir", ck, "--stage", "joint",
                           "--epochs", "24", "--platform", "cpu", *SMALL, *TRAIN, *JAX_FLAGS])
    jdir, tdir = os.path.join(ck, "joint"), os.path.join(root, "ck_torch")
    _, cfg = j_common.parse_with_overrides(j_common.base_parser("study"),
                                           ["--data_dir", data, *SMALL])
    _, _, _, cfg = j_common.load_corpus(data, cfg)
    bridge_checkpoint(jdir, tdir, cfg)
    return data, jdir, tdir


def study(main, argv) -> dict:
    return json.loads(run_cli(main, argv))


@pytest.mark.parametrize("case", ["single", "single_lcs", "templates"])
def test_study_equals_jax(trained, case):
    data, jdir, tdir = trained
    extra = {"single": ["--template", "DT NN VBZ VBG IN DT NN"],
             "single_lcs": ["--template", "DT NN VBZ NN", "--agreement", "lcs",
                            "--split", "val", "--batch_size", "3"],
             "templates": ["--templates", TEMPLATES]}[case]
    got = study(t_ce.main, ["--data_dir", data, "--checkpoint_dir", tdir, "--device", "cpu",
                            *extra, *SMALL])
    want = study(j_ce.main, ["--data_dir", data, "--checkpoint_dir", jdir, "--platform", "cpu",
                             *extra, *SMALL])
    assert got == want
    results = got["per_template"] if case == "templates" else [got]
    assert len(results) == (3 if case == "templates" else 1)
    for r in results:
        assert r["videos"] == 6
        assert all(c["free"] and c["controlled"] for c in r["captions"])


def test_rescore_captions_equals_jax(trained, tmp_path):
    data, _, tdir = trained
    capture = study(t_ce.main, ["--data_dir", data, "--checkpoint_dir", tdir, "--device", "cpu",
                                "--template", "DT NN VBZ VBG NN", *SMALL])
    path = tmp_path / "capture.json"
    path.write_text(json.dumps(capture))
    for mode in ("position", "lcs"):
        argv = ["--rescore_captions", str(path), "--agreement", mode]
        got, want = study(t_ce.main, argv), study(j_ce.main, argv)
        assert got == want and got["agreement_by_mode"] == capture["agreement_by_mode"]
    old = tmp_path / "old.json"
    old.write_text(json.dumps({"template": "DT NN", "examples": capture["captions"][:1]}))
    with pytest.raises(SystemExit, match="no 'captions' dump"):
        t_ce.main(["--rescore_captions", str(old)])


def test_tag_agreement_modes():
    t = PennTagger()
    tmpl = "DT NN VBZ VBG IN DT NN".split()
    exact = "a man is playing in the park"
    shifted = "a young man is playing in the park"  # one JJ insertion
    assert t_ce.tag_agreement(exact, tmpl, t) == 1.0
    assert t_ce.tag_agreement(exact, tmpl, t, "lcs") == 1.0
    assert t_ce.tag_agreement(shifted, tmpl, t) < 0.2
    assert t_ce.tag_agreement(shifted, tmpl, t, "lcs") > 0.8
    assert t_ce.tag_agreement("", tmpl, t, "lcs") == 0.0
    for cap in (exact, shifted, "there is a dog running", "a cat", ""):
        for mode in ("position", "lcs"):
            assert t_ce.tag_agreement(cap, tmpl, t, mode) == j_ce.tag_agreement(cap, tmpl, t, mode)


def test_summary_carries_both_modes():
    tmpl = "DT NN VBZ VBG IN DT NN".split()
    caps = [{"free": "a man is playing in the park", "controlled": "a man is playing in the park"},
            {"free": "a cat rides a horse", "controlled": "a young man is playing in the park"}]
    s = t_ce._summarize(caps, tmpl, PennTagger(), "position")
    assert s == j_ce._summarize(caps, tmpl, PennTagger(), "position")
    assert s["videos"] == 2 and s["captions"] == caps and s["examples"] == caps[:2]
    for side in ("free_run_tag_agreement", "controlled_tag_agreement"):
        assert s["agreement_by_mode"]["lcs"][side] >= s["agreement_by_mode"]["position"][side]


def test_study_needs_a_card_or_device_cpu(trained, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda runs")
    data, _, tdir = trained
    with pytest.raises(SystemExit) as e:
        t_ce.main(["--data_dir", data, "--checkpoint_dir", tdir, *SMALL])
    assert e.value.code != 0 and "--device cpu" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="--data_dir and --checkpoint_dir"):
        t_ce.main(["--device", "cpu"])


def test_style_accuracy_equals_jax(trained, tmp_path, capsys):
    """The style readout of a captions file (the study's controlled
    captions, as an eval output) against the JAX tool's."""
    data, _, tdir = trained
    capture = study(t_ce.main, ["--data_dir", data, "--checkpoint_dir", tdir, "--device", "cpu",
                                "--template", "DT NN VBZ NN", *SMALL])
    cands = tmp_path / "cands.json"
    cands.write_text(json.dumps({"captions": {c["video_id"]: c["controlled"]
                                              for c in capture["captions"]}}))
    free = tmp_path / "free.json"
    free.write_text(json.dumps({c["video_id"]: c["free"] for c in capture["captions"]}))
    meta = os.path.join(data, "fixture_meta.json")
    argv = ["--candidates", f"ctrl={cands}", str(free), "--meta", meta,
            "--out", str(tmp_path / "style.json")]
    got = study(t_style.main, argv)
    assert got == study(j_style.main, argv)
    assert set(got) == {"ctrl", "free.json"} and got["ctrl"]["n"] == 6
    assert json.loads((tmp_path / "style.json").read_text()) == got
    for cap, want in (("a man plays guitar", 1), ("a man is playing guitar", 0),
                      ("a man", None), ("a man is playing and plays", None)):
        assert t_style.classify(cap) == want == j_style.classify(cap)
    linear = tmp_path / "meta.json"
    linear.write_text(json.dumps({"videos": {"video0": {"subject": 0}}}))
    with pytest.raises(SystemExit):
        t_style.main(["--candidates", str(free), "--meta", str(linear)])
    capsys.readouterr()
