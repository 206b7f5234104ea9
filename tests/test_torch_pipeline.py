"""The port's own user path end to end on the CPU, in a fresh interpreter:
`cli.prepro --fixtures` -> `cli.train` (pos, then caption from it, tiny)
-> `cli.eval` -> `cli.caption` free and with tags ->
`tools.controllability_eval` -> `cli.score --bootstrap`, with no module
of jax, flax, optax, orbax, h5py, the JAX package or the repo's root
`tools` / `experiments` / `bench` imported at any point."""

import json
import math
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import contextlib, io, json, os, sys
from controllable_xgating_torch.cli import caption, eval as cli_eval, prepro, score, train
from controllable_xgating_torch.tools import controllability_eval

D = sys.argv[1]
SMALL = ["--model.hidden_dim", "20", "--model.embed_dim", "12", "--model.attn_dim", "12",
         "--model.pos_embed_dim", "12", "--model.num_frames", "5", "--model.dropout", "0.0",
         "--data.batch_size", "4", "--data.caps_per_video_train", "2",
         "--eval.max_decode_len", "12", "--train.log_every_steps", "1"]
DEV = ["--device", "cpu"]

def run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()

out = {}
out["prepro"] = json.loads(run(prepro.main, [
    "--out", D, "--fixtures", "--fixture_videos", "16", "--fixture_frames", "5",
    "--fixture_app_dim", "18", "--fixture_motion_dim", "10", "--max_caption_len", "12",
    "--seqs_per_video", "5"]))
data = ["--data_dir", D, "--checkpoint_dir", D + "/ck"]
run(train.main, [*data, "--stage", "pos", "--epochs", "2", *SMALL, *DEV])
run(train.main, [*data, "--stage", "caption", "--epochs", "2", "--init_from", D + "/ck/pos",
                 *SMALL, *DEV])
out["log"] = [json.loads(l) for l in open(D + "/ck/caption/train_log.jsonl")]
ck = ["--data_dir", D, "--checkpoint_dir", D + "/ck/caption"]
ev = run(cli_eval.main, [*ck, "--beam_size", "3", "--out", D + "/eval.json", *SMALL, *DEV])
out["eval"] = json.JSONDecoder().raw_decode(ev[ev.index("{"):])[0]
out["caption"] = [json.loads(l) for l in run(caption.main, [
    *ck, "--video", "video12", *SMALL, *DEV]).splitlines() if l.startswith("{")]
out["caption"] += [json.loads(l) for l in run(caption.main, [
    *ck, "--video", "video12", "--pos_tags", "DT NN VBZ VBG NN", *SMALL, *DEV]).splitlines()
    if l.startswith("{")]
out["study"] = json.loads(run(controllability_eval.main, [
    *ck, "--templates", "EX VBZ DT NN VBG NN;DT NN VBZ NN", *SMALL, *DEV]))
out["score"] = json.loads(run(score.main, [
    "--candidates", D + "/eval.json", "--data_dir", D, "--split", "test", "--per_video",
    D + "/per.json", "--bootstrap", "20"]))
banned = ("jax", "jaxlib", "flax", "optax", "orbax", "h5py", "controllable_xgating_tpu",
          "experiments", "tools", "bench")
out["banned"] = sorted({m.split(".")[0] for m in sys.modules} & set(banned))
print(json.dumps(out))
"""


def test_port_pipeline_end_to_end_without_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path / "corpus")], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.splitlines()[-1])
    assert out["banned"] == []
    assert out["prepro"]["videos"] == 16 and out["prepro"]["pos_vocab_size"] == 35
    assert not os.path.exists(tmp_path / "corpus" / "features.h5")
    losses = [e["loss"] for e in out["log"] if "loss" in e]
    assert losses and all(map(math.isfinite, losses))
    assert out["eval"]["beam_size"] == 3 and set(out["eval"]["metrics"]) >= {"CIDEr", "Bleu_4"}
    free, ctrl = out["caption"]
    assert free["video"] == ctrl["video"] == "video12" and not free["controlled"]
    assert ctrl["controlled"] and ctrl["pos_sequence"] == "DT NN VBZ VBG NN"
    study = out["study"]["per_template"]
    assert [s["template"] for s in study] == ["EX VBZ DT NN VBG NN", "DT NN VBZ NN"]
    assert all(s["videos"] == 3 and len(s["captions"]) == 3 for s in study)
    score = out["score"]
    assert score["n_scored"] == 3 and score["bootstrap"]["n"] == 20
    assert set(score["bootstrap"]["ci95"]) == set(score["metrics"])
    # the scorer on the eval's captions gives the eval's metrics
    assert score["metrics"].keys() == out["eval"]["metrics"].keys()
    for k, v in out["eval"]["metrics"].items():
        assert math.isclose(score["metrics"][k], v, rel_tol=1e-12, abs_tol=1e-15), k
