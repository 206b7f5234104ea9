"""The ingest, checkpoint and study tools on the card, at small size.

Marked `gpu`: every test skips without a CUDA device. This file imports no
jax, so it also runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tools_gpu.py

- `tools/dress_rehearsal.py` at 400 videos (a vocabulary of ~2.7k words,
  over K5's V >= 2048 gate) and at its default scale (10000 videos x 20
  captions, MSR-VTT's splits and widths, batch 256) with its train stage
  on the card: K5 once in each XE step, K1-K3 in the greedy val eval, no
  K4, finite losses; at the default scale every caption converted and the
  loss falling over the epoch.
- a checkpoint through `tools/import_torch_checkpoint.py` (from a `.pth`
  with one entry transposed) and `tools/average_checkpoints.py` (with
  itself, weights 1,3), neither launching a kernel: the parameters equal
  the source's, and `cli.eval --beam_size 5` on the card gives the
  source's captions.
- `tools/ablation_grid.py`, cells concat_pos and xgate_nopos at the smoke
  recipe's widths on the card, each stage command run in this process
  with its launches counted: K1 never in concat_pos, K1-K3 in xgate_nopos
  (K2 too: the psi-free cell's POS rollout), K4 in the beam-5 evals;
  finite metrics and tag agreements in [0, 1] over every test video;
  `tools/ablation_report.py` on the results (no launch), then
  `tools/psi_diversity.py` on each cell's SCST checkpoint (K2, no K3).
"""

import contextlib
import importlib
import io
import json
import math
import os

import numpy as np
import pytest
import torch

from controllable_xgating_torch import bridge
from controllable_xgating_torch.cli import eval as cli_eval
from controllable_xgating_torch.cli import prepro as cli_prepro
from controllable_xgating_torch.cli.common import load_corpus, restore_params
from controllable_xgating_torch.models.captioner import init_captioner
from controllable_xgating_torch.ops import kernels
from controllable_xgating_torch.tools import ablation_grid
from controllable_xgating_torch.tools import ablation_report
from controllable_xgating_torch.tools import average_checkpoints
from controllable_xgating_torch.tools import dress_rehearsal
from controllable_xgating_torch.tools import import_torch_checkpoint
from controllable_xgating_torch.tools import psi_diversity
from controllable_xgating_torch.train.state import CheckpointManager, create_train_state
from controllable_xgating_torch.utils.config import load_config

pytestmark = pytest.mark.gpu
MODEL = ["--model.hidden_dim", "24", "--model.embed_dim", "16", "--model.attn_dim", "16",
         "--model.pos_embed_dim", "16", "--model.num_frames", "5"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def quiet(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def fixture_corpus(root: str) -> str:
    data = os.path.join(root, "corpus")
    quiet(cli_prepro.main, ["--out", data, "--fixtures", "--fixture_videos", "16",
                            "--fixture_frames", "5", "--fixture_app_dim", "12",
                            "--fixture_motion_dim", "8", "--max_caption_len", "12",
                            "--seqs_per_video", "4"])
    return data


@pytest.mark.parametrize("scale", ["400-videos", "default"])
def test_dress_rehearsal_trains_on_the_card(dev, tmp_path, scale):
    small = ["--videos", "400", "--app_dim", "64", "--motion_dim", "32",
             "--data.caps_per_video_train", "2", *MODEL[:8]]
    out = quiet(dress_rehearsal.main, ["--out", str(tmp_path), "--train.log_every_steps", "1",
                                       *(small if scale == "400-videos" else [])])
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    stages = {e["stage"]: e for e in lines if "stage" in e}
    info = json.loads((tmp_path / "info.json").read_text())
    assert len(info["vocab"]) >= 2048
    steps = -(-len(info["splits"]["train"]) // 256)
    got = stages["xe_epoch_plus_eval"]["launches"]
    assert got["xent_fwd"] == got["xent_bwd"] == steps
    assert got["xgate"] and got["pos_lstm"] and got["attn_lstm"] and not got["topk_tail"]
    with open(tmp_path / "ck" / "joint" / "train_log.jsonl") as f:
        losses = [e["loss"] for e in map(json.loads, f) if "loss" in e]
    assert len(losses) == steps and all(np.isfinite(losses))
    if scale == "default":
        converted = next(e for e in lines if "captions" in e and "splits" in e)
        assert converted["captions"] == 200000
        assert converted["splits"] == {"train": 6513, "val": 497, "test": 2990}
        assert losses[-1] < losses[0], losses


def test_imported_and_averaged_checkpoints_caption_like_the_source(dev, tmp_path):
    data = fixture_corpus(str(tmp_path))
    cfg = load_config(None, {a[2:]: b for a, b in zip(MODEL[::2], MODEL[1::2])})
    _, _, _, cfg = load_corpus(data, cfg)
    src = os.path.join(tmp_path, "src")
    CheckpointManager(src).save("best", create_train_state(
        init_captioner(cfg, seed=3, device="cpu"), cfg), {"epoch": 0, "config": cfg.to_dict()})
    flat = bridge.param_paths(restore_params(src, cfg, "cpu"))
    flip = next(n for n, a in flat if a.ndim == 2)
    sd = {n: torch.from_numpy(a.T.copy() if n == flip else a) for n, a in flat}
    mapping = {n: {"key": n, "transform": "transpose"} if n == flip else n for n, _ in flat}
    torch.save({"model": sd}, tmp_path / "ref.pth")
    (tmp_path / "mapping.json").write_text(json.dumps(mapping))
    kernels.reset_launch_counts()
    quiet(import_torch_checkpoint.main, ["--data_dir", data, "--pth", str(tmp_path / "ref.pth"),
                                         "--mapping", str(tmp_path / "mapping.json"),
                                         "--out", str(tmp_path / "imported"), *MODEL])
    quiet(average_checkpoints.main, ["--data_dir", data, "--inputs", src, src, "--weights", "1,3",
                                     "--out", str(tmp_path / "averaged")])
    assert not any(kernels.launch_counts().values())
    want = dict(restore_params(src, cfg, "cpu").named_parameters())
    caps = {}
    for name in ("src", "imported", "averaged"):
        ck = os.path.join(tmp_path, name)
        got = dict(restore_params(ck, cfg, "cpu").named_parameters())
        assert all(torch.equal(got[n], want[n]) for n in want), name
        kernels.reset_launch_counts()
        js = os.path.join(tmp_path, f"{name}.json")
        quiet(cli_eval.main, ["--data_dir", data, "--checkpoint_dir", ck, "--beam_size", "5",
                              "--out", js, "--eval.max_decode_len", "12", *MODEL])
        assert kernels.launch_counts()["topk_tail"]
        caps[name] = json.loads(open(js).read())["captions"]
    assert caps["imported"] == caps["src"] == caps["averaged"]


def test_grid_cells_launch_their_kernels(dev, tmp_path, monkeypatch):
    data = fixture_corpus(str(tmp_path))
    launches = {}

    def run(cmd, log_path, retries=1, capture_stdout=False):
        kernels.reset_launch_counts()
        text = quiet(importlib.import_module(cmd[2]).main, cmd[3:])
        torch.cuda.synchronize()
        cell = os.path.basename(os.path.dirname(log_path))
        launches.setdefault(cell, []).append((cmd[2], kernels.launch_counts()))
        return text if capture_stdout else None

    monkeypatch.setattr(ablation_grid, "run", run)
    monkeypatch.setattr(ablation_grid, "RECIPE", ablation_grid.RECIPE)
    quiet(ablation_grid.main, ["--data_dir", data, "--out", str(tmp_path / "grid"), "--smoke",
                               "--device", "cuda", "--cells", "concat_pos,xgate_nopos"])
    results = json.loads((tmp_path / "grid" / "grid_results.json").read_text())
    assert [(c["fusion"], c["pos_guidance"]) for c in results] == [("concat", True),
                                                                    ("xgate", False)]
    n_test = len(json.loads(open(os.path.join(data, "info.json")).read())["splits"]["test"])
    for c in results:
        ctrl = c["controllability"]
        assert all(math.isfinite(v) for k in ("caption_metrics", "scst_metrics")
                   for v in c[k].values()), c
        assert ctrl["videos"] == n_test and all(
            0.0 <= ctrl[k] <= 1.0 for k in ("free_run_tag_agreement", "controlled_tag_agreement")), c
    kernels.reset_launch_counts()
    quiet(ablation_report.main, [str(tmp_path / "grid" / "grid_results.json"), "--data_dir", data,
                                 "--bootstrap", "200"])
    assert not any(kernels.launch_counts().values())
    for cell, runs in launches.items():
        assert len(runs) == 6
        for module, got in runs:
            assert bool(got["xgate"]) == (cell == "xgate_nopos"), (cell, module, got)
            assert got["pos_lstm"] and got["attn_lstm"], (cell, module, got)
            assert bool(got["topk_tail"]) == module.endswith(".cli.eval"), (cell, module, got)
    # the free-run psi probe on each cell's SCST checkpoint: K2, and K1 in
    # the xgate cell alone; no decoder step
    for cell in launches:
        kernels.reset_launch_counts()
        out = json.loads(quiet(psi_diversity.main, [
            "--checkpoint_dir", str(tmp_path / "grid" / cell / "scst"), "--data_dir", data]))
        torch.cuda.synchronize()
        got = kernels.launch_counts()
        assert out["videos"] == min(128, n_test) and out["distinct_tag_sequences"] >= 1
        assert got["pos_lstm"] and not got["attn_lstm"], (cell, got)
        assert bool(got["xgate"]) == (cell == "xgate_nopos"), (cell, got)
