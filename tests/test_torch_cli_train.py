"""The port's train CLI (XE stages) vs the JAX package's, on the CPU.

Both CLIs start from the same bridged fixture checkpoint (`--init_from`,
see `tests/test_torch_cli.py`) at dropout 0, so both draw the same
batches (`TrainBatchIterator` with the same seed) and take the same
steps: the losses in `train_log.jsonl` must agree within rtol 1e-5, the
val metrics within rel 1e-12 (the same captions), and the `best`
parameters within rtol 1e-5, atol 1e-6 (the tolerance of
`tests/test_torch_train.py`). The learning rate is 1e-4: Adam moves a
parameter by up to ~lr a step whatever its gradient's size, so where a
gradient nearly cancels, the two sum orders' difference in it shows in the
parameter at the scale of lr. At 4e-4 one weight of the caption stage
(`encoder.lstm_fwd.whh`) ended 3.2e-6 apart after two steps; at 1e-4 no
parameter exceeds rtol 1e-5 by more than 5e-8.
"""

import json
import os

import numpy as np
import pytest
import torch

from controllable_xgating_tpu.cli import common as j_common
from controllable_xgating_tpu.cli import train as j_train
from controllable_xgating_torch import bridge
from controllable_xgating_torch.cli import common as t_common
from controllable_xgating_torch.cli import train as t_train
from controllable_xgating_torch.ops.precision import compute_dtype
from controllable_xgating_torch.train import state as t_state
from test_torch_cli import JAX_FLAGS, PORT_FLAGS, SMALL, make_fixture, run_cli
from tools.import_torch_checkpoint import param_paths

torch.set_num_threads(1)
TRAIN = ["--model.dropout", "0", "--train.log_every_steps", "1", "--train.lr", "1e-4"]
STAGES = {"joint": 2, "pos": 1, "caption": 1}  # stage -> epochs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each stage trained once by each CLI from the bridged checkpoint:
    {stage: (data_dir, JAX run dir, port run dir)}."""
    root = str(tmp_path_factory.mktemp("train_cli"))
    data, jdir, tdir = make_fixture(root)
    out = {}
    for stage, epochs in STAGES.items():
        jrun, trun = os.path.join(root, f"jax_{stage}"), os.path.join(root, f"torch_{stage}")
        common = ["--data_dir", data, "--stage", stage, "--epochs", str(epochs), *SMALL, *TRAIN]
        run_cli(j_train.main, ["--checkpoint_dir", jrun, "--init_from", jdir, *common, *JAX_FLAGS])
        run_cli(t_train.main, ["--checkpoint_dir", trun, "--init_from", tdir, *common, *PORT_FLAGS])
        out[stage] = (data, os.path.join(jrun, stage), os.path.join(trun, stage))
    return out


def read_log(run_dir):
    with open(os.path.join(run_dir, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("stage", list(STAGES))
def test_train_cli_losses_and_val_metrics_match_jax(runs, stage):
    _, jrun, trun = runs[stage]
    jlog, tlog = read_log(jrun), read_log(trun)
    assert [e["step"] for e in tlog] == [e["step"] for e in jlog]
    steps = [e for e in jlog if "loss" in e]
    assert len(steps) == 2 * STAGES[stage]  # 12 train videos / batch 6, every step logged
    for te, je in zip(tlog, jlog):
        assert te.keys() == je.keys()
        for k in je:
            if k == "ts":
                continue
            if k.startswith("val_"):
                assert te[k] == pytest.approx(je[k], rel=1e-12, abs=1e-12), k
            else:
                assert te[k] == pytest.approx(je[k], rel=1e-5, abs=1e-6), k
    assert any("val_CIDEr" in e for e in tlog)


@pytest.mark.parametrize("stage", list(STAGES))
def test_train_cli_best_params_match_jax(runs, stage):
    data, jrun, trun = runs[stage]
    for name in ("best", "last"):
        jinfo = t_state.CheckpointManager.load_infos(jrun, name)
        tinfo = t_state.CheckpointManager.load_infos(trun, name)
        assert {k: tinfo[k] for k in ("epoch", "step", "metric", "stage")} == \
            {k: jinfo[k] for k in ("epoch", "step", "metric", "stage")}
        assert tinfo["best_score"] == pytest.approx(jinfo["best_score"], rel=1e-12)
    _, cfg = j_common.parse_with_overrides(j_common.base_parser("t"), ["--data_dir", data, *SMALL])
    _, _, _, cfg = j_common.load_corpus(data, cfg)
    want = {n: np.asarray(leaf) for n, leaf in param_paths(j_common.restore_params(jrun, cfg))}
    got = bridge.to_numpy(t_common.restore_params(trun, cfg, "cpu"))
    assert got.keys() == want.keys()
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-5, atol=1e-6, err_msg=n)
    init = bridge.to_numpy(t_common.restore_params(os.path.join(os.path.dirname(os.path.dirname(
        trun)), "ck_torch"), cfg, "cpu"))
    moved = {n.split(".")[0] for n in got if not np.array_equal(got[n], init[n])}
    # the stage's mask: pos trains encoder + POS, caption freezes the POS branch
    assert moved == {"pos": {"encoder", "pos"}, "caption": {"encoder", "decoder"},
                     "joint": {"encoder", "pos", "decoder"}}[stage]


def test_train_cli_resumes_from_last_and_starts_fresh(runs, tmp_path):
    """Without --init_from, a run resumes from its directory's `last`
    (step and optimizer carried on), and an empty directory starts from
    `init_captioner(seed=train.seed)`; the policy is left at f32."""
    data, _, trun = runs["joint"]
    root = os.path.dirname(trun)
    steps = t_state.CheckpointManager.load_infos(trun, "last")["step"]
    run_cli(t_train.main, ["--data_dir", data, "--checkpoint_dir", root, "--epochs", "1",
                           *SMALL, *TRAIN, *PORT_FLAGS])
    assert t_state.CheckpointManager.load_infos(trun, "last")["step"] == steps + 2
    fresh = str(tmp_path / "fresh")
    run_cli(t_train.main, ["--data_dir", data, "--checkpoint_dir", fresh, "--epochs", "1",
                           "--compute_dtype", "bfloat16", *SMALL, *TRAIN, *PORT_FLAGS])
    assert t_state.CheckpointManager.load_infos(fresh + "/joint", "last")["step"] == 2
    assert compute_dtype() == torch.float32
