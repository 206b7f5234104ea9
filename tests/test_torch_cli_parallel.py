"""Config 5 through the port's CLIs on the CPU: `cli.train
--parallel.num_devices N` starts its own N ranks (gloo), and equals the
run of N processes started through the CXG_* variables bit for bit (the
same code on the same rows); an indivisible batch trains on one device;
more ranks than cards exits 1 with the count; `cli.eval` takes a mesh of
cards only where there are that many.

Every process runs under a collective timeout of 60 s (CXG_TIMEOUT_S) and
every wait has a timeout.
"""

import os
import subprocess

import numpy as np
import pytest
import torch

from controllable_xgating_torch.cli import eval as t_eval
from controllable_xgating_torch.cli import train as t_train
from controllable_xgating_torch.utils.config import Config
from test_torch_distributed import WAIT, env, load_params, run_cxg, train_cmd

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from controllable_xgating_torch.cli import prepro as t_prepro

    d = str(tmp_path_factory.mktemp("cli_par_corpus"))
    t_prepro.main(["--out", d, "--fixtures", "--fixture_videos", "16", "--fixture_frames", "4",
                   "--fixture_app_dim", "12", "--fixture_motion_dim", "8",
                   "--max_caption_len", "10", "--seqs_per_video", "4"])
    return d


def run(cmd: list) -> str:
    r = subprocess.run(cmd, env=env(), capture_output=True, text=True, timeout=WAIT)
    assert r.returncode == 0, (r.stdout + r.stderr)[-3000:]
    return r.stdout + r.stderr


def test_self_launched_ranks_equal_the_cxg_processes(corpus, tmp_path):
    own, cxg = str(tmp_path / "own"), str(tmp_path / "cxg")
    text = run(train_cmd(corpus, own, "--epochs", "2", "--parallel.num_devices", "2"))
    assert "launching 2 ranks of data-parallel training on cpu" in text
    assert "data-parallel over 2 devices on 2 processes" in text
    run_cxg(train_cmd(corpus, cxg, "--epochs", "2"))
    got, want = load_params(os.path.join(own, "joint")), load_params(os.path.join(cxg, "joint"))
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), want[name].numpy(), err_msg=name)
    with open(os.path.join(own, "joint", "train_log.jsonl")) as a, \
            open(os.path.join(cxg, "joint", "train_log.jsonl")) as b:
        strip = lambda lines: [l.split('"step"')[1] for l in lines]  # drop the time stamps
        assert strip(a.readlines()) == strip(b.readlines())


def test_indivisible_batch_trains_on_one_device(corpus, tmp_path):
    ck = str(tmp_path / "ck")
    text = run(train_cmd(corpus, ck, "--epochs", "1", "--parallel.num_devices", "3"))
    assert "batch_size 8 not divisible by 3 devices; running single-device" in text
    assert "launching" not in text and "data-parallel over" not in text
    assert os.path.exists(os.path.join(ck, "joint", "last.infos.json"))


def test_more_ranks_than_cards_exits_with_the_count(corpus, tmp_path, monkeypatch, capsys):
    """`--parallel.num_devices 2` on a machine with one card exits 1
    naming both counts, before any rank starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit) as e:
        t_train.main(["--data_dir", corpus, "--checkpoint_dir", str(tmp_path),
                      "--parallel.num_devices", "2"])
    assert e.value.code == 1
    assert "need 2 devices, have 1" in capsys.readouterr().err


@pytest.mark.parametrize("n,batch,count,want", [
    (2, 4, 2, 2), (0, 4, 4, 4), (2, 5, 2, None), (4, 4, 2, None), (0, 4, 1, None), (1, 4, 4, None),
])
def test_eval_mesh_takes_the_cards_where_they_are(monkeypatch, n, batch, count, want):
    """`cli.eval`'s mesh: N (0: every card) cards where 1 < N <= their
    count and the batch divides; else one device."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    cfg = Config().replace_flat({"parallel.num_devices": n, "data.batch_size": batch})
    mesh = t_eval.eval_mesh(cfg, torch.device("cuda", 0))
    if want is None:
        assert mesh is None
    else:
        assert mesh.devices == tuple(torch.device("cuda", i) for i in range(want))
    assert t_eval.eval_mesh(cfg, torch.device("cpu")) is None  # the CPU is one device


@pytest.mark.parametrize("n,batch,count,want", [
    (2, 8, 2, 2), (0, 8, 2, 2), (3, 8, 4, 0), (1, 8, 4, 0), (0, 8, 1, 0),
])
def test_ranks_to_launch(monkeypatch, n, batch, count, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    cfg = Config().replace_flat({"parallel.num_devices": n, "data.batch_size": batch})
    assert t_train.ranks_to_launch(cfg, torch.device("cuda", 0)) == want
    cpu_want = n if n > 1 and batch % n == 0 else 0
    assert t_train.ranks_to_launch(cfg, torch.device("cpu")) == cpu_want
