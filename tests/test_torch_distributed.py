"""Multi-process data parallelism of the port (`parallel/distributed.py`,
`train/loop.py`, `cli/train.py`) on the CPU, over gloo.

Real processes: two OS processes join through the CXG_* variables on a
free localhost port and run the port's train CLI on one corpus; their
`last` parameters must be the single-process run's (rtol 2e-4, atol
1e-5, `tests/test_distributed.py`'s bar), with one writer of the
checkpoints and the log. Every process runs under a collective timeout
of 60 s (CXG_TIMEOUT_S) and every wait here has a timeout.

This module imports no JAX: its rank functions run in spawned processes
that import it.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from controllable_xgating_torch.cli import prepro as t_prepro
from controllable_xgating_torch.parallel import distributed

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 60  # the ranks' collective timeout
WAIT = 300      # seconds: any one process of a test
SMALL = [
    "--model.hidden_dim", "16", "--model.embed_dim", "10", "--model.attn_dim", "10",
    "--model.pos_embed_dim", "10", "--model.num_frames", "4", "--model.dropout", "0.5",
    "--data.batch_size", "8", "--data.caps_per_video_train", "2",
    "--eval.max_decode_len", "10", "--train.log_every_steps", "1",
]


def env(extra=None) -> dict:
    e = {k: v for k, v in os.environ.items()
         if not k.startswith("CXG_") and k not in ("MASTER_ADDR", "WORLD_SIZE", "RANK")}
    e.update({"PYTHONPATH": REPO + os.pathsep + e.get("PYTHONPATH", ""), "OMP_NUM_THREADS": "1",
              "CXG_TIMEOUT_S": str(TIMEOUT_S)})
    e.update(extra or {})
    return e


def train_cmd(data_dir: str, ckpt_dir: str, *args) -> list:
    return [sys.executable, "-m", "controllable_xgating_torch.cli.train", "--device", "cpu",
            "--data_dir", data_dir, "--checkpoint_dir", ckpt_dir, *args, *SMALL]


def cxg_procs(cmd: list, n: int = 2) -> list:
    port = distributed.free_port()
    return [subprocess.Popen(cmd, env=env({
        "CXG_COORDINATOR": f"127.0.0.1:{port}", "CXG_NUM_PROCESSES": str(n),
        "CXG_PROCESS_ID": str(r)}), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)]


def finish(procs: list) -> list:
    """[(returncode, stdout + stderr)] of every process, each within WAIT s
    (a process past it is killed and the test fails)."""
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=WAIT)
            out.append((p.returncode, o + e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def run_cxg(cmd: list, n: int = 2) -> list:
    outs = finish(cxg_procs(cmd, n))
    for rc, text in outs:
        assert rc == 0, text[-3000:]
    return outs


def load_params(ckpt: str, name: str = "last") -> dict:
    return torch.load(os.path.join(ckpt, name + ".pt"), map_location="cpu",
                      weights_only=True)["params"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dist_corpus"))
    t_prepro.main(["--out", d, "--fixtures", "--fixture_videos", "18", "--fixture_frames", "4",
                   "--fixture_app_dim", "12", "--fixture_motion_dim", "8",
                   "--max_caption_len", "10", "--seqs_per_video", "4"])
    return d


@pytest.fixture(scope="module")
def two_runs(corpus, tmp_path_factory):
    """The single-process run and the two-process run of 2 joint epochs."""
    root = tmp_path_factory.mktemp("dist_runs")
    single, multi = str(root / "single"), str(root / "multi")
    r = subprocess.run(train_cmd(corpus, single, "--stage", "joint", "--epochs", "2"), env=env(),
                       capture_output=True, text=True, timeout=WAIT)
    assert r.returncode == 0, (r.stdout + r.stderr)[-3000:]
    outs = run_cxg(train_cmd(corpus, multi, "--stage", "joint", "--epochs", "2"))
    return single, multi, r.stdout + r.stderr, outs


def test_two_process_train_matches_single_process(two_runs):
    single, multi, _, _ = two_runs
    want = load_params(os.path.join(single, "joint"))
    got = load_params(os.path.join(multi, "joint"))
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=2e-4, atol=1e-5,
                                   err_msg=name)


def test_two_process_train_logs_the_banner_once(two_runs):
    _, _, single_text, outs = two_runs
    texts = [t for _, t in outs]
    assert "data-parallel over 2 devices on 2 processes" in texts[0]
    assert "data-parallel" not in texts[1] and "data-parallel" not in single_text
    # the side effects' log lines are the primary's
    assert texts[0].count("epoch 1 loss") == 1 and "epoch 1 loss" not in texts[1]


def test_two_process_train_writes_from_the_primary_alone(two_runs):
    single, multi, _, _ = two_runs
    for d in (single, multi):
        assert os.path.exists(os.path.join(d, "joint", "last.infos.json"))
        assert os.path.exists(os.path.join(d, "joint", "best.infos.json"))
    with open(os.path.join(multi, "joint", "train_log.jsonl")) as f:
        multi_log = [json.loads(line) for line in f]
    with open(os.path.join(single, "joint", "train_log.jsonl")) as f:
        single_log = [json.loads(line) for line in f]
    steps = [e["step"] for e in multi_log if "loss" in e]
    assert len(steps) == len(set(steps)) == 4, "duplicate writers on the log"
    # the step log holds the global batch's loss: the single process's
    for a, b in zip(multi_log, single_log):
        for k in ("loss", "cap_loss", "pos_loss", "val_CIDEr"):
            if k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=2e-4, atol=1e-5, err_msg=k)
    infos = json.load(open(os.path.join(multi, "joint", "last.infos.json")))
    assert infos["step"] == 4 and infos["stage"] == "joint"


def test_two_process_scst_stage_handoff(corpus, tmp_path):
    """SCST over two processes from a primary-written XE checkpoint: each
    process builds its reward tables, restores the same `best`."""
    ck = str(tmp_path / "ck")
    run_cxg(train_cmd(corpus, ck, "--stage", "joint", "--epochs", "1"))
    assert os.path.exists(os.path.join(ck, "joint", "best.infos.json"))
    outs = run_cxg(train_cmd(corpus, ck, "--stage", "scst", "--epochs", "1", "--init_from",
                             os.path.join(ck, "joint"), "--train.lr", "5e-5"))
    assert "data-parallel over 2 devices on 2 processes" in outs[0][1]
    infos = json.load(open(os.path.join(ck, "scst", "last.infos.json")))
    assert infos["stage"] == "scst" and infos["step"] == 2
    with open(os.path.join(ck, "scst", "train_log.jsonl")) as f:
        rows = [json.loads(line) for line in f if "reward_greedy" in line]
    assert len(rows) == 2 and all(np.isfinite(r["loss"]) for r in rows)


def test_multiprocess_refuses_a_subset_of_devices(corpus, tmp_path):
    outs = finish(cxg_procs(train_cmd(corpus, str(tmp_path / "ck"), "--epochs", "1",
                                      "--parallel.num_devices", "1")))
    for rc, text in outs:
        assert rc != 0 and "cannot subset the device list" in text


def test_killed_peer_fails_the_run_within_its_timeout(corpus, tmp_path):
    """Rank 1 is killed in the middle of a long run; rank 0 must exit
    non-zero, in its collective timeout at the latest, not hang."""
    ck = str(tmp_path / "ck")
    procs = cxg_procs(train_cmd(corpus, ck, "--epochs", "500"))
    log = os.path.join(ck, "joint", "train_log.jsonl")
    try:
        deadline = time.monotonic() + WAIT
        while not (os.path.exists(log) and os.path.getsize(log)):
            assert time.monotonic() < deadline and all(p.poll() is None for p in procs), \
                "the run never logged a step"
            time.sleep(0.2)
        procs[1].send_signal(signal.SIGKILL)
        t0 = time.monotonic()
        procs[0].communicate(timeout=TIMEOUT_S + 60)
        assert procs[0].returncode != 0
        assert time.monotonic() - t0 < TIMEOUT_S + 60
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate()


# ------------------------------------------------ the helpers over two ranks


def rank_helpers(diverge: bool) -> dict:
    """Run on each rank of a `launch`: the process helpers, and the state
    check with rank 1's copy changed where `diverge`."""
    rank = distributed.process_index()
    out = {
        "rank": rank, "count": distributed.process_count(), "primary": distributed.is_primary(),
        "slice": distributed.process_slice(8),
        "rows": distributed.shard_process_local_batch({"x": np.arange(8), "y": None})["x"].tolist(),
        "flag": distributed.broadcast_flag(rank == 0),
    }
    state = (torch.arange(4.0) + (rank if diverge else 0), 7, torch.Generator().manual_seed(1))
    try:
        distributed.replicate_to_global(state)
        out["same"] = True
    except RuntimeError as e:
        out["same"] = str(e)
    return out


def rank_train_runs(cases: list) -> list:
    """`parallel/dryrun.py::train_steps(**case)` for each case: several
    runs in one launch (one start-up of the processes)."""
    from controllable_xgating_torch.parallel import dryrun

    return [dryrun.train_steps(**case) for case in cases]


def rank_prefetch_rows(batches: list, depth: int) -> list:
    """This rank's rows of each batch as the train loop prefetches them
    under data parallelism (the put: `shard_process_local_batch`, then
    `DevicePut` onto the CPU), as numpy."""
    from controllable_xgating_torch.data.features import DevicePut, PrefetchIterator

    put = DevicePut("cpu")
    with PrefetchIterator(iter(batches), lambda b: put(distributed.shard_process_local_batch(b)),
                          depth) as staged:
        return [{k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in b.items()}
                for b in staged]


def rank_env(name: str):
    return os.environ.get(name)


def rank_fails(rank_to_fail: int) -> int:
    if distributed.process_index() == rank_to_fail:
        raise SystemExit(3)
    return distributed.process_index()


@pytest.fixture(scope="module")
def helpers():
    return distributed.launch(rank_helpers, 2, (False,), timeout=TIMEOUT_S), \
        distributed.launch(rank_helpers, 2, (True,), timeout=TIMEOUT_S)


def test_process_helpers_over_two_ranks(helpers):
    same, _ = helpers
    assert [h["rank"] for h in same] == [0, 1] and all(h["count"] == 2 for h in same)
    assert [h["primary"] for h in same] == [True, False]
    assert [h["slice"] for h in same] == [slice(0, 4), slice(4, 8)]
    assert [h["rows"] for h in same] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert all(h["flag"] is True for h in same)  # the primary's decision, everywhere
    assert all(h["same"] is True for h in same)


def test_divergent_state_is_refused_on_every_rank(helpers):
    _, diverged = helpers
    for h in diverged:
        assert "processes disagree on replicated state" in h["same"]
        assert "shared storage" in h["same"]


def test_launch_sets_the_ranks_environment_and_not_its_own():
    got = distributed.launch(rank_env, 2, ("CXG_TEST_RANK_ENV",), timeout=TIMEOUT_S,
                             env={"CXG_TEST_RANK_ENV": "seen"})
    assert got == ["seen", "seen"] and "CXG_TEST_RANK_ENV" not in os.environ


def test_launch_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 of 2 exited with code 3"):
        distributed.launch(rank_fails, 2, (1,), timeout=TIMEOUT_S)


def test_a_rank_dying_at_start_up_fails_a_launch_of_large_arguments():
    """A rank that dies before it reads its arguments (here spawn cannot
    import a parent that runs from stdin) fails the launch at once, also
    where the arguments exceed a pipe's buffer."""
    script = ("import numpy as np\n"
              "from controllable_xgating_torch.parallel import distributed\n"
              "try:\n"
              "    distributed.launch(len, 2, (np.ones(15_000_000, np.float32),), timeout=30)\n"
              "except RuntimeError as e:\n"
              "    print('raised', e)\n")
    r = subprocess.run([sys.executable, "-"], input=script, env=env(), capture_output=True,
                       text=True, timeout=120)
    assert "raised rank" in r.stdout and "exited with code 1" in r.stdout, r.stderr[-2000:]


def test_fingerprint_covers_every_leaf():
    g = torch.Generator().manual_seed(0)
    base = distributed.fingerprint((torch.ones(3), 5, g))
    assert base == distributed.fingerprint((torch.ones(3), 5, torch.Generator().manual_seed(0)))
    assert base != distributed.fingerprint((torch.ones(3), 6, g))
    assert base != distributed.fingerprint((torch.ones(3, dtype=torch.float64), 5, g))
    assert base != distributed.fingerprint((torch.ones(3), 5, torch.Generator().manual_seed(1)))


def test_initialize_from_env_without_a_group_does_nothing(monkeypatch):
    for k in ("CXG_COORDINATOR", "MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize_from_env("cpu") is False
    assert not torch.distributed.is_initialized()
    assert distributed.local_device("cpu") == torch.device("cpu")
