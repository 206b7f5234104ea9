"""The train loop's prefetch (`data/features.py::PrefetchIterator`,
`DevicePut`, `train/loop.py`) against the JAX package's, on the CPU.

The contract of the JAX iterator (`tests/test_robustness.py:94`, `:126`,
`tests/test_corpus.py`): a bounded queue, worker errors raised on the
consumer's side, an idempotent `close()` that joins the worker, and the
per-rank put under data parallelism. Then what the port adds: the number
of batches drawn when `close()` returns is `consumed + depth + 1`, the
JAX worker's steady state, whatever the timing. The batch stream after
the XE -> SCST switch (ROADMAP C7) depends on it: a second loop over the
same `TrainBatchIterator` must get the JAX loop's batches (ids, captions
and POS equal), and `cli.train --train.scst_start_epoch 1 --init_from`
must log the JAX CLI's XE losses and first SCST greedy reward (rtol
1e-5, the bar of `test_train_scst_stage_matches_the_jax_cli_reward`).
Prefetching changes no number: a loop with the thread gives the losses
and parameters of the same steps fed without it, bit for bit.
"""

import itertools
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from controllable_xgating_tpu.cli import train as j_train
from controllable_xgating_tpu.data import features as j_features
from controllable_xgating_tpu.data import loader as j_loader
from controllable_xgating_torch.cli import train as t_train
from controllable_xgating_torch.data import loader as t_loader
from controllable_xgating_torch.data.features import (
    STEP_KEYS,
    DevicePut,
    PrefetchIterator,
    StagedBatch,
    put_now,
)
from controllable_xgating_torch.parallel import distributed
from controllable_xgating_torch.train import loop as t_loop
from controllable_xgating_torch.train.xe import batch_to_device
from controllable_xgating_torch.utils.config import Config
from test_torch_cli import (
    JAX_FLAGS,
    PORT_FLAGS,
    SCST_TRAIN,
    SMALL,
    make_fixture,
    read_train_log,
    run_cli,
)
from test_torch_distributed import rank_prefetch_rows

torch.set_num_threads(1)
N_VIDEOS, BATCH, CAPS_PER_VIDEO, T, L = 12, 4, 3, 4, 8


class Store:
    """A feature store over numpy arrays (`get_batch`, `frame_mask`)."""

    def __init__(self, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.app = rng.standard_normal((N_VIDEOS, T, 6)).astype(np.float32)
        self.motion = rng.standard_normal((N_VIDEOS, T, 5)).astype(np.float32)
        self.counts = rng.integers(1, T + 1, N_VIDEOS)

    def get_batch(self, idx):
        return self.app[idx], self.motion[idx]

    def frame_mask(self, idx):
        return (np.arange(T)[None] < self.counts[idx][:, None]).astype(np.float32)


def corpus(seed: int = 1):
    """(store, caps, pos, ncaps): 2-5 references a video, so that the
    iterator draws both with and without replacement."""
    rng = np.random.default_rng(seed)
    caps = rng.integers(4, 30, (N_VIDEOS, 5, L)).astype(np.int32)
    pos = rng.integers(4, 12, (N_VIDEOS, 5, L)).astype(np.int32)
    return Store(), caps, pos, rng.integers(2, 6, N_VIDEOS).astype(np.int32)


def train_iterator(module, seed: int = 0):
    store, caps, pos, ncaps = corpus()
    return module.TrainBatchIterator(store, caps, pos, ncaps, np.arange(N_VIDEOS), BATCH,
                                     CAPS_PER_VIDEO, seed=seed)


def host(batch: dict) -> dict:
    return {k: np.asarray(v) for k, v in batch.items()}


# ------------------------------------------------------------ the contract


def test_close_joins_the_thread_and_a_second_close_is_a_no_op():
    """`tests/test_robustness.py:126`: abandoning the iterator mid-stream
    leaks no worker."""
    before = threading.active_count()
    pf = PrefetchIterator(itertools.count(), depth=2)
    assert next(iter(pf)) == 0
    pf.close()
    pf.close()
    assert threading.active_count() <= before
    assert not pf._thread.is_alive()
    with pytest.raises(StopIteration):
        next(pf)


def test_a_worker_error_is_raised_on_the_consumer_side():
    def bad():
        yield 1
        raise RuntimeError("boom in the source")

    with PrefetchIterator(bad()) as pf:
        assert next(pf) == 1
        with pytest.raises(RuntimeError, match="boom in the source"):
            next(pf)


def test_a_put_error_is_raised_on_the_consumer_side():
    def put(x):
        if x == 2:
            raise ValueError("put failed")
        return x

    with PrefetchIterator(iter(range(5)), put_fn=put) as pf:
        assert [next(pf), next(pf)] == [0, 1]
        with pytest.raises(ValueError, match="put failed"):
            next(pf)


@pytest.mark.parametrize("depth", [1, 3])
def test_a_finite_source_ends_under_a_slow_consumer(depth):
    """The end of the source reaches the consumer also where the queue is
    full when the source ends (`tests/test_corpus.py`'s put order)."""
    out = []
    with PrefetchIterator(iter(range(6)), put_fn=lambda x: 2 * x, depth=depth) as pf:
        for x in pf:
            time.sleep(0.02)
            out.append(x)
    assert out == [0, 2, 4, 6, 8, 10]


def test_the_depth_must_be_positive():
    with pytest.raises(ValueError, match="depth must be >= 1"):
        PrefetchIterator(iter(()), depth=0)


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("consumed", [0, 1, 5])
def test_close_leaves_exactly_consumed_plus_depth_plus_one_drawn(depth, consumed):
    """However far the worker got: closed at once after the last batch, or
    on a slow source."""
    def slow():
        for i in itertools.count():
            time.sleep(0.01)
            yield i

    for source in (itertools.count(), slow()):
        pf = PrefetchIterator(source, depth=depth)
        assert [next(pf) for _ in range(consumed)] == list(range(consumed))
        pf.close()
        assert pf.drawn == consumed + depth + 1


def test_close_stops_at_the_end_of_a_short_source():
    pf = PrefetchIterator(iter(range(2)), depth=3)
    assert next(pf) == 0
    pf.close()
    assert pf.drawn == 2


def test_device_put_on_the_cpu_keeps_the_arrays_and_the_other_keys():
    """On the CPU the steps' arrays become tensors sharing their memory,
    other keys stay; `batch_to_device` is then a no-op (the same tensor,
    no second copy)."""
    batch = dict(next(iter(train_iterator(t_loader))), num_valid=3, extra=None)
    out = put_now(DevicePut("cpu"), batch)
    for k in STEP_KEYS:
        assert isinstance(out[k], torch.Tensor) and out[k].device.type == "cpu"
        assert out[k].numpy().dtype == batch[k].dtype
        assert np.shares_memory(out[k].numpy(), batch[k])
    assert out["num_valid"] == 3 and out["extra"] is None
    moved = batch_to_device(out, torch.device("cpu"), STEP_KEYS)
    assert all(moved[k] is out[k] for k in STEP_KEYS)
    assert not isinstance(out, StagedBatch)


def test_prefetch_with_the_per_rank_put_over_two_gloo_ranks():
    """`tests/test_robustness.py:94`: under data parallelism the put takes
    each rank's rows (`shard_process_local_batch`) through the prefetch."""
    rng = np.random.default_rng(3)
    batches = [{"app": rng.standard_normal((8, 3, 2)).astype(np.float32),
                "video_indices": np.arange(8, dtype=np.int32) + 8 * i, "frame_mask": None}
               for i in range(3)]
    outs = distributed.launch(rank_prefetch_rows, 2, (batches, 2), device_type="cpu", timeout=60)
    for rank, rows in enumerate(outs):
        assert len(rows) == 3
        for got, want in zip(rows, batches):
            sl = slice(4 * rank, 4 * rank + 4)
            np.testing.assert_array_equal(got["app"], want["app"][sl])
            np.testing.assert_array_equal(got["video_indices"], want["video_indices"][sl])
            assert got["frame_mask"] is None


# ------------------------------------------------ the stream after a loop (C7)


def jax_next_loop(depth: int, consumed: int) -> list:
    """The JAX package: a loop of `consumed` batches through its
    `PrefetchIterator`, closed once its worker stands in its steady state
    (`consumed + depth + 1` drawn: it would have got there during the
    loop's val eval), then the next loop's first two batches."""
    it = train_iterator(j_loader)
    drawn = [0]

    def counted():
        for b in it:
            drawn[0] += 1
            yield b

    pf = j_features.PrefetchIterator(counted(), depth=depth)
    for _ in range(consumed):
        next(pf)
    deadline = time.monotonic() + 30
    while drawn[0] < consumed + depth + 1:
        assert time.monotonic() < deadline, drawn
        time.sleep(0.01)
    pf.close()
    assert drawn[0] == consumed + depth + 1
    nxt = j_features.PrefetchIterator(iter(it), depth=depth)
    out = [host(next(nxt)) for _ in range(2)]
    nxt.close()
    return out


def port_next_loop_by_iterator(depth: int, consumed: int) -> list:
    it = train_iterator(t_loader)
    with PrefetchIterator(iter(it), depth=depth) as pf:
        for _ in range(consumed):
            next(pf)
    with PrefetchIterator(iter(it), depth=depth) as pf:
        return [host(next(pf)) for _ in range(2)]


def port_next_loop_by_train_loop(depth: int, consumed: int) -> list:
    """Two `train_loop` runs of one epoch over one iterator (no eval), as
    the CLI's switch runs them; the second run's first two batches."""
    it = train_iterator(t_loader)
    assert it.steps_per_epoch() == consumed
    cfg = Config().replace_flat({"data.num_prefetch": depth, "train.eval_every_epochs": 1000})
    seen = []

    def step(state, batch):
        seen.append(host(batch))
        return state, {"loss": torch.zeros(())}

    state = SimpleNamespace(step=0)
    t_loop.train_loop(state, step, it, None, None, None, cfg, epochs=1)
    del seen[:]
    t_loop.train_loop(state, step, it, None, None, None, cfg, epochs=1)
    return seen[:2]


@pytest.mark.parametrize("via", ["iterator", "train_loop"])
@pytest.mark.parametrize("depth", [2, 3])
def test_the_next_loop_gets_the_jax_loops_batches(depth, via):
    """ROADMAP C7: after a loop of one epoch (3 batches) is closed, the
    next loop over the same iterator starts where JAX's does. Without the
    fixed draw count (the parent's loop drew exactly the batches it
    stepped on) the second loop's batches differ."""
    consumed = N_VIDEOS // BATCH
    want = jax_next_loop(depth, consumed)
    run = port_next_loop_by_iterator if via == "iterator" else port_next_loop_by_train_loop
    got = run(depth, consumed)
    for g, w in zip(got, want):
        for k in ("video_indices", "caps", "pos", "app", "frame_mask"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# -------------------------------------------------- prefetch changes nothing


def test_losses_and_parameters_equal_with_and_without_the_thread():
    """A `train_loop` with `num_prefetch` 2 (its put: `DevicePut` onto the
    CPU) against the same steps on the same batches from the calling
    thread, dropout 0.5: every loss and parameter bit for bit."""
    from controllable_xgating_torch.models.captioner import init_captioner
    from controllable_xgating_torch.train.state import create_train_state, make_optimizer
    from controllable_xgating_torch.train.xe import make_xe_train_step

    cfg = Config().replace_flat({
        "model.app_dim": 6, "model.motion_dim": 5, "model.hidden_dim": 8, "model.embed_dim": 6,
        "model.attn_dim": 6, "model.pos_embed_dim": 6, "model.vocab_size": 30,
        "model.pos_vocab_size": 12, "model.num_frames": T, "model.max_caption_len": L,
        "model.max_pos_len": L, "model.dropout": 0.5, "data.batch_size": BATCH,
        "data.caps_per_video_train": CAPS_PER_VIDEO, "data.num_prefetch": 2,
        "train.eval_every_epochs": 1000,
    })

    def run(threaded: bool):
        state = create_train_state(init_captioner(cfg, seed=4, device="cpu"), cfg)
        step = make_xe_train_step(make_optimizer(cfg, 3), cfg)
        losses = []

        def recording(state, batch):
            state, m = step(state, batch)
            losses.append(m["loss"].item())
            return state, m

        it = train_iterator(t_loader)
        if threaded:
            t_loop.train_loop(state, recording, it, None, None, None, cfg, epochs=2,
                              device_put_fn=DevicePut("cpu"))
        else:
            batches = iter(it)
            for _ in range(2 * it.steps_per_epoch()):
                recording(state, next(batches))
        return losses, {n: p.detach().clone() for n, p in state.params.named_parameters()}

    (la, pa), (lb, pb) = run(True), run(False)
    assert la == lb and len(la) == 6
    for name in pa:
        assert torch.equal(pa[name], pb[name]), name


# --------------------------------------------- the switch end to end (C7)


@pytest.fixture(scope="module")
def switch_runs(tmp_path_factory):
    """`cli.train --stage joint --epochs 2 --train.scst_start_epoch 1
    --init_from` the bridged checkpoint, by each CLI, on
    `tests/test_torch_cli.py`'s fixture."""
    root = str(tmp_path_factory.mktemp("switch"))
    data, jdir, tdir = make_fixture(root)
    common = ["--data_dir", data, "--stage", "joint", "--epochs", "2",
              "--train.scst_start_epoch", "1", *SMALL, *SCST_TRAIN]
    run_cli(j_train.main, ["--checkpoint_dir", root + "/jax", "--init_from", jdir, *common,
                           *JAX_FLAGS])
    run_cli(t_train.main, ["--checkpoint_dir", root + "/torch", "--init_from", tdir, *common,
                           *PORT_FLAGS])
    steps = lambda run: [e for e in read_train_log(os.path.join(root, run, "joint"))
                         if "loss" in e]
    return steps("torch"), steps("jax")


def test_switch_run_logs_the_jax_clis_xe_losses(switch_runs):
    tsteps, jsteps = switch_runs
    txe = [e for e in tsteps if "cap_loss" in e]
    jxe = [e for e in jsteps if "cap_loss" in e]
    assert [e["step"] for e in txe] == [e["step"] for e in jxe] and len(txe) >= 1
    for t, j in zip(txe, jxe):
        for k in ("loss", "cap_loss", "pos_loss"):
            assert t[k] == pytest.approx(j[k], rel=1e-5), (t["step"], k)


def test_switch_runs_first_scst_step_on_the_jax_clis_batch(switch_runs):
    """The first SCST step's greedy reward: deterministic given the weights
    and the batch, so equal only where the SCST loop's first batch is
    JAX's (C7)."""
    tsteps, jsteps = switch_runs
    tscst = [e for e in tsteps if "reward_greedy" in e]
    jscst = [e for e in jsteps if "reward_greedy" in e]
    assert tscst and tscst[0]["step"] == jscst[0]["step"]
    assert tscst[0]["reward_greedy"] == pytest.approx(jscst[0]["reward_greedy"], rel=1e-5)
    assert tscst[0]["reward_greedy"] > 0
