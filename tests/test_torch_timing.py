"""The port's timing harness (`utils/timing.py`), counterpart of the fast
tests of `tests/test_bench_timing.py`, at that file's tiny config on the
CPU.

The harness has two ways of giving silently wrong numbers: a repeated
body whose work is skipped (times collapse), and a train timing that
changes the caller's state. Both are pinned, with the draws of its input
batches bit for bit those of the root `bench.py` (which only this test
imports) and `make_timed`'s record.
"""

import numpy as np
import pytest
import torch

import bench
from controllable_xgating_torch.infer.evaluator import make_greedy_caption_fn
from controllable_xgating_torch.models.captioner import init_captioner
from controllable_xgating_torch.train.state import create_train_state, make_optimizer
from controllable_xgating_torch.train.xe import make_xe_train_step
from controllable_xgating_torch.utils import timing
from controllable_xgating_torch.utils.config import Config

torch.set_num_threads(1)
TINY = {
    "model.app_dim": 8, "model.motion_dim": 6, "model.hidden_dim": 8,
    "model.embed_dim": 6, "model.attn_dim": 6, "model.pos_embed_dim": 6,
    "model.vocab_size": 24, "model.pos_vocab_size": 10,
    "model.num_frames": 3, "model.max_pos_len": 5, "model.max_caption_len": 6,
}
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def tiny():
    cfg = Config().replace_flat(TINY)
    return cfg, init_captioner(cfg, seed=0, device="cpu")


def test_caption_sustained_scales_with_length(tiny):
    """Anti-skip: the differenced per-batch time tracks real work. A 16x
    longer decode must measure clearly slower per batch (a skipped or
    hoisted body measures ~constant)."""
    cfg, params = tiny
    rng = np.random.default_rng(0)
    app = rng.normal(size=(32, 3, 8)).astype(np.float32)
    mot = rng.normal(size=(32, 3, 6)).astype(np.float32)
    t = {}
    for max_len in (6, 96):
        fn = make_greedy_caption_fn(cfg.model.max_pos_len, max_len, early_stop=False)
        cps = timing.time_caption_sustained(fn, params, (app, mot), CPU, reps=(2, 20))
        t[max_len] = 32 / cps
    assert t[96] > 2.0 * t[6], (
        f"per-batch time {t[6] * 1e6:.0f}us -> {t[96] * 1e6:.0f}us for 16x decode length: "
        "the timed body is being skipped")


def test_train_sustained_runs_real_steps_and_leaves_the_state(tiny):
    """The timed steps are real steps, each on the state the last one
    left, and the caller's state (parameters, Adam moments, step,
    generator) is as it was: the port's step updates its state in place,
    so the harness steps a copy."""
    cfg, _ = tiny
    full = cfg.replace_flat({"model.dropout": 0.0})
    state = create_train_state(init_captioner(full, seed=0, device="cpu"), full)
    step_fn = make_xe_train_step(make_optimizer(full, 10), full, "joint")
    seen = []

    def step(s, batch):
        seen.append((id(s), s.step, s.params.decoder.w_out.detach().clone()))
        return step_fn(s, batch)

    before = {n: p.detach().clone() for n, p in state.params.named_parameters()}
    gen_state = state.gen.get_state()
    batch = timing.bench_train_batch(full, 4, 2)
    per_step = timing.time_train_sustained(step, state, batch, CPU, steps=3)
    assert per_step > 0
    assert [s for _, s, _ in seen] == [0, 1, 2, 3]  # one warm-up + 3, chained
    assert len({i for i, _, _ in seen}) == 1 and seen[0][0] != id(state)
    assert not torch.equal(seen[0][2], seen[-1][2]), "the steps changed no parameter"
    assert state.step == 0 and torch.equal(state.gen.get_state(), gen_state)
    assert not state.opt_state.state  # no Adam moments: never stepped
    for n, p in state.params.named_parameters():
        assert torch.equal(p, before[n]), n


def test_batches_equal_bench_draws(tiny):
    cfg, _ = tiny
    for b, seed in ((3, 0), (5, 11)):
        for ours, theirs in zip(timing.random_batch(cfg, b, seed), bench.random_batch(cfg, b, seed)):
            assert ours.dtype == theirs.dtype
            np.testing.assert_array_equal(ours, theirs)
    ours, theirs = timing.bench_train_batch(cfg, 4, 2), bench._bench_train_batch(cfg, 4, 2)
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype
        np.testing.assert_array_equal(ours[k], theirs[k])
    assert (timing.BATCH, timing.BEAM, timing.MAX_LEN, timing.FRAMES, timing.REPEATS) == (
        bench.BATCH, bench.BEAM, bench.MAX_LEN, bench.FRAMES, bench.REPEATS)


def test_make_timed_records_positive_ms():
    timings, detail = {}, {}
    timed = timing.make_timed(timings, CPU, reps=(1, 3), tag="t", ndigits=6, detail=detail)
    x = np.random.default_rng(0).normal(size=(256, 256)).astype(np.float32)
    per = timed("matmul", lambda c, x: (x + c).matmul(x).sum() * 1e-9, x)
    assert list(timings) == ["matmul"] and timings["matmul"] > 0 and per > 0
    assert detail["matmul"]["device_ms"] is None  # not measured off the card
    mean, stats = timing.repeat_measure(lambda: 2.0, n=3)
    assert mean == 2.0 and stats == {"mean": 2.0, "sigma": 0.0, "n": 3, "min": 2.0, "max": 2.0}
