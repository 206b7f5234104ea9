"""The train loop's put function on the card (`data/features.py::DevicePut`),
the XE step on prefetched batches, and the split evaluation's batch
caller (`infer/evaluator.py::batch_caller`), which puts through its own
`DevicePut`.

Marked `gpu`: every test skips without a CUDA device. This file imports no
jax, so it also runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_prefetch_gpu.py

The put copies the steps' arrays through pinned host memory on a side
stream; the consumer's stream waits on its event. Values are copied, not
computed: they must equal the host batch exactly, and a step on them must
give the losses and parameters of the same step on batches copied on the
consumer's stream, bit for bit (f32, dropout 0). The batch caller's
beam captions equal those of the same calls on `torch.as_tensor` puts, bit
for bit (bf16 policy, the kernels), over batches A, B, A, B: a staging set
refilled before its copies left it would show there.
"""

import numpy as np
import pytest
import torch

from controllable_xgating_torch.data.features import (
    STEP_KEYS,
    DevicePut,
    PrefetchIterator,
    StagedBatch,
)
from controllable_xgating_torch.data.loader import TrainBatchIterator
from controllable_xgating_torch.train.xe import batch_to_device

pytestmark = pytest.mark.gpu
N_VIDEOS, T, DA, DM, L = 16, 26, 64, 32, 12


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


class Store:
    def __init__(self, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.app = rng.standard_normal((N_VIDEOS, T, DA)).astype(np.float32)
        self.motion = rng.standard_normal((N_VIDEOS, T, DM)).astype(np.float32)
        self.counts = rng.integers(3, T + 1, N_VIDEOS)

    def get_batch(self, idx):
        return self.app[idx], self.motion[idx]

    def frame_mask(self, idx):
        return (np.arange(T)[None] < self.counts[idx][:, None]).astype(np.float32)


def train_iterator(batch: int = 8, seed: int = 0) -> TrainBatchIterator:
    rng = np.random.default_rng(1)
    caps = np.zeros((N_VIDEOS, 4, L), np.int32)
    for v in range(N_VIDEOS):
        for j in range(4):
            n = int(rng.integers(3, L - 2))
            caps[v, j, 0], caps[v, j, n + 1] = 1, 2
            caps[v, j, 1:n + 1] = rng.integers(4, 40, n)
    pos = np.where(caps > 3, caps % 9 + 3, caps).astype(np.int32)
    return TrainBatchIterator(Store(), caps, pos, np.full(N_VIDEOS, 4, np.int32),
                              np.arange(N_VIDEOS), batch, 2, seed=seed)


def test_device_put_copies_on_a_side_stream(dev):
    """The staged tensors lie on the card and equal the host batch; the
    copies ran on the put's own stream, and after `ready()` the consumer's
    stream has waited for them."""
    host = next(iter(train_iterator()))
    put = DevicePut(dev)
    staged = put(dict(host, num_valid=5))
    assert isinstance(staged, StagedBatch)
    assert put._stream is not None and put._stream != torch.cuda.current_stream(dev)
    batch = staged.ready()
    assert batch["num_valid"] == 5
    for k in STEP_KEYS:
        assert batch[k].device == dev and batch[k].dtype == torch.from_numpy(host[k]).dtype
        np.testing.assert_array_equal(batch[k].cpu().numpy(), host[k])
    torch.cuda.current_stream(dev).synchronize()
    assert staged.event.query()
    moved = batch_to_device(batch, dev, STEP_KEYS)
    assert all(moved[k].data_ptr() == batch[k].data_ptr() for k in STEP_KEYS)


def test_device_put_reuses_its_pinned_staging(dev):
    """More puts in a row than the put has staging sets, none readied in
    between: each set is written again only after its copies have left
    it, so every batch still equals its host batch, and the pinned
    buffers are the same ones after the sets come round."""
    it = iter(train_iterator())
    hosts = [next(it) for _ in range(2 * DevicePut.STAGING + 1)]
    put = DevicePut(dev)
    staged = [put(hosts[0])]
    pinned = {k: t.data_ptr() for k, t in put._staging[0][0].items()}
    assert set(pinned) == set(STEP_KEYS)
    assert all(t.is_pinned() for t in put._staging[0][0].values())
    staged += [put(h) for h in hosts[1:]]
    assert {k: t.data_ptr() for k, t in put._staging[0][0].items()} == pinned
    for s, h in zip(staged, hosts):
        got = s.ready()
        for k in STEP_KEYS:
            np.testing.assert_array_equal(got[k].cpu().numpy(), h[k])


def test_prefetched_batches_equal_the_host_batches(dev):
    a, b = iter(train_iterator()), iter(train_iterator())
    with PrefetchIterator(a, DevicePut(dev), depth=2) as pf:
        for _ in range(5):
            got, want = next(pf), next(b)
            for k in STEP_KEYS:
                np.testing.assert_array_equal(got[k].cpu().numpy(), want[k])


def test_xe_steps_on_prefetched_batches_equal_synchronous_copies(dev):
    """The train loop's prefetch against copies made by the step itself
    (`batch_to_device` on the consumer's stream): losses and parameters
    bit for bit, f32."""
    from controllable_xgating_torch.models.captioner import init_captioner
    from controllable_xgating_torch.ops.precision import precision
    from controllable_xgating_torch.train import loop as t_loop
    from controllable_xgating_torch.train.state import create_train_state, make_optimizer
    from controllable_xgating_torch.train.xe import make_xe_train_step
    from controllable_xgating_torch.utils.config import Config

    cfg = Config().replace_flat({
        "model.app_dim": DA, "model.motion_dim": DM, "model.hidden_dim": 64,
        "model.embed_dim": 32, "model.attn_dim": 32, "model.pos_embed_dim": 32,
        "model.vocab_size": 40, "model.pos_vocab_size": 12, "model.num_frames": T,
        "model.max_caption_len": L, "model.max_pos_len": L, "model.dropout": 0.0,
        "data.batch_size": 8, "data.caps_per_video_train": 2, "data.num_prefetch": 2,
        "train.eval_every_epochs": 1000,
    })

    def run(prefetch: bool):
        state = create_train_state(init_captioner(cfg, seed=2, device=dev), cfg)
        step = make_xe_train_step(make_optimizer(cfg, 2), cfg)
        losses = []

        def recording(state, batch):
            state, m = step(state, batch)
            losses.append(m["loss"])
            return state, m

        it = train_iterator()
        with precision("float32"):
            if prefetch:
                t_loop.train_loop(state, recording, it, None, None, None, cfg, epochs=3,
                                  device_put_fn=DevicePut(dev))
            else:
                batches = iter(it)
                for _ in range(3 * it.steps_per_epoch()):
                    recording(state, next(batches))
        torch.cuda.synchronize()
        return [x.item() for x in losses], {n: p.detach().clone()
                                            for n, p in state.params.named_parameters()}

    (la, pa), (lb, pb) = run(True), run(False)
    assert la == lb and len(la) == 6
    for name in pa:
        assert torch.equal(pa[name], pb[name]), name


class CountingPut(DevicePut):
    """A `DevicePut` that counts the pinned buffers it allocates."""

    allocs = 0

    def _pinned(self, bufs, key, src):
        before = bufs.get(key)
        buf = super()._pinned(bufs, key, src)
        CountingPut.allocs += buf is not before
        return buf


def caption_batch(seed: int):
    """16 videos of host arrays (app, motion, frame mask), as a split's."""
    rng = np.random.default_rng(seed)
    app = rng.standard_normal((16, T, DA)).astype(np.float32)
    motion = rng.standard_normal((16, T, DM)).astype(np.float32)
    mask = (np.arange(T)[None] < rng.integers(3, T + 1, 16)[:, None]).astype(np.float32)
    return app, motion, mask


def test_batch_caller_pinned_put_equals_pageable_puts(dev, monkeypatch):
    from controllable_xgating_torch.infer import evaluator
    from controllable_xgating_torch.infer.beam import make_beam_caption_fn
    from controllable_xgating_torch.models.captioner import init_captioner
    from controllable_xgating_torch.ops.precision import precision
    from controllable_xgating_torch.utils import spans
    from controllable_xgating_torch.utils.config import Config

    cfg = Config().replace_flat({
        "model.app_dim": DA, "model.motion_dim": DM, "model.hidden_dim": 64,
        "model.embed_dim": 32, "model.attn_dim": 48, "model.pos_embed_dim": 32,
        "model.vocab_size": 500, "model.pos_vocab_size": 20, "model.num_frames": T})
    params = init_captioner(cfg, seed=3, device=dev).requires_grad_(False)
    fn = make_beam_caption_fn(5, 9, 10, return_all=True)
    batches = [caption_batch(s) for s in (0, 1, 0, 1)]
    pageable = lambda x: [torch.as_tensor(v, device=dev) for v in x]
    monkeypatch.setattr(evaluator, "DevicePut", CountingPut)
    CountingPut.allocs = 0
    with precision("bfloat16"):
        fn(params, *pageable(batches[0]))  # captures the graphs
        call = evaluator.batch_caller(params, fn, 16, None)
        got, allocs = [], []
        with spans.collect() as col:
            for x in batches:
                with spans.request():
                    got.append(call(*x))
                allocs.append(CountingPut.allocs)
        want = [fn(params, *pageable(x)) for x in batches]
    assert allocs == [3, 6, 6, 6]  # two staging sets of three arrays, then reuse
    for g, w in zip(got, want):
        assert len(g) == 3
        for a, b in zip(g, w):  # tokens, scores, tags
            assert torch.equal(a, b)
    put = col.summary()["spans"]["caption.put"]
    assert put["n"] == 4 and put["device_ms"] is not None
