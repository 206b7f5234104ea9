"""The split evaluation's batch caller (`infer/evaluator.py::batch_caller`)
on the CPU: its put (`data/features.py::DevicePut`) hands the caption
function tensors that share the host arrays' memory, the outputs equal
the caption function's on tensors made by hand, with and without a frame
mask, and each call opens the span `caption.put` once, before the caption
function's spans. The benchmark's reader of that span
(`benchmark/metrics/put_ms.caption.py`) reads nothing without it. This
file imports no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_batch_caller.py
"""

import os

import numpy as np
import pytest
import torch

from controllable_xgating_torch.infer import evaluator
from controllable_xgating_torch.infer.evaluator import batch_caller, make_greedy_caption_fn
from controllable_xgating_torch.utils import spans
from controllable_xgating_torch.utils.config import Config

B, T, DA, DM = 3, 4, 12, 10
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_params():
    from controllable_xgating_torch.models.captioner import init_captioner

    cfg = Config().replace_flat({
        "model.app_dim": DA, "model.motion_dim": DM, "model.hidden_dim": 16,
        "model.embed_dim": 8, "model.attn_dim": 8, "model.pos_embed_dim": 8,
        "model.vocab_size": 30, "model.pos_vocab_size": 9, "model.num_frames": T})
    return init_captioner(cfg, seed=3, device="cpu")


def host_batch(seed: int = 0, masked: bool = True):
    rng = np.random.default_rng(seed)
    app = rng.standard_normal((B, T, DA)).astype(np.float32)
    motion = rng.standard_normal((B, T, DM)).astype(np.float32)
    mask = (np.arange(T)[None] < np.array([4, 2, 3])[:, None]).astype(np.float32)
    return app, motion, mask if masked else None


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
def test_batch_caller_equals_the_caption_fn(masked):
    params, fn = tiny_params(), make_greedy_caption_fn(5, 6)
    app, motion, mask = host_batch(masked=masked)
    got = batch_caller(params, fn, B, None)(app, motion, mask)
    want = fn(params, torch.tensor(app), torch.tensor(motion),
              None if mask is None else torch.tensor(mask))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
def test_cpu_put_shares_the_host_arrays(masked):
    """On the CPU the put copies nothing: the caption function gets f32
    tensors on the host arrays' memory, and None for a missing mask."""
    seen = []

    def fn(params, app, motion, frame_mask=None):
        seen.append((app, motion, frame_mask))
        return (app.sum(),)

    app, motion, mask = host_batch(masked=masked)
    batch_caller(tiny_params(), fn, B, None)(app, motion, mask)
    (a, m, k), = seen
    assert a.data_ptr() == app.ctypes.data and m.data_ptr() == motion.ctypes.data
    assert a.dtype == m.dtype == torch.float32 and a.device.type == "cpu"
    if mask is None:
        assert k is None
    else:
        assert k.data_ptr() == mask.ctypes.data


def test_caption_put_is_one_span_per_request():
    params, fn = tiny_params(), make_greedy_caption_fn(5, 6)
    call = batch_caller(params, fn, B, None)
    with spans.collect() as col:
        for seed in range(3):
            with spans.request():
                call(*host_batch(seed))
    puts = [s for s in col.spans if s.name == "caption.put"]
    assert len(puts) == 3 and len({s.request for s in puts}) == 3
    for put in puts:
        assert put.parent is None
        mine = [s for s in col.spans if s.request == put.request]
        assert [s.name for s in mine].count("caption.put") == 1
        encode = next(s for s in mine if s.name == "encode")
        assert put.t1 <= encode.t0  # the put ends before the caption function starts
    got = col.summary()
    assert got["requests"] == 3 and got["spans"]["caption.put"]["n"] == 3


def test_the_batch_caller_has_one_name():
    assert not hasattr(evaluator, "_batch_caller")
    pkg = os.path.join(ROOT, "controllable_xgating_torch")
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(d, f), encoding="utf-8") as fh:
                    assert "_batch_caller" not in fh.read(), os.path.join(d, f)


def test_put_ms_reader_reads_the_put_span_per_request():
    from benchmark.harness import core

    read = core.load_module("metrics", "put_ms.caption").read
    assert read({}) is None  # an untraced run: no program spans
    win = {"requests": 4, "spans": {"encode": {"n": 4, "host_ms": 20.0, "self_ms": 1.0,
                                               "device_ms": 30.0}}}
    assert read({"program": {"window": win}}) is None  # a program without the span
    win["spans"]["caption.put"] = {"n": 4, "host_ms": 10.0, "self_ms": 10.0, "device_ms": 12.0}
    assert read({"program": {"window": win}}) == pytest.approx(2.5)
    assert read({"program": {"window": {"requests": 0, "spans": {}}}}) is None
