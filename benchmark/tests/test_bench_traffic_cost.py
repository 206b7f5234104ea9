"""The traffic repeats bit for bit from a seed, with the same sizes for
every seed; the cost model matches counts made by hand at small sizes;
weights repeat from the seed."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import cost
from benchmark.reference import model as M
from benchmark.tests import tiny
from benchmark.traffic import feature_batches

BIG = 2 ** 35 + 3


def test_feature_batches_repeat_from_seed():
    cell = tiny.caption_cell()
    m, mix = cell["model_cfg"]["model"], cell["traffic_cfg"]
    a, b, c = (feature_batches.make(mix, m, s) for s in (BIG, BIG, BIG + 1))
    assert len(a) == mix["pool"]
    for (x1, y1), (x2, y2), (x3, y3) in zip(a, b, c):
        assert x1.dtype == np.float32 and x1.shape == (8, 5, 24) and y1.shape == (8, 5, 16)
        assert np.array_equal(x1, x2) and np.array_equal(y1, y2)
        assert x3.shape == x1.shape and not np.array_equal(x1, x3)


def test_features_are_standard_normal():
    cell = tiny.caption_cell()
    mix = dict(cell["traffic_cfg"], batch=64)
    x = np.concatenate([a.ravel() for a, _ in feature_batches.make(mix, cell["model_cfg"]["model"], BIG)])
    assert abs(x.mean()) < 0.02 and abs((x ** 2).mean() - 1) < 0.03 and x.min() < 0


def test_weights_repeat_from_seed_and_follow_the_spec():
    m = tiny.caption_cell()["model_cfg"]["model"]
    a, b = M.make_weights(m, BIG, "cpu"), M.make_weights(m, BIG, "cpu")
    for name, shape, init in M.weight_spec(m):
        assert tuple(a[name].shape) == shape and torch.equal(a[name], b[name])
        if init[0] == "u":
            assert a[name].abs().max() <= init[1]
        if init[0] == "lstm_b":
            h = shape[0] // 4
            assert a[name][h:2 * h].eq(1).all() and a[name][:h].eq(0).all()


SMALL = dict(app_dim=3, motion_dim=2, hidden_dim=2, embed_dim=2, attn_dim=2, pos_embed_dim=2,
             vocab_size=7, pos_vocab_size=5, num_frames=2, decoder_hidden_mult=1)


def test_decode_step_cost_by_hand():
    # hd=e=a=g=2, t=2, v=7, one row: q 2*2*2, scores 2*2*2, context 2*2*2,
    # gate 2*(2+2)*2, lstm 2*(2+2+2)*8, logits 2*2*7
    c = cost.decode_step_cost(SMALL, 1, 1)
    assert c.flops == 8 + 8 + 8 + 16 + 96 + 28
    # weights (2*2 + 4*2 + 6*8 + 2*7) * 2 bytes; the video's keys and
    # memory 2*(2+2)*2; the row's psi_g 2*2, h and c 4*2*4, its embedding
    # 2*2; no logits
    assert c.bytes == (4 + 8 + 48 + 14) * 2 + 16 + (4 + 32 + 4)


def test_decode_step_reads_a_videos_context_once_for_its_rows():
    # 3 videos x 5 beams: FLOPs scale with the 15 rows, the context's bytes
    # with the 3 videos, the rows' state with the 15 rows
    one = cost.decode_step_cost(SMALL, 1, 1)
    c = cost.decode_step_cost(SMALL, 3, 15)
    assert c.flops == 15 * one.flops
    assert c.bytes == (4 + 8 + 48 + 14) * 2 + 3 * 16 + 15 * (4 + 32 + 4)


def test_encode_cost_by_hand():
    c = cost.encode_cost(SMALL, 1)
    # xgate 2*2*(3+2+4*2) a frame, BiLSTM 16*2*2 a frame and direction,
    # over 2 frames
    assert c.flops == 2 * 2 * 13 * 2 + 16 * 4 * 2 * 2
    # features 2*(3+2)*4, weights (3*2+2*2+4*4+2*8*4)*2, output 2*4*2
    assert c.bytes == 40 + 180 + 16


def test_beam_call_cost_is_its_parts():
    c = cost.beam_call_cost(SMALL, 3, 5, 4, 6)
    parts = (cost.encode_cost(SMALL, 3).flops + 6 * cost.pos_step_cost(SMALL, 3).flops
             + cost.context_cost(SMALL, 3, 3).flops + 4 * cost.decode_step_cost(SMALL, 3, 15).flops)
    assert c.flops == pytest.approx(parts)


def test_least_seconds_takes_the_binding_roof():
    flops_bound = cost.Cost(flops=989e12, bytes=1.0)
    assert cost.least_seconds(flops_bound) == pytest.approx(1.0)
    assert cost.binding(flops_bound) == "compute"
    bytes_bound = cost.Cost(flops=1.0, bytes=3.35e12)
    assert cost.least_seconds(bytes_bound) == pytest.approx(1.0)
    assert cost.binding(bytes_bound) == "bandwidth"
