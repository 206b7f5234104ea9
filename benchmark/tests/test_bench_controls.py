"""The control at a size a CPU test run holds: the reference put in the
program's place in float8 e4m3 comes out not correct against the cell's
limits, while the program at the same size comes out correct. (The
readings that set the limits were taken on the card at the cell's own
size: `benchmark/controls/caption.py`.)"""

from __future__ import annotations

from benchmark.controls import caption
from benchmark.harness import core


def _fails(readings: dict, limits: dict) -> bool:
    return any(readings[k] > limits[k] for k in limits)


def test_caption_control_is_not_correct():
    cell = core.cell_spec("msrvtt.beam5_b256")
    cell["model_cfg"]["model"].update(app_dim=96, motion_dim=64, hidden_dim=64, embed_dim=64,
                                      attn_dim=64, pos_embed_dim=64, vocab_size=2000, num_frames=8)
    cell["traffic_cfg"].update(batch=16, frames=8, pool=2)
    cell["model_cfg"]["decode"].update(max_len=12, max_pos_len=12)
    cell["sample_calls"] = 2
    out = caption.readings(cell, [1, 2], [3, 4], device="cpu")
    for r in out["program"].values():
        assert not _fails(r, cell["limits"]), r
    for side in ("fp8", *caption.FAULTS):
        for r in out[side].values():
            assert _fails(r, cell["limits"]), (side, r)
