"""The caption cell cut to a size a CPU test run holds: widths of a few
units, short captions, a handful of videos (widths are changed here only,
for the CPU; the cell itself runs as its files say)."""

from __future__ import annotations

from benchmark.harness import core

TINY_MODEL = dict(app_dim=24, motion_dim=16, hidden_dim=16, embed_dim=12, attn_dim=12,
                  pos_embed_dim=12, vocab_size=500, num_frames=5)


def caption_cell() -> dict:
    cell = core.cell_spec("msrvtt.beam5_b256")
    cell["model_cfg"]["model"].update(TINY_MODEL)
    cell["traffic_cfg"].update(batch=8, frames=5, pool=2)
    cell["model_cfg"]["decode"].update(max_len=10, max_pos_len=10)
    return cell


def ctx(cell: dict, seed: int = 2 ** 40 + 7, seconds: float = 1.0) -> dict:
    return {"cell": cell, "seed": seed, "seconds": seconds, "trace": False, "device": "cpu",
            "t0": 0.0}
