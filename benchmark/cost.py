"""The cost model: the operations and bytes a piece of work needs, from
the configuration alone, and the chip's published peaks.

Copied from the port's `utils/roofline.py` with two corrections:
  * a decode step writes no logits: the work is the vocabulary's
    projection and a top-K of each row, and whether logits reach memory
    is the implementation's choice (the port's top-K kernel never writes
    them), so no logits bytes are counted;
  * a decode step reads each video's context (keys and projected memory)
    once: a beam's K rows attend over the same frames, and whether each
    row re-reads them is the implementation's choice.
(The port's training cost is not copied: no cell trains yet.)

FLOPs are matmul MACs x 2; bytes count each input once and each output
once: weights in the compute dtype once per step, each video's context
and each row's state every step, features in f32 once.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense: 989e12 FLOP/s
bf16 on the tensor cores, 67e12 FLOP/s f32 outside them, 3.35e12 B/s of
HBM3, at the card's full power limit of 700 W (a run records the limit
it ran under beside its numbers).
"""

from __future__ import annotations

from dataclasses import dataclass

PEAKS = {"bfloat16": 989e12, "float32": 67e12, "hbm_bytes_s": 3.35e12, "power_limit_w": 700.0}


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0

    def __add__(self, other: "Cost") -> "Cost":
        return Cost(self.flops + other.flops, self.bytes + other.bytes)

    def scaled(self, k: float) -> "Cost":
        return Cost(self.flops * k, self.bytes * k)


def least_seconds(c: Cost, dtype: str = "bfloat16") -> float:
    return max(c.flops / PEAKS[dtype], c.bytes / PEAKS["hbm_bytes_s"])


def binding(c: Cost, dtype: str = "bfloat16") -> str:
    """Which roof binds `c`: "compute" or "bandwidth"."""
    return "compute" if c.flops / PEAKS[dtype] > c.bytes / PEAKS["hbm_bytes_s"] else "bandwidth"


def _dims(m: dict) -> dict:
    h = int(m["hidden_dim"])
    hd = h * int(m.get("decoder_hidden_mult", 1))
    return dict(da=int(m["app_dim"]), dm=int(m["motion_dim"]), h=h, he=2 * h, hd=hd,
                e=int(m["embed_dim"]), a=int(m["attn_dim"]), g=hd, p=int(m["pos_embed_dim"]),
                t=int(m["num_frames"]), v=int(m["vocab_size"]), vp=int(m["pos_vocab_size"]))


def encode_cost(m: dict, batch: int, ws: int = 2) -> Cost:
    """XGating fusion and the BiLSTM over T frames, for `batch` videos."""
    d = _dims(m)
    t, h = d["t"], d["h"]
    xg = 2 * h * (d["da"] + d["dm"] + 4 * h) * t
    lstm = 16 * h * h * t * 2
    feat = batch * t * (d["da"] + d["dm"]) * 4
    w = (d["da"] * h + d["dm"] * h + 4 * h * h + 2 * 8 * h * h) * ws
    return Cost(batch * (xg + lstm), feat + w + batch * t * d["he"] * ws)


def context_cost(m: dict, videos: int, rows: int, ws: int = 2) -> Cost:
    """Keys and projected memory per video; psi_g and the decoder's first
    state per row (a caption's own POS tags make its psi)."""
    d = _dims(m)
    t, he = d["t"], d["he"]
    flops = 2 * videos * t * he * (d["a"] + d["g"]) + 2 * rows * (d["p"] * d["g"] + 2 * he * d["hd"])
    return Cost(flops, videos * t * he * ws + videos * t * (d["a"] + d["g"]) * ws)


def decode_step_cost(m: dict, videos: int, rows: int, ws: int = 2) -> Cost:
    """One decoder step over `rows` rows of `videos` videos: attention,
    gate, LSTM cell and the vocabulary projection; each video's context
    read once, no logits written."""
    d = _dims(m)
    hd, e, g, a, t, v = d["hd"], d["e"], d["g"], d["a"], d["t"], d["v"]
    per_row = (2 * hd * a + 2 * t * a + 2 * t * g + 2 * (hd + e) * g
               + 2 * (e + g + hd) * 4 * hd + 2 * hd * v)
    weights = (hd * a + (hd + e) * g + (e + g + hd) * 4 * hd + hd * v) * ws
    context = t * (a + g) * ws
    state = g * ws + 4 * hd * 4 + e * ws  # psi_g, h and c, the word's embedding
    return Cost(rows * per_row, weights + videos * context + rows * state)


def pos_step_cost(m: dict, rows: int, ws: int = 2) -> Cost:
    d = _dims(m)
    h, e, he, vp = d["h"], d["e"], d["he"], d["vp"]
    per_row = 2 * (e + he) * 4 * h + 2 * h * 4 * h + 2 * h * vp
    weights = ((e + he) * 4 * h + h * 4 * h + h * vp) * ws
    return Cost(rows * per_row, weights + rows * (he * ws + 4 * h * 4 + e * ws + vp * 4))


def beam_call_cost(m: dict, batch: int, beam: int, dec_steps: int, pos_steps: int) -> Cost:
    """A beam caption call over `batch` videos with every step run."""
    return (encode_cost(m, batch) + pos_step_cost(m, batch).scaled(pos_steps)
            + context_cost(m, batch, batch)
            + decode_step_cost(m, batch, batch * beam).scaled(dec_steps))
