"""Analytic FLOPs / HBM-bytes accounting and roofline utilization.

Counterpart of `controllable_xgating_tpu/utils/roofline.py`: the same
cost model of the benched workloads (beam-5 decode, greedy decode, the XE
and SCST train steps), from the model config alone, so that both packages
count the same FLOPs and bytes for the same config, and

    mfu          = achieved matmul FLOP/s  / peak FLOP/s of the compute dtype
    hbm_bw_util  = modeled HBM bytes moved / (peak HBM bytes/s x measured time)

with the roof that binds. The model is a traffic model, not a simulator:

  * FLOPs count matmul MACs x 2 (elementwise, softmax and top-k are left
    to the bytes side);
  * bytes assume the weights are read once per decode step in the compute
    dtype, the per-row context (keys, enc_proj) every step, the logits
    written and read once per step, h / c round trips in f32;
  * the backward is 2x the forward's matmul FLOPs (dX and dW); remat adds
    one decoder forward.

Every decode workload counts all of its steps: on trained weights, where
captions end early, a call runs fewer, and the shares read low.

Peaks: one NVIDIA H100 SXM, NVIDIA's published data-sheet figures (dense,
no sparsity), not measurements: 989 TFLOP/s bf16 on the tensor cores, 67
TFLOP/s f32 outside them, 3.35 TB/s HBM3. The FLOP peak follows the
compute dtype the call ran under. `device_peaks` raises for a device it
does not know rather than borrow another card's numbers.
"""

from __future__ import annotations

from dataclasses import dataclass

from controllable_xgating_torch.utils.config import ModelConfig

# NVIDIA H100 SXM data sheet: peak FLOP/s by compute dtype, HBM bytes/s
H100_SXM = {"bfloat16": 989e12, "float32": 67e12, "hbm_bytes_s": 3.35e12}


def device_peaks(device_kind: str, dtype: str = "bfloat16") -> tuple[float, float, str]:
    """(peak FLOP/s for `dtype`, peak HBM bytes/s, resolved name) of a
    device name as `torch.cuda.get_device_name` gives it. Raises
    ValueError for a device or dtype without published peaks here."""
    kind = device_kind.lower()
    if "h100" in kind and ("hbm3" in kind or "sxm" in kind) and "pcie" not in kind \
            and "nvl" not in kind:
        if dtype not in ("bfloat16", "float32"):
            raise ValueError(f"no H100 peak for compute dtype {dtype!r}")
        return H100_SXM[dtype], H100_SXM["hbm_bytes_s"], "H100 SXM"
    raise ValueError(f"no published peaks for device {device_kind!r} (known: NVIDIA H100 SXM)")


@dataclass
class Cost:
    flops: float = 0.0
    hbm_bytes: float = 0.0

    def __add__(self, other: "Cost") -> "Cost":
        return Cost(self.flops + other.flops, self.hbm_bytes + other.hbm_bytes)

    def scaled(self, k: float) -> "Cost":
        return Cost(self.flops * k, self.hbm_bytes * k)


def _dims(m: ModelConfig):
    h = m.hidden_dim
    he = 2 * h if m.encoder_bidirectional else h
    hd = h * m.decoder_hidden_mult
    return dict(
        da=m.app_dim, dm=m.motion_dim, h=h, he=he, hd=hd,
        e=m.embed_dim, a=m.attn_dim, g=hd, p=m.pos_embed_dim,
        t=m.num_frames, v=m.vocab_size, vp=m.pos_vocab_size,
    )


def encode_cost(m: ModelConfig, batch: int, ws: int = 2) -> Cost:
    """XGating fusion + BiLSTM over T frames, per batch of videos."""
    d = _dims(m)
    t, h = d["t"], d["h"]
    ndir = 2 if m.encoder_bidirectional else 1
    # xgate per frame: ea, em, ga, gm, fused(split) — 2 MACs each
    xg = 2 * h * (d["da"] + d["dm"] + 4 * h) * t
    # lstm per frame per direction: wih [h,4h] + whh [h,4h]
    lstm = 16 * h * h * t * ndir
    flops = batch * (xg + lstm)
    # bytes: read features once, the weights once (the T steps of the scan
    # reuse them from on-chip memory and L2: charged once), write enc_out
    feat = batch * t * (d["da"] + d["dm"]) * 4  # features arrive f32
    w = (d["da"] * h + d["dm"] * h + 2 * h * h + 2 * h * h) * ws
    w += ndir * 8 * h * h * ws
    out = batch * t * d["he"] * ws
    return Cost(flops, feat + w + out)


def context_cost(m: ModelConfig, batch: int, ws: int = 2) -> Cost:
    """Per-sequence decode-context precompute: keys, enc_proj, psi_g, h0/c0."""
    d = _dims(m)
    t, he = d["t"], d["he"]
    flops = 2 * batch * (
        t * he * d["a"]          # keys
        + t * he * d["g"]        # enc_proj (w_ctx)
        + d["p"] * d["g"]        # psi_g
        + 2 * he * d["hd"]       # init h, c
    )
    bytes_ = batch * t * he * ws * 2 + batch * t * (d["a"] + d["g"]) * ws
    return Cost(flops, bytes_)


def decode_step_cost(
    m: ModelConfig, rows: int, ws: int = 2, with_sampling_tail: bool = False
) -> Cost:
    """One decoder step over `rows` (= B for greedy, B*K for beam)."""
    d = _dims(m)
    hd, e, g, a, t, v = d["hd"], d["e"], d["g"], d["a"], d["t"], d["v"]
    per_row = (
        2 * hd * a            # q = h @ wq
        + 2 * t * a           # scores act . v
        + 2 * t * g           # alpha @ enc_proj
        + 2 * (hd + e) * g    # gate
        + 2 * (e + g + hd) * 4 * hd  # lstm
        + 2 * hd * v          # logits
    )
    weights = (
        hd * a + (hd + e) * g + (e + g + hd) * 4 * hd + hd * v
    ) * ws
    act_per_row = (
        t * (a + g) * ws      # keys + enc_proj re-read every step
        + g * ws              # psi_g
        + 4 * hd * 4          # h, c read+write in f32
        + e * ws              # token embedding row
        + 2 * v * 4           # logits write + read (softmax/top-k fused)
    )
    if with_sampling_tail:
        act_per_row += v * 4  # log-softmax materialized for logprob gather
    return Cost(rows * per_row, weights + rows * act_per_row)


def pos_step_cost(m: ModelConfig, rows: int, ws: int = 2) -> Cost:
    """One POS-generator rollout step over `rows` videos."""
    d = _dims(m)
    h, e, he, vp = d["h"], d["e"], d["he"], d["vp"]
    per_row = 2 * (e + he) * 4 * h + 2 * h * 4 * h + 2 * h * vp
    weights = ((e + he) * 4 * h + h * 4 * h + h * vp) * ws
    act = rows * (he * ws + 4 * h * 4 + e * ws + vp * 4)
    return Cost(rows * per_row, weights + act)


def beam_workload_cost(
    m: ModelConfig, batch: int, beam: int, dec_steps: int, pos_steps: int,
    ws: int = 2,
) -> Cost:
    """Full beam-decode program for one batch (bench workload)."""
    return (
        encode_cost(m, batch, ws)
        + pos_step_cost(m, batch, ws).scaled(pos_steps)
        + context_cost(m, batch * beam, ws)
        + decode_step_cost(m, batch * beam, ws).scaled(dec_steps)
    )


def greedy_workload_cost(
    m: ModelConfig, batch: int, dec_steps: int, pos_steps: int, ws: int = 2
) -> Cost:
    return (
        encode_cost(m, batch, ws)
        + pos_step_cost(m, batch, ws).scaled(pos_steps)
        + context_cost(m, batch, ws)
        + decode_step_cost(m, batch, ws).scaled(dec_steps)
    )


def xe_step_cost(
    m: ModelConfig, batch: int, k: int, length: int, pos_len: int,
    remat: bool = False, ws: int = 2,
) -> Cost:
    """One XE train step: forward + backward (2x forward matmul FLOPs),
    plus one recompute forward of the decoder scan when remat is on."""
    rows = batch * k
    fwd = (
        encode_cost(m, batch, ws)
        # teacher-forced POS pass ~ pos rollout matmuls over Lp-1 steps
        + pos_step_cost(m, rows, ws).scaled(pos_len - 1)
        + context_cost(m, rows, ws)
        + decode_step_cost(m, rows, ws).scaled(length - 1)
    )
    mult = 3.0  # fwd + dX + dW
    cost = fwd.scaled(mult)
    if remat:
        dec_fwd = decode_step_cost(m, rows, ws).scaled(length - 1)
        cost = cost + dec_fwd
    return cost


def scst_step_cost(
    m: ModelConfig, batch: int, dec_steps: int, pos_steps: int, ws: int = 2
) -> Cost:
    """One SCST train step: greedy baseline rollout (no grad), multinomial
    rollout (fwd + ~2x bwd through the REINFORCE logprobs), shared encoder/
    POS/context (grad through sample path only -> ~3x), device CIDEr-D
    (negligible FLOPs, counted as one pass over the token arrays)."""
    shared = (
        encode_cost(m, batch, ws)
        + pos_step_cost(m, batch, ws).scaled(pos_steps)
        + context_cost(m, batch, ws)
    )
    greedy = decode_step_cost(m, batch, ws).scaled(dec_steps)
    sample = decode_step_cost(m, batch, ws, with_sampling_tail=True).scaled(
        dec_steps
    )
    return shared.scaled(3.0) + greedy + sample.scaled(3.0)


def utilization(cost: Cost, seconds: float, device_kind: str, dtype: str = "bfloat16") -> dict:
    """Roofline summary for a measured execution time of `cost` on
    `device_kind` under the compute dtype `dtype`."""
    peak_flops, peak_bw, resolved = device_peaks(device_kind, dtype)
    mfu = cost.flops / seconds / peak_flops
    bw = cost.hbm_bytes / seconds / peak_bw
    t_compute = cost.flops / peak_flops
    t_bytes = cost.hbm_bytes / peak_bw
    return {
        "mfu": round(mfu, 4),
        "hbm_bw_util": round(bw, 4),
        "bound": "compute" if t_compute > t_bytes else "bandwidth",
        "roofline_seconds": round(max(t_compute, t_bytes), 6),
        "measured_seconds": round(seconds, 6),
        "headroom_x": round(seconds / max(t_compute, t_bytes), 2),
        "peaks_device": resolved,
    }
