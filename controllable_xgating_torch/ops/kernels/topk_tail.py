"""Fused vocab projection + top-K + logsumexp beam tail (csrc/topk_tail.cu)
and its plain version.

Counterpart of `controllable_xgating_tpu/ops/pallas/topk_tail.py`
(`logits_topk_lanes`), same contract:

    logits = h @ w_out + b_out      (compute dtype, f32 accumulation)
    logits[PAD] = logits[BOS] = -1e30   ([UNK] too when block_unk)
    vals, idx = top_k(logits, k) ; lse = logsumexp(logits, -1)

The true log-probabilities of the winners are vals - lse[:, None]. Ties
go to the lower vocab index, as with `lax.top_k`; the kernel keeps that
order across its vocab chunks too.
"""

from __future__ import annotations

import torch

from controllable_xgating_torch.data.vocab import BOS, PAD, UNK
from controllable_xgating_torch.ops.kernels import build
from controllable_xgating_torch.ops.precision import compute_dtype, mm

NEG = -1e30
CHUNK_COLS = 1024  # vocab columns per block of the first kernel
MAX_K = 8


def topk(x: torch.Tensor, k: int):
    """`lax.top_k` on the last axis: sorted descending, lower index first
    among equal values (a stable sort; `torch.topk` promises no tie order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def logits_topk_plain(h, w_out, b_out, k: int, block_unk: bool = False):
    logits = mm(h, w_out) + b_out.float()
    special = [PAD, BOS] + ([UNK] if block_unk else [])
    logits[:, special] = NEG
    vals, idx = topk(logits, k)
    return vals, idx, torch.logsumexp(logits, dim=-1)


def logits_topk(
    h: torch.Tensor,      # [R, Hd] decoder hidden
    w_out: torch.Tensor,  # [Hd, V]
    b_out: torch.Tensor,  # [V]
    k: int,
    block_unk: bool = False,
):
    """Returns (top-k raw logits [R, k] f32, vocab ids [R, k] int64, lse [R] f32)."""
    if h.device.type == "cpu":
        return logits_topk_plain(h, w_out, b_out, k, block_unk)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"topk_tail kernel takes 1 <= k <= {MAX_K}, got {k}")
    cdt, f32, dev = compute_dtype(), torch.float32, h.device
    r, hd = h.shape
    v = w_out.shape[1]
    hc = h.to(cdt).contiguous()
    w = w_out.to(device=dev, dtype=cdt).contiguous()
    b = b_out.to(device=dev, dtype=f32).contiguous()
    nchunks = -(-v // CHUNK_COLS)
    cand_v = torch.empty((r, nchunks, k), dtype=f32, device=dev)
    cand_i = torch.empty((r, nchunks, k), dtype=torch.int32, device=dev)
    part_m = torch.empty((r, nchunks), dtype=f32, device=dev)
    part_s = torch.empty((r, nchunks), dtype=f32, device=dev)
    vals = torch.empty((r, k), dtype=f32, device=dev)
    idx = torch.empty((r, k), dtype=torch.int32, device=dev)
    lse = torch.empty((r,), dtype=f32, device=dev)
    if r == 0:
        return vals, idx.long(), lse
    ptrs = [
        build.check(hc, "h", (r, hd), cdt, dev),
        build.check(w, "w_out", (hd, v), cdt, dev),
        build.check(b, "b_out", (v,), f32, dev),
        build.check(cand_v, "cand_v", (r, nchunks, k), f32, dev),
        build.check(cand_i, "cand_i", (r, nchunks, k), torch.int32, dev),
        build.check(part_m, "part_m", (r, nchunks), f32, dev),
        build.check(part_s, "part_s", (r, nchunks), f32, dev),
        build.check(vals, "vals", (r, k), f32, dev),
        build.check(idx, "idx", (r, k), torch.int32, dev),
        build.check(lse, "lse", (r,), f32, dev),
    ]
    rc = build.library().cxg_topk_tail_fwd(
        build.dtype_code(hc), *ptrs, r, hd, v, k, int(bool(block_unk)), CHUNK_COLS,
        build.stream_ptr(dev),
    )
    build.raise_on_error(rc, "topk_tail")
    logits_topk.launches += 1
    return vals, idx.long(), lse


logits_topk.launches = 0
