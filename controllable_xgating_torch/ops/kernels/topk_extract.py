"""Vocab projection + top-k by iterative arg-max extraction + logsumexp
(csrc/topk_extract.cu), and its plain version.

Counterpart of the Pallas kernel of `experiments/pallas_logits_topk.py`
(`logits_topk_pallas`). Its contract is the beam tail's
(`ops/kernels/topk_tail.py`) without `block_unk`:

    logits = h @ w_out + b_out      (compute dtype, f32 accumulation)
    logits[PAD] = logits[BOS] = -1e30
    vals, idx = top_k(logits, k) ; lse = logsumexp(logits, -1)

so its plain version is the beam tail's. The kernel differs in how it
picks: k rounds of arg-max over each block's vocab chunk, the TPU
kernel's algorithm, where the beam tail's lanes insert into sorted lists.
Under the bf16 policy a chunk is the 128 columns of a 128-row wgmma tile,
the chunk stage the beam tail's kernel runs too (`csrc/topk.cuh`), and
the rounds run on its accumulator registers, on the beam tail's K-major
operand (`topk_tail_weights`: w_out^T, Hd padded with zero columns to a
multiple of 8); under f32 a chunk is 1024 columns, its f32 logits in shared
memory, on SIMT products.
"""

from __future__ import annotations

import torch

from controllable_xgating_torch.ops.kernels import build
from controllable_xgating_torch.ops.kernels.topk_tail import (
    CHUNK_COLS_BF16,
    MAX_K,
    h_operand,
    logits_topk_plain,
    topk_tail_weights,
)
from controllable_xgating_torch.ops.precision import compute_dtype
from controllable_xgating_torch.utils.debug import nan_guard

CHUNK_COLS = 1024  # f32: vocab columns per block, 128 KB of f32 logits for 32 rows


def logits_topk_extract_plain(h, w_out, b_out, k: int):
    return logits_topk_plain(h, w_out, b_out, k)


@nan_guard("K6 topk_extract")
def logits_topk_extract_kernel(
    h: torch.Tensor,      # [R, Hd] decoder hidden
    w_out: torch.Tensor,  # [Hd, V]
    b_out: torch.Tensor,  # [V]
    k: int,
    w_op: torch.Tensor | None = None,  # topk_tail_weights(w_out), else made here
):
    """(top-k raw logits [R, k] f32, vocab ids [R, k] int64, lse [R] f32):
    the kernels (chunks, then the merge) for CUDA tensors, the plain
    version for CPU tensors."""
    if h.device.type == "cpu":
        return logits_topk_extract_plain(h, w_out, b_out, k)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"topk_extract kernel takes 1 <= k <= {MAX_K}, got {k}")
    lib = build.library()
    cdt, f32, dev = compute_dtype(), torch.float32, h.device
    bf16 = cdt == torch.bfloat16
    chunk_cols = CHUNK_COLS_BF16 if bf16 else CHUNK_COLS
    if not bf16 and lib.cxg_topk_extract_smem_bytes(chunk_cols) > build.smem_limit(dev):
        raise ValueError("topk_extract kernel: the f32 chunk needs more shared memory than a "
                         "block has")
    r = h.shape[0]
    v = w_out.shape[1]
    hc = h_operand(h)
    hd = hc.shape[1]
    w = (topk_tail_weights(w_out) if w_op is None else w_op).to(dev)
    b = b_out.to(device=dev, dtype=f32).contiguous()
    nchunks = -(-v // chunk_cols)
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
        build.check(w, "w_out", (v, hd) if bf16 else (hd, v), cdt, dev),
        build.check(b, "b_out", (v,), f32, dev),
        build.check(cand_v, "cand_v", (r, nchunks, k), f32, dev),
        build.check(cand_i, "cand_i", (r, nchunks, k), torch.int32, dev),
        build.check(part_m, "part_m", (r, nchunks), f32, dev),
        build.check(part_s, "part_s", (r, nchunks), f32, dev),
        build.check(vals, "vals", (r, k), f32, dev),
        build.check(idx, "idx", (r, k), torch.int32, dev),
        build.check(lse, "lse", (r,), f32, dev),
    ]
    rc = build.launch(
        lib.cxg_topk_extract_fwd, dev, build.dtype_code(hc), *ptrs, r, hd, v, k, chunk_cols
    )
    build.raise_on_error(rc, "topk_extract")
    logits_topk_extract_kernel.launches += 1
    return vals, idx.long(), lse


logits_topk_extract_kernel.launches = 0
