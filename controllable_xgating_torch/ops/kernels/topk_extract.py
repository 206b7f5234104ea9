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
The Pallas kernel's vocab tile shrank with the row count to fit VMEM; here
the chunk is fixed, and its f32 logits stay in shared memory.
"""

from __future__ import annotations

import torch

from controllable_xgating_torch.ops.kernels import build
from controllable_xgating_torch.ops.kernels.topk_tail import MAX_K, logits_topk_plain
from controllable_xgating_torch.ops.precision import compute_dtype

CHUNK_COLS = 1024  # vocab columns per block: 128 KB of f32 logits for 32 rows


def logits_topk_extract_plain(h, w_out, b_out, k: int):
    return logits_topk_plain(h, w_out, b_out, k)


def logits_topk_extract_kernel(
    h: torch.Tensor,      # [R, Hd] decoder hidden
    w_out: torch.Tensor,  # [Hd, V]
    b_out: torch.Tensor,  # [V]
    k: int,
):
    """(top-k raw logits [R, k] f32, vocab ids [R, k] int64, lse [R] f32):
    the kernels (chunks, then the merge) for CUDA tensors, the plain
    version for CPU tensors."""
    if h.device.type == "cpu":
        return logits_topk_extract_plain(h, w_out, b_out, k)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"topk_extract kernel takes 1 <= k <= {MAX_K}, got {k}")
    lib = build.library()
    smem, limit = lib.cxg_topk_extract_smem_bytes(CHUNK_COLS), build.smem_limit(h.device)
    if smem > limit:
        raise ValueError(f"topk_extract kernel: {smem} B of shared memory per block, the card "
                         f"allows {limit}")
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
    rc = lib.cxg_topk_extract_fwd(
        build.dtype_code(hc), *ptrs, r, hd, v, k, CHUNK_COLS, build.stream_ptr(dev)
    )
    build.raise_on_error(rc, "topk_extract")
    logits_topk_extract_kernel.launches += 1
    return vals, idx.long(), lse


logits_topk_extract_kernel.launches = 0
