"""Fused vocab projection + top-K + logsumexp beam tail (csrc/topk_tail.cu)
and its plain version.

Counterpart of `controllable_xgating_tpu/ops/pallas/topk_tail.py`
(`logits_topk_lanes`), same contract:

    logits = h @ w_out + b_out      (compute dtype, f32 accumulation)
    logits[PAD] = logits[BOS] = -1e30   ([UNK] too when block_unk)
    vals, idx = top_k(logits, k) ; lse = logsumexp(logits, -1)

The true log-probabilities of the winners are vals - lse[:, None]. Ties
go to the lower vocab index, as with `lax.top_k`; the kernel keeps that
order across its vocab chunks too. Under the bf16 policy the kernel reads
w_out K-major ([V, Hd], `topk_tail_weights`, made once per caption call)
into wgmma, with Hd padded by zero columns to a multiple of 8 (16-byte TMA
rows; a zero column adds nothing to a logit); under f32 it reads w_out as
it is, on SIMT products.

`lanes_fits` is the shape predicate that beam consults before it picks
this tail, as the reference's `lanes_fits` is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from controllable_xgating_torch.data.vocab import BOS, PAD, UNK
from controllable_xgating_torch.ops.kernels import build
from controllable_xgating_torch.ops.precision import compute_dtype, mm
from controllable_xgating_torch.utils.logging import get_logger
from controllable_xgating_torch.utils.debug import nan_guard

NEG = -1e30
CHUNK_COLS = 512  # vocab columns per block of the first kernel
MAX_K = 8  # csrc/topk_tail.cu instantiates k = 1 .. 8
# the bf16 chunk kernel's shared memory (topk_wgmma_smem_bytes in
# csrc/topk_tail.cu): h's resident row tile of 64 x 64 bf16 per 64-deep K
# step, a 3-stage ring of [128, 64] bf16 w tiles, 1 KB of alignment
_TILE_K, _A_TILE, _RING = 64, 64 * 64 * 2, 3 * 128 * 64 * 2
SMEM_OPTIN = 232448  # dynamic shared memory a Hopper block may opt in to
_lanes_warned: set = set()


_ID_MASK = 0xFFFFFFFF
_BLOCK = 128  # prescreen block of topk


def _key_topk(x: torch.Tensor, ids: torch.Tensor, k: int) -> torch.Tensor:
    """The ids of the k largest (value, -id) pairs of x [R, n] f32 with ids
    [R, n] or [n] int64, best first: one `torch.topk` on unique int64 keys,
    whose high 32 bits are the value's order-preserving int32 image (its
    bits, those of a negative value XOR 0x7FFFFFFF; -0.0 made +0.0 first, as
    the stable sort takes them as equal) and whose low 32 bits are
    0xFFFFFFFF - id, so that of two equal values the lower id wins."""
    bits = (x + 0.0).view(torch.int32)  # -0.0 + 0.0 is +0.0
    bits = bits ^ ((bits >> 31) & 0x7FFFFFFF)  # a negative value's low 31 bits flipped
    top = torch.topk((bits.long() << 32) | (_ID_MASK - ids), k, dim=-1).values
    return _ID_MASK - (top & _ID_MASK)


def topk(x: torch.Tensor, k: int):
    """`lax.top_k` on the last axis of f32 `x`: sorted descending, lower
    index first among equal values, the order of a stable descending sort.

    `torch.topk` promises no tie order, so it runs on unique int64 keys
    (`_key_topk`). A row longer than 4 k blocks of 128 is first cut to its
    k best blocks, ranked by (block max desc, block index asc): a block
    outside them has k blocks before it, each holding a value above its
    best, or an equal value at a lower id, so it holds none of the top k.
    The values are gathered from `x`."""
    if x.dtype != torch.float32:
        raise TypeError(f"topk takes float32, got {x.dtype}")
    shape, v = x.shape, x.shape[-1]
    x2 = x.reshape(-1, v)
    dev = x.device
    if v <= 4 * k * _BLOCK:
        idx = _key_topk(x2, torch.arange(v, device=dev), k)
    else:
        full = v // _BLOCK
        bm = x2.unfold(1, _BLOCK, _BLOCK).amax(-1)  # [R, full] maxima of the whole blocks
        if v > full * _BLOCK:
            bm = torch.cat([bm, x2[:, full * _BLOCK:].amax(-1, keepdim=True)], 1)
        blk = _key_topk(bm, torch.arange(bm.shape[1], device=dev), k)
        cols = (blk[:, :, None] * _BLOCK + torch.arange(_BLOCK, device=dev)).flatten(1)
        pool = x2.gather(1, cols.clamp(max=v - 1))
        # a column past the row's end (in the last block) loses to every
        # column of it: the pool holds at least k real ones
        pool = torch.where(cols < v, pool, -float("inf"))
        idx = _key_topk(pool, torch.where(cols < v, cols, _ID_MASK), k)
    return x2.gather(1, idx).reshape(*shape[:-1], k), idx.reshape(*shape[:-1], k)


def logits_topk_plain(h, w_out, b_out, k: int, block_unk: bool = False):
    logits = mm(h, w_out) + b_out.float()
    special = [PAD, BOS] + ([UNK] if block_unk else [])
    logits[:, special] = NEG
    vals, idx = topk(logits, k)
    return vals, idx, torch.logsumexp(logits, dim=-1)


def padded_hd(hd: int) -> int:
    """Hd as the bf16 kernel reads it: rounded up to a multiple of 8."""
    return -(-hd // 8) * 8


def lanes_fits(k: int, hd: int) -> bool:
    """Whether the kernel takes a beam of width k over decoder width hd
    under the current policy: 1 <= k <= MAX_K, and under bf16 the chunk
    kernel's shared memory within a block's. Decided from the shape before
    any launch; warns once per shape that it does not take, where beam
    routes to the grouped tail (the reference's `lanes_fits` convention)."""
    nk = -(-padded_hd(hd) // _TILE_K)
    smem = nk * _A_TILE + _RING + 1024
    fits = 1 <= k <= MAX_K and (compute_dtype() != torch.bfloat16 or smem <= SMEM_OPTIN)
    if not fits and (k, hd) not in _lanes_warned:
        _lanes_warned.add((k, hd))
        get_logger("cxg.ops").warning(
            'topk_mode="lanes": the tail kernel takes 1 <= k <= %d and Hd <= %d under bf16, '
            "got k=%d, Hd=%d; beam takes the grouped tail",
            MAX_K, (SMEM_OPTIN - _RING - 1024) // _A_TILE * _TILE_K, k, hd,
        )
    return fits


def h_operand(h: torch.Tensor) -> torch.Tensor:
    """The kernel's h operand under the current policy: in the compute
    dtype, contiguous, and under bf16 with zero columns to padded_hd."""
    hc = h.to(compute_dtype())
    if hc.dtype == torch.bfloat16:
        hc = F.pad(hc, (0, padded_hd(h.shape[1]) - h.shape[1]))
    return hc.contiguous()


def topk_tail_weights(w_out: torch.Tensor) -> torch.Tensor:
    """The kernel's w_out operand under the current policy, to be made
    once per caption call: w_out^T [V, padded_hd(Hd)] (K-major, zero
    columns past Hd) in bf16, w_out [Hd, V] in f32."""
    cdt = compute_dtype()
    w = w_out.to(cdt)
    if cdt != torch.bfloat16:
        return w.contiguous()
    hd = w.shape[0]
    return F.pad(w.t(), (0, padded_hd(hd) - hd)).contiguous()


@nan_guard("K4 topk_tail")
def logits_topk(
    h: torch.Tensor,      # [R, Hd] decoder hidden
    w_out: torch.Tensor,  # [Hd, V]
    b_out: torch.Tensor,  # [V]
    k: int,
    block_unk: bool = False,
    w_op: torch.Tensor | None = None,  # topk_tail_weights(w_out), else made here
):
    """Returns (top-k raw logits [R, k] f32, vocab ids [R, k] int64, lse [R] f32)."""
    if h.device.type == "cpu":
        return logits_topk_plain(h, w_out, b_out, k, block_unk)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"topk_tail kernel takes 1 <= k <= {MAX_K}, got {k}")
    cdt, f32, dev = compute_dtype(), torch.float32, h.device
    r = h.shape[0]
    v = w_out.shape[1]
    bf16 = cdt == torch.bfloat16
    hc = h_operand(h)
    hd = hc.shape[1]
    w = (topk_tail_weights(w_out) if w_op is None else w_op).to(dev)
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
    lib = build.library()
    if bf16 and lib.cxg_topk_wgmma_smem_bytes(hd) > build.smem_limit(dev):
        raise ValueError(f"topk_tail kernel: Hd={hd} needs more shared memory than a block has")
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
        lib.cxg_topk_tail_fwd, dev, build.dtype_code(hc), *ptrs, r, hd, v, k,
        int(bool(block_unk)), CHUNK_COLS,
    )
    build.raise_on_error(rc, "topk_tail")
    logits_topk.launches += 1
    return vals, idx.long(), lse


logits_topk.launches = 0
