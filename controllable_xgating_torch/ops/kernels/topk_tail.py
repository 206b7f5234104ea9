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

The lanes beam step on the card (`lanes_beam_step`) runs the same chunk
kernel and, in place of the merge, one launch that does the whole step's
selection and reorder on the beam's carry (`beam_select_kernel`). Its
plain version, `lanes_select_plain` after `logits_topk`, is beam's step
as the reference writes it:
the row candidates (a finished row's PAD continuation at zero cost), the
merge of each video's K*K survivors (`merge_survivors`) and the reorder
with the best-finished register (`reorder_beams`); beam's other tails
form their own candidates and share the merge and the reorder.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from controllable_xgating_torch.data.vocab import BOS, EOS, PAD, UNK
from controllable_xgating_torch.ops.kernels import build
from controllable_xgating_torch.ops.precision import compute_dtype, mm
from controllable_xgating_torch.utils.logging import get_logger
from controllable_xgating_torch.utils.debug import nan_guard

NEG = -1e30
CHUNK_COLS = 512  # f32: vocab columns per block of the SIMT chunk kernel
CHUNK_COLS_BF16 = 128  # bf16: one wgmma tile's columns a block (K6's chunk stage)
MAX_K = 8  # csrc/topk_tail.cu instantiates k = 1 .. 8
# lanes_fits' bound on Hd under bf16, from the chunk kernel that kept h's
# row tile resident (64 x 64 bf16 per 64-deep K step beside a 3-stage ring
# of [128, 64] w tiles and 1 KB of alignment): the tail's routing
# contract, kept as it was when the chunk stage began to stream h
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


def chunk_cols() -> int:
    """Vocab columns per chunk of the chunk kernel under the current policy."""
    return CHUNK_COLS_BF16 if compute_dtype() == torch.bfloat16 else CHUNK_COLS


def padded_hd(hd: int) -> int:
    """Hd as the bf16 kernel reads it: rounded up to a multiple of 8."""
    return -(-hd // 8) * 8


def lanes_fits(k: int, hd: int) -> bool:
    """Whether the kernel takes a beam of width k over decoder width hd
    under the current policy: 1 <= k <= MAX_K, and under bf16 Hd within
    the bound of the resident-tile chunk kernel (`_TILE_K` above; the
    streamed chunk stage takes any Hd in 97 KB, the routing is kept).
    Decided from the shape before any launch; warns once per shape that it
    does not take, where beam routes to the grouped tail (the reference's
    `lanes_fits` convention)."""
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
    dtype, contiguous, and under bf16 with zero columns to padded_hd (an
    operand already made is returned as it is)."""
    hc = h.to(compute_dtype())
    if hc.dtype == torch.bfloat16 and padded_hd(h.shape[1]) != h.shape[1]:
        hc = F.pad(hc, (0, padded_hd(h.shape[1]) - h.shape[1]))
    return hc.contiguous()


def empty_h_operand(rows: int, hd: int, device) -> torch.Tensor:
    """A buffer for the bf16 h operand of `rows` rows of width hd, for a
    kernel to write h into: [rows, padded_hd(hd)], its pad columns zero."""
    make = torch.empty if padded_hd(hd) == hd else torch.zeros
    return make((rows, padded_hd(hd)), dtype=torch.bfloat16, device=device)


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
    f32, dev, r = torch.float32, h.device, h.shape[0]
    vals = torch.empty((r, k), dtype=f32, device=dev)
    idx = torch.empty((r, k), dtype=torch.int32, device=dev)
    lse = torch.empty((r,), dtype=f32, device=dev)
    if r == 0:
        return vals, idx.long(), lse
    lib, chunks = build.library(), _chunk_operands(h, w_out, b_out, k, w_op)
    outs = [
        build.check(vals, "vals", (r, k), f32, dev),
        build.check(idx, "idx", (r, k), torch.int32, dev),
        build.check(lse, "lse", (r,), f32, dev),
    ]
    rc = build.launch(lib.cxg_topk_tail_fwd, dev, *chunks.args, *outs, *chunks.shape,
                      int(bool(block_unk)), chunk_cols())
    build.raise_on_error(rc, "topk_tail")
    logits_topk.launches += 1
    return vals, idx.long(), lse


logits_topk.launches = 0


class _Chunks(NamedTuple):
    args: list  # dtype code, then the pointers of h, w, b and the chunks' scratch
    shape: tuple  # rows, Hd as read, V, k
    keep: tuple  # the tensors behind the pointers, alive until the launch


def _chunk_operands(h, w_out, b_out, k: int, w_op) -> _Chunks:
    """The chunk kernel's operands on h's device under the current policy,
    checked, with its scratch: candidates [R, nchunks, k] (f32 values,
    int32 ids) and (max, sum-exp) partials [R, nchunks] f32."""
    cdt, f32, dev = compute_dtype(), torch.float32, h.device
    bf16 = cdt == torch.bfloat16
    r, v = h.shape[0], w_out.shape[1]
    hc = h_operand(h)
    hd = hc.shape[1]
    w = (topk_tail_weights(w_out) if w_op is None else w_op).to(dev)
    b = b_out.to(device=dev, dtype=f32).contiguous()
    if bf16 and build.library().cxg_topk_wgmma_smem_bytes(hd) > build.smem_limit(dev):
        raise ValueError(f"topk_tail kernel: Hd={hd} needs more shared memory than a block has")
    nchunks = -(-v // chunk_cols())
    cand_v = torch.empty((r, nchunks, k), dtype=f32, device=dev)
    cand_i = torch.empty((r, nchunks, k), dtype=torch.int32, device=dev)
    part_m = torch.empty((r, nchunks), dtype=f32, device=dev)
    part_s = torch.empty((r, nchunks), dtype=f32, device=dev)
    args = [
        build.dtype_code(hc),
        build.check(hc, "h", (r, hd), cdt, dev),
        build.check(w, "w_out", (v, hd) if bf16 else (hd, v), cdt, dev),
        build.check(b, "b_out", (v,), f32, dev),
        build.check(cand_v, "cand_v", (r, nchunks, k), f32, dev),
        build.check(cand_i, "cand_i", (r, nchunks, k), torch.int32, dev),
        build.check(part_m, "part_m", (r, nchunks), f32, dev),
        build.check(part_s, "part_s", (r, nchunks), f32, dev),
    ]
    return _Chunks(args, (r, hd, v, k), (hc, w, b, cand_v, cand_i, part_m, part_s))


# --- the lanes beam step: its plain version, shared with beam's other tails ---

CARRY = ("cum", "finished", "lengths", "tok", "hist", "reg_score", "reg_tokens")


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, K, ...] -> x[b, idx[b, j], ...] for idx [B, K]."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def final_score(cum: torch.Tensor, lengths: torch.Tensor, length_penalty: float) -> torch.Tensor:
    """A hypothesis's ranking score: cum / ((5 + length) / 6) ** lp for
    lp > 0 (GNMT's length penalty), else cum."""
    if length_penalty > 0.0:
        return cum / ((5.0 + lengths.float()) / 6.0) ** length_penalty
    return cum


def merge_survivors(s1_scores: torch.Tensor, s1_idx: torch.Tensor, k: int):
    """Each video's K*K row survivors [B*K, K] (scores, words) -> its K
    best by (score desc, flat index asc): (scores, beam rows, words), each
    [B, K]."""
    b = s1_scores.shape[0] // k
    top_scores, m_idx = topk(s1_scores.reshape(b, k * k), k)
    return top_scores, m_idx // k, torch.gather(s1_idx.reshape(b, k * k), 1, m_idx)


def reorder_beams(carry: dict, t: int, top_scores, beam_idx, new_tok, h_new: list, c_new: list,
                  length_penalty: float) -> dict:
    """Step t's new carry entries from the chosen (scores, beam rows,
    words) [B, K] and every member's new state h_new, c_new [B*K, Hd]: a
    beam from a finished row emits PAD and keeps its length, the others
    emit their word (finishing on EOS) and grow by one; the history is
    gathered with column t set to the emitted words; every member's h and
    c follow the beams; the best-finished register takes the best beam
    that finishes at this step (the first of equals) where it scores above
    the register."""
    b, k = top_scores.shape
    rows = torch.arange(b, device=top_scores.device)
    finished = torch.gather(carry["finished"], 1, beam_idx)
    lengths = torch.gather(carry["lengths"], 1, beam_idx)
    hist = gather_rows(carry["hist"], beam_idx)
    flat_src = (rows[:, None] * k + beam_idx).reshape(b * k)

    now_finished = finished | (new_tok == EOS)
    emit = torch.where(finished, torch.full_like(new_tok, PAD), new_tok)
    hist[:, :, t] = emit
    lengths = torch.where(finished, lengths, lengths + 1)

    just_finished = now_finished & ~finished
    cand = torch.where(just_finished, final_score(top_scores, lengths, length_penalty),
                       torch.full_like(top_scores, NEG))
    row_best = torch.argmax(cand, dim=1)
    row_score = cand[rows, row_best]
    reg_score = carry["reg_score"]
    improve = row_score > reg_score
    return dict(
        h=[x[flat_src] for x in h_new], c=[x[flat_src] for x in c_new],
        tok=emit, cum=top_scores, finished=now_finished, lengths=lengths, hist=hist,
        reg_score=torch.where(improve, row_score, reg_score),
        reg_tokens=torch.where(improve[:, None], hist[rows, row_best], carry["reg_tokens"]),
    )


def lanes_select_plain(carry: dict, t: int, top_v, top_i, lse, h_new, c_new,
                       length_penalty: float) -> dict:
    """The lanes step after the top-K: each row's K candidates from its
    top-K logits (top_v, top_i [B*K, K]) and logsumexp lse [B*K], cum +
    (value - lse), or for a finished row the PAD continuation at zero cost
    (the top-K of a row that is 0 at PAD and -1e30 elsewhere: PAD = 0, then
    ids 1 .. K-1); then `merge_survivors` and `reorder_beams`. Returns the
    new carry entries."""
    b, k = carry["cum"].shape
    dev = top_v.device
    fin_col = carry["finished"].reshape(b * k)[:, None]
    cont_i = torch.arange(k, device=dev)
    cont_v = torch.where(cont_i == PAD, 0.0, NEG)
    s1_scores = carry["cum"].reshape(b * k)[:, None] + torch.where(fin_col, cont_v,
                                                                   top_v - lse[:, None])
    s1_idx = torch.where(fin_col, cont_i, top_i)
    return reorder_beams(carry, t, *merge_survivors(s1_scores, s1_idx, k), [h_new], [c_new],
                         length_penalty)


@nan_guard("K4 topk_tail")
def lanes_beam_step(
    h: torch.Tensor,      # [B*K, Hd] h' (or its operand, `h_operand`)
    w_out: torch.Tensor,  # [Hd, V]
    b_out: torch.Tensor,  # [V]
    w_op,                 # topk_tail_weights(w_out), else made here
    block_unk: bool,
    carry: dict,          # beam's carry: h, c (one member's, in lists) and CARRY
    t: int,
    h_new: torch.Tensor,  # [B*K, Hd] the step's new state, before the reorder
    c_new: torch.Tensor,
    length_penalty: float,
) -> dict:
    """Step t of the lanes beam tail on the card: the chunk kernel (the
    top-K of each row's logits), then `beam_select_kernel`, which does
    `lanes_select_plain`'s selection and reorder and writes the carry's
    own tensors in place; returns the new carry entries (those tensors).
    Its plain version is `lanes_select_plain` on `logits_topk`'s output,
    which beam runs for CPU tensors. Counted as a launch of the top-K tail
    (`logits_topk.launches`)."""
    b, k = carry["cum"].shape
    if h.device.type != "cuda":
        raise ValueError(f"lanes_beam_step launches a CUDA kernel, got tensors on {h.device}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"topk_tail kernel takes 1 <= k <= {MAX_K}, got {k}")
    f32, i64, dev = torch.float32, torch.int64, h.device
    out = {n: carry[n] for n in CARRY}
    out.update(h=carry["h"], c=carry["c"])
    if b == 0:
        return out
    r, hidden, max_len = b * k, h_new.shape[1], carry["hist"].shape[2]
    lib, chunks = build.library(), _chunk_operands(h, w_out, b_out, k, w_op)
    state = [
        build.check(h_new, "h_new", (r, hidden), f32, dev),
        build.check(c_new, "c_new", (r, hidden), f32, dev),
        build.check(carry["h"][0], "h", (r, hidden), f32, dev),
        build.check(carry["c"][0], "c", (r, hidden), f32, dev),
        hidden,
        build.check(carry["cum"], "cum", (b, k), f32, dev),
        build.check(carry["finished"], "finished", (b, k), torch.bool, dev),
        build.check(carry["lengths"], "lengths", (b, k), i64, dev),
        build.check(carry["tok"], "tok", (b, k), i64, dev),
        build.check(carry["hist"], "hist", (b, k, max_len), i64, dev),
        build.check(carry["reg_score"], "reg_score", (b,), f32, dev),
        build.check(carry["reg_tokens"], "reg_tokens", (b, max_len), i64, dev),
    ]
    rc = build.launch(lib.cxg_topk_tail_beam, dev, *chunks.args, *chunks.shape,
                      int(bool(block_unk)), chunk_cols(), *state, max_len, t,
                      float(length_penalty))
    build.raise_on_error(rc, "topk_tail")
    logits_topk.launches += 1
    return out
