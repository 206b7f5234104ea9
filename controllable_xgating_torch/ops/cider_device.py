"""CIDEr-D computed on the device from token ids: the SCST reward.

Counterpart of `controllable_xgating_tpu/ops/cider_device.py`, exactly
(not approximately), with no host sync and no strings:

  * n-grams are hashed over token ids by two independent 32-bit
    polynomial hashes (token <-> word is a bijection, so n-gram identity
    over ids is n-gram identity over words);
  * the train corpus' document frequencies are counted once on the host
    with the same hashes (`host_tables`, numpy), sorted lexicographically
    by (h1, h2) and searched on the device by a bisection bounded to one
    bucket of h1's top bits;
  * CIDEr-D's clipped tf-idf dot product is a sum over reference
    positions: sum_j min(ctf_j, rtf_j) * idf_j^2 equals the sum over
    unique n-grams of min(g_c, g_r) * g_r, and the squared norms are
    sum_i tf_i * idf_i^2, all dense and static-shaped.

The hashes are uint32 arithmetic held in int64 tensors, in [0, 2^32):
torch has little uint32 support, and the bisection's `<` needs the
unsigned order. No product exceeds 2^48 (`_mul_add`), so nothing relies
on signed overflow. `metrics/cider.py::CiderDScorer` is the host reference.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from controllable_xgating_torch.data.vocab import BOS, EOS, PAD

MAX_N = 4
SIGMA = 6.0
_M1 = 2654435761
_M2 = 0x85EBCA6B
_MASK = 0xFFFFFFFF
REF_CHUNK = 1024  # videos per reference-stats pass


@dataclass
class CiderRewardTables:
    """Corpus statistics for the reward, on one device.

    The df table is packed: row i of `table_rows` is (h1, h2, the bits of
    df as f32, 0), int64 in [0, 2^32), sorted by (h1, h2), and
    `table_dir[b]` is the (start, end) run of rows whose h1 has top
    `dir_bits` bits b, so that a lookup bisects `bucket_steps` rounds in
    one run. The per-reference statistics are computed once
    (`precompute_ref_stats`) and gathered per batch; `ref_h1` and `ref_h2`
    are only compared for equality, so they are held as int32 (the same
    32 bits). The column form (`table_h1`, `table_h2`, `table_df`) is only
    for a table built by hand: `_idf_lookup` bisects its full range."""

    log_n: torch.Tensor                        # scalar f32: log(#df videos)
    ref_caps: torch.Tensor                     # [N, S, L] int32 reference captions
    ref_counts: torch.Tensor                   # [N] int32 real captions per video
    table_rows: Optional[torch.Tensor] = None  # [M, 4] int64
    table_dir: Optional[torch.Tensor] = None   # [2^dir_bits, 2] int32
    dir_bits: int = 0
    bucket_steps: int = 0
    table_h1: Optional[torch.Tensor] = None    # [M] int64 (column form)
    table_h2: Optional[torch.Tensor] = None    # [M] int64
    table_df: Optional[torch.Tensor] = None    # [M] f32
    ref_h1: Optional[torch.Tensor] = None      # [N, S, 4, L] int32
    ref_h2: Optional[torch.Tensor] = None      # [N, S, 4, L] int32
    ref_valid: Optional[torch.Tensor] = None   # [N, S, 4, L] bool
    ref_tf: Optional[torch.Tensor] = None      # [N, S, 4, L] f32 self term frequencies
    ref_idf: Optional[torch.Tensor] = None     # [N, S, 4, L] f32
    ref_norm: Optional[torch.Tensor] = None    # [N, S, 4] f32 tf-idf norms
    ref_wordlen: Optional[torch.Tensor] = None  # [N, S] f32

    def tensors(self) -> dict:
        """{field: tensor} of the fields that hold one."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)}

    def to(self, device) -> "CiderRewardTables":
        return dataclasses.replace(self, **{k: v.to(device) for k, v in self.tensors().items()})

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors().values())


# ------------------------------------------------------------------ hashes

def _mul_add(a, m: int, t):
    """(a * m + t) mod 2^32 for a, t in [0, 2^32) held as int64, with m
    split into 16-bit halves so that no product exceeds 2^48."""
    hi, lo = m >> 16, m & 0xFFFF
    return ((((a * hi) & 0xFFFF) << 16) + a * lo + t) & _MASK


def _is_word(tokens: torch.Tensor) -> torch.Tensor:
    return (tokens != PAD) & (tokens != EOS) & (tokens != BOS)


def _device_hashes(tokens: torch.Tensor):
    """n-gram hashes of [..., L] id arrays: (h1, h2) int64 [..., 4, L] and
    valid bool [..., 4, L]. Position i holds the n-gram starting at i; a
    window that leaves the words is invalid with hashes of its prefix."""
    word = _is_word(tokens)
    t = tokens.long() + 1

    def shift(x, k):
        if k == 0:
            return x
        return torch.cat([x[..., k:], torch.zeros_like(x[..., :k])], dim=-1)

    h1s, h2s, valids = [], [], []
    a = torch.zeros_like(t)
    b = torch.zeros_like(t)
    v = torch.ones_like(word)
    for n in range(MAX_N):
        tk = shift(t, n)
        a = _mul_add(a, _M1, tk)
        b = _mul_add(b, _M2, tk)
        v = v & shift(word, n)
        h1s.append(a)
        h2s.append(b)
        valids.append(v)
    return torch.stack(h1s, -2), torch.stack(h2s, -2), torch.stack(valids, -2)


def _as_int32(h: torch.Tensor) -> torch.Tensor:
    """[0, 2^32) int64 -> the int32 of the same 32 bits."""
    return (h - ((h >> 31) << 32)).to(torch.int32)


# -------------------------------------------------------------- host build

def _bucket_directory(h1s: np.ndarray, h2s: np.ndarray, dfs: np.ndarray):
    """(dir [2^k, 2] int32, rows [M, 4] uint32, k, bucket_steps) for a
    sorted table; k aims at ~1 key per bucket, capped at 22 (a 32 MB
    directory at MSR-VTT's scale)."""
    m = len(h1s)
    k = int(np.clip(math.ceil(math.log2(m + 1)), 4, 22))
    buckets = (h1s >> np.uint32(32 - k)).astype(np.int64)
    counts = np.bincount(buckets, minlength=1 << k)
    edges = np.zeros((1 << k) + 1, np.int64)
    np.cumsum(counts, out=edges[1:])
    dir_rows = np.stack([edges[:-1], edges[1:]], axis=1).astype(np.int32)
    steps = max(math.ceil(math.log2(int(counts.max(initial=0)) + 1)), 1)
    rows = np.stack([h1s.astype(np.uint32), h2s.astype(np.uint32),
                     np.ascontiguousarray(dfs.astype(np.float32)).view(np.uint32),
                     np.zeros(m, np.uint32)], axis=1)
    return dir_rows, rows, k, steps


def _df_table(caps: np.ndarray, ncaps: np.ndarray, df_video_indices: Sequence[int]):
    """Sorted unique keys h1 << 32 | h2 (uint64) of the n-grams of the
    given videos' real captions, and their document frequencies: the
    number of listed videos (a video listed twice counts twice) in whose
    captions the n-gram occurs. The native library's `build_df`
    (`utils/native.py`) returns the same table, bit for bit, but takes
    about 4x this lexsort's time at MSR-VTT's caption scale (10000 videos
    x 20 captions: 9.3-10.6 against 2.5-2.6 s on an H100 machine's host,
    PERF.md §6), so the table is built here."""
    vids = np.asarray(df_video_indices, np.int64)
    keys, docs = [], []
    for start in range(0, len(vids), REF_CHUNK):
        chunk = vids[start:start + REF_CHUNK]
        h1, h2, valid = (x.numpy() for x in _device_hashes(torch.from_numpy(
            np.ascontiguousarray(caps[chunk]).astype(np.int64))))  # [C, S, 4, L]
        real = np.arange(caps.shape[1])[None, :] < np.asarray(ncaps)[chunk][:, None]
        valid &= real[:, :, None, None]
        doc = np.broadcast_to((start + np.arange(len(chunk)))[:, None, None, None], valid.shape)
        keys.append((h1[valid].astype(np.uint64) << np.uint64(32)) | h2[valid].astype(np.uint64))
        docs.append(doc[valid])
    keys = np.concatenate(keys or [np.zeros(0, np.uint64)])
    docs = np.concatenate(docs or [np.zeros(0, np.int64)])
    if len(keys) == 0:
        return keys, np.zeros(0, np.float32)
    order = np.lexsort((docs, keys))  # by key, then by document
    keys, docs = keys[order], docs[order]
    first = np.ones(len(keys), bool)  # first occurrence of each (key, document)
    first[1:] = (keys[1:] != keys[:-1]) | (docs[1:] != docs[:-1])
    keys = keys[first]
    starts = np.flatnonzero(np.concatenate([[True], keys[1:] != keys[:-1]]))
    df = np.diff(np.append(starts, len(keys))).astype(np.float32)
    return keys[starts], df


def host_tables(caps: np.ndarray, ncaps: np.ndarray,
                df_video_indices: Sequence[int]) -> CiderRewardTables:
    """The host half of `build_reward_tables`: the df table over the
    given videos (the train split for SCST) and the directory, as CPU
    tensors, without the reference statistics. A corpus without n-grams
    gives one zero row."""
    keys, dfs = _df_table(caps, ncaps, df_video_indices)
    if len(keys) == 0:
        keys, dfs = np.zeros(1, np.uint64), np.zeros(1, np.float32)
    h1s = (keys >> np.uint64(32)).astype(np.uint32)
    h2s = (keys & np.uint64(_MASK)).astype(np.uint32)
    dir_rows, rows, dir_bits, steps = _bucket_directory(h1s, h2s, dfs)
    return CiderRewardTables(
        log_n=torch.tensor(math.log(max(len(df_video_indices), 1)), dtype=torch.float32),
        ref_caps=torch.from_numpy(np.asarray(caps, np.int32)),
        ref_counts=torch.from_numpy(np.asarray(ncaps, np.int32)),
        table_rows=torch.from_numpy(rows.astype(np.int64)),
        table_dir=torch.from_numpy(dir_rows),
        dir_bits=dir_bits,
        bucket_steps=steps,
    )


def precompute_ref_stats(tables: CiderRewardTables) -> CiderRewardTables:
    """Fill the per-reference statistics on the tables' device, REF_CHUNK
    videos at a time."""
    outs = []
    with torch.no_grad():
        for refs in torch.split(tables.ref_caps, REF_CHUNK):
            rh1, rh2, rv = _device_hashes(refs)  # [C, S, 4, L]
            r_idf = _idf_lookup(tables, rh1, rh2, rv)
            r_tf = _self_tf(rh1, rh2, rv)
            outs.append((_as_int32(rh1), _as_int32(rh2), rv, r_tf, r_idf,
                         torch.sqrt((r_tf * r_idf * r_idf).sum(-1)), _word_len(refs)))
    cat = [torch.cat(parts) for parts in zip(*outs)]
    return dataclasses.replace(tables, ref_h1=cat[0], ref_h2=cat[1], ref_valid=cat[2],
                               ref_tf=cat[3], ref_idf=cat[4], ref_norm=cat[5],
                               ref_wordlen=cat[6])


def build_reward_tables(caps: np.ndarray, ncaps: np.ndarray, df_video_indices: Sequence[int],
                        device="cuda") -> CiderRewardTables:
    """The reward tables on `device`: df over `df_video_indices` (the
    train split for SCST), references `caps` [N, S, L] with `ncaps` [N]
    real captions for every video."""
    return precompute_ref_stats(host_tables(caps, ncaps, df_video_indices).to(device))


# ------------------------------------------------------------- device side

def _idf_lookup(tables: CiderRewardTables, h1: torch.Tensor, h2: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """idf = log_n - log(max(df, 1)) by a lexicographic (h1, h2) bisection;
    0 at invalid positions. Tables from `host_tables` bisect one bucket's
    run of the packed rows; hand-built column tables their full range. The
    two give the same bits."""
    if tables.table_rows is not None and tables.table_dir is not None and tables.dir_bits > 0:
        m = tables.table_rows.shape[0]
        se = tables.table_dir[h1 >> (32 - tables.dir_bits)].long()  # [..., 2]
        lo, hi = se[..., 0], se[..., 1]
        for _ in range(tables.bucket_steps):
            mid = (lo + hi) // 2
            row = tables.table_rows[mid.clamp(0, m - 1)]
            t1, t2 = row[..., 0], row[..., 1]
            less = (t1 < h1) | ((t1 == h1) & (t2 < h2))
            lo = torch.where(less, mid + 1, lo)
            hi = torch.where(less, hi, mid)
        row = tables.table_rows[lo.clamp(0, m - 1)]
        found = (row[..., 0] == h1) & (row[..., 1] == h2)
        df = _as_int32(row[..., 2]).view(torch.float32)
    else:
        m = tables.table_h1.shape[0]
        lo = torch.zeros(h1.shape, dtype=torch.long, device=h1.device)
        hi = torch.full(h1.shape, m, dtype=torch.long, device=h1.device)
        for _ in range(max(int(math.ceil(math.log2(m + 1))), 1)):
            mid = (lo + hi) // 2
            t1 = tables.table_h1[mid.clamp(0, m - 1)]
            t2 = tables.table_h2[mid.clamp(0, m - 1)]
            less = (t1 < h1) | ((t1 == h1) & (t2 < h2))
            lo = torch.where(less, mid + 1, lo)
            hi = torch.where(less, hi, mid)
        idx = lo.clamp(0, m - 1)
        found = (tables.table_h1[idx] == h1) & (tables.table_h2[idx] == h2)
        df = tables.table_df[idx]
    df = torch.where(found, df, torch.zeros_like(df))
    idf = tables.log_n - torch.log(torch.clamp(df, min=1.0))
    return torch.where(valid, idf, torch.zeros_like(idf))


def _self_tf(h1: torch.Tensor, h2: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """tf of the n-gram at each position within its own sequence, h* and
    valid [..., 4, L]: the count of valid positions with the same hashes."""
    eq = ((h1[..., :, None] == h1[..., None, :]) & (h2[..., :, None] == h2[..., None, :])
          & valid[..., :, None] & valid[..., None, :])
    return eq.sum(-1).float() * valid


def _word_len(tokens: torch.Tensor) -> torch.Tensor:
    return _is_word(tokens).sum(-1).float()


def cider_d_device(tables: CiderRewardTables, cand: torch.Tensor,
                   video_indices: torch.Tensor) -> torch.Tensor:
    """CIDEr-D [B] f32 of each candidate [B, Lc] (decoded ids, EOS and PAD
    allowed) against its video's references, `video_indices` [B] indexing
    the tables; `CiderDScorer` with the tables' df. Only the candidate's
    side is computed here: the references' statistics are gathered."""
    vi = video_indices.long()
    nref = tables.ref_counts[vi]              # [B]
    rh1, rh2, rv = tables.ref_h1[vi], tables.ref_h2[vi], tables.ref_valid[vi]  # [B, S, 4, L]
    r_tf, r_idf = tables.ref_tf[vi], tables.ref_idf[vi]
    r_norm = tables.ref_norm[vi]              # [B, S, 4]
    lr = tables.ref_wordlen[vi]               # [B, S]
    s = rh1.shape[1]

    ch1, ch2, cv = _device_hashes(cand)       # [B, 4, Lc]
    c_idf = _idf_lookup(tables, ch1, ch2, cv)
    c_tf = _self_tf(ch1, ch2, cv)

    # c_in_r[b, s, n, j] = #{i: candidate n-gram i == reference n-gram j}
    c1, c2 = _as_int32(ch1), _as_int32(ch2)
    eq = ((c1[:, None, :, :, None] == rh1[:, :, :, None, :])
          & (c2[:, None, :, :, None] == rh2[:, :, :, None, :])
          & cv[:, None, :, :, None] & rv[:, :, :, None, :])  # [B, S, 4, Lc, L]
    c_in_r = eq.sum(3).float()

    dot = (torch.minimum(c_in_r, r_tf) * r_idf * r_idf).sum(-1)  # [B, S, 4]
    c_norm = torch.sqrt((c_tf * c_idf * c_idf).sum(-1))          # [B, 4]
    denom = c_norm[:, None, :] * r_norm
    sim = torch.where(denom > 0.0, dot / torch.clamp(denom, min=1e-12), torch.zeros_like(dot))

    delta = _word_len(cand)[:, None] - lr
    sim = sim * torch.exp(-(delta ** 2) / (2.0 * SIGMA ** 2))[:, :, None]
    ref_mask = (torch.arange(s, device=cand.device)[None, :] < nref[:, None]).float()
    per_ref = sim.mean(-1) * 10.0             # [B, S]
    return (per_ref * ref_mask).sum(-1) / torch.clamp(nref.float(), min=1.0)
