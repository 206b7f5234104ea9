#!/usr/bin/env python3
"""Drive the PyTorch port's captioning and XE-training paths once on one
NVIDIA GPU.

    python3 chip_smoke.py                 # from the root of a checkout

Phases, each fatal on failure:
  1. refuse to run without a CUDA device; print the card's name and
     power limit;
  2. build the CUDA kernels of both paths from `csrc/`;
  3. hold every caption kernel against its plain PyTorch version at the
     shapes the path gives it (MSR-VTT width: 256 videos x 26 frames,
     beam 5), under the f32 policy (rtol 1e-4, atol 1e-5) and the bf16
     policy (a bound per kernel, `BF16_TOL`), and time both with CUDA
     events;
  4. caption 256 seeded videos with random seeded weights under the bf16
     policy through `evaluate_split` with `make_beam_caption_fn` (beam 5),
     then with `make_greedy_caption_fn`; every kernel of each path must
     have launched, and the metrics must be finite;
  5. under the f32 policy, the kernel path and the plain path
     (`set_fused_kernels(False)`) must give the same caption for >= 98% of
     the videos, beam and greedy;
  6. training at MSR-VTT width (batch 64 x 5 captions, vocab 10000, 35 POS
     tags) on seeded features and captions through `TrainBatchIterator`:
     the cross-entropy kernels (K5, forward and backward) against their
     plain version at the step's shape [8640, 10000] (rtol 1e-4; atol
     1e-5 forward, 1e-6 x max |dx| backward, at N(0, 1) cotangents and at
     the loss's), timed beside `F.cross_entropy`; 1 + 5 joint-stage steps
     under the bf16 policy at dropout 0.5 through the kernels (train
     videos/s, one forward and one backward launch per step); one f32 step
     with label smoothing 0.1 through the kernels and through the plain
     path from the same state (loss and grad norm within rtol 1e-4, the
     Adam first moments within a relative norm of 1e-5, parameters within
     atol 1e-5); ten steps on one batch at dropout 0,
     whose loss must fall;
then print one JSON line of kernel results and, last, one JSON line
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
B, T, K, MAX_LEN = 256, 26, 5, 28
VOCAB, POS_VOCAB = 10000, 35
F32_TOL = dict(rtol=1e-4, atol=1e-5)  # 10x the reference's own CPU bound: other sum order
# bf16 operands: kernel and plain version round the same operands and sum
# in f32, so they differ by summation order only. Each bound is a few times
# the max |kernel - plain| of two H100 runs (PERF.md, Findings). The xgate
# output is itself rounded to bf16: one bf16 ulp of |out| in [0.5, 1), the
# top binade of its tanh.
BF16_TOL = {
    "xgate": dict(rtol=0.0, atol=2.0 ** -8),
    "pos_lstm": dict(rtol=0.0, atol=1e-5),
    "attn_lstm": dict(rtol=0.0, atol=1e-4),
    "topk_tail": dict(rtol=0.0, atol=1e-5),
}
# K5's dx is mostly ~1/V (1e-4 at V = 10000) and below: its atol is this
# share of max |dx|, with F32_TOL's rtol; a backward kernel that scales
# the g_mean / V term by 1/2 fails it
XENT_DX_ATOL = 1e-6
AGREE_MIN = 0.98
TRAIN_VIDEOS = 128  # two batches of 64 per epoch
# the card's peaks for the kernels' bounds (H100 SXM data sheet, dense):
# HBM bytes/s, bf16 tensor-core and f32 non-tensor-core operations/s
HBM_BYTES_S, BF16_OPS_S, F32_OPS_S = 3.35e12, 989e12, 67e12
PATH_KERNELS = {
    "beam-5": ("xgate", "pos_lstm", "attn_lstm", "topk_tail"),
    "greedy": ("xgate", "pos_lstm", "attn_lstm"),
    "xe-train": ("xent_fwd", "xent_bwd"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


class NumpyStore:
    """In-memory feature store: the `get_batch` / `frame_mask` interface of
    the port's `eval_batches`."""

    def __init__(self, app, motion, counts):
        self.app, self.motion, self.counts = app, motion, counts

    def get_batch(self, idx):
        return self.app[idx], self.motion[idx]

    def frame_mask(self, idx):
        import numpy as np

        return (np.arange(self.app.shape[1])[None, :] < self.counts[idx][:, None]).astype(np.float32)


def make_corpus(cfg, seed: int):
    """Seeded features (some videos padded in time) and a synthetic
    reference set over a 10000-word vocabulary."""
    import numpy as np
    from types import SimpleNamespace

    from controllable_xgating_torch.data.vocab import Vocab

    rng = np.random.default_rng(seed)
    app = rng.normal(size=(B, T, cfg.model.app_dim)).astype(np.float32)
    mot = rng.normal(size=(B, T, cfg.model.motion_dim)).astype(np.float32)
    counts = np.where(rng.random(B) < 0.5, T, rng.integers(T // 2, T, B))
    t = np.arange(T)[None, :, None]
    app *= t < counts[:, None, None]
    mot *= t < counts[:, None, None]
    vocab = Vocab([f"w{i}" for i in range(VOCAB - 4)])
    caps = np.zeros((B, 3, MAX_LEN), np.int64)
    caps[:, :, 0] = 1  # BOS
    caps[:, :, 1:9] = rng.integers(4, VOCAB, (B, 3, 8))
    caps[:, :, 9] = 2  # EOS
    info = SimpleNamespace(
        splits={"test": list(range(B))}, video_ids=[f"video{i}" for i in range(B)], vocab=vocab,
    )
    labels = {"caps": caps, "ncaps": np.full(B, 3)}
    return NumpyStore(app, mot, counts), labels, info


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_cases(params, dev):
    """(name, kernel call, plain call) at the path's shapes, with seeded
    inputs, built under the current policy. The kernels get their weights
    cast once beforehand, as the caption loops give them."""
    import torch

    from controllable_xgating_torch.models.decoder import init_decoder_state, make_decode_context
    from controllable_xgating_torch.models.pos_generator import _summary_gates
    from controllable_xgating_torch.ops.kernels import attn_lstm, pos_lstm, topk_tail, xgate
    from controllable_xgating_torch.ops.precision import compute_dtype

    g = torch.Generator(device=dev).manual_seed(7)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    ri = lambda lo, hi, s: torch.randint(lo, hi, s, generator=g, device=dev)
    enc, pos, dec = params.encoder, params.pos, params.decoder
    he, hp, hd = enc.out_dim, pos.lstm.hidden_dim, dec.hidden_dim
    xa, xm = rn(B * T, enc.xgate.wa.shape[0]), rn(B * T, enc.xgate.wm.shape[0])
    e_pos = pos.embed[ri(4, POS_VOCAB, (B,))]
    sg = _summary_gates(pos, torch.tanh(rn(B, he)))
    h_pos, c_pos = torch.tanh(rn(B, hp)), rn(B, hp)
    r = B * K
    mask = (torch.arange(T, device=dev)[None] < ri(T // 2, T + 1, (r, 1))).float()
    ctx = make_decode_context(dec, torch.tanh(rn(r, T, he)), torch.tanh(rn(r, dec.w_psi.shape[0])), mask)
    h_dec, c_dec = init_decoder_state(dec, torch.tanh(rn(r, he)))
    e_dec = dec.embed[ri(4, VOCAB, (r,))]
    h_out = torch.tanh(rn(r, hd))
    step = (dec, e_dec, h_dec, c_dec, ctx.keys, ctx.enc_proj, ctx.psi_g, ctx.frame_mask)
    pos_w, step_w = pos_lstm.pos_lstm_weights(pos), attn_lstm.attn_lstm_weights(dec)
    w_out = dec.w_out.to(compute_dtype())
    return [
        ("xgate", lambda: xgate.xgate_fuse_kernel(enc.xgate, xa, xm),
         lambda: xgate.xgate_fuse_plain(enc.xgate, xa, xm)),
        ("pos_lstm", lambda: pos_lstm.pos_lstm_step_kernel(pos, e_pos, sg, h_pos, c_pos, pos_w),
         lambda: pos_lstm.pos_lstm_step_plain(pos, e_pos, sg, h_pos, c_pos)),
        ("attn_lstm", lambda: attn_lstm.attn_lstm_step_kernel(*step, step_w),
         lambda: attn_lstm.attn_lstm_step_plain(*step)),
        ("topk_tail", lambda: topk_tail.logits_topk(h_out, w_out, dec.b_out, K),
         lambda: topk_tail.logits_topk_plain(h_out, dec.w_out, dec.b_out, K)),
    ], (h_out, dec.w_out, dec.b_out)


def check_kernels(params, dev, policy: str, tols: dict) -> dict:
    """Kernel vs plain on the same inputs, within `tols[name]`; returns
    {name: (max_abs_err, ms, plain_ms)}."""
    import torch

    from controllable_xgating_torch.ops.kernels.topk_tail import logits_topk_plain

    cases, tail_inputs = kernel_cases(params, dev)
    out = {}
    for name, kern, plain in cases:
        tol = tols[name]
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        if name == "topk_tail":
            # ids must agree wherever the plain K-th and (K+1)-th values are
            # further apart than the tolerance
            vals, idx, lse = got
            rv, ri, _ = logits_topk_plain(*tail_inputs, K + 1)
            clear = rv[:, K - 1] - rv[:, K] > tol["atol"] + tol["rtol"] * rv[:, K - 1].abs()
            same = (idx.sort(1).values == ri[:, :K].sort(1).values).all(1)
            if not bool(same[clear].all()):
                fail(f"{name} [{policy}]: top-{K} ids differ on {int((~same & clear).sum())} clear rows")
            in_order = (idx == ri[:, :K]).all(1).float().mean().item()
            print(f"kernel {name} [{policy}]: {int(clear.sum())}/{len(clear)} rows clear of ties, "
                  f"ids in plain order on {in_order:.4f} of rows")
            got, ref = (vals, lse), (ref[0], ref[2])
        err = 0.0
        for a, b in zip(got, ref):
            if not torch.isfinite(a).all():
                fail(f"{name} [{policy}]: non-finite output")
            err = max(err, (a.float() - b.float()).abs().max().item())
            if not torch.allclose(a.float(), b.float(), **tol):
                fail(f"{name} [{policy}]: max |kernel - plain| = {err:.3e} outside {tol}")
        ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
        print(f"kernel {name} [{policy}]: max_abs_err {err:.3e}  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
        out[name] = (err, ms, plain_ms)
    return out


def bound(nbytes: float, ops: float, ops_s: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it): the larger of the
    bytes moved (each input read once, each output written once) over HBM
    bandwidth and the operations over the peak rate for their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / ops_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def caption_bounds(params) -> dict:
    """Bounds of the caption kernels at the shapes `kernel_cases` gives
    them, bf16 policy: operands in bf16 (2 bytes), biases, cell state,
    masks and f32 results in 4, products on the tensor cores."""
    c = 2
    enc, pos, dec = params.encoder, params.pos, params.decoder
    da, h = enc.xgate.wa.shape
    dm = enc.xgate.wm.shape[0]
    rows = B * T
    e_p, hp = pos.embed.shape[1], pos.lstm.hidden_dim
    r, hd, e, a, g, v = B * K, dec.hidden_dim, dec.embed.shape[1], dec.attn.wq.shape[1], \
        dec.w_psi.shape[1], dec.vocab_size
    return {
        # ea, em, two gates and the split Wf: 2 R H (Da + Dm + 4H)
        "xgate": bound(c * (rows * (da + dm + h) + h * (da + dm + 4 * h)) + 4 * 5 * h,
                       2 * rows * h * (da + dm + 4 * h), BF16_OPS_S),
        # gates = e @ wih_e + s_gates + h @ whh + b, then the cell
        "pos_lstm": bound(c * (B * (e_p + hp) + (e_p + hp) * 4 * hp)
                          + 4 * (B * 4 * hp + 4 * hp + 3 * B * hp),
                          2 * B * (e_p + hp) * 4 * hp, BF16_OPS_S),
        # keys and projected memory [R, T, A|G] dominate the bytes
        "attn_lstm": bound(c * (r * (hd + e + T * (a + g) + 2 * g)
                                + hd * a + a + (hd + e) * g + (e + g + hd) * 4 * hd)
                           + 4 * (r * hd + 2 * r * T + a + g + 4 * hd + 2 * r * hd),
                           2 * r * (hd * a + (hd + e) * g + (e + g + hd) * 4 * hd)
                           + 2 * r * T * (a + g), BF16_OPS_S),
        # h @ w_out over the whole vocab; K values, ids and the lse out
        "topk_tail": bound(c * (r * hd + hd * v) + 4 * v + 4 * r * (2 * K + 1),
                           2 * r * hd * v, BF16_OPS_S),
    }


def xent_bounds(n: int, v: int) -> dict:
    """K5 at [n, v] f32 with int64 targets: the forward reads the logits
    once and writes three [n] statistics; the backward reads the logits,
    targets, lse and three cotangents and writes dx. About four f32
    operations per element each (max or subtract, exp, add or fma)."""
    return {
        "xent_fwd": bound(4 * n * v + 8 * n + 12 * n, 4 * n * v, F32_OPS_S),
        "xent_bwd": bound(8 * n * v + 8 * n + 16 * n, 4 * n * v, F32_OPS_S),
    }


def make_train_corpus(cfg, seed: int):
    """TRAIN_VIDEOS seeded videos with `seqs_per_video` captions and POS
    tag sequences each: BOS, 5-25 random ids, EOS, PAD to MAX_LEN."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n, s = TRAIN_VIDEOS, cfg.data.seqs_per_video
    app = rng.normal(size=(n, T, cfg.model.app_dim)).astype(np.float32)
    mot = rng.normal(size=(n, T, cfg.model.motion_dim)).astype(np.float32)
    counts = np.where(rng.random(n) < 0.5, T, rng.integers(T // 2, T, n))
    lengths = rng.integers(6, MAX_LEN - 1, (n, s))
    col = np.arange(MAX_LEN)[None, None, :]
    words = lengths[..., None]
    caps = np.where(col <= words, rng.integers(4, VOCAB, (n, s, MAX_LEN)), 0)
    pos = np.where(col <= words, rng.integers(4, POS_VOCAB, (n, s, MAX_LEN)), 0)
    for arr in (caps, pos):
        arr[..., 0] = 1  # BOS
        np.put_along_axis(arr, words, 2, axis=-1)  # EOS after the words
    ncaps = rng.integers(s // 2, s + 1, n)
    return NumpyStore(app, mot, counts), caps.astype(np.int32), pos.astype(np.int32), ncaps


def check_xent(dev, n: int, v: int, smoothing: float = 0.1) -> dict:
    """K5 forward and backward against the plain version at [n, v] f32,
    with PAD targets on a tenth of the rows. The backward is held at two
    sets of cotangents: N(0, 1) draws, which give each term of dx its own
    scale, and those of the label-smoothed masked loss, where most of dx
    is ~1/V; its atol is scaled to the output (`XENT_DX_ATOL` x max |dx|).
    Times the kernels, the plain version and `F.cross_entropy` (forward,
    then its backward alone) at the loss's cotangents. Returns
    {name: (max_abs_err, ms, plain_ms, library_ms)}."""
    import torch
    import torch.nn.functional as F

    from controllable_xgating_torch.data.vocab import PAD
    from controllable_xgating_torch.ops.kernels.xent import (
        xent_bwd_kernel,
        xent_fwd_kernel,
        xent_row_stats_plain,
    )

    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(n, v, generator=g, device=dev) * 3.0
    t = torch.randint(4, v, (n,), generator=g, device=dev)
    t[torch.rand(n, generator=g, device=dev) < 0.1] = PAD
    mask = (t != PAD).float()
    # d/d(lse, tgt, mean) of sum(mask * ((1-eps)(lse - tgt) + eps (lse - mean)))
    cot = (mask, -(1.0 - smoothing) * mask, -smoothing * mask)

    def weighted(stats, cotangents=cot):
        return sum((w * s).sum() for w, s in zip(cotangents, stats))

    out = {}
    with torch.no_grad():
        got, ref = xent_fwd_kernel(x, t), xent_row_stats_plain(x, t)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b in zip(("lse", "x[t]", "mean"), got, ref):
        err = max(err, (a - b).abs().max().item())
        if not torch.isfinite(a).all() or not torch.allclose(a, b, **F32_TOL):
            fail(f"xent_fwd: {name} max |kernel - plain| = {(a - b).abs().max().item():.3e}")
    with torch.no_grad():
        lib_loss = F.cross_entropy(x, t, ignore_index=PAD, reduction="sum",
                                   label_smoothing=smoothing)
    print(f"kernel xent_fwd: F.cross_entropy {lib_loss.item():.6e} vs the statistics' loss "
          f"{weighted(got).item():.6e}")
    with torch.no_grad():
        out["xent_fwd"] = (err, cuda_ms(lambda: xent_fwd_kernel(x, t)),
                           cuda_ms(lambda: xent_row_stats_plain(x, t)),
                           cuda_ms(lambda: F.cross_entropy(x, t, ignore_index=PAD, reduction="sum",
                                                           label_smoothing=smoothing)))
    lse = got[0]
    xr = x.detach().requires_grad_(True)
    plain_stats = xent_row_stats_plain(xr, t)
    draws = tuple(torch.randn(n, generator=g, device=dev) for _ in range(3))
    err = 0.0
    for label, c in (("N(0,1) cotangents", draws), ("the loss's cotangents", cot)):
        # the plain version's own lse, so that both get the same inputs
        dx = xent_bwd_kernel(x, t, plain_stats[0].detach(), *c)
        (ref_dx,) = torch.autograd.grad(weighted(plain_stats, c), xr, retain_graph=True)
        tol = dict(rtol=F32_TOL["rtol"], atol=XENT_DX_ATOL * ref_dx.abs().max().item())
        e = (dx - ref_dx).abs().max().item()
        print(f"kernel xent_bwd [{label}]: max |kernel - plain| {e:.3e}, median |dx| "
              f"{ref_dx.abs().median().item():.3e}, tolerance {tol}")
        if not torch.isfinite(dx).all() or not torch.allclose(dx, ref_dx, **tol):
            fail(f"xent_bwd [{label}]: max |kernel - plain| = {e:.3e} outside {tol}")
        err = max(err, e)
    plain_loss = weighted(plain_stats)
    lib = F.cross_entropy(xr, t, ignore_index=PAD, reduction="sum", label_smoothing=smoothing)
    out["xent_bwd"] = (err, cuda_ms(lambda: xent_bwd_kernel(x, t, lse, *cot)),
                       cuda_ms(lambda: torch.autograd.grad(plain_loss, xr, retain_graph=True)),
                       cuda_ms(lambda: torch.autograd.grad(lib, xr, retain_graph=True)))
    for name, (e, ms, plain_ms, lib_ms) in out.items():
        print(f"kernel {name} [float32, {n}x{v}]: max_abs_err {e:.3e}  kernel {ms:.4f} ms  "
              f"plain {plain_ms:.4f} ms  F.cross_entropy {lib_ms:.4f} ms")
    return out


def train_phase(cfg, dev) -> dict:
    """The XE-training path; returns the xent launch counts of the bf16
    main-path run."""
    import numpy as np
    import torch

    from controllable_xgating_torch.data.loader import TrainBatchIterator
    from controllable_xgating_torch.models.captioner import init_captioner
    from controllable_xgating_torch.ops import kernels
    from controllable_xgating_torch.ops.dispatch import set_fused_kernels
    from controllable_xgating_torch.ops.precision import set_compute_dtype
    from controllable_xgating_torch.train.state import create_train_state, make_optimizer
    from controllable_xgating_torch.train.xe import make_xe_train_step

    store, caps, pos, ncaps = make_train_corpus(cfg, seed=1)
    bs, k = cfg.data.batch_size, cfg.data.caps_per_video_train
    batches = iter(TrainBatchIterator(store, caps, pos, ncaps, np.arange(TRAIN_VIDEOS), bs, k,
                                      seed=0))
    spe = TRAIN_VIDEOS // bs

    def fresh(c):
        state = create_train_state(init_captioner(c, seed=0, device=dev), c)
        return state, make_xe_train_step(make_optimizer(c, spe, "joint"), c, "joint")

    # the main path: bf16 policy, kernels on, dropout 0.5; 1 warm-up + 5 timed steps
    set_compute_dtype("bfloat16")
    set_fused_kernels(None)
    state, step = fresh(cfg)
    kernels.reset_launch_counts()
    state, m = step(state, next(batches))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        state, m = step(state, next(batches))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kernels.launch_counts()
    print(f"xe-train launches {counts}")
    if any(counts[n] != 6 for n in PATH_KERNELS["xe-train"]):
        fail(f"xe-train: the xent kernels did not launch once per step in 6 steps: {counts}")
    host = {key: float(val) for key, val in m.items()}
    if not all(math.isfinite(val) for val in host.values()):
        fail(f"xe-train: metrics {host}")
    print(f"xe-train [bfloat16, joint, dropout {cfg.model.dropout}]: {5 * bs / dt:.1f} videos/s, "
          f"{5 * bs * k / dt:.1f} sequences/s ({dt / 5 * 1e3:.1f} ms/step over 5 steps), "
          f"last step {json.dumps(host)}")

    # one f32 step from the same state, batch and generator seed, kernels vs
    # plain path, with label smoothing 0.1 so that every statistic of K5
    # carries a gradient. Adam's first moment after one step is 0.1 x the
    # clipped gradient: all parameters' together are held to the plain
    # path's within a relative norm of 1e-5 (the updated parameters move by
    # ~lr x sign and would show only the gradient's sign; a parameter whose
    # gradient nearly cancels differs by ~1e-4 of its own norm from sum
    # order alone)
    set_compute_dtype("float32")
    batch = next(batches)
    c_ls = cfg.replace_flat({"train.label_smoothing": 0.1})
    res = {}
    for fused in (None, False):
        set_fused_kernels(fused)
        state, step = fresh(c_ls)
        state, m = step(state, batch)
        opt = state.opt_state
        res[fused] = ({key: val.item() for key, val in m.items()},
                      [p.detach().clone() for p in state.params.parameters()],
                      [opt.state[p]["exp_avg"].clone() for p in state.params.parameters()])
        del state, opt
    set_fused_kernels(None)
    (mk, pk, gk), (mp, pp, gp) = res[None], res[False]
    for key in ("loss", "grad_norm"):
        if not math.isclose(mk[key], mp[key], rel_tol=1e-4):
            fail(f"xe-train f32 {key}: kernels {mk[key]} vs plain {mp[key]}")
    perr = max((a - b).abs().max().item() for a, b in zip(pk, pp))
    flat = lambda ms: torch.cat([m.flatten() for m in ms])
    gerr = ((flat(gk) - flat(gp)).norm() / flat(gp).norm()).item()
    print(f"xe-train [float32, label smoothing 0.1] kernels vs plain path: loss {mk['loss']:.7g} "
          f"vs {mp['loss']:.7g}, grad_norm {mk['grad_norm']:.7g} vs {mp['grad_norm']:.7g}, "
          f"relative norm of the Adam first-moment difference {gerr:.3e}, "
          f"max |param difference| after the update {perr:.3e}")
    if gerr > 1e-5:
        fail(f"xe-train f32: the gradients differ by a relative norm {gerr:.3e} > 1e-5")
    if perr > 1e-5:
        fail(f"xe-train f32: updated parameters differ by {perr:.3e} > 1e-5")

    # ten steps on one fixed batch at dropout 0: the loss must fall
    set_compute_dtype("bfloat16")
    c0 = cfg.replace_flat({"model.dropout": 0.0})
    state, step = fresh(c0)
    losses = [step(state, batch)[1]["loss"] for _ in range(10)]
    losses = [float(x) for x in losses]
    print(f"xe-train [bfloat16, dropout 0] ten steps on one batch: loss {losses}")
    if not losses[-1] < losses[0]:
        fail("xe-train: ten steps on one batch did not lower the loss")
    return counts


def caption_fn(beam: bool, fused):
    from controllable_xgating_torch.infer.beam import make_beam_caption_fn
    from controllable_xgating_torch.infer.evaluator import make_greedy_caption_fn

    if beam:
        return make_beam_caption_fn(K, MAX_LEN, MAX_LEN, fused=fused)
    return make_greedy_caption_fn(MAX_LEN, MAX_LEN, fused=fused)


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs only on a CUDA device")
    if not os.path.isdir(os.path.join(HERE, "controllable_xgating_torch")):
        fail("run from the root of a checkout: controllable_xgating_torch/ not found")
    sys.path.insert(0, HERE)
    # the card's name and power limit, as nvidia-smi prints them
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip())
    dev = torch.device("cuda:0")

    from controllable_xgating_torch.models.captioner import init_captioner
    from controllable_xgating_torch.ops import kernels
    from controllable_xgating_torch.ops.dispatch import set_fused_kernels
    from controllable_xgating_torch.ops.kernels import build
    from controllable_xgating_torch.ops.precision import set_compute_dtype
    from controllable_xgating_torch.utils.config import load_config

    t0 = time.time()
    lib = build.build()
    print(f"built {os.path.basename(lib)} in {time.time() - t0:.1f} s")
    with open(os.path.join(build.build_dir(), "build.log")) as f:
        for line in f:
            if "entry function" in line or "registers" in line or "bytes stack frame" in line:
                print("ptxas:", line.strip())

    cfg = load_config(os.path.join(HERE, "configs", "msrvtt.json"),
                      {"model.vocab_size": VOCAB, "model.pos_vocab_size": POS_VOCAB})
    params = init_captioner(cfg, seed=0, device=dev)
    store, labels, info = make_corpus(cfg, seed=0)

    set_compute_dtype("float32")
    check_kernels(params, dev, "float32", {n: F32_TOL for n in BF16_TOL})
    set_compute_dtype("bfloat16")
    results = check_kernels(params, dev, "bfloat16", BF16_TOL)

    # the main path, bf16 policy, kernels on: beam 5, then greedy, each
    # through evaluate_split, counting launches around each run
    from controllable_xgating_torch.infer.evaluator import evaluate_split

    set_fused_kernels(None)
    counts = {}
    for beam, label in ((True, "beam-5"), (False, "greedy")):
        kernels.reset_launch_counts()
        metrics, caps = evaluate_split(
            params, store, labels, info, split="test", batch_size=B, max_len=MAX_LEN,
            max_pos_len=MAX_LEN, caption_fn=caption_fn(beam, None),
        )
        torch.cuda.synchronize()
        counts[label] = kernels.launch_counts()
        print(f"{label} launches {counts[label]}")
        if not all(counts[label][n] for n in PATH_KERNELS[label]):
            fail(f"a kernel of the {label} path never launched: {counts[label]}")
        if len(caps) != B or not all(math.isfinite(v) for v in metrics.values()):
            fail(f"{label}: {len(caps)} captions, metrics {metrics}")
        print(f"{label} metrics", json.dumps(metrics))

    # throughput and caption agreement, kernel path vs plain path
    app, mot = (torch.as_tensor(x, device=dev) for x in store.get_batch(np.arange(B)))
    mask = torch.as_tensor(store.frame_mask(np.arange(B)), device=dev)

    def run(beam, fused):
        tokens = caption_fn(beam, fused)(params, app, mot, mask)[0]
        torch.cuda.synchronize()
        return tokens

    for beam, label in ((True, "beam-5"), (False, "greedy")):
        rates = {"kernels": [], "plain": []}
        for fused in (None, False, False, None):
            t = time.perf_counter()
            run(beam, fused)
            rates["kernels" if fused is None else "plain"].append(B / (time.perf_counter() - t))
        print(f"{label} captions/s [bfloat16], 256 videos per call, kernel path then plain path "
              f"in turns: kernels {rates['kernels']} plain {rates['plain']}")
    for policy in ("float32", "bfloat16"):
        set_compute_dtype(policy)
        for beam, label in ((True, "beam-5"), (False, "greedy")):
            a, b = run(beam, None), run(beam, False)
            if a.shape != (B, MAX_LEN) or int(a.min()) < 0 or int(a.max()) >= VOCAB:
                fail(f"{label}: tokens of shape {tuple(a.shape)} in [{int(a.min())}, {int(a.max())}]")
            agree = (a == b).all(1).float().mean().item()
            print(f"{label} caption agreement kernels vs plain [{policy}]: {agree:.4f}")
            if policy == "float32" and agree < AGREE_MIN:
                fail(f"{label} f32 caption agreement {agree:.4f} < {AGREE_MIN}")

    # the XE-training path: K5 against its plain version at the step's
    # shape, then the train steps
    n_rows = cfg.data.batch_size * cfg.data.caps_per_video_train * (MAX_LEN - 1)
    xent = check_xent(dev, n_rows, VOCAB)
    counts["xe-train"] = train_phase(cfg, dev)

    banned = ("jax", "flax", "optax", "orbax", "h5py", "controllable_xgating_tpu")
    pulled = sorted({m.split(".")[0] for m in sys.modules} & set(banned))
    if pulled:
        fail(f"the port pulled in {pulled}")

    src = "controllable_xgating_torch/csrc/"
    pallas = "controllable_xgating_tpu/ops/pallas/"
    kernel_rows = [  # name, source, the Pallas kernel it replaces, path, results
        ("xgate", "xgate.cu", "xgate.py:52", "beam-5", (*results["xgate"], None)),
        ("pos_lstm", "pos_lstm.cu", "pos_lstm.py:35", "beam-5", (*results["pos_lstm"], None)),
        ("attn_lstm", "attn_lstm.cu", "attn_lstm.py:43", "beam-5",
         (*results["attn_lstm"], None)),
        ("topk_tail", "topk_tail.cu", "topk_tail.py:66", "beam-5",
         (*results["topk_tail"], None)),
        ("xent_fwd", "xent.cu", "xent.py:49", "xe-train", xent["xent_fwd"]),
        ("xent_bwd", "xent.cu", "xent.py:60", "xe-train", xent["xent_bwd"]),
    ]
    bounds = {**caption_bounds(params), **xent_bounds(n_rows, VOCAB)}
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": src + f, "replaces": pallas + r,
         "launches": counts[path][n], "max_abs_err": res[0], "ms": res[1], "plain_ms": res[2],
         "bound_ms": bounds[n][0], "bound_by": bounds[n][1], "library_ms": res[3]}
        for n, f, r, path, res in kernel_rows
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
