#!/usr/bin/env python3
"""Drive the PyTorch port's captioning, quantized-decoding, ensemble and
diverse-beam, XE-training and SCST paths and its three command-line entry
points once on one NVIDIA GPU.

    python3 chip_smoke.py                 # from the root of a checkout

Phases, each fatal on failure:
  1. refuse to run without a CUDA device; print the card's name and
     power limit;
  2. build the CUDA kernels of every path from `csrc/` (one nvcc per
     source, all started together);
  3. hold every caption kernel and the logits top-k by iterative
     extraction (K6) against its plain PyTorch version at the shapes the
     path gives it (MSR-VTT width: 256 videos x 26 frames, beam 5), under
     the f32 policy (rtol 1e-4, atol 1e-5) and the bf16 policy (a bound
     per kernel, `BF16_TOL`), and time both with CUDA events; K6 is also
     held against the beam tail's kernel (K4) on the same inputs; under
     bf16, K3 and K4 again at greedy's 256 rows (timed beside beam's
     1280), and cuBLAS's bare bf16 projection h @ w_out at the beam shape
     as a yardstick for K4's wgmma mainloop; K6 and K4 in turns at k = 1,
     5, 8 (device us: each epilogue's selection cost); the POS LSTM step
     (K2) as the rollout takes it (`PosLstmRollout`), and again at a
     ragged shape (77 rows, Ep 100, H 72) under both policies for three
     steps; K1's routes at 77 rows, da 40, dm 24 (bf16: the wgmma chain at
     H 136, the SIMT kernel at H 132; f32: SIMT), each route read from the
     profiler; the device microseconds per launch of every kernel at its
     path's shape (`torch.profiler`, the port's own kernels only);
  3b. the beam tails' `topk` on the quantized beam's candidate matrix
     [1280, 10000] with planted ties, +-0.0, -1e30 and -inf: indices and
     values equal to `torch.sort(..., stable=True)` at k = 1, 5, 8; both
     timed;
  4. caption 256 seeded videos with random seeded weights under the bf16
     policy through `evaluate_split` with `make_beam_caption_fn` (beam 5),
     then with `make_greedy_caption_fn`; every kernel of each path must
     have launched, and the metrics must be finite;
  5. under the f32 policy, the kernel path and the plain path
     (`set_fused_kernels(False)`) must give the same caption for >= 98% of
     the videos, beam and greedy;
  6. the quantized decode path (`vocab_q`): the int8 vocab projection
     kernel (K7), on its K-major operand made once, against its plain
     version at the greedy [256, 512] and beam [1280, 512] shapes -> 10000
     and at ragged [77, 96] and [77, 90] -> 1301 (rtol 1e-4, atol 1e-5;
     K 90 takes zero columns to a multiple of 8), timed beside
     the bf16 projection it stands in for; greedy and beam-5 (grouped
     tail) with `vocab_q` over the 256 videos through `evaluate_split` and
     the entry point of `tools/quant_ab.py`, bf16 policy, where K7 must
     launch once per step (28) and xgate, pos_lstm and attn_lstm as on the
     unquantized paths, topk_tail never; under the f32 policy the int8
     kernel and plain paths must agree on >= 98% of the captions; printed
     only, the agreement with the bf16 projection, the captions/s of
     both in turns and the device time of one call of each;
  7. one beam-5 call per full log-softmax tail (grouped, flat, block), plain
     path, unquantized: the tokens must be equal; then beam 10 (wider
     than the lanes tail's k <= 8) through `make_beam_caption_fn` with the
     kernels: no topk_tail launch, under bf16 the tokens of the explicit
     grouped tail, under f32 >= 98% agreement with the plain path;
  7b. the decode-science paths (A9, `a9_phase`): under f32 with the
     kernels a [p, p] ensemble gives the single model's beam-5 n-best
     (grouped tail; tokens equal, scores rtol 1e-6) and greedy tokens; a
     same-architecture ensemble (seeds 0 and 1) and a cross-architecture
     one (member 0 and a concat-fusion, psi-free member at hidden 384,
     embed / attn / psi 256) at beam 5 through `evaluate_split` (bf16),
     each with its launches (K3 once per member per step, K1 once per
     xgate-mode member, no topk_tail) and f32 kernels-vs-plain agreement
     >= 98%; captions/s of ensemble and single beam-5, kernels and plain,
     in turns; diverse beam 6 in 3 groups (G 1 = G 0, no topk_tail, f32
     agreement >= 98%, at penalty 1e3 the groups' first words disjoint),
     with its captions/s; the kernels' beam-5 n-best rescored by
     `sequence_logprob` under f32 (its scores to rtol 1e-4, lengths
     equal);
  8. training at MSR-VTT width (batch 64 x 5 captions, vocab 10000, 35 POS
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
  8b. SCST at MSR-VTT width under bf16: the reward tables at MSR-VTT's
     caption scale (10000 videos x 20 seeded captions of 5-25 words, df
     over 6513), with their host and device build seconds and bytes on the
     card; the reward on the card against the port on the CPU over 256
     candidates (atol 1e-5) and against the host `CiderDScorer` over 64
     (rtol 1e-4, atol 1e-5); each realization (separate rollouts, paired
     rollout) for 1 warm-up and 5 timed steps of 64 videos (videos/s,
     device ms and busy share of one profiled step, 28 attn_lstm launches
     a step and no other kernel, the POS generator bitwise unchanged,
     rewards and losses finite); the baseline's f32 tokens with the
     kernels against the plain path (>= 98% of the batch);
  9. the three entry points users run, through `main(argv)` on the card
     (bf16 policy, kernels on), on a corpus directory written with the
     port's writers (info.json, labels.npz, features/; 128 train, 64 val
     and 256 test videos at MSR-VTT width, half padded in time), each run
     with its own launch counts: `cli.train` (joint, one epoch, then val
     eval: K5 and K1-K3), `cli.train --stage scst --init_from` that
     checkpoint (K3 at every step, K1-K3 in the val eval, no K5), `cli.eval --beam_size 5` (K1-K4; the captions of
     `evaluate_split` with `make_beam_caption_fn(5, ...)` on the same
     checkpoint, captions/s of both in turns), `cli.eval --nbest 5`,
     `cli.caption` on 8 videos greedy (K1-K3), with `--pos_tags` (no K2),
     `--sample 3 --seed 0` twice (equal), `--nbest 10` (no topk_tail), and
     once as `python3 -m controllable_xgating_torch.cli.caption`;
     `cli.eval --ensemble` of the XE and SCST checkpoints and `cli.eval
     --beam_size 6 --eval.diversity_groups 3` (K1-K3, no topk_tail, finite
     metrics); each CLI must leave the process's compute policy as it
     found it;
then print every kernel's device microseconds per launch beside its
bound, one JSON line of kernel results (eight kernels, each with its
launches on its path, bound and times) and, last, one JSON line
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
    # the same contract as topk_tail, held to its bound
    "topk_extract": dict(rtol=0.0, atol=1e-5),
}
TOPK_KERNELS = ("topk_tail", "topk_extract")
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
    "greedy-int8": ("xgate", "pos_lstm", "attn_lstm", "int8_vocab"),
    "beam-5-int8": ("xgate", "pos_lstm", "attn_lstm", "int8_vocab"),
    "xe-train": ("xent_fwd", "xent_bwd"),
    # the decode-science paths (A9): K4 never launches on them
    "ensemble-beam-5": ("xgate", "pos_lstm", "attn_lstm"),
    "ensemble-hetero-beam-5": ("xgate", "pos_lstm", "attn_lstm"),
    "diverse-beam-6": ("xgate", "pos_lstm", "attn_lstm"),
}
CARD = "the card"  # its name and power limit, from nvidia-smi in main


# kernel -> device microseconds per launch at its path's shape (torch.profiler)
DEVICE_US: dict = {}


def kernel_device_us(fn) -> float:
    from controllable_xgating_torch.utils.profiling import kernel_device_us as measure

    return measure(fn)


def kernel_device_split(fn) -> dict:
    from controllable_xgating_torch.utils.profiling import kernel_device_split as measure

    return measure(fn)


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


def kernel_cases(params, dev, r: int = B * K):
    """(name, kernel call, plain call) at the path's shapes, with seeded
    inputs, built under the current policy; the decoder-step and top-K
    kernels at `r` rows (beam-5's by default). The kernels get their weights
    cast once beforehand, as the caption loops give them."""
    import torch

    from controllable_xgating_torch.models.decoder import init_decoder_state, make_decode_context
    from controllable_xgating_torch.models.pos_generator import _summary_gates
    from controllable_xgating_torch.ops.kernels import (
        attn_lstm,
        pos_lstm,
        topk_extract,
        topk_tail,
        xgate,
    )
    g = torch.Generator(device=dev).manual_seed(7)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    ri = lambda lo, hi, s: torch.randint(lo, hi, s, generator=g, device=dev)
    enc, pos, dec = params.encoder, params.pos, params.decoder
    he, hp, hd = enc.out_dim, pos.lstm.hidden_dim, dec.hidden_dim
    xa, xm = rn(B * T, enc.xgate.wa.shape[0]), rn(B * T, enc.xgate.wm.shape[0])
    tok_pos = ri(4, POS_VOCAB, (B,))
    e_pos = pos.embed[tok_pos]
    sg = _summary_gates(pos, torch.tanh(rn(B, he)))
    h_pos, c_pos = torch.tanh(rn(B, hp)), rn(B, hp)
    mask = (torch.arange(T, device=dev)[None] < ri(T // 2, T + 1, (r, 1))).float()
    ctx = make_decode_context(dec, torch.tanh(rn(r, T, he)), torch.tanh(rn(r, dec.w_psi.shape[0])), mask)
    h_dec, c_dec = init_decoder_state(dec, torch.tanh(rn(r, he)))
    e_dec = dec.embed[ri(4, VOCAB, (r,))]
    h_out = torch.tanh(rn(r, hd))
    step = (dec, e_dec, h_dec, c_dec, ctx.keys, ctx.enc_proj, ctx.psi_g, ctx.frame_mask)
    pos_w, step_w = pos_lstm.pos_lstm_weights(pos), attn_lstm.attn_lstm_weights(dec)
    # the rollout's step, as pos_greedy_generate takes it: the first call
    # starts from h_pos (the one held against the plain version)
    pos_cell = pos_lstm.PosLstmRollout(pos, h_pos, sg, pos_w)
    w_op = topk_tail.topk_tail_weights(dec.w_out)
    xg_ops = xgate.xgate_weights(enc.xgate)
    return [
        ("xgate", lambda: xgate.xgate_fuse_kernel(enc.xgate, xa, xm, xg_ops),
         lambda: xgate.xgate_fuse_plain(enc.xgate, xa, xm)),
        ("pos_lstm", lambda: pos_cell.step(c_pos, tok=tok_pos),
         lambda: pos_lstm.pos_lstm_step_plain(pos, e_pos, sg, h_pos, c_pos)),
        ("attn_lstm", lambda: attn_lstm.attn_lstm_step_kernel(*step, step_w),
         lambda: attn_lstm.attn_lstm_step_plain(*step)),
        ("topk_tail", lambda: topk_tail.logits_topk(h_out, dec.w_out, dec.b_out, K, False, w_op),
         lambda: topk_tail.logits_topk_plain(h_out, dec.w_out, dec.b_out, K)),
        ("topk_extract",
         lambda: topk_extract.logits_topk_extract_kernel(h_out, dec.w_out, dec.b_out, K, w_op),
         lambda: topk_extract.logits_topk_extract_plain(h_out, dec.w_out, dec.b_out, K)),
    ], (h_out, dec.w_out, dec.b_out)


def check_kernels(params, dev, policy: str, tols: dict) -> dict:
    """Kernel vs plain on the same inputs, within `tols[name]`, and the two
    top-K kernels against each other; returns {name: (max_abs_err, ms,
    plain_ms)}."""
    import torch

    from controllable_xgating_torch.ops.kernels.topk_tail import logits_topk_plain

    cases, tail_inputs = kernel_cases(params, dev)
    rv, ri, _ = logits_topk_plain(*tail_inputs, K + 1)
    out, tails = {}, {}
    for name, kern, plain in cases:
        tol = tols[name]
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        if name in TOPK_KERNELS:
            # ids must agree wherever the plain K-th and (K+1)-th values are
            # further apart than the tolerance
            vals, idx, lse = tails[name] = got
            clear, same = ids_agree(idx, rv, ri, tol)
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
        dev_us = ""
        if policy == "bfloat16":
            split = kernel_device_split(kern)
            DEVICE_US[name] = sum(split.values())
            dev_us = f"  device {DEVICE_US[name]:.2f} us per launch"
            if len(split) > 1:  # a wrapper call of several kernels
                dev_us += " (" + ", ".join(f"{n} {us:.2f}" for n, us in split.items()) + ")"
        print(f"kernel {name} [{policy}]: max_abs_err {err:.3e}  kernel {ms:.4f} ms  "
              f"plain {plain_ms:.4f} ms{dev_us}")
        out[name] = (err, ms, plain_ms)
        if name == "topk_tail" and policy == "bfloat16":
            # how close K4's mainloop gets to cuBLAS on the bare projection
            # (not K4's function: no bias, mask, top-K or lse; the logits go
            # to device memory)
            h16, w16 = tail_inputs[0].bfloat16(), tail_inputs[1].bfloat16()
            print(f"kernel topk_tail [{policy}]: cuBLAS h.bfloat16() @ w_out.bfloat16() "
                  f"{list(h16.shape)} x {list(w16.shape)}: {cuda_ms(lambda: h16 @ w16):.4f} ms "
                  f"(a diagnostic, not K4's function)")
    # K6 (iterative extraction) against K4 (per-lane insertion) on the same
    # inputs: values and lse within the tolerance, ids equal on clear rows
    (ev, ei, el), (kv, ki, kl) = tails["topk_extract"], tails["topk_tail"]
    tol = tols["topk_extract"]
    clear, same = ids_agree(ei, rv, ri, tol, ki)
    err = max((ev - kv).abs().max().item(), (el - kl).abs().max().item())
    if not (bool(same[clear].all()) and torch.allclose(ev, kv, **tol) and torch.allclose(el, kl, **tol)):
        fail(f"topk_extract vs topk_tail [{policy}]: max |difference| {err:.3e}, ids differ on "
             f"{int((~same & clear).sum())} clear rows")
    print(f"kernel topk_extract vs topk_tail [{policy}]: max |difference| {err:.3e}, ids equal on "
          f"all {int(clear.sum())} clear rows; kernel ms {out['topk_extract'][1]:.4f} vs "
          f"{out['topk_tail'][1]:.4f}")
    return out


def check_greedy_rows(params, dev, beam: dict) -> None:
    """K3 and K4 under the bf16 policy at greedy's R = 256 rows (256
    videos, one beam each), held to BF16_TOL as at the beam shape (top-K
    ids on clear rows too), timed beside the beam shape's R = 1280 from
    `beam` ({name: (max_abs_err, ms, plain_ms)})."""
    import torch

    from controllable_xgating_torch.ops.kernels.topk_tail import logits_topk_plain

    cases, tail_inputs = kernel_cases(params, dev, r=B)
    rv, ri, _ = logits_topk_plain(*tail_inputs, K + 1)
    for name, kern, plain in cases:
        if name not in ("attn_lstm", "topk_tail"):
            continue
        tol = BF16_TOL[name]
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        if name == "topk_tail":
            clear, same = ids_agree(got[1], rv, ri, tol)
            if not bool(same[clear].all()):
                fail(f"topk_tail [bfloat16, {B} rows]: ids differ on "
                     f"{int((~same & clear).sum())} clear rows")
            got, ref = (got[0], got[2]), (ref[0], ref[2])
        err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, ref))
        if not all(bool(torch.isfinite(a).all()) and torch.allclose(a.float(), b.float(), **tol)
                   for a, b in zip(got, ref)):
            fail(f"{name} [bfloat16, {B} rows]: max |kernel - plain| = {err:.3e} outside {tol}")
        print(f"kernel {name} [bfloat16, {B} rows (greedy)]: max_abs_err {err:.3e}  kernel "
              f"{cuda_ms(kern):.4f} ms  plain {cuda_ms(plain):.4f} ms  device "
              f"{kernel_device_us(kern):.2f} us per launch; at {B * K} rows (beam-5) "
              f"kernel {beam[name][1]:.4f} ms")


def ids_agree(idx, rv, ri, tol, other=None):
    """(rows whose plain K-th and (K+1)-th values are further apart than
    `tol`, rows whose top-K id sets equal `other`'s, the plain ids by
    default)."""
    clear = rv[:, K - 1] - rv[:, K] > tol["atol"] + tol["rtol"] * rv[:, K - 1].abs()
    other = ri[:, :K] if other is None else other
    return clear, (idx.sort(1).values == other.sort(1).values).all(1)


def check_int8(params, dev) -> dict:
    """K7 against its plain version at the greedy [256, 512] and beam
    [1280, 512] shapes -> 10000, on the projection quantized from the
    decoder's and its K-major operand made once (`with_kernel_operand`,
    as the decode loops do), and at two ragged shapes (77 rows, n 1301, K
    96 and 90: no multiple of the 128-row tile, the 64-deep K step, the
    128-column tile or 4, so the output rows lie off 16-byte alignment; K
    90 no multiple of 8 either, so x takes zero columns): both multiply
    the same bf16 operands, so F32_TOL. Times both,
    the kernel's device time per launch and the bf16 projection
    `mm(h, w_out) + b` (bf16 policy) that it stands in for. Returns {rows:
    (max_abs_err, ms, plain_ms, bf16_ms)}."""
    import torch

    from controllable_xgating_torch.experiments.int8_vocab_matmul import (
        quantize_vocab_proj,
        with_kernel_operand,
    )
    from controllable_xgating_torch.ops.kernels.int8_vocab import int8_vocab_plain, int8_vocab_proj
    from controllable_xgating_torch.ops.precision import mm

    dec = params.decoder
    g = torch.Generator(device=dev).manual_seed(13)
    ragged = [with_kernel_operand(quantize_vocab_proj(
        torch.randn(k, 1301, generator=g, device=dev) * 0.1,
        torch.randn(1301, generator=g, device=dev) * 0.1)) for k in (96, 90)]
    q = with_kernel_operand(quantize_vocab_proj(dec.w_out, dec.b_out))
    out = {}
    for rows, qq in ((B, q), (B * K, q), (77, ragged[0]), (77, ragged[1])):
        k_dim = qq.wq.shape[0]
        h = torch.tanh(torch.randn(rows, k_dim, generator=g, device=dev))
        kern = lambda: int8_vocab_proj(h, qq.wq, qq.scale, qq.bias, qq.n, qq.wq_t)
        plain = lambda: int8_vocab_plain(h, qq.wq, qq.scale, qq.bias)[:, : qq.n]
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        if got.shape != (rows, qq.n) or not torch.isfinite(got).all() or not torch.allclose(
                got, ref, **F32_TOL):
            fail(f"int8_vocab [{rows}x{k_dim} -> {qq.n}]: max |kernel - plain| = {err:.3e} "
                 f"outside {F32_TOL}")
        if rows == 77:
            print(f"kernel int8_vocab [{rows}x{k_dim} -> {qq.n}, ragged]: max_abs_err {err:.3e}")
            continue
        out[rows] = (err, cuda_ms(kern), cuda_ms(plain),
                     cuda_ms(lambda: mm(h, dec.w_out) + dec.b_out.float()))
        dev_us = kernel_device_us(kern)
        if rows == B * K:
            DEVICE_US["int8_vocab"] = dev_us
        print(f"kernel int8_vocab [{rows}x{k_dim} -> {VOCAB}]: max_abs_err {err:.3e}  "
              f"kernel {out[rows][1]:.4f} ms  plain {out[rows][2]:.4f} ms  device {dev_us:.2f} us "
              f"per launch  bf16 projection {out[rows][3]:.4f} ms  "
              f"bound {int8_bound(rows, k_dim, VOCAB)}")
    return out


def check_pos_ragged(dev) -> None:
    """K2 through a rollout at a ragged shape (77 rows, Ep 100, H 72: no
    multiple of the 64-row tile, of the 64-deep K step or of 8 for Ep),
    under both policies: three steps on gathered tags, each against the
    plain step from the same state (F32_TOL, or BF16_TOL["pos_lstm"])."""
    import torch

    from controllable_xgating_torch.models.pos_generator import _summary_gates, init_pos_generator
    from controllable_xgating_torch.ops.kernels.pos_lstm import PosLstmRollout, pos_lstm_step_plain
    from controllable_xgating_torch.ops.precision import precision

    rows, ep, hd = 77, 100, 72
    pos = init_pos_generator(torch.Generator().manual_seed(4), POS_VOCAB, 2 * hd, hd, ep, 64).to(dev)
    g = torch.Generator(device=dev).manual_seed(5)
    for policy, tol in (("float32", F32_TOL), ("bfloat16", BF16_TOL["pos_lstm"])):
        with precision(policy):
            h = torch.tanh(torch.randn(rows, hd, generator=g, device=dev))
            c = torch.randn(rows, hd, generator=g, device=dev)
            sg = _summary_gates(pos, torch.tanh(torch.randn(rows, 2 * hd, generator=g, device=dev)))
            cell, err = PosLstmRollout(pos, h, sg), 0.0
            for _ in range(3):
                tok = torch.randint(0, POS_VOCAB, (rows,), generator=g, device=dev)
                ref = pos_lstm_step_plain(pos, pos.embed[tok], sg, h, c)
                h, c = cell.step(c, tok=tok)
                torch.cuda.synchronize()
                for a, b in zip((h, c), ref):
                    err = max(err, (a - b).abs().max().item())
                    if not torch.isfinite(a).all() or not torch.allclose(a, b, **tol):
                        fail(f"pos_lstm [{policy}, {rows} rows, Ep {ep}, H {hd}]: max |kernel - "
                             f"plain| = {err:.3e} outside {tol}")
        print(f"kernel pos_lstm [{policy}, {rows} rows, Ep {ep}, H {hd}, ragged, 3 steps]: "
              f"max_abs_err {err:.3e}")


def port_kernels(fn) -> list:
    """The port's kernels (namespace cxg) that one call of fn launches,
    one name per kernel (a template's instantiations each), sorted
    (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = (e.key.split("(")[0].replace("void ", "") for e in prof.key_averages())
    return sorted(n.split("<")[0] for n in names if n.startswith("cxg::"))


def check_xgate_routes(dev) -> None:
    """K1's two routes at 77 rows (ragged against the 64-row tiles), da 40,
    dm 24: under bf16 the wgmma chain at H = 136 (three launches) and the
    SIMT kernel at H = 132 (H % 8 != 0), under f32 the SIMT kernel at both;
    each against the plain version (BF16_TOL["xgate"], F32_TOL)."""
    import torch

    from controllable_xgating_torch.ops.kernels.xgate import (
        xgate_fits,
        xgate_fuse_kernel,
        xgate_fuse_plain,
    )
    from controllable_xgating_torch.ops.precision import precision
    from controllable_xgating_torch.ops.xgate import init_xgate

    g = torch.Generator(device=dev).manual_seed(19)
    for h in (136, 132):
        w = init_xgate(torch.Generator().manual_seed(h), 40, 24, h).to(dev)
        for bias in (w.ba, w.bm, w.bga, w.bgm, w.bf):
            bias.data = torch.randn(h, generator=g, device=dev) * 0.1
        xa, xm = torch.randn(77, 40, generator=g, device=dev), torch.randn(77, 24, generator=g, device=dev)
        for policy, tol in (("float32", F32_TOL), ("bfloat16", BF16_TOL["xgate"])):
            with precision(policy):
                got, ref = xgate_fuse_kernel(w, xa, xm), xgate_fuse_plain(w, xa, xm)
                names = port_kernels(lambda: xgate_fuse_kernel(w, xa, xm))
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            chain = policy == "bfloat16" and xgate_fits(40, 24, h)
            want = ["cxg::xgate_chain_kernel"] * 3 if chain else ["cxg::xgate_kernel"]
            if names != want:
                fail(f"xgate [{policy}, H {h}]: launched {names}, expected {want}")
            if not torch.isfinite(got).all() or not torch.allclose(got, ref, **tol):
                fail(f"xgate [{policy}, 77 rows, H {h}]: max |kernel - plain| = {err:.3e} outside {tol}")
            print(f"kernel xgate [{policy}, 77 rows, da 40, dm 24, H {h}, "
                  f"{'chain' if chain else 'SIMT'}]: max_abs_err {err:.3e}")


def check_topk_epilogues(params, dev) -> None:
    """Device us per launch of K6 (extraction rounds on the accumulator)
    and K4 (insertion into sorted lists) at the beam shape for k = 1, 5, 8,
    bf16, in turns, by kernel (chunk kernel, merge): the chunk kernel's
    growth with k is each epilogue's selection cost."""
    import torch

    from controllable_xgating_torch.ops.kernels.topk_extract import logits_topk_extract_kernel
    from controllable_xgating_torch.ops.kernels.topk_tail import logits_topk, topk_tail_weights

    dec = params.decoder
    g = torch.Generator(device=dev).manual_seed(23)
    h = torch.tanh(torch.randn(B * K, dec.hidden_dim, generator=g, device=dev))
    w_op = topk_tail_weights(dec.w_out)
    us = {}
    for k in (1, 5, 8):
        for name, fn in (("topk_extract", logits_topk_extract_kernel), ("topk_tail", logits_topk),
                         ("topk_tail", logits_topk), ("topk_extract", logits_topk_extract_kernel)):
            split = kernel_device_split(lambda: fn(h, dec.w_out, dec.b_out, k, w_op=w_op))
            us.setdefault((name, k), []).append(
                {n.split("<")[0].replace("cxg::", ""): round(t, 2) for n, t in split.items()})
    print("kernel topk_extract vs topk_tail [bfloat16, 1280x512 -> 10000], device us per launch "
          "by k and kernel, in turns: " + json.dumps({f"{n} k={k}": v for (n, k), v in us.items()}))


def check_topk(dev) -> dict:
    """The beam tails' `topk` on the quantized beam's candidate matrix
    [1280, 10000] (cum + log-softmax, finished rows' PAD-only rows, planted
    ties, +-0.0, -1e30, -inf) against `torch.sort(..., stable=True)`:
    indices and values equal, k = 1, 5, 8. Times both at k = 5. Returns
    {name: ms}."""
    import torch

    from controllable_xgating_torch.ops.kernels.topk_tail import topk

    g = torch.Generator(device=dev).manual_seed(17)
    r, v = B * K, VOCAB
    cum = -torch.rand(r, 1, generator=g, device=dev) * 10
    x = cum + torch.log_softmax(torch.randn(r, v, generator=g, device=dev) * 3, -1)
    x[::4, 100:140] = x[::4, 5:6]                # ties with a row's own values
    x[1::4, 17] = x[1::4, 9000] = x[1::4].amax(-1)  # a tie for the top
    x[2::4] = torch.where(torch.arange(v, device=dev) == 0, 0.0, -1e30)  # finished rows
    x[3::4, ::9] = -0.0
    x[:, 1] = -float("inf")
    stable = lambda k: tuple(t[:, :k] for t in torch.sort(x, dim=-1, descending=True, stable=True))
    for k in (1, 5, 8):
        rv, ri = stable(k)
        vals, idx = topk(x, k)
        torch.cuda.synchronize()
        if not (torch.equal(idx, ri) and torch.equal(vals, rv)):
            fail(f"topk [{r}x{v}, k {k}]: indices differ from the stable sort on "
                 f"{int((idx != ri).any(1).sum())} rows")
    from controllable_xgating_torch.utils.profiling import device_time_ms, profile_call

    plain_x = cum + torch.randn(r, v, generator=g, device=dev)  # no planted ties
    forms = {"stable sort": lambda a: torch.sort(a, dim=-1, descending=True, stable=True),
             "topk (block prescreen, int64 keys)": lambda a: topk(a, K)}
    ms = {}
    for name, fn in forms.items():
        ms[name] = cuda_ms(lambda: fn(x))
        dev_ms = [device_time_ms(profile_call(fn, (a,))[1]) for a in (x, plain_x)]
        print(f"topk [{r}x{v}, k {K}] {name}: {ms[name]:.4f} ms a call (CUDA events); device "
              f"{dev_ms[0]:.4f} ms (planted ties) / {dev_ms[1]:.4f} ms (N(0, 1) rows)")
    print(f"topk [{r}x{v}, k 1/5/8]: indices and values equal to the stable sort's")
    return ms


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


def int8_bound(rows: int, hd: int, v: int) -> tuple[float, str]:
    """K7 at [rows, hd] -> v, reckoned as `caption_bounds` is: it reads x
    (bf16), wq (int8, padded width), scale and bias (f32) and writes the
    f32 logits; the products run on the bf16 tensor cores."""
    vpad = -(-v // 1024) * 1024
    return bound(2 * rows * hd + hd * vpad + 4 * 2 * vpad + 4 * rows * v, 2 * rows * hd * v,
                 BF16_OPS_S)


def quant_bounds(params) -> dict:
    """Bounds of the two experiments/ kernels at the kernel phase's beam
    shape: int8_vocab's as above, and topk_extract does topk_tail's work."""
    dec = params.decoder
    return {
        "int8_vocab": int8_bound(B * K, dec.hidden_dim, dec.vocab_size),
        "topk_extract": caption_bounds(params)["topk_tail"],
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


def draw_features(rng, n: int, da: int, dm: int):
    """n seeded videos' features, half of them padded in time (zero past
    their frame count only where a caller masks them): (app, motion,
    frame counts)."""
    import numpy as np

    app = rng.normal(size=(n, T, da)).astype(np.float32)
    mot = rng.normal(size=(n, T, dm)).astype(np.float32)
    counts = np.where(rng.random(n) < 0.5, T, rng.integers(T // 2, T, n))
    return app, mot, counts


def draw_captions(rng, n: int, s: int):
    """n x s seeded captions and POS tag sequences: BOS, 5-25 random ids,
    EOS, PAD to MAX_LEN, as int32."""
    import numpy as np

    lengths = rng.integers(6, MAX_LEN - 1, (n, s))
    col = np.arange(MAX_LEN)[None, None, :]
    words = lengths[..., None]
    caps = np.where(col <= words, rng.integers(4, VOCAB, (n, s, MAX_LEN)), 0)
    pos = np.where(col <= words, rng.integers(4, POS_VOCAB, (n, s, MAX_LEN)), 0)
    for arr in (caps, pos):
        arr[..., 0] = 1  # BOS
        np.put_along_axis(arr, words, 2, axis=-1)  # EOS after the words
    return caps.astype(np.int32), pos.astype(np.int32)


def draw_videos(rng, n: int, s: int, da: int, dm: int):
    """n seeded videos (`draw_features`) with s captions and POS tag
    sequences each (`draw_captions`), s // 2 .. s of them real. Returns
    (app, motion, frame counts, caps, pos, ncaps)."""
    app, mot, counts = draw_features(rng, n, da, dm)
    caps, pos = draw_captions(rng, n, s)
    ncaps = rng.integers(s // 2, s + 1, n)
    return app, mot, counts, caps, pos, ncaps


def make_train_corpus(cfg, seed: int):
    """TRAIN_VIDEOS seeded videos (`draw_videos`), `seqs_per_video`
    captions each, in a NumpyStore."""
    import numpy as np

    app, mot, counts, caps, pos, ncaps = draw_videos(
        np.random.default_rng(seed), TRAIN_VIDEOS, cfg.data.seqs_per_video, cfg.model.app_dim,
        cfg.model.motion_dim)
    return NumpyStore(app, mot, counts), caps, pos, ncaps


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
    DEVICE_US["xent_fwd"] = kernel_device_us(lambda: xent_fwd_kernel(x, t))
    DEVICE_US["xent_bwd"] = kernel_device_us(lambda: xent_bwd_kernel(x, t, lse, *cot))
    for name, (e, ms, plain_ms, lib_ms) in out.items():
        print(f"kernel {name} [float32, {n}x{v}]: max_abs_err {e:.3e}  kernel {ms:.4f} ms  "
              f"plain {plain_ms:.4f} ms  device {DEVICE_US[name]:.2f} us per launch  "
              f"F.cross_entropy {lib_ms:.4f} ms")
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


# SCST at MSR-VTT's caption scale: 10000 videos x 20 captions, df over
# the 6513 of its train split; 1 warm-up + SCST_STEPS timed steps
SCST_VIDEOS, SCST_DF_VIDEOS, SCST_CAPS, SCST_STEPS = 10000, 6513, 20, 5
SCST_CARD_CPU_ATOL = 1e-5
SCST_HOST_TOL = dict(rtol=1e-4, atol=1e-5)  # the JAX package's device-vs-host bar


def id_words(ids) -> str:
    """Token ids -> "w<id> ..." up to the first EOS, without PAD and BOS:
    the strings the host scorer takes (a bijection on words)."""
    out = []
    for t in ids.tolist():
        if t == 2:  # EOS
            break
        if t > 2:
            out.append(f"w{t}")
    return " ".join(out)


def scst_candidates(rng, caps, vids):
    """Decoded-style candidates [len(vids), MAX_LEN] (no BOS): a third
    a reference of their own video, a third that reference with every
    third word replaced, a third random words with EOS."""
    import numpy as np

    cand = np.zeros((len(vids), MAX_LEN), np.int32)
    for i, v in enumerate(vids):
        ref = caps[v, rng.integers(0, caps.shape[1]), 1:]
        if i % 3 < 2:
            cand[i, :MAX_LEN - 1] = ref
            if i % 3 == 1:
                cand[i, :MAX_LEN - 1:3] = np.where(ref[::3] > 2, rng.integers(4, VOCAB, len(ref[::3])),
                                                   ref[::3])
        else:
            k = int(rng.integers(5, 26))
            cand[i, :k] = rng.integers(4, VOCAB, k)
            cand[i, k] = 2  # EOS
    return cand


def scst_phase(cfg, dev) -> dict:
    """SCST (config 4) at MSR-VTT width under the bf16 policy. Reward
    tables at MSR-VTT's caption scale (host and device seconds, bytes on
    the card); `cider_d_device` on the card against the port on the CPU
    over 256 candidates and against the host `CiderDScorer` over 64; each
    realization (separate rollouts, paired rollout) for 1 warm-up and
    SCST_STEPS timed steps of 64 videos: videos/s on the host clock,
    device ms of one step and its busy share (`utils/profiling.py`), K3's
    28 launches a step and no other kernel, the POS generator bitwise
    unchanged, every reward and loss finite; then the baseline's tokens
    with the kernels against the plain path under f32 (>= AGREE_MIN of the
    batch). Returns the launch counts of each realization's timed steps."""
    import dataclasses

    import numpy as np
    import torch

    from controllable_xgating_torch.infer.greedy import greedy_decode
    from controllable_xgating_torch.metrics.cider import CiderDScorer, compute_doc_freq
    from controllable_xgating_torch.models.captioner import init_captioner
    from controllable_xgating_torch.ops import cider_device as cd
    from controllable_xgating_torch.ops import kernels
    from controllable_xgating_torch.ops.dispatch import set_fused_kernels
    from controllable_xgating_torch.ops.precision import set_compute_dtype
    from controllable_xgating_torch.train.scst import make_scst_train_step, scst_context
    from controllable_xgating_torch.train.state import create_train_state, make_optimizer
    from controllable_xgating_torch.utils.profiling import device_time_ms, profile_call

    rng = np.random.default_rng(4)
    caps, _ = draw_captions(rng, SCST_VIDEOS, SCST_CAPS)
    ncaps = np.full(SCST_VIDEOS, SCST_CAPS, np.int32)
    t0 = time.perf_counter()
    host = cd.host_tables(caps, ncaps, range(SCST_DF_VIDEOS))
    t1 = time.perf_counter()
    tables = cd.precompute_ref_stats(host.to(dev))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    parts = {k: v.numel() * v.element_size() for k, v in tables.tensors().items()}
    print(f"scst tables [{SCST_VIDEOS} videos x {SCST_CAPS} captions, df over {SCST_DF_VIDEOS}]: "
          f"host {t1 - t0:.3f} s, device {t2 - t1:.3f} s (copy + reference stats), "
          f"{tables.nbytes() / 2 ** 20:.1f} MiB on the card; {tables.table_rows.shape[0]} df rows, "
          f"dir_bits {tables.dir_bits}, bucket_steps {tables.bucket_steps}; MiB by field "
          + json.dumps({k: round(v / 2 ** 20, 1) for k, v in parts.items()}))

    # the reward on the card against the port on the CPU (the same df table,
    # the reference statistics of the 256 videos computed there)
    vids = rng.choice(SCST_VIDEOS, 256, replace=False)
    cand = torch.as_tensor(scst_candidates(rng, caps, vids))
    card = cd.cider_d_device(tables, cand.to(dev), torch.as_tensor(vids, device=dev)).cpu()
    cpu = cd.precompute_ref_stats(dataclasses.replace(
        host, ref_caps=host.ref_caps[vids], ref_counts=host.ref_counts[vids]))
    ref = cd.cider_d_device(cpu, cand, torch.arange(len(vids)))
    err = (card - ref).abs().max().item()
    if not torch.isfinite(card).all() or err > SCST_CARD_CPU_ATOL:
        fail(f"scst reward: card vs CPU max |diff| {err:.3e} > {SCST_CARD_CPU_ATOL}")
    # ... and against the host scorer on strings, df over the same videos
    t3 = time.perf_counter()
    df, num = compute_doc_freq({v: [id_words(caps[v, j]) for j in range(SCST_CAPS)]
                                for v in range(SCST_DF_VIDEOS)})
    scorer = CiderDScorer(df=df, df_num_segments=num)
    host_scores = np.array([scorer.score({0: [id_words(caps[v, j]) for j in range(SCST_CAPS)]},
                                         {0: [id_words(c)]})[0]
                            for c, v in zip(cand.numpy()[:64], vids[:64])])
    if not np.allclose(card.numpy()[:64], host_scores, **SCST_HOST_TOL):
        fail(f"scst reward: card vs host CiderDScorer max |diff| "
             f"{np.abs(card.numpy()[:64] - host_scores).max():.3e} outside {SCST_HOST_TOL}")
    print(f"scst reward: card vs CPU over 256 candidates max |diff| {err:.3e} (atol "
          f"{SCST_CARD_CPU_ATOL}); card vs host CiderDScorer over 64 max |diff| "
          f"{np.abs(card.numpy()[:64] - host_scores).max():.3e} ({SCST_HOST_TOL}; host df "
          f"{time.perf_counter() - t3:.1f} s); rewards by kind (own reference, edited, random) "
          + json.dumps([round(card[i::3].mean().item(), 4) for i in range(3)]))

    # the steps: batches of train videos with seeded features, padded in time
    bs = cfg.data.batch_size
    n = (1 + SCST_STEPS) * bs
    app, mot, counts = draw_features(rng, n, cfg.model.app_dim, cfg.model.motion_dim)
    mask = (np.arange(T)[None, :] < counts[:, None]).astype(np.float32)
    app *= mask[:, :, None]
    mot *= mask[:, :, None]
    train_vids = rng.choice(SCST_DF_VIDEOS, n, replace=False).astype(np.int32)
    batches = [{"app": app[i:i + bs], "motion": mot[i:i + bs], "frame_mask": mask[i:i + bs],
                "video_indices": train_vids[i:i + bs]} for i in range(0, n, bs)]
    set_compute_dtype("bfloat16")
    set_fused_kernels(None)
    out = {}
    for paired in (False, True):
        label = "scst-paired" if paired else "scst"
        c = cfg.replace_flat({"train.scst_paired_rollout": paired})
        state = create_train_state(init_captioner(c, seed=0, device=dev), c)
        pos0 = [p.detach().clone() for p in state.params.pos.parameters()]
        step = make_scst_train_step(make_optimizer(c, 100, "scst"), c, tables)
        state, m = step(state, batches[0])
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t = time.perf_counter()
        metrics = []
        for batch in batches[1:]:
            state, m = step(state, batch)
            metrics.append(m)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        got = out[label] = kernels.launch_counts()
        want = {k: MAX_LEN * SCST_STEPS if k == "attn_lstm" else 0 for k in got}
        print(f"{label} launches {got}")
        if got != want:
            fail(f"{label}: expected {want} launches in {SCST_STEPS} steps: {got}")
        host_m = [{k: float(v) for k, v in mm.items()} for mm in metrics]
        if not all(math.isfinite(v) for mm in host_m for v in mm.values()):
            fail(f"{label}: metrics {host_m}")
        wall, ka, _ = profile_call(step, (state, batches[1]))
        device_ms = device_time_ms(ka)
        if any(not torch.equal(a, b) for a, b in zip(state.params.pos.parameters(), pos0)):
            fail(f"{label}: the POS generator moved")
        print(f"{label} [bfloat16, batch {bs}, {MAX_LEN} steps a rollout]: "
              f"{SCST_STEPS * bs / dt:.1f} videos/s ({dt / SCST_STEPS * 1e3:.1f} ms/step over "
              f"{SCST_STEPS} steps); one profiled step: wall {wall:.2f} ms, device {device_ms:.2f} ms, "
              f"busy share {device_ms / wall:.3f}; POS generator unchanged; last step "
              + json.dumps(host_m[-1]))

    # the baseline's tokens, kernels vs plain path, f32
    set_compute_dtype("float32")
    with torch.no_grad():
        b = {k: torch.as_tensor(v, device=dev) for k, v in batches[0].items()}
        ctx, summary = scst_context(state.params, b, MAX_LEN)
        toks = [greedy_decode(state.params.decoder, ctx, summary, MAX_LEN, fused=f)
                for f in (True, False)]
    agree = (toks[0] == toks[1]).all(1).float().mean().item()
    print(f"scst baseline tokens kernels vs plain [float32, batch {bs}]: agreement {agree:.4f}")
    if agree < AGREE_MIN:
        fail(f"scst baseline f32 agreement {agree:.4f} < {AGREE_MIN}")
    set_compute_dtype("bfloat16")
    return out


# the CLI phase's corpus: video counts per split, and a POS vocabulary of
# 31 Penn tags (+ 4 specials = POS_VOCAB) that holds --pos_tags' tags
CLI_SPLITS = {"train": 128, "val": 64, "test": 256}
CLI_TAGS = "DT NN VBZ VBG NN"
PENN = ("CC CD DT EX FW IN JJ JJR JJS MD NN NNS NNP NNPS PDT POS PRP PRP$ RB RBR RBS RP TO UH VB "
        "VBD VBG VBN VBP VBZ WDT").split()
CLI_CAPTION_KERNELS = ("xgate", "pos_lstm", "attn_lstm")


def write_cli_corpus(root: str, cfg, seed: int) -> None:
    """A corpus directory as the CLIs read it, written with the port's own
    writers (no HDF5): info.json (`CorpusInfo.save`), labels.npz and
    features/ (`write_feature_dir`) at MSR-VTT width, CLI_SPLITS videos
    from `draw_videos` (half padded in time, ~120 MB of features), a
    10000-word vocabulary and PENN."""
    import numpy as np

    from controllable_xgating_torch.data.corpus import CorpusInfo
    from controllable_xgating_torch.data.features import write_feature_dir
    from controllable_xgating_torch.data.vocab import Vocab

    n, s = sum(CLI_SPLITS.values()), cfg.data.seqs_per_video
    app, mot, counts, caps, pos, ncaps = draw_videos(
        np.random.default_rng(seed), n, s, cfg.model.app_dim, cfg.model.motion_dim)
    t = np.arange(T)[None, :, None]
    write_feature_dir(os.path.join(root, "features"), app * (t < counts[:, None, None]),
                      mot * (t < counts[:, None, None]), counts)
    np.savez(os.path.join(root, "labels.npz"), caps=caps, pos=pos, ncaps=ncaps.astype(np.int32))
    splits, start = {}, 0
    for name, size in CLI_SPLITS.items():
        splits[name], start = list(range(start, start + size)), start + size
    assert len(PENN) + 4 == POS_VOCAB
    CorpusInfo(vocab=Vocab([f"w{i}" for i in range(VOCAB - 4)]), pos_vocab=Vocab(PENN),
               video_ids=[f"video{i}" for i in range(n)], splits=splits, max_caption_len=MAX_LEN,
               max_pos_len=MAX_LEN, seqs_per_video=s).save(os.path.join(root, "info.json"))


def cli_phase(dev, cfg) -> dict:
    """The three entry points users run, each through its `main(argv)` on
    the card (the CLIs' default: bf16 policy, kernels on), with the launch
    counts set to 0 before each run and read after it: train (joint, one
    epoch: 2 steps of 64 videos, then greedy eval of the 64 val videos,
    which writes `best`) launches K5 and K1-K3; eval beam 5 over the 256
    test videos launches K1-K4 and gives the captions of `evaluate_split`
    with `make_beam_caption_fn(5, ...)` on the same checkpoint (the library
    path), timed in turns with it (three each, after the counted run);
    eval --nbest 5; caption of 8 videos
    greedy (K1-K3), with --pos_tags (no K2), --sample 3 --seed 0 twice
    (the same output) and --nbest 10 (wider than K4's k <= 8: no
    topk_tail); then caption once from the shell. Every metric must be
    finite. Returns the phase's rates and the library path's wall split."""
    import contextlib
    import io
    import shutil

    import torch

    from controllable_xgating_torch.cli import caption as cli_caption
    from controllable_xgating_torch.cli import eval as cli_eval
    from controllable_xgating_torch.cli import train as cli_train
    from controllable_xgating_torch.cli.common import load_corpus, restore_params
    from controllable_xgating_torch.infer.beam import make_beam_caption_fn
    from controllable_xgating_torch.infer.evaluator import evaluate_split
    from controllable_xgating_torch.ops import kernels
    from controllable_xgating_torch.ops.precision import compute_dtype, precision

    root = os.path.join(HERE, "build", "chip_smoke_cli")
    shutil.rmtree(root, ignore_errors=True)
    data, ck = os.path.join(root, "corpus"), os.path.join(root, "ck")
    t0 = time.perf_counter()
    write_cli_corpus(data, cfg, seed=2)
    print(f"cli corpus: {json.dumps(CLI_SPLITS)} videos written in {time.perf_counter() - t0:.1f} s")
    base = ["--data_dir", data, "--config", os.path.join(HERE, "configs", "msrvtt.json")]
    joint = os.path.join(ck, "joint")
    counts = {}

    def run(label, main, argv, want=(), absent=()):
        """One CLI run with its launches counted: (stdout, wall s)."""
        before = compute_dtype()
        kernels.reset_launch_counts()
        buf = io.StringIO()
        t = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                main(base + argv)
        except SystemExit as e:
            fail(f"cli {label}: exited {e.code}")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        got = counts[label] = kernels.launch_counts()
        print(f"cli {label} launches {got}")
        if [n for n in want if not got[n]] or [n for n in absent if got[n]]:
            fail(f"cli {label}: expected launches of {list(want)} and none of {list(absent)}: {got}")
        if compute_dtype() != before:
            fail(f"cli {label}: left the compute policy at {compute_dtype()}")
        return buf.getvalue(), dt

    def finite(label, metrics):
        if not metrics or not all(math.isfinite(v) for v in metrics.values()):
            fail(f"cli {label}: metrics {metrics}")

    def caption_lines(out):
        return [json.loads(line) for line in out.splitlines() if line.startswith("{")]

    # 1. train: joint XE, one epoch, every step logged
    _, dt = run("train", cli_train.main, ["--checkpoint_dir", ck, "--stage", "joint", "--epochs", "1",
                                          "--train.log_every_steps", "1"],
                ("xent_fwd", "xent_bwd", *CLI_CAPTION_KERNELS), ("topk_tail",))
    with open(os.path.join(joint, "train_log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    steps = [e for e in log if "loss" in e]
    val = {k[4:]: v for e in log for k, v in e.items() if k.startswith("val_")}
    finite("train", {**val, **{k: v for e in steps for k, v in e.items() if k != "ts"}})
    n_train = CLI_SPLITS["train"]
    if len(steps) != 2 or not os.path.exists(os.path.join(joint, "best.pt")):
        fail(f"cli train: {len(steps)} steps logged (2 expected), or no best checkpoint")
    if counts["train"]["xent_fwd"] != 2:
        fail(f"cli train: expected launches of xent_fwd once per step (2): {counts['train']}")
    step_rate = cfg.data.batch_size / (steps[1]["ts"] - steps[0]["ts"])
    print(f"cli train [joint, 1 epoch, 2 steps of {cfg.data.batch_size} videos, val eval of "
          f"{CLI_SPLITS['val']}]: {n_train / dt:.1f} train videos/s over the whole command "
          f"({dt:.2f} s), second step {step_rate:.1f} videos/s (train_log.jsonl), val {json.dumps(val)}")

    # 1b. train --stage scst from that checkpoint: the baseline through K3
    # at every step, then the val eval (K1-K3)
    scst_dir = os.path.join(ck, "scst")
    _, scst_dt = run("train-scst", cli_train.main,
                     ["--checkpoint_dir", ck, "--stage", "scst", "--init_from", joint, "--epochs", "1",
                      "--train.log_every_steps", "1"],
                     CLI_CAPTION_KERNELS, ("xent_fwd", "xent_bwd", "topk_tail"))
    with open(os.path.join(scst_dir, "train_log.jsonl")) as f:
        scst_log = [json.loads(line) for line in f]
    scst_steps = [{k: v for k, v in e.items() if k in ("step", "loss", "grad_norm", "reward_sample",
                                                       "reward_greedy", "advantage")}
                  for e in scst_log if "loss" in e]
    finite("train-scst", {f"{k}{e['step']}": v for e in scst_steps for k, v in e.items()})
    if len(scst_steps) != 2 or not all("reward_greedy" in e for e in scst_steps) \
            or not os.path.exists(os.path.join(scst_dir, "best.pt")):
        fail(f"cli train-scst: {scst_steps} logged (2 steps with rewards expected), or no best")
    if counts["train-scst"]["attn_lstm"] < 2 * MAX_LEN:
        fail(f"cli train-scst: expected {MAX_LEN} attn_lstm launches in each of 2 steps: "
             f"{counts['train-scst']}")
    print(f"cli train --stage scst [1 epoch, 2 steps of {cfg.data.batch_size} videos, val eval of "
          f"{CLI_SPLITS['val']}]: {n_train / scst_dt:.1f} train videos/s over the whole command "
          f"({scst_dt:.2f} s, reward tables included); train_log.jsonl {json.dumps(scst_steps)}")

    # 2. eval beam 5 over the test split, against the library path
    n_test = CLI_SPLITS["test"]
    out_json = os.path.join(root, "eval_beam5.json")
    eval_argv = ["--checkpoint_dir", joint, "--split", "test", "--beam_size", "5", "--out", out_json]
    _, cli_dt = run("eval-beam-5", cli_eval.main, eval_argv, (*CLI_CAPTION_KERNELS, "topk_tail"))
    with open(out_json) as f:
        res = json.load(f)
    finite("eval-beam-5", res["metrics"])

    def library(split: dict):
        """The library path, its wall split into set-up (corpus and
        checkpoint), decode (the caption function, synchronised) and the
        rest (batches, strings, metrics) in `split`."""
        from controllable_xgating_torch.utils.config import load_config

        t = time.perf_counter()
        with precision(cfg.model.dtype):
            info, labels, store, c = load_corpus(data, load_config(base[3]))
            params = restore_params(joint, c, dev)
            beam = make_beam_caption_fn(5, c.model.max_pos_len, c.eval.max_decode_len,
                                        length_penalty=c.eval.length_penalty,
                                        block_unk=c.eval.block_unk)
            split["setup"] = time.perf_counter() - t
            split["decode"] = 0.0

            def fn(*a):
                t = time.perf_counter()
                out = beam(*a)
                torch.cuda.synchronize()
                split["decode"] += time.perf_counter() - t
                return out

            res = evaluate_split(params, store, labels, info, split="test", batch_size=c.data.batch_size,
                                 max_len=c.eval.max_decode_len, max_pos_len=c.model.max_pos_len,
                                 caption_fn=fn, metrics=c.eval.metrics)
        split["rest"] = time.perf_counter() - t - split["setup"] - split["decode"]
        return res

    # in turns after the counted run: library, cli, cli, library, ... (3 each)
    rates, splits = {"cli": [], "library": []}, []
    for turn in ("library", "cli", "cli", "library", "library", "cli"):
        t = time.perf_counter()
        if turn == "cli":
            run("eval-beam-5 (timed)", cli_eval.main, eval_argv)
        else:
            splits.append({})
            lib_metrics, lib_caps = library(splits[-1])
        rates[turn].append(n_test / (time.perf_counter() - t))
    if len(res["captions"]) != n_test or res["captions"] != lib_caps:
        diff = sum(res["captions"].get(v) != c for v, c in lib_caps.items())
        fail(f"cli eval-beam-5: captions differ from the library path's on {diff} videos")
    if res["metrics"] != lib_metrics:
        fail(f"cli eval-beam-5: metrics {res['metrics']} vs the library path's {lib_metrics}")
    print(f"cli eval [beam 5, {n_test} test videos, {cfg.model.dtype}]: captions equal the library path's "
          f"(evaluate_split + make_beam_caption_fn); captions/s over the whole command, first run "
          f"{n_test / cli_dt:.2f}, then in turns (library, cli, cli, library, library, cli): cli "
          f"{rates['cli']} library {rates['library']}, medians cli "
          f"{sorted(rates['cli'])[1]:.2f} library {sorted(rates['library'])[1]:.2f}; "
          f"library wall split, s: {json.dumps(splits)}; metrics {json.dumps(res['metrics'])}")

    # 3. eval n-best 5
    out_nbest = os.path.join(root, "eval_nbest5.json")
    run("eval-nbest-5", cli_eval.main, ["--checkpoint_dir", joint, "--split", "test", "--nbest", "5",
                                        "--out", out_nbest], (*CLI_CAPTION_KERNELS, "topk_tail"))
    with open(out_nbest) as f:
        res = json.load(f)
    finite("eval-nbest-5", {**res["metrics"], **{"oracle_" + k: v for k, v in res["oracle_metrics"].items()}})
    if res["beam_size"] != 5 or any(len(l) != 5 for l in res["captions"].values()):
        fail("cli eval-nbest-5: expected 5 hypotheses per video")
    print(f"cli eval [--nbest 5]: oracle {res['oracle_metric']} {res['oracle_metrics'][res['oracle_metric']]:.6g}"
          f" vs rank-0 {res['metrics'][res['oracle_metric']]:.6g}")

    # 3b. the decode-science CLI runs (A9): a log-prob ensemble of the XE and
    # SCST checkpoints (K3 once per member per step, K1 once per member per
    # batch), and diverse beam 6 in 3 groups; neither launches topk_tail
    n_batches = -(-n_test // cfg.data.batch_size)
    out_ens = os.path.join(root, "eval_ensemble.json")
    _, ens_dt = run("eval-ensemble", cli_eval.main,
                    ["--ensemble", joint, scst_dir, "--split", "test", "--out", out_ens],
                    CLI_CAPTION_KERNELS, ("topk_tail",))
    with open(out_ens) as f:
        res = json.load(f)
    finite("eval-ensemble", res["metrics"])
    got = counts["eval-ensemble"]
    if res["ensemble"] != [joint, scst_dir] or len(res["captions"]) != n_test \
            or got["xgate"] != 2 * n_batches or got["attn_lstm"] % 2:
        fail(f"cli eval-ensemble: expected 2 members, {n_test} captions, xgate 2 x {n_batches} "
             f"and attn_lstm in pairs: {got}")
    out_div = os.path.join(root, "eval_diverse.json")
    _, div_dt = run("eval-diverse-beam-6", cli_eval.main,
                    ["--checkpoint_dir", joint, "--split", "test", "--beam_size", "6",
                     "--eval.diversity_groups", "3", "--out", out_div],
                    CLI_CAPTION_KERNELS, ("topk_tail",))
    with open(out_div) as f:
        res_div = json.load(f)
    finite("eval-diverse-beam-6", res_div["metrics"])
    print(f"cli eval --ensemble [XE + SCST, beam 5, {n_test} test videos]: "
          f"{n_test / ens_dt:.2f} captions/s over the whole command, metrics "
          f"{json.dumps(res['metrics'])}; cli eval --beam_size 6 --eval.diversity_groups 3: "
          f"{n_test / div_dt:.2f} captions/s, metrics {json.dumps(res_div['metrics'])}")

    # 4. caption 8 videos four ways, then once from the shell
    vids = ",".join(f"video{i}" for i in range(n_train, n_train + 8))
    cap = ["--checkpoint_dir", joint, "--video", vids]
    out, _ = run("caption-greedy", cli_caption.main, cap, CLI_CAPTION_KERNELS, ("topk_tail",))
    out_tags, _ = run("caption-pos-tags", cli_caption.main, cap + ["--pos_tags", CLI_TAGS],
                      ("xgate", "attn_lstm"), ("pos_lstm", "topk_tail"))
    sample = cap + ["--sample", "3", "--seed", "0"]
    out_s1, _ = run("caption-sample", cli_caption.main, sample, CLI_CAPTION_KERNELS)
    out_s2, _ = run("caption-sample (again)", cli_caption.main, sample, CLI_CAPTION_KERNELS)
    out_nb, _ = run("caption-nbest-10", cli_caption.main, cap + ["--nbest", "10"],
                    CLI_CAPTION_KERNELS, ("topk_tail",))
    lines = {k: caption_lines(o) for k, o in (("greedy", out), ("pos_tags", out_tags),
                                               ("sample", out_s1), ("nbest", out_nb))}
    if any(len(v) != 8 for v in lines.values()):
        fail(f"cli caption: expected 8 lines per run: {dict((k, len(v)) for k, v in lines.items())}")
    if not all(line["pos_sequence"] == CLI_TAGS and line["controlled"] for line in lines["pos_tags"]):
        fail("cli caption --pos_tags: the POS sequence is not the one given")
    if out_s1 != out_s2 or not all(len(line["caption"]) == 3 for line in lines["sample"]):
        fail("cli caption --sample 3 --seed 0: two runs differ")
    if not all(len(line["captions"]) == 10 and all(math.isfinite(c["score"]) for c in line["captions"])
               for line in lines["nbest"]):
        fail("cli caption --nbest 10: expected 10 finite-scored captions per video")
    print(f"cli caption [8 videos]: greedy {json.dumps(lines['greedy'][0])}; --pos_tags "
          f"{json.dumps(lines['pos_tags'][0])}; --sample 3 --seed 0 twice: equal")
    shell = subprocess.run(
        [sys.executable, "-m", "controllable_xgating_torch.cli.caption", *base, *cap],
        cwd=HERE, capture_output=True, text=True, timeout=300)
    if shell.returncode != 0 or len(caption_lines(shell.stdout)) != 8:
        fail(f"python3 -m controllable_xgating_torch.cli.caption exited {shell.returncode}: "
             f"{shell.stderr[-2000:]}")
    if caption_lines(shell.stdout) != lines["greedy"]:
        fail("cli caption from the shell: captions differ from the in-process run")
    print("cli caption from the shell (python3 -m controllable_xgating_torch.cli.caption): exit 0, "
          "the in-process run's captions")
    shutil.rmtree(root, ignore_errors=True)
    return {"train_videos_s": n_train / dt, "train_second_step_videos_s": step_rate,
            "train_scst_videos_s": n_train / scst_dt,
            "eval_beam5_captions_s": {"first": n_test / cli_dt, **rates},
            "eval_ensemble_captions_s": n_test / ens_dt,
            "eval_diverse_beam6_captions_s": n_test / div_dt,
            "library_wall_split_s": splits}


def caption_fn(beam: bool, fused):
    from controllable_xgating_torch.infer.beam import make_beam_caption_fn
    from controllable_xgating_torch.infer.evaluator import make_greedy_caption_fn

    if beam:
        return make_beam_caption_fn(K, MAX_LEN, MAX_LEN, fused=fused)
    return make_greedy_caption_fn(MAX_LEN, MAX_LEN, fused=fused)


def int8_phase(params, cfg, store, labels, info, dev, counts: dict) -> dict:
    """The quantized decode path (`vocab_q`, the entry point of
    `tools/quant_ab.py`), after the unquantized paths have filled
    `counts`: greedy and beam-5 (grouped tail) over the 256 videos through
    `evaluate_split`, bf16 policy, kernels on, counting launches around each
    run; the f32 agreement of the kernel and plain int8 paths; printed
    only, the agreement with the unquantized path and the captions/s of
    both. Returns K7's results at the beam shape."""
    import numpy as np
    import torch

    from controllable_xgating_torch.experiments.int8_vocab_matmul import quantize_vocab_proj
    from controllable_xgating_torch.infer.evaluator import evaluate_split
    from controllable_xgating_torch.ops import kernels
    from controllable_xgating_torch.ops.dispatch import set_fused_kernels
    from controllable_xgating_torch.ops.precision import set_compute_dtype
    from controllable_xgating_torch.tools.quant_ab import make_fn
    from controllable_xgating_torch.utils.profiling import device_time_ms, profile_call

    set_compute_dtype("bfloat16")
    set_fused_kernels(None)
    k7 = check_int8(params, dev)
    vq = quantize_vocab_proj(params.decoder.w_out, params.decoder.b_out)
    for beam, label in ((False, "greedy-int8"), (True, "beam-5-int8")):
        kernels.reset_launch_counts()
        metrics, caps = evaluate_split(
            params, store, labels, info, split="test", batch_size=B, max_len=MAX_LEN,
            max_pos_len=MAX_LEN, caption_fn=make_fn(cfg, beam, vq),
        )
        torch.cuda.synchronize()
        counts[label] = got = kernels.launch_counts()
        print(f"{label} launches {got}")
        base = counts["beam-5" if beam else "greedy"]
        if got["int8_vocab"] != MAX_LEN or got["topk_tail"] != 0 or any(
                got[n] != base[n] for n in ("xgate", "pos_lstm", "attn_lstm")):
            fail(f"{label}: expected {MAX_LEN} int8_vocab launches, none of topk_tail and the "
                 f"unquantized path's xgate, pos_lstm and attn_lstm counts {base}: {got}")
        if len(caps) != B or not all(math.isfinite(v) for v in metrics.values()):
            fail(f"{label}: {len(caps)} captions, metrics {metrics}")
        print(f"{label} metrics", json.dumps(metrics))

    app, mot = (torch.as_tensor(x, device=dev) for x in store.get_batch(np.arange(B)))
    mask = torch.as_tensor(store.frame_mask(np.arange(B)), device=dev)

    def run(beam, fused, quant):
        set_fused_kernels(fused)
        try:
            tokens = make_fn(cfg, beam, vq if quant else None)(params, app, mot, mask)[0]
        finally:
            set_fused_kernels(None)
        torch.cuda.synchronize()
        return tokens

    for beam, label in ((False, "greedy-int8"), (True, "beam-5-int8")):
        set_compute_dtype("float32")
        a, b = run(beam, None, True), run(beam, False, True)
        for x in (a, b):
            if x.shape != (B, MAX_LEN) or int(x.min()) < 0 or int(x.max()) >= VOCAB:
                fail(f"{label}: tokens of shape {tuple(x.shape)} in [{int(x.min())}, {int(x.max())}]")
        agree = (a == b).all(1).float().mean().item()
        print(f"{label} caption agreement kernels vs plain [float32]: {agree:.4f}")
        if agree < AGREE_MIN:
            fail(f"{label} f32 caption agreement {agree:.4f} < {AGREE_MIN}")
        set_compute_dtype("bfloat16")
        rates = {"bf16": [], "int8": []}
        for quant in (False, True, True, False):
            t = time.perf_counter()
            run(beam, None, quant)
            rates["int8" if quant else "bf16"].append(B / (time.perf_counter() - t))
        vs = (run(beam, None, True) == run(beam, None, False)).all(1).float().mean().item()
        print(f"{label} [bfloat16, kernels, not gated] caption agreement with the bf16 projection "
              f"{vs:.4f}; captions/s in turns: bf16 projection {rates['bf16']} int8 {rates['int8']}")
        # device time per call (torch.profiler), int8 then bf16 projection
        for quant in (True, False):
            wall, ka, _ = profile_call(lambda: run(beam, None, quant), ())
            print(f"{label} [bfloat16, kernels, {'int8' if quant else 'bf16'} projection]: device "
                  f"time {device_time_ms(ka):.2f} ms per call of 256 videos (wall {wall:.2f} ms)")
    return k7[B * K]


def tails_phase(params, dev) -> None:
    """One beam-5 call per candidate tail that forms the full log-softmax
    (grouped, flat, block), plain path, bf16 policy, unquantized: the
    tokens must be equal. Prints each call's captions/s."""
    import numpy as np
    import torch

    from controllable_xgating_torch.infer.beam import make_beam_caption_fn
    from controllable_xgating_torch.ops.precision import set_compute_dtype

    set_compute_dtype("bfloat16")
    g = np.random.default_rng(3)
    app = torch.as_tensor(g.normal(size=(B, T, params.encoder.xgate.wa.shape[0])), dtype=torch.float32,
                          device=dev)
    mot = torch.as_tensor(g.normal(size=(B, T, params.encoder.xgate.wm.shape[0])), dtype=torch.float32,
                          device=dev)
    out, rates = {}, {}
    for mode in ("grouped", "flat", "block"):
        fn = make_beam_caption_fn(K, MAX_LEN, MAX_LEN, fused=False, topk_mode=mode)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out[mode] = fn(params, app, mot)[0]
        torch.cuda.synchronize()
        rates[mode] = B / (time.perf_counter() - t)
    for mode in ("flat", "block"):
        if not torch.equal(out[mode], out["grouped"]):
            fail(f"beam-5 tail {mode}: tokens differ from grouped on "
                 f"{int((out[mode] != out['grouped']).any(1).sum())} videos")
    print(f"beam-5 tails [bfloat16, plain path]: grouped, flat and block give equal tokens; "
          f"captions/s (one call each) {json.dumps(rates)}")


def beam10_phase(params, store, dev) -> None:
    """Beam 10 (wider than the lanes tail's MAX_K = 8) over the 256 videos
    through `make_beam_caption_fn`, kernels on: auto must route to the
    grouped tail by shape (no topk_tail launch), and under bf16 give the
    tokens of an explicit grouped tail through the same kernels; under f32
    its captions must agree with the plain path's grouped tail
    (fused=False) on >= AGREE_MIN of the videos, as beam-5's do."""
    import numpy as np
    import torch

    from controllable_xgating_torch.infer.beam import make_beam_caption_fn
    from controllable_xgating_torch.ops import kernels
    from controllable_xgating_torch.ops.precision import precision

    app, mot = (torch.as_tensor(x, device=dev) for x in store.get_batch(np.arange(B)))
    mask = torch.as_tensor(store.frame_mask(np.arange(B)), device=dev)
    run = lambda fused, mode: make_beam_caption_fn(10, MAX_LEN, MAX_LEN, fused=fused,
                                                   topk_mode=mode)(params, app, mot, mask)[0]
    with precision("bfloat16"):
        kernels.reset_launch_counts()
        t = time.perf_counter()
        auto = run(None, "auto")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        counts = kernels.launch_counts()
        grouped = run(None, "grouped")
    torch.cuda.synchronize()
    print(f"beam-10 launches {counts}")
    if counts["topk_tail"] != 0 or not all(counts[n] for n in ("xgate", "pos_lstm", "attn_lstm")):
        fail(f"beam-10: expected the kernels of the grouped route and no topk_tail: {counts}")
    if auto.shape != (B, MAX_LEN) or not torch.equal(auto, grouped):
        fail(f"beam-10 [bfloat16]: auto's tokens differ from the grouped tail's on "
             f"{int((auto != grouped).any(1).sum())} videos")
    with precision("float32"):
        a, b = run(None, "auto"), run(False, "grouped")
    agree = (a == b).all(1).float().mean().item()
    print(f"beam-10 [bfloat16, kernels]: auto takes the grouped tail, tokens equal; "
          f"{B / dt:.1f} captions/s (one call); caption agreement kernels vs plain [float32] "
          f"{agree:.4f}")
    if agree < AGREE_MIN:
        fail(f"beam-10 f32 caption agreement {agree:.4f} < {AGREE_MIN}")


# the A9 phase's second architecture: concat fusion, no psi, other widths
# (K3 takes them: A and G multiples of 8, Hd + E padded to 8)
A9_ALT = {"model.fusion": "concat", "model.pos_guidance": False, "model.hidden_dim": 384,
          "model.embed_dim": 256, "model.attn_dim": 256, "model.pos_embed_dim": 256}


def a9_phase(params, cfg, store, labels, info, dev, counts: dict) -> dict:
    """The decode-science paths at MSR-VTT width over the 256 videos, every
    check fatal: (a) under f32 with the kernels, a [p, p] ensemble's beam-5
    n-best equals the single model's grouped-tail beam-5 (tokens, scores to
    rtol 1e-6) and its greedy tokens the single model's; (b) a
    same-architecture ensemble (seeds 0 and 1) and a cross-architecture one
    (member 0 and an A9_ALT member) at beam 5 through `evaluate_split`
    under bf16, counting launches (K3 once per member per step, K1 once
    per xgate-mode member, no topk_tail), kernels vs plain agreement >=
    AGREE_MIN under f32 (printed under bf16); (c) diverse beam 6 / G 3 /
    penalty 0.5 through `make_beam_caption_fn`: G = 1 gives G = 0's
    tokens, G = 3 launches no topk_tail, f32 agreement >= AGREE_MIN, and at
    penalty 1e3 the groups' first tokens are disjoint; (d) under f32,
    `sequence_logprob` of the kernels' beam-5 n-best equals its scores to
    rtol 1e-4, lengths equal. Prints captions/s of each, in turns with the
    plain path, beside the card. Returns the phase's rates."""
    import numpy as np
    import torch

    from controllable_xgating_torch.data.vocab import EOS, PAD
    from controllable_xgating_torch.infer.beam import make_beam_caption_fn
    from controllable_xgating_torch.infer.ensemble import make_ensemble_caption_fn
    from controllable_xgating_torch.infer.evaluator import evaluate_split, make_greedy_caption_fn
    from controllable_xgating_torch.infer.score import make_sequence_scorer
    from controllable_xgating_torch.models.captioner import init_captioner
    from controllable_xgating_torch.ops import kernels
    from controllable_xgating_torch.ops.dispatch import set_fused_kernels
    from controllable_xgating_torch.ops.precision import precision

    app, mot = (torch.as_tensor(x, device=dev) for x in store.get_batch(np.arange(B)))
    mask = torch.as_tensor(store.frame_mask(np.arange(B)), device=dev)
    p1 = init_captioner(cfg, seed=1, device=dev)
    alt = init_captioner(cfg.replace_flat(A9_ALT), seed=2, device=dev)
    ensembles = {"ensemble-beam-5": (params, p1), "ensemble-hetero-beam-5": (params, alt)}

    def call(make, p, fused):
        """One call of the caption function that `make()` builds under the
        kernel setting `fused` (a factory reads the setting when it
        builds), on the 256 videos."""
        set_fused_kernels(fused)
        try:
            out = make()(p, app, mot, mask)
        finally:
            set_fused_kernels(None)
        torch.cuda.synchronize()
        return out

    def agree(a, b):
        return (a == b).all(-1).float().mean().item()

    # (a) identity, f32, kernels on
    with precision("float32"):
        single = call(lambda: make_beam_caption_fn(K, MAX_LEN, MAX_LEN, topk_mode="grouped",
                                                   return_all=True), params, None)
        ens = call(lambda: make_ensemble_caption_fn(K, MAX_LEN, MAX_LEN, return_all=True),
                   (params, params), None)
        g1 = call(lambda: make_greedy_caption_fn(MAX_LEN, MAX_LEN), params, None)[0]
        g2 = call(lambda: make_ensemble_caption_fn(1, MAX_LEN, MAX_LEN), (params, params),
                  None)[0]
    if not torch.equal(ens[0], single[0]) or not torch.equal(ens[2], single[2]):
        fail(f"a9 identity: the [p, p] ensemble's beam-5 tokens differ from the single model's "
             f"on {int((ens[0] != single[0]).flatten(1).any(1).sum())} videos")
    if not torch.allclose(ens[1], single[1], rtol=1e-6, atol=0.0):
        fail(f"a9 identity: scores differ by {(ens[1] - single[1]).abs().max().item():.3g}")
    if not torch.equal(g1, g2):
        fail(f"a9 identity: greedy tokens differ on {int((g1 != g2).any(1).sum())} videos")
    print(f"a9 identity [float32, kernels, {CARD}]: [p, p] beam-5 n-best equals the single "
          f"model's grouped tail (tokens equal, max score diff "
          f"{(ens[1] - single[1]).abs().max().item():.3g}); greedy tokens equal")

    # (b) two ensembles at beam 5 through evaluate_split (bf16, kernels on)
    out = {}
    make_ens = lambda: make_ensemble_caption_fn(K, MAX_LEN, MAX_LEN)
    for label, members in ensembles.items():
        m = len(members)
        n_xgate = sum(p.encoder.xgate.mode == "xgate" for p in members)
        with precision("bfloat16"):
            kernels.reset_launch_counts()
            metrics, caps = evaluate_split(members, store, labels, info, split="test",
                                           batch_size=B, max_len=MAX_LEN, max_pos_len=MAX_LEN,
                                           caption_fn=make_ens())
            torch.cuda.synchronize()
            counts[label] = got = kernels.launch_counts()
            tokens = call(make_ens, members, None)[0]
        print(f"{label} launches {got}")
        if len(caps) != B or not all(math.isfinite(v) for v in metrics.values()):
            fail(f"{label}: {len(caps)} captions, metrics {metrics}")
        # a caption without EOS means the loop ran all MAX_LEN steps
        if bool((tokens == EOS).any(1).all()):
            fail(f"{label}: every caption ended early; the launch count check needs a full run")
        if got["attn_lstm"] != m * MAX_LEN or got["xgate"] != n_xgate or got["topk_tail"] \
                or got["pos_lstm"] < m:
            fail(f"{label}: expected attn_lstm {m} x {MAX_LEN}, xgate {n_xgate}, pos_lstm >= {m} "
                 f"and no topk_tail: {got}")
        agreement = {}
        for policy in ("float32", "bfloat16"):
            with precision(policy):
                agreement[policy] = agree(call(make_ens, members, None)[0],
                                          call(make_ens, members, False)[0])
        print(f"{label} caption agreement kernels vs plain: {json.dumps(agreement)}; "
              f"metrics {json.dumps(metrics)}")
        if agreement["float32"] < AGREE_MIN:
            fail(f"{label} f32 caption agreement {agreement['float32']:.4f} < {AGREE_MIN}")
        out[label] = agreement

    # captions/s in turns: ensemble (M = 2) and single beam-5, kernels and plain
    fns = {"ensemble": (make_ens, ensembles["ensemble-beam-5"]),
           "single": (lambda: make_beam_caption_fn(K, MAX_LEN, MAX_LEN), params)}
    rates = {f"{n} {path}": [] for n in fns for path in ("kernels", "plain")}
    with precision("bfloat16"):
        for fused in (None, False, False, None):
            for name, (make, p) in fns.items():
                t = time.perf_counter()
                call(make, p, fused)
                rates[f"{name} {'kernels' if fused is None else 'plain'}"].append(
                    B / (time.perf_counter() - t))
    print(f"a9 captions/s [bfloat16, beam 5, {B} videos per call, {CARD}], in turns: "
          f"{json.dumps(rates)}")
    out["beam5_captions_s"] = rates

    # (c) diverse beam 6 in 3 groups
    div = lambda g, pen=0.5, length=MAX_LEN, **kw: lambda: make_beam_caption_fn(
        6, MAX_LEN, length, diversity_groups=g, diversity_penalty=pen, **kw)
    with precision("bfloat16"):
        if not torch.equal(call(div(1), params, None)[0], call(div(0), params, None)[0]):
            fail("diverse-beam-6: diversity_groups=1 differs from the plain beam")
        kernels.reset_launch_counts()
        t = time.perf_counter()
        call(div(3), params, None)
        dt = time.perf_counter() - t
        counts["diverse-beam-6"] = got = kernels.launch_counts()
        print(f"diverse-beam-6 launches {got}")
        if got["topk_tail"] or not all(got[n] for n in PATH_KERNELS["diverse-beam-6"]):
            fail(f"diverse-beam-6: expected K1-K3 and no topk_tail: {got}")
        drates = {"kernels": [], "plain": []}
        for fused in (None, False, False, None):
            t = time.perf_counter()
            call(div(3), params, fused)
            drates["kernels" if fused is None else "plain"].append(B / (time.perf_counter() - t))
        bf16_agree = agree(call(div(3), params, None)[0], call(div(3), params, False)[0])
        # penalty 1e3: after one step every video's 6 first words are
        # distinct (the groups' choices disjoint); after all steps each
        # video keeps one first word per group at least
        first = call(div(3, 1e3, length=1, return_all=True), params, None)[0][:, :, 0]
        full = call(div(3, 1e3, return_all=True), params, None)[0][:, :, 0]
    if any(len(set(r)) != 6 for r in first.tolist()):
        fail("diverse-beam-6 at penalty 1e3: two groups share a first token")
    if any(len(set(r) - {PAD}) < 3 for r in full.tolist()):
        fail("diverse-beam-6 at penalty 1e3: fewer than 3 distinct first tokens in a video's n-best")
    with precision("float32"):
        f32_agree = agree(call(div(3), params, None)[0], call(div(3), params, False)[0])
    print(f"diverse-beam-6 [G 3, penalty 0.5, {CARD}]: {B / dt:.1f} captions/s (the counted call); "
          f"in turns [bfloat16]: {json.dumps(drates)}; caption agreement kernels vs plain: "
          f"float32 {f32_agree:.4f}, bfloat16 {bf16_agree:.4f}; penalty 1e3: groups' first "
          f"tokens disjoint")
    if f32_agree < AGREE_MIN:
        fail(f"diverse-beam-6 f32 caption agreement {f32_agree:.4f} < {AGREE_MIN}")
    out["diverse_beam6"] = {"captions_s": drates, "agree_f32": f32_agree, "agree_bf16": bf16_agree}

    # (d) the kernels' beam-5 n-best rescored by the plain teacher-forced decoder
    with precision("float32"):
        toks, scores, _ = call(lambda: make_beam_caption_fn(K, MAX_LEN, MAX_LEN,
                                                            return_all=True), params, None)
        rep = lambda x: x.repeat_interleave(K, dim=0)
        lp, n = make_sequence_scorer(MAX_LEN)(params, rep(app), rep(mot), rep(mask),
                                              toks.reshape(B * K, MAX_LEN))
        torch.cuda.synchronize()
    rel = ((lp.reshape(B, K) - scores).abs() / scores.abs()).max().item()
    print(f"a9 rescoring [float32]: sequence_logprob of the kernels' beam-5 n-best vs its scores, "
          f"max relative difference {rel:.3g} over {B * K} rows")
    if not torch.allclose(lp.reshape(B, K), scores, rtol=1e-4, atol=0.0):
        fail(f"a9 rescoring: sequence_logprob differs from the beam's scores by rel {rel:.3g}")
    if not torch.equal(n.reshape(B, K), (toks != PAD).sum(-1)):
        fail("a9 rescoring: lengths differ")
    return out


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs only on a CUDA device")
    if not os.path.isdir(os.path.join(HERE, "controllable_xgating_torch")):
        fail("run from the root of a checkout: controllable_xgating_torch/ not found")
    sys.path.insert(0, HERE)
    # the card's name and power limit, as nvidia-smi prints them
    global CARD
    CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(CARD)
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
    check_greedy_rows(params, dev, results)
    check_topk_epilogues(params, dev)
    check_pos_ragged(dev)
    check_xgate_routes(dev)
    check_topk(dev)

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

    # the quantized decode path and beam's full log-softmax tails
    k7 = int8_phase(params, cfg, store, labels, info, dev, counts)
    tails_phase(params, dev)
    beam10_phase(params, store, dev)
    # ensembles (same and cross architecture), diverse beam and rescoring
    a9 = a9_phase(params, cfg, store, labels, info, dev, counts)

    # the XE-training path: K5 against its plain version at the step's
    # shape, then the train steps
    n_rows = cfg.data.batch_size * cfg.data.caps_per_video_train * (MAX_LEN - 1)
    xent = check_xent(dev, n_rows, VOCAB)
    counts["xe-train"] = train_phase(cfg, dev)

    # SCST: the reward tables and the reward at MSR-VTT's caption scale,
    # then both realizations' steps, the baseline through K3
    scst = scst_phase(cfg, dev)

    # the entry points users run: train, eval and caption through main(argv)
    set_compute_dtype("float32")  # each CLI picks bf16 and must leave this as it found it
    cli = cli_phase(dev, cfg)

    banned = ("jax", "flax", "optax", "orbax", "h5py", "controllable_xgating_tpu", "experiments",
              "tools", "bench")
    pulled = sorted({m.split(".")[0] for m in sys.modules} & set(banned))
    if pulled:
        fail(f"the port pulled in {pulled}")

    src = "controllable_xgating_torch/csrc/"
    pallas = "controllable_xgating_tpu/ops/pallas/"
    kernel_rows = [  # name, source, the Pallas kernel it replaces, path, results
        ("xgate", "xgate.cu", pallas + "xgate.py:52", "beam-5", (*results["xgate"], None)),
        ("pos_lstm", "pos_lstm.cu", pallas + "pos_lstm.py:35", "beam-5",
         (*results["pos_lstm"], None)),
        ("attn_lstm", "attn_lstm.cu", pallas + "attn_lstm.py:43", "beam-5",
         (*results["attn_lstm"], None)),
        ("topk_tail", "topk_tail.cu", pallas + "topk_tail.py:66", "beam-5",
         (*results["topk_tail"], None)),
        ("xent_fwd", "xent.cu", pallas + "xent.py:49", "xe-train", xent["xent_fwd"]),
        ("xent_bwd", "xent.cu", pallas + "xent.py:60", "xe-train", xent["xent_bwd"]),
        # no PyTorch call takes an int8 weight with column scales (the bf16
        # projection it stands in for is printed by check_int8)
        ("int8_vocab", "int8_vocab.cu", "experiments/int8_vocab_matmul.py:87", "beam-5-int8",
         (*k7[:3], None)),
        # no path launches K6: its launches are the beam-5 run's, 0
        ("topk_extract", "topk_extract.cu", "experiments/pallas_logits_topk.py:50", "beam-5",
         (*results["topk_extract"], None)),
    ]
    bounds = {**caption_bounds(params), **xent_bounds(n_rows, VOCAB), **quant_bounds(params)}
    print("device us per launch (torch.profiler, the path's shapes; bound us): " + json.dumps(
        {n: [round(DEVICE_US[n], 2), round(bounds[n][0] * 1e3, 2)] for n, *_ in kernel_rows}))
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": src + f, "replaces": r,
         "launches": counts[path][n], "max_abs_err": res[0], "ms": res[1], "plain_ms": res[2],
         "bound_ms": bounds[n][0], "bound_by": bounds[n][1], "library_ms": res[3]}
        for n, f, r, path, res in kernel_rows
    ]}))
    print("scst phase launches in its timed steps: " + json.dumps(scst))
    print("a9 phase (host clock /s; agreement): " + json.dumps(a9))
    print("cli phase (host clock, s and /s): " + json.dumps(cli))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
