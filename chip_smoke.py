#!/usr/bin/env python3
"""Drive the PyTorch port's captioning (its decode loops as replayed CUDA
graphs and as eager loops), quantized-decoding, ensemble and diverse-beam,
XE-training and SCST paths, its command-line entry points, its serving
path, its own corpus -> train -> eval -> controllability study, its
data-parallel path, its host runtime and measurement surface (the
native metric library, `--profile`, `--debug_nans`, the roofline
shares), config 5 (the 2x decoder on the joint corpus, prefetched
training) and the C3D widths, its ingest, checkpoint and study tools, and
its measurement tools once on one NVIDIA GPU.

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
  5b. the decode loops as replayed CUDA graphs (`graphs_phase`; every
     decode loop of the script replays them, as on any CUDA call, unless
     `set_decode_graphs(False)`): beam-5, greedy, both with `vocab_q`, an
     ensemble's beam-5 (M = 2), diverse beam 6 / G 3, and the beam-5,
     greedy and POS loops alone, each graphed against the eager loop:
     outputs equal under f32 and bf16, launches per call equal; under bf16
     the wall (median of 5 in turns), device ms, busy share and
     captions/s of both, the capture seconds and pool MiB of each key and
     the chunks replayed per call;
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
  9b. the native host runtime and the measurement surface (`host_phase`,
     in build/chip_smoke_host, on the same corpus): the port's native
     library must build; `cli.eval --beam_size 5` in turns with the
     metrics native and Python (captions equal, metrics within rel 1e-9;
     captions/s, metric and decode wall); native vs Python tokens, stems,
     METEOR (with and without synonyms), ROUGE-L on its captions and the
     df table at MSR-VTT's caption scale (bit for bit; host seconds);
     `cli.train --profile` and `cli.eval --profile` traces whose kernel
     events count the run's launches (K5; K1-K4), the profiled eval equal
     to the unprofiled one; `cli.train --debug_nans` (f32) logging the
     run's values without it (rtol 1e-6), raising FloatingPointError on a
     copy with one NaN planted in the features, completing without the
     flag; the roofline shares of the graphed beam-5 and greedy calls and
     the XE step (`utils/roofline.py`, each <= 1.05);
  10. the serving path (`serve_phase`; `serve/engine.py` and
     `serve/server.py`, beam 5, buckets 1, 4, 16, 64): K1-K4 against
     their plain versions at bucket 1's and 4's shapes (f32 and bf16);
     under each policy a warmed engine (capture s and pool MiB per key)
     serving 64 seeded requests from 4 threads (a quarter controlled,
     ragged frame counts) and a batch of controlled rows only, with the
     launch counts set to 0 before and read after: every batch equal to
     the offline library call on the same padded bucket batch (tokens and
     tags exactly, scores rtol 1e-6) with its launches; under f32 the 256
     videos served against the 256-video offline call (>= 98% equal);
     one batch per bucket through the warmed bf16 engine and through one
     without warm-up whose captures run while the previous batch's
     completion waits on its event (same results); per bucket the wall
     of a served batch, free-run and with a controlled row, beside the
     offline call, and its device ms; closed loops of 8 and 64 HTTP
     clients by video id (requests/s, p50 / p99, occupancy, batches per
     bucket, busy share, idle gaps between batches) and an open loop at
     1.5x the 64-client rate with 200 ms deadlines (goodput, late
     completions, predictive sheds);
  11. the port's own user path on a corpus it makes (`study_phase`, in
     build/chip_smoke_study): `cli.prepro --fixtures` with the flagship
     recipe's corpus (600 videos x 26 frames at MSR-VTT width, captions
     of at most 20 tokens, 8 per video), `cli.train --stage pos` (4 of
     the recipe's 8 epochs) then `--stage caption` from it (16 of its 40
     epochs: the script's time limit) at the recipe's
     widths under bf16 (each stage's loss must fall; K1-K3 in the val
     evals, no K5: the corpus's 81 words are under its V >= 2048 gate),
     `cli.eval --beam_size 5` on the test split (K1-K4); on the trained
     checkpoint under f32 the kernels against the plain path for beam 5
     and greedy, free and under a template (>= 98% of the test videos
     each); the
     early exit of beam 5 and greedy graphed against eager (tokens
     equal; wall, device ms, busy share, chunks replayed, caption
     length); the int8 projection (K7) against bf16 (printed only);
     `tools.controllability_eval` with two templates (K1-K3) and
     `cli.caption` of one test video free (K1-K3) and with `--pos_tags`
     (no K2); `cli.score --per_video --bootstrap 200` on the eval's
     captions (its metrics the eval's); the beam-5 call on the trained
     weights through `utils/debug.py::kernel_plain_diff` under f32
     (tokens equal, floats within rtol 1e-4, atol 1e-5);
  12. data parallelism (`dp_phase`, in build/chip_smoke_dp): (a)
     `cli.train` under the CXG_* variables at world size 1 over NCCL,
     equal bit for bit under f32 to the run without a process group;
     (b) three XE steps of the train phase's batches as two ranks over
     gloo (on the one card) against one rank: f32 loss rtol 1e-5,
     parameters rtol 2e-4 / atol 1e-5, K5 launched on each rank; bf16
     printed with the step ms, the all-reduce ms and the gradient bytes;
     one SCST step's greedy reward rtol 1e-4; (c) with two or more
     cards, (b) over NCCL with 2 (or 4) ranks and `cli.train
     --parallel.num_devices N` against one device, else printed as
     skipped; (d) `evaluate_split` beam 5 over a mesh of two entries on
     the 256 videos: each block's tokens equal the offline call at its
     batch, f32 agreement with the unsharded call >= 98%; (e) a mesh
     engine at buckets (2, 8): every served block equal to the offline
     call on it, with its launches;
  13. config 5 at its own shape and the C3D widths (`config5_phase`, in
     build/chip_smoke_config5): (a) K3 and K4 at decoder Hd 1024 (2 x
     512), K7 at K 1024 and K1 at motion 4096 against their plain
     versions under f32 and bf16, with ms, device us per launch and
     bounds, and `lanes_fits(5, 1024)` with K4's shared memory; (b) the
     XE step at config 5 (64 x 5, dropout 0.5, bf16, K5) fed by the train
     loop's prefetch (depth 2) and without it, in turns (wall and device
     ms, busy share), f32 losses of 5 steps equal bit for bit with and
     without it, and 3 f32 steps as 2 gloo ranks against 1; (c) beam 5
     and greedy over the 256 videos (K1 1, K2-K4 28: the lanes tail),
     graphed tokens equal eager, f32 agreement >= 98%, captions/s,
     device ms and roofline shares; (d) beam 5 at motion 4096 (K1 once a
     call; under f32 K1 held inside the path >= 98%, the whole path's
     agreement printed); (e) `make_joint_fixture_corpus`
     at MSR-VTT width (600 + 300 videos), `cli.train --stage joint
     --model.decoder_hidden_mult 2` for one epoch (the loss falls) and
     `cli.eval --beam_size 5` (finite metrics, K1 once a batch);
  14. the ingest, checkpoint and study tools (`tools_phase`, in
     build/chip_smoke_tools, on the study phase's directory, which it
     then removes): (a) `tools.dress_rehearsal` at its default scale
     (10000 videos x 20 captions, MSR-VTT's splits, app 1536, motion
     1024) as a process: the vocab threshold, each stage's seconds and
     peak RSS, K5 once in each XE step and K1-K3 in the greedy val eval,
     the per-step losses finite and falling; its XE step on the same
     corpus in this process (wall, device ms, busy share); (b) the
     study's `best` as a reference-style `.pth` through
     `tools.import_torch_checkpoint`, and averaged with itself at
     weights 1,3 by `tools.average_checkpoints`: parameters equal bit for
     bit, `cli.eval --beam_size 5` on each gives the study's captions;
     (c) `tools.ablation_grid` cells concat_pos and xgate_nopos on the
     study corpus (flagship widths, epochs 1, 1, 1), each command's
     launches pinned (K1 0 in concat_pos; K2 and K3 in every command; K4
     in the beam-5 evals), finite metrics and controllability, then
     `tools.ablation_report` and `tools.psi_diversity` (K2);
  15. the measurement tools (`breakdown_phase`, in
     build/chip_smoke_breakdown), each through its `main` at MSR-VTT width
     with loops of 2 and 4 repetitions: the timing harness not pruned,
     each tool's launches pinned, the decode step and the loss against
     their plain versions, the reward of one call against two, every
     roofline share at most 1.05, the server at 100 and 800 requests/s,
     a trace that ranks the port's kernels;
then print every kernel's device microseconds per launch ("not
measured" where the profiler kept none of its events) beside its
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


def kernel_device_us(fn):
    """Device us per call in the port's kernels, or None: not measured
    (the profiler kept none of their events, twice)."""
    from controllable_xgating_torch.utils.profiling import kernel_device_us as measure

    return measure(fn)


def fmt_us(us) -> str:
    return "not measured" if us is None else f"{us:.2f}"


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


def kernel_cases(params, dev, r: int = B * K, b: int = B):
    """(name, kernel call, plain call) at the path's shapes, with seeded
    inputs, built under the current policy, for `b` videos (the fusion's
    b x 26 rows, the POS step's b); the decoder-step and top-K kernels at
    `r` rows (beam-5's by default). The kernels get their weights cast once
    beforehand, as the caption loops give them."""
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
    xa, xm = rn(b * T, enc.xgate.wa.shape[0]), rn(b * T, enc.xgate.wm.shape[0])
    tok_pos = ri(4, POS_VOCAB, (b,))
    e_pos = pos.embed[tok_pos]
    sg = _summary_gates(pos, torch.tanh(rn(b, he)))
    h_pos, c_pos = torch.tanh(rn(b, hp)), rn(b, hp)
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


def check_kernels(params, dev, policy: str, tols: dict, names=None, device_us=None,
                  tag: str = "") -> dict:
    """Kernel vs plain on the same inputs, within `tols[name]`, and the two
    top-K kernels against each other; returns {name: (max_abs_err, ms,
    plain_ms)}. `names` picks cases (default: all); under bf16 each
    kernel's device us per launch go into `device_us` (default DEVICE_US,
    the main path's); `tag` is added to the printed shape."""
    import torch

    from controllable_xgating_torch.ops.kernels.topk_tail import logits_topk_plain

    device_us = DEVICE_US if device_us is None else device_us
    cases, tail_inputs = kernel_cases(params, dev)
    cases = [c for c in cases if names is None or c[0] in names]
    policy = policy + tag
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
        if policy.startswith("bfloat16"):
            split = kernel_device_split(kern)
            device_us[name] = sum(split.values()) if split else None
            dev_us = f"  device {fmt_us(device_us[name])} us per launch"
            if len(split) > 1:  # a wrapper call of several kernels
                dev_us += " (" + ", ".join(f"{n} {us:.2f}" for n, us in split.items()) + ")"
        print(f"kernel {name} [{policy}]: max_abs_err {err:.3e}  kernel {ms:.4f} ms  "
              f"plain {plain_ms:.4f} ms{dev_us}")
        out[name] = (err, ms, plain_ms)
        if name == "topk_tail" and policy == "bfloat16":  # the main path's shape only
            # how close K4's mainloop gets to cuBLAS on the bare projection
            # (not K4's function: no bias, mask, top-K or lse; the logits go
            # to device memory)
            h16, w16 = tail_inputs[0].bfloat16(), tail_inputs[1].bfloat16()
            print(f"kernel topk_tail [{policy}]: cuBLAS h.bfloat16() @ w_out.bfloat16() "
                  f"{list(h16.shape)} x {list(w16.shape)}: {cuda_ms(lambda: h16 @ w16):.4f} ms "
                  f"(a diagnostic, not K4's function)")
    if not set(TOPK_KERNELS) <= set(tails):
        return out
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
              f"{fmt_us(kernel_device_us(kern))} us per launch; at {B * K} rows (beam-5) "
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
              f"kernel {out[rows][1]:.4f} ms  plain {out[rows][2]:.4f} ms  device "
              f"{fmt_us(dev_us)} us per launch  bf16 projection {out[rows][3]:.4f} ms  "
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


def chunk_counts(fn):
    """fn() under a span collector: its output and, by kind of decode
    loop, [chunks replayed, chunks its calls had]."""
    from controllable_xgating_torch.utils import spans

    with spans.collect() as col:
        out = fn()
    counters = col.summary()["counters"]
    kinds = [k[len("graphs.replays."):] for k in counters if k.startswith("graphs.replays.")]
    return out, {k: [counters[f"graphs.replays.{k}"], counters[f"graphs.chunks_of.{k}"]]
                 for k in kinds}


def replayed(chunks: dict) -> str:
    """`chunk_counts`'s counts as text: "chunks replayed r of n" by loop."""
    return "; ".join(f"{kind} chunks replayed {r} of {n}" for kind, (r, n) in chunks.items()) \
        or "no chunks replayed"


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


def bound(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    """(least ms the card could take, what bounds it): the larger of the
    bytes moved (each input read once, each output written once) over HBM
    bandwidth and the operations over the peak rate for their type (bf16
    on the tensor cores, f32 outside them), the card's published peaks
    from `utils/roofline.py`."""
    import torch

    from controllable_xgating_torch.utils.roofline import device_peaks

    ops_s, hbm_s, _ = device_peaks(torch.cuda.get_device_name(0), dtype)
    t_bytes, t_ops = nbytes / hbm_s, ops / ops_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def caption_bounds(params, b: int = B) -> dict:
    """Bounds of the caption kernels at the shapes `kernel_cases` gives
    them for `b` videos (beam 5), bf16 policy: operands in bf16 (2 bytes),
    biases, cell state, masks and f32 results in 4, products on the
    tensor cores."""
    c = 2
    enc, pos, dec = params.encoder, params.pos, params.decoder
    da, h = enc.xgate.wa.shape
    dm = enc.xgate.wm.shape[0]
    rows = b * T
    e_p, hp = pos.embed.shape[1], pos.lstm.hidden_dim
    r, hd, e, a, g, v = b * K, dec.hidden_dim, dec.embed.shape[1], dec.attn.wq.shape[1], \
        dec.w_psi.shape[1], dec.vocab_size
    return {
        # ea, em, two gates and the split Wf: 2 R H (Da + Dm + 4H)
        "xgate": bound(c * (rows * (da + dm + h) + h * (da + dm + 4 * h)) + 4 * 5 * h,
                       2 * rows * h * (da + dm + 4 * h), "bfloat16"),
        # gates = e @ wih_e + s_gates + h @ whh + b, then the cell
        "pos_lstm": bound(c * (b * (e_p + hp) + (e_p + hp) * 4 * hp)
                          + 4 * (b * 4 * hp + 4 * hp + 3 * b * hp),
                          2 * b * (e_p + hp) * 4 * hp, "bfloat16"),
        # keys and projected memory [R, T, A|G] dominate the bytes
        "attn_lstm": bound(c * (r * (hd + e + T * (a + g) + 2 * g)
                                + hd * a + a + (hd + e) * g + (e + g + hd) * 4 * hd)
                           + 4 * (r * hd + 2 * r * T + a + g + 4 * hd + 2 * r * hd),
                           2 * r * (hd * a + (hd + e) * g + (e + g + hd) * 4 * hd)
                           + 2 * r * T * (a + g), "bfloat16"),
        # h @ w_out over the whole vocab; K values, ids and the lse out
        "topk_tail": bound(c * (r * hd + hd * v) + 4 * v + 4 * r * (2 * K + 1),
                           2 * r * hd * v, "bfloat16"),
    }


def int8_bound(rows: int, hd: int, v: int) -> tuple[float, str]:
    """K7 at [rows, hd] -> v, reckoned as `caption_bounds` is: it reads x
    (bf16), wq (int8, padded width), scale and bias (f32) and writes the
    f32 logits; the products run on the bf16 tensor cores."""
    vpad = -(-v // 1024) * 1024
    return bound(2 * rows * hd + hd * vpad + 4 * 2 * vpad + 4 * rows * v, 2 * rows * hd * v,
                 "bfloat16")


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
        "xent_fwd": bound(4 * n * v + 8 * n + 12 * n, 4 * n * v, "float32"),
        "xent_bwd": bound(8 * n * v + 8 * n + 16 * n, 4 * n * v, "float32"),
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
              f"plain {plain_ms:.4f} ms  device {fmt_us(DEVICE_US[name])} us per launch  "
              f"F.cross_entropy {lib_ms:.4f} ms")
    # each launch's own device time (a sum over launches can drop events):
    # the median of 10, with the number of launches the profiler kept
    from controllable_xgating_torch.utils.profiling import kernel_launch_us

    for name, fn in (("xent_fwd", lambda: xent_fwd_kernel(x, t)),
                     ("xent_bwd", lambda: xent_bwd_kernel(x, t, lse, *cot))):
        for kern, us in kernel_launch_us(fn, calls=10).items():
            print(f"kernel {name} [float32, {n}x{v}]: {kern} device us per launch, median of "
                  f"{len(us)} launches seen of 10: {sorted(us)[len(us) // 2]:.2f} "
                  f"(min {min(us):.2f}, max {max(us):.2f}); {CARD}")
    return out


def train_phase(cfg, dev) -> tuple[dict, float]:
    """The XE-training path; returns the xent launch counts of the bf16
    main-path run and its seconds per step."""
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
    step_s = dt / 5
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
    return counts, step_s


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


def counted_cli(label: str, main, argv: list, counts: dict, want=(), absent=()):
    """One CLI run through `main(argv)` with its launches counted (set to 0
    before, read after, into `counts[label]`): (stdout, wall s). Fails the
    script where the CLI exits, where a kernel of `want` did not launch or
    one of `absent` did, or where the CLI left the process's compute
    policy changed."""
    import contextlib
    import io

    import torch

    from controllable_xgating_torch.ops import kernels
    from controllable_xgating_torch.ops.precision import compute_dtype

    before = compute_dtype()
    kernels.reset_launch_counts()
    buf = io.StringIO()
    t = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            main(argv)
    except SystemExit as e:
        fail(f"{label}: exited {e.code}")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    got = counts[label] = kernels.launch_counts()
    print(f"{label} launches {got}")
    if [n for n in want if not got[n]] or [n for n in absent if got[n]]:
        fail(f"{label}: expected launches of {list(want)} and none of {list(absent)}: {got}")
    if compute_dtype() != before:
        fail(f"{label}: left the compute policy at {compute_dtype()}")
    return buf.getvalue(), dt


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
    import shutil

    import torch

    from controllable_xgating_torch.cli import caption as cli_caption
    from controllable_xgating_torch.cli import eval as cli_eval
    from controllable_xgating_torch.cli import train as cli_train
    from controllable_xgating_torch.cli.common import load_corpus, restore_params
    from controllable_xgating_torch.infer.beam import make_beam_caption_fn
    from controllable_xgating_torch.infer.evaluator import evaluate_split
    from controllable_xgating_torch.ops.precision import precision

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
        res = counted_cli(f"cli {label}", main, base + argv, counts, want, absent)
        counts[label] = counts.pop(f"cli {label}")
        return res

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


# the host runtime and the measurement surface (`host_phase`): the native
# library under the metrics and the df build, `--profile`, `--debug_nans`
# and the roofline shares
HOST_SYNONYM_PAIRS = 200  # synonym groups of two corpus words each, for METEOR's stage 3
HOST_REL = 1e-9  # native vs Python metrics (tests/test_native_text.py's bar)
ROOFLINE_MAX = 1.05  # a share above this means the cost model or the clock is wrong


def trace_counts(logdir: str) -> tuple[dict, dict, float]:
    """({wrapper: the launches its kernel's device events account for
    (`profiling.kernel_event_launches`)}, {entry point: user annotations},
    MiB) of the one `torch.profiler` trace in `logdir`."""
    from controllable_xgating_torch.utils.profiling import kernel_event_launches

    files = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
    if len(files) != 1:
        fail(f"--profile {logdir}: expected one trace, found {files}")
    path = os.path.join(logdir, files[0])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    notes = {}
    for e in events:
        name = e.get("name", "")
        if e.get("cat") == "user_annotation" and name.startswith("cxg_"):
            notes[name] = notes.get(name, 0) + 1
    seen = kernel_event_launches(e.get("name", "") for e in events if e.get("cat") == "kernel")
    return seen, notes, os.path.getsize(path) / 2 ** 20


class python_metrics:
    """The port's native library out of reach for the span: every entry
    point of `utils/native.py` returns None, so the scorers and the
    tokenizer take their pure-Python paths."""

    def __enter__(self):
        from controllable_xgating_torch.utils import native

        self.native, self.saved = native, (native._LIB, native._TRIED)
        native._LIB, native._TRIED = None, True

    def __exit__(self, *exc):
        self.native._LIB, self.native._TRIED = self.saved


def train_losses(run_dir: str) -> list:
    with open(os.path.join(run_dir, "train_log.jsonl")) as f:
        return [{k: v for k, v in e.items() if k != "ts"} for e in map(json.loads, f)]


def host_phase(dev, cfg, graph_rows: dict, xe_step_s: float) -> dict:
    """The native host runtime and the measurement surface, on the CLI
    corpus (`write_cli_corpus`, seed 2, in build/chip_smoke_host), the
    CLIs through `main(argv)` with their launches counted:
    (a) the port's native library must build and load. `cli.eval
    --beam_size 5` over the 256 test videos in turns with the metrics
    native and Python (native, python, python, native): captions equal,
    metrics within rel HOST_REL, captions/s and the metric and decode wall
    of each; on that eval's captions and references, native and Python
    tokens and stems equal, METEOR (with and without a synonym table) and
    ROUGE-L within HOST_REL; the native df builder against the numpy build
    at MSR-VTT's caption scale, bit for bit, both builds' host seconds. (b) `cli.train --profile` and
    `cli.eval --beam_size 5 --profile` each write one trace whose kernel
    events count the run's launches (K5 forward and backward; K1-K4, with
    the launches of the graph captures' warm-ups, which the counters leave
    out: `infer/graphs.py::WARMUP_LAUNCHES`); the
    profiled eval's captions and metrics equal the unprofiled run's. (c)
    `cli.train --debug_nans` on the clean corpus logs the losses of the run
    without it (f32 rtol 1e-6); on a copy with one NaN in a train video's
    appearance features it raises FloatingPointError, and without the flag
    it completes. (d) the roofline shares (`utils/roofline.py`, the card's
    published peaks) of the graphed beam-5 and greedy calls and of the XE
    step that the earlier phases timed, each at most ROOFLINE_MAX.
    Returns the phase's numbers."""
    import contextlib
    import shutil

    import numpy as np
    import torch

    from controllable_xgating_torch.cli import eval as cli_eval
    from controllable_xgating_torch.cli import train as cli_train
    from controllable_xgating_torch.data.tokenizer import PTBTokenizer
    from controllable_xgating_torch.infer import evaluator, graphs
    from controllable_xgating_torch.metrics.meteor import MeteorScorer
    from controllable_xgating_torch.metrics.rouge import RougeScorer
    from controllable_xgating_torch.metrics.stemmer import stem
    from controllable_xgating_torch.ops import cider_device as cd
    from controllable_xgating_torch.ops import dispatch
    from controllable_xgating_torch.utils import native, roofline

    out: dict = {}
    t0 = time.perf_counter()
    if not native.available():
        fail(f"host: the port's native library did not build or load ({native.library_path()})")
    print(f"host native library {os.path.relpath(native.library_path(), HERE)}: built or loaded "
          f"in {time.perf_counter() - t0:.2f} s")
    root = os.path.join(HERE, "build", "chip_smoke_host")
    shutil.rmtree(root, ignore_errors=True)
    data, ck = os.path.join(root, "corpus"), os.path.join(root, "ck")
    write_cli_corpus(data, cfg, seed=2)
    base = ["--data_dir", data, "--config", os.path.join(HERE, "configs", "msrvtt.json")]
    joint = os.path.join(ck, "joint")
    counts: dict = {}

    # (b) train --profile (also the checkpoint of the evals): K5 in its trace
    prof = os.path.join(root, "prof_train")
    counted_cli("host train --profile", cli_train.main,
                base + ["--checkpoint_dir", ck, "--stage", "joint", "--epochs", "1",
                        "--profile", prof], counts, ("xent_fwd", "xent_bwd"))
    seen, notes, mib = trace_counts(prof)
    got = counts["host train --profile"]
    print(f"host train --profile [joint, 1 epoch, {CARD}]: one trace of {mib:.1f} MiB, kernel "
          f"events per launch {json.dumps(seen)}, entry-point annotations {json.dumps(notes)}")
    for name in ("xent_fwd", "xent_bwd"):
        if seen.get(name) != got[name]:
            fail(f"host train --profile: the trace holds {seen.get(name)} {name} launches, the "
                 f"run launched {got[name]}")
    out["profile_train"] = {"trace": seen, "launches": {n: got[n] for n in ("xent_fwd", "xent_bwd")},
                            "trace_mib": mib}

    # (a) cli.eval beam 5 in turns, its metrics native and Python
    timing: dict = {}
    captured: dict = {}
    language_eval, make_beam = evaluator.language_eval, cli_eval.make_beam_caption_fn

    def timed_eval(gts, res, **kw):
        t = time.perf_counter()
        scored = language_eval(gts, res, **kw)
        timing["metrics_s"] += time.perf_counter() - t
        captured.update(gts=gts, res=res)
        return scored

    def timed_beam(*a, **kw):
        fn = make_beam(*a, **kw)

        def call(*x):
            t = time.perf_counter()
            tokens = fn(*x)
            torch.cuda.synchronize()
            timing["decode_s"] += time.perf_counter() - t
            return tokens

        return call

    n_test = CLI_SPLITS["test"]
    eval_argv = base + ["--checkpoint_dir", joint, "--split", "test", "--beam_size", "5"]
    runs: dict = {"native": [], "python": []}
    results = {}
    evaluator.language_eval, cli_eval.make_beam_caption_fn = timed_eval, timed_beam
    try:
        for i, mode in enumerate(("native", "python", "python", "native")):
            path = os.path.join(root, f"eval_{i}.json")
            timing.update(metrics_s=0.0, decode_s=0.0)
            with python_metrics() if mode == "python" else contextlib.nullcontext():
                _, dt = counted_cli(f"host eval-beam-5 [{mode} metrics]", cli_eval.main,
                                    eval_argv + ["--out", path], counts,
                                    (*CLI_CAPTION_KERNELS, "topk_tail"))
            with open(path) as f:
                results[i] = json.load(f)
            runs[mode].append({"captions_s": n_test / dt, "wall_s": dt, **timing})
    finally:
        evaluator.language_eval, cli_eval.make_beam_caption_fn = language_eval, make_beam
    ref = results[0]
    for i, res in results.items():
        if res["captions"] != ref["captions"]:
            fail(f"host eval: run {i}'s captions differ from the first run's")
        for k, v in res["metrics"].items():
            if not math.isclose(v, ref["metrics"][k], rel_tol=HOST_REL, abs_tol=1e-12):
                fail(f"host eval: {k} {v} (run {i}) vs {ref['metrics'][k]} (native)")
    out["eval"] = runs
    print(f"host eval [beam 5, {n_test} test videos, bf16, {CARD}], in turns native, python, "
          f"python, native metrics: captions equal, metrics within rel {HOST_REL}; captions/s "
          f"native {[round(r['captions_s'], 2) for r in runs['native']]}, python "
          f"{[round(r['captions_s'], 2) for r in runs['python']]}; metric wall s native "
          f"{[round(r['metrics_s'], 4) for r in runs['native']]}, python "
          f"{[round(r['metrics_s'], 4) for r in runs['python']]}; decode wall s native "
          f"{[round(r['decode_s'], 4) for r in runs['native']]}, python "
          f"{[round(r['decode_s'], 4) for r in runs['python']]}; metrics "
          f"{json.dumps(ref['metrics'])}")

    # (a) the text paths on that eval's captions and references
    gts, res = captured["gts"], captured["res"]
    texts = [c for caps in gts.values() for c in caps] + [c[0] for c in res.values()]
    tok = PTBTokenizer()
    if any(native.ptb_tokenize(s) != tok.tokenize_python(s) for s in texts):
        fail("host: native tokens differ from the Python tokenizer's")
    words = sorted({w for s in texts for w in s.split()})
    if any(native.porter_stem(w) != stem(w) for w in words):
        fail("host: native stems differ from the Python stemmer's")
    synonyms = [(words[2 * i], words[2 * i + 1]) for i in range(min(HOST_SYNONYM_PAIRS,
                                                                      len(words) // 2))]
    scores, walls = {}, {}
    for name, make in (("METEOR", lambda nat: MeteorScorer(use_native=nat)),
                       ("METEOR+synonyms", lambda nat: MeteorScorer(use_native=nat,
                                                                    synonyms=synonyms)),
                       ("ROUGE_L", lambda nat: RougeScorer())):
        for nat in (True, False):
            t = time.perf_counter()
            with contextlib.nullcontext() if nat else python_metrics():
                scores[name, nat] = make(nat).score(gts, res)
            walls[f"{name} {'native' if nat else 'python'}"] = time.perf_counter() - t
        (a, per_a), (b, per_b) = scores[name, True], scores[name, False]
        if not math.isclose(a, b, rel_tol=HOST_REL, abs_tol=1e-12) or not np.allclose(
                per_a, per_b, rtol=HOST_REL, atol=1e-12):
            fail(f"host: {name} native {a} vs python {b}")
    out["text"] = {"texts": len(texts), "words": len(words), "wall_s": walls,
                   "scores": {n: scores[n, True][0] for n, _ in scores}}
    print(f"host text paths [{len(texts)} captions and references, {len(words)} words, "
          f"{len(synonyms)} synonym groups]: tokens and stems equal; METEOR, METEOR with "
          f"synonyms, ROUGE-L within rel {HOST_REL}; host s {json.dumps(walls)}")

    # (a) the SCST reward tables' df at MSR-VTT's caption scale: the native
    # builder against the numpy build `ops/cider_device.py` keeps
    caps, _ = draw_captions(np.random.default_rng(4), SCST_VIDEOS, SCST_CAPS)
    ncaps = np.full(SCST_VIDEOS, SCST_CAPS, np.int32)
    vids = list(range(SCST_DF_VIDEOS))
    built, walls = {}, {}
    for name in ("native", "numpy"):
        t = time.perf_counter()
        built[name] = native.build_df(caps, ncaps, vids) if name.startswith("native") \
            else cd._df_table(caps, ncaps, vids)
        walls[name] = time.perf_counter() - t
    h1, h2, df_native = built["native"]
    keys, df = built["numpy"]
    if not (np.array_equal((h1.astype(np.uint64) << np.uint64(32)) | h2, keys)
            and np.array_equal(df_native.view(np.uint32), df.view(np.uint32))):
        fail("host: the native df table differs from the numpy build")
    out["df_build_s"] = walls
    print(f"host df table [{SCST_VIDEOS} videos x {SCST_CAPS} captions, df over {SCST_DF_VIDEOS}, "
          f"{len(keys)} n-grams, {CARD}]: native equals numpy bit for bit; host s "
          f"{json.dumps(walls)}")

    # (b) eval --profile: K1-K4 in its trace, the unprofiled run's results
    prof = os.path.join(root, "prof_eval")
    path = os.path.join(root, "eval_profiled.json")
    graphs.WARMUP_LAUNCHES.clear()
    counted_cli("host eval-beam-5 --profile", cli_eval.main,
                eval_argv + ["--out", path, "--profile", prof], counts,
                (*CLI_CAPTION_KERNELS, "topk_tail"))
    warmup = dict(graphs.WARMUP_LAUNCHES)
    with open(path) as f:
        res_prof = json.load(f)
    if res_prof["captions"] != ref["captions"] or res_prof["metrics"] != ref["metrics"]:
        fail("host eval --profile: captions or metrics differ from the unprofiled run's")
    seen, notes, mib = trace_counts(prof)
    got = counts["host eval-beam-5 --profile"]
    print(f"host eval --profile [beam 5, {n_test} test videos, {CARD}]: one trace of {mib:.1f} "
          f"MiB; kernel events per launch {json.dumps(seen)} against launches "
          f"{json.dumps({n: got[n] for n in seen})} plus the graph captures' warm-up "
          f"{json.dumps(warmup)} (real launches the counters leave out); entry-point "
          f"annotations (eager calls, warm-ups and captures) {json.dumps(notes)}; captions and "
          f"metrics equal the unprofiled run's")
    for name in (*CLI_CAPTION_KERNELS, "topk_tail"):
        if seen.get(name) != got[name] + warmup.get(name, 0):
            fail(f"host eval --profile: the trace holds {seen.get(name)} {name} launches, the "
                 f"run launched {got[name]} and its captures' warm-ups {warmup.get(name, 0)}")
    out["profile_eval"] = {"trace": seen, "launches": got, "warmup": warmup,
                           "annotations": notes, "trace_mib": mib}

    # (c) --debug_nans: the clean corpus, then one planted NaN
    f32 = ["--compute_dtype", "float32", "--train.log_every_steps", "1", "--stage", "joint",
           "--epochs", "1"]
    walls = {}
    for name, extra in (("plain", []), ("debug", ["--debug_nans"])):
        _, walls[name] = counted_cli(f"host train f32 [{name}]", cli_train.main,
                                     base + f32 + ["--checkpoint_dir",
                                                   os.path.join(root, f"ck_{name}")] + extra,
                                     counts, ("xent_fwd", "xent_bwd"))
    want, got = (train_losses(os.path.join(root, f"ck_{n}", "joint")) for n in ("plain", "debug"))
    if len(got) != len(want) or any(g.keys() != w.keys() for g, w in zip(got, want)):
        fail("host train --debug_nans: the log differs in shape from the run's without")
    worst = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-30) for g, w in zip(got, want) for k in w
                if isinstance(w[k], float))
    if worst > 1e-6 or dispatch.nan_checks_enabled() or torch.is_anomaly_enabled():
        fail(f"host train --debug_nans: logged values within rel {worst} of the run's without "
             f"(1e-6), or the checks were left on")
    print(f"host train --debug_nans [f32, joint, 1 epoch, {CARD}]: every logged value within rel "
          f"{worst:.3g} of the run without; wall {walls['debug']:.2f} s against "
          f"{walls['plain']:.2f} s; launches {json.dumps(counts['host train f32 [debug]'])}")
    nan_data = os.path.join(root, "corpus_nan")
    shutil.copytree(data, nan_data)
    app_path = os.path.join(nan_data, "features", "app.npy")
    app = np.load(app_path)
    app[0, 0, 3] = np.nan  # video 0: the first train video (`write_cli_corpus`'s splits)
    np.save(app_path, app)
    nan_argv = ["--data_dir", nan_data, "--config", base[3], *f32]
    try:
        cli_train.main(nan_argv + ["--checkpoint_dir", os.path.join(root, "ck_nan_debug"),
                                   "--debug_nans"])
        fail("host train --debug_nans on the planted NaN: no FloatingPointError")
    except FloatingPointError as e:
        message = str(e)
    if dispatch.nan_checks_enabled() or torch.is_anomaly_enabled():
        fail("host train --debug_nans: the checks were left on after the error")
    cli_train.main(nan_argv + ["--checkpoint_dir", os.path.join(root, "ck_nan")])
    losses = [e["loss"] for e in train_losses(os.path.join(root, "ck_nan", "joint")) if "loss" in e]
    print(f"host train on one planted NaN [video0, frame 0, {CARD}]: --debug_nans raised "
          f"FloatingPointError: {message}; without the flag the run completes, losses {losses}")
    out["debug_nans"] = {"clean_worst_rel": worst, "wall_s": walls, "nan_message": message,
                         "nan_losses_without": losses}

    # (d) the roofline shares of the calls the earlier phases timed
    kind = torch.cuda.get_device_name(0)
    m = cfg.model
    rows = {
        "beam-5": (roofline.beam_workload_cost(m, B, K, MAX_LEN, MAX_LEN), graph_rows["beam-5"]),
        "greedy": (roofline.greedy_workload_cost(m, B, MAX_LEN, MAX_LEN), graph_rows["greedy"]),
        "xe-step": (roofline.xe_step_cost(m, cfg.data.batch_size, cfg.data.caps_per_video_train,
                                          MAX_LEN, MAX_LEN), None),
    }
    out["roofline"] = {}
    for name, (cost, row) in rows.items():
        times = ({"wall": xe_step_s} if row is None else
                 {"wall": row["graphed"]["wall_ms"] / 1e3, "device": row["graphed"]["device_ms"] / 1e3})
        shares = {k: roofline.utilization(cost, s, kind, "bfloat16") for k, s in times.items()}
        steps = "28 steps" if row is None else replayed(row["chunks"])
        out["roofline"][name] = {"flops": cost.flops, "hbm_bytes": cost.hbm_bytes, **shares}
        print(f"host roofline {name} [bf16, {CARD}; {steps}; the model counts every step]: "
              f"{cost.flops / 1e9:.2f} GFLOP, {cost.hbm_bytes / 2 ** 20:.1f} MiB; " + "; ".join(
                  f"on the {k} time {s * 1e3:.3f} ms: mfu {u['mfu']}, hbm_bw_util "
                  f"{u['hbm_bw_util']}, bound {u['bound']}, headroom {u['headroom_x']}x"
                  for (k, s), u in zip(times.items(), shares.values())))
        for u in shares.values():
            if u["mfu"] > ROOFLINE_MAX or u["hbm_bw_util"] > ROOFLINE_MAX:
                fail(f"host roofline {name}: a share over {ROOFLINE_MAX}: {u}")
    shutil.rmtree(root, ignore_errors=True)
    out["launches"] = counts
    return out


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




def graphs_phase(params, cfg, store, dev) -> dict:
    """The decode loops as replayed CUDA graphs (`infer/graphs.py`) against
    the eager loop (`set_decode_graphs(False)`), kernels on, over the 256
    videos: beam-5 (lanes tail), greedy, both with `vocab_q` (the entry
    point of `tools/quant_ab.py`), an ensemble's beam-5 (seeds 0 and 1),
    diverse beam 6 / G 3, each a whole caption call (encoder, POS rollout,
    decode); then the loops alone on one encoding: beam-5's and greedy's
    decode loop and the POS rollout on the encoder's summary. For each:
    tokens (and tags) equal under f32 and bf16 (psi within rtol 1e-6),
    launches per call equal (bf16), then under bf16 the wall of 5 calls in
    turns after a warm-up (median), the device time of one call (the
    profiler's, where it sees the replayed kernels, else the CUDA-event
    span), busy share and captions/s, the capture seconds and pool bytes
    of the path's keys and the chunks replayed per call. Returns the
    printed rows."""
    import numpy as np
    import torch

    from controllable_xgating_torch.experiments.int8_vocab_matmul import quantize_vocab_proj
    from controllable_xgating_torch.infer import graphs
    from controllable_xgating_torch.infer.beam import beam_search, make_beam_caption_fn
    from controllable_xgating_torch.infer.ensemble import make_ensemble_caption_fn
    from controllable_xgating_torch.infer.evaluator import make_greedy_caption_fn
    from controllable_xgating_torch.infer.greedy import greedy_decode
    from controllable_xgating_torch.models.captioner import encode_for_inference, init_captioner
    from controllable_xgating_torch.models.pos_generator import pos_greedy_generate
    from controllable_xgating_torch.ops import kernels
    from controllable_xgating_torch.ops.dispatch import set_decode_graphs
    from controllable_xgating_torch.ops.precision import precision
    from controllable_xgating_torch.tools.quant_ab import make_fn
    from controllable_xgating_torch.utils.profiling import call_device_ms

    app, mot = (torch.as_tensor(x, device=dev) for x in store.get_batch(np.arange(B)))
    mask = torch.as_tensor(store.frame_mask(np.arange(B)), device=dev)
    members = (params, init_captioner(cfg, seed=1, device=dev))
    vq = quantize_vocab_proj(params.decoder.w_out, params.decoder.b_out)

    def fns():
        """Each path's call, built now under the current policy (the
        factories read the kernel setting when they build; the loops alone
        run on an encoding made now)."""
        with torch.inference_mode():
            ctx, summary, _ = encode_for_inference(params, app, mot, mask, max_pos_len=MAX_LEN,
                                                   fused=True)
        loop = torch.inference_mode()(lambda beam: beam_search(
            params.decoder, ctx, summary, K, MAX_LEN, fused=True, early_stop=True) if beam else
            (greedy_decode(params.decoder, ctx, summary, MAX_LEN, fused=True, early_stop=True),))
        pos_rollout = torch.inference_mode()(lambda: pos_greedy_generate(
            params.pos, summary, MAX_LEN, early_stop=True, fused=True))
        beam5, greedy = make_beam_caption_fn(K, MAX_LEN, MAX_LEN), \
            make_greedy_caption_fn(MAX_LEN, MAX_LEN)
        beam_q, greedy_q = make_fn(cfg, True, vq), make_fn(cfg, False, vq)
        ens = make_ensemble_caption_fn(K, MAX_LEN, MAX_LEN)
        diverse = make_beam_caption_fn(6, MAX_LEN, MAX_LEN, diversity_groups=3)
        return {
            "beam-5": lambda: beam5(params, app, mot, mask),
            "greedy": lambda: greedy(params, app, mot, mask),
            "beam-5-int8": lambda: beam_q(params, app, mot, mask),
            "greedy-int8": lambda: greedy_q(params, app, mot, mask),
            "ensemble-beam-5": lambda: ens(members, app, mot, mask),
            "diverse-beam-6": lambda: diverse(params, app, mot, mask),
            "beam-5-loop": lambda: loop(True),
            "greedy-loop": lambda: loop(False),
            "pos-rollout": pos_rollout,
        }

    def run(fn, on: bool):
        set_decode_graphs(None if on else False)
        try:
            out = fn()
        finally:
            set_decode_graphs(None)
        torch.cuda.synchronize()
        return out

    rows = {}
    for policy in ("float32", "bfloat16"):
        with precision(policy):
            for label, fn in fns().items():
                graphs.clear()  # the keys cached next are this path's
                eager = run(fn, False)
                graphed, chunks = chunk_counts(lambda: run(fn, True))
                for a, b in zip(graphed, eager):
                    ok = torch.allclose(a, b, rtol=1e-6, atol=0.0) if a.is_floating_point() \
                        else torch.equal(a, b)
                    if not ok:
                        fail(f"graphs {label} [{policy}]: the graphed loop's outputs differ from "
                             f"the eager loop's")
                print(f"graphs {label} [{policy}]: graphed outputs equal the eager loop's "
                      f"({replayed(chunks)})")
                if policy == "float32":
                    continue
                counts = []
                for on in (False, True):
                    kernels.reset_launch_counts()
                    run(fn, on)
                    counts.append(kernels.launch_counts())
                if counts[0] != counts[1]:
                    fail(f"graphs {label}: launches per call, eager {counts[0]}, "
                         f"graphed {counts[1]}")
                new = graphs.cache_info()
                walls = {"graphed": [], "eager": []}
                run(fn, True), run(fn, False)
                for i in range(5):
                    for on in ((True, False) if i % 2 == 0 else (False, True)):
                        t = time.perf_counter()
                        run(fn, on)
                        walls["graphed" if on else "eager"].append(
                            (time.perf_counter() - t) * 1e3)
                row = {"launches": {n: c for n, c in counts[1].items() if c},
                       "chunks": chunks,
                       "keys": [{"kind": e["kind"], "capture_s": round(e["capture_s"], 3),
                                 "pool_mib": round(e["pool_bytes"] / 2 ** 20, 1)} for e in new]}
                for name, on in (("graphed", True), ("eager", False)):
                    d = call_device_ms(lambda: run(fn, on))
                    wall = float(np.median(walls[name]))
                    dev_ms = d["profiler"] if d["kernels_seen"] else d["events"]
                    row[name] = {
                        "wall_ms": wall, "walls_ms": walls[name], "device_ms": dev_ms,
                        "device_from": "profiler" if d["kernels_seen"] else "events",
                        "profiler_ms": d["profiler"], "kernels_seen": d["kernels_seen"],
                        "events_ms": d["events"], "busy": dev_ms / wall,
                        "captions_s": B / wall * 1e3}
                rows[label] = row
                g, e = row["graphed"], row["eager"]
                print(f"graphs {label} [bfloat16, {B} videos, {CARD}]: wall {g['wall_ms']:.2f} ms "
                      f"graphed vs {e['wall_ms']:.2f} eager (median of 5 in turns); device "
                      f"{g['device_ms']:.2f} vs {e['device_ms']:.2f} ms ({g['device_from']} / "
                      f"{e['device_from']}); busy {g['busy']:.3f} vs {e['busy']:.3f}; "
                      f"{'rows' if label == 'pos-rollout' else 'captions'}/s "
                      f"{g['captions_s']:.1f} vs {e['captions_s']:.1f}; keys {row['keys']}; "
                      f"{replayed(row['chunks'])}")
    return rows


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


# the serve phase: the engine's buckets and the kernels of its beam-5
# path; each closed loop's length, the open loop's length, deadline and
# offered rate over the 64-client closed loop's
SERVE_BUCKETS = (1, 4, 16, 64)
SERVE_PATH = ("xgate", "pos_lstm", "attn_lstm", "topk_tail")
CLOSED_S, OPEN_S, DEADLINE_MS, OVERLOAD = 3.0, 3.0, 200.0, 1.5
SLEEP_CYCLES = 600_000_000  # a device sleep of ~0.3 s at the H100's boost clock


def check_serve_kernels(params, dev) -> dict:
    """K1-K4 against their plain versions at bucket 1's and bucket 4's
    shapes (beam 5: the fusion on 26b rows, the POS step on b, the decoder
    step and the top-K tail on 5b), under the f32 policy (F32_TOL) and the
    bf16 policy (BF16_TOL; top-K ids equal on rows clear of ties); wrapper
    and plain ms (CUDA events) and, under bf16, device us per launch
    beside the bound. Returns {"name@b": numbers}."""
    import torch

    from controllable_xgating_torch.ops.kernels.topk_tail import logits_topk_plain
    from controllable_xgating_torch.ops.precision import precision

    rows = {}
    for b in (1, 4):
        bounds = caption_bounds(params, b)
        for policy in ("float32", "bfloat16"):
            with precision(policy):
                cases, tail_inputs = kernel_cases(params, dev, r=b * K, b=b)
                rv, ri, _ = logits_topk_plain(*tail_inputs, K + 1)
                for name, kern, plain in cases:
                    if name not in SERVE_PATH:
                        continue
                    tol = BF16_TOL[name] if policy == "bfloat16" else F32_TOL
                    label = f"{name} [{policy}, bucket {b}]"
                    got, ref = kern(), plain()
                    torch.cuda.synchronize()
                    got = got if isinstance(got, tuple) else (got,)
                    ref = ref if isinstance(ref, tuple) else (ref,)
                    if name == "topk_tail":
                        clear, same = ids_agree(got[1], rv, ri, tol)
                        if not bool(same[clear].all()):
                            fail(f"{label}: top-{K} ids differ on "
                                 f"{int((~same & clear).sum())} clear rows")
                        got, ref = (got[0], got[2]), (ref[0], ref[2])
                    err = max((x.float() - y.float()).abs().max().item() for x, y in zip(got, ref))
                    if not all(bool(torch.isfinite(x).all()) and torch.allclose(
                            x.float(), y.float(), **tol) for x, y in zip(got, ref)):
                        fail(f"{label}: max |kernel - plain| = {err:.3e} outside {tol}")
                    ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
                    line = (f"kernel {label}: max_abs_err {err:.3e}  kernel {ms:.4f} ms  "
                            f"plain {plain_ms:.4f} ms")
                    if policy == "bfloat16":
                        us = kernel_device_us(kern)
                        line += (f"  device {fmt_us(us)} us per launch (bound "
                                 f"{bounds[name][0] * 1e3:.2f} us, {bounds[name][1]})")
                        rows[f"{name}@{b}"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                               "device_us": us, "bound_us": bounds[name][0] * 1e3}
                    print(f"{line}; {CARD}")
    return rows


def serve_requests(cfg, n: int, seed: int, tags: list) -> list:
    """n seeded requests at MSR-VTT width: T in [13, 39] frames (below, at
    and above the model's 26) with nframes in [1, T]; every fourth
    controlled by 3-12 tags."""
    import numpy as np

    rng = np.random.default_rng(seed)
    m, out = cfg.model, []
    for i in range(n):
        t = int(rng.integers(T // 2, T * 3 // 2))
        out.append({
            "app": rng.standard_normal((t, m.app_dim), dtype=np.float32),
            "motion": rng.standard_normal((t, m.motion_dim), dtype=np.float32),
            "nframes": int(rng.integers(1, t + 1)),
            "pos_tags": ([tags[j] for j in rng.integers(0, len(tags), int(rng.integers(3, 13)))]
                         if i % 4 == 1 else None),
        })
    return out


def submit_from_threads(eng, reqs: list, threads: int = 4) -> list:
    """Submit `reqs` from `threads` threads at once -> their Futures, in order."""
    import threading

    futs = [None] * len(reqs)
    barrier = threading.Barrier(threads)

    def producer(k):
        barrier.wait(60)
        for i in range(k, len(reqs), threads):
            futs[i] = eng.submit(**reqs[i])

    ts = [threading.Thread(target=producer, args=(k,)) for k in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    if any(t.is_alive() for t in ts) or None in futs:
        fail("serve: a producer thread did not submit its requests")
    return futs


def serve_offline(params, cfg, inputs):
    """The offline library call on one padded bucket batch, kernels on:
    `encode_for_inference` with `use_tags`, then `beam_search` ->
    (tokens, tags, scores)."""
    import torch

    from controllable_xgating_torch.infer.beam import beam_search
    from controllable_xgating_torch.models.captioner import encode_for_inference

    app, motion, mask, tags, use_tags = inputs
    with torch.inference_mode():
        ctx, summary, tags_out = encode_for_inference(
            params, app.float(), motion.float(), mask, pos_tags=tags,
            max_pos_len=cfg.model.max_pos_len, fused=True, early_stop=True, use_tags=use_tags)
        toks, scores = beam_search(params.decoder, ctx, summary, K, cfg.eval.max_decode_len,
                                   cfg.eval.length_penalty, fused=True, early_stop=True)
    return toks.int(), tags_out.int(), scores


def check_served_batches(eng, params, cfg, policy: str, reqs: list, controlled: list) -> dict:
    """Serve `reqs` from 4 threads, then `controlled` (controlled rows
    only) from one, recording every batch at the engine's device seam;
    the launch counts are set to 0 before and read after (every kernel of
    the path must launch). Each recorded batch must equal the offline call
    on the same padded bucket batch: tokens and tags exactly, scores within
    rtol 1e-6 (the same kernels on the same operands), launches equal."""
    import collections

    import torch

    from controllable_xgating_torch.infer import graphs
    from controllable_xgating_torch.ops import kernels
    from controllable_xgating_torch.ops.precision import precision

    orig, calls = eng._fn, []
    # the parameters of the device a block ran on (a mesh engine's copies)
    params_on = (lambda d: params[d]) if isinstance(params, dict) else (lambda d: params)
    ledger = graphs.LaunchLedger()

    def recording(params_, *inputs):
        before = ledger.read()
        out = orig(params_, *inputs)
        calls.append(([None if x is None else x.clone() for x in inputs], out.clone(), ledger.since(before)))
        return out

    eng._fn = recording
    kernels.reset_launch_counts()
    for f in submit_from_threads(eng, reqs):
        f.result(timeout=300)
    for f in submit_from_threads(eng, controlled, threads=1):
        f.result(timeout=300)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    eng._fn = orig
    if not all(counts[n] for n in SERVE_PATH):
        fail(f"serve [{policy}]: a kernel of the path never launched: {counts}")
    if not bool(calls[-1][0][4].all()):
        fail(f"serve [{policy}]: the last batch was not the controlled-only one")
    nb, lp = cfg.eval.max_decode_len, cfg.model.max_pos_len
    per_batch, err = collections.Counter(), 0.0
    for inputs, packed, launches in calls:
        before = ledger.read()
        with precision(policy):
            toks, tags, scores = serve_offline(params_on(inputs[0].device), cfg, inputs)
        torch.cuda.synchronize()
        want = ledger.since(before)
        got_scores = packed[:, -1].view(torch.float32)
        err = max(err, (got_scores - scores).abs().max().item())
        if not (torch.equal(packed[:, :nb], toks) and torch.equal(packed[:, nb:nb + lp], tags)
                and torch.allclose(got_scores, scores, rtol=1e-6, atol=0.0)):
            fail(f"serve [{policy}]: a served batch of {inputs[0].shape[0]} differs from the "
                 "offline call on the same bucket batch")
        if launches != want or launches.get("xgate") != 1:
            fail(f"serve [{policy}]: launches per batch {launches}, offline call {want}")
        per_batch[(inputs[0].shape[0], tuple(sorted(launches.items())))] += 1
    if not calls[-1][2].get("pos_lstm"):
        fail(f"serve [{policy}]: the controlled-only batch did not roll the POS generator")
    print(f"serve equality [{policy}]: {len(reqs)} requests from 4 threads and {len(controlled)} "
          f"controlled from one in {len(calls)} batches; tokens and tags equal the offline call on "
          f"each bucket batch, scores max |d| {err:.3e}; launches per batch equal the offline "
          f"call's, (bucket, launches): batches {dict(per_batch)}; path launches {counts}; {CARD}")
    return {"batches": len(calls), "launches": counts, "score_err": err}


def gated_groups(eng, groups: list):
    """Serve `groups` (lists of requests, one bucket each) so that each
    group's batch reaches the device while the previous batch's completion
    waits on its event: the device seam holds batch i until group i + 1 is
    queued, and a device sleep of ~0.3 s after each batch delays its
    event. Returns (results per group, [captured keys while the previous
    batch's event was pending] per batch)."""
    import threading

    import torch

    from controllable_xgating_torch.infer import graphs

    orig = eng._fn
    entered, go = threading.Semaphore(0), [threading.Event() for _ in groups]
    state, overlap = {"i": 0, "prev": None}, []

    def gated(*a):
        i = state["i"]
        state["i"] += 1
        entered.release()
        if not go[i].wait(300):
            raise RuntimeError("serve: the gate never opened")
        pending = state["prev"] is not None and not state["prev"].query()
        n = len(graphs.cache_info())
        out = orig(*a)
        overlap.append(pending and len(graphs.cache_info()) > n)
        torch.cuda._sleep(SLEEP_CYCLES)
        state["prev"] = torch.cuda.Event()
        state["prev"].record()
        return out

    eng._fn = gated
    try:
        futs = [[eng.submit(**r) for r in groups[0]]]
        if not entered.acquire(timeout=300):
            fail("serve: the first batch never reached the device seam")
        for i in range(1, len(groups)):
            futs.append([eng.submit(**r) for r in groups[i]])  # queued behind batch i - 1
            go[i - 1].set()
            if not entered.acquire(timeout=300):
                fail(f"serve: batch {i} never reached the device seam")
        go[-1].set()
        return [[f.result(timeout=300) for f in fs] for fs in futs], overlap
    finally:
        for g in go:
            g.set()
        eng._fn = orig


def closed_loop(port: int, eng, spans: list, vids: list, clients: int, seconds: float,
                seed: int) -> dict:
    """`clients` threads, each on its own keep-alive connection, POST
    /caption by video id for `seconds`: requests/s, p50 / p99 latency
    (client side), occupancy and batches per bucket (the engine's), the
    device's event span share of the window and the idle gaps between
    batches (CUDA events around each batch at the device seam, appended
    to `spans` by the seam), and the interpreter's garbage collections in
    the window (count by generation, the longest pause: a collection
    holds the GIL, so every thread waits it out)."""
    import collections
    import gc
    import http.client
    import random
    import threading

    import numpy as np
    import torch

    lat, errors, lock = [], [], threading.Lock()
    n0 = (eng._n_requests, eng._n_padded_rows, eng._n_batches)
    spans.clear()
    stop = time.perf_counter() + seconds

    def client(k):
        rng = random.Random(seed + k)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        mine = []
        try:
            while time.perf_counter() < stop:
                body = json.dumps({"video": rng.choice(vids)}).encode()
                t = time.perf_counter()
                conn.request("POST", "/caption", body=body,
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                data = resp.read()
                if resp.status != 200:
                    raise RuntimeError(f"HTTP {resp.status}: {data[:200]!r}")
                mine.append(time.perf_counter() - t)
        except Exception as e:  # noqa: BLE001 — reported below, fatal
            with lock:
                errors.append(repr(e))
        finally:
            conn.close()
            with lock:
                lat.extend(mine)

    pauses, gc_start = [], {}

    def on_gc(phase, info):
        if phase == "start":
            gc_start["t"] = time.perf_counter()
        elif "t" in gc_start:
            pauses.append((info["generation"], (time.perf_counter() - gc_start.pop("t")) * 1e3))

    ts = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
    gc.callbacks.append(on_gc)
    t0 = time.perf_counter()
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(seconds + 300)
    finally:
        wall = time.perf_counter() - t0
        gc.callbacks.remove(on_gc)
    if errors or any(t.is_alive() for t in ts):
        fail(f"serve closed loop ({clients} clients): {errors[:3]}")
    torch.cuda.synchronize()
    req = eng._n_requests - n0[0]
    pad = eng._n_padded_rows - n0[1]
    window = list(spans)
    dev_ms = sum(s.elapsed_time(e) for _, s, e in window)
    gaps = [window[i][2].elapsed_time(window[i + 1][1]) for i in range(len(window) - 1)]
    lat_ms = np.sort(np.array(lat)) * 1e3
    return {
        "clients": clients, "seconds": wall, "requests": len(lat), "requests_s": len(lat) / wall,
        "p50_ms": float(lat_ms[int(0.50 * (len(lat_ms) - 1))]),
        "p99_ms": float(lat_ms[int(0.99 * (len(lat_ms) - 1))]),
        "batches": eng._n_batches - n0[2], "occupancy": req / (req + pad) if req else None,
        "batches_by_bucket": dict(sorted(collections.Counter(b for b, _, _ in window).items())),
        "span_share": dev_ms / (wall * 1e3),
        "idle_gap_ms_max": max(gaps) if gaps else None,
        "idle_gap_ms_median": float(np.median(gaps)) if gaps else None,
        "gc_by_generation": dict(sorted(collections.Counter(g for g, _ in pauses).items())),
        "gc_pause_ms_max": max((ms for _, ms in pauses), default=0.0),
    }


def bucket_costs(eng, videos: list) -> dict:
    """Per bucket, with no other load, the first videos of `videos`: the
    wall of one batch through the engine's device call (staging, the
    library calls, the packed transfer), free-run and with one controlled
    row (the teacher-forced pass), and of the offline library call
    (`make_beam_caption_fn`, kernels on), each synchronised, medians of 5
    in turns; the free-run batch's device ms (one call profiled,
    `call_device_ms`: the profiler's where it sees the port's kernels,
    else the CUDA-event span). bf16, the engine's scope."""
    import numpy as np
    import torch

    from controllable_xgating_torch.ops.precision import precision
    from controllable_xgating_torch.utils.profiling import call_device_ms

    m, out = eng.cfg.model, {}
    for b in eng.buckets:
        rows = videos[:b]
        x = (np.stack([r["app"] for r in rows]), np.stack([r["motion"] for r in rows]),
             (np.arange(T)[None] < np.array([r["nframes"] for r in rows])[:, None]).astype(
                 np.float32), np.zeros((b, m.max_pos_len), np.int64), np.zeros(b, bool))
        x[4][0] = True  # one controlled row: the teacher-forced pass runs
        offline_fn = caption_fn(True, None)
        dx = [torch.as_tensor(a, device=eng._device) for a in x[:3]]

        def offline():
            with precision(eng._dtype):
                offline_fn(eng.params, *dx)
            torch.cuda.synchronize()

        calls = {"served": lambda: eng._device_batch(*x[:3]),
                 "served_controlled": lambda: eng._device_batch(*x), "offline": offline}
        walls = {name: [] for name in calls}
        for fn in calls.values():
            fn()
            torch.cuda.synchronize()
        for i in range(5):
            for name, fn in calls.items():
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls[name].append((time.perf_counter() - t) * 1e3)
        d = call_device_ms(lambda: (calls["served"](), torch.cuda.synchronize()))
        out[b] = {**{f"{n}_wall_ms": float(np.median(w)) for n, w in walls.items()},
                  "device_ms": d["profiler"] if d["kernels_seen"] else d["events"],
                  "device_from": "profiler" if d["kernels_seen"] else "events"}
    return out


def open_loop(eng, feats: list, rate: float, seconds: float, seed: int) -> dict:
    """Poisson arrivals at `rate` per second for `seconds`, each a
    `submit(..., deadline_ms=DEADLINE_MS)` on the engine (not through HTTP,
    so that the offered rate is the one asked for): goodput (results within
    the deadline per second), late completions, predictive and queue-head
    sheds (the engine's counters over the run)."""
    import random
    import threading

    import numpy as np

    from controllable_xgating_torch.serve.engine import DeadlineExceeded

    rng = random.Random(seed)
    s0 = eng.stats()
    done, lock = [], threading.Lock()

    def record(fut):
        if fut.cancelled() or fut.exception() is not None:
            return
        with lock:
            done.append(fut.result().latency_ms)

    futs, t0 = [], time.perf_counter()
    t_next = t0
    while t_next - t0 < seconds:
        t_next += rng.expovariate(rate)
        delay = t_next - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        f = eng.submit(**feats[rng.randrange(len(feats))], deadline_ms=DEADLINE_MS)
        f.add_done_callback(record)
        futs.append(f)
    offered_s = time.perf_counter() - t0
    for f in futs:
        try:
            f.result(timeout=300)
        except DeadlineExceeded:  # shed: counted by the engine
            pass
    wall = time.perf_counter() - t0
    s1 = eng.stats()
    lat = np.sort(np.array(done))
    good = int((lat <= DEADLINE_MS).sum())
    return {
        "offered_s": rate, "submitted": len(futs), "submit_rate_s": len(futs) / offered_s,
        "wall_s": wall, "completed": len(done), "goodput_s": good / wall,
        "late": s1["late_completions"] - s0["late_completions"],
        "shed_predicted": s1["deadline_shed_predicted"] - s0["deadline_shed_predicted"],
        "expired": s1["deadline_expired"] - s0["deadline_expired"],
        "p50_ms": float(lat[int(0.5 * (len(lat) - 1))]) if len(lat) else None,
        "p99_ms": float(lat[int(0.99 * (len(lat) - 1))]) if len(lat) else None,
        "shed_margin_live": s1["shed_margin_live"],
    }


def serve_phase(params, cfg, store, info, dev) -> dict:
    """The serving path (`serve/engine.py`, `serve/server.py`) at MSR-VTT
    width, beam 5, buckets (1, 4, 16, 64):
      1. K1-K4 against their plain versions at bucket 1's and 4's shapes;
      2. an engine per policy, warmed (capture s and pool MiB per key);
      3. under f32 and bf16, 64 seeded requests from 4 threads (a quarter
         controlled, ragged frame counts) and 4 controlled ones: every
         batch equal to the offline call on the same bucket batch, with
         its launches; under f32 the 256 videos served against the
         256-video offline call (>= 98% of the captions equal);
      4. one batch per bucket through the warmed bf16 engine, then through
         an engine without warm-up whose captures run while the previous
         batch's completion waits on its event: the same results;
      5. that engine behind `serve/server.py`: closed loops of 8 and 64
         clients by video id;
      6. an open loop at OVERLOAD x the 64-client rate with deadlines.
    Returns the printed numbers."""
    import threading

    import numpy as np
    import torch

    from controllable_xgating_torch.data.vocab import Vocab
    from controllable_xgating_torch.infer import graphs
    from controllable_xgating_torch.ops.precision import precision
    from controllable_xgating_torch.serve.engine import ServingEngine
    from controllable_xgating_torch.serve.server import serve

    t_phase = time.perf_counter()
    out = {"kernels": check_serve_kernels(params, dev)}
    tags = [f"t{i}" for i in range(POS_VOCAB - 4)]
    pos_vocab = Vocab(tags)
    idx = np.arange(B)
    app, mot = store.get_batch(idx)
    counts = store.counts
    videos = [{"app": app[i], "motion": mot[i], "nframes": int(counts[i])} for i in idx]

    def engine(policy):
        graphs.clear()  # the cache holds this engine's keys only
        with precision(policy):
            t = time.perf_counter()
            eng = ServingEngine(params, cfg, info.vocab, pos_vocab, mode="beam",
                                buckets=SERVE_BUCKETS)
            eng.warmup()
            wall = time.perf_counter() - t
        keys = [{"kind": e["kind"], "capture_s": round(e["capture_s"], 3),
                 "pool_mib": round(e["pool_bytes"] / 2 ** 20, 1)} for e in graphs.cache_info()]
        print(f"serve warmup [{policy}]: {wall:.2f} s for buckets {SERVE_BUCKETS}; keys {keys}; "
              f"{CARD}")
        out[f"warmup_{policy}"] = {"s": wall, "keys": keys}
        return eng

    reqs = serve_requests(cfg, 64, seed=11, tags=tags)
    controlled = [dict(r, pos_tags=tags[:6]) for r in serve_requests(cfg, 4, seed=12, tags=tags)]
    groups, start = [], 0
    ladder = serve_requests(cfg, sum(SERVE_BUCKETS), seed=13, tags=tags)
    for b in SERVE_BUCKETS:
        groups.append(ladder[start:start + b])
        start += b

    eng = engine("float32")
    try:
        out["equal_float32"] = check_served_batches(eng, params, cfg, "float32", reqs, controlled)
        served = [f.result(timeout=300) for f in submit_from_threads(eng, videos)]
    finally:
        eng.close()
    with precision("float32"):
        toks = caption_fn(True, None)(params, *(torch.as_tensor(x, device=dev) for x in (
            app, mot, store.frame_mask(idx))))[0].cpu().numpy()
    agree = float(np.mean([r.caption == info.vocab.decode_str(t) for r, t in zip(served, toks)]))
    print(f"serve agreement [float32]: {agree:.4f} of the {B} videos served in buckets of up to "
          f"{SERVE_BUCKETS[-1]} caption as the {B}-video offline call; {CARD}")
    if agree < AGREE_MIN:
        fail(f"serve f32 agreement with the {B}-video call {agree:.4f} < {AGREE_MIN}")
    out["agreement_float32"] = agree

    eng = engine("bfloat16")
    try:
        out["equal_bfloat16"] = check_served_batches(eng, params, cfg, "bfloat16", reqs, controlled)
        want, _ = gated_groups(eng, groups)
    finally:
        eng.close()
    graphs.clear()
    with precision("bfloat16"):
        eng = ServingEngine(params, cfg, info.vocab, pos_vocab, mode="beam", buckets=SERVE_BUCKETS)
    try:
        got, overlap = gated_groups(eng, groups)
        same = all((a.caption, a.pos_sequence, a.score, a.batch_size)
                   == (b.caption, b.pos_sequence, b.score, b.batch_size)
                   for ga, gb in zip(got, want) for a, b in zip(ga, gb))
        print(f"serve no warm-up [bfloat16]: one batch per bucket {SERVE_BUCKETS}, keys captured "
              f"while the previous batch's event was pending: {overlap}; results equal the warmed "
              f"engine's: {same}; keys {len(graphs.cache_info())}; {CARD}")
        if not same:
            fail("serve: the engine without warm-up served other results than the warmed one")
        if overlap[1:] != [True] * (len(SERVE_BUCKETS) - 1):
            fail(f"serve: no capture overlapped a pending batch ({overlap}): hazard not exercised")
        out["no_warmup"] = {"overlap": overlap, "equal": same}

        # steps 5 and 6 on this engine, now holding every bucket's keys
        spans = []
        orig = eng._fn

        def timed(*a):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            res = orig(*a)
            e.record()
            spans.append((a[1].shape[0], s, e))
            return res

        eng._fn = timed
        httpd = serve(eng, "127.0.0.1", 0, store=store, video_ids=list(info.video_ids))
        server = threading.Thread(target=httpd.serve_forever, daemon=True)
        server.start()
        try:
            vids = list(info.video_ids)
            for clients in (8, 64):
                out[f"closed_{clients}"] = closed_loop(httpd.server_address[1], eng, spans, vids,
                                                       clients, CLOSED_S, seed=clients)
        finally:
            httpd.shutdown()
            httpd.server_close()
            server.join(60)
        eng._fn = orig
        costs = out["bucket_costs"] = bucket_costs(eng, videos)
        for b, c in costs.items():
            print(f"serve bucket {b} [bfloat16, beam 5, no other load, {CARD}]: wall "
                  f"{c['served_wall_ms']:.2f} ms through the engine's device call (free-run "
                  f"rows), {c['served_controlled_wall_ms']:.2f} ms with a controlled row, "
                  f"offline call {c['offline_wall_ms']:.2f} ms (medians of 5 in turns); device "
                  f"{c['device_ms']:.2f} ms ({c['device_from']})")
        for clients in (8, 64):
            r = out[f"closed_{clients}"]
            r["busy"] = sum(n * costs[b]["device_ms"] for b, n in
                            r["batches_by_bucket"].items()) / (r["seconds"] * 1e3)
            print(f"serve closed loop [bfloat16, beam 5, {clients} clients, "
                  f"{r['seconds']:.1f} s, {CARD}]: {r['requests_s']:.1f} requests/s, p50 "
                  f"{r['p50_ms']:.2f} ms, p99 {r['p99_ms']:.2f} ms, occupancy "
                  f"{r['occupancy']:.3f}, batches by bucket {r['batches_by_bucket']}, device "
                  f"busy {r['busy']:.3f} (batches x their bucket's device ms / wall), event "
                  f"span share {r['span_share']:.3f}, idle gap between batches max "
                  f"{r['idle_gap_ms_max']:.2f} ms, median {r['idle_gap_ms_median']:.2f} ms; "
                  f"garbage collections {r['gc_by_generation']}, longest "
                  f"{r['gc_pause_ms_max']:.2f} ms")
        rate = OVERLOAD * out["closed_64"]["requests_s"]
        r = out["open"] = open_loop(eng, videos, rate, OPEN_S, seed=7)
        print(f"serve open loop [bfloat16, beam 5, deadline {DEADLINE_MS:.0f} ms, shed_margin "
              f"1.3, {CARD}]: offered {rate:.1f} requests/s ({OVERLOAD} x the 64-client rate), "
              f"submitted {r['submit_rate_s']:.1f}/s, goodput {r['goodput_s']:.1f}/s, completed "
              f"{r['completed']} of {r['submitted']}, late {r['late']}, predictive sheds "
              f"{r['shed_predicted']}, expired {r['expired']}, p50 {r['p50_ms']} ms, p99 "
              f"{r['p99_ms']} ms")
    finally:
        eng.close()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"serve phase: {out['phase_s']:.1f} s; {CARD}")
    return out


# the port's own user path on a corpus it makes (examples/full_pipeline.sh)
STUDY_PREPRO = ["--fixtures", "--fixture_videos", "600", "--fixture_frames", "26",
                "--fixture_app_dim", "1536", "--fixture_motion_dim", "1024",
                "--max_caption_len", "20", "--seqs_per_video", "8"]
STUDY_COMMON = ["--compute_dtype", "bfloat16", "--model.hidden_dim", "512",
                "--model.embed_dim", "512", "--model.attn_dim", "512",
                "--model.pos_embed_dim", "512", "--model.num_frames", "26",
                "--data.batch_size", "64", "--data.caps_per_video_train", "4",
                "--train.lr_decay_every_epochs", "40", "--train.log_every_steps", "1",
                "--eval.max_decode_len", "20"]
STUDY_RECIPE = {"pos": 8, "caption": 40}  # the flagship recipe's epochs
STUDY_EPOCHS = {"pos": 4, "caption": 16}  # cut for the script's time limit
STUDY_LR = {"pos": "1e-3", "caption": "2e-3"}
STUDY_TEMPLATES = "EX VBZ DT NN VBG NN;DT NN VBZ NN"
STUDY_TAGS = "DT NN VBZ VBG IN DT NN"
STUDY_VIDEO = "video590"  # a test video of the 600
# the study's corpus, checkpoints and beam-5 captions, kept for the tools phase
STUDY_ROOT = os.path.join(HERE, "build", "chip_smoke_study")


def caption_lengths(tokens) -> list:
    """Words per caption: the tokens before the first EOS (or all)."""
    import numpy as np

    from controllable_xgating_torch.data.vocab import EOS

    t = np.asarray(tokens.cpu())
    ends = np.where((t == EOS).any(1), (t == EOS).argmax(1), t.shape[1])
    return ends.tolist()


def study_phase(dev) -> dict:
    """The port's own user path on a corpus it makes, in a directory of its
    own: `cli.prepro --fixtures` (the flagship recipe's 600 videos at
    MSR-VTT width), `cli.train --stage pos` then `--stage caption` from it
    (bf16, the recipe's widths and epochs), `cli.eval --beam_size 5` on
    the test split; on the trained checkpoint the kernels against the
    plain path under f32 for beam 5 and greedy, free and under a template
    (>= 98% of the test videos each), and the beam-5 call through
    `kernel_plain_diff` (f32: tokens equal, floats within F32_TOL); the
    early exit, graphed against
    eager (tokens equal; wall, device ms, busy share, chunks replayed,
    caption length); the int8 projection (K7) against bf16 (printed);
    `tools.controllability_eval` with two templates and `cli.caption` of
    one video free and with tags; `cli.score --per_video --bootstrap 200`
    on the eval's captions. Returns the phase's numbers."""
    import shutil

    import numpy as np
    import torch

    from controllable_xgating_torch.cli import caption as cli_caption
    from controllable_xgating_torch.cli import eval as cli_eval
    from controllable_xgating_torch.cli import prepro as cli_prepro
    from controllable_xgating_torch.cli import score as cli_score
    from controllable_xgating_torch.cli import train as cli_train
    from controllable_xgating_torch.cli.common import load_corpus, restore_params
    from controllable_xgating_torch.data.vocab import pad_encode
    from controllable_xgating_torch.experiments.int8_vocab_matmul import quantize_vocab_proj
    from controllable_xgating_torch.infer.beam import beam_search
    from controllable_xgating_torch.infer.greedy import greedy_decode
    from controllable_xgating_torch.models.captioner import encode_for_inference
    from controllable_xgating_torch.ops import kernels
    from controllable_xgating_torch.ops.dispatch import set_decode_graphs
    from controllable_xgating_torch.ops.precision import precision
    from controllable_xgating_torch.tools import controllability_eval
    from controllable_xgating_torch.utils.debug import kernel_plain_diff
    from controllable_xgating_torch.utils.config import load_config
    from controllable_xgating_torch.utils.profiling import call_device_ms

    root = STUDY_ROOT
    shutil.rmtree(root, ignore_errors=True)
    data, ck = os.path.join(root, "corpus"), os.path.join(root, "ck")
    counts, out = {}, {}

    # 1. the corpus, made by the port
    text, dt = counted_cli("study prepro", cli_prepro.main, ["--out", data, *STUDY_PREPRO], counts)
    made = json.loads(text.strip().splitlines()[-1])
    out["prepro_s"] = dt
    print(f"study prepro [{' '.join(STUDY_PREPRO)}]: {dt:.2f} s; vocab {made['vocab_size']}, POS "
          f"vocab {made['pos_vocab_size']}, splits {json.dumps(made['splits'])}")
    if any(counts["study prepro"].values()):
        fail(f"study prepro launched kernels: {counts['study prepro']}")
    n_train = made["splits"]["train"]

    # 2. training: the POS stage, then the caption stage from it. The val
    # eval launches K1-K3; K5 does not: the corpus's vocabulary is below its
    # V >= 2048 gate (`train/xe.py`, as the reference's)
    common = ["--data_dir", data, *STUDY_COMMON]
    init = []
    for stage in ("pos", "caption"):
        epochs = STUDY_EPOCHS[stage]
        _, dt = counted_cli(
            f"study train-{stage}", cli_train.main,
            ["--checkpoint_dir", ck, "--stage", stage, "--epochs", str(epochs), *init,
             "--train.lr", STUDY_LR[stage], *common],
            counts, CLI_CAPTION_KERNELS, ("topk_tail", "xent_fwd", "xent_bwd"))
        with open(os.path.join(ck, stage, "train_log.jsonl")) as f:
            log = [json.loads(line) for line in f]
        by_epoch = {}
        for e in log:
            if "loss" in e:
                by_epoch.setdefault(e["epoch"], []).append(e["loss"])
        first, last = (float(np.mean(by_epoch[e])) for e in (min(by_epoch), max(by_epoch)))
        val = [{k[4:]: v for k, v in e.items() if k.startswith("val_")} for e in log
               if "val_CIDEr" in e]
        rate = n_train * epochs / dt
        out[f"train_{stage}"] = {"epochs": epochs, "wall_s": dt, "videos_s": rate,
                                 "loss_first_epoch": first, "loss_last_epoch": last,
                                 "val_last": val[-1] if val else None}
        print(f"study train --stage {stage} [{epochs} epochs of {n_train} videos, "
              f"{' '.join(STUDY_COMMON)}, {CARD}]: {rate:.1f} train videos/s over the whole command "
              f"({dt:.1f} s, a greedy val eval of {made['splits']['val']} each epoch); loss, "
              f"first epoch {first:.4f}, last {last:.4f}; last val {json.dumps(val[-1])}")
        if not (math.isfinite(last) and last < first):
            fail(f"study train --stage {stage}: the loss did not fall ({first} -> {last})")
        init = ["--init_from", os.path.join(ck, stage)]
    print("study reduced: " + ", ".join(f"{stage} stage {STUDY_EPOCHS[stage]} of the recipe's "
                                        f"{STUDY_RECIPE[stage]} epochs" for stage in STUDY_EPOCHS))
    best = os.path.join(ck, "caption")

    # 3. eval beam 5 on the test split through the CLI
    n_test = made["splits"]["test"]
    eval_json = os.path.join(root, "eval_test.json")
    _, dt = counted_cli("study eval-beam-5", cli_eval.main,
                        ["--checkpoint_dir", best, "--split", "test", "--beam_size", "5",
                         "--out", eval_json, *common],
                        counts, (*CLI_CAPTION_KERNELS, "topk_tail"))
    with open(eval_json) as f:
        res = json.load(f)
    if len(res["captions"]) != n_test or not all(math.isfinite(v) for v in res["metrics"].values()):
        fail(f"study eval-beam-5: {len(res['captions'])} captions, metrics {res['metrics']}")
    out["eval"] = {"captions_s": n_test / dt, "metrics": res["metrics"]}
    print(f"study eval [beam 5, {n_test} test videos, bf16, {CARD}]: {n_test / dt:.2f} "
          f"captions/s over the whole command ({dt:.2f} s); metrics {json.dumps(res['metrics'])}")

    # the trained checkpoint in this process, with its test split
    cfg = load_config(None, {k[2:]: v for k, v in zip(STUDY_COMMON[::2], STUDY_COMMON[1::2])
                             if "." in k})
    info, _, store, cfg = load_corpus(data, cfg)
    idx, steps = np.asarray(info.splits["test"]), cfg.eval.max_decode_len
    app, mot = (torch.as_tensor(x, device=dev) for x in store.get_batch(idx))
    mask = torch.as_tensor(store.frame_mask(idx), device=dev)
    tmpl = torch.as_tensor(np.array([pad_encode(info.pos_vocab, STUDY_TAGS.split(),
                                                cfg.model.max_pos_len)] * len(idx)), device=dev)

    def decode(params, beam, fused, tags=None, vq=None):
        with torch.inference_mode():
            ctx, summary, _ = encode_for_inference(
                params, app, mot, mask, pos_tags=tags, max_pos_len=cfg.model.max_pos_len,
                fused=fused, early_stop=True)
            if beam:
                return beam_search(params.decoder, ctx, summary, K, steps, fused=fused,
                                   early_stop=True, vocab_q=vq)[0]
            return greedy_decode(params.decoder, ctx, summary, steps, fused=fused,
                                 early_stop=True, vocab_q=vq)

    # kernels against the plain path on trained weights, f32
    agree = {}
    with precision("float32"):
        params = restore_params(best, cfg, dev)
        for beam, name in ((True, "beam-5"), (False, "greedy")):
            for tags, how in ((None, "free"), (tmpl, "controlled")):
                a, b = decode(params, beam, True, tags), decode(params, beam, False, tags)
                agree[f"{name} {how}"] = (a == b).all(1).float().mean().item()
    out["agreement_f32"] = agree
    print(f"study kernels vs plain [float32, trained weights, {n_test} test videos; controlled: "
          f"\"{STUDY_TAGS}\"]: caption agreement {json.dumps(agree)}")
    low = {k: v for k, v in agree.items() if v < AGREE_MIN}
    if low:
        fail(f"study: f32 caption agreement below {AGREE_MIN}: {low}")

    # the beam-5 call through kernel_plain_diff (`utils/debug.py`): the
    # kernels and the graphs against the plain eager path, f32
    def beam_call(p):
        with torch.inference_mode():
            ctx, summary, _ = encode_for_inference(p, app, mot, mask,
                                                   max_pos_len=cfg.model.max_pos_len,
                                                   early_stop=True)
            return beam_search(p.decoder, ctx, summary, K, steps, early_stop=True)

    with precision("float32"):
        try:
            diffs = kernel_plain_diff(beam_call, restore_params(best, cfg, dev), **F32_TOL)
        except AssertionError as e:
            fail(f"study kernel_plain_diff beam-5 [f32, trained weights]: {e}")
    out["kernel_plain_diff"] = diffs
    print(f"study kernel_plain_diff beam-5 [f32, trained weights, {n_test} test videos, {CARD}]: "
          f"tokens equal, largest difference per output {json.dumps(diffs)} (bound rtol "
          f"{F32_TOL['rtol']}, atol {F32_TOL['atol']})")

    # 4. the early exit: graphed against eager, bf16, kernels on
    def run(fn, on: bool):
        set_decode_graphs(None if on else False)
        try:
            tokens = fn()
        finally:
            set_decode_graphs(None)
        torch.cuda.synchronize()
        return tokens

    with precision("bfloat16"):
        params = restore_params(best, cfg, dev)
        exits = {}
        for beam, name in ((True, "beam-5"), (False, "greedy")):
            fn = lambda: decode(params, beam, True)
            eager = run(fn, False)
            graphed, chunks = chunk_counts(lambda: run(fn, True))
            if not torch.equal(eager, graphed):
                fail(f"study early exit {name}: graphed tokens differ from the eager loop's")
            walls = {"graphed": [], "eager": []}
            for i in range(5):
                for on in ((True, False) if i % 2 == 0 else (False, True)):
                    t = time.perf_counter()
                    run(fn, on)
                    walls["graphed" if on else "eager"].append((time.perf_counter() - t) * 1e3)
            lengths = caption_lengths(graphed)
            row = {"chunks": chunks, "mean_words": float(np.mean(lengths)),
                   "max_words": int(max(lengths))}
            for key, on in (("graphed", True), ("eager", False)):
                d = call_device_ms(lambda: run(fn, on))
                wall = float(np.median(walls[key]))
                dev_ms = d["profiler"] if d["kernels_seen"] else d["events"]
                row[key] = {"wall_ms": wall, "walls_ms": walls[key], "device_ms": dev_ms,
                            "device_from": "profiler" if d["kernels_seen"] else "events",
                            "busy": dev_ms / wall, "captions_s": len(idx) / wall * 1e3}
            exits[name] = row
            g, e = row["graphed"], row["eager"]
            print(f"study early exit {name} [bf16, {len(idx)} test videos, max {steps} steps, "
                  f"{CARD}]: tokens equal graphed and eager; wall {g['wall_ms']:.2f} ms graphed "
                  f"vs {e['wall_ms']:.2f} eager (median of 5 in turns); device "
                  f"{g['device_ms']:.2f} vs {e['device_ms']:.2f} ms ({g['device_from']}); busy "
                  f"{g['busy']:.3f} vs {e['busy']:.3f}; {replayed(chunks)}; "
                  f"words per caption mean {row['mean_words']:.2f}, "
                  f"max {row['max_words']}")
        out["early_exit"] = exits

        # 5. the int8 projection (K7) on trained weights against bf16
        vq = quantize_vocab_proj(params.decoder.w_out, params.decoder.b_out)
        k7 = {}
        for beam, name in ((False, "greedy"), (True, "beam-5")):
            kernels.reset_launch_counts()
            q = decode(params, beam, True, vq=vq)
            torch.cuda.synchronize()
            n7 = kernels.launch_counts()["int8_vocab"]
            if not n7:
                fail(f"study int8 {name}: int8_vocab never launched")
            k7[name] = {"agreement": (q == decode(params, beam, True)).all(1).float().mean().item(),
                        "int8_vocab_launches": n7}
        out["int8_vs_bf16"] = k7
        print(f"study int8 projection (K7) vs bf16 [trained weights, {len(idx)} test videos, not "
              f"gated]: {json.dumps(k7)}")

    # 6. controllability: the study tool, then one video free and with tags
    ctrl_out, dt = counted_cli(
        "study controllability", controllability_eval.main,
        ["--data_dir", data, "--checkpoint_dir", best, "--templates", STUDY_TEMPLATES,
         *STUDY_COMMON], counts, CLI_CAPTION_KERNELS, ("topk_tail",))
    ctrl = json.loads(ctrl_out)
    study = {r["template"]: r["agreement_by_mode"] for r in ctrl["per_template"]}
    out["controllability"] = {"per_template": study, "wall_s": dt,
                              "mean_free": ctrl["mean_free_run_tag_agreement"],
                              "mean_controlled": ctrl["mean_controlled_tag_agreement"]}
    print(f"study controllability [{n_test} test videos, greedy, bf16, {dt:.2f} s]: per template "
          f"(free-run / controlled tag agreement, both modes) {json.dumps(study)}; means "
          f"{ctrl['mean_free_run_tag_agreement']} / {ctrl['mean_controlled_tag_agreement']}; "
          f"examples {json.dumps(ctrl['per_template'][0]['examples'][:2])}")
    cap = ["--data_dir", data, "--checkpoint_dir", best, "--video", STUDY_VIDEO, *STUDY_COMMON]
    lines = {}
    for how, extra, want, absent in (("free", [], CLI_CAPTION_KERNELS, ("topk_tail",)),
                                     ("tags", ["--pos_tags", STUDY_TAGS], ("xgate", "attn_lstm"),
                                      ("pos_lstm", "topk_tail"))):
        text, _ = counted_cli(f"study caption-{how}", cli_caption.main, cap + extra, counts,
                              want, absent)
        lines[how] = json.loads(text.strip().splitlines()[-1])
    if lines["tags"]["pos_sequence"] != STUDY_TAGS or not lines["tags"]["controlled"]:
        fail(f"study caption --pos_tags: {lines['tags']}")
    out["caption"] = {STUDY_VIDEO: lines}
    print(f"study caption {STUDY_VIDEO}: free {json.dumps(lines['free'])}; --pos_tags "
          f"\"{STUDY_TAGS}\": {json.dumps(lines['tags'])}")

    # 7. the scorer on the eval's captions, with its bootstrap
    per_video = os.path.join(root, "per_video.json")
    text, dt = counted_cli("study score", cli_score.main,
                           ["--candidates", eval_json, "--data_dir", data, "--split", "test",
                            "--per_video", per_video, "--bootstrap", "200"], counts)
    scored = json.loads(text)
    with open(per_video) as f:
        n_per = len(json.load(f))
    if scored["n_scored"] != n_test or n_per != n_test or any(counts["study score"].values()):
        fail(f"study score: {scored['n_scored']} scored, {n_per} per-video rows, launches "
             f"{counts['study score']}")
    for m, v in scored["metrics"].items():
        if m in res["metrics"] and not math.isclose(v, res["metrics"][m], rel_tol=1e-9):
            fail(f"study score: {m} {v} differs from the eval's {res['metrics'][m]}")
    out["score"] = {"wall_s": dt, "ci95": scored["bootstrap"]["ci95"]}
    print(f"study score [--per_video --bootstrap 200, {n_test} videos, host, {dt:.2f} s]: "
          f"metrics {json.dumps(scored['metrics'])}; 95% intervals "
          f"{json.dumps(scored['bootstrap']['ci95'])}")
    out["launches"] = counts  # the directory stays for the tools phase, which removes it
    return out


# the data-parallel phase: XE steps of the train phase's batches, the
# decode mesh's serving buckets
DP_STEPS = 3
DP_BUCKETS = (2, 8)
DP_TRAIN = ("xent_fwd", "xent_bwd")
DP_DECODE = ("xgate", "pos_lstm", "attn_lstm", "topk_tail")


def dp_train_clis(data: str, runs: dict) -> dict:
    """`cli.train --stage joint --epochs 1` under f32 on the CLI corpus at
    `data`, once per entry of `runs` {name: (extra arguments, extra
    environment)}, all at once, each into `<data>/../<name>` ->
    {name: (its output, its `last` checkpoint, its logged steps)}; fails
    where one exits."""
    import torch

    root = os.path.dirname(data)
    cmd = [sys.executable, "-m", "controllable_xgating_torch.cli.train", "--data_dir", data,
           "--config", os.path.join(HERE, "configs", "msrvtt.json"), "--stage", "joint",
           "--epochs", "1", "--compute_dtype", "float32", "--train.log_every_steps", "1"]
    env = dict(os.environ, PYTHONPATH=HERE, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               CXG_TIMEOUT_S="300")
    procs = {name: subprocess.Popen(cmd + ["--checkpoint_dir", os.path.join(root, name), *args],
                                    env=dict(env, **extra), stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name, (args, extra) in runs.items()}
    outs = {}
    try:
        for name, p in procs.items():
            outs[name] = p.communicate(timeout=600)[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    for name, p in procs.items():
        if p.returncode:
            fail(f"dp cli.train [{name}] exited {p.returncode}: {outs[name][-2000:]}")
    got = {}
    for name in runs:
        with open(os.path.join(root, name, "joint", "train_log.jsonl")) as f:
            steps = [json.loads(line) for line in f if '"loss"' in line]
        got[name] = (outs[name], torch.load(os.path.join(root, name, "joint", "last.pt"),
                                            map_location="cpu", weights_only=True), steps)
    return got


def dp_cli_world_one(data: str) -> dict:
    """(a) `dp_train_clis` as one process of a process group of one over
    NCCL (the CXG_* variables) and without a group: their `last`
    parameters must be equal bit for bit (an all-reduce of one rank
    changes nothing)."""
    import torch

    from controllable_xgating_torch.parallel.distributed import free_port

    t = time.perf_counter()
    got = dp_train_clis(data, {
        "nccl1": ([], {"CXG_COORDINATOR": f"127.0.0.1:{free_port()}", "CXG_NUM_PROCESSES": "1",
                       "CXG_PROCESS_ID": "0"}),
        "alone": (["--parallel.num_devices", "1"], {})})
    wall = time.perf_counter() - t
    (out, a, _), (alone_out, b, _) = got["nccl1"], got["alone"]
    a, b = a["params"], b["params"]
    if ("over nccl" not in out or "data-parallel over 1 devices on 1 processes" not in out
            or "joined process group" in alone_out):
        fail(f"dp (a): the NCCL run did not join a group of one: {out[-2000:]}")
    differ = [n for n in b if not torch.equal(a[n], b[n])]
    if differ:
        fail(f"dp (a): world size 1 over NCCL differs from no group in {differ[:5]}")
    print(f"dp (a) cli.train [float32, 1 epoch, 128 videos]: NCCL world size 1 == no process "
          f"group, {len(b)} parameters bit for bit; both runs {wall:.1f} s at once; {CARD}")
    return {"equal_params": len(b), "wall_s": wall}


def dp_cli_cards(data: str, n: int) -> dict:
    """(c) `dp_train_clis` with `--parallel.num_devices n` (the CLI starts
    its n ranks, one per card, over NCCL) against one device: the logged
    losses rtol 1e-5, and Adam's first moments, all parameters as one
    vector, within a relative norm of 1e-5 (the parameters move by ~lr x
    sign after two steps, so a near-cancelling gradient's sum order shows
    there at ~lr; their difference is printed)."""
    import torch

    t = time.perf_counter()
    got = dp_train_clis(data, {"cards": (["--parallel.num_devices", str(n)], {}),
                               "alone": (["--parallel.num_devices", "1"], {})})
    wall = time.perf_counter() - t
    (out, a, la), (_, b, lb) = got["cards"], got["alone"]
    if f"data-parallel over {n} devices on {n} processes" not in out:
        fail(f"dp (c): cli.train did not start {n} ranks: {out[-2000:]}")
    loss_err = max(abs(x["loss"] - y["loss"]) / abs(y["loss"]) for x, y in zip(la, lb))
    moments = lambda ck: torch.cat([v["exp_avg"].flatten() for _, v in
                                    sorted(ck["opt_state"]["state"].items())])
    merr = ((moments(a) - moments(b)).norm() / moments(b).norm()).item()
    pa, pb = a["params"], b["params"]
    worst = max(pb, key=lambda k: float((pa[k] - pb[k]).abs().max()))
    maxd = float((pa[worst] - pb[worst]).abs().max())
    print(f"dp (c) cli.train --parallel.num_devices {n} [float32, 1 epoch, 128 videos, NCCL] vs "
          f"one device: {len(lb)} logged losses, max relative difference {loss_err:.3e}; relative "
          f"norm of the Adam first-moment difference {merr:.3e}; max |param difference| "
          f"{maxd:.3e} ({worst}); both runs {wall:.1f} s at once; {CARD}")
    if len(la) != len(lb) or not lb or loss_err > 1e-5 or merr > 1e-5:
        fail(f"dp (c): {n} cards differ from one device (losses {loss_err:.3e}, moments "
             f"{merr:.3e})")
    return {"loss_err": loss_err, "moment_err": merr, "max_param_diff": maxd, "wall_s": wall}


def dp_rank_steps(cfg, policy: str, timed: int = 0, scst: bool = False) -> dict:
    """`dryrun.train_steps` from `init_captioner(seed=0)` on the train
    phase's first DP_STEPS batches of 64 x 5 (`make_train_corpus(seed=1)`,
    `TrainBatchIterator(seed=0)`), or one SCST step on the first with
    that corpus's references: what each rank of `dp_pair` runs, and its
    one-rank reference. The batches are drawn here from their seeds, so a
    rank's arguments stay small."""
    import numpy as np

    from controllable_xgating_torch.data.loader import TrainBatchIterator
    from controllable_xgating_torch.parallel import dryrun

    store, caps, pos, ncaps = make_train_corpus(cfg, seed=1)
    it = iter(TrainBatchIterator(store, caps, pos, ncaps, np.arange(TRAIN_VIDEOS),
                                 cfg.data.batch_size, cfg.data.caps_per_video_train, seed=0))
    batches = [next(it) for _ in range(1 if scst else DP_STEPS)]
    refs = (caps, ncaps, list(range(TRAIN_VIDEOS))) if scst else None
    return dryrun.train_steps(0, cfg, batches, "joint", "cuda", policy, refs, timed)


def dp_pair(cfg, backend: str, counts: dict, ranks: int = 2, env=None,
            policies=("float32", "bfloat16"), scst: bool = True, tag: str = "") -> dict:
    """(b) / (c): DP_STEPS XE steps as `ranks` ranks over `backend` (with
    `env` in their environment: (b) shows them the first card only)
    against one
    rank on the global batches (`dp_rank_steps`, dropout 0.5): f32 loss
    rtol 1e-5 and parameters rtol 2e-4, atol 1e-5 (the JAX package's bar),
    each rank launching K5 once a step; under bf16 the same, printed, with
    5 timed steps (step ms, the all-reduce ms of the gradients' bytes);
    then, with `scst`, one SCST step: the greedy reward rtol 1e-4. `tag`
    names the configuration in the printed lines."""
    import numpy as np

    from controllable_xgating_torch.parallel import distributed

    out = {}
    backend_tag = backend + tag
    for policy in policies:
        timed = 5 if policy == "bfloat16" else 0
        one = dp_rank_steps(cfg, policy, timed)
        two = distributed.launch(dp_rank_steps, ranks, (cfg, policy, timed), device_type="cuda",
                                 backend=backend, timeout=300, env=env)
        steps = len(one["metrics"])
        loss_err = max(abs(r["metrics"][i]["loss"] - one["metrics"][i]["loss"])
                       / abs(one["metrics"][i]["loss"]) for r in two for i in range(steps))
        perr = max(float(np.max(np.abs(r["params"][n] - one["params"][n])
                                - 2e-4 * np.abs(one["params"][n]))) for r in two
                   for n in one["params"])
        maxd = max(float(np.max(np.abs(r["params"][n] - one["params"][n]))) for r in two
                   for n in one["params"])
        for rank, r in enumerate(two):
            counts[f"dp-train rank {rank} [{backend_tag}, {policy}]"] = r["launches"]
            if any(r["launches"][k] != steps for k in DP_TRAIN):
                fail(f"dp [{backend_tag}, {policy}]: rank {rank} launched K5 {r['launches']} in "
                     f"{steps} steps")
        line = (f"dp xe [{backend_tag}, {policy}, {ranks} ranks on {[r['device'] for r in two]}, "
                f"{steps} steps of 64 x 5, dropout {cfg.model.dropout}] vs 1 rank: max "
                f"relative loss difference {loss_err:.3e}, max |param difference| {maxd:.3e}; "
                f"K5 per rank {[{k: r['launches'][k] for k in DP_TRAIN} for r in two]}")
        if policy == "float32":
            if loss_err > 1e-5 or perr > 1e-5:
                fail(f"{line}: outside loss rtol 1e-5 / params rtol 2e-4, atol 1e-5")
        else:
            bs = cfg.data.batch_size
            out.update({
                "one_step_ms": one["step_ms"], "step_ms": [r["step_ms"] for r in two],
                "allreduce_ms": [r["allreduce_ms"] for r in two], "grad_bytes": two[0]["grad_bytes"],
                "one_videos_s": bs / one["step_ms"] * 1e3,
                "rank_videos_s": [bs / ranks / r["step_ms"] * 1e3 for r in two],
            })
            out["scaling"] = sum(out["rank_videos_s"]) / out["one_videos_s"]
            line += (f"; step ms 1 rank {one['step_ms']:.2f}, 2 ranks {out['step_ms']}, "
                     f"all-reduce ms {out['allreduce_ms']} of {out['grad_bytes']} gradient bytes; "
                     f"videos/s 1 rank {out['one_videos_s']:.1f}, per rank "
                     f"{[round(v, 1) for v in out['rank_videos_s']]} (scaling "
                     f"{out['scaling']:.3f}x)")
        out[f"loss_err_{policy}"], out[f"param_err_{policy}"] = loss_err, maxd
        print(f"{line}; {CARD}")
    if not scst:
        return out
    one = dp_rank_steps(cfg, "float32", scst=True)["metrics"][0]
    two = [r["metrics"][0] for r in distributed.launch(
        dp_rank_steps, ranks, (cfg, "float32", 0, True), device_type="cuda", backend=backend,
        timeout=300, env=env)]
    err = max(abs(r["reward_greedy"] - one["reward_greedy"]) / max(abs(one["reward_greedy"]), 1e-12)
              for r in two)
    print(f"dp scst [{backend}, float32, {ranks} ranks]: reward_greedy {[r['reward_greedy'] for r in two]}"
          f" vs 1 rank {one['reward_greedy']} (relative {err:.3e}); loss "
          f"{[r['loss'] for r in two]}; {CARD}")
    if err > 1e-4 or not all(math.isfinite(r["loss"]) for r in two):
        fail(f"dp scst [{backend}]: reward_greedy relative difference {err:.3e} > 1e-4")
    out["scst_reward_err"] = err
    return out


def dp_mesh(dev):
    import torch

    from controllable_xgating_torch.parallel.mesh import make_mesh

    if torch.cuda.device_count() >= 2:
        return make_mesh(2)
    return make_mesh(devices=[dev, dev])


def dp_eval(params, store, labels, info, dev, counts: dict) -> dict:
    """(d) `evaluate_split` beam 5 over a mesh of two entries on the 256
    videos (bf16, launches counted): each block's tokens equal the
    offline call at the block's batch (bf16, f32); under f32 the sharded
    tokens agree with the unsharded 256-video call on >= AGREE_MIN of the
    videos (batch size changes sums on the card); captions/s in turns."""
    import numpy as np
    import torch

    from controllable_xgating_torch.infer.evaluator import evaluate_split, sharded_call
    from controllable_xgating_torch.ops import kernels
    from controllable_xgating_torch.ops.precision import precision
    from controllable_xgating_torch.parallel.mesh import replicate, shard_rows

    mesh = dp_mesh(dev)
    reps = replicate(params, mesh)
    idx = np.arange(B)
    host = (*store.get_batch(idx), store.frame_mask(idx))
    out = {"mesh": [str(d) for d in mesh.devices]}
    with precision("bfloat16"):
        kernels.reset_launch_counts()
        metrics, caps = evaluate_split(params, store, labels, info, split="test", batch_size=B,
                                       max_len=MAX_LEN, max_pos_len=MAX_LEN,
                                       caption_fn=caption_fn(True, None), mesh=mesh)
        torch.cuda.synchronize()
        got = counts["dp-eval beam-5"] = kernels.launch_counts()
    print(f"dp eval beam-5 over {out['mesh']} launches {got}")
    if not all(got[n] for n in DP_DECODE) or got["xgate"] != mesh.size:
        fail(f"dp (d): a kernel of the mesh's beam-5 path did not launch as it should: {got}")
    if len(caps) != B or not all(math.isfinite(v) for v in metrics.values()):
        fail(f"dp (d): {len(caps)} captions, metrics {metrics}")
    for policy in ("bfloat16", "float32"):
        with precision(policy):
            fn = caption_fn(True, None)
            tokens = sharded_call(fn, reps, mesh, *host)[0]
            for d, sl in zip(mesh.devices, shard_rows(B, mesh)):
                want = fn(reps[d], *(torch.as_tensor(x[sl], device=d) for x in host))[0].cpu()
                if not torch.equal(tokens[sl], want):
                    fail(f"dp (d) [{policy}]: the block of rows {sl} on {d} differs from the "
                         "offline call at its batch")
            whole = fn(params, *(torch.as_tensor(x, device=dev) for x in host))[0].cpu()
            agree = (tokens == whole).all(1).float().mean().item()
        out[f"agree_{policy}"] = agree
        print(f"dp eval beam-5 [{policy}] over {out['mesh']}: every block equals the offline call "
              f"at its batch of {B // mesh.size}; agreement with the {B}-video call {agree:.4f}; "
              f"{CARD}")
        if policy == "float32" and agree < AGREE_MIN:
            fail(f"dp (d): f32 agreement {agree:.4f} < {AGREE_MIN}")
    rates = {"mesh": [], "one": []}
    with precision("bfloat16"):
        fn = caption_fn(True, None)
        inputs = [torch.as_tensor(x, device=dev) for x in host]
        for on in ("mesh", "one", "one", "mesh"):
            t = time.perf_counter()
            if on == "mesh":
                sharded_call(fn, reps, mesh, *host)
            else:
                fn(params, *inputs)[0].cpu()
            torch.cuda.synchronize()
            rates[on].append(B / (time.perf_counter() - t))
    out["captions_s"] = rates
    print(f"dp eval beam-5 captions/s [bfloat16, {B} videos, host arrays in, tokens out], mesh "
          f"{out['mesh']} then one device in turns: mesh {rates['mesh']} one {rates['one']}; "
          f"{CARD}")
    return out


def dp_serve(params, cfg, info, dev, counts: dict) -> dict:
    """(e) An engine over the mesh at buckets DP_BUCKETS, beam 5, per
    policy: every served block equals the offline call on the same block
    (`check_served_batches`), with its launches."""
    from controllable_xgating_torch.data.vocab import Vocab
    from controllable_xgating_torch.infer import graphs
    from controllable_xgating_torch.ops.precision import precision
    from controllable_xgating_torch.serve.engine import ServingEngine

    mesh = dp_mesh(dev)
    tags = [f"t{i}" for i in range(POS_VOCAB - 4)]
    reqs = serve_requests(cfg, 16, seed=21, tags=tags)
    controlled = [dict(r, pos_tags=tags[:6]) for r in serve_requests(cfg, 4, seed=22, tags=tags)]
    out = {}
    for policy in ("float32", "bfloat16"):
        graphs.clear()
        with precision(policy):
            eng = ServingEngine(params, cfg, info.vocab, Vocab(tags), mode="beam",
                                buckets=DP_BUCKETS, mesh=mesh)
        try:
            eng.warmup()
            res = check_served_batches(eng, eng._replicas, cfg, policy, reqs, controlled)
        finally:
            eng.close()
        counts[f"dp-serve [{policy}]"] = res["launches"]
        out[policy] = res
        print(f"dp serve [{policy}] over {[str(d) for d in mesh.devices]}, buckets {DP_BUCKETS}: "
              f"{res['batches']} blocks served, each equal to the offline call on it; {CARD}")
    return out


def dp_phase(params, cfg, store, labels, info, dev) -> dict:
    """The data-parallel path (ROADMAP A7) at MSR-VTT width: (a) the train
    CLI over NCCL at world size 1, (b) two ranks over gloo (on the one
    card of a one-card machine), (c) where there are two or more cards, 2
    (or, with four, 4) ranks over NCCL and the train CLI's own ranks
    against one device, (d) the decode mesh's
    eval, (e) the mesh's serving engine. Returns the printed numbers and
    the launches of each run."""
    import shutil

    import torch

    from controllable_xgating_torch.ops.precision import set_compute_dtype

    t0 = time.perf_counter()
    counts: dict = {}
    root = os.path.join(HERE, "build", "chip_smoke_dp")
    shutil.rmtree(root, ignore_errors=True)
    data = os.path.join(root, "corpus")
    write_cli_corpus(data, cfg, seed=2)
    out = {"a": dp_cli_world_one(data)}
    out["b"] = dp_pair(cfg, "gloo", counts, env={"CUDA_VISIBLE_DEVICES": "0"})
    cards = torch.cuda.device_count()
    if cards >= 2:
        n = 4 if cards >= 4 else 2
        out["c"] = {"steps": dp_pair(cfg, "nccl", counts, ranks=n), "cli": dp_cli_cards(data, n)}
    else:
        out["c"] = "skipped: one card"
        print(f"dp (c) two or more cards over NCCL: skipped, this machine has {cards} card "
              f"(not measured); {CARD}")
    shutil.rmtree(root, ignore_errors=True)
    out["d"] = dp_eval(params, store, labels, info, dev, counts)
    out["e"] = dp_serve(params, cfg, info, dev, counts)
    set_compute_dtype("bfloat16")
    out["launches"] = counts
    out["phase_s"] = time.perf_counter() - t0
    print(f"dp phase: {out['phase_s']:.1f} s; {CARD}")
    return out


# config 5 (BASELINE.json: a 2x hidden-dim decoder on the joint MSVD +
# MSR-VTT corpus, data-parallel) and the C3D widths (configs/msvd_c3d.json)
C5_OVERRIDES = {"model.vocab_size": VOCAB, "model.pos_vocab_size": POS_VOCAB,
                "model.decoder_hidden_mult": 2}
C5_STEPS = 5
C5_PAIRS, C5_WINDOW = 2, 3  # (b)'s timed windows: pairs in turns, steps in each
C5_CLI = ["--compute_dtype", "bfloat16", "--model.decoder_hidden_mult", "2",
          "--parallel.num_devices", "1", "--train.log_every_steps", "1",
          "--eval.max_decode_len", "20"]


def c5_int8(params, dev) -> dict:
    """K7 at config 5's beam shape [1280, 1024] -> 10000 against its plain
    version (F32_TOL: the same bf16 operands), timed, with its device us
    and bound."""
    import torch

    from controllable_xgating_torch.experiments.int8_vocab_matmul import (
        quantize_vocab_proj,
        with_kernel_operand,
    )
    from controllable_xgating_torch.ops.kernels.int8_vocab import int8_vocab_plain, int8_vocab_proj

    dec = params.decoder
    q = with_kernel_operand(quantize_vocab_proj(dec.w_out, dec.b_out))
    h = torch.tanh(torch.randn(B * K, dec.hidden_dim, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(14)))
    kern = lambda: int8_vocab_proj(h, q.wq, q.scale, q.bias, q.n, q.wq_t)
    plain = lambda: int8_vocab_plain(h, q.wq, q.scale, q.bias)[:, : q.n]
    got, ref = kern(), plain()
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    if not torch.isfinite(got).all() or not torch.allclose(got, ref, **F32_TOL):
        fail(f"config5 int8_vocab [{B * K}x{dec.hidden_dim}]: max |kernel - plain| {err:.3e}")
    row = {"max_abs_err": err, "ms": cuda_ms(kern), "plain_ms": cuda_ms(plain),
           "device_us": kernel_device_us(kern), "bound": int8_bound(B * K, dec.hidden_dim, VOCAB)}
    print(f"config5 kernel int8_vocab [{B * K}x{dec.hidden_dim} -> {VOCAB}]: max_abs_err "
          f"{err:.3e}  kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  device "
          f"{fmt_us(row['device_us'])} us per launch  bound {row['bound']}; {CARD}")
    return row


def c5_xe(cfg, dev) -> dict:
    """(b) the XE step at config 5 (batch 64 x 5, dropout 0.5, bf16, K5
    launched) fed by the train loop's prefetch (depth 2: `DevicePut`,
    pinned memory and a side stream) and without it (host batches the
    step copies), C5_PAIRS pairs of windows of C5_WINDOW steps in turns
    (ABBA): wall ms per step (batch fetch included), each pair's
    difference (prefetch - none) with their median and how many pairs
    each side won, device ms per step and busy share from one profiled
    window of C5_STEPS steps each, beside the host's batch assembly and
    synchronous copy alone (what the prefetch can hide at most); then
    under f32 at dropout 0 the losses of C5_STEPS steps, with and without
    prefetch, must be equal bit for bit."""
    import numpy as np
    import torch

    from controllable_xgating_torch.data.features import DevicePut, PrefetchIterator
    from controllable_xgating_torch.data.loader import TrainBatchIterator
    from controllable_xgating_torch.models.captioner import init_captioner
    from controllable_xgating_torch.ops import kernels
    from controllable_xgating_torch.ops.precision import set_compute_dtype
    from controllable_xgating_torch.train.state import create_train_state, make_optimizer
    from controllable_xgating_torch.train.xe import batch_to_device, make_xe_train_step
    from controllable_xgating_torch.utils.profiling import device_time_ms
    from torch.profiler import ProfilerActivity, profile

    store, caps, pos, ncaps = make_train_corpus(cfg, seed=1)
    bs, k = cfg.data.batch_size, cfg.data.caps_per_video_train
    source = lambda: iter(TrainBatchIterator(store, caps, pos, ncaps, np.arange(TRAIN_VIDEOS),
                                             bs, k, seed=0))

    def fresh(c):
        state = create_train_state(init_captioner(c, seed=0, device=dev), c)
        return state, make_xe_train_step(make_optimizer(c, TRAIN_VIDEOS // bs, "joint"), c)

    def batches(prefetch: bool):
        src = source()
        return PrefetchIterator(src, DevicePut(dev), depth=2) if prefetch else src

    def window(step, state, it, n):
        losses = []
        for _ in range(n):
            state, m = step(state, next(it))
            losses.append(m["loss"])
        torch.cuda.synchronize()
        return losses

    set_compute_dtype("bfloat16")
    state, step = fresh(cfg)
    out = {}
    walls = {True: [], False: []}
    kernels.reset_launch_counts()
    for prefetch in (True, False, False, True) * (C5_PAIRS // 2):
        it = batches(prefetch)
        window(step, state, it, 1)  # warm-up: the thread's first batches
        t = time.perf_counter()
        window(step, state, it, C5_WINDOW)
        walls[prefetch].append((time.perf_counter() - t) / C5_WINDOW * 1e3)
        if prefetch:
            it.close()
    counts = kernels.launch_counts()
    if any(counts[n] != 2 * C5_PAIRS * (1 + C5_WINDOW) for n in DP_TRAIN):
        fail(f"config5 xe: K5 did not launch once a step: {counts}")
    diffs = [a - b for a, b in zip(walls[True], walls[False])]  # adjacent windows
    out["pairs"] = {"diff_ms": diffs, "median_diff_ms": float(np.median(diffs)),
                    "prefetch_faster": sum(d < 0 for d in diffs),
                    "prefetch_slower": sum(d > 0 for d in diffs)}
    print(f"config5 xe [bfloat16] {C5_PAIRS} pairs of {C5_WINDOW}-step windows in turns, wall "
          f"ms per step prefetch - none: {[round(d, 2) for d in diffs]}, median "
          f"{out['pairs']['median_diff_ms']:.2f}; prefetch faster in "
          f"{out['pairs']['prefetch_faster']}, slower in {out['pairs']['prefetch_slower']}; "
          f"{CARD}")
    # what the prefetch can take off a step at most: the host's batch
    # assembly and its synchronous copy to the card
    src, fetch = source(), []
    for _ in range(5):
        t = time.perf_counter()
        batch_to_device(next(src), dev)
        torch.cuda.synchronize()
        fetch.append((time.perf_counter() - t) * 1e3)
    out["fetch_ms"] = float(np.median(fetch))
    for prefetch in (True, False):
        it = batches(prefetch)
        window(step, state, it, 1)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:  # the device's events only
            window(step, state, it, C5_STEPS)
        if prefetch:
            it.close()
        dev_ms = device_time_ms(prof.key_averages()) / C5_STEPS
        name = "prefetch" if prefetch else "no_prefetch"
        out[name] = {"wall_ms": walls[prefetch], "device_ms": dev_ms,
                     "busy": dev_ms / float(np.median(walls[prefetch]))}
        print(f"config5 xe [bfloat16, batch {bs} x {k}, dropout {cfg.model.dropout}, "
              f"{'prefetch depth 2' if prefetch else 'no prefetch'}]: wall ms per step "
              f"{[round(w, 2) for w in walls[prefetch]]} (in turns; median "
              f"{float(np.median(walls[prefetch])):.2f}), device {dev_ms:.2f} ms per "
              f"step (one profiled window), busy share {out[name]['busy']:.3f}; the host's "
              f"batch assembly + synchronous copy {out['fetch_ms']:.2f} ms (median of 5); {CARD}")

    set_compute_dtype("float32")
    c0 = cfg.replace_flat({"model.dropout": 0.0})
    losses = {}
    for prefetch in (True, False):
        state, step = fresh(c0)
        it = batches(prefetch)
        losses[prefetch] = [x.item() for x in window(step, state, it, C5_STEPS)]
        if prefetch:
            it.close()
    print(f"config5 xe [float32, dropout 0, {C5_STEPS} steps]: losses with prefetch "
          f"{losses[True]}, without {losses[False]}")
    if losses[True] != losses[False]:
        fail("config5 xe: f32 losses with and without prefetch differ")
    set_compute_dtype("bfloat16")
    out["launches"] = counts
    return out


def config5_phase(dev) -> dict:
    """Config 5 at its own shape and the C3D widths on the card (`config5`
    lines): (a) K3 and K4 at decoder Hd 1024, K7 at K 1024 (config 5) and
    K1 at motion 4096 (C3D) against their plain versions at the paths'
    shapes under f32 (F32_TOL) and bf16 (BF16_TOL; K7 F32_TOL), with their
    ms, device us per launch and bounds, and `lanes_fits(5, 1024)` with
    K4's shared memory; (b) `c5_xe`, then 3 XE steps as 2 gloo ranks on
    the one card against 1 rank (f32, `dp_pair`); (c) beam 5 and greedy
    over 256 seeded videos through `evaluate_split` (bf16): K1 1 and K2-K4
    28 launches for beam 5 (K4: the lanes tail, not the grouped one),
    graphed tokens equal to eager, f32 kernels-vs-plain agreement >= 98%,
    captions/s, device ms and the roofline shares; (d) C3D: beam 5 over
    256 videos at motion 4096, K1 once a call; under f32 K1 held inside
    the path (>= 98%: its encoder under the plain decoder against the
    plain path, and the kernel path against it with the plain encoder),
    the whole path's agreement with the plain one printed; (e)
    the user path in build/chip_smoke_config5: `make_joint_fixture_corpus`
    at MSR-VTT width (600 + 300 videos), `cli.train --stage joint
    --model.decoder_hidden_mult 2 --parallel.num_devices 1` for one epoch
    (prefetched; the loss must fall), `cli.eval --beam_size 5` (finite
    metrics; K1 once a batch, K2-K4 launched)."""
    import shutil

    import numpy as np
    import torch

    from controllable_xgating_torch.cli import eval as cli_eval
    from controllable_xgating_torch.cli import train as cli_train
    from controllable_xgating_torch.data.fixtures import make_joint_fixture_corpus
    from controllable_xgating_torch.infer.beam import beam_search
    from controllable_xgating_torch.infer.evaluator import evaluate_split
    from controllable_xgating_torch.models.captioner import encode_for_inference, init_captioner
    from controllable_xgating_torch.ops import kernels
    from controllable_xgating_torch.ops.dispatch import set_decode_graphs
    from controllable_xgating_torch.ops.kernels import topk_tail
    from controllable_xgating_torch.ops.kernels.xgate import xgate_fits
    from controllable_xgating_torch.ops.precision import precision, set_compute_dtype
    from controllable_xgating_torch.utils import roofline
    from controllable_xgating_torch.utils.config import load_config
    from controllable_xgating_torch.utils.profiling import call_device_ms

    t_phase = time.time()
    cfg5 = load_config(os.path.join(HERE, "configs", "msrvtt.json"), C5_OVERRIDES)
    c3d = load_config(os.path.join(HERE, "configs", "msvd_c3d.json"),
                      {"model.vocab_size": VOCAB, "model.pos_vocab_size": POS_VOCAB})
    p5, pc = (init_captioner(c, seed=0, device=dev) for c in (cfg5, c3d))
    hd = p5.decoder.hidden_dim
    if hd != 1024 or pc.encoder.xgate.wm.shape[0] != 4096:
        fail(f"config5: decoder Hd {hd}, C3D motion {pc.encoder.xgate.wm.shape[0]}")
    out = {"kernels": {}}

    # (a) the kernels at config 5's and C3D's shapes
    with precision("bfloat16"):
        fits = topk_tail.lanes_fits(K, hd)
    smem = -(-topk_tail.padded_hd(hd) // topk_tail._TILE_K) * topk_tail._A_TILE \
        + topk_tail._RING + 1024
    print(f"config5 lanes_fits({K}, {hd}) [bfloat16]: {fits}; K4's chunk kernel takes {smem} of "
          f"{topk_tail.SMEM_OPTIN} B of shared memory; xgate_fits(1536, 4096, 512): "
          f"{xgate_fits(1536, 4096, 512)}")
    if not fits:
        fail(f"config5: beam {K} at Hd {hd} would take the grouped tail")
    dev_us = {}
    shapes = {"attn_lstm": (p5, f", Hd {hd}"), "topk_tail": (p5, f", Hd {hd}"),
              "xgate": (pc, ", motion 4096")}
    for policy, tols in (("float32", {n: F32_TOL for n in BF16_TOL}), ("bfloat16", BF16_TOL)):
        set_compute_dtype(policy)
        for name, (params, tag) in shapes.items():
            err, ms, plain_ms = check_kernels(params, dev, policy, tols, names=(name,),
                                              device_us=dev_us, tag=" config5" + tag)[name]
            out["kernels"].setdefault(name, {})[policy] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    bounds = {**caption_bounds(p5), "xgate": caption_bounds(pc)["xgate"]}
    for name in shapes:
        out["kernels"][name].update(device_us=dev_us.get(name), bound=bounds[name])
    out["kernels"]["int8_vocab"] = c5_int8(p5, dev)
    set_compute_dtype("bfloat16")
    print(f"config5 (a) kernels: {time.time() - t_phase:.1f} s into the phase")

    # (b) the XE step with and without prefetch; two gloo ranks against one
    out["xe"] = c5_xe(cfg5, dev)
    counts = {}
    out["dp"] = dp_pair(cfg5, "gloo", counts, env={"CUDA_VISIBLE_DEVICES": "0"},
                        policies=("float32",), scst=False, tag=", config5 Hd 1024")
    print(f"config5 (b) xe and dp: {time.time() - t_phase:.1f} s into the phase")

    # (c) beam 5 and greedy at config 5 over 256 videos; (d) C3D beam 5
    kind = torch.cuda.get_device_name(0)
    for label, params, cfg in (("beam-5", p5, cfg5), ("greedy", p5, cfg5),
                               ("c3d beam-5", pc, c3d)):
        beam = "beam" in label
        store, labels, info = make_corpus(cfg, seed=0)
        kernels.reset_launch_counts()
        metrics, caps = evaluate_split(
            params, store, labels, info, split="test", batch_size=B, max_len=MAX_LEN,
            max_pos_len=MAX_LEN, caption_fn=caption_fn(beam, None))
        torch.cuda.synchronize()
        got = counts[f"config5 {label}"] = kernels.launch_counts()
        want = {"xgate": 1, "pos_lstm": MAX_LEN, "attn_lstm": MAX_LEN}
        if beam:
            want["topk_tail"] = MAX_LEN
        print(f"config5 {label} launches {got}")
        if any(got[n] != v for n, v in want.items()):
            fail(f"config5 {label}: launches {got}, expected {want}")
        if len(caps) != B or not all(math.isfinite(v) for v in metrics.values()):
            fail(f"config5 {label}: {len(caps)} captions, metrics {metrics}")
        app, mot = (torch.as_tensor(x, device=dev) for x in store.get_batch(np.arange(B)))
        mask = torch.as_tensor(store.frame_mask(np.arange(B)), device=dev)
        call = lambda fused: caption_fn(beam, fused)(params, app, mot, mask)[0]
        row = {"launches": got}
        if label != "c3d beam-5":
            graphed = call(None)
            set_decode_graphs(False)
            try:
                eager = call(None)
            finally:
                set_decode_graphs(None)
            if not torch.equal(graphed, eager):
                fail(f"config5 {label}: graphed tokens differ from the eager loop's")
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t = time.perf_counter()
                call(None)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t)
            wall = float(np.median(walls))
            d = call_device_ms(lambda: call(None))
            dms = d["profiler"] if d["kernels_seen"] else d["events"]
            cost = (roofline.beam_workload_cost(cfg.model, B, K, MAX_LEN, MAX_LEN) if beam else
                    roofline.greedy_workload_cost(cfg.model, B, MAX_LEN, MAX_LEN))
            shares = {k: roofline.utilization(cost, sec, kind, "bfloat16")
                      for k, sec in (("wall", wall), ("device", dms / 1e3))}
            row.update(captions_s=B / wall, wall_ms=wall * 1e3, device_ms=dms,
                       roofline={k: {"mfu": u["mfu"], "hbm_bw_util": u["hbm_bw_util"]}
                                 for k, u in shares.items()})
            print(f"config5 {label} [bfloat16, Hd {hd}, 256 videos]: graphed tokens equal the "
                  f"eager loop's; {B / wall:.1f} captions/s (wall {wall * 1e3:.2f} ms, median of "
                  f"3), device {dms:.2f} ms; roofline on the wall mfu {shares['wall']['mfu']}, "
                  f"hbm_bw_util {shares['wall']['hbm_bw_util']}, on the device time mfu "
                  f"{shares['device']['mfu']}, hbm_bw_util {shares['device']['hbm_bw_util']}; "
                  f"{CARD}")
        set_compute_dtype("float32")
        kernels.reset_launch_counts()
        a = call(None)
        k1 = kernels.launch_counts()["xgate"]
        b = call(False)
        agree = (a == b).all(1).float().mean().item()
        row["f32_agreement"] = agree
        print(f"config5 {label} caption agreement kernels vs plain [float32]: {agree:.4f}; K1 "
              f"launches in the kernels' call {k1}")
        if label == "c3d beam-5":
            # what the C3D widths change is K1's input (4096-d motion); the
            # decoder is the main path's (Hd 512). K1 is held inside the
            # path both ways: its encoder under the plain decoder against
            # the plain path, and the kernel path against the same path
            # with the plain encoder. The whole path against the plain one
            # is printed: its flips are the decoder kernels' near-ties on
            # random weights, whatever the encoder (PERF.md, Findings)
            enc = {f: encode_for_inference(params, app, mot, mask, max_pos_len=MAX_LEN, fused=f)
                   for f in (True, False)}
            dec = lambda e, f: beam_search(params.decoder, enc[e][0], enc[e][1], K, MAX_LEN,
                                           fused=f)[0]
            pairs = {"K1 + plain decoder vs plain": (dec(True, False), dec(False, False)),
                     "kernels vs kernels with the plain encoder": (dec(True, True), dec(False, True))}
            row["k1_agreement"] = {n: (x == y).all(1).float().mean().item()
                                   for n, (x, y) in pairs.items()}
            print(f"config5 {label} [float32] K1 at motion 4096 in the caption path: "
                  + json.dumps(row["k1_agreement"]))
            agree = min(row["k1_agreement"].values())
        set_compute_dtype("bfloat16")
        if agree < AGREE_MIN or k1 != 1:
            fail(f"config5 {label}: f32 agreement {agree:.4f} (< {AGREE_MIN}?), K1 {k1} (!= 1?)")
        out[label] = row

    print(f"config5 (c), (d) decode: {time.time() - t_phase:.1f} s into the phase")
    # (e) the user path: the joint corpus, cli.train, cli.eval
    root = os.path.join(HERE, "build", "chip_smoke_config5")
    shutil.rmtree(root, ignore_errors=True)
    data, ck = os.path.join(root, "corpus"), os.path.join(root, "ck")
    t = time.perf_counter()
    info = make_joint_fixture_corpus(data)
    n = {k: len(v) for k, v in info.splits.items()}
    print(f"config5 joint corpus (600 MSR-VTT-shaped + 300 MSVD-shaped videos, 26 frames, "
          f"1536 + 1024): splits {n}, vocab {len(info.vocab)}, written in "
          f"{time.perf_counter() - t:.1f} s")
    base = ["--data_dir", data, "--config", os.path.join(HERE, "configs", "msrvtt.json"), *C5_CLI]
    _, train_s = counted_cli("config5 train", cli_train.main,
                        ["--checkpoint_dir", ck, "--stage", "joint", "--epochs", "1", *base],
                        counts, CLI_CAPTION_KERNELS, ("topk_tail", *DP_TRAIN))
    with open(os.path.join(ck, "joint", "train_log.jsonl")) as f:
        losses = [e["loss"] for e in map(json.loads, f) if "loss" in e]
    print(f"config5 train [joint, Hd {hd}, prefetch depth 2, bf16, {n['train']} videos]: "
          f"{len(losses)} steps in {train_s:.1f} s over the whole command; loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; {CARD}")
    if not (losses and math.isfinite(losses[-1]) and losses[-1] < losses[0]):
        fail(f"config5 train: the loss did not fall: {losses}")
    eval_json = os.path.join(root, "eval_test.json")
    _, dt = counted_cli("config5 eval-beam-5", cli_eval.main,
                        ["--checkpoint_dir", os.path.join(ck, "joint"), "--beam_size", "5",
                         "--out", eval_json, *base], counts, (*CLI_CAPTION_KERNELS, "topk_tail"))
    with open(eval_json) as f:
        res = json.load(f)
    calls = -(-n["test"] // cfg5.data.batch_size)
    got = counts["config5 eval-beam-5"]
    if (len(res["captions"]) != n["test"] or got["xgate"] != calls
            or not all(math.isfinite(v) for v in res["metrics"].values())):
        fail(f"config5 eval: {len(res['captions'])} captions, K1 {got['xgate']} in {calls} "
             f"batches, metrics {res['metrics']}")
    print(f"config5 eval [beam 5, {n['test']} test videos, {calls} batches, bf16]: "
          f"{n['test'] / dt:.2f} captions/s over the whole command; metrics "
          f"{json.dumps(res['metrics'])}; {CARD}")
    out["cli"] = {"train_losses": losses, "train_s": train_s, "eval_s": dt,
                  "eval_metrics": res["metrics"]}
    shutil.rmtree(root, ignore_errors=True)
    out["launches"] = counts
    out["phase_s"] = time.time() - t_phase
    print("config5 kernels: " + json.dumps(out["kernels"]))
    print(f"config5 phase: {out['phase_s']:.1f} s; {CARD}")
    return out


# the ingest, checkpoint and study tools (ROADMAP A4, A7), in a directory of
# their own; the study phase's corpus, checkpoint and captions come along
TOOLS_ROOT = os.path.join(HERE, "build", "chip_smoke_tools")
REHEARSAL_BATCH = 256
REHEARSAL_SPLITS = {"train": 6513, "val": 497, "test": 2990}  # the default 10000 x 20
REHEARSAL_TIMEOUT_S = 900
REHEARSAL_XE_STEPS = 5
GRID_CELLS = ("concat_pos", "xgate_nopos")  # the cells no other phase trains
GRID_EPOCHS = (1, 1, 1)  # pos, caption, SCST: the flagship recipe's (8, 40, 15), cut
ALL_KERNELS = ("xgate", "pos_lstm", "attn_lstm", "topk_tail", "xent_fwd", "xent_bwd",
               "int8_vocab", "topk_extract")


def rehearsal_xe_step(data: str, dev) -> dict:
    """The rehearsal's XE step (bf16, batch REHEARSAL_BATCH x 5 captions,
    dropout 0.5, K5) on its own corpus, in this process, fed as the train
    loop feeds it (`PrefetchIterator`, `DevicePut`): wall ms per step over
    REHEARSAL_XE_STEPS steps after one, the device ms of one profiled
    step and the busy share."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from controllable_xgating_torch.cli.common import load_corpus
    from controllable_xgating_torch.data.features import DevicePut, PrefetchIterator
    from controllable_xgating_torch.data.loader import TrainBatchIterator
    from controllable_xgating_torch.models.captioner import init_captioner
    from controllable_xgating_torch.ops.precision import precision
    from controllable_xgating_torch.train.state import create_train_state, make_optimizer
    from controllable_xgating_torch.train.xe import make_xe_train_step
    from controllable_xgating_torch.utils.config import load_config
    from controllable_xgating_torch.utils.profiling import device_time_ms

    info, labels, store, cfg = load_corpus(data, load_config(None, {
        "data.batch_size": REHEARSAL_BATCH}))
    it = TrainBatchIterator(store, labels["caps"], labels["pos"], labels["ncaps"],
                            np.asarray(info.splits["train"]), REHEARSAL_BATCH,
                            cfg.data.caps_per_video_train, seed=0)
    with precision("bfloat16"), PrefetchIterator(iter(it), DevicePut(dev), depth=2) as batches:
        state = create_train_state(init_captioner(cfg, seed=0, device=dev), cfg)
        step = make_xe_train_step(make_optimizer(cfg, it.steps_per_epoch(), "joint"), cfg)
        state, _ = step(state, next(batches))
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(REHEARSAL_XE_STEPS):
            state, m = step(state, next(batches))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) / REHEARSAL_XE_STEPS * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:  # the device's events only
            state, m = step(state, next(batches))
            torch.cuda.synchronize()
    dev_ms = device_time_ms(prof.key_averages())
    return {"wall_ms": wall, "device_ms": dev_ms, "busy": dev_ms / wall,
            "rows": REHEARSAL_BATCH * cfg.data.caps_per_video_train,
            "vocab": cfg.model.vocab_size, "loss": m["loss"].item()}


def grid_run(counts: dict, walls: dict):
    """`tools/ablation_grid.py::run` in this process: each stage command's
    module `main(argv)` through `counted_cli`, with the launches it must
    make: K2 and K3 in every command (the psi-free cells' POS rollout too),
    K1 only in an xgate cell, K4 in the beam-5 evals alone, no K5 (the
    study corpus's 81 words are under its V >= 2048 gate)."""
    import importlib

    def run(cmd, log_path, retries=1, capture_stdout=False):
        module, argv = cmd[2], cmd[3:]
        cell = os.path.basename(os.path.dirname(log_path))
        beam = module.endswith(".cli.eval")
        if "--stage" in argv:
            what = "train-" + argv[argv.index("--stage") + 1]
        elif beam:
            what = "eval-" + os.path.basename(argv[argv.index("--checkpoint_dir") + 1])
        else:
            what = module.rsplit(".", 1)[1]
        xgate = cell.startswith("xgate")
        want = ("pos_lstm", "attn_lstm") + (("xgate",) if xgate else ()) + (
            ("topk_tail",) if beam else ())
        absent = ("xent_fwd", "xent_bwd") + (() if xgate else ("xgate",)) + (
            () if beam else ("topk_tail",))
        label = f"tools grid {cell} {what}"
        text, walls[label] = counted_cli(label, importlib.import_module(module).main, argv,
                                         counts, want, absent)
        return text if capture_stdout else None

    return run


def tools_phase(dev) -> dict:
    """The ingest, checkpoint and study tools (`tools ...` lines, in
    build/chip_smoke_tools): (a) `tools.dress_rehearsal` at its default
    scale (10000 videos x 20 captions, splits 6513 / 497 / 2990, app 1536,
    motion 1024, 26 frames; `--batch_size 256`) as a user runs it, in a
    process of its own: the vocab threshold holds (the tool asserts it),
    each stage's seconds and peak RSS, the XE epoch's launches (K5 once a
    step, K1-K3 in the greedy val eval, no K4), its per-step losses finite
    and falling, its epoch rate; then its XE step on the same corpus in
    this process (wall, device ms, busy share); (b) the study phase's
    trained `best` through `torch.save` as a reference-style `.pth` (one
    entry transposed under its mapping) and `tools.import_torch_checkpoint`
    into a `.pt` slot, and `tools.average_checkpoints` of that `best` with
    itself at weights 1,3: both slots' parameters equal the source's and
    `cli.eval --beam_size 5` on each gives the study's captions exactly;
    (c) `tools.ablation_grid` on the study corpus at the flagship recipe's
    widths, epochs cut to GRID_EPOCHS, cells GRID_CELLS, each stage
    command in this process with its launches pinned (`grid_run`: K1 0 in
    concat_pos), finite metrics and controllability in grid_results.json,
    then `tools.ablation_report` and `tools.psi_diversity` (K2) on them."""
    import re
    import shutil

    import numpy as np
    import torch

    from controllable_xgating_torch import bridge
    from controllable_xgating_torch.cli import eval as cli_eval
    from controllable_xgating_torch.cli.common import load_corpus, restore_params
    from controllable_xgating_torch.tools import (
        ablation_grid,
        ablation_report,
        average_checkpoints,
        import_torch_checkpoint,
        psi_diversity,
    )
    from controllable_xgating_torch.utils.config import load_config

    t_phase = time.time()
    root = TOOLS_ROOT
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    counts, out = {}, {}

    # (a) the full-scale rehearsal, in its own process (its peak RSS is its own)
    reh = os.path.join(root, "rehearsal")
    cmd = [sys.executable, "-m", "controllable_xgating_torch.tools.dress_rehearsal",
           "--out", reh, "--batch_size", str(REHEARSAL_BATCH), "--train.log_every_steps", "1"]
    torch.cuda.empty_cache()
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                          timeout=REHEARSAL_TIMEOUT_S)
    wall = time.perf_counter() - t
    if proc.returncode:
        fail(f"tools rehearsal exited {proc.returncode}: {proc.stderr[-3000:]} "
             f"{proc.stdout[-2000:]}")
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    stages = {e["stage"]: e for e in lines if "stage" in e}
    converted = next(e for e in lines if "captions" in e and "splits" in e)
    if converted["captions"] != 200000 or converted["splits"] != REHEARSAL_SPLITS:
        fail(f"tools rehearsal: converted {converted}")
    steps = -(-REHEARSAL_SPLITS["train"] // REHEARSAL_BATCH)
    got = counts["tools rehearsal xe"] = stages["xe_epoch_plus_eval"]["launches"]
    print(f"tools rehearsal xe launches {got}")
    if (got["xent_fwd"] != steps or got["xent_bwd"] != steps or got["topk_tail"]
            or not all(got[n] for n in CLI_CAPTION_KERNELS)):
        fail(f"tools rehearsal xe: K5 not once in each of {steps} steps, or K1-K3 not in the "
             f"greedy val eval, or K4 launched: {got}")
    with open(os.path.join(reh, "ck", "joint", "train_log.jsonl")) as f:
        losses = [e["loss"] for e in map(json.loads, f) if "loss" in e]
    if len(losses) != steps or not all(map(math.isfinite, losses)) or losses[-1] >= losses[0]:
        fail(f"tools rehearsal xe: losses of its {steps} steps {losses}")
    rate = re.search(r"epoch 0 loss [0-9.]+ \(([0-9.]+) samples/s\)", proc.stdout)
    epoch_step_ms = REHEARSAL_BATCH / float(rate.group(1)) * 1e3 if rate else None
    xe_step = rehearsal_xe_step(reh, dev)
    out["rehearsal"] = {"stages": list(stages.values()), "wall_s": wall, "losses": losses,
                        "epoch_step_ms": epoch_step_ms, "xe_step": xe_step}
    for e in stages.values():
        print(f"tools rehearsal stage {json.dumps(e)}")
    print(f"tools rehearsal [10000 videos x 20 captions, vocab {stages['TOTAL']['vocab_size']}, "
          f"app 1536, motion 1024, 26 frames, batch {REHEARSAL_BATCH}, bf16, {CARD}]: "
          f"{wall:.1f} s as a process; XE epoch of {steps} steps, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, "
          + (f"{epoch_step_ms:.2f} ms a step over the epoch (its log's samples/s); "
             if epoch_step_ms else "no epoch rate in its log; ")
          + f"the step in this process: wall {xe_step['wall_ms']:.2f} ms (mean of "
          f"{REHEARSAL_XE_STEPS} after 1), device {xe_step['device_ms']:.2f} ms, busy "
          f"{xe_step['busy']:.3f} ({xe_step['rows']} rows x vocab {xe_step['vocab']})")
    shutil.rmtree(reh, ignore_errors=True)

    # (b) the study's checkpoint through the importer and the averager
    data = os.path.join(STUDY_ROOT, "corpus")
    best = os.path.join(STUDY_ROOT, "ck", "caption")
    with open(os.path.join(STUDY_ROOT, "eval_test.json")) as f:
        study_eval = json.load(f)
    pairs = list(zip(STUDY_COMMON[::2], STUDY_COMMON[1::2]))
    model_flags = [a for k, v in pairs if k.startswith("--model.") for a in (k, v)]
    cfg = load_config(None, {k[2:]: v for k, v in pairs if k.startswith("--model.")})
    _, _, _, cfg = load_corpus(data, cfg)
    source = restore_params(best, cfg, "cpu")
    sd, mapping = {}, {}
    flat = bridge.param_paths(source)
    flip = next(n for n, a in flat if a.ndim == 2)
    for n, a in flat:
        key = "module." + n
        sd[key] = torch.from_numpy(a.T.copy() if n == flip else a)
        mapping[n] = {"key": key, "transform": "transpose"} if n == flip else key
    pth, map_path = os.path.join(root, "model-best.pth"), os.path.join(root, "mapping.json")
    torch.save({"state_dict": sd}, pth)
    with open(map_path, "w") as f:
        json.dump(mapping, f)
    slots = {"imported": os.path.join(root, "imported"), "averaged": os.path.join(root, "averaged")}
    _, dt_imp = counted_cli("tools import", import_torch_checkpoint.main,
                            ["--data_dir", data, "--pth", pth, "--mapping", map_path,
                             "--out", slots["imported"], *model_flags], counts, (), ALL_KERNELS)
    _, dt_avg = counted_cli("tools average", average_checkpoints.main,
                            ["--data_dir", data, "--inputs", best, f"{best}:best",
                             "--weights", "1,3", "--out", slots["averaged"]], counts, (),
                            ALL_KERNELS)
    want = dict(source.named_parameters())
    ckpts = {"import_s": dt_imp, "average_s": dt_avg}
    for label, ck in slots.items():
        got = dict(restore_params(ck, cfg, "cpu").named_parameters())
        if got.keys() != want.keys() or not all(torch.equal(got[n], want[n]) for n in want):
            fail(f"tools {label}: the parameters differ from the source's")
        js = os.path.join(root, f"eval_{label}.json")
        _, dt = counted_cli(f"tools eval-{label}", cli_eval.main,
                            ["--data_dir", data, "--checkpoint_dir", ck, "--split", "test",
                             "--beam_size", "5", "--out", js, *STUDY_COMMON], counts,
                            (*CLI_CAPTION_KERNELS, "topk_tail"))
        with open(js) as f:
            res = json.load(f)
        if res["captions"] != study_eval["captions"] or res["metrics"] != study_eval["metrics"]:
            diff = sum(res["captions"].get(k) != v for k, v in study_eval["captions"].items())
            fail(f"tools eval-{label}: {diff} captions differ from the study checkpoint's")
        ckpts[f"eval_{label}_s"] = dt
    out["checkpoints"] = ckpts
    print(f"tools checkpoints [the study's best, {len(flat)} tensors, {flip!r} stored "
          f"transposed; {CARD}]: imported ({dt_imp:.2f} s) and averaged with itself at weights "
          f"1,3 ({dt_avg:.2f} s): parameters equal bit for bit; cli.eval beam 5 on each: "
          f"{len(study_eval['captions'])} captions and metrics equal to the study's")

    # (c) two cells of the ablation grid, each command in this process
    grid_dir, walls = os.path.join(root, "grid"), {}
    n_test = len(study_eval["captions"])
    recipe, runner = ablation_grid.RECIPE, ablation_grid.run
    ablation_grid.RECIPE = dict(ablation_grid.FLAGSHIP, epochs=GRID_EPOCHS)
    ablation_grid.run = grid_run(counts, walls)
    t = time.perf_counter()
    try:
        ablation_grid.main(["--data_dir", data, "--out", grid_dir, "--cells",
                            ",".join(GRID_CELLS)])
    finally:
        ablation_grid.RECIPE, ablation_grid.run = recipe, runner
    grid_s = time.perf_counter() - t
    results_path = os.path.join(grid_dir, "grid_results.json")
    with open(results_path) as f:
        results = json.load(f)
    names = [f"{c['fusion']}_{'pos' if c['pos_guidance'] else 'nopos'}" for c in results]
    for c in results:
        ctrl = c["controllability"]
        if not (all(math.isfinite(v) for k in ("caption_metrics", "scst_metrics")
                    for v in c[k].values())
                and ctrl["videos"] == n_test
                and all(0.0 <= ctrl[k] <= 1.0 for k in ("free_run_tag_agreement",
                                                       "controlled_tag_agreement"))):
            fail(f"tools grid: cell {c}")
    if names != list(GRID_CELLS):
        fail(f"tools grid: cells {names}")
    report, _ = counted_cli("tools ablation_report", ablation_report.main,
                            [results_path, "--data_dir", data, "--bootstrap", "200"], counts, (),
                            ALL_KERNELS)
    psi = {}
    for cell in GRID_CELLS:
        text, _ = counted_cli(f"tools psi_diversity {cell}", psi_diversity.main,
                              ["--checkpoint_dir", os.path.join(grid_dir, cell, "scst"),
                               "--data_dir", data], counts,
                              ("pos_lstm",) + (("xgate",) if cell.startswith("xgate") else ()),
                              ("attn_lstm", "topk_tail") + (
                                  () if cell.startswith("xgate") else ("xgate",)))
        psi[cell] = json.loads(text)
        if psi[cell]["videos"] != min(128, n_test) or psi[cell]["distinct_tag_sequences"] < 1:
            fail(f"tools psi_diversity {cell}: {psi[cell]}")
    out["grid"] = {"wall_s": grid_s, "command_s": walls, "results": results,
                   "psi": {c: {k: v for k, v in r.items() if k != "checkpoint"}
                           for c, r in psi.items()}}
    print(f"tools grid [{', '.join(GRID_CELLS)} on the study corpus, flagship widths, epochs "
          f"{GRID_EPOCHS}, bf16, {CARD}]: {grid_s:.1f} s; per command "
          f"{json.dumps({k: round(v, 2) for k, v in walls.items()})}")
    print("tools ablation_report:\n" + report.strip())
    print(f"tools psi_diversity (distinct free-run tag sequences of {min(128, n_test)} test "
          f"videos): " + json.dumps({c: [r["distinct_tag_sequences"], r["top"][:2]]
                                     for c, r in psi.items()}))
    shutil.rmtree(root, ignore_errors=True)
    shutil.rmtree(STUDY_ROOT, ignore_errors=True)
    out["launches"] = counts
    out["phase_s"] = time.time() - t_phase
    print(f"tools phase: {out['phase_s']:.1f} s; {CARD}")
    return out


BREAKDOWN_ROOT = os.path.join(HERE, "build", "chip_smoke_breakdown")
BREAKDOWN_REPS = ["--reps", "2,4"]  # the tools' loop lengths, cut from 2,8 / 2,10 / 2,32
SERVE_RATES = "100,800"  # the higher above the 404.7 requests/s of 64 closed-loop clients


def run_tool(name: str, main, argv: list):
    """A measurement tool's `main(argv)` in this process, its standard
    output kept in BREAKDOWN_ROOT/<name>.txt; its return value."""
    import contextlib
    import io

    buf = io.StringIO()
    t = time.time()
    with contextlib.redirect_stdout(buf):
        ret = main(argv)
    with open(os.path.join(BREAKDOWN_ROOT, f"{name}.txt"), "w") as f:
        f.write(buf.getvalue())
    print(f"breakdown {name}: {time.time() - t:.1f} s")
    return ret


def check_shares(label: str, row: dict) -> None:
    """A report row's roofline shares: on its sustained ms each at most
    ROOFLINE_MAX, on its device ms too wherever the profile kept an event
    of every launch (else printed: a short count inflates the share)."""
    on_dev = row.get("on_device") or {}
    for key in ("mfu", "hbm_bw_util"):
        if key in row and row[key] > ROOFLINE_MAX:
            fail(f"breakdown {label}: {key} {row[key]} > {ROOFLINE_MAX} on its sustained ms")
        if on_dev.get(key, 0) > ROOFLINE_MAX:
            if row["events_complete"]:
                fail(f"breakdown {label}: {key} {on_dev[key]} > {ROOFLINE_MAX} on its device ms")
            print(f"breakdown {label}: {key} {on_dev[key]} on a device ms read from a short "
                  f"event count {row['kernel_events']} for launches {row['launches']}")


def want_launches(label: str, got: dict, want: dict) -> None:
    if got != want:
        fail(f"breakdown {label}: launches {got}, expected {want}")


def breakdown_phase(dev) -> dict:
    """The measurement tools (`breakdown ...` lines, outputs in
    build/chip_smoke_breakdown), each through its `main` in this process
    at MSR-VTT width (app 1536, motion 1024, Hd 512, 26 frames, V 10000,
    batch 256, bf16) with its loop lengths cut to BREAKDOWN_REPS:
    (a) the harness is not pruned: beam-5's sustained ms a call is at
    least 0.9 x its profiled device ms, and 10 calls take longer than 2;
    (b) `cider_piece_timing`, the one-call rewards equal to the two-call
    ones (atol 1e-6); (c) `beam_topk_ab`: K4 in lanes only; under f32 the
    block, grouped and flat tails' tokens equal; (d) `ensemble_bench` at
    M = 1, 2: K3 56 a call at M = 2, no K4; (e) `profile_beam_step`: K3
    once a decode_fused repetition, none in decode_jnp, K3 and K4 28 each
    in the beam call; decode_fused's (h, c) against decode_jnp's within
    the attn_lstm bf16 bound; (f) `xe_breakdown`: K5 in the _KERNEL rows
    alone; loss_lse_KERNEL against loss_lse rtol 1e-4 (f32 logits); (g)
    `scst_breakdown`: K3 28 in greedy_rollout; (h) `serve_bench` at 100
    and 800 offered requests/s for 2 s with 1000 ms deadlines: both
    complete, p50 <= p99, nothing expired at 100; (i) `trace_ops
    --workload beam` ranks the port's kernels, its kernel events printed
    beside the ledger's launches. Every roofline share of (e) and (f)
    (`check_shares`) at most ROOFLINE_MAX."""
    import shutil

    import torch

    from controllable_xgating_torch.ops.cider_device import build_reward_tables
    from controllable_xgating_torch.ops.kernels.attn_lstm import attn_lstm_step_plain
    from controllable_xgating_torch.ops.precision import precision
    from controllable_xgating_torch.tools import (
        beam_topk_ab,
        cider_piece_timing,
        ensemble_bench,
        profile_beam_step,
        scst_breakdown,
        serve_bench,
        trace_ops,
        xe_breakdown,
    )
    from controllable_xgating_torch.train.xe import masked_xe_loss
    from controllable_xgating_torch.utils import timing
    from controllable_xgating_torch.utils.profiling import call_device_ms

    t_phase = time.time()
    shutil.rmtree(BREAKDOWN_ROOT, ignore_errors=True)
    os.makedirs(BREAKDOWN_ROOT)
    out: dict = {}
    with precision("bfloat16"):
        cfg, params = timing.build(device=dev)
        # (a) the harness
        fn = timing.make_fn(cfg)
        app, mot = (timing.put(x, dev) for x in timing.random_batch(cfg, timing.BATCH))
        times: dict = {}
        per = timing.diff_time(timing.caption_loop(fn, params, app, mot), (2, 10), times=times)
        d = call_device_ms(lambda: fn(params, app, mot))
        out["harness"] = {"sustained_ms": round(per * 1e3, 3), "device_ms": round(d["profiler"], 3),
                          "calls_2_ms": round(times[2] * 1e3, 3),
                          "calls_10_ms": round(times[10] * 1e3, 3),
                          "events_complete": d["events_complete"]}
        print(f"breakdown harness [bfloat16, {CARD}]: beam-5 " + json.dumps(out["harness"]))
        if not times[10] > times[2]:
            fail(f"breakdown harness: 10 calls {times[10]} s not longer than 2 {times[2]} s")
        if per * 1e3 < 0.9 * d["profiler"]:
            fail(f"breakdown harness: sustained {per * 1e3:.3f} ms a call under 0.9 x its "
                 f"device {d['profiler']:.3f} ms: the timed loop skips work")

        # (e) the decode step: K3 against decode_step's plain path under f32,
        # against its own plain version under bf16 (the plain path rounds the
        # attention context to bf16 where K3 and its plain version do not)
        err = {}
        for policy in ("float32", "bfloat16"):
            with precision(policy), torch.no_grad():
                s = profile_beam_step.setup(cfg, params, timing.BATCH, dev)
                dec, ctx_k = params.decoder, s["ctx_k"]
                path, k3 = (profile_beam_step.decode_core(dec, ctx_k, s["tok"], s["h"], s["c"], f)
                            for f in (False, True))
                own = attn_lstm_step_plain(dec, dec.embed[s["tok"]], s["h"], s["c"], ctx_k.keys,
                                           ctx_k.enc_proj, ctx_k.psi_g)[:2]
            gap = lambda x, y: max((a - b).abs().max().item() for a, b in zip(x, y))
            err[policy] = {"decode_fused_vs_jnp": gap(k3, path), "decode_fused_vs_own_plain":
                           gap(k3, own), "jnp_vs_own_plain": gap(path, own)}
            if policy == "float32" and not all(torch.allclose(a, b, **F32_TOL)
                                               for a, b in zip(k3, path)):
                fail(f"breakdown decode_fused vs decode_jnp [float32]: {err[policy]}")
        if err["bfloat16"]["decode_fused_vs_own_plain"] > BF16_TOL["attn_lstm"]["atol"]:
            fail(f"breakdown decode_fused vs its plain version [bfloat16]: {err['bfloat16']}")
        print("breakdown decode step (h, c) max |d|: " + json.dumps(err))
        out["decode_step_err"] = err

        # (f) the loss, plain row statistics against K5, f32 logits
        g = torch.Generator(device=dev).manual_seed(2)
        rows = timing.BATCH * xe_breakdown.K
        logits = torch.randn((rows, MAX_LEN - 1, VOCAB), generator=g, device=dev)
        targets = torch.randint(4, VOCAB, (rows, MAX_LEN - 1), generator=g, device=dev)
        losses = []
        for kernels in (False, True):
            with xe_breakdown.routed(kernels):
                losses.append(masked_xe_loss(logits, targets).item())
        if not math.isclose(losses[1], losses[0], rel_tol=1e-4):
            fail(f"breakdown loss_lse_KERNEL {losses[1]} vs loss_lse {losses[0]}")
        out["loss_lse"] = losses
        del logits

        # (b) the reward, one call of 2B against two of B
        caps, ncaps, cand = cider_piece_timing.make_inputs(timing.BATCH)
        tables = build_reward_tables(caps, ncaps, list(range(timing.BATCH)), device=dev)
        cand, vidx = torch.as_tensor(cand, device=dev), torch.arange(timing.BATCH, device=dev)
        two = torch.cat(cider_piece_timing.two_calls(tables, cand, vidx))
        err = (cider_piece_timing.one_call(tables, cand, vidx) - two).abs().max().item()
        if err > 1e-6:
            fail(f"breakdown cider one_call_2B vs two_calls_B: max |d| {err}")

        # (c) the full log-softmax tails under f32
        with precision("float32"):
            toks = {m: timing.make_fn(cfg, fused=False, topk_mode=m)(params, app, mot)[0]
                    for m in ("block", "grouped", "flat")}
        if not all(torch.equal(t, toks["flat"]) for t in toks.values()):
            fail("breakdown f32 block / grouped / flat tails: tokens differ")
        del params, s, tables, own, path, k3

    cider = run_tool("cider_piece_timing", cider_piece_timing.main, BREAKDOWN_REPS)
    out["cider_ms"] = cider["timings_ms"]
    out["cider_device_ms"] = cider["device_ms"]

    ab = run_tool("beam_topk_ab", beam_topk_ab.main, BREAKDOWN_REPS)
    for mode, row in ab["forms"].items():
        has_k4 = "topk_tail" in row["launches"]
        if has_k4 != (mode == "lanes") or (has_k4 and row["launches"]["topk_tail"] != MAX_LEN):
            fail(f"breakdown beam_topk_ab {mode}: launches {row['launches']}")
    out["beam_topk_ab"] = {m: [r["captions_per_sec"], r["device_ms"]] for m, r in ab["forms"].items()}

    ens = run_tool("ensemble_bench", ensemble_bench.main,
                   BREAKDOWN_REPS + ["--members", "1,2", "--repeats", "1"])
    m2 = ens["points"]["M=2"]["launches"]
    if m2.get("attn_lstm") != 2 * MAX_LEN or "topk_tail" in m2:
        fail(f"breakdown ensemble_bench M=2: launches {m2}")
    out["ensemble"] = {k: [p["captions_per_sec"], p["device_ms"], p.get("per_member_vs_single")]
                       for k, p in ens["points"].items()}

    pb = run_tool("profile_beam_step", profile_beam_step.main, BREAKDOWN_REPS)["pieces"]
    want_launches("decode_fused", pb["decode_fused"]["launches"], {"attn_lstm": 1})
    want_launches("decode_jnp", pb["decode_jnp"]["launches"], {})
    want_launches("full_beam_step", pb["full_beam_step(prod/28)"]["launches"],
                  {"attn_lstm": MAX_LEN, "topk_tail": MAX_LEN})
    for name, row in pb.items():
        check_shares(f"profile_beam_step {name}", row)
    out["profile_beam_step"] = {n: [r["us_per_step"], r["device_ms"]] for n, r in pb.items()}

    xe = run_tool("xe_breakdown", xe_breakdown.main, BREAKDOWN_REPS)["pieces"]
    for name, row in xe.items():
        if "derived" in name:
            continue
        want_launches(f"xe_breakdown {name}", row["launches"], {} if "_KERNEL" not in name else
                      {"xent_fwd": 1} if name.startswith("loss_lse") else
                      {"xent_fwd": 1, "xent_bwd": 1})
        check_shares(f"xe_breakdown {name}", row)
    out["xe"] = {n: [r["ms"], r.get("device_ms")] for n, r in xe.items()}

    sc = run_tool("scst_breakdown", scst_breakdown.main, BREAKDOWN_REPS)
    want_launches("scst_breakdown greedy_rollout", sc["launches"]["greedy_rollout"],
                  {"attn_lstm": MAX_LEN})
    out["scst_ms"], out["scst_device_ms"] = sc["timings_ms"], sc["device_ms"]
    out["scst_videos_per_sec"] = sc["videos_per_sec"]

    points = run_tool("serve_bench", serve_bench.main,
                      ["--rates", SERVE_RATES, "--duration", "2", "--deadline_ms", "1000"])
    for p in points:
        if p["n"] < 1 or p["latency_ms_p50"] > p["latency_ms_p99"]:
            fail(f"breakdown serve_bench at {p['offered_rps']}/s: {p}")
    if points[0]["expired"]:
        fail(f"breakdown serve_bench: {points[0]['expired']} expired at {points[0]['offered_rps']}/s")
    out["serve"] = [{k: p[k] for k in ("offered_rps", "achieved_rps", "n", "latency_ms_p50",
                                       "latency_ms_p99", "mean_ride_bucket", "expired",
                                       "late_completions")} for p in points]

    tr = run_tool("trace_ops", trace_ops.main, ["--workload", "beam", "--reps", "2", "--out",
                                                os.path.join(BREAKDOWN_ROOT, "trace_beam")])
    ranked = [o["op"].split("(")[0] for o in tr["ops"] if "cxg::" in o["op"]]
    if not ranked:
        fail(f"breakdown trace_ops: no kernel of the port among {[o['op'] for o in tr['ops']]}")
    out["trace_beam"] = {"total_device_us": tr["total_device_us"], "port_kernels": ranked[:6],
                         "kernel_events": tr["port_kernel_events"], "launches": tr["launches"]}
    print("breakdown trace_ops beam: kernel events " + json.dumps(tr["port_kernel_events"])
          + " beside the ledger's launches " + json.dumps(tr["launches"]))
    for label, rows in (("profile_beam_step", pb), ("xe_breakdown", xe)):
        print(f"breakdown {label} [bfloat16, {CARD}]: " + json.dumps(rows))
    out["seconds"] = round(time.time() - t_phase, 1)
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

    # the decode loops as replayed CUDA graphs against the eager loop
    graph_rows = graphs_phase(params, cfg, store, dev)
    set_compute_dtype("bfloat16")

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
    counts["xe-train"], xe_step_s = train_phase(cfg, dev)

    # SCST: the reward tables and the reward at MSR-VTT's caption scale,
    # then both realizations' steps, the baseline through K3
    scst = scst_phase(cfg, dev)

    # the entry points users run: train, eval and caption through main(argv)
    set_compute_dtype("float32")  # each CLI picks bf16 and must leave this as it found it
    cli = cli_phase(dev, cfg)

    # the native host runtime under the metrics and the df build,
    # --profile, --debug_nans and the roofline shares of the timed calls
    host = host_phase(dev, cfg, graph_rows, xe_step_s)

    # the serving path: the engine's buckets through the kernels, the
    # HTTP front end under load
    serve_rows = serve_phase(params, cfg, store, info, dev)

    # the port's own user path on a corpus it makes: prepro, train, eval,
    # the early exit and the controllability study on trained weights
    study = study_phase(dev)

    # data parallelism: the train CLI in a process group, two ranks, the
    # decode mesh's eval and serving
    dp = dp_phase(params, cfg, store, labels, info, dev)

    # config 5 at its own shape (2x decoder, the joint corpus, two ranks)
    # and the C3D widths
    c5 = config5_phase(dev)

    # the ingest, checkpoint and study tools: the full-scale rehearsal, the
    # study's checkpoint imported and averaged, two cells of the grid
    tools = tools_phase(dev)

    # the measurement tools: piece tables of the beam step, XE, SCST and the
    # reward, ensembles, the server under open-loop load, a trace
    breakdown = breakdown_phase(dev)

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
        {n: [fmt_us(DEVICE_US[n]), round(bounds[n][0] * 1e3, 2)] for n, *_ in kernel_rows}))
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": src + f, "replaces": r,
         "launches": counts[path][n], "max_abs_err": res[0], "ms": res[1], "plain_ms": res[2],
         "bound_ms": bounds[n][0], "bound_by": bounds[n][1], "library_ms": res[3]}
        for n, f, r, path, res in kernel_rows
    ]}))
    print("scst phase launches in its timed steps: " + json.dumps(scst))
    print("a9 phase (host clock /s; agreement): " + json.dumps(a9))
    print("cli phase (host clock, s and /s): " + json.dumps(cli))
    print("host phase: " + json.dumps(host))
    print("graphs phase (graphed vs eager, bf16): " + json.dumps(graph_rows))
    print("serve phase: " + json.dumps(serve_rows, default=str))
    print("study phase: " + json.dumps(study))
    print("dp phase: " + json.dumps(dp, default=str))
    print("config5 phase: " + json.dumps(c5, default=str))
    print("tools phase: " + json.dumps(tools, default=str))
    print("breakdown phase: " + json.dumps(breakdown, default=str))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
