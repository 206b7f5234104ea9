#!/usr/bin/env python3
"""Drive the PyTorch port's captioning path once on one NVIDIA GPU.

    python3 chip_smoke.py                 # from the root of a checkout

Phases, each fatal on failure:
  1. refuse to run without a CUDA device; print the card's name and
     power limit;
  2. build the four CUDA kernels of the path from `csrc/`;
  3. hold every kernel against its plain PyTorch version at the shapes the
     path gives it (MSR-VTT width: 256 videos x 26 frames, beam 5), under
     the f32 policy (rtol 1e-4, atol 1e-5) and the bf16 policy (a bound
     per kernel, `BF16_TOL`), and time both with CUDA events;
  4. caption 256 seeded videos with random seeded weights under the bf16
     policy through `evaluate_split` with `make_beam_caption_fn` (beam 5),
     then with `make_greedy_caption_fn`; every kernel of each path must
     have launched, and the metrics must be finite;
  5. under the f32 policy, the kernel path and the plain path
     (`set_fused_kernels(False)`) must give the same caption for >= 98% of
     the videos, beam and greedy;
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
AGREE_MIN = 0.98


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
            if "registers" in line or "bytes stack frame" in line:
                print("ptxas:", line.strip())

    cfg = load_config(os.path.join(HERE, "configs", "msrvtt.json"),
                      {"model.vocab_size": VOCAB, "model.pos_vocab_size": POS_VOCAB})
    params = init_captioner(cfg, seed=0).to(dev)
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
        need = kernels.WRAPPERS if beam else ("xgate", "pos_lstm", "attn_lstm")
        if not all(counts[label][n] for n in need):
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
    if any(m in sys.modules for m in ("jax", "flax", "orbax", "h5py")):
        fail("the port pulled in jax/flax/orbax/h5py")

    src = "controllable_xgating_torch/csrc/"
    replaces = {
        "xgate": "controllable_xgating_tpu/ops/pallas/xgate.py:52",
        "pos_lstm": "controllable_xgating_tpu/ops/pallas/pos_lstm.py:35",
        "attn_lstm": "controllable_xgating_tpu/ops/pallas/attn_lstm.py:43",
        "topk_tail": "controllable_xgating_tpu/ops/pallas/topk_tail.py:66",
    }
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": f"{src}{n}.cu", "replaces": replaces[n],
         "launches": counts["beam-5"][n], "max_abs_err": results[n][0], "ms": results[n][1],
         "plain_ms": results[n][2]}
        for n in replaces
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
