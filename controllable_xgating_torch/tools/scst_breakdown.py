"""SCST step breakdown and the two rollout realizations.

Counterpart of the JAX package's `tools/scst_breakdown.py`, with its
flags, pieces and report keys and `--device` in place of `--platform`.
At MSR-VTT width (B 256 videos, vocab 10000, 35 POS tags, 28 steps, bf16
on the card), random weights from seed 0, reward tables over the B videos
x 20 seeded captions, it times by `utils/timing.py::make_timed` (the
sustained ms of a repeated piece, and the device ms of one under
`torch.profiler`):

  encode_psi        encoder + POS greedy rollout + decode context
  greedy_rollout    the baseline decode (the decoder-step kernel, K3,
                    where the kernels are on)
  sample_rollout    the multinomial decode with its per-step logp
  paired_rollout    the 2B-row rollout of both token sets
  cider_candidate   one `cider_d_device` call on fixed tokens
  loss_forward_*    `scst_loss` forward, each realization

and, by `time_train_sustained`, the full steps `step_original`
(separate rollouts, gradient through the sampling loop) and
`step_paired` (one 2B rollout without gradient, then logp teacher-
forced). Backward + optimizer ~= step - loss_forward. The JAX tool's
`PRNGKey(3)` is a `torch.Generator` seeded 3 on the device; torch's
stream is not JAX's, so the sampled tokens differ from JAX's.

    python -m controllable_xgating_torch.tools.scst_breakdown [--batch 256]
        [--reps 2,8] [--device cuda|cpu]

Without a CUDA device it exits 1 unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

REFS = 20


def make_inputs(cfg, batch: int, seed: int = 11):
    """(caps [B, 20, L], ncaps [B], {app, motion, video_indices}) numpy
    draws, bit for bit the JAX tool's."""
    from controllable_xgating_torch.utils.timing import FRAMES

    m = cfg.model
    rng = np.random.default_rng(seed)
    ncaps = np.full((batch,), REFS, np.int64)
    caps = np.zeros((batch, REFS, m.max_caption_len), np.int32)
    caps[:, :, 0] = 1
    caps[:, :, 1:-1] = rng.integers(4, m.vocab_size, (batch, REFS, m.max_caption_len - 2))
    caps[:, :, -1] = 2
    feats = {
        "app": rng.normal(size=(batch, FRAMES, m.app_dim)).astype(np.float32),
        "motion": rng.normal(size=(batch, FRAMES, m.motion_dim)).astype(np.float32),
        "video_indices": np.arange(batch, dtype=np.int32),
    }
    return caps, ncaps, feats


def encode_psi(params, app, motion, max_pos_len: int):
    """(decode context, summary, psi): the encoder, psi from the POS
    generator's greedy rollout, the context."""
    from controllable_xgating_torch.models.decoder import make_decode_context
    from controllable_xgating_torch.models.encoder import encode
    from controllable_xgating_torch.models.pos_generator import pos_greedy_generate

    enc_out, summary = encode(params.encoder, app, motion)
    _, psi = pos_greedy_generate(params.pos, summary, max_pos_len)
    return make_decode_context(params.decoder, enc_out, psi, None), summary, psi


def _fold(x: torch.Tensor) -> torch.Tensor:
    return (x.sum() % 7).float() * 1e-6


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--reps", default="2,8")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where to run (default: the card; cpu only when asked)")
    args = p.parse_args(argv)

    from controllable_xgating_torch.cli.common import runtime_device
    from controllable_xgating_torch.infer.greedy import greedy_decode, paired_rollout, sample_decode
    from controllable_xgating_torch.ops.cider_device import build_reward_tables, cider_d_device
    from controllable_xgating_torch.ops.dispatch import fused_enabled
    from controllable_xgating_torch.ops.precision import precision
    from controllable_xgating_torch.train.scst import make_scst_train_step, scst_loss
    from controllable_xgating_torch.train.state import create_train_state, make_optimizer
    from controllable_xgating_torch.utils import timing
    from controllable_xgating_torch.utils.config import Config

    dev, dtype = runtime_device(args.device, None, Config())
    fused = fused_enabled(None)
    b = args.batch
    reps = tuple(int(r) for r in args.reps.split(","))
    timings: dict = {}
    detail: dict = {}
    timed = timing.make_timed(timings, dev, reps, tag="breakdown", detail=detail)

    with precision(dtype):
        cfg, params = timing.build(device=dev)
        m = cfg.model
        max_len = cfg.eval.max_decode_len
        caps, ncaps, feats = make_inputs(cfg, b)
        tables = build_reward_tables(caps, ncaps, list(range(b)), device=dev)
        batch = {k: timing.put(v, dev) for k, v in feats.items()}
        app, mot, vidx = batch["app"], batch["motion"], batch["video_indices"]
        gen = torch.Generator(device=dev).manual_seed(3)

        # ---- pieces ----
        def encode_psi_body(c):
            ctx, _, psi = encode_psi(params, app + c, mot, m.max_pos_len)
            return (ctx.keys.sum() + psi.sum()).float() * 1e-9

        timed("encode_psi", encode_psi_body)
        # the rollouts' fixed context (outside their timing)
        with torch.no_grad():
            ctx, summary, _ = encode_psi(params, app, mot, m.max_pos_len)
        dec = params.decoder
        fused_arg = True if fused else None
        timed("greedy_rollout", lambda c: _fold(greedy_decode(dec, ctx, summary + c, max_len,
                                                              fused=fused_arg)))
        timed("sample_rollout", lambda c: _fold(sample_decode(dec, ctx, summary + c, max_len,
                                                              gen)[0]))
        timed("paired_rollout", lambda c: _fold(torch.cat(paired_rollout(
            dec, ctx, summary + c, max_len, gen, fused=fused_arg))))
        with torch.no_grad():
            cand = greedy_decode(dec, ctx, summary, max_len)
        timed("cider_candidate", lambda c: _fold(cider_d_device(
            tables, cand + (c > 1e30).long(), vidx)))
        for name, paired in (("loss_forward_original", False), ("loss_forward_paired", True)):
            timed(name, lambda c, paired=paired: scst_loss(
                params, {**batch, "app": app + c}, tables, gen, max_len, m.max_pos_len,
                fused_baseline=fused, paired=paired)[0] * 1e-9)

        # ---- full steps ----
        for name, paired in (("step_original", False), ("step_paired", True)):
            full = cfg.replace_flat({"train.scst_paired_rollout": paired})
            state = create_train_state(params, full)
            step = make_scst_train_step(make_optimizer(full, 100), full, tables)
            timings[name] = round(timing.time_train_sustained(step, state, batch, dev) * 1e3, 3)
            copy = timing.copy_train_state(state)
            detail[name] = timing.device_detail(lambda: step(copy, batch), dev)
            print(f"[breakdown] {name}: {timings[name]:.3f} ms", file=sys.stderr,
                  flush=True)

    report = {
        "batch": b,
        "device": timing.device_name(dev),
        "fused_dispatch": fused,
        "timings_ms": timings,
        "device_ms": {k: d["device_ms"] for k, d in detail.items()},
        "launches": {k: d["launches"] for k, d in detail.items()},
        "videos_per_sec": {
            "original": round(b / (timings["step_original"] / 1e3), 1),
            "paired": round(b / (timings["step_paired"] / 1e3), 1),
        },
    }
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
