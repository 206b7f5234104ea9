"""A/B the weight-only int8 vocab projection against the bf16 one.

Counterpart of the JAX package's `tools/quant_ab.py`: for each batch size,
caption seeded videos (26 frames) with seeded random weights (vocab 10000,
35 POS tags) through greedy or beam-5, once with the bf16 vocab projection
and once with `vocab_q`, the kernel path on, and print the sustained
captions/s of both. The projection is quantized once, before the timed
calls. Each rate is the median of `--reps` calls after one warm-up call,
timed on the host clock around calls that end in a device synchronise.

    python -m controllable_xgating_torch.tools.quant_ab [--beam] [--hidden N]
        [--batches 8 16 32 64 256] [--reps 5] [--device cuda|cpu]

It refuses to run without a CUDA device unless `--device cpu` is given; a
CPU run times PyTorch's CPU kernels, not the card.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np
import torch

from controllable_xgating_torch.experiments.int8_vocab_matmul import quantize_vocab_proj
from controllable_xgating_torch.infer.beam import beam_search
from controllable_xgating_torch.infer.greedy import greedy_decode
from controllable_xgating_torch.models.captioner import encode_for_inference, init_captioner
from controllable_xgating_torch.ops.dispatch import fused_enabled
from controllable_xgating_torch.ops.precision import precision
from controllable_xgating_torch.utils.config import Config

BEAM = 5
MAX_LEN = 28
FRAMES = 26


def build(cfg_overrides=None, device="cuda"):
    """Default config at vocab 10000 and 35 POS tags, random weights from
    seed 0, on `device`."""
    cfg = Config().replace_flat({
        "model.vocab_size": 10000,
        "model.pos_vocab_size": 35,
        **(cfg_overrides or {}),
    })
    return cfg, init_captioner(cfg, seed=0, device=device)


def random_batch(cfg, batch, seed=0):
    rng = np.random.default_rng(seed)
    app = rng.normal(size=(batch, FRAMES, cfg.model.app_dim)).astype(np.float32)
    mot = rng.normal(size=(batch, FRAMES, cfg.model.motion_dim)).astype(np.float32)
    return app, mot


def make_fn(cfg, beam: bool, vocab_q=None):
    """(params, app, motion, frame_mask=None) -> (tokens [B, 28], pos_tags):
    every call runs all 28 steps; the kernel path is on unless
    `set_fused_kernels(False)` was called before. Beam takes the lanes
    tail without `vocab_q` and the grouped one with it."""
    m = cfg.model
    fused = fused_enabled(None)

    @torch.inference_mode()
    def fn(params, app, motion, frame_mask=None):
        ctx, summary, tags = encode_for_inference(
            params, app, motion, frame_mask, max_pos_len=m.max_pos_len, fused=fused,
        )
        if beam:
            tokens, _ = beam_search(
                params.decoder, ctx, summary, BEAM, MAX_LEN, fused=fused, vocab_q=vocab_q,
            )
        else:
            tokens = greedy_decode(
                params.decoder, ctx, summary, MAX_LEN, fused=fused, vocab_q=vocab_q,
            )
        return tokens, tags

    return fn


def captions_per_s(fn, params, app, mot, reps: int) -> float:
    """Median captions/s of `reps` synchronised calls after one warm-up."""
    sync = torch.cuda.synchronize if app.device.type == "cuda" else (lambda: None)
    fn(params, app, mot)
    sync()
    rates = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(params, app, mot)
        sync()
        rates.append(app.shape[0] / (time.perf_counter() - t0))
    return statistics.median(rates)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--beam", action="store_true", help="beam-5 instead of greedy")
    p.add_argument("--batches", type=int, nargs="+", default=[8, 16, 32, 64, 256])
    p.add_argument("--hidden", type=int, default=None, help="override model.hidden_dim")
    p.add_argument("--reps", type=int, default=5, help="timed calls per rate (>= 5)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    if args.reps < 5:
        p.error("--reps must be at least 5")
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("quant_ab: no CUDA device (pass --device cpu to run on the CPU)")

    # the bf16 policy is scoped to this call: the policy is process-global
    with precision("bfloat16"):
        over = {"model.hidden_dim": args.hidden} if args.hidden else None
        cfg, params = build(over, device=args.device)
        vq = quantize_vocab_proj(params.decoder.w_out, params.decoder.b_out)
        where = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
        print(f"# {'beam-5' if args.beam else 'greedy'}, hidden {cfg.model.hidden_dim}, on {where}")
        print(f"{'batch':>6} {'bf16':>12} {'int8':>12} {'delta':>8}")
        for b in args.batches:
            app, mot = (torch.as_tensor(x, device=args.device) for x in random_batch(cfg, b))
            out = {
                quant: captions_per_s(make_fn(cfg, args.beam, vq if quant else None), params, app,
                                      mot, args.reps)
                for quant in (False, True)
            }
            print(f"{b:>6} {out[False]:>10.0f}/s {out[True]:>10.0f}/s "
                  f"{out[True] / out[False] - 1:>+7.1%}", flush=True)


if __name__ == "__main__":
    main()
