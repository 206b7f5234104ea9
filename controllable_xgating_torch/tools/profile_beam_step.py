"""Piece-wise timing of the beam-5 decode step and of the XE train step.

Counterpart of the JAX package's `tools/profile_beam_step.py`, at its
shapes (B 256 videos, K 5 beams, V 10000, 1280 decoder rows, bf16 on the
card) and with its pieces:

  decode_jnp / decode_fused  `models/decoder.py::decode_step` without the
                             vocab projection: attention + gate + cell,
                             the plain path, then the decoder-step kernel
                             (K3) on weights packed once
  logits_chain               h @ w_out + b, the special tokens masked,
                             log_softmax, the flat top-K over [B, K*V]
  logits_matmul              h @ w_out alone
  full_beam_step(prod/28)    `beam_search` with the kernels (K3 + K4), per
                             step of its 28
  xe_fwd / xe_step           the teacher-forced forward (`xe_losses`,
                             dropout 0) / the whole joint train step
                             (remat on)

Each piece is timed by the harness of `utils/timing.py` (the step pieces
repeated at `--reps`' two loop lengths, the beam call and the forward at
the shorter length and two more, each differenced; the train step as
`time_train_sustained`), with the device ms of one call under
`torch.profiler` and the launches it counted. It prints one JSON line per
piece: microseconds per step, and on the card the roofline shares of
`utils/roofline.py::utilization` on the sustained time and, under
`on_device`, on the device time (the card's name from
`torch.cuda.get_device_name`); then a summary line. On the CPU no share
is given (`roofline.device_peaks` knows no CPU), and the summary says so.

    python -m controllable_xgating_torch.tools.profile_beam_step [--batch 256]
        [--reps 2,32] [--device cuda|cpu]

Without a CUDA device it exits 1 unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

B, K, REPS = 256, 5, 32


def setup(cfg, params, batch: int, dev, seed: int = 0) -> dict:
    """The fixed inputs of the pieces, from the JAX tool's draws: app and
    motion, the encoder's output, a random psi, the context tiled K times,
    the initial (h, c) of B*K rows and BOS tokens; then the XE batch
    (captions and tags drawn over [4, V) and [4, 35))."""
    from controllable_xgating_torch.data.vocab import BOS
    from controllable_xgating_torch.models.decoder import (
        DecodeContext,
        init_decoder_state,
        make_decode_context,
    )
    from controllable_xgating_torch.models.encoder import encode

    m = cfg.model
    rng = np.random.default_rng(seed)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    app = t(rng.normal(size=(batch, m.num_frames, m.app_dim)))
    mot = t(rng.normal(size=(batch, m.num_frames, m.motion_dim)))
    dec = params.decoder
    with torch.no_grad():
        enc_out, summary = encode(params.encoder, app, mot)
        psi = t(rng.normal(size=(batch, m.pos_embed_dim)))
        ctx = make_decode_context(dec, enc_out, psi)
        ctx_k = DecodeContext(*(None if x is None else x.repeat_interleave(K, 0) for x in ctx))
        h, c = init_decoder_state(dec, summary.repeat_interleave(K, 0))
    caps = rng.integers(4, m.vocab_size, (batch, K, m.max_caption_len)).astype(np.int32)
    pos = rng.integers(4, m.pos_vocab_size, (batch, K, m.max_pos_len)).astype(np.int32)
    return {"app": app, "motion": mot, "summary": summary, "ctx": ctx, "ctx_k": ctx_k,
            "h": h, "c": c, "tok": torch.full((batch * K,), BOS, dtype=torch.long, device=dev),
            "batch": {"app": app, "motion": mot, "caps": torch.as_tensor(caps, device=dev),
                      "pos": torch.as_tensor(pos, device=dev)}}


def decode_core(dec, ctx_k, tok, h, c, fused: bool, kernel_weights=None):
    """(h', c') of one decode step without the vocab projection."""
    from controllable_xgating_torch.models.decoder import decode_step

    _, h2, c2, _ = decode_step(dec, ctx_k, tok, h, c, fused=fused, return_hidden=True,
                               kernel_weights=kernel_weights)
    return h2, c2


def logits_chain(dec, h, batch: int):
    """(values, flat ids) [B, K] of the flat top-K over the masked
    log-softmax of h @ w_out + b, as beam's flat tail forms it."""
    from controllable_xgating_torch.infer.greedy import mask_special_tokens
    from controllable_xgating_torch.ops.kernels.topk_tail import topk
    from controllable_xgating_torch.ops.precision import mm

    logits = mask_special_tokens(mm(h, dec.w_out) + dec.b_out.float())
    logp = torch.log_softmax(logits, -1).reshape(batch, -1)
    return topk(logp, K)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=B)
    p.add_argument("--reps", default=f"2,{REPS}",
                   help="the two repetition counts differenced (the JAX tool's REPS = 32)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where to run (default: the card; cpu only when asked)")
    args = p.parse_args(argv)

    from controllable_xgating_torch.cli.common import runtime_device
    from controllable_xgating_torch.infer.beam import beam_search
    from controllable_xgating_torch.ops.kernels.attn_lstm import attn_lstm_weights
    from controllable_xgating_torch.ops.precision import mm, precision
    from controllable_xgating_torch.train.state import create_train_state, make_optimizer
    from controllable_xgating_torch.train.xe import make_xe_train_step, xe_losses
    from controllable_xgating_torch.utils import roofline, timing
    from controllable_xgating_torch.utils.config import Config

    dev, dtype = runtime_device(args.device, None, Config())
    b, rows = args.batch, args.batch * K
    reps = tuple(int(r) for r in args.reps.split(","))
    results: dict = {}

    def report(name, secs, detail, cost, per: int = 1):
        """One piece: `secs` per call of `per` steps."""
        if detail["device_ms"] is not None:
            detail = {**detail, "device_ms": round(detail["device_ms"] / per, 4)}
        row = timing.piece(secs / per * 1e3, detail, cost, dev, dtype, ndigits=4)
        entry = {"piece": name, "us_per_step": round(row.pop("ms") * 1e3, 1), **row}
        results[name] = entry
        print(json.dumps(entry), flush=True)

    def timed(name, step, carry, cost):
        """`step(carry) -> carry`, repeated; the carry is whatever the
        step threads through (device tensors only)."""

        def run(n):
            x = carry
            with torch.no_grad():
                for _ in range(n):
                    x = step(x)
            return x

        report(name, timing.diff_time(run, reps),
               timing.device_detail(lambda: run(1), dev), cost)

    with precision(dtype):
        cfg, params = timing.build(device=dev)
        m, dec = cfg.model, params.decoder
        hd, v = dec.hidden_dim, dec.vocab_size
        s = setup(cfg, params, b, dev)
        ctx_k, tok = s["ctx_k"], s["tok"]

        # --- decode core (no logits) ---
        core = roofline.decode_step_cost(m, rows)
        lg = roofline.Cost(2 * rows * hd * v, hd * v * 2 + rows * 2 * v * 4)
        core = roofline.Cost(core.flops - lg.flops, core.hbm_bytes - lg.hbm_bytes)
        with torch.no_grad():
            kw = attn_lstm_weights(dec)
        for fused, name in ((False, "decode_jnp"), (True, "decode_fused")):
            timed(name, lambda hc, fused=fused: decode_core(
                dec, ctx_k, tok, *hc, fused, kw if fused else None), (s["h"], s["c"]), core)

        # --- the logits chain as the flat tail forms it, and its matmul ---
        def chain(x):
            h, _ = x
            vals, idx = logits_chain(dec, h, b)
            return h + vals.mean() * 0, idx.float().mean()

        zero = torch.zeros((), device=dev)
        timed("logits_chain", chain, (s["h"], zero),
              roofline.Cost(2 * rows * hd * v, hd * v * 2 + rows * (2 * v * 4) + rows * v * 4))
        timed("logits_matmul", lambda x: (x[0], mm(x[0], dec.w_out).mean()), (s["h"], zero),
              roofline.Cost(2 * rows * hd * v, hd * v * 2 + rows * v * 4))

        # --- the whole beam call, per step ---
        def beam(c):
            toks = beam_search(dec, s["ctx"], s["summary"] + c, K, 28, fused=True)[0]
            return (toks.sum() % 7).float() * 1e-6

        run = timing.repeat_loop(beam, (), dev)
        report("full_beam_step(prod/28)", timing.diff_time(run, reps[:1] + (reps[0] + 2,)),
               timing.device_detail(lambda: run(1), dev), roofline.decode_step_cost(m, rows),
               per=28)

        # --- XE: the forward, then the train step ---
        batch = s["batch"]

        def fwd(c):
            cap_l, pos_l = xe_losses(params, {**batch, "app": batch["app"] + c}, None, 0.0)
            return (cap_l + pos_l) * 1e-9

        run = timing.repeat_loop(fwd, (), dev)
        report("xe_fwd", timing.diff_time(run, reps[:1] + (reps[0] + 2,)),
               timing.device_detail(lambda: run(1), dev),
               roofline.xe_step_cost(m, b, K, m.max_caption_len, m.max_pos_len).scaled(1 / 3))

        full = cfg.replace_flat({"train.remat": True})
        state = create_train_state(params, full)
        step = make_xe_train_step(make_optimizer(full, 100), full, "joint")
        copy = timing.copy_train_state(state)
        report("xe_step", timing.time_train_sustained(step, state, batch, dev, steps=3),
               timing.device_detail(lambda: step(copy, batch), dev),
               roofline.xe_step_cost(m, b, K, m.max_caption_len, m.max_pos_len, remat=True))

    summary = {"summary": {k: e["us_per_step"] for k, e in results.items()},
               "device": timing.device_name(dev)}
    if dev.type != "cuda":
        summary["roofline"] = timing.NO_SHARES
    print(json.dumps(summary))
    return {**summary, "pieces": results}


if __name__ == "__main__":
    main()
