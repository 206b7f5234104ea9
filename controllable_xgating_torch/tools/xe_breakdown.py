"""XE train-step piece table.

Counterpart of the JAX package's `tools/xe_breakdown.py`, with its flags,
its pieces and its report keys and `--device` in place of `--platform`:
every forward piece timed by the harness of `utils/timing.py`
(`make_timed`: the sustained ms of repeated pieces, differenced over two
loop lengths, and the device ms of one under `torch.profiler`), the full
step by `time_train_sustained`, each beside its own roofline from
`utils/roofline.py`.

Pieces (B 256 videos x 5 captions = 1280 rows, L 28, V 10000, bf16 on the
card, dropout 0.5, remat on):

  encoder           `encode` on the [256, 26] streams (with dropout)
  pos_teacher       the POS generator teacher-forced ([1280, Lp])
  context           `make_decode_context` (keys, enc_proj)
  dec_fwd           `decoder_forward`: the hidden-state loop and the
                    hoisted vocab projection (logits [1280, 27, V])
  logits_matmul     the projection alone ([34560, Hd] @ [Hd, V])
  loss_lse          `masked_xe_loss` on fixed f32 logits
  loss_fwdbwd       its gradient with respect to the logits
  fwd_total         `xe_losses` (everything above, the step's code)
  step_total        the whole train step: forward, backward, Adam

Routing: the rows above take the plain row statistics of the loss (the
JAX package's default there); `loss_lse_KERNEL`, `loss_fwdbwd_KERNEL` and
`step_total_KERNEL` take the cross-entropy kernels (K5, `csrc/xent.cu`),
which are the port's default (`train/xe.py`: under `fused_enabled()` at
V >= 2048). The routing is set with `ops/dispatch.py::set_fused_kernels`
and restored on exit. Derived rows: dec_scan = dec_fwd - logits_matmul,
bwd+opt = step_total - fwd_total, fwd_unattributed = fwd_total - the
forward pieces.

    python -m controllable_xgating_torch.tools.xe_breakdown [--batch 256]
        [--reps 2,8] [--device cuda|cpu]

Without a CUDA device it exits 1 unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import torch

K = 5
ROUTING = {
    "rows": "plain row statistics (the JAX package's default)",
    "_KERNEL rows": "K5, csrc/xent.cu",
    "port_default": "K5 under fused_enabled() at V >= 2048 (train/xe.py)",
}


@contextlib.contextmanager
def routed(kernels: bool):
    """The loss's row statistics through K5 (`kernels`) or plain, for the
    span; the process's setting as it was afterwards."""
    from controllable_xgating_torch.ops.dispatch import fused_setting, set_fused_kernels

    saved = fused_setting()
    set_fused_kernels(None if kernels else False)
    try:
        yield
    finally:
        set_fused_kernels(saved)


def _fold(x: torch.Tensor) -> torch.Tensor:
    return (x.sum() % 7).float() * 1e-6


def loss_grad(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """d masked_xe_loss / d logits."""
    from controllable_xgating_torch.train.xe import masked_xe_loss

    with torch.enable_grad():
        x = logits.detach().requires_grad_(True)
        return torch.autograd.grad(masked_xe_loss(x, targets), x)[0]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--reps", default="2,8")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where to run (default: the card; cpu only when asked)")
    args = p.parse_args(argv)

    from controllable_xgating_torch.cli.common import runtime_device
    from controllable_xgating_torch.models.decoder import decoder_forward, make_decode_context
    from controllable_xgating_torch.models.encoder import encode
    from controllable_xgating_torch.models.pos_generator import pos_forward
    from controllable_xgating_torch.ops.precision import mm, precision
    from controllable_xgating_torch.train.state import create_train_state, make_optimizer
    from controllable_xgating_torch.train.xe import make_xe_train_step, masked_xe_loss, xe_losses
    from controllable_xgating_torch.utils import roofline, timing
    from controllable_xgating_torch.utils.config import Config

    dev, dtype = runtime_device(args.device, None, Config())
    reps = tuple(int(x) for x in args.reps.split(","))
    b = args.batch
    rows = b * K
    timings: dict = {}
    detail: dict = {}
    timed = timing.make_timed(timings, dev, reps=reps, tag="xe", detail=detail)
    report: dict = {"batch": b, "k": K, "rows": rows, "device": timing.device_name(dev),
                    "compute_dtype": dtype, "routing": ROUTING, "pieces": {}}

    def record(name, cost=None, ms=None):
        report["pieces"][name] = timing.piece(timings[name] if ms is None else ms,
                                              detail[name], cost, dev, dtype)

    with precision(dtype):
        cfg, params = timing.build({"model.dropout": 0.5}, device=dev)
        cfg = cfg.replace_flat({"train.remat": True})
        m = cfg.model
        L, Lp, v = m.max_caption_len, m.max_pos_len, m.vocab_size
        report.update(len=L, vocab=v)
        batch = {k: timing.put(x, dev) for k, x in timing.bench_train_batch(cfg, b, K).items()}
        app, mot = batch["app"], batch["motion"]
        caps_flat, pos_flat = batch["caps"].reshape(rows, L), batch["pos"].reshape(rows, -1)
        gen = torch.Generator(device=dev).manual_seed(0)

        with routed(False):
            # ---- forward pieces ----
            timed("encoder", lambda c: _fold(encode(params.encoder, app + c, mot, gen=gen,
                                                    dropout_rate=0.5)[0]))
            record("encoder", roofline.encode_cost(m, b))
            with torch.no_grad():
                enc_out, summary = encode(params.encoder, app, mot, gen=gen, dropout_rate=0.5)
                summary_k = summary.repeat_interleave(K, 0)
                enc_out_k = enc_out.repeat_interleave(K, 0)
                _, psi = pos_forward(params.pos, summary_k, pos_flat)
                ctx = make_decode_context(params.decoder, enc_out_k, psi)
            timed("pos_teacher", lambda c: _fold(pos_forward(params.pos, summary_k + c,
                                                             pos_flat)[0]))
            record("pos_teacher", roofline.pos_step_cost(m, rows).scaled(Lp - 1))
            timed("context", lambda c: _fold(make_decode_context(params.decoder, enc_out_k + c,
                                                                 psi).keys))
            record("context", roofline.context_cost(m, rows))
            timed("dec_fwd", lambda c: _fold(decoder_forward(
                params.decoder, ctx, summary_k + c, caps_flat, gen, 0.5, remat=True)))
            record("dec_fwd", roofline.decode_step_cost(m, rows).scaled(L - 1))

            g = torch.Generator(device=dev).manual_seed(1)
            hs = torch.randn((rows * (L - 1), m.hidden_dim), generator=g, device=dev)
            timed("logits_matmul", lambda c: _fold(mm(hs + c, params.decoder.w_out)))
            record("logits_matmul", roofline.Cost(2 * rows * (L - 1) * m.hidden_dim * v,
                                                  m.hidden_dim * v * 2 + rows * (L - 1) * v * 4))

        logits_fix = torch.randn((rows, L - 1, v), generator=g, device=dev)
        targets = caps_flat[:, 1:]
        lse_cost = roofline.Cost(0, rows * (L - 1) * v * 4)
        grad_cost = roofline.Cost(0, 3 * rows * (L - 1) * v * 4)  # read x twice, write dx
        fwd_cost = roofline.xe_step_cost(m, b, K, L, Lp).scaled(1 / 3.0)
        step_cost = roofline.xe_step_cost(m, b, K, L, Lp, remat=True)
        state = create_train_state(params, cfg)
        tx = make_optimizer(cfg, 100)

        def fwd_body(c):
            cap_l, pos_l = xe_losses(params, {**batch, "app": app + c}, gen, 0.5, remat=True)
            return (cap_l + pos_l) * 1e-9

        def step_total(name):
            step = make_xe_train_step(tx, cfg, "joint")
            copy = timing.copy_train_state(state)
            ms = timing.time_train_sustained(step, state, batch, dev) * 1e3
            detail[name] = timing.device_detail(lambda: step(copy, batch), dev)
            record(name, step_cost, ms)

        for suffix, kernels in (("", False), ("_KERNEL", True)):
            with routed(kernels):
                timed("loss_lse" + suffix, lambda c: masked_xe_loss(logits_fix + c, targets) * 1e-6)
                record("loss_lse" + suffix, lse_cost)
                timed("loss_fwdbwd" + suffix, lambda c: _fold(loss_grad(logits_fix + c, targets)))
                record("loss_fwdbwd" + suffix, grad_cost)
                if not kernels:
                    timed("fwd_total", fwd_body)
                    record("fwd_total", fwd_cost)
                step_total("step_total" + suffix)

    pieces = report["pieces"]
    pieces["dec_scan (derived)"] = {
        "ms": round(pieces["dec_fwd"]["ms"] - pieces["logits_matmul"]["ms"], 3)}
    pieces["bwd+opt (derived)"] = {
        "ms": round(pieces["step_total"]["ms"] - pieces["fwd_total"]["ms"], 3)}
    accounted = sum(pieces[n]["ms"] for n in
                    ("encoder", "pos_teacher", "context", "dec_fwd", "loss_lse"))
    pieces["fwd_unattributed (derived)"] = {"ms": round(pieces["fwd_total"]["ms"] - accounted, 3)}
    if dev.type != "cuda":
        report["roofline"] = timing.NO_SHARES
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
