"""Entry kind `caption_beam`: offline split captioning, one batch after
another, as `infer/evaluator.py::_batch_caller` calls the caption
function.

Set-up: the bf16 policy, the kernel library, weights drawn on the card
from the seed, the mix's pool of feature batches, and two warm calls (the
first captures the decode graphs). The window: f32 host arrays go to the
card, the two library calls of `make_beam_caption_fn(beam, max_pos_len,
max_len)` with its defaults run (`encode_for_inference`, then
`beam_search`; the function itself drops the best beam's score, which
the comparison reads), and the tokens, tags and scores come back to the
host; each call is timed from handing over its arrays to its outputs on
the host. A traced run puts CUDA-event spans around the two calls and
then profiles a few calls.

After the window: the peak memory is read, the program's state freed,
and a sample of the window's calls, drawn from the seed, is judged by the
plain reference (`reference/caption.py::judge`).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from benchmark import cost
from benchmark.harness import core, trace
from benchmark.reference import caption as ref_caption
from benchmark.reference import model as ref_model

PROFILE_CALLS = 4


def port_params(model: dict, weights: dict, device):
    """The port's `CaptionerParams` holding `weights` (the benchmark's draw)."""
    from controllable_xgating_torch.models.captioner import init_captioner
    from controllable_xgating_torch.utils.config import Config

    keys = ("app_dim", "motion_dim", "hidden_dim", "embed_dim", "attn_dim", "pos_embed_dim",
            "vocab_size", "pos_vocab_size", "num_frames", "max_caption_len", "max_pos_len",
            "dropout", "dtype", "decoder_hidden_mult")
    cfg = Config().replace_flat({f"model.{k}": model[k] for k in keys})
    params = init_captioner(cfg, seed=None, device=device)
    named = dict(params.named_parameters())
    if set(named) != set(weights):
        raise RuntimeError(f"parameter names differ: {sorted(set(named) ^ set(weights))}")
    with torch.no_grad():
        for name, p in named.items():
            if tuple(p.shape) != tuple(weights[name].shape):
                raise RuntimeError(f"{name}: {tuple(p.shape)} != {tuple(weights[name].shape)}")
            p.copy_(weights[name])
    return cfg, params


def caption_call(params, dec: dict, dev, spans=None, h2d_s=None):
    """The caption function's work on host arrays: (app, motion) ->
    (tokens [B, L], tags [B, Lp], scores [B]) on the host. `spans`, an
    `EventSpans`, times the two library calls and names the host's spans
    for a profile; `h2d_s` collects each input copy's seconds."""
    from controllable_xgating_torch.infer import beam as port_beam
    from controllable_xgating_torch.ops.dispatch import fused_enabled

    beam, max_len, max_pos = int(dec["beam_size"]), int(dec["max_len"]), int(dec["max_pos_len"])
    fused = fused_enabled(None)
    host = trace.span if spans is not None else (lambda name: contextlib.nullcontext())

    def timed(name, f):
        if spans is None:
            return f()
        tok = spans.start(name)
        out = f()
        spans.stop(tok)
        return out

    @torch.inference_mode()
    def call(app, motion):
        t = time.perf_counter()
        with host("h2d"):
            a, m = torch.as_tensor(app, device=dev), torch.as_tensor(motion, device=dev)
        if h2d_s is not None:
            h2d_s.append(time.perf_counter() - t)
        with host("encode"):
            c, s, tags = timed("encode", lambda: port_beam.encode_for_inference(
                params, a, m, None, max_pos_len=max_pos, fused=fused, early_stop=True))
        with host("decode"):
            tokens, scores = timed("decode", lambda: port_beam.beam_search(
                params.decoder, c, s, beam, max_len, 0.0, fused=fused, block_unk=False,
                early_stop=True, topk_mode="auto", return_all=False, diversity_groups=0,
                diversity_penalty=0.5))
        with host("d2h"):
            return tokens.cpu().numpy(), tags.cpu().numpy(), scores.cpu().numpy()

    return call


def run(ctx: dict) -> dict:
    from controllable_xgating_torch.infer import graphs
    from controllable_xgating_torch.ops.precision import set_compute_dtype

    cell, seed, dev = ctx["cell"], ctx["seed"], torch.device(ctx["device"])
    mcfg = cell["model_cfg"]
    model, dec = mcfg["model"], mcfg["decode"]
    beam, max_len, max_pos = int(dec["beam_size"]), int(dec["max_len"]), int(dec["max_pos_len"])
    set_compute_dtype(model["dtype"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        from controllable_xgating_torch.ops.kernels.build import library

        library()
    weight_seed = core.derive(seed, "weights")
    _, params = port_params(model, ref_model.make_weights(model, weight_seed, dev), dev)
    pool = core.traffic(cell).make(cell["traffic_cfg"], model, core.derive(seed, "traffic"))
    h2d_s = []
    spans = trace.EventSpans() if ctx["trace"] else None
    call = caption_call(params, dec, dev, spans, h2d_s)
    for _ in range(2):  # the first call captures the decode graphs
        call(*pool[0])
    if spans is not None:
        spans.ms()
        spans.clear()
    h2d_s.clear()

    lat, outs = [], []
    t_start_wall = time.time()
    t_start = time.perf_counter()
    deadline = t_start + float(ctx["seconds"])
    i = 0
    while True:
        t0 = time.perf_counter()
        out = call(*pool[i % len(pool)])
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        outs.append((i % len(pool), *out))
        i += 1
        if t1 >= deadline:
            break
    window_s = t1 - t_start
    core.check_imports("after the window")
    rec = {"setup_s": t_start_wall - ctx["t0"], "window_s": window_s, "calls": i,
           "videos": i * pool[0][0].shape[0], "call_s": lat, "trace": bool(ctx["trace"])}
    prof = None
    if ctx["trace"]:
        b = pool[0][0].shape[0]
        rec["spans_ms"] = spans.ms()
        rec["cost"] = {
            "decode_least_s": cost.least_seconds(
                cost.decode_step_cost(model, b, b * beam).scaled(max_len)),
            "call_flops": cost.beam_call_cost(model, b, beam, max_len, max_pos).flops,
            "peak_flops": cost.PEAKS["bfloat16"],
        }
        if dev.type == "cuda":
            prof = trace.profile(lambda: call(*pool[0]), PROFILE_CALLS)
            rec["profile"] = prof
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del params, call
    graphs.clear()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the comparison, on a sample of the window's calls drawn from the seed
    rng = np.random.default_rng(core.derive(seed, "sample"))
    picks = sorted(rng.choice(len(outs), min(int(cell["sample_calls"]), len(outs)), replace=False))
    cat = lambda j: np.concatenate([outs[p][j] for p in picks])
    app = np.concatenate([pool[outs[p][0]][0] for p in picks])
    motion = np.concatenate([pool[outs[p][0]][1] for p in picks])
    t_ref = time.perf_counter()
    weights = ref_model.make_weights(model, weight_seed, dev)
    got = ref_caption.judge(weights, app, motion, cat(2), cat(1), cat(3), beam)
    checks = {k: {"value": got[k], "limit": float(cell["limits"][k])} for k in cell["limits"]}
    return {"record": rec, "checks": checks,
            "correct": all(c["value"] <= c["limit"] for c in checks.values()),
            "attempted": i, "failed": 0, "memory_peak_bytes": int(peak), "profile": prof,
            "notes": {"call_ms_quartiles": [round(1e3 * float(q), 3)
                                            for q in np.quantile(lat, [0.25, 0.5, 0.75])],
                      "h2d_ms_median": round(1e3 * float(np.median(h2d_s)), 3),
                      "judged_videos": int(app.shape[0]), "judged_positions": got["positions"],
                      **{k: got[k] for k in ("caption_gap_mean", "beam_gap_mean", "beam_gap_max")},
                      "reference_s": time.perf_counter() - t_ref}}
