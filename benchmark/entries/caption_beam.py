"""Entry kind `caption_beam`: offline split captioning, one batch after
another, through the program's own batch caller
(`infer/evaluator.py::batch_caller`, `_batch_caller` before it was
public), as `evaluate_split` and `cli/eval.py` caption a split.

Set-up: the bf16 policy, the kernel library, weights drawn on the card
from the seed, the mix's pool of feature batches, and two warm calls (the
first captures the graphs). The window: each call hands the pool's f32
host arrays (no frame mask) to the batch caller, which puts them on the
card and calls the caption function: the two library calls of
`make_beam_caption_fn(beam, max_pos_len, max_len)` with its defaults
(`encode_for_inference`, then `beam_search`; the function itself drops
the best beam's score, which the comparison reads). The tokens, tags and
scores come back with `.cpu().numpy()`; each call is timed from handing
over its arrays to its outputs on the host.

A traced run puts CUDA-event spans around the two library calls, collects
the program's own spans (`utils/spans.py`: one collector for the set-up,
one for the window, each call one `request()`) and keeps both summaries
under `record["program"]`, then profiles a few calls. An untraced run
installs no collector.

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


def caption_call(params, dec: dict, batch_size: int, spans=None):
    """The caption call on host arrays: (app, motion) -> (tokens [B, L],
    tags [B, Lp], scores [B]) on the host, through the program's batch
    caller. `spans`, an `EventSpans`, times the two library calls and names
    the host's spans for a profile; each call is one `request()` of the
    program's spans (a null context while no collector is installed)."""
    from controllable_xgating_torch.infer import beam as port_beam
    from controllable_xgating_torch.infer import evaluator
    from controllable_xgating_torch.ops.dispatch import fused_enabled
    from controllable_xgating_torch.utils import spans as port_spans

    # public as `batch_caller` once the program names it so
    batch_caller = getattr(evaluator, "batch_caller", None) or evaluator._batch_caller
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
    def caption_fn(params, app, motion, frame_mask=None):
        with host("encode"):
            c, s, tags = timed("encode", lambda: port_beam.encode_for_inference(
                params, app, motion, frame_mask, max_pos_len=max_pos, fused=fused,
                early_stop=True))
        with host("decode"):
            tokens, scores = timed("decode", lambda: port_beam.beam_search(
                params.decoder, c, s, beam, max_len, 0.0, fused=fused, block_unk=False,
                early_stop=True, topk_mode="auto", return_all=False, diversity_groups=0,
                diversity_penalty=0.5))
        return tokens, tags, scores

    caller = batch_caller(params, caption_fn, batch_size, None)  # one device, no mesh

    def call(app, motion):
        with port_spans.request(), host("call"):
            tokens, tags, scores = caller(app, motion, None)
            with host("d2h"):
                return tokens.cpu().numpy(), tags.cpu().numpy(), scores.cpu().numpy()

    return call


def _per_call(summary: dict) -> dict:
    """{span: [host ms, device ms or None]} per request of a spans summary."""
    n = max(summary["requests"], 1)
    return {k: [round(d["host_ms"] / n, 3),
                None if d["device_ms"] is None else round(d["device_ms"] / n, 3)]
            for k, d in summary["spans"].items()}


def run(ctx: dict) -> dict:
    from controllable_xgating_torch.infer import graphs
    from controllable_xgating_torch.ops.precision import set_compute_dtype
    from controllable_xgating_torch.utils import spans as port_spans

    cell, seed, dev = ctx["cell"], ctx["seed"], torch.device(ctx["device"])
    mcfg = cell["model_cfg"]
    model, dec = mcfg["model"], mcfg["decode"]
    beam, max_len, max_pos = int(dec["beam_size"]), int(dec["max_len"]), int(dec["max_pos_len"])
    # a traced run keeps the program's spans: the set-up's, then the window's
    program = port_spans.collect() if ctx["trace"] else None
    set_compute_dtype(model["dtype"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        from controllable_xgating_torch.ops.kernels.build import library

        library()
    weight_seed = core.derive(seed, "weights")
    _, params = port_params(model, ref_model.make_weights(model, weight_seed, dev), dev)
    pool = core.traffic(cell).make(cell["traffic_cfg"], model, core.derive(seed, "traffic"))
    spans = trace.EventSpans() if ctx["trace"] and dev.type == "cuda" else None
    call = caption_call(params, dec, pool[0][0].shape[0], spans)
    for _ in range(2):  # the first call captures the graphs
        call(*pool[0])
    if spans is not None:
        spans.ms()
        spans.clear()
    if program is not None:
        setup_spans = program.summary()
        program.close()
        program = port_spans.collect()

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
    if program is not None:
        program.close()  # the profiled calls below run as an untraced call does
    core.check_imports("after the window")
    rec = {"setup_s": t_start_wall - ctx["t0"], "window_s": window_s, "calls": i,
           "videos": i * pool[0][0].shape[0], "call_s": lat, "trace": bool(ctx["trace"])}
    prof = None
    if ctx["trace"]:
        b = pool[0][0].shape[0]
        rec["program"] = {"setup": setup_spans, "window": program.summary()}
        if spans is not None:
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
                      "judged_videos": int(app.shape[0]), "judged_positions": got["positions"],
                      **{k: got[k] for k in ("caption_gap_mean", "beam_gap_mean", "beam_gap_max")},
                      "reference_s": time.perf_counter() - t_ref,
                      **({"program_ms": _per_call(rec["program"]["window"])}
                         if "program" in rec else {})}}
