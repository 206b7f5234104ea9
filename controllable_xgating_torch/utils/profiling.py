"""Where the device time of a caption call or an XE train step goes, on
one CUDA card.

    python -m controllable_xgating_torch.utils.profiling [--out DIR]

At MSR-VTT width (`configs/msrvtt.json`, vocab 10000, 35 POS tags), random
weights from seed 0, bf16 policy, first through the kernels, then through
the plain path:
  caption: beam-5 and greedy over 256 videos, seeded features with every
    frame valid, early stop off so that every call runs all 28 steps; then
    the same two with the weight-only int8 vocab projection (`vocab_q`,
    the entry point of `tools/quant_ab.py`; beam takes the grouped tail);
    then beam-5 on the grouped tail (no top-K kernel), a two-member
    ensemble at beam 5 (seeds 0 and 1) and diverse beam 6 in 3 groups,
    the decode-science paths, which take the grouped selection;
  train: one joint-stage XE step (`make_xe_train_step`) on a batch of 64
    videos x 5 seeded captions of 27 words (no PAD), dropout 0.5, the
    batch already on the card; then one SCST step (`make_scst_train_step`)
    of each realization on 64 videos of the same features, with reward
    tables over 10000 videos x 20 seeded captions of 5-25 words, df over
    6513 (MSR-VTT's caption scale).
Each caption call runs twice: with its decode loops as replayed CUDA
graphs (the default on the card, `infer/graphs.py`), then as eager loops
(`set_decode_graphs(False)`, tagged `_eager`). For each, one warm-up
call, one call timed on the host clock (wall), then one call under
`torch.profiler`, which gives the device time (kernels, copies and sets
on the card; a replayed graph's kernels count only where the profiler
traces graph nodes, so the count of the port's kernels it saw is
printed), its ratio to the wall time (the device busy share), the copies
and casts (`aten::copy_`) with their device time, and the top ops by
device time; then the CUDA-event span of one call (from before its first
launch to after its last, idle gaps included). The Chrome traces go to
DIR.

The library half, for any caller: `profile_trace(logdir)`, the
`--profile LOGDIR` context of `cli.eval` and `cli.train` (counterpart of
the JAX package's `jax.profiler` trace): a `torch.profiler` trace of the
CPU, and of the card where there is one, written into LOGDIR as a
Chrome / TensorBoard trace (`*.pt.trace.json`); the profiler keeps every
event in memory until the span ends. `materialize` and `time_fn` time a
call to its results' completion on the device.

This module imports nothing at import time beyond torch; `main` runs only
where `torch.cuda.is_available()`.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
from typing import Callable

import numpy as np
import torch
from torch.utils._pytree import tree_flatten

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
B, T, K, MAX_LEN = 256, 26, 5, 28
VOCAB, POS_VOCAB = 10000, 35


@contextlib.contextmanager
def profile_trace(logdir):
    """`torch.profiler` trace of the enclosed span into `logdir` (CPU
    activity, and CUDA where a card is present; TensorBoard's
    `torch_tb_profiler` and chrome://tracing read it); a no-op when
    `logdir` is falsy."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


def materialize(tree) -> None:
    """Wait for every tensor of a pytree: its card synchronised, its
    values read to the host."""
    for leaf in tree_flatten(tree)[0]:
        if isinstance(leaf, torch.Tensor):
            if leaf.is_cuda:
                torch.cuda.synchronize(leaf.device)
            leaf.detach().cpu()


def time_fn(fn: Callable, *args, warmup: int = 1, iters: int = 5) -> dict:
    """Time fn(*args) steady-state, each call to its results' completion.
    Returns {mean_s, min_s, iters}."""
    for _ in range(warmup):
        materialize(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        materialize(fn(*args))
        times.append(time.perf_counter() - t0)
    return {"mean_s": float(np.mean(times)), "min_s": float(np.min(times)), "iters": iters}


def profile_call(fn, args) -> tuple:
    """(wall ms of one synchronised call, key averages, profiler) after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn(*args)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    return wall, prof.key_averages(), prof


def device_time_ms(key_averages) -> float:
    """Device time of the kernels, copies and sets in a profile. Only the
    device events count: an aten op also reports its kernels' time as its
    own, so summing every row would count those kernels twice."""
    from torch.autograd import DeviceType

    return sum(
        e.self_device_time_total for e in key_averages
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
    ) / 1e3


def call_device_ms(fn, args=()) -> dict:
    """One call of `fn(*args)` on the card, after a warm-up, read two ways:
    "profiler", the device time of the kernels, copies and sets in its
    profile (`device_time_ms`), with "kernels_seen", the launches of the
    port's own kernels the profile holds (the kernels of a replayed CUDA
    graph appear only where the profiler traces graph nodes); and
    "events", the span between CUDA events recorded on the current stream
    before and after the call, which also counts the time the card waited
    for the host between launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn(*args)
    end.record()
    torch.cuda.synchronize()
    events = start.elapsed_time(end)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    seen = sum(e.count for e in ka if e.device_type == DeviceType.CUDA and "cxg::" in e.key)
    return {"profiler": device_time_ms(ka), "kernels_seen": seen, "events": events}


def kernel_launch_us(fn, calls: int = 10) -> dict:
    """Device microseconds of every launch of the port's own CUDA kernels
    (namespace `cxg`, so not the casts or copies a wrapper makes) in
    `calls` calls of `fn` under `torch.profiler`, after one warm-up, by
    kernel name: one entry per kernel event the profiler kept. The
    profiler may keep fewer events than there were launches (8 of 10 on
    the card for the cross-entropy kernels), so a sum over them divided by
    `calls` under-reads. Where the kernel wrappers counted launches in the
    profiled calls but the profile kept no event of the port's kernels,
    the profile is taken once more; a kernel still without an event is
    absent from the result: not measured, never 0."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from controllable_xgating_torch.ops import kernels

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        before = sum(kernels.launch_counts().values())
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        launched = sum(kernels.launch_counts().values()) - before
        out = kept_kernel_events(prof.events(), DeviceType.CUDA)
        if out or not launched:
            break
    return out


def kept_kernel_events(events, device_type) -> dict:
    """{kernel name: [device us of each kept event]} of the port's own
    kernels (`cxg::`) among a profile's events."""
    out: dict = {}
    for e in events:
        if e.device_type == device_type and "cxg::" in e.name:
            out.setdefault(e.name.split("(")[0].replace("void ", ""), []).append(
                e.time_range.elapsed_us())
    return out


def kernel_device_split(fn, calls: int = 10) -> dict:
    """Device microseconds per call of `fn` in each of the port's own CUDA
    kernels, by kernel name: the median launch of `kernel_launch_us` times
    the launches a call makes (the events kept over `calls`, rounded, at
    least 1). A kernel the profiler kept no event of is absent."""
    return {name: sorted(us)[len(us) // 2] * max(1, round(len(us) / calls))
            for name, us in kernel_launch_us(fn, calls).items()}


def kernel_device_us(fn, calls: int = 10):
    """Device microseconds per call of `fn` in the port's own CUDA kernels,
    all of them together (`kernel_device_split`), or None (not measured)
    where the profiler kept none of their events."""
    split = kernel_device_split(fn, calls)
    return sum(split.values()) if split else None


def caption_calls(cfg, dev):
    """[(name, fn, args)] of the caption path; fn is built under the
    current kernel setting."""
    import numpy as np

    from controllable_xgating_torch.experiments.int8_vocab_matmul import quantize_vocab_proj
    from controllable_xgating_torch.infer.beam import make_beam_caption_fn
    from controllable_xgating_torch.infer.ensemble import make_ensemble_caption_fn
    from controllable_xgating_torch.infer.evaluator import make_greedy_caption_fn
    from controllable_xgating_torch.models.captioner import init_captioner
    from controllable_xgating_torch.tools.quant_ab import make_fn

    params = init_captioner(cfg, seed=0, device=dev)
    members = (params, init_captioner(cfg, seed=1, device=dev))
    vq = quantize_vocab_proj(params.decoder.w_out, params.decoder.b_out)
    rng = np.random.default_rng(0)
    feats = (
        torch.as_tensor(rng.normal(size=(B, T, cfg.model.app_dim)).astype(np.float32), device=dev),
        torch.as_tensor(rng.normal(size=(B, T, cfg.model.motion_dim)).astype(np.float32), device=dev),
        torch.ones(B, T, device=dev),
    )
    return [
        ("beam5", make_beam_caption_fn(K, MAX_LEN, MAX_LEN, early_stop=False), (params, *feats)),
        ("greedy", make_greedy_caption_fn(MAX_LEN, MAX_LEN, early_stop=False), (params, *feats)),
        ("beam5_int8", make_fn(cfg, True, vq), (params, *feats)),
        ("greedy_int8", make_fn(cfg, False, vq), (params, *feats)),
        ("beam5_grouped", make_beam_caption_fn(K, MAX_LEN, MAX_LEN, early_stop=False,
                                               topk_mode="grouped"), (params, *feats)),
        ("ensemble_beam5", make_ensemble_caption_fn(K, MAX_LEN, MAX_LEN, early_stop=False),
         (members, *feats)),
        ("diverse_beam6", make_beam_caption_fn(6, MAX_LEN, MAX_LEN, early_stop=False,
                                               diversity_groups=3), (params, *feats)),
    ]


def train_calls(cfg, dev):
    """[(name, step, (state, batch))]: one joint XE step and one SCST step
    of each realization, on batches already on the card."""
    import numpy as np

    from controllable_xgating_torch.models.captioner import init_captioner
    from controllable_xgating_torch.train.state import create_train_state, make_optimizer
    from controllable_xgating_torch.train.xe import make_xe_train_step

    rng = np.random.default_rng(0)
    b, k = cfg.data.batch_size, cfg.data.caps_per_video_train
    seqs = lambda vocab: np.concatenate([
        np.ones((b, k, 1)), rng.integers(4, vocab, (b, k, MAX_LEN - 2)), np.full((b, k, 1), 2)],
        axis=-1).astype(np.int32)
    put = lambda x: torch.as_tensor(x, device=dev)
    batch = {
        "app": put(rng.normal(size=(b, T, cfg.model.app_dim)).astype(np.float32)),
        "motion": put(rng.normal(size=(b, T, cfg.model.motion_dim)).astype(np.float32)),
        "caps": put(seqs(VOCAB)), "pos": put(seqs(POS_VOCAB)), "frame_mask": torch.ones(b, T, device=dev),
    }
    state = create_train_state(init_captioner(cfg, seed=0, device=dev), cfg)
    step = make_xe_train_step(make_optimizer(cfg, 100), cfg, "joint")
    calls = [("xe_step", step, (state, batch))]

    from controllable_xgating_torch.ops.cider_device import build_reward_tables
    from controllable_xgating_torch.train.scst import make_scst_train_step

    n, s = 10000, 20
    words = rng.integers(6, MAX_LEN - 1, (n, s))[..., None]
    caps = np.where(np.arange(MAX_LEN) <= words, rng.integers(4, VOCAB, (n, s, MAX_LEN)), 0)
    caps[..., 0] = 1
    np.put_along_axis(caps, words, 2, axis=-1)
    tables = build_reward_tables(caps, np.full(n, s), range(6513), device=dev)
    scst_batch = {k: batch[k] for k in ("app", "motion", "frame_mask")}
    scst_batch["video_indices"] = put(rng.choice(6513, b, replace=False))
    for paired in (False, True):
        c = cfg.replace_flat({"train.scst_paired_rollout": paired})
        state = create_train_state(init_captioner(c, seed=0, device=dev), c)
        step = make_scst_train_step(make_optimizer(c, 100, "scst"), c, tables)
        calls.append((f"scst_{'paired_' if paired else ''}step", step, (state, scst_batch)))
    return calls


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out", help="directory for the Chrome traces")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profiling: needs a CUDA device")

    from controllable_xgating_torch.ops.dispatch import set_decode_graphs, set_fused_kernels
    from controllable_xgating_torch.ops.precision import precision
    from controllable_xgating_torch.utils.config import load_config

    cfg = load_config(os.path.join(ROOT, "configs", "msrvtt.json"),
                      {"model.vocab_size": VOCAB, "model.pos_vocab_size": POS_VOCAB})
    dev = torch.device("cuda:0")
    os.makedirs(args.out, exist_ok=True)
    # the bf16 policy and the kernel setting are scoped to this call
    with precision("bfloat16"):
        try:
            for fused in (None, False):
                set_fused_kernels(fused)
                calls = [(n, fn, a, g) for n, fn, a in caption_calls(cfg, dev)
                         for g in (None, False)]
                calls += [(n, fn, a, None) for n, fn, a in train_calls(cfg, dev)]
                for name, fn, fn_args, graphs_on in calls:
                    set_decode_graphs(graphs_on)
                    wall, ka, prof = profile_call(fn, fn_args)
                    span = call_device_ms(fn, fn_args)
                    device_ms = device_time_ms(ka)
                    copies = [e for e in ka if e.key == "aten::copy_"]
                    tag = f"{name}_{'kernels' if fused is None else 'plain'}" + \
                        ("_eager" if graphs_on is False else "")
                    print(f"== {tag}: wall {wall:.2f} ms, device time {device_ms:.2f} ms "
                          f"(port kernels seen {span['kernels_seen']}), CUDA-event span "
                          f"{span['events']:.2f} ms, device busy share ~{device_ms / wall:.3f}, "
                          f"aten::copy_ {sum(e.count for e in copies)} calls "
                          f"{sum(e.self_device_time_total for e in copies) / 1e3:.2f} ms")
                    print(ka.table(sort_by="self_device_time_total", row_limit=14,
                                   max_name_column_width=60))
                    prof.export_chrome_trace(os.path.join(args.out, f"trace_{tag}.json"))
        finally:
            set_fused_kernels(None)
            set_decode_graphs(None)


if __name__ == "__main__":
    main()
