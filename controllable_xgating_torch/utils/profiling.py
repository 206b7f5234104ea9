"""Where the device time of a caption call or an XE train step goes, on
one CUDA card.

    python -m controllable_xgating_torch.utils.profiling [--out DIR]

At MSR-VTT width (`configs/msrvtt.json`, vocab 10000, 35 POS tags), random
weights from seed 0, bf16 policy, first through the kernels, then through
the plain path:
  caption: beam-5 and greedy over 256 videos, seeded features with every
    frame valid, early stop off so that every call runs all 28 steps;
  train: one joint-stage XE step (`make_xe_train_step`) on a batch of 64
    videos x 5 seeded captions of 27 words (no PAD), dropout 0.5, the
    batch already on the card.
For each, one warm-up call, one call timed on the host clock (wall), then
one call under `torch.profiler`, which gives the device time (kernels,
copies and sets on the card), its ratio to the wall time (the device busy
share), the copies and casts (`aten::copy_`) with their device time, and
the top ops by device time. The Chrome traces go to DIR (default
`chiprun_out/`).

This module imports nothing at import time beyond torch; it runs only
where `torch.cuda.is_available()`.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
B, T, K, MAX_LEN = 256, 26, 5, 28
VOCAB, POS_VOCAB = 10000, 35


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


def caption_calls(cfg, dev):
    """[(name, fn, args)] of the caption path; fn is built under the
    current kernel setting."""
    import numpy as np

    from controllable_xgating_torch.infer.beam import make_beam_caption_fn
    from controllable_xgating_torch.infer.evaluator import make_greedy_caption_fn
    from controllable_xgating_torch.models.captioner import init_captioner

    params = init_captioner(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    feats = (
        torch.as_tensor(rng.normal(size=(B, T, cfg.model.app_dim)).astype(np.float32), device=dev),
        torch.as_tensor(rng.normal(size=(B, T, cfg.model.motion_dim)).astype(np.float32), device=dev),
        torch.ones(B, T, device=dev),
    )
    return [
        ("beam5", make_beam_caption_fn(K, MAX_LEN, MAX_LEN, early_stop=False), (params, *feats)),
        ("greedy", make_greedy_caption_fn(MAX_LEN, MAX_LEN, early_stop=False), (params, *feats)),
    ]


def train_calls(cfg, dev):
    """[("xe_step", step, (state, batch))]: one joint XE step on a batch
    already on the card."""
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
    return [("xe_step", step, (state, batch))]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out", help="directory for the Chrome traces")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profiling: needs a CUDA device")

    from controllable_xgating_torch.ops.dispatch import set_fused_kernels
    from controllable_xgating_torch.ops.precision import set_compute_dtype
    from controllable_xgating_torch.utils.config import load_config

    cfg = load_config(os.path.join(ROOT, "configs", "msrvtt.json"),
                      {"model.vocab_size": VOCAB, "model.pos_vocab_size": POS_VOCAB})
    dev = torch.device("cuda:0")
    set_compute_dtype("bfloat16")
    os.makedirs(args.out, exist_ok=True)
    try:
        for fused in (None, False):
            set_fused_kernels(fused)
            for name, fn, fn_args in caption_calls(cfg, dev) + train_calls(cfg, dev):
                wall, ka, prof = profile_call(fn, fn_args)
                device_ms = device_time_ms(ka)
                copies = [e for e in ka if e.key == "aten::copy_"]
                tag = f"{name}_{'kernels' if fused is None else 'plain'}"
                print(f"== {tag}: wall {wall:.2f} ms, device time {device_ms:.2f} ms, "
                      f"device busy share ~{device_ms / wall:.3f}, "
                      f"aten::copy_ {sum(e.count for e in copies)} calls "
                      f"{sum(e.self_device_time_total for e in copies) / 1e3:.2f} ms")
                print(ka.table(sort_by="self_device_time_total", row_limit=14,
                               max_name_column_width=60))
                prof.export_chrome_trace(os.path.join(args.out, f"trace_{tag}.json"))
    finally:
        set_fused_kernels(None)


if __name__ == "__main__":
    main()
