"""The timing harness of the measurement tools (`tools/*_breakdown.py`,
`tools/*_bench.py`, `tools/beam_topk_ab.py`, `tools/profile_beam_step.py`,
`tools/cider_piece_timing.py`, `tools/trace_ops.py`).

Counterpart of the helpers of the root `bench.py` that the JAX tools
import (its constants, `_stats`, `repeat_measure`, `build`, `make_fn`,
`random_batch`, `_bench_train_batch`, `_diff_time`, `make_timed`,
`make_caption_measure`, `time_caption_sustained`,
`time_train_sustained`), and of nothing else of it: the benchmark's
`main`, its cells and its JSON keys are not here.

What "sustained" means on the card. On the TPU, `bench.py` timed R
repetitions of a workload inside one jitted loop; the dispatch was
outside the loop, so the difference of two loop lengths was device time.
On the card the host launches every kernel, or replays every graph, of
every repetition. The same differencing, (t[R_hi] - t[R_lo]) / (R_hi -
R_lo) with the best of 3 trials per length, therefore measures what a
pipelined loop sustains: about max(host enqueue, device). That number
keeps the JAX tool's key (`ms`, `us_per_step`, `captions_per_sec`).
Beside it, `make_timed` and the tools give each piece's `device_ms`: the
device time of one repetition under `torch.profiler`
(`utils/profiling.py::call_device_ms`), with the port's kernel events
the profile kept and the launches the wrappers counted in that
repetition, so that a reader can tell host-bound pieces from
device-bound ones. Where the profile kept fewer kernel events than there
were launches (the kernels of a replayed graph are not always traced),
the device time reads short and says so (`events_complete`).

Inside a repetition nothing syncs the host: no `.item()`, no `.cpu()`,
no `bool()` of a device tensor. The carry that feeds the next
repetition, `(toks.sum() % 7) * 1e-6` added to the input, stays a device
tensor; the host waits once, after the last repetition. The JAX tools'
`fori` and `scan` forms are one Python loop here: nothing is compiled
per loop length. The first call of each length is a warm-up: it builds
the kernels and captures the decode graphs (`infer/graphs.py`), as the
JAX warm-up compiled. The decode calls replay graphs, as the CLIs' do.

This module imports torch and numpy only; nothing runs at import.
"""

from __future__ import annotations

import copy
import os
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from controllable_xgating_torch.models.captioner import init_captioner
from controllable_xgating_torch.utils.config import Config
from controllable_xgating_torch.utils.profiling import materialize as fence

BATCH = 256  # beam sweet spot: B*K = 1280 decoder rows
BEAM = 5
MAX_LEN = 28
FRAMES = 26
# each throughput is measured this many times (one warm-up, n timings) and
# reported as a mean with its sigma
REPEATS = int(os.environ.get("CXG_BENCH_REPEATS", "5"))


def _stats(samples: list[float]) -> dict:
    a = np.asarray(samples, np.float64)
    return {
        "mean": round(float(a.mean()), 1),
        "sigma": round(float(a.std(ddof=1)) if a.size > 1 else 0.0, 1),
        "n": int(a.size),
        "min": round(float(a.min()), 1),
        "max": round(float(a.max()), 1),
    }


def repeat_measure(measure: Callable[[], float], n: Optional[int] = None) -> tuple[float, dict]:
    """Run a throughput measurement n times (REPEATS by default): (mean,
    stats). The first call pays the kernel build and the graph captures;
    every call re-times the same warmed work, so sigma is the timing's
    reproducibility at fixed code."""
    n = REPEATS if n is None else n
    st = _stats([float(measure()) for _ in range(max(n, 1))])
    return st["mean"], st


def build(cfg_overrides=None, device="cuda"):
    """(cfg, params): the default config at vocab 10000 and 35 POS tags
    (MSR-VTT width: app 1536, motion 1024, hidden 512, 26 frames), random
    weights from seed 0 on `device`."""
    cfg = Config().replace_flat({
        "model.vocab_size": 10000,
        "model.pos_vocab_size": 35,
        **(cfg_overrides or {}),
    })
    return cfg, init_captioner(cfg, seed=0, device=device)


def make_fn(cfg, fused: Optional[bool] = None, topk_mode: str = "auto"):
    """Beam-5 caption function of the benchmark: (params, app, motion) ->
    (tokens, tags), early stop off (random weights never emit EOS, so every
    call runs all 28 steps)."""
    from controllable_xgating_torch.infer.beam import make_beam_caption_fn

    return make_beam_caption_fn(BEAM, cfg.model.max_pos_len, MAX_LEN, fused=fused,
                                early_stop=False, topk_mode=topk_mode)


def random_batch(cfg, batch: int, seed: int = 0):
    """(app, motion) f32 numpy draws, bit for bit `bench.random_batch`'s."""
    rng = np.random.default_rng(seed)
    app = rng.normal(size=(batch, FRAMES, cfg.model.app_dim)).astype(np.float32)
    mot = rng.normal(size=(batch, FRAMES, cfg.model.motion_dim)).astype(np.float32)
    return app, mot


def bench_train_batch(cfg, batch: int, k: int, seed: int = 7) -> dict:
    """A train batch of numpy arrays (app, motion, caps [B, k, L], pos),
    bit for bit `bench._bench_train_batch`'s: BOS, random words, EOS."""
    rng = np.random.default_rng(seed)
    m = cfg.model
    length = m.max_caption_len
    caps = np.zeros((batch, k, length), np.int32)
    caps[:, :, 0] = 1
    caps[:, :, 1:-1] = rng.integers(4, m.vocab_size, (batch, k, length - 2))
    caps[:, :, -1] = 2
    pos = np.zeros((batch, k, length), np.int32)
    pos[:, :, 0] = 1
    pos[:, :, 1:-1] = rng.integers(4, m.pos_vocab_size, (batch, k, length - 2))
    pos[:, :, -1] = 2
    return {
        "app": rng.normal(size=(batch, FRAMES, m.app_dim)).astype(np.float32),
        "motion": rng.normal(size=(batch, FRAMES, m.motion_dim)).astype(np.float32),
        "caps": caps,
        "pos": pos,
    }


def device_name(device) -> str:
    """The card's name as `torch.cuda.get_device_name` gives it, or "cpu"."""
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


NO_SHARES = "none: utils/roofline.py has no published peaks for the CPU"


def roofline_share(cost, seconds: float, device, dtype: str = "bfloat16"):
    """`roofline.utilization` of `cost` done in `seconds` on the card, or
    None off it (`NO_SHARES`)."""
    if torch.device(device).type != "cuda":
        return None
    from controllable_xgating_torch.utils import roofline

    return roofline.utilization(cost, seconds, device_name(device), dtype)


def piece(ms: float, detail: dict, cost, device, dtype: str, ndigits: int = 3) -> dict:
    """A piece's row: `ms` (sustained), its `device_detail`, and on the
    card the roofline shares of `cost` on `ms` and, under `on_device`, on
    the device ms."""
    row = {"ms": round(ms, ndigits), **detail}
    if cost is not None and torch.device(device).type == "cuda":
        row.update(roofline_share(cost, ms / 1e3, device, dtype))
        if detail.get("device_ms"):
            row["on_device"] = roofline_share(cost, detail["device_ms"] / 1e3, device, dtype)
    return row


def diff_time(run: Callable[[int], object], reps, trials: int = 3,
              times: Optional[dict] = None) -> float:
    """Seconds per repetition by loop-length differencing (module
    docstring): `run(n)` does the work n times and returns what to fence.
    Each length is warmed once, then timed `trials` times; the best trial
    of each length counts, and lands in `times[n]` where given."""
    ts = {} if times is None else times
    for n in reps:
        fence(run(n))  # builds, captures
        best = float("inf")
        for _ in range(trials):
            t0 = time.perf_counter()
            fence(run(n))
            best = min(best, time.perf_counter() - t0)
        ts[n] = best
    lo, hi = min(reps), max(reps)
    return max((ts[hi] - ts[lo]) / (hi - lo), 1e-9)


def put(x, device):
    """numpy arrays and tensors onto `device`; anything else (modules,
    reward tables, contexts) as it is: the caller made it there."""
    if isinstance(x, np.ndarray):
        return torch.as_tensor(x, device=device)
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return x


def repeat_loop(make_body: Callable, args: tuple, device) -> Callable[[int], torch.Tensor]:
    """`run(n)`: n repetitions of `make_body(carry, *args)` on a device f32
    carry, without gradient (a body that needs one enables it itself);
    returns the last carry."""

    def run(n: int) -> torch.Tensor:
        with torch.no_grad():
            c = torch.zeros((), dtype=torch.float32, device=device)
            for _ in range(n):
                c = make_body(c, *args)
            return c

    return run


def device_detail(fn: Callable[[], object], device) -> dict:
    """One call of `fn` on the card (`profiling.call_device_ms`): its
    device ms by the profiler, the port's kernel events it kept and the
    launches the wrappers counted, by kernel; on the CPU only the
    launches (none: a wrapper counts its kernel's launches) and no device
    time ("not measured")."""
    if torch.device(device).type != "cuda":
        return {"device_ms": None, "launches": {}, "kernel_events": {}, "events_complete": False}
    from controllable_xgating_torch.utils.profiling import call_device_ms

    d = call_device_ms(fn)
    device_ms = round(d["profiler"], 4) if d["profiler"] > 0 else None  # no event kept
    return {"device_ms": device_ms, "launches": d["launches"],
            "kernel_events": d["kernel_events"], "events_complete": d["events_complete"]}


def make_timed(timings: dict, device=None, reps=(2, 8), tag: str = "timed", ndigits: int = 3,
               detail: Optional[dict] = None):
    """The micro-timing harness of the piece tools. Returns
    `timed(name, make_body, *args)`: moves numpy arrays and tensors in
    `args` to `device`, repeats `make_body(carry, *args)` on a device f32
    carry, records the loop-length-differenced ms per call into
    `timings[name]` and prints `[tag] name: x ms` on stderr; with a
    `detail` dict, also `detail[name] = device_detail(one repetition)`.
    The body must fold a data-dependent function of the carry into its
    inputs and return a device f32 scalar for the next carry, and must not
    read a device value on the host."""
    device = torch.device(device if device is not None else "cuda")

    def timed(name: str, make_body: Callable, *args) -> float:
        args = tuple(put(a, device) for a in args)
        run = repeat_loop(make_body, args, device)
        per = diff_time(run, reps)
        timings[name] = round(per * 1e3, ndigits)
        print(f"[{tag}] {name}: {per * 1e3:.{ndigits}f} ms", file=sys.stderr, flush=True)
        if detail is not None:
            detail[name] = device_detail(lambda: run(1), device)
        return per

    return timed


def make_caption_measure(fn, params, batch, device, reps=(2, 10)):
    """Zero-arg closure -> sustained captions/s of a (params, app, motion)
    -> (tokens, tags) caption function: n back-to-back calls, each input
    perturbed by the previous call's tokens so that no call can be skipped
    or merged, differenced over two loop lengths (module docstring).
    `repeat_measure` re-times it on the warmed graphs. `batch` is (app,
    motion) numpy arrays or tensors."""
    app, mot = (put(x, device) for x in batch)
    run = caption_loop(fn, params, app, mot)
    return lambda: app.shape[0] / diff_time(run, reps)


def caption_loop(fn, params, app: torch.Tensor, mot: torch.Tensor) -> Callable[[int], torch.Tensor]:
    """`run(n)`: n caption calls, every token of each feeding the next
    call's input perturbation; returns the last carry."""

    def run(n: int) -> torch.Tensor:
        c = torch.zeros((), dtype=torch.float32, device=app.device)
        for _ in range(n):
            toks = fn(params, app + c, mot)[0]
            c = (toks.sum() % 7).float() * 1e-6
        return c

    return run


def time_caption_sustained(fn, params, batch, device, reps=(2, 10)) -> float:
    """Sustained captions/s of a caption function (`make_caption_measure`,
    measured once). The JAX harness's `form` ("fori" / "scan") chose how
    the loop compiled; here both are the one Python loop."""
    return make_caption_measure(fn, params, batch, device, reps)()


def copy_train_state(state):
    """A train state of its own: parameters, Adam moments, step and
    generator copied, so that steps on it leave `state` as it was."""
    from controllable_xgating_torch.train.state import TrainState, init_adam

    params = copy.deepcopy(state.params)
    opt = init_adam(params)
    opt.load_state_dict(copy.deepcopy(state.opt_state.state_dict()))
    gen = torch.Generator(device=state.gen.device)
    gen.set_state(state.gen.get_state())
    return TrainState(params=params, opt_state=opt, step=state.step, gen=gen)


def time_train_sustained(step_fn, state, batch, device, steps: int = 12) -> float:
    """Seconds per train step: one warm-up step, then `steps` dependent
    steps (each on the state the last one left, as a prefetched train
    loop runs them) enqueued without a wait and fenced once on the last
    loss. The steps run on a copy of `state` (`copy_train_state`): the
    port's step updates its state in place, and the caller's is left as
    it was. `batch` is moved to `device` once, before the steps."""
    s = copy_train_state(state)
    batch = {k: put(v, device) for k, v in batch.items()}
    _, m = step_fn(s, batch)
    fence(m["loss"])
    t0 = time.perf_counter()
    for _ in range(steps):
        s, m = step_fn(s, batch)
    fence(m["loss"])
    return (time.perf_counter() - t0) / steps
