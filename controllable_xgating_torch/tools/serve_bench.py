"""Serving-engine load test: latency and throughput against offered load.

Counterpart of the JAX package's `tools/serve_bench.py`, with its flags,
its warm-up and its JSON lines and `--device` in place of `--platform`.
It builds the port's `serve/engine.py::ServingEngine` at MSR-VTT width
(vocab 9996 words + 4 specials, 8 POS tags, random weights from seed 0;
`--ensemble M`: members from seeds 0 .. M-1; bf16 on the card, as the
CLIs) and drives it with open-loop Poisson arrivals: requests arrive on
their own schedule whether or not the engine keeps up, so queueing shows
in the latency (a closed loop throttles itself and hides it).

For each offered rate it prints one JSON line: achieved requests/s, n,
rejected, p50 / p99 end-to-end latency, the mean bucket a request rode,
under `--deadline_ms` the deadline, `expired` and `late_completions`,
and a subset of the engine's counters (`engine_stats`). Before each
point three rounds of full largest-bucket batches settle the pipeline; a
round that stalls (180 s for the first, 60 s after) prints an "abort"
event, cancels its requests and exits 3, cleanly, with the engine
closed.

    python -m controllable_xgating_torch.tools.serve_bench --mode beam \\
        --rates 50,200,1000,4000 [--duration 10] [--deadline_ms 200] [--device cpu]

Without a CUDA device it exits 1 unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import time
from concurrent.futures import TimeoutError as FutureTimeoutError

import numpy as np

WORDS = [f"w{i}" for i in range(9996)]
TAGS = ["DT", "NN", "VBZ", "VBG", "IN", "JJ", "NNS", "EX"]
STATS_KEYS = ("cancelled", "deadline_expired", "deadline_shed_predicted", "rejected",
              "deadline_completed", "late_completions", "shed_margin_live")


def build_engine(mode: str, buckets, max_wait_ms: float, max_queue: int = 0,
                 shed_margin: float = 1.0, adaptive_margin: bool = False,
                 n_members: int = 0, nbest: int = 0, device="cuda"):
    """The engine on `device` under the current compute policy (which it
    keeps for its life); its parameters from `utils/timing.py::build`."""
    from controllable_xgating_torch.data.vocab import Vocab
    from controllable_xgating_torch.infer.ensemble import stack_params
    from controllable_xgating_torch.models.captioner import init_captioner
    from controllable_xgating_torch.serve.engine import ServingEngine
    from controllable_xgating_torch.utils import timing

    cfg, params = timing.build({"model.vocab_size": 4 + len(WORDS),
                                "model.pos_vocab_size": 4 + len(TAGS)}, device=device)
    if n_members:
        n_members = max(n_members, 2)  # an ensemble needs two members
        params = stack_params([params] + [init_captioner(cfg, seed=i, device=device)
                                          for i in range(1, n_members)])
    return ServingEngine(
        params, cfg, Vocab(WORDS), Vocab(TAGS), mode=mode, buckets=buckets,
        max_wait_ms=max_wait_ms, max_queue=max_queue, shed_margin=shed_margin,
        adaptive_margin=adaptive_margin, n_members=n_members, nbest=nbest,
    )


def run_load_point(engine, rate_rps: float, duration_s: float, rng,
                   deadline_ms: float | None = None) -> dict:
    """Open-loop Poisson arrivals at `rate_rps` for `duration_s`.

    `deadline_ms` plays impatient clients: every request carries that
    queue deadline, and the point reports how many were shed unserved
    (`expired`) and how many completed after the client stopped waiting
    (`late_completions`: wasted device work). Every request is one video
    of the engine's model widths drawn from `rng`."""
    from controllable_xgating_torch.serve.engine import DeadlineExceeded, EngineOverloaded

    m = engine.cfg.model
    app = rng.normal(size=(m.num_frames, m.app_dim)).astype(np.float32)
    mot = rng.normal(size=(m.num_frames, m.motion_dim)).astype(np.float32)
    # settle: full largest-bucket batches through the whole pipeline
    for i in range(3):
        warm = [engine.submit(app, mot) for _ in range(engine.buckets[-1])]
        deadline = time.monotonic() + (180.0 if i == 0 else 60.0)
        for f in warm:
            try:
                f.result(timeout=max(1.0, deadline - time.monotonic()))
            except FutureTimeoutError:
                print(json.dumps({"event": "abort",
                                  "reason": f"warmup round {i} stalled (device wedged?)"}),
                      flush=True)
                for w in warm:
                    w.cancel()
                raise SystemExit(3)
    futures = []
    rejected = 0
    t0 = time.monotonic()
    next_t = t0
    while True:
        now = time.monotonic()
        if now - t0 >= duration_s:
            break
        if now < next_t:
            time.sleep(min(next_t - now, 0.005))
            continue
        try:
            futures.append(engine.submit(app, mot, deadline_ms=deadline_ms))
        except EngineOverloaded:  # --max_queue: shed
            rejected += 1
        next_t += rng.exponential(1.0 / rate_rps)

    results, expired = [], 0
    for f in futures:
        try:
            results.append(f.result(timeout=300))
        except DeadlineExceeded:
            expired += 1
    t_end = time.monotonic()
    lats = sorted(r.latency_ms for r in results)

    def pct(p):
        # n = 0 is a legitimate outcome under overload with deadlines
        if not lats:
            return None
        return round(lats[min(int(p * len(lats)), len(lats) - 1)], 2)

    occ = float(np.mean([r.batch_size for r in results])) if results else None
    point = {
        "offered_rps": rate_rps,
        "achieved_rps": len(results) / (t_end - t0),
        "n": len(results),
        "rejected": rejected,
        "latency_ms_p50": pct(0.50),
        "latency_ms_p99": pct(0.99),
        "mean_ride_bucket": round(occ, 1) if occ is not None else None,
    }
    if deadline_ms is not None:
        point["deadline_ms"] = deadline_ms
        point["expired"] = expired
        point["late_completions"] = int(sum(r.latency_ms > deadline_ms for r in results))
    return point


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mode", choices=("greedy", "beam"), default="beam")
    p.add_argument("--rates", default="50,200,1000,4000",
                   help="offered loads (requests/s), comma-separated")
    p.add_argument("--duration", type=float, default=10.0)
    p.add_argument("--buckets", default="1,4,16,64,256")
    p.add_argument("--max_wait_ms", type=float, default=8.0)
    p.add_argument("--shed_margin", type=float, default=1.3)
    p.add_argument("--adaptive_margin", action="store_true",
                   help="self-tuning shed margin (feedback on the measured late-completion "
                        "fraction; --shed_margin is the floor and the start)")
    p.add_argument("--max_queue", type=int, default=0, help=">0 = load shedding")
    p.add_argument("--deadline_ms", type=float, default=None,
                   help="per-request queue deadline (impatient clients)")
    p.add_argument("--ensemble", type=int, default=0, metavar="M",
                   help="M >= 2: an M-member ensemble engine (random members: throughput, "
                        "not quality)")
    p.add_argument("--nbest", type=int, default=0,
                   help="beam mode: responses carry the N best hypotheses")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where to run (default: the card; cpu only when asked)")
    args = p.parse_args(argv)

    from controllable_xgating_torch.cli.common import runtime_device
    from controllable_xgating_torch.ops.precision import precision
    from controllable_xgating_torch.utils.config import Config

    dev, dtype = runtime_device(args.device, None, Config())
    buckets = tuple(int(b) for b in args.buckets.split(","))
    points = []
    with precision(dtype):
        engine = build_engine(args.mode, buckets, args.max_wait_ms, max_queue=args.max_queue,
                              shed_margin=args.shed_margin,
                              adaptive_margin=args.adaptive_margin, n_members=args.ensemble,
                              nbest=args.nbest, device=dev)
        try:
            print(json.dumps({"event": "warmup", "buckets": buckets, "device": str(dev),
                              "compute_dtype": dtype}), flush=True)
            engine.warmup()
            rng = np.random.default_rng(0)
            for rate in (float(r) for r in args.rates.split(",")):
                point = run_load_point(engine, rate, args.duration, rng,
                                       deadline_ms=args.deadline_ms)
                point["mode"] = args.mode
                stats = engine.stats()
                point["engine_stats"] = {k: stats[k] for k in STATS_KEYS}
                print(json.dumps(point), flush=True)
                points.append(point)
        finally:
            engine.close()
    return points


if __name__ == "__main__":
    main()
