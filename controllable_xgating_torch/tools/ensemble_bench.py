"""Ensemble decode throughput: M-member beam-5 captions/s vs one model.

Counterpart of the JAX package's `tools/ensemble_bench.py`, with its flags
and JSON and `--device` in place of `--platform`: for each M of
`--members`, the sustained beam-5 captions/s at MSR-VTT width (the timing
harness, `utils/timing.py`: B = 256, 28 steps, bf16 on the card) over
`--repeats` timings, with their `stats`, and for M > 1
`per_member_vs_single` (1.0: M members cost exactly M single models).
M = 1 is `timing.make_fn`; M > 1 is
`infer/ensemble.py::make_ensemble_caption_fn` over `stack_params` of
members with random weights from seeds 0 .. M-1 (throughput, not
quality). The port steps every member's decoder (K3 once per member per
step) on shared beam bookkeeping; an ensemble takes the grouped tail, no
K4. Each point also carries the device ms of one call (`torch.profiler`)
and the launches that call counted.

    python -m controllable_xgating_torch.tools.ensemble_bench [--members 1,2,3]
        [--batch 256] [--repeats 3] [--reps 2,10] [--device cuda|cpu]

Without a CUDA device it exits 1 unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> dict:
    from controllable_xgating_torch.utils import timing

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--members", default="1,2,3")
    p.add_argument("--batch", type=int, default=timing.BATCH)
    p.add_argument("--repeats", type=int, default=3,
                   help="independent timings per point (one warm-up)")
    p.add_argument("--reps", default="2,10", help="the two loop lengths differenced")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where to run (default: the card; cpu only when asked)")
    args = p.parse_args(argv)

    from controllable_xgating_torch.cli.common import runtime_device
    from controllable_xgating_torch.infer.ensemble import make_ensemble_caption_fn, stack_params
    from controllable_xgating_torch.models.captioner import init_captioner
    from controllable_xgating_torch.ops.precision import precision
    from controllable_xgating_torch.utils.config import Config

    dev, dtype = runtime_device(args.device, None, Config())
    reps = tuple(int(r) for r in args.reps.split(","))
    out = {"batch": args.batch, "beam": timing.BEAM, "max_len": timing.MAX_LEN,
           "device": timing.device_name(dev), "points": {}}
    single_cps = None
    with precision(dtype):
        cfg, params = timing.build(device=dev)
        batch = tuple(timing.put(x, dev) for x in timing.random_batch(cfg, args.batch))
        for m in (int(x) for x in args.members.split(",")):
            if m <= 1:
                fn, pm = timing.make_fn(cfg), params
            else:
                fn = make_ensemble_caption_fn(timing.BEAM, cfg.model.max_pos_len,
                                              timing.MAX_LEN, early_stop=False)
                pm = stack_params([params] + [init_captioner(cfg, seed=i, device=dev)
                                              for i in range(1, m)])
            print(f"[ens-bench] M={m}: warming + timing...", file=sys.stderr, flush=True)
            measure = timing.make_caption_measure(fn, pm, batch, dev, reps)
            cps, stats = timing.repeat_measure(measure, n=args.repeats)
            point = {"captions_per_sec": round(cps, 1), "stats": stats,
                     **timing.device_detail(lambda: fn(pm, *batch), dev)}
            if m == 1:
                single_cps = cps
            elif single_cps:
                point["per_member_vs_single"] = round(cps * m / single_cps, 3)
            out["points"][f"M={m}"] = point
            print(f"[ens-bench] M={m}: {cps:.0f} captions/s", file=sys.stderr, flush=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
