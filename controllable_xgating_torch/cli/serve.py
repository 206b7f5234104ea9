"""Serving CLI — run the micro-batching caption server on a checkpoint.

Counterpart of `controllable_xgating_tpu/cli/serve.py`: an HTTP JSON API
in front of `serve.engine.ServingEngine`, which coalesces concurrent
requests into bucketed device batches (see that module's docstring). It
serves on the card unless `--device cpu` is given; without a CUDA device
`--device cuda` exits 1. `--devices N > 1` serves data-parallel over the
first N cards (`parallel/mesh.py`; more than there are exits 1), or over N
entries of the CPU with `--device cpu`; buckets that N does not divide are
dropped, as in the JAX CLI.

The compute policy the CLI picks (bf16 on the card, f32 on the CPU, or
`--compute_dtype`) is the engine's for its whole life: the engine fixes
it at construction and its dispatcher computes under it, pinned for its
own thread. The process-wide policy is scoped to the set-up, so an
in-process caller finds it as it left it.

  python -m controllable_xgating_torch.cli.serve --data_dir D \\
      --checkpoint_dir checkpoints/scst --port 8000 \\
      --mode beam --buckets 1,4,16,64 --max_wait_ms 5
  python -m controllable_xgating_torch.cli.serve --data_dir D \\
      --ensemble CK1 CK2 ...      # serve a checkpoint ensemble
  curl -s localhost:8000/caption -d '{"video": "video7"}'
"""

from __future__ import annotations

import json

from controllable_xgating_torch.cli.common import (
    add_ckpt_args,
    add_ensemble_arg,
    adopt_run_config,
    apply_runtime_flags,
    base_parser,
    die,
    load_corpus,
    note_no_trace,
    parse_with_overrides,
    restore_ensemble_params,
    restore_params,
)
from controllable_xgating_torch.ops.precision import precision
from controllable_xgating_torch.utils.debug import enable_nan_checks


def build_engine(args, cfg, info, device):
    from controllable_xgating_torch.serve.engine import ServingEngine

    n_members = 0
    if getattr(args, "ensemble", None):
        params, n_members = restore_ensemble_params(args.ensemble, cfg, device)
    else:
        params = restore_params(args.checkpoint_dir, cfg, device, name=args.ckpt_name)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    mesh = None
    n_dev = args.devices or 1
    if n_dev > 1:
        from controllable_xgating_torch.parallel.mesh import make_mesh

        try:
            mesh = make_mesh(n_dev, devices=[device] * n_dev if device.type == "cpu" else None)
        except ValueError as e:
            die(f"--devices {n_dev}: {e}")
        kept = tuple(b for b in buckets if b % n_dev == 0)
        if kept != buckets:
            if not kept:
                die(f"no bucket in {list(buckets)} is divisible by --devices {n_dev}; pass e.g. "
                    f"--buckets {n_dev},{4 * n_dev},{16 * n_dev}")
            print(json.dumps({"event": "buckets_filtered",
                              "dropped": [b for b in buckets if b % n_dev], "kept": list(kept)}))
            buckets = kept
        print(json.dumps({"event": "mesh", "devices": n_dev}))
    return ServingEngine(
        params, cfg, info.vocab, info.pos_vocab,
        mode=args.mode, buckets=buckets, max_wait_ms=args.max_wait_ms,
        mesh=mesh, max_queue=args.max_queue, n_members=n_members,
        shed_margin=args.shed_margin,
        adaptive_margin=args.adaptive_margin,
        nbest=args.nbest,
    )


def start(argv=None):
    """Parse args, build the engine, bind the server. Returns
    (httpd, engine) — main() runs serve_forever; tests drive it directly."""
    p = base_parser(__doc__)
    add_ckpt_args(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000,
                   help="0 = pick an ephemeral port (printed at startup)")
    p.add_argument("--mode", choices=("greedy", "beam"), default="beam")
    p.add_argument("--buckets", default="1,4,16,64",
                   help="ascending batch-size buckets (graphs captured once each)")
    p.add_argument("--max_wait_ms", type=float, default=5.0,
                   help="micro-batching window after the first request")
    p.add_argument("--no_warmup", action="store_true",
                   help="skip running every bucket once at startup")
    p.add_argument("--devices", type=int, default=0,
                   help=">1 = data-parallel serving over that many devices")
    p.add_argument("--shed_margin", type=float, default=1.3,
                   help="scale the predicted pipeline latency used for "
                        "deadline shedding / bucket choice: > 1 sheds "
                        "earlier, trading goodput for fewer late "
                        "completions")
    p.add_argument("--adaptive_margin", action="store_true",
                   help="self-tune shed_margin from the engine's measured "
                        "late-completion fraction (--shed_margin becomes "
                        "the floor/start)")
    p.add_argument("--max_queue", type=int, default=0,
                   help=">0 = shed load: reject requests (HTTP 503) once "
                        "this many are waiting; 0 = queue unboundedly")
    p.add_argument("--nbest", type=int, default=0,
                   help="beam mode only: every response carries the N "
                        "best scored hypotheses (N <= eval.beam_size)")
    add_ensemble_arg(p)
    args, cfg = parse_with_overrides(p, argv)
    cfg = adopt_run_config(args, cfg)
    device, dtype = apply_runtime_flags(args, cfg)
    note_no_trace(args, "cli.serve")
    if args.nbest:
        # validate HERE (the engine re-checks) so flag errors print the
        # CLI's uniform "error: ..." instead of a ValueError traceback
        if args.mode != "beam":
            die("--nbest requires --mode beam")
        if args.nbest > cfg.eval.beam_size:
            die(f"--nbest {args.nbest} exceeds eval.beam_size "
                f"{cfg.eval.beam_size}")

    info, _, store, cfg = load_corpus(args.data_dir, cfg)
    if args.debug_nans:
        # for the server's life: the kernels' outputs checked and the decode
        # loops eager on the engine's threads, every operator on this one
        # (the warm-up)
        enable_nan_checks(True)
    with precision(dtype):
        engine = build_engine(args, cfg, info, device)
        if not args.no_warmup:
            print(json.dumps({"event": "warmup", "buckets": engine.buckets}))
            engine.warmup()

    from controllable_xgating_torch.serve.server import serve

    httpd = serve(engine, args.host, args.port,
                  store=store, video_ids=list(info.video_ids))
    print(json.dumps({
        "event": "serving",
        "addr": f"http://{args.host}:{httpd.server_address[1]}",
        "mode": args.mode,
        "device": str(device),
        "compute_dtype": str(dtype),
    }), flush=True)
    return httpd, engine


def main(argv=None) -> None:
    httpd, engine = start(argv)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        engine.close()


if __name__ == "__main__":
    main()
