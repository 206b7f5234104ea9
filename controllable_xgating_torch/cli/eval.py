"""Evaluate a checkpoint on a split: decode with greedy or beam search,
score with the metric suite, print the metrics JSON and write it with the
captions to `<checkpoint_dir>/eval_<split>.json` (or `--out`).

Counterpart of `controllable_xgating_tpu/cli/eval.py`. With
`parallel.num_devices` N > 1 (0: every visible card) it decodes each
batch over a mesh of N cards (`parallel/mesh.py`) where there are that
many, the batch divides by N and the run is one process; otherwise on one
device, as the JAX CLI does where the devices are short (a training
config's device count never stops an eval).

  python -m controllable_xgating_torch.cli.eval --data_dir D \\
      --checkpoint_dir checkpoints/joint --split test --beam_size 5
  python -m controllable_xgating_torch.cli.eval ... --nbest 5 --oracle_metric CIDErD
  python -m controllable_xgating_torch.cli.eval ... --ensemble ck/joint ck/scst:best
  python -m controllable_xgating_torch.cli.eval ... --beam_size 6 --eval.diversity_groups 3
  python -m controllable_xgating_torch.cli.eval ... --profile prof/   # + a torch.profiler trace

An ensemble's result goes next to its first member, as
`eval_<split>_ensemble.json`, and records the members under "ensemble".
"""

from __future__ import annotations

import json
import os

import torch

from controllable_xgating_torch.cli.common import (
    add_ckpt_args,
    add_ensemble_arg,
    adopt_run_config,
    apply_runtime_flags,
    base_parser,
    load_corpus,
    parse_with_overrides,
    restore_ensemble_params,
    restore_params,
    runtime_scope,
    split_ckpt_spec,
)
from controllable_xgating_torch.infer.beam import make_beam_caption_fn
from controllable_xgating_torch.infer.ensemble import make_auto_ensemble_caption_fn
from controllable_xgating_torch.infer.evaluator import (
    evaluate_split,
    evaluate_split_nbest,
    make_greedy_caption_fn,
)
from controllable_xgating_torch.utils.logging import get_logger
from controllable_xgating_torch.utils.profiling import profile_trace

log = get_logger("cxg.cli.eval")


def main(argv=None) -> None:
    p = base_parser(__doc__)
    p.add_argument("--split", default="test", choices=("train", "val", "test"))
    p.add_argument("--beam_size", type=int, default=None,
                   help="beam width; 1 = greedy; unset = eval.beam_size")
    add_ckpt_args(p)
    add_ensemble_arg(p)
    p.add_argument("--nbest", type=int, default=0, metavar="N",
                   help="N>0: n-best evaluation — score rank-0 AND the "
                        "per-video oracle over the top-N beam hypotheses "
                        "(the reranking-headroom diagnostic); beam width "
                        "= max(--beam_size, N, 2)")
    p.add_argument("--oracle_metric", default="CIDErD",
                   help="per-video metric the --nbest oracle maximizes")
    p.add_argument("--out", default=None, help="output JSON path")
    args, cfg = parse_with_overrides(p, argv)
    cfg = adopt_run_config(args, cfg)
    beam = args.beam_size if args.beam_size is not None else cfg.eval.beam_size
    if args.nbest:
        beam = max(beam or 0, args.nbest, 2)
    device, dtype = apply_runtime_flags(args, cfg)
    with runtime_scope(args, dtype):
        _eval(args, cfg, beam, device)


def eval_mesh(cfg, device):
    """The decode mesh: `parallel.num_devices` N (0: the visible cards)
    cards where 1 < N <= their count, the batch divides by N and no
    process group runs (eval is a process-local concern, as in JAX); else
    None (one device). The CPU counts as one device."""
    from controllable_xgating_torch.parallel import distributed
    from controllable_xgating_torch.parallel.mesh import make_mesh

    count = torch.cuda.device_count() if device.type == "cuda" else 1
    n = cfg.parallel.num_devices or count
    if 1 < n <= count and cfg.data.batch_size % n == 0 and not distributed.is_multiprocess():
        log.info("eval data-parallel over %d devices", n)
        return make_mesh(n, axis=cfg.parallel.mesh_axis)
    if n > 1:
        log.info("parallel.num_devices=%d: decoding on one device", n)
    return None


def _eval(args, cfg, beam: int, device) -> None:
    info, labels, store, cfg = load_corpus(args.data_dir, cfg)
    mesh = eval_mesh(cfg, device)
    diversity = dict(diversity_groups=cfg.eval.diversity_groups,
                     diversity_penalty=cfg.eval.diversity_penalty)
    if args.ensemble:
        params, n_members = restore_ensemble_params(args.ensemble, cfg, device)
        caption_fn = make_auto_ensemble_caption_fn(
            params, beam or 1, cfg.model.max_pos_len, cfg.eval.max_decode_len,
            length_penalty=cfg.eval.length_penalty, block_unk=cfg.eval.block_unk,
            return_all=bool(args.nbest), **diversity,
        )
        log.info("ensemble decode over %d members", n_members)
    else:
        params = restore_params(args.checkpoint_dir, cfg, device, name=args.ckpt_name)
        if beam and beam > 1:
            caption_fn = make_beam_caption_fn(
                beam, cfg.model.max_pos_len, cfg.eval.max_decode_len,
                length_penalty=cfg.eval.length_penalty, block_unk=cfg.eval.block_unk,
                return_all=bool(args.nbest), **diversity,
            )
        else:
            caption_fn = make_greedy_caption_fn(cfg.model.max_pos_len, cfg.eval.max_decode_len,
                                                block_unk=cfg.eval.block_unk)
    with profile_trace(args.profile):  # the decode and the scoring, as the JAX CLI's span
        if args.nbest:
            metrics, oracle, lists = evaluate_split_nbest(
                params, store, labels, info, caption_fn, args.nbest, split=args.split,
                batch_size=cfg.data.batch_size, metrics=cfg.eval.metrics,
                oracle_metric=args.oracle_metric, mesh=mesh,
            )
            captions = {v: [{"caption": c, "score": s} for c, s in l] for v, l in lists.items()}
        else:
            metrics, captions = evaluate_split(
                params, store, labels, info, split=args.split, batch_size=cfg.data.batch_size,
                max_len=cfg.eval.max_decode_len, max_pos_len=cfg.model.max_pos_len,
                caption_fn=caption_fn, metrics=cfg.eval.metrics, mesh=mesh,
            )
    result = {"split": args.split, "beam_size": beam, "metrics": metrics}
    if args.nbest:
        result["nbest"] = args.nbest
        result["oracle_metric"] = args.oracle_metric
        result["oracle_metrics"] = oracle
    if args.ensemble:
        result["ensemble"] = args.ensemble
    print(json.dumps(result, indent=2))
    if args.out:
        out = args.out
    elif args.ensemble:
        out = os.path.join(split_ckpt_spec(args.ensemble[0])[0], f"eval_{args.split}_ensemble.json")
    else:
        out = os.path.join(args.checkpoint_dir, f"eval_{args.split}.json")
    with open(out, "w") as f:
        json.dump({**result, "captions": captions}, f, indent=2)
    log.info("wrote %s", out)


if __name__ == "__main__":
    main()
