"""Evaluate a checkpoint on a split: decode with greedy or beam search,
score with the metric suite, print the metrics JSON and write it with the
captions to `<checkpoint_dir>/eval_<split>.json` (or `--out`).

Counterpart of `controllable_xgating_tpu/cli/eval.py`, on one device.

  python -m controllable_xgating_torch.cli.eval --data_dir D \\
      --checkpoint_dir checkpoints/joint --split test --beam_size 5
  python -m controllable_xgating_torch.cli.eval ... --nbest 5 --oracle_metric CIDErD
"""

from __future__ import annotations

import json
import os

from controllable_xgating_torch.cli.common import (
    add_ckpt_args,
    apply_runtime_flags,
    base_parser,
    load_corpus,
    maybe_adopt_ckpt_config,
    parse_with_overrides,
    refuse_diverse_beam,
    restore_params,
)
from controllable_xgating_torch.infer.beam import make_beam_caption_fn
from controllable_xgating_torch.infer.evaluator import (
    evaluate_split,
    evaluate_split_nbest,
    make_greedy_caption_fn,
)
from controllable_xgating_torch.ops.precision import precision
from controllable_xgating_torch.utils.logging import get_logger

log = get_logger("cxg.cli.eval")


def main(argv=None) -> None:
    p = base_parser(__doc__)
    p.add_argument("--split", default="test", choices=("train", "val", "test"))
    p.add_argument("--beam_size", type=int, default=None,
                   help="beam width; 1 = greedy; unset = eval.beam_size")
    add_ckpt_args(p)
    p.add_argument("--nbest", type=int, default=0, metavar="N",
                   help="N>0: n-best evaluation — score rank-0 AND the "
                        "per-video oracle over the top-N beam hypotheses "
                        "(the reranking-headroom diagnostic); beam width "
                        "= max(--beam_size, N, 2)")
    p.add_argument("--oracle_metric", default="CIDErD",
                   help="per-video metric the --nbest oracle maximizes")
    p.add_argument("--out", default=None, help="output JSON path")
    args, cfg = parse_with_overrides(p, argv)
    cfg = maybe_adopt_ckpt_config(args, cfg)
    beam = args.beam_size if args.beam_size is not None else cfg.eval.beam_size
    if args.nbest:
        beam = max(beam or 0, args.nbest, 2)
    if beam and beam > 1:
        refuse_diverse_beam(cfg)
    device, dtype = apply_runtime_flags(args, cfg)
    with precision(dtype):
        _eval(args, cfg, beam, device)


def _eval(args, cfg, beam: int, device) -> None:
    info, labels, store, cfg = load_corpus(args.data_dir, cfg)
    params = restore_params(args.checkpoint_dir, cfg, device, name=args.ckpt_name)
    if beam and beam > 1:
        caption_fn = make_beam_caption_fn(
            beam, cfg.model.max_pos_len, cfg.eval.max_decode_len,
            length_penalty=cfg.eval.length_penalty, block_unk=cfg.eval.block_unk,
            return_all=bool(args.nbest),
        )
    else:
        caption_fn = make_greedy_caption_fn(cfg.model.max_pos_len, cfg.eval.max_decode_len,
                                            block_unk=cfg.eval.block_unk)
    if args.nbest:
        metrics, oracle, lists = evaluate_split_nbest(
            params, store, labels, info, caption_fn, args.nbest, split=args.split,
            batch_size=cfg.data.batch_size, metrics=cfg.eval.metrics,
            oracle_metric=args.oracle_metric,
        )
        captions = {v: [{"caption": c, "score": s} for c, s in l] for v, l in lists.items()}
    else:
        metrics, captions = evaluate_split(
            params, store, labels, info, split=args.split, batch_size=cfg.data.batch_size,
            max_len=cfg.eval.max_decode_len, max_pos_len=cfg.model.max_pos_len,
            caption_fn=caption_fn, metrics=cfg.eval.metrics,
        )
    result = {"split": args.split, "beam_size": beam, "metrics": metrics}
    if args.nbest:
        result["nbest"] = args.nbest
        result["oracle_metric"] = args.oracle_metric
        result["oracle_metrics"] = oracle
    print(json.dumps(result, indent=2))
    out = args.out or os.path.join(args.checkpoint_dir, f"eval_{args.split}.json")
    with open(out, "w") as f:
        json.dump({**result, "captions": captions}, f, indent=2)
    log.info("wrote %s", out)


if __name__ == "__main__":
    main()
