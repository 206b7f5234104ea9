"""MBR decoding evaluation: build a candidate pool per video, select by
consensus, score against the split's references beside greedy.

Counterpart of the JAX package's `tools/mbr_eval.py`. Pools come from
`--samples` multinomial rollouts per video (`--pool sample`, optionally
with the greedy caption added) or from the width-`--samples` beam n-best
(`--pool beam`, candidates weighted by their normalised exp(score) or
uniformly; `--diversity_groups` takes it through diverse beam search).
`infer/mbr.py::mbr_select` picks each video's candidate (`--utility
ROUGE_L` or `CIDErD`). Samples are drawn with `sample_decode` from one
`torch.Generator` seeded with `--seed` for the run, so they are not the
JAX tool's samples for the same seed; the same seed gives the same pools.

  python -m controllable_xgating_torch.tools.mbr_eval --data_dir D \\
      --checkpoint_dir CK --samples 20 --temperature 0.7 --out mbr.json

It runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from controllable_xgating_torch.cli.common import (
    adopt_ckpt_model_config,
    load_corpus,
    restore_params,
    runtime_device,
)
from controllable_xgating_torch.data.loader import eval_batches
from controllable_xgating_torch.infer.beam import beam_search
from controllable_xgating_torch.infer.greedy import greedy_decode, sample_decode
from controllable_xgating_torch.infer.mbr import mbr_select
from controllable_xgating_torch.metrics.harness import gts_from_label_array, language_eval
from controllable_xgating_torch.models.captioner import encode_for_inference
from controllable_xgating_torch.models.decoder import DecodeContext
from controllable_xgating_torch.ops.dispatch import fused_enabled
from controllable_xgating_torch.ops.precision import precision
from controllable_xgating_torch.utils.config import load_config, parse_cli_overrides


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--checkpoint_dir", required=True)
    p.add_argument("--ckpt_name", default="best")
    p.add_argument("--samples", type=int, default=20)
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--include_greedy", action="store_true",
                   help="add the greedy caption to every pool")
    p.add_argument("--split", default="test", choices=("train", "val", "test"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--utility", default="ROUGE_L", choices=("ROUGE_L", "CIDErD"),
                   help="consensus utility (infer/mbr.py): pairwise ROUGE-L F, or sentence "
                        "CIDEr-D with idf over the candidate pseudo-corpus")
    p.add_argument("--pool", default="sample", choices=("sample", "beam"),
                   help="candidate pool: --samples multinomial rollouts at --temperature "
                        "(Monte-Carlo MBR), or the beam n-best of width --samples (distinct "
                        "hypotheses with exact model posteriors)")
    p.add_argument("--diversity_groups", type=int, default=0,
                   help="with --pool beam: diverse beam search with this many groups (must "
                        "divide --samples)")
    p.add_argument("--diversity_penalty", type=float, default=0.5)
    p.add_argument("--beam_weighting", default="posterior", choices=("posterior", "uniform"),
                   help="with --pool beam: weight candidates by normalised exp(beam score), "
                        "or uniformly")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--compute_dtype", default=None, choices=("float32", "bfloat16"),
                   help="matmul operand dtype (accumulation is always f32)")
    args, overrides = p.parse_known_args(argv)
    if args.samples < 2:
        p.error("--samples must be >= 2 (MBR needs a pool)")
    if args.temperature <= 0:
        p.error("--temperature must be > 0")
    if args.pool == "beam" and args.include_greedy:
        p.error("--include_greedy applies to --pool sample only (a beam list already holds "
                "every high-probability hypothesis)")

    cfg = adopt_ckpt_model_config(args.checkpoint_dir, load_config(None, {}), args.ckpt_name)
    cfg = cfg.replace_flat(parse_cli_overrides(overrides))
    device, dtype = runtime_device(args.device, args.compute_dtype, cfg)
    with precision(dtype):
        result, mbr_res = _mbr_eval(args, cfg, device)
    print(json.dumps(result, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**result, "captions": mbr_res}, f, indent=2)


def _mbr_eval(args, cfg, device) -> tuple[dict, dict]:
    info, labels, store, cfg = load_corpus(args.data_dir, cfg)
    params = restore_params(args.checkpoint_dir, cfg, device, name=args.ckpt_name)
    s, max_len, block_unk = args.samples, cfg.eval.max_decode_len, cfg.eval.block_unk
    fused = fused_enabled(None)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    @torch.inference_mode()
    def decode_batch(app, motion, frame_mask):
        """(greedy [B, L], pool tokens [B, S, L] or [B*S, L], beam scores or None)."""
        ctx, summary, _ = encode_for_inference(params, app, motion, frame_mask,
                                               max_pos_len=cfg.model.max_pos_len, fused=fused,
                                               early_stop=True)
        greedy = greedy_decode(params.decoder, ctx, summary, max_len, fused=fused,
                               block_unk=block_unk, early_stop=True)
        if args.pool == "beam":
            nbest, scores = beam_search(
                params.decoder, ctx, summary, s, max_len, fused=fused, block_unk=block_unk,
                early_stop=True, return_all=True, diversity_groups=args.diversity_groups,
                diversity_penalty=args.diversity_penalty,
            )
            return greedy, nbest, scores
        rep = lambda x: None if x is None else x.repeat_interleave(s, dim=0)
        # the pool obeys the same constraint as the served captions
        sampled, _ = sample_decode(params.decoder, DecodeContext(*map(rep, ctx)), rep(summary),
                                   max_len, gen, args.temperature, block_unk=block_unk,
                                   fused=fused, early_stop=True)
        return greedy, sampled, None

    indices = np.asarray(info.splits[args.split], np.int64)
    put = lambda x: None if x is None else torch.as_tensor(x, device=device)
    pools: dict[str, list] = {}
    weights = {} if args.pool == "beam" and args.beam_weighting == "posterior" else None
    greedy_res: dict[str, list] = {}
    for batch in eval_batches(store, indices, cfg.data.batch_size):
        g, smp, scores = decode_batch(put(batch["app"]), put(batch["motion"]),
                                      put(batch.get("frame_mask")))
        g, smp = g.cpu().numpy(), smp.cpu().numpy()
        if scores is not None:
            scores = scores.cpu().numpy().astype(np.float64)
        for row in range(batch["num_valid"]):
            vid = info.video_ids[int(batch["video_indices"][row])]
            if args.pool == "beam":
                pool = [info.vocab.decode_str(smp[row, k]) for k in range(s)]
                if weights is not None:
                    sc = scores[row] - scores[row].max()
                    weights[vid] = list(np.exp(sc) / np.exp(sc).sum())
            else:
                pool = [info.vocab.decode_str(smp[row * s + k]) for k in range(s)]
            gcap = info.vocab.decode_str(g[row])
            if args.include_greedy:
                pool.append(gcap)
            pools[vid] = pool
            greedy_res[vid] = [gcap]

    chosen = mbr_select(pools, utility=args.utility, weights=weights)
    mbr_res = {v: [c] for v, (c, _u) in chosen.items()}
    keys = [info.video_ids[i] for i in indices]
    gts = gts_from_label_array(info.vocab, labels["caps"][indices], labels["ncaps"][indices],
                               keys)
    result = {
        "split": args.split, "samples": s, "temperature": args.temperature,
        "include_greedy": bool(args.include_greedy), "utility": args.utility,
        "pool": args.pool,
        "beam_weighting": args.beam_weighting if args.pool == "beam" else None,
        "metrics_greedy": language_eval(gts, greedy_res, metrics=cfg.eval.metrics),
        "metrics_mbr": language_eval(gts, mbr_res, metrics=cfg.eval.metrics),
        "picked_greedy_frac": float(np.mean([mbr_res[v][0] == greedy_res[v][0]
                                             for v in mbr_res])),
    }
    return result, mbr_res


if __name__ == "__main__":
    main()
