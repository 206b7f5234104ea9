"""Caption videos from a checkpoint: greedy by default, or with user POS
tags steering the syntax, multinomial samples, beam search or an n-best
list. One JSON line per video, with the JAX package's keys.

Counterpart of `controllable_xgating_tpu/cli/caption.py`. It runs the
port's kernels on the card (the dispatcher's choice, passed explicitly);
`--device cpu` runs their plain versions.

  python -m controllable_xgating_torch.cli.caption --data_dir D \\
      --checkpoint_dir checkpoints/joint --video video7
  python -m controllable_xgating_torch.cli.caption ... --pos_tags "DT NN VBZ VBG NN"
  python -m controllable_xgating_torch.cli.caption ... --sample 3 --seed 0
  python -m controllable_xgating_torch.cli.caption ... --beam_size 5
  python -m controllable_xgating_torch.cli.caption ... --nbest 5
  python -m controllable_xgating_torch.cli.caption ... --ensemble ck/joint ck/scst --beam_size 5
  python -m controllable_xgating_torch.cli.caption ... --beam_size 6 --eval.diversity_groups 3
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

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
    runtime_scope,
)
from controllable_xgating_torch.data.vocab import pad_encode
from controllable_xgating_torch.infer.beam import beam_search
from controllable_xgating_torch.infer.ensemble import make_auto_ensemble_caption_fn
from controllable_xgating_torch.infer.greedy import greedy_decode, sample_decode
from controllable_xgating_torch.models.captioner import encode_for_inference
from controllable_xgating_torch.models.decoder import DecodeContext
from controllable_xgating_torch.ops.dispatch import fused_enabled


def main(argv=None) -> None:
    p = base_parser(__doc__)
    p.add_argument("--video", required=True,
                   help="video id, comma-separated ids, or 'all' (batch mode)")
    add_ckpt_args(p)
    p.add_argument("--pos_tags", default=None,
                   help="space-separated Penn tags to control syntax")
    p.add_argument("--sample", type=int, default=0, metavar="N",
                   help="N>0: draw N stochastic captions per video "
                        "(multinomial; default is deterministic greedy)")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--beam_size", type=int, default=0, metavar="K",
                   help="K>1: beam decode instead of greedy")
    p.add_argument("--nbest", type=int, default=0, metavar="N",
                   help="N>0: print the N best beam hypotheses with "
                        "scores (beam width = max(--beam_size, N, 2))")
    add_ensemble_arg(p)
    args, cfg = parse_with_overrides(p, argv)
    if args.sample and (args.beam_size > 1 or args.nbest):
        die("--sample is mutually exclusive with --beam_size/--nbest")
    if args.nbest < 0 or args.beam_size < 0:
        die("--nbest/--beam_size must be >= 0")
    if args.sample > 0 and args.temperature <= 0:
        die(f"--temperature must be > 0 (got {args.temperature}); "
            "use greedy (no --sample) for deterministic decoding")
    beam = max(args.beam_size, args.nbest, 2) if (args.beam_size > 1 or args.nbest) else 0
    if args.ensemble and args.sample:
        die("--ensemble supports deterministic decoding only (drop --sample)")
    cfg = adopt_run_config(args, cfg)
    device, dtype = apply_runtime_flags(args, cfg)
    note_no_trace(args, "cli.caption")
    with runtime_scope(args, dtype):
        _caption(args, cfg, beam, device)


def _caption(args, cfg, beam: int, device) -> None:
    info, _, store, cfg = load_corpus(args.data_dir, cfg)
    if args.video == "all":
        vids = list(info.video_ids)
    else:
        vids = args.video.split(",")
        unknown = [v for v in vids if v not in info.video_ids]
        if unknown:
            die(f"unknown video id(s) {unknown}")
    vidx = np.array([info.video_ids.index(v) for v in vids])
    if args.ensemble:
        params, _ = restore_ensemble_params(args.ensemble, cfg, device)
    else:
        params = restore_params(args.checkpoint_dir, cfg, device, name=args.ckpt_name)

    put = lambda x: None if x is None else torch.as_tensor(x, device=device)
    app, motion = map(put, store.get_batch(vidx))
    frame_mask = put(store.frame_mask(vidx))
    pos_tags = None
    if args.pos_tags:
        if not cfg.model.pos_guidance:
            print("warning: model.pos_guidance=false — the decoder ignores psi, so "
                  "--pos_tags cannot steer this caption", file=sys.stderr)
        tags = args.pos_tags.split()
        unknown = [t for t in tags if t not in info.pos_vocab]
        if unknown:
            die(f"unknown POS tags {unknown}; vocabulary: Penn treebank")
        row = pad_encode(info.pos_vocab, tags, cfg.model.max_pos_len)
        pos_tags = put(np.array([row] * len(vids), np.int64))

    n_samples = max(args.sample, 0)
    fused = fused_enabled(None)
    diversity = dict(diversity_groups=cfg.eval.diversity_groups,
                     diversity_penalty=cfg.eval.diversity_penalty)
    if args.ensemble:
        out = make_auto_ensemble_caption_fn(
            params, beam or 1, cfg.model.max_pos_len, cfg.eval.max_decode_len,
            length_penalty=cfg.eval.length_penalty, block_unk=cfg.eval.block_unk,
            return_all=bool(args.nbest), **diversity,
        )(params, app, motion, frame_mask, pos_tags)
        tokens, scores, tags_out = out if args.nbest else (out[0], None, out[1])
    else:
        tokens, scores, tags_out = _decode(args, cfg, params, app, motion, frame_mask, pos_tags,
                                           beam, n_samples, fused, diversity)
    tokens, tags_out = tokens.cpu().numpy(), tags_out.cpu().numpy()
    if scores is not None:
        scores = scores.cpu().numpy()
    per_vid = n_samples or 1
    for row, vid in enumerate(vids):
        if args.nbest:  # tokens [B, K, L], scores [B, K], best-first
            cap_field = {"captions": [
                {"caption": info.vocab.decode_str(tokens[row, n]),
                 "score": round(float(scores[row, n]), 4)}
                for n in range(args.nbest)
            ]}
        else:
            caps = [info.vocab.decode_str(tokens[row * per_vid + s]) for s in range(per_vid)]
            cap_field = {"caption": caps[0] if not n_samples else caps}
        print(json.dumps({
            "video": vid,
            **cap_field,
            "pos_sequence": " ".join(info.pos_vocab.decode(tags_out[row])),
            "controlled": args.pos_tags is not None,
            **({"sampled": True, "temperature": args.temperature} if n_samples else {}),
            **({"beam_size": beam} if beam else {}),
            **({"ensemble": len(args.ensemble)} if args.ensemble else {}),
        }))


@torch.inference_mode()
def _decode(args, cfg, params, app, motion, frame_mask, pos_tags, beam, n_samples, fused,
            diversity):
    """One model's tokens [B*S, L] (samples), [B, K, L] (n-best) or [B, L],
    the n-best's scores or None, and the POS tags."""
    max_len, scores = cfg.eval.max_decode_len, None
    ctx, summary, tags_out = encode_for_inference(
        params, app, motion, frame_mask, pos_tags=pos_tags,
        max_pos_len=cfg.model.max_pos_len, fused=fused, early_stop=True,
    )
    if n_samples:
        # one rollout per (video, sample): rows repeated in place
        rep = lambda x: None if x is None else x.repeat_interleave(n_samples, dim=0)
        gen = torch.Generator(device=app.device).manual_seed(args.seed)
        tokens, _ = sample_decode(
            params.decoder, DecodeContext(*map(rep, ctx)), rep(summary), max_len, gen,
            args.temperature, block_unk=cfg.eval.block_unk, fused=fused, early_stop=True,
        )
    elif beam:
        tokens, scores = beam_search(
            params.decoder, ctx, summary, beam, max_len,
            length_penalty=cfg.eval.length_penalty, fused=fused,
            block_unk=cfg.eval.block_unk, early_stop=True, return_all=bool(args.nbest),
            **diversity,
        )
    else:
        tokens = greedy_decode(params.decoder, ctx, summary, max_len, fused=fused,
                               block_unk=cfg.eval.block_unk, early_stop=True)
    return tokens, scores, tags_out


if __name__ == "__main__":
    main()
