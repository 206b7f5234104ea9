"""N-best reranking: tune hypothesis-selection weights on one split, apply
them on another.

Counterpart of the JAX package's `tools/rerank.py`. Each hypothesis of a
checkpoint's beam n-best gets a feature vector: its beam log-prob, its
length, its log-prob per token and, with `--rescore`, its log-prob under
each other checkpoint (`infer/score.py`, one teacher-forced forward of the
batch's [B*N] rows per scorer). A linear weight vector over the
standardised features picks the served hypothesis. The weights are tuned
once on `--tune_split` by a seeded random search over the per-video
oracle-metric table (pure numpy: no decode or scorer calls in the loop),
then applied unchanged to `--eval_split`; references are used only in
tuning.

  python -m controllable_xgating_torch.tools.rerank --data_dir D \\
      --checkpoint_dir CK --rescore CK2 CK3 --nbest 5 --out rerank.json

It runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from controllable_xgating_torch.cli.common import (
    adopt_ckpt_model_config,
    load_corpus,
    restore_params,
    runtime_device,
    split_ckpt_spec,
)
from controllable_xgating_torch.data.loader import eval_batches
from controllable_xgating_torch.data.vocab import PAD
from controllable_xgating_torch.infer.beam import make_beam_caption_fn
from controllable_xgating_torch.infer.score import make_sequence_scorer
from controllable_xgating_torch.metrics.harness import (
    gts_from_label_array,
    language_eval,
    normalize_metric_name,
)
from controllable_xgating_torch.ops.precision import precision
from controllable_xgating_torch.utils.config import load_config, parse_cli_overrides


def collect_nbest(params, store, labels, info, caption_fn, nbest, split, batch_size, device):
    """Decode a split -> ({vid: [(caption, score)]}, {vid: tokens [N, L]},
    {vid: row features [N, 3]} (beam log-prob, length, log-prob per
    token))."""
    indices = np.asarray(info.splits[split], np.int64)
    put = lambda x: None if x is None else torch.as_tensor(x, device=device)
    lists, toks, feats = {}, {}, {}
    for batch in eval_batches(store, indices, batch_size):
        tokens, scores, _ = caption_fn(
            params, put(batch["app"]), put(batch["motion"]), put(batch.get("frame_mask")))
        tokens = tokens.cpu().numpy()[:, :nbest]
        scores = scores.cpu().numpy()[:, :nbest]
        for row in range(batch["num_valid"]):
            vid = info.video_ids[int(batch["video_indices"][row])]
            lists[vid] = [(info.vocab.decode_str(tokens[row, n]), float(scores[row, n]))
                          for n in range(nbest)]
            toks[vid] = tokens[row]
            length = (tokens[row] != PAD).sum(axis=1).astype(np.float64)
            # the length-normalised log-prob (the GNMT selection rule) is a
            # ratio the linear model cannot form from the other two
            feats[vid] = np.stack([scores[row], length, scores[row] / np.maximum(length, 1.0)],
                                  axis=1)
    return lists, toks, feats


def add_rescore_features(feats, toks, store, info, scorer, rescore_params, vids, batch_size,
                         device):
    """Append one log-prob column per rescoring checkpoint."""
    idx_of = {v: i for i, v in enumerate(info.video_ids)}
    order = list(vids)
    nbest = next(iter(toks.values())).shape[0]
    put = lambda x: None if x is None else torch.as_tensor(
        np.repeat(x, nbest, axis=0), device=device)
    for start in range(0, len(order), batch_size):
        chunk = order[start:start + batch_size]
        vidx = np.array([idx_of[v] for v in chunk])
        app, motion = store.get_batch(vidx)
        mask = store.frame_mask(vidx)
        rows = torch.as_tensor(np.concatenate([toks[v] for v in chunk], axis=0), device=device)
        for p in rescore_params:
            lp, _ = scorer(p, put(app), put(motion), put(mask), rows)
            lp = lp.cpu().numpy().reshape(len(chunk), nbest)
            for i, v in enumerate(chunk):
                feats[v] = np.concatenate([feats[v], lp[i][:, None]], axis=1)
    return feats


def per_video_metric_table(lists, gts, oracle_metric):
    """[V, N] per-video `oracle_metric` of every rank (one `language_eval`
    per rank, per key)."""
    vids = list(lists)
    nbest = len(lists[vids[0]])
    table = np.zeros((len(vids), nbest))
    for n in range(nbest):
        _, detail = language_eval(gts, {v: [lists[v][n][0]] for v in vids},
                                  metrics=[oracle_metric], per_key=True)
        for i, v in enumerate(vids):
            table[i, n] = detail[v].get(oracle_metric, 0.0)
    return vids, table


def tune_weights(F, table, trials, seed):
    """Maximise mean_v table[v, argmax_n F[v, n, :] @ w] by a seeded random
    search around the best weights so far, at three step sizes. F is
    standardised; the start w0 selects by beam score alone (rank 0)."""
    rng = np.random.default_rng(seed)
    d = F.shape[2]

    def objective(w):
        sel = np.argmax(F @ w, axis=1)
        return float(table[np.arange(len(sel)), sel].mean())

    best_w = np.zeros(d)
    best_w[0] = 1.0  # the highest beam score wins: the rank-0 baseline
    best = objective(best_w)
    for sigma in (1.0, 0.3, 0.1):
        for _ in range(trials // 3):
            w = best_w + sigma * rng.standard_normal(d)
            v = objective(w)
            if v > best + 1e-12:
                best, best_w = v, w
    return best_w, best


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--checkpoint_dir", required=True,
                   help="the decoding checkpoint (its beam gives the n-best lists; its saved "
                        "config is adopted)")
    p.add_argument("--ckpt_name", default="best")
    p.add_argument("--rescore", nargs="*", default=[], metavar="CKPT_DIR[:NAME]",
                   help="other checkpoints of the same architecture whose log-probs become "
                        "reranking features")
    p.add_argument("--nbest", type=int, default=5)
    p.add_argument("--beam_size", type=int, default=None,
                   help="decode beam width (default max(eval.beam_size, nbest))")
    p.add_argument("--tune_split", default="val", choices=("train", "val", "test"))
    p.add_argument("--eval_split", default="test", choices=("train", "val", "test"))
    p.add_argument("--oracle_metric", default="CIDErD")
    p.add_argument("--trials", type=int, default=3000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="output JSON path")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--compute_dtype", default=None, choices=("float32", "bfloat16"))
    args, overrides = p.parse_known_args(argv)
    try:
        args.oracle_metric = normalize_metric_name(args.oracle_metric)
    except ValueError as e:
        p.error(str(e))

    cfg = adopt_ckpt_model_config(args.checkpoint_dir, load_config(None, {}), args.ckpt_name)
    cfg = cfg.replace_flat(parse_cli_overrides(overrides))
    device, dtype = runtime_device(args.device, args.compute_dtype, cfg)
    with precision(dtype):
        result = _rerank(args, cfg, device)
    print(json.dumps(result, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)


def _rerank(args, cfg, device) -> dict:
    info, labels, store, cfg = load_corpus(args.data_dir, cfg)
    params = restore_params(args.checkpoint_dir, cfg, device, name=args.ckpt_name)
    rescore_params = [restore_params(d, cfg, device, name=n)
                      for d, n in map(split_ckpt_spec, args.rescore)]
    # --beam_size replaces the config's width (as in cli.eval); nbest only widens it
    beam = max(args.beam_size or cfg.eval.beam_size, args.nbest, 2)
    caption_fn = make_beam_caption_fn(
        beam, cfg.model.max_pos_len, cfg.eval.max_decode_len,
        length_penalty=cfg.eval.length_penalty, block_unk=cfg.eval.block_unk, return_all=True,
    )
    scorer = make_sequence_scorer(cfg.model.max_pos_len, block_unk=cfg.eval.block_unk)

    def gather(split):
        lists, toks, feats = collect_nbest(params, store, labels, info, caption_fn, args.nbest,
                                           split, cfg.data.batch_size, device)
        if rescore_params:
            feats = add_rescore_features(feats, toks, store, info, scorer, rescore_params,
                                         list(lists), cfg.data.batch_size, device)
        indices = np.asarray(info.splits[split], np.int64)
        keys = [info.video_ids[i] for i in indices]
        gts = gts_from_label_array(info.vocab, labels["caps"][indices],
                                   labels["ncaps"][indices], keys)
        vids, table = per_video_metric_table(lists, gts, args.oracle_metric)
        return lists, gts, vids, table, np.stack([feats[v] for v in vids])  # F [V, N, J]

    print(f"[rerank] decoding + featurizing {args.tune_split} ...", file=sys.stderr)
    _, _, _, t_table, t_F = gather(args.tune_split)
    mu = t_F.reshape(-1, t_F.shape[2]).mean(0)
    sd = t_F.reshape(-1, t_F.shape[2]).std(0)
    sd[sd == 0] = 1.0
    w, tuned_val = tune_weights((t_F - mu) / sd, t_table, args.trials, args.seed)
    base_val = float(t_table[:, 0].mean())
    print(f"[rerank] tune {args.oracle_metric}: rank-0 {base_val:.4f} -> reranked "
          f"{tuned_val:.4f} (w={np.round(w, 3).tolist()})", file=sys.stderr)

    print(f"[rerank] decoding + featurizing {args.eval_split} ...", file=sys.stderr)
    e_lists, e_gts, e_vids, e_table, e_F = gather(args.eval_split)
    sel = np.argmax(((e_F - mu) / sd) @ w, axis=1)
    oracle_sel = np.argmax(e_table, axis=1)

    def corpus(selection):
        res = {v: [e_lists[v][int(n)][0]] for v, n in zip(e_vids, selection)}
        return language_eval(e_gts, res, metrics=cfg.eval.metrics)

    return {
        "nbest": args.nbest, "beam_size": beam,
        "features": (["beam_logprob", "length", "logprob_per_token"]
                     + [f"rescore:{s}" for s in args.rescore]),
        "weights": w.tolist(),
        "feature_mean": mu.tolist(), "feature_std": sd.tolist(),
        "tune_split": args.tune_split, "tune_metric": args.oracle_metric,
        "tune_rank0": base_val, "tune_reranked": tuned_val,
        "eval_split": args.eval_split,
        "metrics_rank0": corpus(np.zeros(len(e_vids), int)),
        "metrics_reranked": corpus(sel),
        "metrics_oracle": corpus(oracle_sel),
        "picked_nonzero_rank": float((sel != 0).mean()),
    }


if __name__ == "__main__":
    main()
