"""Standalone metric scorer CLI — the vendored coco-caption toolkit's
standalone surface (SURVEY.md §2 "coco-caption equivalents"): score a file
of candidate captions against references with BLEU-1..4 / METEOR / ROUGE-L
/ CIDEr / CIDEr-D. Pure host code — no model, checkpoint, or accelerator.

Counterpart of `controllable_xgating_tpu/cli/score.py`: the same input
shapes, flags, bootstrap draws and JSON, on the port's pure-Python scorers
(tests/test_torch_score_cli.py).

Candidate JSON (--candidates) is accepted in any of these shapes:

  {"video1": "a man plays guitar", ...}
  {"video1": ["a man plays guitar"], ...}          # single-item lists
  {"metrics": ..., "captions": {...}}              # a cxg-eval output file
  {"v1": [{"caption": ..., "score": ...}, ...]}    # a cxg-eval --nbest file
                                                   # (rank 0 scores; pass
                                                   # --oracle N for headroom)
  [{"image_id": "video1", "caption": "..."}, ...]  # COCO results format

References come from --references (``{id: [refs...]}``, ``{id: "ref"}``,
or COCO annotation format ``{"annotations": [{"image_id", "caption"}]}``)
or from a prepared corpus directory (--data_dir [--split]).

Raw-text inputs are PTB-tokenized before scoring (coco-caption behavior);
corpus ground truths and cxg-eval outputs are already tokenized, so
--retokenize defaults to "auto": on iff --references is used. CIDEr idf
statistics are computed over exactly the scored reference set, matching
the reference toolkit's behavior on an eval split.

  cxg-torch-score --candidates ckpt/eval_test.json --data_dir data/flagship --split test
  cxg-torch-score --candidates results.json --references refs.json --per_video per.json

Statistical testing (beyond the reference toolkit): `--bootstrap N`
reports a 95% CI per metric from N video-resamples, each an exact
corpus-metric recomputation (incl. CIDEr idf over the resampled
reference multiset — BLEU/METEOR are not mean-decomposable, so
resampling per-video scores would be wrong). `--compare FILE` scores a
second candidates file on the same resamples (paired) and reports the
per-metric delta, its CI, and an add-one-smoothed two-sided percentile
p-value — use it to state whether an ablation/model delta is real:

  cxg-torch-score --candidates a/eval_test.json --compare b/eval_test.json \
      --data_dir data/flagship --split test --bootstrap 1000
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_candidates(path: str) -> dict[str, list[str]]:
    """Normalize any accepted candidate shape to {key: [one caption]}."""
    d = _load_json(path)
    if isinstance(d, list):  # COCO results format
        out: dict[str, list[str]] = {}
        for row in d:
            key = str(row["image_id"])
            if key in out:
                raise ValueError(f"duplicate candidate for {key!r}")
            out[key] = [str(row["caption"])]
        return out
    if not isinstance(d, dict):
        raise ValueError(f"{path}: expected a JSON object or list")
    if isinstance(d.get("captions"), dict):
        d = d["captions"]  # a cxg-eval / tools output file
    out = {}
    for k, v in d.items():
        if isinstance(v, str):
            out[str(k)] = [v]
        elif isinstance(v, list) and len(v) == 1 and isinstance(v[0], str):
            out[str(k)] = [v[0]]
        elif (isinstance(v, list) and v and isinstance(v[0], dict)
              and "caption" in v[0]):
            # cxg-eval --nbest output: scored best-first list; rank 0 is
            # the served caption (pass --oracle N to score the list)
            out[str(k)] = [str(v[0]["caption"])]
        else:
            raise ValueError(
                f"{path}: candidate for {k!r} must be one string "
                f"(got {type(v).__name__} of len "
                f"{len(v) if isinstance(v, list) else 'n/a'}); metrics "
                "score exactly one candidate per video"
            )
    return out


def load_nbest_lists(path: str):
    """{key: [caption, ...]} (best-first) if `path` is a cxg-eval --nbest
    output (captions are scored lists); None for any other shape."""
    d = _load_json(path)
    if isinstance(d, dict) and isinstance(d.get("captions"), dict):
        d = d["captions"]
    if not isinstance(d, dict) or not d:
        return None
    vals = list(d.values())
    if not all(isinstance(v, list) and v and isinstance(v[0], dict)
               and "caption" in v[0] for v in vals):
        return None
    return {str(k): [str(r["caption"]) for r in v] for k, v in d.items()}


def load_reference_file(path: str) -> dict[str, list[str]]:
    d = _load_json(path)
    if not isinstance(d, dict):
        raise ValueError(f"{path}: expected a JSON object")
    if isinstance(d.get("annotations"), list):  # COCO annotation format
        out: dict[str, list[str]] = {}
        for row in d["annotations"]:
            out.setdefault(str(row["image_id"]), []).append(
                str(row["caption"])
            )
        return out
    return {
        str(k): ([v] if isinstance(v, str) else [str(s) for s in v])
        for k, v in d.items()
    }


def load_corpus_references(
    data_dir: str, split: str | None
) -> dict[str, list[str]]:
    """Ground truths from a prepared corpus dir (info.json + labels.npz)."""
    import numpy as np

    from controllable_xgating_torch.data.corpus import CorpusInfo, load_labels
    from controllable_xgating_torch.metrics.harness import gts_from_label_array

    info = CorpusInfo.load(os.path.join(data_dir, "info.json"))
    labels = load_labels(data_dir)
    if split:
        if split not in info.splits:
            raise ValueError(
                f"unknown split {split!r}; corpus has {sorted(info.splits)}"
            )
        idx = np.asarray(info.splits[split], np.int64)
    else:
        idx = np.arange(len(info.video_ids), dtype=np.int64)
    keys = [info.video_ids[int(i)] for i in idx]
    return gts_from_label_array(
        info.vocab, labels["caps"][idx], labels["ncaps"][idx], keys
    )


def bootstrap_metrics(gts, res, res2, n, seed, metrics, fast=True,
                      meteor_synonyms=None):
    """Nonparametric bootstrap over videos.

    Resample video ids with replacement and recompute the FULL corpus
    metrics per resample — including the CIDEr idf statistics over the
    resampled reference multiset. This is an exact bootstrap of the
    corpus-level scores (BLEU's clipped-count ratios are not
    mean-decomposable, and CIDEr's idf couples videos, so resampling
    per-video scores would be wrong).

    `fast=True` (default) computes the same numbers from per-video
    sufficient statistics precomputed once (metrics/bootstrap.py):
    ~200x faster at 300 videos, identical resample draws (same rng
    stream), values equal to the direct path up to float summation
    order (pinned by tests/test_score_cli.py). `fast=False` re-runs
    the scorer suite per resample (~0.15 s per resample at 90 videos).

    Returns (rows, rows2): one metric dict per resample for the
    candidates and (if res2 is given) the paired comparison file —
    paired because both are scored on the SAME resampled id multiset.
    """
    import numpy as np

    from controllable_xgating_torch.metrics.harness import language_eval

    keys = sorted(res)
    rng = np.random.default_rng(seed)
    rows, rows2 = [], []
    if fast:
        from controllable_xgating_torch.metrics.bootstrap import (
            FastPairedBootstrap,
        )

        fb = FastPairedBootstrap(gts, res, res2, metrics,
                                 meteor_synonyms=meteor_synonyms)
        for _ in range(n):
            pick = rng.integers(0, len(keys), len(keys))
            row, row2 = fb.resample(pick)
            rows.append(row)
            if res2 is not None:
                rows2.append(row2)
        return rows, (rows2 if res2 is not None else None)
    for _ in range(n):
        pick = rng.integers(0, len(keys), len(keys))
        g, r1, r2 = {}, {}, {}
        for j, i in enumerate(pick):
            k, nk = keys[i], f"{keys[i]}#{j}"
            g[nk] = gts[k]
            r1[nk] = res[k]
            if res2 is not None:
                r2[nk] = res2[k]
        rows.append(language_eval(g, r1, metrics=metrics,
                                  meteor_synonyms=meteor_synonyms))
        if res2 is not None:
            rows2.append(language_eval(g, r2, metrics=metrics,
                                       meteor_synonyms=meteor_synonyms))
    return rows, (rows2 if res2 is not None else None)


def _ci95(values):
    import numpy as np

    v = np.asarray(values, np.float64)
    lo, hi = np.percentile(v, [2.5, 97.5])
    return [round(float(lo), 6), round(float(hi), 6)]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--candidates", required=True,
                   help="candidate captions JSON (see accepted shapes above)")
    p.add_argument("--references", default=None,
                   help="reference captions JSON; mutually exclusive with "
                        "--data_dir")
    p.add_argument("--data_dir", default=None,
                   help="prepared corpus dir to pull ground truths from")
    p.add_argument("--split", default=None,
                   choices=("train", "val", "test"),
                   help="restrict corpus ground truths to one split "
                        "(default: whole corpus)")
    p.add_argument("--metrics", default=None,
                   help="comma list, e.g. 'Bleu_4,CIDEr' (default: all)")
    p.add_argument("--retokenize", default="auto",
                   choices=("auto", "yes", "no"),
                   help="PTB-tokenize both sides before scoring "
                        "(auto: yes iff --references)")
    p.add_argument("--per_video", default=None, metavar="PATH",
                   help="also write per-video scores (coco-caption's "
                        "imgToEval) to PATH")
    p.add_argument("--out", default=None, help="write the metric dict here "
                                               "in addition to stdout")
    p.add_argument("--bootstrap", type=int, default=0, metavar="N",
                   help="N bootstrap resamples over videos -> 95%% CI per "
                        "metric (exact corpus-metric recomputation incl. "
                        "the per-resample CIDEr idf, via precomputed "
                        "per-video statistics: 2000 paired resamples at "
                        "300 videos in ~6 s)")
    p.add_argument("--compare", default=None, metavar="PATH",
                   help="second candidates file (same video ids): paired "
                        "bootstrap -> per-metric delta (candidates minus "
                        "compare), 95%% CI and two-sided p-value")
    p.add_argument("--seed", type=int, default=0,
                   help="bootstrap resampling seed")
    p.add_argument("--meteor_synonyms", default=None, metavar="PATH",
                   help="synonym table for METEOR's stage-3 module (one "
                        "synset group of whitespace-separated words per "
                        "line, e.g. a WordNet export); default: exact+stem "
                        "only")
    p.add_argument("--oracle", type=int, default=0, metavar="N",
                   help="candidates must be a cxg-eval --nbest file: also "
                        "report the per-video oracle over the top-N list "
                        "(reranking headroom) without re-decoding")
    p.add_argument("--oracle_metric", default="CIDErD",
                   help="per-video metric the --oracle selection maximizes")
    args = p.parse_args(argv)

    if bool(args.references) == bool(args.data_dir):
        p.error("exactly one of --references / --data_dir is required")
    if args.split and not args.data_dir:
        p.error("--split only applies with --data_dir")
    if args.compare and not args.bootstrap:
        p.error("--compare requires --bootstrap N (the comparison is the "
                "paired-bootstrap delta)")

    res = load_candidates(args.candidates)
    if not res:
        p.error(f"{args.candidates}: no candidates")
    meteor_syn = None
    if args.meteor_synonyms:
        # parse ONCE: language_eval/bootstrap accept the prebuilt mapping,
        # and a WordNet-scale table re-parsed per scoring call (the
        # --oracle loop alone makes N+3 of them) costs real seconds
        from controllable_xgating_torch.metrics.meteor import (
            load_synonym_table,
        )

        meteor_syn = load_synonym_table(args.meteor_synonyms)
    if args.references:
        gts = load_reference_file(args.references)
    else:
        gts = load_corpus_references(args.data_dir, args.split)

    missing = [k for k in res if k not in gts]
    if missing:
        sys.exit(
            f"error: {len(missing)} candidate id(s) have no references "
            f"(first few: {missing[:5]}); check --split / the id scheme"
        )
    # idf statistics must come from exactly the scored set (the reference
    # toolkit computes CIDEr df over the eval split's gts)
    gts = {k: gts[k] for k in res}

    res2 = None
    if args.compare:
        res2 = load_candidates(args.compare)
        if set(res2) != set(res):
            only_a = sorted(set(res) - set(res2))[:5]
            only_b = sorted(set(res2) - set(res))[:5]
            sys.exit(
                "error: --compare must cover the same video ids as "
                f"--candidates (only in candidates: {only_a}; only in "
                f"compare: {only_b})"
            )

    retok = args.retokenize == "yes" or (
        args.retokenize == "auto" and bool(args.references)
    )
    if retok:
        # tokenize once up front (deterministic per caption) so bootstrap
        # resamples don't redo it; language_eval then runs on token form
        from controllable_xgating_torch.data.tokenizer import PTBTokenizer

        tok = PTBTokenizer()
        gts = tok.tokenize_captions({k: list(v) for k, v in gts.items()})
        res = tok.tokenize_captions({k: list(v) for k, v in res.items()})
        if res2 is not None:
            res2 = tok.tokenize_captions(
                {k: list(v) for k, v in res2.items()})

    from controllable_xgating_torch.metrics.harness import language_eval

    scored = language_eval(
        gts, res, metrics=args.metrics, per_key=bool(args.per_video),
        meteor_synonyms=meteor_syn,
    )
    if args.per_video:
        scored, detail = scored
        with open(args.per_video, "w") as f:
            json.dump(detail, f, indent=2)
    out = {"n_scored": len(res), "metrics": scored}

    if args.oracle:
        from controllable_xgating_torch.metrics.harness import (
            normalize_metric_name,
        )

        try:
            args.oracle_metric = normalize_metric_name(args.oracle_metric)
        except ValueError as e:
            p.error(str(e))
        lists = load_nbest_lists(args.candidates)
        if lists is None:
            p.error("--oracle requires a cxg-eval --nbest candidates file "
                    "(scored n-best lists per video)")
        short = min(len(v) for v in lists.values())
        if args.oracle > short:
            p.error(f"--oracle {args.oracle} exceeds the shortest saved "
                    f"list ({short})")
        if retok:
            lists = tok.tokenize_captions({k: list(v)
                                           for k, v in lists.items()})
        per_rank = []
        for n in range(args.oracle):
            _, det = language_eval(
                gts, {k: [v[n]] for k, v in lists.items()},
                metrics=[args.oracle_metric], per_key=True,
                meteor_synonyms=meteor_syn,
            )
            per_rank.append(det)
        pick = {
            k: max(range(args.oracle),
                   key=lambda n: per_rank[n][k].get(args.oracle_metric, 0.0))
            for k in lists
        }
        out["oracle"] = {
            "n": args.oracle,
            "metric": args.oracle_metric,
            "metrics": language_eval(
                gts, {k: [lists[k][pick[k]]] for k in lists},
                metrics=args.metrics,
                meteor_synonyms=meteor_syn,
            ),
        }

    if args.bootstrap:
        import numpy as np

        rows, rows2 = bootstrap_metrics(
            gts, res, res2, args.bootstrap, args.seed, args.metrics,
            meteor_synonyms=meteor_syn)
        names = list(rows[0])
        out["bootstrap"] = {
            "n": args.bootstrap, "seed": args.seed,
            "ci95": {m: _ci95([r[m] for r in rows]) for m in names},
        }
        if rows2 is not None:
            deltas = {
                m: np.asarray([a[m] - b[m] for a, b in zip(rows, rows2)])
                for m in names
            }
            n = args.bootstrap
            comp = {}
            for m, d in deltas.items():
                # add-one-smoothed two-sided percentile p-value: with all
                # resamples on one side, report 2/(n+1) rather than 0
                p_val = 2.0 * min((1 + int((d <= 0).sum())) / (n + 1),
                                  (1 + int((d >= 0).sum())) / (n + 1))
                comp[m] = {
                    "mean": round(float(d.mean()), 6),
                    "ci95": _ci95(d),
                    "p_value": round(min(p_val, 1.0), 6),
                }
            out["compare"] = {
                "path": args.compare,
                "metrics": language_eval(
                    gts, res2, metrics=args.metrics,
                    meteor_synonyms=meteor_syn),
                "delta": comp,
            }

    print(json.dumps(out, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)


if __name__ == "__main__":
    main()
