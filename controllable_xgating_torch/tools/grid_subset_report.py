"""Subset-stratified paired comparison of ablation-grid eval files.

The grid-v2 mechanism analysis (docs/RESULTS.md "Corpus v2") splits the
eval videos by the fixture generator's per-video corruption flag and asks
WHERE each architectural delta lives: cross-gating is predicted to win
exactly on the videos where one stream is corrupted and the other carries
the reliability beacon (paper arXiv:1908.10072 §3.1). This tool makes
that analysis a one-command, reusable artifact instead of a notebook
pattern — round 4 needs it a second time for the held-out re-test at ~5x
the corrupted-subset n.

For every requested pair of cxg-eval output files and every subset
(pooled / corrupted / clean), it scores both candidate sets on exactly
the subset's videos (CIDEr idf over the subset's reference multiset,
same convention as cxg-score) and reports the paired-bootstrap delta
with an add-one-smoothed two-sided p-value — identical statistics to
``cxg-score --compare --bootstrap`` (cli/score.py), via the same fast
sufficient-statistics path (metrics/bootstrap.py).

  python -m controllable_xgating_torch.tools.grid_subset_report \\
      --data_dir data/grid_v2_heldout --split train \\
      --cell xgate_pos=checkpoints/grid_v2/heldout_xgate_pos_scst.json \\
      --cell concat_nopos=... [--pair xgate_pos:concat_nopos ...] \\
      --bootstrap 2000 --out checkpoints/grid_v2/heldout_report.md

Counterpart of the JAX package's `tools/grid_subset_report.py`, on the
port's `cli/score.py`, `metrics/harness.py` and `metrics/bootstrap.py`:
the same tables, pairs, subsets and statistics. Host code only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from controllable_xgating_torch.cli.score import (
    bootstrap_metrics,
    load_candidates,
    load_corpus_references,
)
from controllable_xgating_torch.metrics.harness import language_eval

# the four standard 2x2 comparisons, in the order RESULTS.md tables them:
# gating effect without/with psi, full-vs-doubly-ablated, psi effect.
DEFAULT_PAIRS = [
    ("xgate_nopos", "concat_nopos"),
    ("xgate_pos", "concat_pos"),
    ("xgate_pos", "concat_nopos"),
    ("xgate_pos", "xgate_nopos"),
]


def corrupted_flags(meta_path: str, key: str = "corrupted") -> dict[str, bool]:
    with open(meta_path) as f:
        meta = json.load(f)
    missing = [k for k, v in meta["videos"].items() if key not in v]
    if missing:
        raise SystemExit(
            f"{meta_path}: {len(missing)} videos lack {key!r} "
            "(wrong corpus generation for this subset key?)")
    return {str(k): bool(v[key]) for k, v in meta["videos"].items()}


def interaction_delta(gts, res_a, res_b, corr_ids, clean_ids,
                      n_boot, seed, metric):
    """Difference-in-differences: is the A−B delta LARGER on the
    corrupted subset than on the clean one?

    The per-subset tables answer "is A better than B within this
    subset"; the mechanism claim ("the gating win CONCENTRATES on
    corrupted videos") is about the INTERACTION, which needs its own
    test. Stratified bootstrap: resample within each subset
    independently (each scored with its own subset idf, same convention
    as the subset tables), D = delta_corrupted − delta_clean per
    resample, add-one-smoothed two-sided p.
    """
    from controllable_xgating_torch.metrics.bootstrap import (
        FastPairedBootstrap,
    )

    fbs, points = {}, {}
    for name, ids in (("corr", corr_ids), ("clean", clean_ids)):
        g = {k: gts[k] for k in ids}
        ra = {k: res_a[k] for k in ids}
        rb = {k: res_b[k] for k in ids}
        fbs[name] = FastPairedBootstrap(g, ra, rb, [metric])
        points[name] = (language_eval(g, ra, metrics=[metric])[metric]
                        - language_eval(g, rb, metrics=[metric])[metric])
    rng = np.random.default_rng(seed)
    ds = np.empty(n_boot)
    for i in range(n_boot):
        d = {}
        for name, fb in fbs.items():
            row, row2 = fb.resample(rng.integers(0, fb.V, fb.V))
            d[name] = row[metric] - row2[metric]
        ds[i] = d["corr"] - d["clean"]
    p_val = 2.0 * min((1 + int((ds <= 0).sum())) / (n_boot + 1),
                      (1 + int((ds >= 0).sum())) / (n_boot + 1))
    return {
        "point": round(points["corr"] - points["clean"], 4),
        "ci95": [round(float(x), 4) for x in np.percentile(ds, [2.5, 97.5])],
        "p": round(min(p_val, 1.0), 4),
    }


def paired_delta(gts, res_a, res_b, n_boot, seed, metric):
    """Point scores for both sides + paired-bootstrap delta on `metric`.

    Same resample stream and p-value convention as cli/score.py main().
    """
    point_a = language_eval(gts, res_a, metrics=[metric])[metric]
    point_b = language_eval(gts, res_b, metrics=[metric])[metric]
    rows, rows2 = bootstrap_metrics(gts, res_a, res_b, n_boot, seed, [metric])
    d = np.asarray([a[metric] - b[metric] for a, b in zip(rows, rows2)])
    p_val = 2.0 * min((1 + int((d <= 0).sum())) / (n_boot + 1),
                      (1 + int((d >= 0).sum())) / (n_boot + 1))
    return {
        "a": round(point_a, 4), "b": round(point_b, 4),
        "delta": round(point_a - point_b, 4),
        "ci95": [round(float(x), 4) for x in np.percentile(d, [2.5, 97.5])],
        "p": round(min(p_val, 1.0), 4),
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data_dir", required=True)
    p.add_argument("--split", default=None)
    p.add_argument("--meta", default=None,
                   help="fixture_meta.json with per-video corrupted flags "
                        "(default: <data_dir>/fixture_meta.json)")
    p.add_argument("--cell", action="append", required=True,
                   metavar="NAME=PATH", help="a grid cell's eval json")
    p.add_argument("--pair", action="append", default=None, metavar="A:B",
                   help="comparison A minus B (default: the standard 2x2 "
                        "set for cells named {xgate,concat}_{pos,nopos})")
    p.add_argument("--metric", default="CIDEr")
    p.add_argument("--bootstrap", type=int, default=2000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="also write markdown here")
    p.add_argument("--subset_key", default="corrupted",
                   help="boolean per-video fixture_meta field to stratify "
                        "by (e.g. 'corrupted', or 'style' on a v3 corpus)")
    p.add_argument("--interaction", action="store_true",
                   help="additionally bootstrap the corrupted-minus-clean "
                        "difference-in-differences per pair (the mechanism "
                        "claim's own test)")
    args = p.parse_args(argv)

    cells = {}
    for spec in args.cell:
        name, _, path = spec.partition("=")
        if not path:
            p.error(f"--cell {spec!r}: expected NAME=PATH")
        cells[name] = load_candidates(path)
    pairs = ([tuple(s.split(":", 1)) for s in args.pair] if args.pair
             else [pr for pr in DEFAULT_PAIRS
                   if pr[0] in cells and pr[1] in cells])
    for a, b in pairs:
        for name in (a, b):
            if name not in cells:
                p.error(f"pair names a cell not given via --cell: {name}")

    gts_all = load_corpus_references(args.data_dir, args.split)
    flags = corrupted_flags(
        args.meta or os.path.join(args.data_dir, "fixture_meta.json"),
        args.subset_key)
    ids = sorted(next(iter(cells.values())))
    for name, res in cells.items():
        if sorted(res) != ids:
            p.error(f"cell {name} covers different video ids")
        missing = [k for k in ids if k not in gts_all]
        if missing:
            p.error(f"{len(missing)} candidate ids lack references "
                    f"(first: {missing[:3]}); check --split")
    on_name, off_name = (("corrupted", "clean")
                         if args.subset_key == "corrupted"
                         else (args.subset_key, f"not_{args.subset_key}"))
    subsets = {
        "pooled": ids,
        on_name: [k for k in ids if flags[k]],
        off_name: [k for k in ids if not flags[k]],
    }
    empty = [s for s, v in subsets.items() if not v]
    for s in empty:
        # An all-clean (or all-corrupted) corpus would otherwise produce
        # degenerate 0.0/NaN point scores and p-values with no warning.
        print(f"note: subset {s!r} is empty on this corpus — skipped",
              file=sys.stderr)
        del subsets[s]

    lines = [f"# Subset report — {args.data_dir} [{args.split or 'all'}], "
             f"{args.metric}, {args.bootstrap} resamples",
             "",
             "Per-cell point scores:", "",
             "| cell | " + " | ".join(f"{s} (n={len(v)})"
                                      for s, v in subsets.items()) + " |",
             "|---|" + "---|" * len(subsets)]
    for name, res in cells.items():
        row = [name]
        for sub_ids in subsets.values():
            g = {k: gts_all[k] for k in sub_ids}
            r = {k: res[k] for k in sub_ids}
            row.append(f"{language_eval(g, r, metrics=[args.metric])[args.metric]:.4f}")
        lines.append("| " + " | ".join(row) + " |")

    lines += ["", f"Paired deltas ({args.metric}, A − B):", "",
              "| A − B | " + " | ".join(subsets) + " |",
              "|---|" + "---|" * len(subsets)]
    for a, b in pairs:
        row = [f"{a} − {b}"]
        for sub_ids in subsets.values():
            g = {k: gts_all[k] for k in sub_ids}
            ra = {k: cells[a][k] for k in sub_ids}
            rb = {k: cells[b][k] for k in sub_ids}
            st = paired_delta(g, ra, rb, args.bootstrap, args.seed,
                              args.metric)
            row.append(f"{st['delta']:+.3f} (p={st['p']:.3f})")
        lines.append("| " + " | ".join(row) + " |")

    if args.interaction:
        if on_name in subsets and off_name in subsets:
            lines += ["", f"Interaction (delta on {on_name} − delta on "
                          f"{off_name}; stratified bootstrap):", "",
                      f"| A − B | {on_name}−{off_name} | 95% CI | p |",
                      "|---|---|---|---|"]
            for a, b in pairs:
                st = interaction_delta(
                    gts_all, cells[a], cells[b],
                    subsets[on_name], subsets[off_name],
                    args.bootstrap, args.seed, args.metric)
                lines.append(
                    f"| {a} − {b} | {st['point']:+.3f} "
                    f"| [{st['ci95'][0]:+.3f}, {st['ci95'][1]:+.3f}] "
                    f"| {st['p']:.3f} |")
        else:
            lines += ["", f"Interaction test skipped: {on_name} or "
                          f"{off_name} subset is empty on this corpus."]

    text = "\n".join(lines) + "\n"
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)


if __name__ == "__main__":
    main()
