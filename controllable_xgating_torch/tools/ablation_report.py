"""Render grid_results.json (tools/ablation_grid.py) as a markdown table,
with optional statistical + per-subset analysis.

  python -m controllable_xgating_torch.tools.ablation_report \\
      checkpoints/ablation_grid/grid_results.json

With --data_dir the report adds what the raw table cannot say:

  * paired-bootstrap deltas (cli/score.py machinery) for the paper's two
    ablation comparisons (xgate_pos vs concat_pos; xgate_pos vs
    xgate_nopos) and the fourth-corner comparison (xgate_pos vs
    concat_nopos), on the SCST beam-5 test evals;
  * if the corpus carries a generator sidecar (fixture_meta.json, corpus
    v2) — a corrupted-vs-clean test-video breakdown per cell: corruption
    is exactly the situation cross gating models (paper §3.1), so the
    gating win should CONCENTRATE on the corrupted subset.

  python -m controllable_xgating_torch.tools.ablation_report \\
      checkpoints/grid_v2/grid_results.json --data_dir data/flagship_v2 \\
      --grid_dir checkpoints/grid_v2 --bootstrap 1000

Counterpart of the JAX package's `tools/ablation_report.py`, on the port's
`cli/score.py` and `metrics/harness.py`: the same table, comparisons and
statistics. Host code only.
"""

from __future__ import annotations

import argparse
import json
import os

COMPARISONS = [
    ("xgate_pos", "concat_pos", "cross gating vs concat (psi on)"),
    ("xgate_pos", "xgate_nopos", "psi guidance vs none (fusion xgate)"),
    ("xgate_pos", "concat_nopos", "full model vs doubly-ablated baseline"),
]


def render(results: list[dict]) -> str:
    rows = []
    # lcs agreement columns appear when any cell carries the round-5
    # both-mode capture (controllability_v2 / agreement_by_mode)
    has_lcs = any("agreement_by_mode" in c.get("controllability", {})
                  for c in results)
    lcs_hdr = " tag-agree free (lcs) | tag-agree ctrl (lcs) |" if has_lcs \
        else ""
    header = (
        "| fusion | psi | XE B-4 | XE CIDEr | SCST B-4 | SCST CIDEr | "
        "SCST CIDEr-D | tag-agree free | tag-agree ctrl |" + lcs_hdr + "\n"
        "|---|---|---|---|---|---|---|---|---|"
        + ("---|---|" if has_lcs else "")
    )
    for c in results:
        cm, sm = c["caption_metrics"], c["scst_metrics"]
        ctrl = c["controllability"]
        row = (
            f"| {c['fusion']} | {'on' if c['pos_guidance'] else 'off'} "
            f"| {cm['Bleu_4']:.4f} | {cm['CIDEr']:.4f} "
            f"| {sm['Bleu_4']:.4f} | {sm['CIDEr']:.4f} "
            f"| {sm['CIDErD']:.4f} "
            f"| {ctrl['free_run_tag_agreement']:.4f} "
            f"| {ctrl['controlled_tag_agreement']:.4f} |"
        )
        if has_lcs:
            lcs = ctrl.get("agreement_by_mode", {}).get("lcs")
            row += (
                f" {lcs['free_run_tag_agreement']:.4f} "
                f"| {lcs['controlled_tag_agreement']:.4f} |"
                if lcs else " — | — |"
            )
        rows.append(row)
    return header + "\n" + "\n".join(rows)


def _cell_captions(grid_dir: str, cell: str, stage: str = "scst") -> dict:
    path = os.path.join(grid_dir, cell, stage, "eval_test.json")
    with open(path) as f:
        caps = json.load(f)["captions"]
    return {k: v if isinstance(v, list) else [v] for k, v in caps.items()}


def significance(grid_dir: str, data_dir: str, n: int, seed: int) -> list:
    """Paired-bootstrap CIDEr deltas for the three grid comparisons."""
    import numpy as np

    from controllable_xgating_torch.cli.score import (
        bootstrap_metrics,
        load_corpus_references,
    )
    from controllable_xgating_torch.metrics.harness import language_eval

    gts = load_corpus_references(data_dir, "test")
    out = []
    for a, b, label in COMPARISONS:
        try:
            res_a = _cell_captions(grid_dir, a)
            res_b = _cell_captions(grid_dir, b)
        except FileNotFoundError as e:
            out.append({"comparison": label, "skipped": str(e)})
            continue
        point_a = language_eval(gts, res_a, metrics=("CIDEr",))["CIDEr"]
        point_b = language_eval(gts, res_b, metrics=("CIDEr",))["CIDEr"]
        rows_a, rows_b = bootstrap_metrics(
            gts, res_a, res_b, n, seed, ("CIDEr",))
        deltas = np.asarray(
            [ra["CIDEr"] - rb["CIDEr"] for ra, rb in zip(rows_a, rows_b)]
        )
        lo, hi = np.percentile(deltas, [2.5, 97.5])
        # add-one-smoothed two-sided percentile p (cli/score.py convention)
        p = 2 * min(
            (1 + (deltas <= 0).sum()) / (n + 1),
            (1 + (deltas >= 0).sum()) / (n + 1),
        )
        out.append({
            "comparison": label,
            "cells": [a, b],
            "cider": [round(point_a, 4), round(point_b, 4)],
            "delta": round(point_a - point_b, 4),
            "delta_ci95": [round(float(lo), 4), round(float(hi), 4)],
            "p": round(min(p, 1.0), 4),
        })
    return out


def subset_breakdown(grid_dir: str, data_dir: str, cells: list[str]) -> list:
    """Per-cell CIDEr on corrupted vs clean test videos (corpus v2)."""
    from controllable_xgating_torch.cli.score import load_corpus_references
    from controllable_xgating_torch.metrics.harness import language_eval

    meta_path = os.path.join(data_dir, "fixture_meta.json")
    if not os.path.exists(meta_path):
        return []
    with open(meta_path) as f:
        meta = json.load(f)["videos"]
    gts = load_corpus_references(data_dir, "test")
    corrupted = {k for k in gts if meta.get(k, {}).get("corrupted")}
    if not corrupted or len(corrupted) == len(gts):
        return []
    out = []
    for cell in cells:
        try:
            res = _cell_captions(grid_dir, cell)
        except FileNotFoundError:
            continue
        row = {"cell": cell, "n_corrupted": len(corrupted),
               "n_clean": len(gts) - len(corrupted)}
        for name, keys in (
            ("corrupted", corrupted),
            ("clean", set(gts) - corrupted),
        ):
            g = {k: gts[k] for k in keys}
            r = {k: res[k] for k in keys}
            row[f"cider_{name}"] = round(
                language_eval(g, r, metrics=("CIDEr",))["CIDEr"], 4)
        out.append(row)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("results", nargs="?",
                   default="checkpoints/ablation_grid/grid_results.json")
    p.add_argument("--data_dir", default=None,
                   help="corpus dir: enables bootstrap significance and "
                        "(with fixture_meta.json) the corrupted-vs-clean "
                        "breakdown")
    p.add_argument("--grid_dir", default=None,
                   help="grid output dir holding <cell>/scst/eval_test.json "
                        "(default: the results file's directory)")
    p.add_argument("--bootstrap", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    with open(args.results) as f:
        results = json.load(f)
    print(render(results))

    if args.data_dir:
        grid_dir = args.grid_dir or os.path.dirname(
            os.path.abspath(args.results))
        cells = [
            f"{c['fusion']}_{'pos' if c['pos_guidance'] else 'nopos'}"
            for c in results
        ]
        sig = significance(grid_dir, args.data_dir, args.bootstrap, args.seed)
        print("\n## Paired-bootstrap significance (SCST beam-5 test, CIDEr)")
        print(json.dumps(sig, indent=2))
        sub = subset_breakdown(grid_dir, args.data_dir, cells)
        if sub:
            print("\n## Corrupted-vs-clean test subset CIDEr (corpus v2)")
            print(json.dumps(sub, indent=2))


if __name__ == "__main__":
    main()
