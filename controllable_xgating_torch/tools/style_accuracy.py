"""Style accuracy: does a model realize each video's latent STYLE?

Corpus v3's mechanism readout: the corpus makes the correct caption
syntax-dependent (data/fixtures.py `feature_map="syntax"`:
style 0 = progressive, style 1 = simple-present with fronted place). CIDEr
measures the consequence; this tool measures the mechanism directly — the
fraction of generated captions whose verb form matches the video's style
(classified by the generator's own verb banks, so the readout is exact on
this corpus).

  python -m controllable_xgating_torch.tools.style_accuracy \
      --candidates eval.json --meta data/grid_v3_heldout/fixture_meta.json

Counterpart of the JAX package's `tools/style_accuracy.py`, on the port's
`ACTIONS` and `load_candidates`. Host code only.
"""

from __future__ import annotations

import argparse
import json
import os

from controllable_xgating_torch.cli.score import load_candidates
from controllable_xgating_torch.data.fixtures import ACTIONS

ING = {a[0].split()[-1] for a in ACTIONS}
SG = {a[1] for a in ACTIONS}


def classify(caption: str) -> int | None:
    """0=progressive, 1=simple-present, None=no/both verb forms."""
    words = set(caption.replace(".", " ").split())
    has_ing, has_sg = bool(words & ING), bool(words & SG)
    if has_ing == has_sg:
        return None
    return 0 if has_ing else 1


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--candidates", required=True, nargs="+",
                   metavar="NAME=PATH|PATH")
    p.add_argument("--meta", required=True,
                   help="fixture_meta.json with per-video style")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    with open(args.meta) as f:
        meta = json.load(f)
    styles = {k: v.get("style") for k, v in meta["videos"].items()}
    if any(v is None for v in styles.values()):
        p.error(f"{args.meta}: no per-video style (not a v3 'syntax' corpus)")

    report = {}
    for spec in args.candidates:
        name, _, path = spec.rpartition("=")
        name = name or os.path.basename(path)
        res = load_candidates(path)
        n = ok = none = 0
        per_style = {0: [0, 0], 1: [0, 0]}  # style -> [correct, total]
        for vid, caps in res.items():
            st = styles.get(vid)
            if st is None:
                continue
            got = classify(caps[0])
            n += 1
            per_style[st][1] += 1
            if got is None:
                none += 1
            elif got == st:
                ok += 1
                per_style[st][0] += 1
        report[name] = {
            "n": n,
            "style_accuracy": round(ok / n, 4) if n else None,
            "unclassifiable": none,
            "acc_progressive": (round(per_style[0][0] / per_style[0][1], 4)
                                if per_style[0][1] else None),
            "acc_simple": (round(per_style[1][0] / per_style[1][1], 4)
                           if per_style[1][1] else None),
        }
    text = json.dumps(report, indent=2)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)


if __name__ == "__main__":
    main()
