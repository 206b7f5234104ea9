"""Convert standard MSR-VTT / MSVD annotation files to the port's prepro
inputs.

The reference trains from the MSR-VTT `videodatainfo.json` release format
(`{"videos": [{"video_id", "split", ...}], "sentences": [{"video_id",
"caption", ...}]}`) and from MSVD's per-video caption lists. This tool maps
either format onto the `captions.json` + `splits.json` pair that
`cli/prepro.py` takes, so the same downloads reach the card.

Counterpart of the JAX package's `tools/convert_msrvtt.py`: the same
flags, outputs and summary line. Host code only.

Usage:
  python -m controllable_xgating_torch.tools.convert_msrvtt \\
      --videodatainfo videodatainfo.json --out_captions caps.json --out_splits splits.json
  python -m controllable_xgating_torch.tools.convert_msrvtt \\
      --msvd_corpus msvd_captions.txt --split_counts 1200 100 \\
      --out_captions caps.json --out_splits splits.json
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict


def convert_videodatainfo(path: str):
    with open(path) as f:
        data = json.load(f)
    captions = defaultdict(list)
    for s in data["sentences"]:
        captions[s["video_id"]].append(s["caption"])
    splits = defaultdict(list)
    for v in data["videos"]:
        split = v.get("split", "train")
        # MSR-VTT uses "validate" for the val split
        split = {"validate": "val"}.get(split, split)
        splits[split].append(v["video_id"])
    return dict(captions), {k: splits.get(k, []) for k in ("train", "val", "test")}


def convert_msvd(path: str, split_counts):
    """MSVD flat corpus: one `<video_id>\\t<caption>` (or space-separated)
    line per caption; splits by the conventional 1200/100/670 video counts
    in first-appearance order."""
    captions = defaultdict(list)
    order = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if "\t" in line:
                vid, cap = line.split("\t", 1)
            else:
                vid, cap = line.split(" ", 1)
            if vid not in captions:
                order.append(vid)
            captions[vid].append(cap)
    n_train, n_val = split_counts
    return dict(captions), {
        "train": order[:n_train],
        "val": order[n_train : n_train + n_val],
        "test": order[n_train + n_val :],
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--videodatainfo", help="MSR-VTT videodatainfo.json")
    p.add_argument("--msvd_corpus", help="MSVD '<vid>\\t<caption>' file")
    p.add_argument("--split_counts", type=int, nargs=2, default=(1200, 100),
                   help="MSVD train/val video counts (rest = test)")
    p.add_argument("--out_captions", required=True)
    p.add_argument("--out_splits", required=True)
    args = p.parse_args(argv)

    if bool(args.videodatainfo) == bool(args.msvd_corpus):
        p.error("give exactly one of --videodatainfo / --msvd_corpus")
    if args.videodatainfo:
        captions, splits = convert_videodatainfo(args.videodatainfo)
    else:
        captions, splits = convert_msvd(args.msvd_corpus, args.split_counts)

    with open(args.out_captions, "w") as f:
        json.dump(captions, f)
    with open(args.out_splits, "w") as f:
        json.dump(splits, f)
    print(json.dumps({
        "videos": len(captions),
        "captions": sum(len(v) for v in captions.values()),
        "splits": {k: len(v) for k, v in splits.items()},
    }))


if __name__ == "__main__":
    main()
