"""Train the averaged-perceptron POS tagger from a tagged corpus.

Counterpart of the JAX package's `tools/train_tagger.py`: the same file
format, seed and report, and a model file either package's prepro loads.

Input: one sentence per line, `word_TAG` pairs separated by spaces (the
classic slash/underscore tagged-text format; `word/TAG` also accepted):

    a_DT man_NN plays_VBZ guitar_NN
    the/DT dog/NN runs/VBZ

Usage:
    python -m controllable_xgating_torch.tools.train_tagger \
        --train corpus.txt --out tagger.json [--heldout dev.txt] [--epochs 5]
    python -m controllable_xgating_torch.cli.prepro ... \
        --tagger perceptron --tagger_model tagger.json
"""

from __future__ import annotations

import argparse
import json

from controllable_xgating_torch.data.postag_perceptron import PerceptronTagger


def read_tagged(path: str) -> list[tuple[list[str], list[str]]]:
    sents = []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            toks, tags = [], []
            for pair in line.split():
                # split at the RIGHTMOST of '_' or '/': handles both tagged
                # formats AND words containing the other separator
                # ("new_york/NNP" -> ("new_york", "NNP"))
                cut = max(pair.rfind("_"), pair.rfind("/"))
                if cut <= 0 or cut == len(pair) - 1:
                    raise ValueError(
                        f"{path}:{ln}: {pair!r} has no _TAG or /TAG suffix")
                w, t = pair[:cut], pair[cut + 1:]
                toks.append(w)
                tags.append(t)
            sents.append((toks, tags))
    if not sents:
        raise ValueError(f"{path}: no tagged sentences")
    return sents


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--train", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--heldout", help="tagged file for accuracy report")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    train = read_tagged(args.train)
    tagger = PerceptronTagger().train(train, epochs=args.epochs,
                                      seed=args.seed)
    tagger.save(args.out)
    report = {
        "out": args.out,
        "sentences": len(train),
        "tagset": tagger.tags,
        "train_acc": round(tagger.evaluate(train), 4),
    }
    if args.heldout:
        report["heldout_acc"] = round(
            tagger.evaluate(read_tagged(args.heldout)), 4)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
