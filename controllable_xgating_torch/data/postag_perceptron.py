"""Trainable averaged-perceptron POS tagger (Collins 2002 style).

The port's own copy of the JAX package's module of the same name: the same
seed and sentences give the same weights, and a model saved by either
package loads in the other (tests/test_torch_postag_perceptron.py).

The reference tags captions with NLTK's pretrained tagger (SURVEY.md §2
"Corpus prep"); offline we ship the self-contained rule tagger in
`postag.py`, which covers caption English but cannot adapt. This module is
the trainable path (docs/ROADMAP.md item 5): a user with ANY tagged corpus
(their own domain, another language's tagset) trains a model offline with
`python -m controllable_xgating_torch.tools.train_tagger` and passes it to
prepro via `--tagger perceptron --tagger_model model.json`.

Algorithm: greedy left-to-right decoding over a linear model with local
features (word, affixes, shape, previous two predicted tags, adjacent
words), trained by the averaged perceptron — the classic fast/accurate
recipe (~97% on WSJ in the literature) with zero dependencies. Weight
averaging uses the standard lazy totals/timestamps trick so training is
O(updates), not O(updates × features).

This is a host-side offline prep tool — plain Python by design, like the
tokenizer; it never runs on the device hot path.
"""

from __future__ import annotations

import json
import random
from collections import defaultdict
from typing import Iterable, Sequence

START = ("-START-", "-START2-")


def _features(i: int, word: str, context: Sequence[str],
              prev: str, prev2: str) -> list[str]:
    """Feature strings for position i. `context` is START + words + END."""
    j = i + len(START)  # index into padded context
    w = word.lower()
    feats = [
        "bias",
        "w=" + w,
        "suf3=" + w[-3:],
        "suf2=" + w[-2:],
        "suf1=" + w[-1:],
        "pre1=" + w[:1],
        "shape=" + (
            "d" if w.isdigit() else "h" if "-" in w else
            "u" if word[:1].isupper() else "l"
        ),
        "t-1=" + prev,
        "t-2=" + prev2,
        "t-1t-2=" + prev + "|" + prev2,
        "t-1w=" + prev + "|" + w,
        "w-1=" + context[j - 1],
        "w-1suf3=" + context[j - 1][-3:],
        "w-2=" + context[j - 2],
        "w+1=" + context[j + 1],
        "w+1suf3=" + context[j + 1][-3:],
        "w+2=" + context[j + 2],
    ]
    return feats


class PerceptronTagger:
    """Averaged-perceptron POS tagger; train/save/load/tag."""

    def __init__(self):
        # weights[feature][tag] = float
        self.weights: dict[str, dict[str, float]] = {}
        self.tags: list[str] = []
        # single-tag lexicon for unambiguous frequent words (fast + exact)
        self.lexicon: dict[str, str] = {}
        # averaging accumulators (training only)
        self._totals: dict[tuple[str, str], float] = defaultdict(float)
        self._stamps: dict[tuple[str, str], int] = defaultdict(int)
        self._updates = 0

    # ------------------------------------------------------------- inference

    def _score(self, feats: Sequence[str]) -> dict[str, float]:
        scores: dict[str, float] = defaultdict(float)
        for f in feats:
            row = self.weights.get(f)
            if row:
                for tag, w in row.items():
                    scores[tag] += w
        return scores

    def _predict(self, feats: Sequence[str]) -> str:
        scores = self._score(feats)
        # deterministic tie-break: highest score, then lexicographic tag
        return max(self.tags, key=lambda t: (scores.get(t, 0.0), t))

    def tag(self, tokens: list[str]) -> list[str]:
        if not self.tags:
            raise RuntimeError("tagger is untrained (no tags); call train() "
                               "or load() first")
        context = list(START) + [t.lower() for t in tokens] + ["-END-", "-END2-"]
        prev, prev2 = START
        out = []
        for i, tok in enumerate(tokens):
            tag = self.lexicon.get(tok.lower())
            if tag is None:
                tag = self._predict(_features(i, tok, context, prev, prev2))
            out.append(tag)
            prev2, prev = prev, tag
        return out

    # -------------------------------------------------------------- training

    def _upd(self, tag: str, feats: Sequence[str], delta: float) -> None:
        for f in feats:
            key = (f, tag)
            row = self.weights.setdefault(f, {})
            w = row.get(tag, 0.0)
            # lazy averaging: settle this weight's contribution up to now
            self._totals[key] += (self._updates - self._stamps[key]) * w
            self._stamps[key] = self._updates
            row[tag] = w + delta

    def train(
        self,
        sentences: Iterable[tuple[list[str], list[str]]],
        epochs: int = 5,
        seed: int = 0,
        lexicon_min_freq: int = 5,
        lexicon_purity: float = 0.99,
    ) -> "PerceptronTagger":
        """Fit on (tokens, tags) pairs. Returns self.

        Frequent words whose tag distribution is >= `lexicon_purity` pure
        go into a closed lexicon (tagged without the model — faster and
        immune to feature noise), mirroring the standard recipe.
        """
        data = [(list(t), list(g)) for t, g in sentences]
        for toks, gold in data:
            if len(toks) != len(gold):
                raise ValueError("tokens/tags length mismatch")
        tagset = sorted({g for _, gold in data for g in gold})
        if not tagset:
            raise ValueError("no training data")
        self.tags = tagset

        counts: dict[str, dict[str, int]] = defaultdict(lambda: defaultdict(int))
        for toks, gold in data:
            for w, g in zip(toks, gold):
                counts[w.lower()][g] += 1
        self.lexicon = {}
        for w, dist in counts.items():
            n = sum(dist.values())
            tag, c = max(dist.items(), key=lambda kv: (kv[1], kv[0]))
            if n >= lexicon_min_freq and c / n >= lexicon_purity:
                self.lexicon[w] = tag

        rng = random.Random(seed)
        for _ in range(epochs):
            rng.shuffle(data)
            for toks, gold in data:
                context = (list(START) + [t.lower() for t in toks]
                           + ["-END-", "-END2-"])
                prev, prev2 = START
                for i, (tok, g) in enumerate(zip(toks, gold)):
                    low = tok.lower()
                    guess = self.lexicon.get(low)
                    if guess is None:
                        feats = _features(i, tok, context, prev, prev2)
                        guess = self._predict(feats)
                        self._updates += 1
                        if guess != g:
                            self._upd(g, feats, +1.0)
                            self._upd(guess, feats, -1.0)
                    # condition on GOLD history during training (standard)
                    prev2, prev = prev, g
        self._average()
        return self

    def _average(self) -> None:
        if self._updates == 0:
            return
        for f, row in self.weights.items():
            for tag in list(row):
                key = (f, tag)
                total = self._totals[key] + (
                    self._updates - self._stamps[key]
                ) * row[tag]
                avg = total / self._updates
                if abs(avg) > 1e-9:
                    row[tag] = round(avg, 6)
                else:
                    del row[tag]
        self.weights = {f: r for f, r in self.weights.items() if r}
        self._totals.clear()
        self._stamps.clear()

    def evaluate(self, sentences: Iterable[tuple[list[str], list[str]]]) -> float:
        """Token-level accuracy."""
        right = total = 0
        for toks, gold in sentences:
            pred = self.tag(list(toks))
            right += sum(p == g for p, g in zip(pred, gold))
            total += len(gold)
        return right / max(total, 1)

    # ------------------------------------------------------------- persistence

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({
                "format": "cxg-perceptron-tagger-v1",
                "tags": self.tags,
                "lexicon": self.lexicon,
                "weights": self.weights,
            }, f)

    @classmethod
    def load(cls, path: str) -> "PerceptronTagger":
        with open(path) as f:
            d = json.load(f)
        if d.get("format") != "cxg-perceptron-tagger-v1":
            raise ValueError(f"{path} is not a perceptron tagger model")
        t = cls()
        t.tags = list(d["tags"])
        t.lexicon = dict(d["lexicon"])
        t.weights = {f: dict(r) for f, r in d["weights"].items()}
        return t
