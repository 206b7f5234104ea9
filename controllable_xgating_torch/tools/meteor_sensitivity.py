"""Bound METEOR's divergence from meteor-1.5.jar's unavailable data files.

Two documented divergences in metrics/meteor.py are data-gated (SURVEY.md
§2 "document any divergence"): the jar's LEARNED function-word list (ours
is a ~40-word hand list) and its Snowball stemmer (ours is Porter). This
tool measures how much either choice can move the corpus score on the
fixture corpus, using caption-realistic hypothesis/reference pairs (each
video's paraphrase variant 0 scored against its remaining references —
near-matches with syntactic variation, the regime METEOR discriminates).

Sensitivity probes:
  * function-word list: drop random subsets of the current list, extend it
    with the era-typical closed-class words it omits, and the extreme of
    NO function-word discounting (every word weighs DELTA).
  * stemmer: an upper bound on ANY stemmer disagreement — the score delta
    between the full scorer and exact-only matching (stem stage disabled).
    Porter vs Snowball can only alter stem-stage matches, so their
    divergence is <= this delta.

Prints one JSON report; docs/RESULTS.md records the measured bound.

  python -m controllable_xgating_torch.tools.meteor_sensitivity [--videos 200] [--seed 0]

Counterpart of the JAX package's `tools/meteor_sensitivity.py`, on the
port's `metrics/meteor.py` and `data/fixtures.py`: the same probes and
report. Host code only.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from controllable_xgating_torch.metrics.meteor import (
    _FUNCTION_WORDS,
    meteor_single,
)

# closed-class English words the hand list omits but the jar's learned
# list plausibly contains (pronouns, modals, prepositions, determiners)
EXTRA_FUNCTION_WORDS = {
    "he", "she", "we", "they", "you", "i", "his", "her", "their", "our",
    "your", "my", "him", "them", "who", "what", "which", "when", "where",
    "how", "why", "will", "would", "can", "could", "shall", "should",
    "may", "might", "must", "about", "into", "through", "over", "under",
    "between", "against", "during", "before", "after", "above", "below",
    "up", "down", "out", "off", "all", "each", "every", "both", "some",
    "any", "such", "own", "same", "while", "because", "until",
}


def corpus_pairs(num_videos: int, seed: int):
    """[(hyp, [refs...])]: each scene's paraphrase variant 0 scored
    against its remaining reference variants (the fixture generator's
    multi-reference sets — data/fixtures.py)."""
    from controllable_xgating_torch.data.fixtures import (
        ACTIONS,
        PLACES,
        SUBJECTS,
        Scene,
        _render_captions,
    )

    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(num_videos):
        sc = Scene(
            subject=int(rng.integers(len(SUBJECTS))),
            action=int(rng.integers(len(ACTIONS))),
            place=int(rng.integers(len(PLACES))),
        )
        caps = [c.rstrip(".").lower() for c in _render_captions(sc, rng, 6)]
        pairs.append((caps[0], caps[1:]))
    return pairs


def corpus_score(pairs, **kw) -> float:
    return float(np.mean([meteor_single(h, r, **kw) for h, r in pairs]))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--videos", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--drops", type=int, default=8,
                   help="random drop-k perturbations of the word list")
    args = p.parse_args(argv)

    pairs = corpus_pairs(args.videos, args.seed)
    base = corpus_score(pairs)

    rng = np.random.default_rng(args.seed)
    words = sorted(_FUNCTION_WORDS)
    drop_deltas = []
    for _ in range(args.drops):
        keep = set(words) - set(
            rng.choice(words, size=len(words) // 4, replace=False)
        )
        drop_deltas.append(corpus_score(pairs, function_words=keep) - base)
    extended = corpus_score(
        pairs, function_words=_FUNCTION_WORDS | EXTRA_FUNCTION_WORDS
    )
    no_discount = corpus_score(pairs, function_words=frozenset())
    exact_only = corpus_score(pairs, use_stem=False)

    report = {
        "videos": len(pairs),
        "corpus_meteor": round(base, 6),
        "function_word_list": {
            "size": len(words),
            "drop_quarter_delta_max_abs": round(
                max(abs(d) for d in drop_deltas), 6),
            "extended_list_delta": round(extended - base, 6),
            "no_discount_delta": round(no_discount - base, 6),
        },
        "stemmer": {
            # Porter-vs-Snowball can only differ on stem-stage matches;
            # removing the stage entirely bounds any stemmer's effect
            "exact_only_delta_bound": round(base - exact_only, 6),
        },
    }
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
