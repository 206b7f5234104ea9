"""Corpus-level BLEU-N (Papineni et al., 2002), coco-caption flavor.

Rebuilds coco-caption's `Bleu` scorer (SURVEY.md §2): modified n-gram
precision with per-ngram clipping against the maximum reference count,
corpus-level aggregation, and brevity penalty using the *closest* reference
length per segment (ties broken toward the shorter length, as in the
standard corpus-BLEU definition coco uses).
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Mapping, Sequence


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


class BleuScorer:
    def __init__(self, n: int = 4):
        self.n = n

    def score(
        self,
        gts: Mapping[str, Sequence[str]],
        res: Mapping[str, Sequence[str]],
    ) -> tuple[list[float], list[list[float]]]:
        """Returns ([Bleu_1..Bleu_n], per-key scores list-of-lists).

        Per-key scores use the same corpus statistics restricted to that
        key (i.e. sentence-level BLEU with +0 smoothing like coco's
        per-image output).
        """
        clipped = [0] * self.n
        totals = [0] * self.n
        cand_len = 0
        ref_len = 0
        per_key: list[list[float]] = []

        keys = list(res.keys())
        for key in keys:
            if len(res[key]) != 1:
                raise ValueError("exactly one candidate per key expected")
            hyp = res[key][0].split()
            refs = [r.split() for r in gts[key]]
            c_clip = [0] * self.n
            c_tot = [0] * self.n
            for i in range(self.n):
                hyp_ng = _ngrams(hyp, i + 1)
                max_ref = Counter()
                for ref in refs:
                    for ng, cnt in _ngrams(ref, i + 1).items():
                        if cnt > max_ref[ng]:
                            max_ref[ng] = cnt
                c_clip[i] = sum(min(cnt, max_ref[ng]) for ng, cnt in hyp_ng.items())
                c_tot[i] = max(len(hyp) - i, 0)
                clipped[i] += c_clip[i]
                totals[i] += c_tot[i]
            h_len = len(hyp)
            r_len = min((abs(len(r) - h_len), len(r)) for r in refs)[1]
            cand_len += h_len
            ref_len += r_len
            per_key.append(_bleu_from_counts(c_clip, c_tot, h_len, r_len, self.n))

        corpus = _bleu_from_counts(clipped, totals, cand_len, ref_len, self.n)
        # transpose per_key to [n][num_keys] like coco returns
        per_key_t = [[pk[i] for pk in per_key] for i in range(self.n)]
        return corpus, per_key_t


def _bleu_from_counts(
    clipped: list[int], totals: list[int], cand_len: int, ref_len: int, n: int
) -> list[float]:
    """BLEU-1..n from aggregated counts. Tiny-eps numerator like coco so a
    zero count gives ~0 rather than -inf."""
    small = 1e-9
    tiny = 1e-15
    bleus = []
    log_sum = 0.0
    bp = 1.0 if cand_len > ref_len else math.exp(1 - ref_len / max(cand_len, 1)) \
        if cand_len > 0 else 0.0
    for i in range(n):
        p = (clipped[i] + tiny) / (totals[i] + small) if totals[i] > 0 else 0.0
        log_sum += math.log(max(p, tiny))
        bleus.append(bp * math.exp(log_sum / (i + 1)))
    return bleus
