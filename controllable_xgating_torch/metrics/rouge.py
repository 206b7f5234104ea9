"""ROUGE-L (Lin, 2004), coco-caption flavor.

Rebuilds coco-caption's `Rouge` scorer (SURVEY.md §2): per segment, LCS
against each reference gives precision/recall; the *maximum* precision and
maximum recall over the reference set feed an F-measure with beta = 1.2;
the corpus score is the mean over segments.
"""

from __future__ import annotations

from typing import Mapping, Sequence


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    """Classic O(len(a)*len(b)) DP, rolling row."""
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y else max(prev[j], cur[-1]))
        prev = cur
    return prev[-1]


class RougeScorer:
    def __init__(self, beta: float = 1.2):
        self.beta = beta

    def score_single(self, refs: Sequence[str], cand: str) -> float:
        hyp = cand.split()
        precs, recs = [], []
        for ref_str in refs:
            ref = ref_str.split()
            lcs = _lcs_len(hyp, ref)
            precs.append(lcs / len(hyp) if hyp else 0.0)
            recs.append(lcs / len(ref) if ref else 0.0)
        p, r = max(precs, default=0.0), max(recs, default=0.0)
        if p == 0.0 or r == 0.0:
            return 0.0
        b2 = self.beta**2
        return (1 + b2) * p * r / (r + b2 * p)

    def score(
        self,
        gts: Mapping[str, Sequence[str]],
        res: Mapping[str, Sequence[str]],
    ) -> tuple[float, list[float]]:
        per_key = []
        for key in res:
            if len(res[key]) != 1:
                raise ValueError("exactly one candidate per key expected")
            per_key.append(self.score_single(gts[key], res[key][0]))
        corpus = sum(per_key) / len(per_key) if per_key else 0.0
        return corpus, per_key
