"""CIDEr and CIDEr-D (Vedantam et al., 2015), coco-caption flavor.

Rebuilds coco-caption's `Cider`/`CiderD` scorers (SURVEY.md §2). CIDEr-D is
also the SCST reward (SURVEY.md §3.2): `CiderDScorer` supports a document
frequency table precomputed on the *training* corpus (the reference ships
this as a pickle for its `CiderD` reward) as well as the default
compute-df-from-eval-refs mode. `ops/cider_device.py` reimplements exactly
this math on device; tests golden-diff the two.

Definitions used (paper + coco implementation):
  * n-grams n = 1..4; per caption, term frequencies g_n.
  * tf-idf vector: g_k * log(N / max(df_k, 1)); N = number of segments in
    the df corpus (ref_len). Unseen n-grams get idf = log(N).
  * CIDEr: per n, cosine similarity between candidate and each ref,
    averaged over refs, then averaged over n, times 10.
  * CIDEr-D adds: candidate tf clipped to the ref's tf (per n-gram,
    min(c, r) in the dot product), and a Gaussian length penalty
    exp(-(lc - lr)^2 / (2 sigma^2)) with sigma = 6; norms clipped.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Mapping, Optional, Sequence


def ngram_counts(tokens: Sequence[str], max_n: int = 4) -> list[Counter]:
    return [
        Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))
        for n in range(1, max_n + 1)
    ]


def compute_doc_freq(
    refs_per_key: Mapping[str, Sequence[str]], max_n: int = 4
) -> tuple[dict, int]:
    """df over segments: an n-gram counts once per segment it appears in.

    Returns (df dict {ngram_tuple: count}, num_segments). This is the
    host-side builder for the SCST reward table as well (reference ships
    the equivalent as a train-corpus pickle).
    """
    df: dict = defaultdict(float)
    num = 0
    for refs in refs_per_key.values():
        num += 1
        seen = set()
        for ref in refs:
            toks = ref.split()
            for n in range(1, max_n + 1):
                for i in range(len(toks) - n + 1):
                    seen.add(tuple(toks[i : i + n]))
        for ng in seen:
            df[ng] += 1.0
    return dict(df), num


class _CiderBase:
    def __init__(
        self,
        max_n: int = 4,
        sigma: float = 6.0,
        df: Optional[dict] = None,
        df_num_segments: Optional[int] = None,
    ):
        self.max_n = max_n
        self.sigma = sigma
        self._df = df
        self._df_num = df_num_segments
        if (df is None) != (df_num_segments is None):
            raise ValueError("df and df_num_segments must be given together")

    def _vec(self, tokens: Sequence[str], df: dict, log_n: float):
        """tf-idf vectors per n + norms + length."""
        vecs = []
        norms = []
        counts = ngram_counts(tokens, self.max_n)
        for n_counts in counts:
            vec = {}
            norm = 0.0
            for ng, tf in n_counts.items():
                idf = log_n - math.log(max(df.get(ng, 0.0), 1.0))
                v = tf * idf
                vec[ng] = v
                norm += v * v
            vecs.append(vec)
            norms.append(math.sqrt(norm))
        return vecs, norms, len(tokens)

    def score(
        self,
        gts: Mapping[str, Sequence[str]],
        res: Mapping[str, Sequence[str]],
    ) -> tuple[float, list[float]]:
        if self._df is not None:
            df, num = self._df, self._df_num
        else:
            df, num = compute_doc_freq(gts, self.max_n)
        log_n = math.log(max(num, 1))
        per_key = []
        for key in res:
            if len(res[key]) != 1:
                raise ValueError("exactly one candidate per key expected")
            cand = res[key][0].split()
            c_vecs, c_norms, c_len = self._vec(cand, df, log_n)
            score_n = [0.0] * self.max_n
            refs = gts[key]
            for ref_str in refs:
                ref = ref_str.split()
                r_vecs, r_norms, r_len = self._vec(ref, df, log_n)
                for n in range(self.max_n):
                    score_n[n] += self._pair_sim(
                        c_vecs[n], c_norms[n], c_len,
                        r_vecs[n], r_norms[n], r_len,
                    )
            s = sum(score_n) / self.max_n / max(len(refs), 1) * 10.0
            per_key.append(s)
        corpus = sum(per_key) / len(per_key) if per_key else 0.0
        return corpus, per_key

    def _pair_sim(self, cv, cn, cl, rv, rn, rl) -> float:
        raise NotImplementedError


class CiderScorer(_CiderBase):
    """Plain CIDEr: cosine similarity, no clipping or length penalty."""

    def _pair_sim(self, cv, cn, cl, rv, rn, rl) -> float:
        if cn == 0.0 or rn == 0.0:
            return 0.0
        dot = sum(v * rv[ng] for ng, v in cv.items() if ng in rv)
        return dot / (cn * rn)


class CiderDScorer(_CiderBase):
    """CIDEr-D: tf clipped to the reference + Gaussian length penalty."""

    def _pair_sim(self, cv, cn, cl, rv, rn, rl) -> float:
        if cn == 0.0 or rn == 0.0:
            return 0.0
        # min-clip the candidate's tf-idf against the ref's per ngram
        dot = sum(min(v, rv[ng]) * rv[ng] for ng, v in cv.items() if ng in rv)
        delta = float(cl - rl)
        penalty = math.exp(-(delta**2) / (2.0 * self.sigma**2))
        return penalty * dot / (cn * rn)
