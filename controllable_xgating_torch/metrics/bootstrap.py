"""Exact fast bootstrap of corpus caption metrics.

The port's own copy of the JAX package's module of the same name, on the
port's scorers (`metrics/{bleu,cider,rouge,meteor}.py`, METEOR and
ROUGE-L on the native library where it is built);
tests/test_torch_score_cli.py holds its intervals equal to the JAX
package's and to the direct path's.

`cli/score.py`'s bootstrap (and tools/ablation_report.py's significance
stage) resamples videos with replacement and recomputes the FULL corpus
metrics per resample — including the CIDEr idf over the resampled
reference multiset. The direct implementation re-runs the scorer suite
per resample (~0.5 s at 300 videos), which makes one 2000-resample
paired test a ~30-minute affair on a single host core — and the science
pipeline queues a dozen of them behind one CPU.

This module computes the SAME numbers from per-video sufficient
statistics, precomputed once:

* BLEU-N corpus scores are functions of summed per-video clipped/total
  n-gram counts and candidate/effective-reference lengths
  (metrics/bleu.py aggregates exactly these), so a resample's corpus
  BLEU is `_bleu_from_counts` applied to multiplicity-weighted sums.
* ROUGE_L and METEOR corpus scores are means of per-video scores that
  do not depend on the rest of the corpus -> multiplicity-weighted mean.
* CIDEr / CIDEr-D couple videos only through the idf table
  (log N - log df) — N, the segment count, equals the corpus size by
  construction (len(keys) draws). df of the resampled multiset is a
  multiplicity-weighted sum of per-video n-gram indicator vectors, and
  every cosine term factors as (precomputed tf products) x idf^2
  gathered at the n-gram id — a handful of np.bincount segment sums
  per resample instead of a full re-tokenize/re-count pass.

The numbers are EXACT — same formulas, same resample semantics as
re-running metrics/{bleu,rouge,meteor,cider}.py on the resampled dicts —
up to float summation order; tests/test_score_cli.py pins fast == slow
on identical rng picks. ~200x faster at 300 videos.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence

import numpy as np

from controllable_xgating_torch.metrics.bleu import _bleu_from_counts
from controllable_xgating_torch.metrics.cider import ngram_counts

MAX_N = 4
SIGMA = 6.0  # CIDEr-D length-penalty sigma (metrics/cider.py default)


def _selector(metrics):
    """Replicate language_eval's metric-family selection semantics."""
    if isinstance(metrics, str):
        metrics = [m for m in metrics.split(",") if m]
    want = None if metrics is None else {str(m).lower() for m in metrics}

    def on(name: str) -> bool:
        return want is None or any(name in m for m in want)

    return on


class _SetStats:
    """Per-candidate-file sufficient statistics (built once)."""

    __slots__ = (
        "cn_gid", "cn_tf2", "cn_seg",
        "pair_gid", "pair_wp", "pair_wd", "pair_seg",
        "pair_vid", "pair_rg", "pair_pen", "n_pairs",
        "bleu_mat", "rouge_per", "meteor_per",
    )


class FastPairedBootstrap:
    """Precompute sufficient statistics for (gts, res[, res2]) and score
    arbitrary resamples (index arrays into sorted(res)) exactly.

    Usage (mirrors cli/score.bootstrap_metrics's slow loop):

        fb = FastPairedBootstrap(gts, res, res2, metrics)
        pick = rng.integers(0, len(fb.keys), len(fb.keys))
        row_a, row_b = fb.resample(pick)
    """

    def __init__(self, gts, res, res2=None, metrics=None,
                 meteor_synonyms=None):
        self.keys = sorted(res)
        self.V = len(self.keys)
        self.meteor_synonyms = meteor_synonyms
        on = _selector(metrics)
        self.need_bleu = on("bleu")
        self.need_meteor = on("meteor")
        self.need_rouge = on("rouge")
        self.need_cider = on("cider")

        self._gid: dict = {}
        self._build_refs(gts)
        self.sets = [self._build_set(gts, res)]
        if res2 is not None:
            self.sets.append(self._build_set(gts, res2))
        self.G = len(self._gid)
        self.log_n = math.log(max(self.V, 1))

    # -- precompute ------------------------------------------------------

    def _gid_of(self, ng) -> int:
        g = self._gid.get(ng)
        if g is None:
            g = len(self._gid)
            self._gid[ng] = g
        return g

    def _build_refs(self, gts) -> None:
        df_gid, df_vid = [], []
        rn_gid, rn_tf, rn_seg = [], [], []
        self._ref_counters = []  # per video: [(counters[4], len), ...]
        self._ref_base = []      # per video: global index of its ref 0
        refdiv = np.ones(self.V)
        r_total = 0
        for i, k in enumerate(self.keys):
            refs = [r.split() for r in gts[k]]
            self._ref_base.append(r_total)
            refdiv[i] = max(len(refs), 1)
            per_ref = []
            seen = set()
            if self.need_cider:
                for j, toks in enumerate(refs):
                    cnts = ngram_counts(toks, MAX_N)
                    per_ref.append((cnts, len(toks)))
                    rg = r_total + j
                    for n_i, cnt in enumerate(cnts):
                        for ng, tf in cnt.items():
                            g = self._gid_of(ng)
                            rn_gid.append(g)
                            rn_tf.append(float(tf))
                            rn_seg.append(rg * MAX_N + n_i)
                            seen.add(g)
                for g in seen:
                    df_gid.append(g)
                    df_vid.append(i)
            else:
                per_ref = [(ngram_counts(t, MAX_N), len(t)) for t in refs]
            self._ref_counters.append(per_ref)
            r_total += len(refs)
        self.R_total = r_total
        self.refdiv = refdiv
        self.df_gid = np.asarray(df_gid, np.int64)
        self.df_vid = np.asarray(df_vid, np.int64)
        self.rn_gid = np.asarray(rn_gid, np.int64)
        self.rn_tf2 = np.asarray(rn_tf, np.float64) ** 2
        self.rn_seg = np.asarray(rn_seg, np.int64)

    def _build_set(self, gts, res) -> _SetStats:
        s = _SetStats()
        cn_gid, cn_tf2, cn_seg = [], [], []
        pair_gid, pair_wp, pair_wd, pair_seg = [], [], [], []
        pair_vid, pair_rg, pair_pen = [], [], []
        bleu_mat = np.zeros((self.V, 10))
        n_pairs = 0
        for i, k in enumerate(self.keys):
            cand = res[k]
            if len(cand) != 1:
                raise ValueError("exactly one candidate per key expected")
            hyp = cand[0].split()
            ccnts = ngram_counts(hyp, MAX_N)
            if self.need_cider:
                for n_i, cnt in enumerate(ccnts):
                    for ng, tf in cnt.items():
                        cn_gid.append(self._gid_of(ng))
                        cn_tf2.append(float(tf * tf))
                        cn_seg.append(i * MAX_N + n_i)
                for j, (rc, rlen) in enumerate(self._ref_counters[i]):
                    pen = math.exp(
                        -((len(hyp) - rlen) ** 2) / (2.0 * SIGMA * SIGMA))
                    for n_i in range(MAX_N):
                        for ng, tf in ccnts[n_i].items():
                            rtf = rc[n_i].get(ng)
                            if rtf:
                                pair_gid.append(self._gid[ng])
                                pair_wp.append(float(tf * rtf))
                                pair_wd.append(float(min(tf, rtf) * rtf))
                                pair_seg.append(n_pairs * MAX_N + n_i)
                    pair_vid.append(i)
                    pair_rg.append(self._ref_base[i] + j)
                    pair_pen.append(pen)
                    n_pairs += 1
            if self.need_bleu:
                for n_i in range(MAX_N):
                    max_ref: dict = {}
                    for rc, _ in self._ref_counters[i]:
                        for ng, c in rc[n_i].items():
                            if c > max_ref.get(ng, 0):
                                max_ref[ng] = c
                    bleu_mat[i, n_i] = sum(
                        min(c, max_ref.get(ng, 0))
                        for ng, c in ccnts[n_i].items())
                    bleu_mat[i, 4 + n_i] = max(len(hyp) - n_i, 0)
                bleu_mat[i, 8] = len(hyp)
                bleu_mat[i, 9] = min(
                    (abs(len(r.split()) - len(hyp)), len(r.split()))
                    for r in gts[k])[1]
        s.cn_gid = np.asarray(cn_gid, np.int64)
        s.cn_tf2 = np.asarray(cn_tf2, np.float64)
        s.cn_seg = np.asarray(cn_seg, np.int64)
        s.pair_gid = np.asarray(pair_gid, np.int64)
        s.pair_wp = np.asarray(pair_wp, np.float64)
        s.pair_wd = np.asarray(pair_wd, np.float64)
        s.pair_seg = np.asarray(pair_seg, np.int64)
        s.pair_vid = np.asarray(pair_vid, np.int64)
        s.pair_rg = np.asarray(pair_rg, np.int64)
        s.pair_pen = np.asarray(pair_pen, np.float64)
        s.n_pairs = n_pairs
        s.bleu_mat = bleu_mat
        # per-video scores for the mean-decomposable metrics, computed
        # once by the real scorers
        gts_sub = {k: gts[k] for k in self.keys}
        res_sub = {k: res[k] for k in self.keys}
        if self.need_rouge:
            from controllable_xgating_torch.metrics.rouge import RougeScorer

            _, per = RougeScorer().score(gts_sub, res_sub)
            s.rouge_per = np.asarray(per, np.float64)
        if self.need_meteor:
            from controllable_xgating_torch.metrics.meteor import MeteorScorer

            _, per = MeteorScorer(
                synonyms=self.meteor_synonyms).score(gts_sub, res_sub)
            s.meteor_per = np.asarray(per, np.float64)
        return s

    # -- per-resample ----------------------------------------------------

    def resample(self, pick) -> tuple:
        """Score one resample (indices into self.keys, with replacement).

        Returns (row, row2-or-None): metric dicts matching what
        language_eval returns on the resampled caption dicts.
        """
        if len(pick) == 0:
            # Mirror the slow path: language_eval over an empty caption
            # dict reports 0.0 everywhere (never NaN).
            row: dict = {}
            if self.need_bleu:
                row.update({f"Bleu_{i}": 0.0 for i in range(1, MAX_N + 1)})
            if self.need_meteor:
                row["METEOR"] = 0.0
            if self.need_rouge:
                row["ROUGE_L"] = 0.0
            if self.need_cider:
                row["CIDEr"] = 0.0
                row["CIDErD"] = 0.0
            rows = [dict(row) for _ in self.sets]
            return rows[0], (rows[1] if len(rows) > 1 else None)
        counts = np.bincount(
            np.asarray(pick, np.int64), minlength=self.V
        ).astype(np.float64)
        n_seg = float(len(pick))
        idf2 = rn = None
        if self.need_cider:
            df = np.bincount(
                self.df_gid, weights=counts[self.df_vid], minlength=self.G)
            idf = math.log(max(len(pick), 1)) - np.log(np.maximum(df, 1.0))
            idf2 = idf * idf
            rn2 = np.bincount(
                self.rn_seg, weights=self.rn_tf2 * idf2[self.rn_gid],
                minlength=self.R_total * MAX_N)
            rn = np.sqrt(rn2).reshape(self.R_total, MAX_N)
        rows = [self._score_set(s, counts, n_seg, idf2, rn)
                for s in self.sets]
        return rows[0], (rows[1] if len(rows) > 1 else None)

    def _score_set(self, s: _SetStats, counts, n_seg, idf2, rn) -> dict:
        row: dict = {}
        if self.need_bleu:
            agg = counts @ s.bleu_mat
            bleus = _bleu_from_counts(
                list(agg[:4]), list(agg[4:8]), agg[8], agg[9], MAX_N)
            for i, b in enumerate(bleus, 1):
                row[f"Bleu_{i}"] = b
        if self.need_meteor:
            row["METEOR"] = float(counts @ s.meteor_per / n_seg)
        if self.need_rouge:
            row["ROUGE_L"] = float(counts @ s.rouge_per / n_seg)
        if self.need_cider:
            cn2 = np.bincount(
                s.cn_seg, weights=s.cn_tf2 * idf2[s.cn_gid],
                minlength=self.V * MAX_N)
            cn = np.sqrt(cn2).reshape(self.V, MAX_N)
            dot_p = np.bincount(
                s.pair_seg, weights=s.pair_wp * idf2[s.pair_gid],
                minlength=s.n_pairs * MAX_N).reshape(s.n_pairs, MAX_N)
            dot_d = np.bincount(
                s.pair_seg, weights=s.pair_wd * idf2[s.pair_gid],
                minlength=s.n_pairs * MAX_N).reshape(s.n_pairs, MAX_N)
            denom = cn[s.pair_vid] * rn[s.pair_rg]
            ok = denom > 0.0
            safe = np.where(ok, denom, 1.0)
            sim_p = np.where(ok, dot_p / safe, 0.0)
            sim_d = np.where(ok, dot_d / safe, 0.0) * s.pair_pen[:, None]
            per_vid_p = np.bincount(
                s.pair_vid, weights=sim_p.sum(axis=1), minlength=self.V)
            per_vid_d = np.bincount(
                s.pair_vid, weights=sim_d.sum(axis=1), minlength=self.V)
            sp = per_vid_p / self.refdiv / MAX_N * 10.0
            sd = per_vid_d / self.refdiv / MAX_N * 10.0
            row["CIDEr"] = float(counts @ sp / n_seg)
            row["CIDErD"] = float(counts @ sd / n_seg)
        return row
