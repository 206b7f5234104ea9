"""Split evaluation: decode a split batch by batch, score on the host.

Counterpart of `make_greedy_caption_fn`, `evaluate_split` and
`evaluate_split_nbest` in `controllable_xgating_tpu/infer/evaluator.py`
(without the device mesh).
Token ids leave the device once per batch; strings are joined through the
vocab and scored by the port's copy of the metric harness (`metrics/`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from controllable_xgating_torch.data.loader import eval_batches
from controllable_xgating_torch.infer.greedy import greedy_decode
from controllable_xgating_torch.metrics.harness import (
    gts_from_label_array,
    language_eval,
    normalize_metric_name,
)
from controllable_xgating_torch.models.captioner import CaptionerParams, encode_for_inference


def make_greedy_caption_fn(
    max_pos_len: int, max_len: int, fused: Optional[bool] = None, early_stop: bool = True,
    block_unk: bool = False,
):
    """(params, app, motion, frame_mask=None) -> (tokens [B, L], pos_tags).
    Inputs are tensors on the parameters' device."""
    from controllable_xgating_torch.ops.dispatch import fused_enabled

    fused = fused_enabled(fused)

    @torch.inference_mode()
    def fn(params: CaptionerParams, app, motion, frame_mask=None):
        ctx, summary, tags = encode_for_inference(
            params, app, motion, frame_mask, max_pos_len=max_pos_len, fused=fused,
            early_stop=early_stop,
        )
        tokens = greedy_decode(
            params.decoder, ctx, summary, max_len, fused=fused, early_stop=early_stop,
            block_unk=block_unk,
        )
        return tokens, tags

    return fn


def params_device(params) -> torch.device:
    """The device of `params`: a `CaptionerParams`, or an ensemble's tuple
    of members (its first member's)."""
    member = params[0] if isinstance(params, (tuple, list)) else params
    return member.decoder.w_out.device


def evaluate_split(
    params,
    store,
    labels: dict,
    info,
    split: str = "val",
    batch_size: int = 64,
    max_len: int = 28,
    max_pos_len: int = 28,
    caption_fn=None,
    metrics=None,
) -> tuple[dict, dict]:
    """Returns (metrics dict, {video_id: caption string}).

    `store` is any object with `get_batch` and `frame_mask` (see
    data/loader.py); `info` carries `splits`, `video_ids` and `vocab`, as
    the JAX package's CorpusInfo does. `params` is what `caption_fn`
    takes: a `CaptionerParams`, or an ensemble's tuple of members with
    `infer/ensemble.py::make_ensemble_caption_fn`. `caption_fn` defaults
    to greedy."""
    if caption_fn is None:
        caption_fn = make_greedy_caption_fn(max_pos_len, max_len)
    indices = np.asarray(info.splits[split], np.int64)
    if len(indices) == 0:
        raise ValueError(f"split {split!r} is empty")
    device = params_device(params)
    put = lambda x: None if x is None else torch.as_tensor(x, device=device)
    res: dict[str, list[str]] = {}
    for batch in eval_batches(store, indices, batch_size):
        tokens, _ = caption_fn(
            params, put(batch["app"]), put(batch["motion"]), put(batch.get("frame_mask"))
        )
        tokens = tokens.cpu().numpy()
        for row in range(batch["num_valid"]):
            vid = info.video_ids[int(batch["video_indices"][row])]
            res[vid] = [info.vocab.decode_str(tokens[row])]
    keys = [info.video_ids[i] for i in indices]
    gts = gts_from_label_array(info.vocab, labels["caps"][indices], labels["ncaps"][indices], keys)
    scored = language_eval(gts, res, metrics=metrics)
    return scored, {k: v[0] for k, v in res.items()}


def evaluate_split_nbest(
    params,
    store,
    labels: dict,
    info,
    caption_fn,
    nbest: int,
    split: str = "val",
    batch_size: int = 64,
    metrics=None,
    oracle_metric: str = "CIDErD",
) -> tuple[dict, dict, dict]:
    """N-best evaluation with oracle headroom (the reranking diagnostic).

    `caption_fn` is a `return_all=True` decoder, (params, app, motion,
    frame_mask) -> (tokens [B, K, L], scores [B, K], tags), such as
    `make_beam_caption_fn(..., return_all=True)`. Returns
    (metrics of rank 0, oracle metrics, {video_id: [(caption, score), ...]}).
    The oracle picks, per video, the hypothesis among its top `nbest` that
    maximizes the video's own `oracle_metric`, then scores that selection
    as a corpus: what a perfect reranker of the list would reach."""
    oracle_metric = normalize_metric_name(oracle_metric)
    if nbest < 1:
        raise ValueError("nbest must be >= 1")
    indices = np.asarray(info.splits[split], np.int64)
    if len(indices) == 0:
        raise ValueError(f"split {split!r} is empty")
    device = params_device(params)
    put = lambda x: None if x is None else torch.as_tensor(x, device=device)
    lists: dict[str, list] = {}
    for batch in eval_batches(store, indices, batch_size):
        tokens, scores, _ = caption_fn(
            params, put(batch["app"]), put(batch["motion"]), put(batch.get("frame_mask"))
        )
        tokens = tokens.cpu().numpy()  # [B, K, L] best-first
        scores = scores.cpu().numpy()  # [B, K]
        if nbest > tokens.shape[1]:
            raise ValueError(f"nbest {nbest} exceeds the decoded beam {tokens.shape[1]}")
        for row in range(batch["num_valid"]):
            vid = info.video_ids[int(batch["video_indices"][row])]
            lists[vid] = [
                (info.vocab.decode_str(tokens[row, n]), float(scores[row, n])) for n in range(nbest)
            ]
    keys = [info.video_ids[i] for i in indices]
    gts = gts_from_label_array(info.vocab, labels["caps"][indices], labels["ncaps"][indices], keys)
    best = language_eval(gts, {v: [l[0][0]] for v, l in lists.items()}, metrics=metrics)
    # per-rank per-video oracle_metric, then per-video argmax over ranks
    per_rank = [
        language_eval(gts, {v: [l[n][0]] for v, l in lists.items()}, metrics=[oracle_metric],
                      per_key=True)[1]
        for n in range(nbest)
    ]
    pick = {v: max(range(nbest), key=lambda n: per_rank[n][v].get(oracle_metric, 0.0))
            for v in lists}
    oracle = language_eval(gts, {v: [lists[v][pick[v]][0]] for v in lists}, metrics=metrics)
    return best, oracle, lists
