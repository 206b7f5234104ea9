"""Split evaluation: decode a split batch by batch, score on the host.

Counterpart of `make_greedy_caption_fn`, `evaluate_split` and
`evaluate_split_nbest` in `controllable_xgating_tpu/infer/evaluator.py`.
Token ids leave the device once per batch; strings are joined through the
vocab and scored by the port's copy of the metric harness (`metrics/`).
With a `parallel/mesh.py::Mesh` each batch is split into one block of
rows per device, each decoded there on that device's copy of the
parameters (`sharded_call`), and the results are joined in row order.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from controllable_xgating_torch.data.features import DevicePut, put_now
from controllable_xgating_torch.data.loader import eval_batches
from controllable_xgating_torch.infer.greedy import greedy_decode
from controllable_xgating_torch.metrics.harness import (
    gts_from_label_array,
    language_eval,
    normalize_metric_name,
)
from controllable_xgating_torch.models.captioner import CaptionerParams, encode_for_inference
from controllable_xgating_torch.utils import spans


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


def sharded_call(caption_fn, replicas: dict, mesh, app, motion, frame_mask=None) -> tuple:
    """`caption_fn(params, app, motion, frame_mask)` over the mesh: host
    arrays [B, ...] split into `mesh.size` contiguous blocks of rows
    (`parallel/mesh.py::shard_rows`), block i decoded on `mesh.devices[i]`
    with `replicas[device]`; each output's blocks joined in row order on
    the CPU. Every block is launched before any is read back, so distinct
    cards decode at once; blocks on one device run in turn (their decode
    graphs share keys: each call's outputs are clones, read after the
    next block's replay)."""
    from controllable_xgating_torch.parallel.mesh import shard_batch

    blocks = shard_batch({"app": app, "motion": motion, "mask": frame_mask}, mesh)
    outs = [caption_fn(replicas[dev], b["app"], b["motion"], b["mask"])
            for dev, b in zip(mesh.devices, blocks)]
    return tuple(torch.cat([o[i].cpu() for o in outs]) for i in range(len(outs[0])))


def batch_caller(params, caption_fn, batch_size: int, mesh):
    """(app, motion, frame_mask) host arrays -> caption_fn's outputs: on
    the parameters' device, or over `mesh` (the batch must divide by it).

    On one device the arrays go through a `data/features.py::DevicePut`
    of the caller's own: on a card they are staged in pinned buffers that
    the caller keeps and sent on a side stream, which the caption's stream
    waits for; on the CPU they become tensors sharing their memory. The
    put, from the host arrays to the tensors ready on the caption's stream,
    is the span `caption.put`. Calls go one at a time."""
    if mesh is None:
        put = DevicePut(params_device(params))

        def call(app, motion, mask):
            with spans.span("caption.put", device=True):
                x = put_now(put, {"app": app, "motion": motion, "frame_mask": mask})
            return caption_fn(params, x["app"], x["motion"], x["frame_mask"])

        return call
    if batch_size % mesh.size:
        raise ValueError(f"batch_size {batch_size} not divisible by the {mesh.size}-device mesh")
    from controllable_xgating_torch.parallel.mesh import replicate

    replicas = replicate(params, mesh)
    return lambda app, motion, mask: sharded_call(caption_fn, replicas, mesh, app, motion, mask)


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
    mesh=None,
) -> tuple[dict, dict]:
    """Returns (metrics dict, {video_id: caption string}).

    `store` is any object with `get_batch` and `frame_mask` (see
    data/loader.py); `info` carries `splits`, `video_ids` and `vocab`, as
    the JAX package's CorpusInfo does. `params` is what `caption_fn`
    takes: a `CaptionerParams`, or an ensemble's tuple of members with
    `infer/ensemble.py::make_ensemble_caption_fn`. `caption_fn` defaults
    to greedy. `mesh` (`parallel/mesh.py::Mesh`) splits every batch over
    its devices (`sharded_call`); `batch_size` must divide by its size
    (`eval_batches` pads every batch to full size)."""
    if caption_fn is None:
        caption_fn = make_greedy_caption_fn(max_pos_len, max_len)
    indices = np.asarray(info.splits[split], np.int64)
    if len(indices) == 0:
        raise ValueError(f"split {split!r} is empty")
    call = batch_caller(params, caption_fn, batch_size, mesh)
    res: dict[str, list[str]] = {}
    for batch in eval_batches(store, indices, batch_size):
        tokens, _ = call(batch["app"], batch["motion"], batch.get("frame_mask"))
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
    mesh=None,
) -> tuple[dict, dict, dict]:
    """N-best evaluation with oracle headroom (the reranking diagnostic).

    `caption_fn` is a `return_all=True` decoder, (params, app, motion,
    frame_mask) -> (tokens [B, K, L], scores [B, K], tags), such as
    `make_beam_caption_fn(..., return_all=True)`. Returns
    (metrics of rank 0, oracle metrics, {video_id: [(caption, score), ...]}).
    The oracle picks, per video, the hypothesis among its top `nbest` that
    maximizes the video's own `oracle_metric`, then scores that selection
    as a corpus: what a perfect reranker of the list would reach. `mesh`
    as in `evaluate_split`."""
    oracle_metric = normalize_metric_name(oracle_metric)
    if nbest < 1:
        raise ValueError("nbest must be >= 1")
    indices = np.asarray(info.splits[split], np.int64)
    if len(indices) == 0:
        raise ValueError(f"split {split!r} is empty")
    call = batch_caller(params, caption_fn, batch_size, mesh)
    lists: dict[str, list] = {}
    for batch in eval_batches(store, indices, batch_size):
        tokens, scores, _ = call(batch["app"], batch["motion"], batch.get("frame_mask"))
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
