"""Split evaluation: decode a split batch by batch, score on the host.

Counterpart of `make_greedy_caption_fn` and `evaluate_split` in
`controllable_xgating_tpu/infer/evaluator.py` (without the device mesh).
Token ids leave the device once per batch; strings are joined through the
vocab and scored by the port's copy of the metric harness (`metrics/`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from controllable_xgating_torch.data.loader import eval_batches
from controllable_xgating_torch.infer.greedy import greedy_decode
from controllable_xgating_torch.metrics.harness import gts_from_label_array, language_eval
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


def evaluate_split(
    params: CaptionerParams,
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
    the JAX package's CorpusInfo does. `caption_fn` defaults to greedy."""
    if caption_fn is None:
        caption_fn = make_greedy_caption_fn(max_pos_len, max_len)
    indices = np.asarray(info.splits[split], np.int64)
    if len(indices) == 0:
        raise ValueError(f"split {split!r} is empty")
    device = params.decoder.w_out.device
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
