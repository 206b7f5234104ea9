"""Sequence scoring: the log-probability of given token rows under a
checkpoint.

Counterpart of `controllable_xgating_tpu/infer/score.py`. It
teacher-forces an arbitrary hypothesis (another model's beam output, a
sample) through `decoder_forward` and sums the log-softmax of each emitted
token under the same `mask_special_tokens` masking as greedy and beam, so
scoring a model's own beam rows reproduces the beam's cumulative scores.
It is the rescoring primitive of n-best reranking
(`controllable_xgating_torch/tools/rerank.py`). A whole n-best list is one
[B*N]-row teacher-forced forward.
"""

from __future__ import annotations

from typing import Optional

import torch

from controllable_xgating_torch.data.vocab import BOS, EOS, PAD
from controllable_xgating_torch.infer.greedy import mask_special_tokens
from controllable_xgating_torch.models.captioner import CaptionerParams, encode_for_inference
from controllable_xgating_torch.models.decoder import decoder_forward


def sequence_logprob(
    params: CaptionerParams,
    app: torch.Tensor,       # [B, T, Da]
    motion: torch.Tensor,    # [B, T, Dm]
    frame_mask,              # [B, T] or None
    tokens: torch.Tensor,    # [B, L] decode-style rows: first word ... EOS PAD*
    max_pos_len: int,
    block_unk: bool = False,
    fused: Optional[bool] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (logprob [B] f32, length [B] int64).

    `logprob` sums the per-step log-softmax of each emitted token up to and
    including the first EOS (beam search's cumulative-score convention);
    `length` counts the same positions. Positions after EOS, and PAD
    positions of a short hypothesis, add nothing. `fused` routes the
    encoder's fusion and POS rollout through their kernels, as the caption
    functions do; the teacher-forced decoder is the plain one."""
    ctx, summary, _ = encode_for_inference(
        params, app, motion, frame_mask, max_pos_len=max_pos_len, fused=fused,
    )
    tokens = tokens.long()
    bos = torch.full((tokens.shape[0], 1), BOS, dtype=torch.long, device=tokens.device)
    logits = decoder_forward(params.decoder, ctx, summary, torch.cat([bos, tokens], 1))
    logp = torch.log_softmax(mask_special_tokens(logits.float(), block_unk), -1)
    step_lp = logp.gather(2, tokens[:, :, None])[:, :, 0]
    is_eos = (tokens == EOS).long()
    eos_before = torch.cumsum(is_eos, 1) - is_eos  # EOS count before t
    alive = (eos_before == 0) & (tokens != PAD)
    return torch.where(alive, step_lp, 0.0).sum(1), alive.sum(1)


def make_sequence_scorer(max_pos_len: int, block_unk: bool = False):
    """(params, app, motion, frame_mask, tokens) -> (logprob [B], length
    [B]), without gradient; inputs are tensors on the parameters' device.
    The encoder takes the kernel path where the dispatcher turns it on,
    as the caption functions' encoders do."""
    from controllable_xgating_torch.ops.dispatch import fused_enabled

    fused = fused_enabled()

    @torch.inference_mode()
    def fn(params, app, motion, frame_mask, tokens):
        return sequence_logprob(params, app, motion, frame_mask, tokens,
                                max_pos_len=max_pos_len, block_unk=block_unk, fused=fused)

    return fn
