"""Greedy caption decoding.

Counterpart of `controllable_xgating_tpu/infer/greedy.py` (`greedy_decode`
and `mask_special_tokens`). A Python loop stands in for the scan; with
`early_stop=True` it leaves once every row has emitted EOS, which costs
one host sync per step. Tokens after EOS are PAD.
"""

from __future__ import annotations

from typing import Optional

import torch

from controllable_xgating_torch.data.vocab import BOS, EOS, PAD, UNK
from controllable_xgating_torch.models.decoder import (
    DecodeContext,
    DecoderParams,
    decode_step,
    init_decoder_state,
)
from controllable_xgating_torch.ops.kernels.attn_lstm import attn_lstm_weights

_MASK_NEG = -1e30


def mask_special_tokens(logits: torch.Tensor, block_unk: bool = False) -> torch.Tensor:
    """Forbid PAD/BOS as outputs (and UNK with `block_unk`). Returns a copy."""
    out = logits.clone()
    out[..., PAD] = _MASK_NEG
    out[..., BOS] = _MASK_NEG
    if block_unk:
        out[..., UNK] = _MASK_NEG
    return out


def greedy_decode(
    params: DecoderParams,
    ctx: DecodeContext,
    summary: torch.Tensor,
    max_len: int,
    fused: Optional[bool] = None,
    block_unk: bool = False,
    early_stop: bool = False,
) -> torch.Tensor:
    """Deterministic argmax rollout -> tokens [B, max_len] int64."""
    b = summary.shape[0]
    dev = summary.device
    h, c = init_decoder_state(params, summary)
    tok = torch.full((b,), BOS, dtype=torch.long, device=dev)
    alive = torch.ones((b,), dtype=torch.bool, device=dev)
    tokens = torch.full((b, max_len), PAD, dtype=torch.long, device=dev)
    kw = attn_lstm_weights(params) if fused else None
    for t in range(max_len):
        if early_stop and not bool(alive.any()):
            break
        logits, h, c, _ = decode_step(params, ctx, tok, h, c, fused=fused, kernel_weights=kw)
        logits = mask_special_tokens(logits.float(), block_unk)
        nxt = torch.argmax(logits, dim=-1)
        nxt = torch.where(alive, nxt, torch.full_like(nxt, PAD))
        alive = alive & (nxt != EOS)
        tokens[:, t] = nxt
        tok = nxt
    return tokens
