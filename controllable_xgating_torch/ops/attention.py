"""Temporal soft attention (additive / Bahdanau form).

Counterpart of `controllable_xgating_tpu/ops/attention.py`:
e_ti = v^T tanh(W_q h + W_k s_i + b), alpha = softmax_i(e) with padded
frames at NEG_INF, context = sum_i alpha_i s_i.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from controllable_xgating_torch.ops.params import param, uniform
from controllable_xgating_torch.ops.precision import mm

NEG_INF = -1e9


class AttentionWeights(nn.Module):
    def __init__(self, wq, wk, b, v):
        super().__init__()
        self.wq = param(wq)  # [Hq, A]
        self.wk = param(wk)  # [He, A]
        self.b = param(b)    # [A]
        self.v = param(v)    # [A]


def init_attention(
    gen: torch.Generator, query_dim: int, key_dim: int, attn_dim: int
) -> AttentionWeights:
    return AttentionWeights(
        wq=uniform(gen, (query_dim, attn_dim), 1.0 / math.sqrt(query_dim)),
        wk=uniform(gen, (key_dim, attn_dim), 1.0 / math.sqrt(key_dim)),
        b=torch.zeros(attn_dim),
        v=uniform(gen, (attn_dim,), 1.0 / math.sqrt(attn_dim)),
    )


def precompute_keys(w: AttentionWeights, enc_out: torch.Tensor) -> torch.Tensor:
    """Project encoder outputs once: [B, T, He] -> [B, T, A]."""
    return mm(enc_out, w.wk).to(enc_out.dtype)


def additive_attention(
    w: AttentionWeights,
    query: torch.Tensor,                  # [B, Hq]
    enc_out: torch.Tensor,                # [B, T, He] attention values
    keys: Optional[torch.Tensor] = None,  # [B, T, A]
    mask: Optional[torch.Tensor] = None,  # [B, T] 1=valid
):
    """Returns (context [B, He], alpha [B, T]) in enc_out's dtype."""
    if keys is None:
        keys = precompute_keys(w, enc_out)
    q = mm(query, w.wq)  # [B, A] f32
    act = torch.tanh(q[:, None, :] + keys.float() + w.b.float())
    scores = (act * w.v.float()).sum(-1)  # [B, T]
    if mask is not None:
        scores = torch.where(mask.bool(), scores, torch.full_like(scores, NEG_INF))
    alpha = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bt,bth->bh", alpha, enc_out.float())
    return ctx.to(enc_out.dtype), alpha.to(enc_out.dtype)
