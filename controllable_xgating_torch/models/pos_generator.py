"""Global POS-sequence generator (paper §3.2).

Counterpart of `controllable_xgating_tpu/models/pos_generator.py`: an LSTM
that maps the video summary to a sequence of POS tags and pools its hidden
states into the global syntactic feature psi, teacher-forced
(`pos_forward`, `psi_from_tags`) or greedy (`pos_greedy_generate`).

psi = tanh(W_psi . masked-mean(hidden states)); in the rollout the mask is
the alive state *before* each step.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from controllable_xgating_torch.data.vocab import BOS, EOS, PAD
from controllable_xgating_torch.ops.lstm import LSTMWeights, init_lstm, lstm_cell_pre
from controllable_xgating_torch.ops.params import normal, param, uniform_fan_in
from controllable_xgating_torch.ops.precision import mm


class PosGeneratorParams(nn.Module):
    def __init__(self, embed, init_h, init_c, lstm: LSTMWeights, w_out, b_out, w_psi, b_psi):
        super().__init__()
        self.embed = param(embed)    # [Vp, Ep]
        self.init_h = param(init_h)  # [He, H]
        self.init_c = param(init_c)  # [He, H]
        self.lstm = lstm             # input dim Ep + He
        self.w_out = param(w_out)    # [H, Vp]
        self.b_out = param(b_out)    # [Vp]
        self.w_psi = param(w_psi)    # [H, P]
        self.b_psi = param(b_psi)    # [P]

    @property
    def pos_vocab_size(self) -> int:
        return self.w_out.shape[1]

    @property
    def psi_dim(self) -> int:
        return self.w_psi.shape[1]


def init_pos_generator(
    gen: torch.Generator, pos_vocab: int, enc_dim: int, hidden: int, embed_dim: int,
    psi_dim: int,
) -> PosGeneratorParams:
    return PosGeneratorParams(
        embed=normal(gen, (pos_vocab, embed_dim), 0.1),
        init_h=uniform_fan_in(gen, (enc_dim, hidden)),
        init_c=uniform_fan_in(gen, (enc_dim, hidden)),
        lstm=init_lstm(gen, embed_dim + enc_dim, hidden),
        w_out=uniform_fan_in(gen, (hidden, pos_vocab)),
        b_out=torch.zeros(pos_vocab),
        w_psi=uniform_fan_in(gen, (hidden, psi_dim)),
        b_psi=torch.zeros(psi_dim),
    )


def _init_state(params: PosGeneratorParams, summary: torch.Tensor):
    h = torch.tanh(mm(summary, params.init_h))
    c = torch.tanh(mm(summary, params.init_c))
    return h.to(summary.dtype), c.to(summary.dtype)


def _summary_gates(params: PosGeneratorParams, summary: torch.Tensor) -> torch.Tensor:
    """summary @ wih_s [B, 4H]: the per-sequence-constant half of the
    cell's input projection, hoisted out of every loop below."""
    e_dim = params.embed.shape[1]
    return mm(summary, params.lstm.wih[e_dim:])


def _emb_gates(params: PosGeneratorParams, emb: torch.Tensor) -> torch.Tensor:
    e_dim = params.embed.shape[1]
    return mm(emb, params.lstm.wih[:e_dim])


def _pool_psi(params: PosGeneratorParams, hs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """psi = tanh(W_psi . masked-mean over time of hidden states). [B, P]"""
    m = mask.to(hs.dtype)[:, :, None]
    pooled = (hs * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
    psi = torch.tanh(mm(pooled, params.w_psi) + params.b_psi.float())
    return psi.to(hs.dtype)


def pos_forward(params: PosGeneratorParams, summary: torch.Tensor, pos_tags: torch.Tensor):
    """Teacher-forced pass over pos_tags [B, Lp] (BOS ... EOS PAD*).
    Returns (logits [B, Lp-1, Vp], psi [B, P]); logits[:, t] predicts
    pos_tags[:, t+1]."""
    inputs = pos_tags[:, :-1].long()
    emb = params.embed[inputs]
    h, c = _init_state(params, summary)
    s_gates = _summary_gates(params, summary)
    e_gates = _emb_gates(params, emb)  # [B, Lp-1, 4H], batched over all steps
    hs = []
    for t in range(inputs.shape[1]):
        h, c = lstm_cell_pre(params.lstm, e_gates[:, t] + s_gates, h, c)
        hs.append(h)
    hs = torch.stack(hs, dim=1)
    logits = mm(hs, params.w_out) + params.b_out.float()
    step_mask = (inputs != PAD).to(hs.dtype)
    return logits, _pool_psi(params, hs, step_mask)


def psi_from_tags(params: PosGeneratorParams, summary: torch.Tensor, pos_tags: torch.Tensor):
    """Controllability path: psi for a user-specified tag sequence."""
    return pos_forward(params, summary, pos_tags)[1]


def pos_greedy_generate(
    params: PosGeneratorParams,
    summary: torch.Tensor,  # [B, He]
    max_len: int,
    early_stop: bool = False,
    fused: Optional[bool] = None,
):
    """Greedy rollout. Returns (tags [B, max_len] int64, psi [B, P]).

    tags exclude BOS; rows stop contributing to psi after EOS.
    `early_stop=True` leaves the loop once every row has emitted EOS (one
    host sync per step). `fused=True` routes the cell through the POS LSTM
    kernel (`PosLstmRollout`: operands made once, one gather and one
    launch a step)."""
    b = summary.shape[0]
    dev = summary.device
    h, c = _init_state(params, summary)
    tok = torch.full((b,), BOS, dtype=torch.long, device=dev)
    alive = torch.ones((b,), dtype=torch.bool, device=dev)
    hidden = params.lstm.hidden_dim
    s_gates = _summary_gates(params, summary)
    if fused:
        from controllable_xgating_torch.ops.kernels.pos_lstm import PosLstmRollout

        cell = PosLstmRollout(params, h, s_gates)  # the kernel's operands, made once

    tags = torch.full((b, max_len), PAD, dtype=torch.long, device=dev)
    hs = summary.new_zeros((b, max_len, hidden))
    step_mask = torch.zeros((b, max_len), dtype=torch.bool, device=dev)
    for t in range(max_len):
        if early_stop and not bool(alive.any()):
            break
        step_mask[:, t] = alive
        if fused:
            h, c = cell.step(c, tok=tok)
            h, c = h.to(summary.dtype), c.to(summary.dtype)
        else:
            e = params.embed[tok]
            h, c = lstm_cell_pre(params.lstm, _emb_gates(params, e) + s_gates, h, c)
        logits = mm(h, params.w_out) + params.b_out.float()
        logits[:, PAD] = -1e30  # never training targets, never outputs
        logits[:, BOS] = -1e30
        nxt = torch.argmax(logits, dim=-1)
        nxt = torch.where(alive, nxt, torch.full_like(nxt, PAD))
        alive = alive & (nxt != EOS)
        tok = nxt
        tags[:, t] = nxt
        hs[:, t] = h
    return tags, _pool_psi(params, hs, step_mask)
