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
from controllable_xgating_torch.infer.graphs import StepLoop
from controllable_xgating_torch.infer.graphs import run as run_loop
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


class PosRolloutLoop(StepLoop):
    """The greedy POS rollout split as the reference's scan
    (`infer/graphs.py`): inputs summary and s_gates, carry (h, c, the last
    tag, the alive rows, tags, hidden states and the step mask), one
    argmax step, finish = (tags, psi). On the kernel path the cell is a
    `PosLstmRollout`, made at the first `init` and `reset` at every later
    one (its operands made again from the parameters, its buffers and TMA
    descriptors kept)."""

    kind = "pos"

    def __init__(self, params: PosGeneratorParams, summary: torch.Tensor, max_len: int,
                 fused: Optional[bool]):
        self.params, self.summary, self.max_len = params, summary, max_len
        self.fused = bool(fused)
        self.device = summary.device
        self.cell = None

    def key_options(self) -> tuple:
        return (self.fused,)

    def modules(self) -> list:
        return [self.params]

    def key_tensors(self) -> list:
        return [self.summary]

    def prepare(self) -> dict:
        return dict(summary=self.summary, s_gates=_summary_gates(self.params, self.summary))

    def init(self) -> dict:
        summary, s_gates = self.inp["summary"], self.inp["s_gates"]
        b, dev = summary.shape[0], summary.device
        h, c = _init_state(self.params, summary)
        if self.fused:
            from controllable_xgating_torch.ops.kernels.pos_lstm import PosLstmRollout

            if self.cell is None:
                self.cell = PosLstmRollout(self.params, h, s_gates)  # the kernel's operands
            else:
                self.cell.reset(h, s_gates)
        return dict(
            h=h, c=c, tok=torch.full((b,), BOS, dtype=torch.long, device=dev),
            alive=torch.ones((b,), dtype=torch.bool, device=dev),
            tags=torch.full((b, self.max_len), PAD, dtype=torch.long, device=dev),
            hs=summary.new_zeros((b, self.max_len, self.params.lstm.hidden_dim)),
            step_mask=torch.zeros((b, self.max_len), dtype=torch.bool, device=dev),
        )

    def step(self, carry: dict, t: int) -> None:
        p, alive, tok = self.params, carry["alive"], carry["tok"]
        dt = self.inp["summary"].dtype
        carry["step_mask"][:, t] = alive
        if self.fused:
            h, c = self.cell.step(carry["c"], tok=tok, h=carry["h"])
            h, c = h.to(dt), c.to(dt)
        else:
            e = p.embed[tok]
            h, c = lstm_cell_pre(p.lstm, _emb_gates(p, e) + self.inp["s_gates"], carry["h"],
                                 carry["c"])
        logits = mm(h, p.w_out) + p.b_out.float()
        logits[:, PAD] = -1e30  # never training targets, never outputs
        logits[:, BOS] = -1e30
        nxt = torch.argmax(logits, dim=-1)
        nxt = torch.where(alive, nxt, torch.full_like(nxt, PAD))
        carry.update(h=h, c=c, tok=nxt, alive=alive & (nxt != EOS))
        carry["tags"][:, t] = nxt
        carry["hs"][:, t] = h

    def done(self, carry: dict) -> torch.Tensor:
        return ~carry["alive"].any()

    def finish(self, carry: dict):
        return carry["tags"], _pool_psi(self.params, carry["hs"], carry["step_mask"])


def pos_greedy_generate(
    params: PosGeneratorParams,
    summary: torch.Tensor,  # [B, He]
    max_len: int,
    early_stop: bool = False,
    fused: Optional[bool] = None,
    graphs: Optional[bool] = None,
):
    """Greedy rollout. Returns (tags [B, max_len] int64, psi [B, P]).

    tags exclude BOS; rows stop contributing to psi after EOS.
    `early_stop=True` leaves the loop once every row has emitted EOS.
    `fused=True` routes the cell through the POS LSTM kernel
    (`PosLstmRollout`: operands made once a call, one gather and one
    launch a step). `graphs` overrides `set_decode_graphs` (None = auto:
    replayed CUDA graphs for CUDA tensors unless autograd records, the
    eager loop otherwise; see `infer/graphs.py`)."""
    return run_loop(PosRolloutLoop(params, summary, max_len, fused), max_len, early_stop, graphs)
