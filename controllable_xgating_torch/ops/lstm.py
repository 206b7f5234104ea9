"""LSTM primitives, written out by hand.

Counterpart of `controllable_xgating_tpu/ops/lstm.py`. Gate order is
(i, f, g, o) in one [Din, 4H] weight per input. `nn.LSTM` and packed
sequences are not used: a masked step here carries h and c through
unchanged and emits 0, in the reverse direction too, which is not what a
packed reverse LSTM does over a padded tail.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from controllable_xgating_torch.ops.params import param, uniform
from controllable_xgating_torch.ops.precision import mm


class LSTMWeights(nn.Module):
    def __init__(self, wih: torch.Tensor, whh: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.wih = param(wih)  # [Din, 4H]
        self.whh = param(whh)  # [H, 4H]
        self.b = param(b)      # [4H]

    @property
    def hidden_dim(self) -> int:
        return self.whh.shape[0]


def init_lstm(gen: torch.Generator, din: int, hidden: int) -> LSTMWeights:
    w_ih = uniform(gen, (din, 4 * hidden), 1.0 / math.sqrt(din))
    w_hh = uniform(gen, (hidden, 4 * hidden), 1.0 / math.sqrt(hidden))
    b = torch.zeros(4 * hidden)
    b[hidden : 2 * hidden] = 1.0  # forget-gate bias
    return LSTMWeights(w_ih, w_hh, b)


def lstm_cell(w: LSTMWeights, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
    """One LSTM step on x [B, Din]. Returns (h', c')."""
    return lstm_cell_pre(w, mm(x, w.wih), h, c)


def lstm_cell_pre(
    w: LSTMWeights,
    x_gates: torch.Tensor,  # [B, 4H] f32 input projection, maybe partly hoisted
    h: torch.Tensor,
    c: torch.Tensor,
):
    """Cell tail given a precomputed input projection. Returns (h', c') in
    h's dtype."""
    hidden = w.hidden_dim
    gates = x_gates + mm(h, w.whh) + w.b.float()
    i = torch.sigmoid(gates[:, :hidden])
    f = torch.sigmoid(gates[:, hidden : 2 * hidden])
    g = torch.tanh(gates[:, 2 * hidden : 3 * hidden])
    o = torch.sigmoid(gates[:, 3 * hidden :])
    c_new = f * c.float() + i * g
    h_new = o * torch.tanh(c_new)
    return h_new.to(h.dtype), c_new.to(h.dtype)


def lstm_scan(
    w: LSTMWeights,
    xs: torch.Tensor,                    # [B, T, Din]
    mask: Optional[torch.Tensor] = None,  # [B, T] 1=valid
    h0: Optional[torch.Tensor] = None,
    c0: Optional[torch.Tensor] = None,
    reverse: bool = False,
):
    """Run the cell over time. Returns (hs [B, T, H], (hT, cT)).

    Masked steps carry state through unchanged and emit zero."""
    b, t, _ = xs.shape
    hidden = w.hidden_dim
    h = xs.new_zeros((b, hidden)) if h0 is None else h0
    c = xs.new_zeros((b, hidden)) if c0 is None else c0
    hs: list = [None] * t
    for step in (range(t - 1, -1, -1) if reverse else range(t)):
        h_new, c_new = lstm_cell(w, xs[:, step], h, c)
        if mask is None:
            h, c = h_new, c_new
            hs[step] = h_new
            continue
        m = mask[:, step, None].to(xs.dtype)
        h = m * h_new + (1 - m) * h
        c = m * c_new + (1 - m) * c
        hs[step] = m * h_new
    return torch.stack(hs, dim=1), (h, c)


def bilstm_scan(
    w_fwd: LSTMWeights,
    w_bwd: LSTMWeights,
    xs: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
):
    """Bidirectional LSTM. Returns (hs [B, T, 2H], (hT_cat, cT_cat))."""
    hs_f, (hf, cf) = lstm_scan(w_fwd, xs, mask)
    hs_b, (hb, cb) = lstm_scan(w_bwd, xs, mask, reverse=True)
    return (
        torch.cat([hs_f, hs_b], dim=-1),
        (torch.cat([hf, hb], -1), torch.cat([cf, cb], -1)),
    )
