"""Fused POS-generator LSTM step (csrc/pos_lstm.cu) and its plain version.

Counterpart of `controllable_xgating_tpu/ops/pallas/pos_lstm.py`
(`pos_lstm_step_pallas`): gates = e @ Wih_e + s_gates + h @ Whh + b with
e, h and the weights in the compute dtype, s_gates, b and c in f32;
returns (h', c') in f32. The tag-logit projection stays outside. The
weight operands are cast once per rollout (`pos_lstm_weights`), not at
every step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from controllable_xgating_torch.ops.kernels import build
from controllable_xgating_torch.ops.lstm import lstm_cell_pre
from controllable_xgating_torch.ops.precision import compute_dtype, mm


def pos_lstm_step_plain(pos_params, token_emb, s_gates, h, c):
    p = pos_params
    e_dim = p.embed.shape[1]
    x_gates = mm(token_emb, p.lstm.wih[:e_dim]) + s_gates.float()
    return lstm_cell_pre(p.lstm, x_gates, h.float(), c)


class PosLstmWeights(NamedTuple):
    """The kernel's weight operands: matrices in the compute dtype, the
    bias in f32."""

    wih_e: torch.Tensor  # [Ep, 4H]
    whh: torch.Tensor    # [H, 4H]
    b: torch.Tensor      # [4H]


def pos_lstm_weights(pos_params) -> PosLstmWeights:
    """Cast the step's weights once, for every step of a rollout under the
    current policy."""
    p = pos_params
    cdt = compute_dtype()
    e_dim = p.embed.shape[1]
    return PosLstmWeights(
        p.lstm.wih[:e_dim].to(cdt).contiguous(), p.lstm.whh.to(cdt).contiguous(),
        p.lstm.b.float().contiguous(),
    )


def pos_lstm_step_kernel(
    pos_params,
    token_emb: torch.Tensor,  # [B, Ep] gathered tag embedding
    s_gates: torch.Tensor,    # [B, 4H] f32, summary @ wih_s
    h: torch.Tensor,
    c: torch.Tensor,
    weights: PosLstmWeights | None = None,  # from pos_lstm_weights, else cast here
):
    """One POS rollout step. Returns (h', c') in f32."""
    if h.device.type == "cpu":
        return pos_lstm_step_plain(pos_params, token_emb, s_gates, h, c)
    p = pos_params
    cdt, f32, dev = compute_dtype(), torch.float32, h.device
    b, hd = h.shape
    e_dim = p.embed.shape[1]
    cast = lambda t: t.to(device=dev, dtype=cdt).contiguous()
    full = lambda t: t.to(device=dev, dtype=f32).contiguous()
    e_c, h_c = cast(token_emb), cast(h)
    wih_e, whh, bias = pos_lstm_weights(p) if weights is None else weights
    sg, c32 = full(s_gates), full(c)
    h_out = torch.empty((b, hd), dtype=f32, device=dev)
    c_out = torch.empty((b, hd), dtype=f32, device=dev)
    if b == 0:
        return h_out, c_out
    ptrs = [
        build.check(e_c, "token_emb", (b, e_dim), cdt, dev),
        build.check(h_c, "h", (b, hd), cdt, dev),
        build.check(sg, "s_gates", (b, 4 * hd), f32, dev),
        build.check(c32, "c", (b, hd), f32, dev),
        build.check(wih_e, "wih_e", (e_dim, 4 * hd), cdt, dev),
        build.check(whh, "whh", (hd, 4 * hd), cdt, dev),
        build.check(bias, "b", (4 * hd,), f32, dev),
        build.check(h_out, "h_out", (b, hd), f32, dev),
        build.check(c_out, "c_out", (b, hd), f32, dev),
    ]
    rc = build.library().cxg_pos_lstm_fwd(
        build.dtype_code(e_c), *ptrs, b, e_dim, hd, build.stream_ptr(dev)
    )
    build.raise_on_error(rc, "pos_lstm")
    pos_lstm_step_kernel.launches += 1
    return h_out, c_out


pos_lstm_step_kernel.launches = 0
