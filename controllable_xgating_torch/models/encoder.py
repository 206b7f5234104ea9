"""XGating fusion encoder: embed + cross-gate + temporal BiLSTM.

Counterpart of `controllable_xgating_tpu/models/encoder.py`. Outputs the
attention memory `enc_out` [B, T, He] and the masked-mean `summary`
[B, He] that initialises the POS generator and the decoder.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from controllable_xgating_torch.infer.graphs import StepLoop, resolve_mode
from controllable_xgating_torch.infer.graphs import run as run_loop
from controllable_xgating_torch.ops import dropout
from controllable_xgating_torch.ops.lstm import LSTMWeights, bilstm_scan, init_lstm, lstm_scan
from controllable_xgating_torch.ops.precision import compute_dtype, mm
from controllable_xgating_torch.ops.xgate import XGateWeights, init_xgate, xgate_fuse
from controllable_xgating_torch.utils.spans import span


class EncoderParams(nn.Module):
    def __init__(self, xgate: XGateWeights, lstm_fwd: LSTMWeights,
                 lstm_bwd: Optional[LSTMWeights]):
        super().__init__()
        self.xgate = xgate
        self.lstm_fwd = lstm_fwd
        self.lstm_bwd = lstm_bwd

    @property
    def out_dim(self) -> int:
        h = self.lstm_fwd.hidden_dim
        return 2 * h if self.lstm_bwd is not None else h


def init_encoder(
    gen: torch.Generator, app_dim: int, motion_dim: int, hidden: int,
    bidirectional: bool = True, fusion: str = "xgate",
) -> EncoderParams:
    if fusion not in ("xgate", "concat"):
        raise ValueError(f"model.fusion must be xgate|concat, got {fusion!r}")
    return EncoderParams(
        xgate=init_xgate(gen, app_dim, motion_dim, hidden, mode=fusion),
        lstm_fwd=init_lstm(gen, hidden, hidden),
        lstm_bwd=init_lstm(gen, hidden, hidden) if bidirectional else None,
    )


class BiLstmLoop(StepLoop):
    """The encoder's temporal (Bi)LSTM split as the reference's scan
    (`infer/graphs.py`), both directions in one step: at step t the
    forward direction reads frame t and the backward one frame T-1-t.
    Inputs: the input projection of every frame and direction (one
    product over [wih_fwd | wih_bwd], hoisted out of the loop), the
    recurrent operands and biases stacked [D, ...] by direction, and the
    frame mask's factors per step and direction (`valid` m, `held` 1 - m).
    The carry is the state [D, B, H] and the emitted history [T, D, B, H]
    (the backward direction's in step order); finish = (enc_out [B, T,
    D*H], (hT, cT) [B, D*H]). Every element is computed by the operations
    of `ops/lstm.py::lstm_scan_pre` on the same operands in the same
    order, so graphed and eager outputs are equal. Masked steps carry
    state through and emit zero."""

    kind = "bilstm"
    raw = ("xs", "mask")

    def __init__(self, params: EncoderParams, xs: torch.Tensor,
                 mask: Optional[torch.Tensor]):
        self.weights = [w for w in (params.lstm_fwd, params.lstm_bwd) if w is not None]
        self.xs, self.mask = xs, mask
        self.device = xs.device

    def modules(self) -> list:
        return self.weights

    def prepare(self) -> dict:
        ws, xs, mask = self.weights, self.xs, self.mask
        wih = ws[0].wih if len(ws) == 1 else torch.cat([w.wih for w in ws], 1)
        inp = dict(x_gates=mm(xs, wih),  # [B, T, D*4H] f32
                   whh=torch.stack([w.whh for w in ws]).to(compute_dtype()).float(),
                   b=torch.stack([w.b for w in ws]).float()[:, None],  # [D, 1, 4H]
                   valid=None, held=None)
        if mask is not None:
            m = mask.to(xs.dtype).T  # [T, B]
            m = torch.stack([m, m.flip(0)][:len(ws)], 1)[..., None]  # [T, D, B, 1]
            inp.update(valid=m, held=1 - m)
        return inp

    def init(self) -> dict:
        (b, t, _), hidden, d = self.xs.shape, self.weights[0].hidden_dim, len(self.weights)
        return dict(h=self.xs.new_zeros((d, b, hidden)), c=self.xs.new_zeros((d, b, hidden)),
                    hist=self.xs.new_empty((t, d, b, hidden)))

    def step(self, carry: dict, t: int) -> None:
        inp, h, c = self.inp, carry["h"], carry["c"]
        d, n_steps, hidden = h.shape[0], carry["hist"].shape[0], h.shape[2]
        g4 = 4 * hidden
        hf = h.to(compute_dtype()).float()
        gates = torch.empty((d, h.shape[1], g4), dtype=torch.float32, device=h.device)
        for i, frame in enumerate((t, n_steps - 1 - t)[:d]):
            hh = torch.mm(hf[i], inp["whh"][i])
            torch.add(inp["x_gates"][:, frame, i * g4:(i + 1) * g4], hh, out=gates[i])
        gates += inp["b"]
        s = torch.sigmoid(gates)
        i_g, f_g, o_g = s[..., :hidden], s[..., hidden:2 * hidden], s[..., 3 * hidden:]
        g_g = torch.tanh(gates[..., 2 * hidden:3 * hidden])
        c_new = f_g * c.float() + i_g * g_g
        h_new = (o_g * torch.tanh(c_new)).to(h.dtype)
        c_new = c_new.to(h.dtype)
        if inp["valid"] is None:
            carry.update(h=h_new, c=c_new)
        else:
            valid, held = inp["valid"][t], inp["held"][t]
            h_new = valid * h_new  # what the step emits
            carry.update(h=h_new + held * h, c=valid * c_new + held * c)
        carry["hist"][t] = h_new

    def done(self, carry: dict) -> torch.Tensor:
        return torch.zeros((), dtype=torch.bool, device=self.device)

    def finish(self, carry: dict):
        hist, h, c = carry["hist"], carry["h"], carry["c"]
        b = h.shape[1]
        outs = [hist[:, 0]] + ([hist[:, 1].flip(0)] if hist.shape[1] == 2 else [])
        enc_out = torch.cat(outs, -1).transpose(0, 1).contiguous()
        last = lambda s: s.transpose(0, 1).reshape(b, -1)
        return enc_out, (last(h), last(c))


def temporal_lstm(params: EncoderParams, xs: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (Bi)LSTM's outputs [B, T, He] over the fused features: a
    `BiLstmLoop` through `infer/graphs.py` (replayed CUDA graphs on the
    card) where autograd need not record and `resolve_mode` does not pick
    the eager loop; else the eager scan of `ops/lstm.py`, as training,
    the CPU and the NaN checks run it."""
    loop = BiLstmLoop(params, xs, mask)
    if not loop.needs_grad() and resolve_mode(None, loop.device, False) != "eager":
        return run_loop(loop, xs.shape[1], False)[0]
    if params.lstm_bwd is None:
        return lstm_scan(params.lstm_fwd, xs, mask)[0]
    return bilstm_scan(params.lstm_fwd, params.lstm_bwd, xs, mask)[0]


def encode(
    params: EncoderParams,
    app: torch.Tensor,                         # [B, T, Da]
    motion: torch.Tensor,                      # [B, T, Dm]
    frame_mask: Optional[torch.Tensor] = None,  # [B, T] 1=valid
    fused_kernels: Optional[bool] = None,
    gen: Optional[torch.Generator] = None,
    dropout_rate: float = 0.0,
    shard: tuple = (0, 1),
):
    """Returns (enc_out [B, T, He], summary [B, He]).

    `fused_kernels=True` routes the cross-gated fusion through the XGating
    kernel wrapper (inference only: the kernel has no backward). The
    concat ablation has no kernel and always takes the plain path, as in
    the JAX package. With a generator and `dropout_rate > 0` the fused
    features are dropped out (keep-mask, scaled by 1 / (1 - rate)); the
    batch is block `shard` of the global batch's rows (`dropout.keep_rows`).
    Spans: `encode.fuse` (the fusion and its dropout) and `encode.bilstm`
    (the scan, `temporal_lstm`, and the summary), both timed on the card."""
    with span("encode.fuse", device=True):
        if fused_kernels and params.xgate.mode == "xgate":
            from controllable_xgating_torch.ops.kernels.xgate import xgate_fuse_kernel

            fused = xgate_fuse_kernel(params.xgate, app, motion)
        else:
            fused = xgate_fuse(params.xgate, app, motion)  # [B, T, H]
        if gen is not None and dropout_rate > 0.0:
            keep = dropout.keep_rows(gen, fused.shape, dropout_rate, fused.device, 0, shard)
            fused = torch.where(keep, fused / (1.0 - dropout_rate), 0.0).to(fused.dtype)
    with span("encode.bilstm", device=True):
        enc_out = temporal_lstm(params, fused, frame_mask)
        if frame_mask is None:
            summary = enc_out.mean(dim=1)
        else:
            m = frame_mask.to(enc_out.dtype)[:, :, None]
            summary = (enc_out * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
    return enc_out, summary
