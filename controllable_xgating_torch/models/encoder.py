"""XGating fusion encoder: embed + cross-gate + temporal BiLSTM.

Counterpart of `controllable_xgating_tpu/models/encoder.py`. Outputs the
attention memory `enc_out` [B, T, He] and the masked-mean `summary`
[B, He] that initialises the POS generator and the decoder.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from controllable_xgating_torch.ops import dropout
from controllable_xgating_torch.ops.lstm import LSTMWeights, bilstm_scan, init_lstm, lstm_scan
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
    (the scan and the summary), both timed on the card."""
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
        if params.lstm_bwd is not None:
            enc_out, _ = bilstm_scan(params.lstm_fwd, params.lstm_bwd, fused, frame_mask)
        else:
            enc_out, _ = lstm_scan(params.lstm_fwd, fused, frame_mask)
        if frame_mask is None:
            summary = enc_out.mean(dim=1)
        else:
            m = frame_mask.to(enc_out.dtype)[:, :, None]
            summary = (enc_out * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
    return enc_out, summary
