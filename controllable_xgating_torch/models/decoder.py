"""Caption decoder: temporal-attention LSTM with gated visual/syntax fusion.

Counterpart of `controllable_xgating_tpu/models/decoder.py`. Each step:
additive attention over the encoder memory gives a visual context; a
sigmoid gate over [h ; emb(w)] mixes it with the projected POS feature
psi; the LSTM cell consumes [emb(w) ; guide] and projects to vocab logits.
h and c are carried in f32. `decoder_forward` is the teacher-forced pass
of XE training. `decode_step`'s `vocab_q` hook takes a weight-only int8
vocab projection (`experiments/int8_vocab_matmul.py`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from controllable_xgating_torch.ops import dropout
from controllable_xgating_torch.ops.attention import (
    AttentionWeights,
    additive_attention,
    init_attention,
    precompute_keys,
)
from controllable_xgating_torch.ops.lstm import LSTMWeights, init_lstm, lstm_cell
from controllable_xgating_torch.ops.params import normal, param, uniform_fan_in
from controllable_xgating_torch.ops.precision import compute_dtype, mm


class DecoderParams(nn.Module):
    def __init__(self, embed, init_h, init_c, attn: AttentionWeights, w_ctx, w_psi,
                 w_gate, b_gate, lstm: LSTMWeights, w_out, b_out, use_psi: bool = True):
        super().__init__()
        self.embed = param(embed)    # [V, E]
        self.init_h = param(init_h)  # [He, Hd]
        self.init_c = param(init_c)  # [He, Hd]
        self.attn = attn
        self.w_ctx = param(w_ctx)    # [He, G] visual context -> guide space
        self.w_psi = param(w_psi)    # [P, G]  psi -> guide space
        self.w_gate = param(w_gate)  # [Hd + E, G]
        self.b_gate = param(b_gate)  # [G]
        self.lstm = lstm             # input dim E + G, hidden Hd
        self.w_out = param(w_out)    # [Hd, V]
        self.b_out = param(b_out)    # [V]
        # paper §4 ablation: False zeroes psi in make_decode_context
        self.use_psi = use_psi

    @property
    def vocab_size(self) -> int:
        return self.w_out.shape[1]

    @property
    def hidden_dim(self) -> int:
        return self.lstm.hidden_dim


def init_decoder(
    gen: torch.Generator, vocab: int, enc_dim: int, hidden: int, embed_dim: int,
    attn_dim: int, psi_dim: int, guide_dim: Optional[int] = None, use_psi: bool = True,
) -> DecoderParams:
    guide_dim = guide_dim or hidden
    return DecoderParams(
        embed=normal(gen, (vocab, embed_dim), 0.1),
        init_h=uniform_fan_in(gen, (enc_dim, hidden)),
        init_c=uniform_fan_in(gen, (enc_dim, hidden)),
        attn=init_attention(gen, hidden, enc_dim, attn_dim),
        w_ctx=uniform_fan_in(gen, (enc_dim, guide_dim)),
        w_psi=uniform_fan_in(gen, (psi_dim, guide_dim)),
        w_gate=uniform_fan_in(gen, (hidden + embed_dim, guide_dim)),
        b_gate=torch.zeros(guide_dim),
        lstm=init_lstm(gen, embed_dim + guide_dim, hidden),
        w_out=uniform_fan_in(gen, (hidden, vocab)),
        b_out=torch.zeros(vocab),
        use_psi=use_psi,
    )


class DecodeContext(NamedTuple):
    """Per-sequence constants reused by every decode step. `enc_proj` is the
    encoder memory already pushed through `w_ctx` (attention is linear in
    its values, so projecting once per sequence is the same arithmetic)."""

    enc_proj: torch.Tensor              # [B, T, G]
    keys: torch.Tensor                  # [B, T, A]
    frame_mask: Optional[torch.Tensor]  # [B, T]
    psi_g: torch.Tensor                 # [B, G]


def make_decode_context(
    params: DecoderParams, enc_out: torch.Tensor, psi: torch.Tensor,
    frame_mask: Optional[torch.Tensor] = None,
) -> DecodeContext:
    """The context tensors are re-read every step, so they are stored in the
    compute dtype (half the bytes under bf16)."""
    cdt = compute_dtype()
    if not params.use_psi:
        psi = psi * 0
    return DecodeContext(
        enc_proj=mm(enc_out, params.w_ctx).to(cdt),
        keys=precompute_keys(params.attn, enc_out).to(cdt),
        frame_mask=frame_mask,
        psi_g=mm(psi, params.w_psi).to(cdt),
    )


def init_decoder_state(params: DecoderParams, summary: torch.Tensor):
    h = torch.tanh(mm(summary, params.init_h))
    c = torch.tanh(mm(summary, params.init_c))
    return h.to(summary.dtype), c.to(summary.dtype)


def decode_step(
    params: DecoderParams,
    ctx: DecodeContext,
    token: torch.Tensor,  # [B] previous word
    h: torch.Tensor,      # [B, Hd]
    c: torch.Tensor,      # [B, Hd]
    fused: Optional[bool] = None,
    return_hidden: bool = False,
    kernel_weights=None,
    vocab_q=None,
):
    """One decode step. Returns (logits [B, V], h', c', alpha [B, T]).

    `fused=True` routes attention + gate + cell through the attn_lstm
    kernel wrapper; a decode loop passes that wrapper's weights, cast once
    by `attn_lstm_weights`, as `kernel_weights`. `vocab_q` (a
    `QuantVocabProj`) swaps the vocab projection for the weight-only int8
    one, through the int8_vocab kernel wrapper when `fused`; a decode loop
    attaches that kernel's K-major weight to it once (`with_kernel_operand`).
    `return_hidden=True` skips the vocab projection and returns h' in the
    logits slot, for a caller that fuses the projection into its own tail
    (beam's top-K kernel); it wins over `vocab_q`."""

    def project(h_out):
        if return_hidden:
            return h_out
        if vocab_q is not None:
            from controllable_xgating_torch.experiments.int8_vocab_matmul import vocab_proj_int8

            return vocab_proj_int8(h_out, vocab_q, fused=bool(fused))
        return mm(h_out, params.w_out) + params.b_out.float()

    e = params.embed[token]
    if fused:
        from controllable_xgating_torch.ops.kernels.attn_lstm import attn_lstm_step_kernel

        h_new, c_new, alpha = attn_lstm_step_kernel(
            params, e, h, c, ctx.keys, ctx.enc_proj, ctx.psi_g, ctx.frame_mask, kernel_weights
        )
        return project(h_new), h_new, c_new, alpha
    h_new, c_new, alpha = _attend_gate_cell(params, ctx, e, h, c)
    return project(h_new), h_new, c_new, alpha


def _attend_gate_cell(params: DecoderParams, ctx: DecodeContext, e, h, c):
    """Attention, syntax gate and LSTM cell of one step on the embedded
    word e: (h', c', alpha). The plain path of `decode_step`, and the step
    of `decoder_forward`."""
    vis_g, alpha = additive_attention(params.attn, h, ctx.enc_proj, ctx.keys, ctx.frame_mask)
    vis_g = vis_g.float()
    gate = torch.sigmoid(mm(torch.cat([h, e], -1), params.w_gate) + params.b_gate.float())
    guide = gate * vis_g + (1.0 - gate) * ctx.psi_g.float()
    x = torch.cat([e, guide.to(e.dtype)], dim=-1)
    h_new, c_new = lstm_cell(params.lstm, x, h, c)
    return h_new, c_new, alpha


def _hidden_step(params, ctx, token, h, c, emb_drop=None, out_drop=None):
    """decode_step without the vocab projection, with the step's dropout
    multipliers: (h_out, h', c')."""
    e = params.embed[token]
    if emb_drop is not None:
        e = e * emb_drop
    h_new, c_new, _ = _attend_gate_cell(params, ctx, e, h, c)
    h_out = h_new * out_drop if out_drop is not None else h_new
    return h_out, h_new, c_new


def decoder_forward(
    params: DecoderParams,
    ctx: DecodeContext,
    summary: torch.Tensor,   # [B, He]
    captions: torch.Tensor,  # [B, L] BOS ... EOS PAD*
    gen: Optional[torch.Generator] = None,
    dropout_rate: float = 0.0,
    remat: bool = False,
    shard: tuple = (0, 1),
) -> torch.Tensor:
    """Teacher-forced logits [B, L-1, V]; logits[:, t] predicts captions[:, t+1].

    Counterpart of the JAX `decoder_forward`: the L-1 steps run as a Python
    loop of the plain attention + gate + cell (the attn_lstm kernel has no
    backward), the dropout multipliers of every step are drawn up front
    (`emb_drop` [L-1, B, E], `out_drop` [L-1, B, Hd]), and the vocab
    projection is hoisted out of the loop into one product over all
    steps' hidden states, which are stacked batch-major so that the logits
    come out contiguous. `remat=True` checkpoints each step: the backward
    recomputes its attention and gate instead of keeping them. The batch
    is block `shard` of the global batch's rows (`dropout.keep_rows`)."""
    b, length = captions.shape
    h, c = init_decoder_state(params, summary)
    inputs = captions[:, :-1].long()
    emb_drop = out_drop = None
    if gen is not None and dropout_rate > 0.0:
        scale = 1.0 / (1.0 - dropout_rate)
        dev, dt = params.embed.device, params.embed.dtype
        emb_drop = dropout.keep_rows(
            gen, (length - 1, b, params.embed.shape[1]), dropout_rate, dev, 1, shard).to(dt) * scale
        out_drop = dropout.keep_rows(
            gen, (length - 1, b, params.hidden_dim), dropout_rate, dev, 1, shard).to(dt) * scale
    hs = []
    for t in range(length - 1):
        args = (params, ctx, inputs[:, t], h, c,
                None if emb_drop is None else emb_drop[t], None if out_drop is None else out_drop[t])
        if remat:
            h_out, h, c = checkpoint(_hidden_step, *args, use_reentrant=False)
        else:
            h_out, h, c = _hidden_step(*args)
        hs.append(h_out)
    hs = torch.stack(hs, dim=1)  # [B, L-1, Hd]
    return mm(hs, params.w_out) + params.b_out.float()
