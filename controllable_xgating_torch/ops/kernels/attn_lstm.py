"""Fused attention + gated fusion + LSTM decode step (csrc/attn_lstm.cu)
and its plain version.

Counterpart of `controllable_xgating_tpu/ops/pallas/attn_lstm.py`
(`attn_lstm_step_pallas`). Operands h, e, keys, enc_proj, psi_g, the
weights and v are in the compute dtype; c, the mask, the biases and the
outputs (h', c', alpha) are f32. `w_gate` is split [h; e] and `lstm.wih`
[e; guide]; the guide is rounded to the compute dtype before its matmul.
The weight operands are cast and split once per caption call
(`attn_lstm_weights`), not at every step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from controllable_xgating_torch.ops.attention import NEG_INF
from controllable_xgating_torch.ops.kernels import build
from controllable_xgating_torch.ops.lstm import lstm_cell_pre
from controllable_xgating_torch.ops.precision import compute_dtype, mm


def attn_lstm_step_plain(decoder_params, token_emb, h, c, keys, enc_proj, psi_g,
                         frame_mask=None):
    p = decoder_params
    cdt = compute_dtype()
    hd = p.lstm.hidden_dim
    e_dim = p.embed.shape[1]
    up = lambda t: t.to(cdt).float()
    q = mm(h, p.attn.wq)
    act = torch.tanh(q[:, None, :] + up(keys) + p.attn.b.float())
    scores = (act * up(p.attn.v)).sum(-1)
    if frame_mask is not None:
        scores = torch.where(frame_mask > 0, scores, torch.full_like(scores, NEG_INF))
    alpha = torch.softmax(scores, dim=-1)
    vis_g = (alpha[:, :, None] * up(enc_proj)).sum(1)
    gate = torch.sigmoid(
        mm(h, p.w_gate[:hd]) + mm(token_emb, p.w_gate[hd:]) + p.b_gate.float()
    )
    guide = gate * vis_g + (1.0 - gate) * up(psi_g)
    x_gates = mm(token_emb, p.lstm.wih[:e_dim]) + mm(guide, p.lstm.wih[e_dim:])
    h_new, c_new = lstm_cell_pre(p.lstm, x_gates, h.float(), c)
    return h_new, c_new, alpha


class AttnLstmWeights(NamedTuple):
    """The kernel's weight operands: matrices and v in the compute dtype,
    biases in f32, `w_gate` and `lstm.wih` split into contiguous halves."""

    wq: torch.Tensor     # [Hd, A]
    battn: torch.Tensor  # [A]
    v: torch.Tensor      # [A]
    wg_h: torch.Tensor   # [Hd, G]
    wg_e: torch.Tensor   # [E, G]
    bg: torch.Tensor     # [G]
    wih_e: torch.Tensor  # [E, 4Hd]
    wih_g: torch.Tensor  # [G, 4Hd]
    whh: torch.Tensor    # [Hd, 4Hd]
    bl: torch.Tensor     # [4Hd]


def attn_lstm_weights(decoder_params) -> AttnLstmWeights:
    """Cast the step's weights once, for every step of a caption call
    under the current policy."""
    p = decoder_params
    cdt = compute_dtype()
    hd, e_dim = p.lstm.hidden_dim, p.embed.shape[1]
    cast = lambda x: x.to(cdt).contiguous()
    full = lambda x: x.float().contiguous()
    return AttnLstmWeights(
        wq=cast(p.attn.wq), battn=full(p.attn.b), v=cast(p.attn.v),
        wg_h=cast(p.w_gate[:hd]), wg_e=cast(p.w_gate[hd:]), bg=full(p.b_gate),
        wih_e=cast(p.lstm.wih[:e_dim]), wih_g=cast(p.lstm.wih[e_dim:]),
        whh=cast(p.lstm.whh), bl=full(p.lstm.b),
    )


def attn_lstm_step_kernel(
    decoder_params,
    token_emb: torch.Tensor,  # [B, E] gathered word embedding
    h: torch.Tensor,          # [B, Hd]
    c: torch.Tensor,          # [B, Hd]
    keys: torch.Tensor,       # [B, T, A]
    enc_proj: torch.Tensor,   # [B, T, G] values pre-projected through w_ctx
    psi_g: torch.Tensor,      # [B, G]
    frame_mask=None,          # [B, T] or None
    weights: AttnLstmWeights | None = None,  # from attn_lstm_weights, else cast here
):
    """One decode step without the vocab projection. Returns (h', c', alpha)."""
    if h.device.type == "cpu":
        return attn_lstm_step_plain(
            decoder_params, token_emb, h, c, keys, enc_proj, psi_g, frame_mask
        )
    p = decoder_params
    cdt, f32, dev = compute_dtype(), torch.float32, h.device
    b, hd = h.shape
    _, t, a = keys.shape
    g = psi_g.shape[1]
    e_dim = p.embed.shape[1]
    cast = lambda x: x.to(device=dev, dtype=cdt).contiguous()
    full = lambda x: x.to(device=dev, dtype=f32).contiguous()
    if frame_mask is None:
        frame_mask = torch.ones((b, t), dtype=f32, device=dev)
    lib = build.library()
    smem = lib.cxg_attn_smem_bytes(t, a, g)
    if smem > build.smem_limit(dev):
        raise ValueError(f"attn_lstm kernel: T={t}, A={a}, G={g} need {smem} B of shared memory")
    w = attn_lstm_weights(p) if weights is None else weights
    ops = dict(
        h=cast(h), c=full(c), e=cast(token_emb), keys=cast(keys), encp=cast(enc_proj),
        psi=cast(psi_g), mask=full(frame_mask), **w._asdict(),
    )
    guide = torch.empty((b, g), dtype=cdt, device=dev)
    h_out = torch.empty((b, hd), dtype=f32, device=dev)
    c_out = torch.empty((b, hd), dtype=f32, device=dev)
    alpha = torch.empty((b, t), dtype=f32, device=dev)
    if b == 0:
        return h_out, c_out, alpha
    shapes = dict(
        h=((b, hd), cdt), c=((b, hd), f32), e=((b, e_dim), cdt), keys=((b, t, a), cdt),
        encp=((b, t, g), cdt), psi=((b, g), cdt), mask=((b, t), f32), wq=((hd, a), cdt),
        battn=((a,), f32), v=((a,), cdt), wg_h=((hd, g), cdt), wg_e=((e_dim, g), cdt),
        bg=((g,), f32), wih_e=((e_dim, 4 * hd), cdt), wih_g=((g, 4 * hd), cdt),
        whh=((hd, 4 * hd), cdt), bl=((4 * hd,), f32),
    )
    ptrs = [build.check(ops[n], n, s, dt, dev) for n, (s, dt) in shapes.items()]
    ptrs += [
        build.check(guide, "guide", (b, g), cdt, dev),
        build.check(h_out, "h_out", (b, hd), f32, dev),
        build.check(c_out, "c_out", (b, hd), f32, dev),
        build.check(alpha, "alpha", (b, t), f32, dev),
    ]
    rc = lib.cxg_attn_lstm_fwd(
        build.dtype_code(ops["h"]), *ptrs, b, hd, e_dim, t, a, g, build.stream_ptr(dev)
    )
    build.raise_on_error(rc, "attn_lstm")
    attn_lstm_step_kernel.launches += 1
    return h_out, c_out, alpha


attn_lstm_step_kernel.launches = 0
