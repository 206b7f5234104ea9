"""Fused attention + gated fusion + LSTM decode step (csrc/attn_lstm.cu)
and its plain version.

Counterpart of `controllable_xgating_tpu/ops/pallas/attn_lstm.py`
(`attn_lstm_step_pallas`). Operands h, e, keys, enc_proj, psi_g, the
weights and v are in the compute dtype; c, the mask, the biases and the
outputs (h', c', alpha) are f32. `w_gate` is split [h; e] and `lstm.wih`
[e; guide]; the guide is rounded to the compute dtype before its matmul.
The weight operands are cast, split and packed once per caption call
(`attn_lstm_weights`), not at every step. Under the bf16 policy the kernel
is three launches (a wgmma GEMM of [h | e] against the packed
`pack_pre_weights`, the memory-bound attention, the guide's wgmma GEMM with
the LSTM tail in its epilogue, on `pack_cell_weights`); under f32 it is the
SIMT path of two launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

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


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def gate_perm(hd: int) -> torch.Tensor:
    """The bf16 cell kernel's order of the 4 Hd LSTM gate columns: entry p
    is the source column (gate * Hd + unit) of packed column p, -1 for the
    padding units of Hd rounded up to 4. Packed 16-column block j holds
    units 4j .. 4j + 3; unit 4j + q has i, f at columns 2q, 2q + 1 and g, o
    at 8 + 2q, 9 + 2q, the columns thread q of a quad holds in a wgmma
    accumulator, so the LSTM tail needs no exchange between threads."""
    p = torch.arange(4 * _round_up(hd, 4))
    w = p % 16
    unit = 4 * (p // 16) + (w % 8) // 2
    gate = w % 2 + 2 * (w // 8)
    return torch.where(unit < hd, gate * hd + unit, torch.full_like(p, -1))


def _permute_gates(w: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """w [..., 4 Hd] -> [..., len(perm)] in gate_perm order, zero padding."""
    perm = perm.to(w.device)
    return torch.where(perm >= 0, w[..., perm.clamp(min=0)], torch.zeros((), dtype=w.dtype,
                                                                          device=w.device))


def pack_pre_weights(decoder_params, dtype) -> torch.Tensor:
    """W_pre^T [A + G + 4 Hd', round_up(Hd + E, 8)], K-major, in `dtype`:
    [h | e] @ W_pre gives q = h @ Wq, gate_pre = h @ Wg_h + e @ Wg_e and
    lstm_pre = e @ Wih_e + h @ Whh (in gate_perm order) side by side, the
    three products of the bf16 kernel's first launch."""
    p = decoder_params
    hd, e_dim = p.lstm.hidden_dim, p.embed.shape[1]
    perm = gate_perm(hd)
    wq = p.attn.wq.float()
    from_h = torch.cat([wq, p.w_gate[:hd].float(), _permute_gates(p.lstm.whh.float(), perm)], 1)
    from_e = torch.cat([
        torch.zeros((e_dim, wq.shape[1]), device=wq.device), p.w_gate[hd:].float(),
        _permute_gates(p.lstm.wih[:e_dim].float(), perm),
    ], 1)
    w = torch.cat([from_h, from_e], 0).t()
    return F.pad(w, (0, _round_up(hd + e_dim, 8) - (hd + e_dim))).to(dtype).contiguous()


def pack_cell_weights(decoder_params, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """(W_cell^T [4 Hd', round_up(G, 8)] K-major in `dtype`, b [4 Hd'] f32):
    the guide's LSTM input weight and the LSTM bias in gate_perm order."""
    p = decoder_params
    e_dim = p.embed.shape[1]
    perm = gate_perm(p.lstm.hidden_dim)
    w = _permute_gates(p.lstm.wih[e_dim:].float(), perm).t()
    g = w.shape[1]
    return (F.pad(w, (0, _round_up(g, 8) - g)).to(dtype).contiguous(),
            _permute_gates(p.lstm.b.float(), perm).contiguous())


class AttnLstmWeights(NamedTuple):
    """The kernel's weight operands: matrices and v in the compute dtype,
    biases in f32. The f32 policy's kernel takes `w_gate` and `lstm.wih`
    split into contiguous halves; the bf16 policy's takes the packed
    K-major operands (`pack_pre_weights`, `pack_cell_weights`)."""

    wq: torch.Tensor      # [Hd, A]
    battn: torch.Tensor   # [A]
    v: torch.Tensor       # [A]
    wg_h: torch.Tensor    # [Hd, G]
    wg_e: torch.Tensor    # [E, G]
    bg: torch.Tensor      # [G]
    wih_e: torch.Tensor   # [E, 4Hd]
    wih_g: torch.Tensor   # [G, 4Hd]
    whh: torch.Tensor     # [Hd, 4Hd]
    bl: torch.Tensor      # [4Hd]
    w_pre: torch.Tensor   # [A + G + 4Hd', round_up(Hd + E, 8)]
    w_cell: torch.Tensor  # [4Hd', round_up(G, 8)]
    b_cell: torch.Tensor  # [4Hd']


def attn_lstm_weights(decoder_params) -> AttnLstmWeights:
    """Cast and pack the step's weights once, for every step of a caption
    call under the current policy."""
    p = decoder_params
    cdt = compute_dtype()
    hd, e_dim = p.lstm.hidden_dim, p.embed.shape[1]
    cast = lambda x: x.to(cdt).contiguous()
    full = lambda x: x.float().contiguous()
    w_cell, b_cell = pack_cell_weights(p, cdt)
    return AttnLstmWeights(
        wq=cast(p.attn.wq), battn=full(p.attn.b), v=cast(p.attn.v),
        wg_h=cast(p.w_gate[:hd]), wg_e=cast(p.w_gate[hd:]), bg=full(p.b_gate),
        wih_e=cast(p.lstm.wih[:e_dim]), wih_g=cast(p.lstm.wih[e_dim:]),
        whh=cast(p.lstm.whh), bl=full(p.lstm.b),
        w_pre=pack_pre_weights(p, cdt), w_cell=w_cell, b_cell=b_cell,
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
    w = attn_lstm_weights(p) if weights is None else weights
    h_out = torch.empty((b, hd), dtype=f32, device=dev)
    c_out = torch.empty((b, hd), dtype=f32, device=dev)
    alpha = torch.empty((b, t), dtype=f32, device=dev)
    if b == 0:
        return h_out, c_out, alpha
    lib = build.library()
    bf16 = cdt == torch.bfloat16
    smem = lib.cxg_attn_bf16_smem_bytes(t, a, g) if bf16 else lib.cxg_attn_smem_bytes(t, a, g)
    if smem > build.smem_limit(dev):
        raise ValueError(f"attn_lstm kernel: T={t}, A={a}, G={g} need {smem} B of shared memory")
    ops = dict(
        c=full(c), keys=cast(keys), encp=cast(enc_proj), psi=cast(psi_g), mask=full(frame_mask),
        **w._asdict(),
    )
    shapes = dict(
        c=((b, hd), f32), keys=((b, t, a), cdt), encp=((b, t, g), cdt), psi=((b, g), cdt),
        mask=((b, t), f32), battn=((a,), f32), v=((a,), cdt), bg=((g,), f32),
    )
    check = lambda *names: [build.check(ops[n], n, *shapes[n], dev) for n in names]
    outs = [
        build.check(h_out, "h_out", (b, hd), f32, dev),
        build.check(c_out, "c_out", (b, hd), f32, dev),
        build.check(alpha, "alpha", (b, t), f32, dev),
    ]
    if bf16:
        # x = [h | e] in bf16; the pre-activation scratch; the guide
        kxp, n_cell, gp = _round_up(hd + e_dim, 8), 4 * _round_up(hd, 4), _round_up(g, 8)
        n_pre = a + g + n_cell
        ops["x"] = torch.empty((b, kxp), dtype=cdt, device=dev)
        ops["x"][:, :hd] = h
        ops["x"][:, hd:hd + e_dim] = token_emb
        ops["pre"] = torch.empty((b, n_pre), dtype=f32, device=dev)
        ops["guide"] = torch.empty((b, gp), dtype=cdt, device=dev)
        shapes.update(
            x=((b, kxp), cdt), w_pre=((n_pre, kxp), cdt), pre=((b, n_pre), f32),
            guide=((b, gp), cdt), w_cell=((n_cell, gp), cdt), b_cell=((n_cell,), f32),
        )
        ptrs = check("x", "w_pre", "pre", "keys", "encp", "psi", "mask", "battn", "v", "bg",
                     "guide", "w_cell", "b_cell", "c")
        rc = build.launch(lib.cxg_attn_lstm_bf16_fwd, dev, *ptrs, *outs, b, hd, e_dim, t, a, g)
    else:
        ops.update(h=cast(h), e=cast(token_emb), guide=torch.empty((b, g), dtype=cdt, device=dev))
        shapes.update(
            h=((b, hd), cdt), e=((b, e_dim), cdt), wq=((hd, a), cdt), wg_h=((hd, g), cdt),
            wg_e=((e_dim, g), cdt), wih_e=((e_dim, 4 * hd), cdt), wih_g=((g, 4 * hd), cdt),
            whh=((hd, 4 * hd), cdt), bl=((4 * hd,), f32), guide=((b, g), cdt),
        )
        ptrs = check("h", "c", "e", "keys", "encp", "psi", "mask", "wq", "battn", "v", "wg_h",
                     "wg_e", "bg", "wih_e", "wih_g", "whh", "bl", "guide")
        rc = build.launch(lib.cxg_attn_lstm_fwd, dev, *ptrs, *outs, b, hd, e_dim, t, a, g)
    build.raise_on_error(rc, "attn_lstm")
    attn_lstm_step_kernel.launches += 1
    return h_out, c_out, alpha


attn_lstm_step_kernel.launches = 0
