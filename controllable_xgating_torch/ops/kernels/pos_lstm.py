"""Fused POS-generator LSTM step (csrc/pos_lstm.cu) and its plain version.

Counterpart of `controllable_xgating_tpu/ops/pallas/pos_lstm.py`
(`pos_lstm_step_pallas`): gates = e @ Wih_e + s_gates + h @ Whh + b with
e, h and the weights in the compute dtype, s_gates, b and c in f32;
returns (h', c') in f32. The tag-logit projection stays outside.

A rollout makes its operands once (`PosLstmRollout`): the weights cast
(`pos_lstm_weights`), and under the bf16 policy on the card the packed
K-major weight (`pack_pos_weights`), s_gates + b in the packed gate order,
a bf16 copy of the tag embedding, the bf16 buffers of e and of h (a
ping-pong pair: each step's kernel writes bf16(h') into the buffer the
next step reads) and their TMA descriptors, so that a step is one gather
into e's buffer and one launch. Both roundings are the reference's
`astype` (round to nearest even).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from controllable_xgating_torch.ops.kernels import build
from controllable_xgating_torch.ops.kernels.attn_lstm import _permute_gates, _round_up, gate_perm
from controllable_xgating_torch.ops.lstm import lstm_cell_pre
from controllable_xgating_torch.ops.precision import compute_dtype, mm


def pos_lstm_step_plain(pos_params, token_emb, s_gates, h, c):
    p = pos_params
    e_dim = p.embed.shape[1]
    x_gates = mm(token_emb, p.lstm.wih[:e_dim]) + s_gates.float()
    return lstm_cell_pre(p.lstm, x_gates, h.float(), c)


class PosLstmWeights(NamedTuple):
    """The kernel's weight operands: matrices in the compute dtype, the
    bias in f32; under the bf16 policy also the packed weight."""

    wih_e: torch.Tensor  # [Ep, 4H]
    whh: torch.Tensor    # [H, 4H]
    b: torch.Tensor      # [4H]
    w_pack: Optional[torch.Tensor] = None  # [4H', 64 (ceil(Ep/64) + ceil(H/64))] bf16


def pack_pos_weights(pos_params, dtype) -> torch.Tensor:
    """[Wih_e; Whh]^T K-major in gate_perm order, in `dtype`: row p is gate
    column gate_perm(H)[p] (zero for a padding unit); columns [0, Ep) take
    e, then zeros up to the next multiple of 64, where h's H columns start
    (zeros again to a multiple of 64), so that each 64-deep K step of the
    kernel reads one tile of e or of h."""
    p = pos_params
    e_dim, hd = p.embed.shape[1], p.lstm.hidden_dim
    perm = gate_perm(hd)
    we = _permute_gates(p.lstm.wih[:e_dim].float(), perm).t()
    wh = _permute_gates(p.lstm.whh.float(), perm).t()
    return torch.cat([F.pad(we, (0, _round_up(e_dim, 64) - e_dim)),
                      F.pad(wh, (0, _round_up(hd, 64) - hd))], 1).to(dtype).contiguous()


def pack_pos_addend(s_gates: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """s_gates + b [B, 4H] f32 in gate_perm order [B, 4H'], zero for a
    padding unit: what the bf16 kernel adds to its products, made once per
    rollout."""
    return _permute_gates(s_gates.float() + b.float(), gate_perm(b.shape[0] // 4)).contiguous()


def pos_lstm_weights(pos_params) -> PosLstmWeights:
    """Cast the step's weights once, for every step of a rollout under the
    current policy."""
    p = pos_params
    cdt = compute_dtype()
    e_dim = p.embed.shape[1]
    return PosLstmWeights(
        p.lstm.wih[:e_dim].to(cdt).contiguous(), p.lstm.whh.to(cdt).contiguous(),
        p.lstm.b.float().contiguous(),
        pack_pos_weights(p, cdt) if cdt == torch.bfloat16 else None,
    )


class PosLstmRollout:
    """The POS LSTM steps of one rollout from the state h [B, H], with the
    rollout's s_gates [B, 4H] (summary @ Wih_s): each `step` advances h
    (kept here) and returns (h', c') in f32. CPU tensors take the plain
    version; CUDA tensors launch the kernel, the bf16 policy's on operands
    made here once. `launches` counts the kernel's launches."""

    launches = 0

    def __init__(self, pos_params, h: torch.Tensor, s_gates: torch.Tensor,
                 weights: PosLstmWeights | None = None):
        p = self.p = pos_params
        self.w = pos_lstm_weights(p) if weights is None else weights
        self.h = h
        self.dev = h.device
        self.s_gates = s_gates.to(device=self.dev, dtype=torch.float32).clone()
        self.rows, self.hd = h.shape
        self.e_dim = p.embed.shape[1]
        self.bf16 = self.dev.type == "cuda" and compute_dtype() == torch.bfloat16
        if not self.bf16 or self.rows == 0:
            return
        bf16, dev, b, hd = torch.bfloat16, self.dev, self.rows, self.hd
        if self.w.w_pack is None:
            raise ValueError("pos_lstm kernel (bf16): the weights lack the packed operand")
        ep8, hd8 = _round_up(self.e_dim, 8), _round_up(hd, 8)
        self.sgb = pack_pos_addend(self.s_gates, self.w.b)
        self.table = F.pad(p.embed.to(bf16), (0, ep8 - self.e_dim)).contiguous()
        self.e = torch.zeros((b, ep8), dtype=bf16, device=dev)
        self.hb = torch.zeros((2, b, hd8), dtype=bf16, device=dev)
        self.hb[0, :, :hd] = h
        self.cur = 0
        n_cell = 4 * _round_up(hd, 4)
        kw = 64 * (-(-self.e_dim // 64) + -(-hd // 64))
        w_pack = build.check(self.w.w_pack, "w_pack", (n_cell, kw), bf16, dev)
        build.check(self.sgb, "s_gates", (b, n_cell), torch.float32, dev)
        lib = build.library()
        self.maps = ctypes.create_string_buffer(lib.cxg_pos_lstm_maps_bytes())
        rc = lib.cxg_pos_lstm_bf16_plan(self.maps, self.e.data_ptr(), self.hb[0].data_ptr(),
                                        self.hb[1].data_ptr(), w_pack, b, self.e_dim, hd)
        build.raise_on_error(rc, "pos_lstm (TMA descriptors)")

    def reset(self, h: torch.Tensor, s_gates: torch.Tensor) -> None:
        """Start another rollout from h [B, H] with s_gates [B, 4H] on this
        rollout's own buffers, in place, so that the TMA descriptors (which
        hold the addresses of e, hb and the packed weight) stay valid: the
        weight operands are made again from the parameters (which may have
        changed in place), s_gates and, under the bf16 policy, s_gates + b,
        the bf16 tag table and hb[0] are refreshed, and the ping-pong starts
        again from hb[0]."""
        for dst, src in zip(self.w, pos_lstm_weights(self.p)):
            if dst is not None:
                dst.copy_(src)
        self.h = h
        self.s_gates.copy_(s_gates)
        if not self.bf16 or self.rows == 0:
            return
        self.sgb.copy_(pack_pos_addend(self.s_gates, self.w.b))
        self.table[:, :self.e_dim].copy_(self.p.embed)
        self.hb[0, :, :self.hd].copy_(h)
        self.cur = 0

    def step(self, c: torch.Tensor, tok: torch.Tensor, h: Optional[torch.Tensor] = None):
        """One step on the tags `tok` [B] (their embedding gathered here);
        c [B, H] f32. Returns (h', c') in f32. `h` is the state to step
        from where it is read in f32 (the plain version, the f32 policy's
        kernel), by default the last step's h' (kept here); the bf16
        kernel keeps its own bf16 copy in hb."""
        p, dev, f32 = self.p, self.dev, torch.float32
        if h is not None:
            self.h = h
        if dev.type == "cpu":
            self.h, c_new = pos_lstm_step_plain(p, p.embed[tok], self.s_gates, self.h, c)
            return self.h, c_new
        b, hd = self.rows, self.hd
        h_out = torch.empty((b, hd), dtype=f32, device=dev)
        c_out = torch.empty((b, hd), dtype=f32, device=dev)
        if b == 0:
            return h_out, c_out
        lib = build.library()
        c = c.to(device=dev, dtype=f32).contiguous()
        cp = build.check(c, "c", (b, hd), f32, dev)
        if self.bf16:
            torch.index_select(self.table, 0, tok, out=self.e)
            nxt = 1 - self.cur
            rc = build.launch(
                lib.cxg_pos_lstm_bf16_fwd, dev, self.maps, self.cur, self.sgb.data_ptr(), cp,
                h_out.data_ptr(), c_out.data_ptr(), self.hb[nxt].data_ptr(), b, self.e_dim, hd)
            self.cur = nxt
        else:
            e = p.embed[tok].to(device=dev, dtype=f32).contiguous()
            hf = self.h.to(device=dev, dtype=f32).contiguous()
            ptrs = [
                build.check(e, "token_emb", (b, self.e_dim), f32, dev),
                build.check(hf, "h", (b, hd), f32, dev),
                build.check(self.s_gates, "s_gates", (b, 4 * hd), f32, dev), cp,
                build.check(self.w.wih_e, "wih_e", (self.e_dim, 4 * hd), f32, dev),
                build.check(self.w.whh, "whh", (hd, 4 * hd), f32, dev),
                build.check(self.w.b, "b", (4 * hd,), f32, dev),
            ]
            rc = build.launch(lib.cxg_pos_lstm_fwd, dev, *ptrs, h_out.data_ptr(),
                              c_out.data_ptr(), b, self.e_dim, hd)
        build.raise_on_error(rc, "pos_lstm")
        PosLstmRollout.launches += 1
        self.h = h_out
        return h_out, c_out

