"""XGating fusion kernels (csrc/xgate.cu) and their plain PyTorch version.

Counterpart of `controllable_xgating_tpu/ops/pallas/xgate.py`
(`xgate_fuse_pallas`): every weight, bias and input is cast to the compute
dtype, the five products accumulate in f32, `em` is rounded to the compute
dtype before the gate matmul and `ea * ga` after the product, and the
output passes through the compute dtype on its way back to the input's.

Two routes, chosen from the policy and the shape before any launch:
  * bf16 and `xgate_fits` (da, dm and H % 8 == 0, for 16-byte TMA rows):
    the chain, three wgmma GEMM launches through device memory,
      E = [ea | em] (f32), Eb = [bf16(em) | bf16(ea)],
      P = [bf16(ea * ga) | bf16(em * gm)], out = tanh(P @ Wf + bf),
    on the K-major operands of `xgate_weights`;
  * otherwise (the f32 policy, or other widths) the SIMT kernel that keeps
    a 32-row tile's intermediates in shared memory.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from controllable_xgating_torch.ops.kernels import build
from controllable_xgating_torch.ops.precision import compute_dtype, mm
from controllable_xgating_torch.ops.xgate import XGateWeights


def xgate_fuse_plain(w: XGateWeights, x_app: torch.Tensor, x_motion: torch.Tensor) -> torch.Tensor:
    cdt = compute_dtype()
    bias = lambda b: b.to(cdt).float()
    h = w.wf.shape[0] // 2
    ea = mm(x_app, w.wa) + bias(w.ba)
    em = mm(x_motion, w.wm) + bias(w.bm)
    ga = torch.sigmoid(mm(em, w.uga) + bias(w.bga))
    gm = torch.sigmoid(mm(ea, w.ugm) + bias(w.bgm))
    fused = torch.tanh(mm(ea * ga, w.wf[:h]) + mm(em * gm, w.wf[h:]) + bias(w.bf))
    return fused.to(cdt).to(x_app.dtype)


class XGateOperands(NamedTuple):
    """The chain's operands in the compute dtype: weights K-major ([N, K]),
    biases rounded through it and held in f32."""

    wa_t: torch.Tensor   # [H, Da] = Wa^T
    wm_t: torch.Tensor   # [H, Dm] = Wm^T
    uga_t: torch.Tensor  # [H, H] = Uga^T (the gate of ea, from em)
    ugm_t: torch.Tensor  # [H, H] = Ugm^T (the gate of em, from ea)
    wf_t: torch.Tensor   # [H, 2H] = Wf^T: one product over P = [ea*ga | em*gm]
    ba: torch.Tensor
    bm: torch.Tensor
    bga: torch.Tensor
    bgm: torch.Tensor
    bf: torch.Tensor


def xgate_weights(w: XGateWeights) -> XGateOperands:
    """The chain's K-major operands under the current policy, on the
    weights' device, made once per caption call."""
    cdt = compute_dtype()
    kmajor = lambda t: t.detach().to(cdt).t().contiguous()
    bias = lambda t: t.detach().to(cdt).float().contiguous()
    return XGateOperands(*(kmajor(t) for t in (w.wa, w.wm, w.uga, w.ugm, w.wf)),
                         *(bias(t) for t in (w.ba, w.bm, w.bga, w.bgm, w.bf)))


def xgate_fits(da: int, dm: int, h: int) -> bool:
    """Whether the bf16 chain takes these widths: 16-byte TMA rows of x_app,
    x_motion, the weights and the [R, 2H] scratch."""
    return da % 8 == 0 and dm % 8 == 0 and h % 8 == 0


def xgate_fuse_kernel(
    w: XGateWeights, x_app: torch.Tensor, x_motion: torch.Tensor,
    ops: XGateOperands | None = None,  # xgate_weights(w), else made here
) -> torch.Tensor:
    """Drop-in for `ops/xgate.py::xgate_fuse` in xgate mode (any leading
    dims). CPU tensors take the plain version; CUDA tensors the kernels:
    the bf16 chain where it fits, else the SIMT kernel. One count a call."""
    if w.mode != "xgate":
        raise ValueError("the XGating kernel implements mode='xgate' only")
    if x_app.device.type == "cpu":
        return xgate_fuse_plain(w, x_app, x_motion)
    cdt = compute_dtype()
    lead = x_app.shape[:-1]
    da, dm, h = x_app.shape[-1], x_motion.shape[-1], w.wa.shape[1]
    xa = x_app.reshape(-1, da).to(cdt).contiguous()
    xm = x_motion.reshape(-1, dm).to(cdt).contiguous()
    rows = xa.shape[0]
    if rows == 0:
        return x_app.new_empty((*lead, h))
    if cdt == torch.bfloat16 and xgate_fits(da, dm, h):
        out = _xgate_chain(xgate_weights(w) if ops is None else ops, xa, xm)
    else:
        out = _xgate_simt(w, xa, xm)
    xgate_fuse_kernel.launches += 1
    return out.reshape(*lead, h).to(x_app.dtype)


def _xgate_chain(ops: XGateOperands, xa: torch.Tensor, xm: torch.Tensor) -> torch.Tensor:
    bf16, f32, dev = torch.bfloat16, torch.float32, xa.device
    (rows, da), dm, h = xa.shape, xm.shape[1], ops.wa_t.shape[0]
    e = torch.empty((rows, 2 * h), dtype=f32, device=dev)
    eb = torch.empty((rows, 2 * h), dtype=bf16, device=dev)
    p = torch.empty((rows, 2 * h), dtype=bf16, device=dev)
    out = torch.empty((rows, h), dtype=bf16, device=dev)
    ptrs = [
        build.check(xa, "x_app", (rows, da), bf16, dev),
        build.check(xm, "x_motion", (rows, dm), bf16, dev),
        build.check(ops.wa_t, "wa_t", (h, da), bf16, dev),
        build.check(ops.wm_t, "wm_t", (h, dm), bf16, dev),
        build.check(ops.uga_t, "uga_t", (h, h), bf16, dev),
        build.check(ops.ugm_t, "ugm_t", (h, h), bf16, dev),
        build.check(ops.wf_t, "wf_t", (h, 2 * h), bf16, dev),
        *(build.check(b, n, (h,), f32, dev) for n, b in zip(
            ("ba", "bm", "bga", "bgm", "bf"), (ops.ba, ops.bm, ops.bga, ops.bgm, ops.bf))),
        build.check(e, "e", (rows, 2 * h), f32, dev),
        build.check(eb, "eb", (rows, 2 * h), bf16, dev),
        build.check(p, "p", (rows, 2 * h), bf16, dev),
        build.check(out, "out", (rows, h), bf16, dev),
    ]
    rc = build.launch(build.library().cxg_xgate_chain_fwd, dev, *ptrs, rows, da, dm, h)
    build.raise_on_error(rc, "xgate (bf16 chain)")
    return out


def _xgate_simt(w: XGateWeights, xa: torch.Tensor, xm: torch.Tensor) -> torch.Tensor:
    cdt = compute_dtype()
    (rows, da), dm, h = xa.shape, xm.shape[1], w.wa.shape[1]
    lib = build.library()
    smem = lib.cxg_xgate_smem_bytes(h)
    limit = build.smem_limit(xa.device)
    if smem > limit:
        raise ValueError(
            f"xgate kernel: hidden {h} needs {smem} B of shared memory per block, "
            f"the card allows {limit}"
        )
    dev = xa.device
    cast = lambda t: t.to(device=dev, dtype=cdt).contiguous()
    bias = lambda t: t.to(device=dev, dtype=cdt).float().contiguous()
    wa, wm, uga, ugm, wf = (cast(t) for t in (w.wa, w.wm, w.uga, w.ugm, w.wf))
    ba, bm, bga, bgm, bf = (bias(t) for t in (w.ba, w.bm, w.bga, w.bgm, w.bf))
    out = torch.empty((rows, h), dtype=cdt, device=dev)
    f32 = torch.float32
    ptrs = [
        build.check(xa, "x_app", (rows, da), cdt, dev),
        build.check(xm, "x_motion", (rows, dm), cdt, dev),
        build.check(wa, "wa", (da, h), cdt, dev),
        build.check(wm, "wm", (dm, h), cdt, dev),
        build.check(uga, "uga", (h, h), cdt, dev),
        build.check(ugm, "ugm", (h, h), cdt, dev),
        build.check(wf, "wf", (2 * h, h), cdt, dev),
        *(build.check(b, n, (h,), f32, dev)
          for b, n in ((ba, "ba"), (bm, "bm"), (bga, "bga"), (bgm, "bgm"), (bf, "bf"))),
        build.check(out, "out", (rows, h), cdt, dev),
    ]
    rc = build.launch(lib.cxg_xgate_fwd, dev, build.dtype_code(xa), *ptrs, rows, da, dm, h)
    build.raise_on_error(rc, "xgate")
    return out


xgate_fuse_kernel.launches = 0
