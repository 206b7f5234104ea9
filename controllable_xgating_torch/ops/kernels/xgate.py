"""Fused XGating kernel (csrc/xgate.cu) and its plain PyTorch version.

Counterpart of `controllable_xgating_tpu/ops/pallas/xgate.py`
(`xgate_fuse_pallas`): every weight, bias and input is cast to the compute
dtype, the five products accumulate in f32, `em` is rounded to the compute
dtype before the gate matmul and `ea * ga` after the product, and the
output passes through the compute dtype on its way back to the input's.
"""

from __future__ import annotations

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


def xgate_fuse_kernel(w: XGateWeights, x_app: torch.Tensor, x_motion: torch.Tensor) -> torch.Tensor:
    """Drop-in for `ops/xgate.py::xgate_fuse` in xgate mode (any leading
    dims). CPU tensors take the plain version; CUDA tensors the kernel."""
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
    rc = lib.cxg_xgate_fwd(build.dtype_code(xa), *ptrs, rows, da, dm, h, build.stream_ptr(dev))
    build.raise_on_error(rc, "xgate")
    xgate_fuse_kernel.launches += 1
    return out.reshape(*lead, h).to(x_app.dtype)


xgate_fuse_kernel.launches = 0
