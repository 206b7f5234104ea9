"""Cross-gated ("XGating") fusion of appearance and motion streams.

Counterpart of `controllable_xgating_tpu/ops/xgate.py`:

    ea = x_a @ Wa + ba ; em = x_m @ Wm + bm
    ga = sigmoid(em @ Uga + bga) ; gm = sigmoid(ea @ Ugm + bgm)
    fused = tanh([ea*ga ; em*gm] @ Wf + bf)

in the split-Wf form (no concat). Mode "concat" is the paper's no-gating
ablation. The fused kernel is `ops/kernels/xgate.py`.
"""

from __future__ import annotations

import torch
from torch import nn

from controllable_xgating_torch.ops.params import param, uniform_fan_in
from controllable_xgating_torch.ops.precision import mm


class XGateWeights(nn.Module):
    def __init__(self, wa, ba, wm, bm, uga, bga, ugm, bgm, wf, bf, mode: str = "xgate"):
        super().__init__()
        if mode not in ("xgate", "concat"):
            raise ValueError(f"xgate mode must be xgate|concat, got {mode!r}")
        self.wa = param(wa)    # [Da, H]
        self.ba = param(ba)    # [H]
        self.wm = param(wm)    # [Dm, H]
        self.bm = param(bm)    # [H]
        self.uga = param(uga)  # [H, H] gate for appearance, from motion
        self.bga = param(bga)
        self.ugm = param(ugm)  # [H, H] gate for motion, from appearance
        self.bgm = param(bgm)
        self.wf = param(wf)    # [2H, H]
        self.bf = param(bf)
        self.mode = mode


def init_xgate(
    gen: torch.Generator, app_dim: int, motion_dim: int, hidden: int,
    mode: str = "xgate",
) -> XGateWeights:
    z = lambda: torch.zeros(hidden)
    return XGateWeights(
        wa=uniform_fan_in(gen, (app_dim, hidden)), ba=z(),
        wm=uniform_fan_in(gen, (motion_dim, hidden)), bm=z(),
        uga=uniform_fan_in(gen, (hidden, hidden)), bga=z(),
        ugm=uniform_fan_in(gen, (hidden, hidden)), bgm=z(),
        wf=uniform_fan_in(gen, (2 * hidden, hidden)), bf=z(),
        mode=mode,
    )


def xgate_fuse(w: XGateWeights, x_app: torch.Tensor, x_motion: torch.Tensor) -> torch.Tensor:
    """Fuse [.., Da] and [.., Dm] -> [.., H]. Plain path."""
    ea = mm(x_app, w.wa) + w.ba.float()
    em = mm(x_motion, w.wm) + w.bm.float()
    h = w.wf.shape[0] // 2
    if w.mode == "concat":
        fused = torch.tanh(mm(ea, w.wf[:h]) + mm(em, w.wf[h:]) + w.bf.float())
        return fused.to(x_app.dtype)
    ga = torch.sigmoid(mm(em, w.uga) + w.bga.float())
    gm = torch.sigmoid(mm(ea, w.ugm) + w.bgm.float())
    fused = torch.tanh(mm(ea * ga, w.wf[:h]) + mm(em * gm, w.wf[h:]) + w.bf.float())
    return fused.to(x_app.dtype)
