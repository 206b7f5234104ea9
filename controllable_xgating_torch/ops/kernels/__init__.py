"""The port's hand-written Hopper kernels, one wrapper each.

Each wrapper launches its CUDA kernel for CUDA tensors, runs its plain
PyTorch version for CPU tensors, and counts its launches in `.launches`.
"""

from __future__ import annotations

from controllable_xgating_torch.ops.kernels.attn_lstm import attn_lstm_step_kernel
from controllable_xgating_torch.ops.kernels.pos_lstm import pos_lstm_step_kernel
from controllable_xgating_torch.ops.kernels.topk_tail import logits_topk
from controllable_xgating_torch.ops.kernels.xent import xent_bwd_kernel, xent_fwd_kernel
from controllable_xgating_torch.ops.kernels.xgate import xgate_fuse_kernel

WRAPPERS = {
    "xgate": xgate_fuse_kernel,
    "pos_lstm": pos_lstm_step_kernel,
    "attn_lstm": attn_lstm_step_kernel,
    "topk_tail": logits_topk,
    "xent_fwd": xent_fwd_kernel,
    "xent_bwd": xent_bwd_kernel,
}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
