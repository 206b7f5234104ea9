"""The port's hand-written Hopper kernels, one wrapper each.

Each wrapper launches its CUDA kernel for CUDA tensors, runs its plain
PyTorch version for CPU tensors, and counts its launches in `.launches`
(the POS LSTM step's wrapper is `PosLstmRollout.step`, counted on the
class).
"""

from __future__ import annotations

from controllable_xgating_torch.ops.kernels.attn_lstm import attn_lstm_step_kernel
from controllable_xgating_torch.ops.kernels.int8_vocab import int8_vocab_proj
from controllable_xgating_torch.ops.kernels.pos_lstm import PosLstmRollout
from controllable_xgating_torch.ops.kernels.topk_extract import logits_topk_extract_kernel
from controllable_xgating_torch.ops.kernels.topk_tail import logits_topk
from controllable_xgating_torch.ops.kernels.xent import xent_bwd_kernel, xent_fwd_kernel
from controllable_xgating_torch.ops.kernels.xgate import xgate_fuse_kernel

WRAPPERS = {
    "xgate": xgate_fuse_kernel,
    "pos_lstm": PosLstmRollout,
    "attn_lstm": attn_lstm_step_kernel,
    "topk_tail": logits_topk,
    "xent_fwd": xent_fwd_kernel,
    "xent_bwd": xent_bwd_kernel,
    "int8_vocab": int8_vocab_proj,
    "topk_extract": logits_topk_extract_kernel,
}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
