"""Fused vocab projection + top-k by iterative extraction + logsumexp.

Counterpart of the JAX package's `experiments/pallas_logits_topk.py`
(`logits_topk_pallas`): the beam tail's contract without `block_unk`,
computed by the topk_extract kernel (`csrc/topk_extract.cu`), which picks
by k rounds of arg-max as the Pallas kernel does. True log-probabilities
of the winners are vals - lse[:, None]; PAD and BOS are excluded.

As in the JAX package, no decode path routes here: beam's fused tail is
the topk_tail kernel. It is reached from the tests alone
(`tests/test_torch_kernels_gpu.py`), which hold it against the plain
version and against topk_tail on the same inputs.
"""

from __future__ import annotations

from typing import Optional

import torch

from controllable_xgating_torch.ops.dispatch import fused_enabled
from controllable_xgating_torch.ops.kernels.topk_extract import (
    logits_topk_extract_kernel,
    logits_topk_extract_plain,
)


def logits_topk_extract(
    h: torch.Tensor,      # [R, Hd] decoder hidden
    w_out: torch.Tensor,  # [Hd, V]
    b_out: torch.Tensor,  # [V]
    k: int,
    fused: Optional[bool] = None,
):
    """Returns (top-k raw logits [R, k] f32, vocab ids [R, k] int64, lse [R] f32)."""
    if fused_enabled(fused):
        return logits_topk_extract_kernel(h, w_out, b_out, k)
    return logits_topk_extract_plain(h, w_out, b_out, k)
