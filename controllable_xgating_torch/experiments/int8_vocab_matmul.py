"""Weight-only int8 vocab projection.

Counterpart of the JAX package's `experiments/int8_vocab_matmul.py`: the
[Hd, V] vocab projection stored as int8 with one f32 scale per column,

    w ~ wq * scale[col]
    logits = f32(bf16(x) @ bf16(wq)) * scale + bias

reached through `decode_step`'s `vocab_q` hook (greedy and beam pass it
through). The fields keep the JAX layout, the vocab axis padded to a
multiple of 1024 (`n` is the true vocab), so they carry across one to one.
x is cast to bf16 whatever the compute policy, as in the JAX function.
`vocab_proj_int8` runs the int8_vocab kernel wrapper on the kernel path
and the plain version otherwise (`set_fused_kernels(False)`). The kernel
reads the weight K-major: a decode loop attaches that operand once per
caption call (`with_kernel_operand`), in the `wq_t` field the JAX tuple
does not have.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from controllable_xgating_torch.ops.dispatch import fused_enabled
from controllable_xgating_torch.ops.kernels.int8_vocab import (
    int8_vocab_plain,
    int8_vocab_proj,
    int8_vocab_weights,
)

TILE_N = 1024


class QuantVocabProj(NamedTuple):
    """Per-column symmetric int8 quantized [Hd, V] projection (+ bias)."""

    wq: torch.Tensor     # [Hd, Vpad] int8
    scale: torch.Tensor  # [1, Vpad] f32
    bias: torch.Tensor   # [1, Vpad] f32
    n: int
    wq_t: Optional[torch.Tensor] = None  # the kernel's K-major wq^T (with_kernel_operand)


def quantize_vocab_proj(w: torch.Tensor, b: torch.Tensor) -> QuantVocabProj:
    """Symmetric per-column quantization of w [Hd, V]: scale = amax / 127
    (1 for a zero column), round half to even, clip to +-127; the bias is
    carried in f32. Padded columns hold wq 0, scale 1, bias 0."""
    with torch.no_grad():
        n = w.shape[1]
        w = w.float()
        amax = w.abs().amax(dim=0)
        scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        wq = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
        bias = b.float()
        pad = (-n) % TILE_N
        if pad:
            wq = F.pad(wq, (0, pad))
            scale = F.pad(scale, (0, pad), value=1.0)
            bias = F.pad(bias, (0, pad))
        return QuantVocabProj(wq.contiguous(), scale[None, :].contiguous(),
                              bias[None, :].contiguous(), n)


def with_kernel_operand(q: QuantVocabProj) -> QuantVocabProj:
    """q with the kernel's K-major weight operand attached, for every step
    of a caption call."""
    return q if q.wq_t is not None else q._replace(wq_t=int8_vocab_weights(q.wq))


def _dequant_matmul_plain(x: torch.Tensor, q: QuantVocabProj) -> torch.Tensor:
    """The plain version over the padded width [M, Vpad]."""
    return int8_vocab_plain(x, q.wq, q.scale, q.bias)


def vocab_proj_int8(x: torch.Tensor, q: QuantVocabProj, fused: Optional[bool] = None) -> torch.Tensor:
    """Quantized logits [M, n] f32."""
    if fused_enabled(fused):
        return int8_vocab_proj(x, q.wq, q.scale, q.bias, q.n, q.wq_t)
    return _dequant_matmul_plain(x, q)[:, : q.n]
