"""Compute-precision policy: params live in f32, matmul operands in the
compute dtype, every accumulation in f32.

Counterpart of `controllable_xgating_tpu/ops/precision.py`. JAX gets f32
accumulation from `preferred_element_type=f32`; a torch `bf16 @ bf16`
returns bf16 and so rounds the accumulator. The plain `mm` therefore
rounds its operands to the compute dtype and multiplies them in f32: a
product of two bf16 values is exact in f32, so this is the same
arithmetic as the mixed-precision matmul, up to summation order.

TF32 is switched off for matmuls and cuDNN: it keeps ~3 decimal digits
and would make the f32 policy a different computation on the card.

The policy is process-global. CLIs set it once at startup (bf16 on the
card, as the JAX CLIs do on any non-CPU backend); tests pin f32. The
custom VJP of the JAX `mm` belongs to training and is not ported yet.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_POLICY = {"compute_dtype": torch.float32}


def set_compute_dtype(dtype) -> None:
    if str(dtype) in ("bfloat16", "bf16", "torch.bfloat16"):
        _POLICY["compute_dtype"] = torch.bfloat16
    elif str(dtype) in ("float32", "f32", "torch.float32"):
        _POLICY["compute_dtype"] = torch.float32
    else:
        raise ValueError(f"compute dtype must be bfloat16 or float32, got {dtype!r}")


def compute_dtype() -> torch.dtype:
    return _POLICY["compute_dtype"]


@contextmanager
def precision(dtype):
    old = _POLICY["compute_dtype"]
    set_compute_dtype(dtype)
    try:
        yield
    finally:
        _POLICY["compute_dtype"] = old


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Policy matmul: a [..., K] @ b [K, N], operands rounded to the compute
    dtype, product and sum in f32. Returns f32."""
    d = _POLICY["compute_dtype"]
    return torch.matmul(a.to(d).float(), b.to(d).float())
