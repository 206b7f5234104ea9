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
card, as the JAX CLIs do on any non-CPU backend); tests pin f32. A thread
may pin its own dtype over the global one (`thread_precision`): the
serving engine's dispatcher computes under the dtype the engine was built
with, whatever another thread sets later. `mm` carries the JAX `mm`'s
custom VJP for training.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_POLICY = {"compute_dtype": torch.float32}
_THREAD = threading.local()  # .dtype: this thread's pin over _POLICY, or unset


def _parse(dtype) -> torch.dtype:
    if str(dtype) in ("bfloat16", "bf16", "torch.bfloat16"):
        return torch.bfloat16
    if str(dtype) in ("float32", "f32", "torch.float32"):
        return torch.float32
    raise ValueError(f"compute dtype must be bfloat16 or float32, got {dtype!r}")


def set_compute_dtype(dtype) -> None:
    _POLICY["compute_dtype"] = _parse(dtype)


def compute_dtype() -> torch.dtype:
    """The calling thread's pinned dtype (`thread_precision`), else the
    process-global policy."""
    return getattr(_THREAD, "dtype", None) or _POLICY["compute_dtype"]


@contextmanager
def precision(dtype):
    old = _POLICY["compute_dtype"]
    set_compute_dtype(dtype)
    try:
        yield
    finally:
        _POLICY["compute_dtype"] = old


@contextmanager
def thread_precision(dtype):
    """Pin the calling thread's compute dtype for the block: the global
    policy, and other threads' changes to it, do not reach this thread's
    calls until the block ends."""
    old = getattr(_THREAD, "dtype", None)
    _THREAD.dtype = _parse(dtype)
    try:
        yield
    finally:
        _THREAD.dtype = old


def _mm_plain(a: torch.Tensor, b: torch.Tensor, d: torch.dtype) -> torch.Tensor:
    return torch.matmul(a.to(d).float(), b.to(d).float())


class _PolicyMatmul(torch.autograd.Function):
    """The JAX `mm`'s custom VJP: the cotangent g is rounded to the compute
    dtype, and both transposed products take operands in that dtype with
    f32 products and sums; da and db come back in a's and b's dtypes.
    Plain autograd of `_mm_plain` would leave g in f32 and round da and db
    to bf16 on the way back through the casts. Under the f32 policy the
    two are the same."""

    @staticmethod
    def forward(ctx, a, b):
        d = compute_dtype()
        ctx.save_for_backward(a, b)
        ctx.compute_dtype = d
        return _mm_plain(a, b, d)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        d = ctx.compute_dtype
        g16 = g.to(d).float()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.matmul(g16, b.to(d).float().T).to(a.dtype)  # [..., K]
        if ctx.needs_input_grad[1]:
            a2d = a.reshape(-1, a.shape[-1]).to(d).float()
            db = torch.matmul(a2d.T, g16.reshape(-1, g.shape[-1])).to(b.dtype)  # [K, N]
        return da, db


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Policy matmul: a [..., K] @ b [K, N], operands rounded to the compute
    dtype, product and sum in f32. Returns f32; its backward is the JAX
    `mm`'s custom VJP (`_PolicyMatmul`)."""
    return _PolicyMatmul.apply(a, b)
