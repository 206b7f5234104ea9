"""Cross-entropy row statistics (csrc/xent.cu), forward and backward, and
their plain PyTorch version.

Counterpart of `controllable_xgating_tpu/ops/pallas/xent.py`
(`xent_row_stats`), same contract:

    xent_row_stats(x [N, V] f32, t [N] int) -> (lse, x[t], mean), f32 [N]
    dx = g_lse * exp(x - lse) + g_mean / V + onehot(t) * g_tgt

The three statistics are all `train/xe.py::masked_xe_sum` needs for the
masked and label-smoothed NLL; the loss arithmetic stays there, on [N]
arrays. On a CUDA tensor `xent_row_stats` is a `torch.autograd.Function`
whose forward and backward are one kernel launch each, and it launches or
raises: there is no fallback. On a CPU tensor it is the plain version,
with autograd. The Pallas kernel's 12,288-column cap was the TPU's VMEM;
the CUDA kernels stream each row and take any V that fits an int, which
is all the shape check below asks.
"""

from __future__ import annotations

import torch

from controllable_xgating_torch.ops.kernels import build

_INT_MAX = 2**31 - 1


def xent_row_stats_plain(x: torch.Tensor, t: torch.Tensor):
    """(logsumexp(x, -1), x[t], mean(x, -1)) with autograd."""
    x = x.float()
    return (torch.logsumexp(x, dim=-1), x.gather(-1, t.long()[:, None])[:, 0], x.mean(dim=-1))


def _check(x: torch.Tensor, t: torch.Tensor) -> tuple[int, int]:
    if x.dim() != 2:
        raise ValueError(f"xent kernel: logits must be 2-D [N, V], got shape {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"xent kernel: logits must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("xent kernel: logits must be contiguous")
    n, v = x.shape
    if not 0 < v <= _INT_MAX or n > _INT_MAX:
        raise ValueError(f"xent kernel: shape {tuple(x.shape)} out of range")
    if t.shape != (n,) or t.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"xent kernel: targets must be int [{n}], got {t.dtype} {tuple(t.shape)}")
    if t.device != x.device:
        raise ValueError(f"xent kernel: targets on {t.device}, logits on {x.device}")
    return n, v


def xent_fwd_kernel(x: torch.Tensor, t: torch.Tensor):
    """One launch of the forward kernel: (lse, x[t], mean), f32 [N]."""
    n, v = _check(x, t)
    dev, f32 = x.device, torch.float32
    t = t.long().contiguous()
    lse, tgt, mean = (torch.empty(n, dtype=f32, device=dev) for _ in range(3))
    if n == 0:
        return lse, tgt, mean
    rc = build.launch(
        build.library().cxg_xent_fwd, dev,
        x.data_ptr(), build.check(t, "targets", (n,), torch.int64, dev),
        lse.data_ptr(), tgt.data_ptr(), mean.data_ptr(), n, v,
    )
    build.raise_on_error(rc, "xent_fwd")
    xent_fwd_kernel.launches += 1
    return lse, tgt, mean


def xent_bwd_kernel(x, t, lse, g_lse, g_tgt, g_mean) -> torch.Tensor:
    """One launch of the backward kernel: dx f32 [N, V]."""
    n, v = _check(x, t)
    dev, f32 = x.device, torch.float32
    t = t.long().contiguous()
    dx = torch.empty_like(x)
    if n == 0:
        return dx
    vec = lambda a, name: build.check(a.to(f32).contiguous(), name, (n,), f32, dev)
    rc = build.launch(
        build.library().cxg_xent_bwd, dev,
        x.data_ptr(), build.check(t, "targets", (n,), torch.int64, dev), vec(lse, "lse"),
        vec(g_lse, "g_lse"), vec(g_tgt, "g_tgt"), vec(g_mean, "g_mean"), dx.data_ptr(), n, v,
    )
    build.raise_on_error(rc, "xent_bwd")
    xent_bwd_kernel.launches += 1
    return dx


xent_fwd_kernel.launches = 0
xent_bwd_kernel.launches = 0


class _XentRowStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, t):
        lse, tgt, mean = xent_fwd_kernel(x, t)
        ctx.save_for_backward(x, t, lse)
        return lse, tgt, mean

    @staticmethod
    def backward(ctx, g_lse, g_tgt, g_mean):
        x, t, lse = ctx.saved_tensors
        # a statistic the loss does not use has no cotangent: zero
        zero = lambda g: torch.zeros_like(lse) if g is None else g
        return xent_bwd_kernel(x, t, lse, zero(g_lse), zero(g_tgt), zero(g_mean)), None


def xent_row_stats(x: torch.Tensor, t: torch.Tensor):
    """Per-row (logsumexp, x[target], mean) of 2-D f32 logits, with their
    gradient: the kernels for a CUDA tensor, the plain version for a CPU
    tensor."""
    if x.device.type == "cpu":
        return xent_row_stats_plain(x, t)
    return _XentRowStats.apply(x, t)
