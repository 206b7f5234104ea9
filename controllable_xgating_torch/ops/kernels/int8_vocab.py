"""Weight-only int8 vocab projection (csrc/int8_vocab.cu) and its plain
PyTorch version.

Counterpart of the Pallas kernel of `experiments/int8_vocab_matmul.py`
(`_int8_matmul_pallas`), same contract:

    out = f32(bf16(x) @ bf16(wq)) * scale + bias     [M, n]

x is cast to bf16 whatever the compute policy, as the JAX function does;
int8 -> bf16 is exact, the products and sums are f32. `wq` [K, Vpad] int8
and `scale`, `bias` [1, Vpad] f32 carry the vocab padded to a multiple of
1024 (`experiments/int8_vocab_matmul.py`). The kernel reads the weight
K-major, `int8_vocab_weights(wq)` = wq^T [Vpad, round_up(K, 64)] in its
fragment order, made once per caption call, and writes only the n true
columns. Any depth K is taken: x gets zero columns up to a multiple of 8
(`x_operand`, 16-byte rows for TMA), against which wq_t is already zero.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from controllable_xgating_torch.ops.kernels import build

_BN = 128  # the kernel's vocab tile


def int8_vocab_plain(x, wq, scale, bias) -> torch.Tensor:
    """Logits over the padded width [M, Vpad] f32."""
    bf16 = torch.bfloat16
    acc = torch.matmul(x.to(bf16).float(), wq.to(bf16).float())
    return acc * scale + bias


def int8_vocab_weights(wq: torch.Tensor) -> torch.Tensor:
    """The kernel's weight operand: wq^T [Vpad, round_up(K, 64)] int8,
    K-major, zero past K, the 64 bytes of each K block in fragment order:
    byte 16q + 4kk + 2h + b holds k = 16kk + 8h + 2q + b, so that the four
    16-deep chunks' bytes of one thread (q = lane % 4) lie together."""
    k, vpad = wq.shape
    kp = -(-k // 64) * 64
    p = torch.arange(64)
    src = 16 * ((p % 16) // 4) + 8 * ((p % 4) // 2) + 2 * (p // 16) + p % 2
    w = F.pad(wq.t(), (0, kp - k)).reshape(vpad, kp // 64, 64)
    return w[:, :, src.to(wq.device)].reshape(vpad, kp).contiguous()


def x_operand(x: torch.Tensor) -> torch.Tensor:
    """The kernel's x operand: bf16, contiguous, 16-byte aligned, with zero
    columns past K up to a multiple of 8. `int8_vocab_weights` is zero on
    those columns, so the sum is unchanged."""
    xb = x.to(torch.bfloat16)
    if x.shape[1] % 8:
        xb = F.pad(xb, (0, -x.shape[1] % 8))
    xb = xb.contiguous()
    if xb.data_ptr() % 16:  # a view off 16-byte alignment: TMA reads 16-byte rows
        xb = xb.clone()
    return xb


def int8_vocab_proj(
    x: torch.Tensor,      # [M, K]
    wq: torch.Tensor,     # [K, Vpad] int8
    scale: torch.Tensor,  # [1, Vpad] f32
    bias: torch.Tensor,   # [1, Vpad] f32
    n: int,
    wq_t: torch.Tensor | None = None,  # int8_vocab_weights(wq), else made here
) -> torch.Tensor:
    """Quantized logits [M, n] f32: one kernel launch for CUDA tensors, the
    plain version for CPU tensors."""
    if x.device.type == "cpu":
        return int8_vocab_plain(x, wq, scale, bias)[:, :n]
    m, k = x.shape
    vpad = wq.shape[1]
    if vpad % _BN or not 0 < n <= vpad:
        raise ValueError(
            f"int8_vocab kernel takes a padded width that is a multiple of {_BN} and >= n; "
            f"got width {vpad}, n {n}"
        )
    dev, f32 = x.device, torch.float32
    wq_t = int8_vocab_weights(wq) if wq_t is None else wq_t
    ldq = wq_t.shape[1]
    xb = x_operand(x)
    kx = xb.shape[1]
    out = torch.empty((m, n), dtype=f32, device=dev)
    if m == 0:
        return out
    ptrs = [
        build.check(xb, "x", (m, kx), torch.bfloat16, dev),
        build.check(wq_t, "wq_t", (vpad, -(-k // 64) * 64), torch.int8, dev),
        build.check(scale, "scale", (1, vpad), f32, dev),
        build.check(bias, "bias", (1, vpad), f32, dev),
        build.check(out, "out", (m, n), f32, dev),
    ]
    if ptrs[1] % 16:
        raise ValueError("int8_vocab kernel: wq_t must be 16-byte aligned")
    rc = build.launch(build.library().cxg_int8_vocab_fwd, dev, *ptrs, m, kx, n, vpad, ldq)
    build.raise_on_error(rc, "int8_vocab")
    int8_vocab_proj.launches += 1
    return out


int8_vocab_proj.launches = 0
