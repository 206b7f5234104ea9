"""Weight-only int8 vocab projection (csrc/int8_vocab.cu) and its plain
PyTorch version.

Counterpart of the Pallas kernel of `experiments/int8_vocab_matmul.py`
(`_int8_matmul_pallas`), same contract:

    out = f32(bf16(x) @ bf16(wq)) * scale + bias     [M, n]

x is cast to bf16 whatever the compute policy, as the JAX function does;
int8 -> bf16 is exact, the products and sums are f32. `wq` [K, Vpad] int8
and `scale`, `bias` [1, Vpad] f32 carry the vocab padded to a multiple of
1024 (`experiments/int8_vocab_matmul.py`); the kernel reads the padded
rows, which keep every int8 row 16-byte aligned, and writes only the n
true columns.
"""

from __future__ import annotations

import torch

from controllable_xgating_torch.ops.kernels import build

_BK, _BN = 32, 128  # the kernel's stage depth and tile width


def int8_vocab_plain(x, wq, scale, bias) -> torch.Tensor:
    """Logits over the padded width [M, Vpad] f32."""
    bf16 = torch.bfloat16
    acc = torch.matmul(x.to(bf16).float(), wq.to(bf16).float())
    return acc * scale + bias


def int8_vocab_proj(
    x: torch.Tensor,      # [M, K]
    wq: torch.Tensor,     # [K, Vpad] int8
    scale: torch.Tensor,  # [1, Vpad] f32
    bias: torch.Tensor,   # [1, Vpad] f32
    n: int,
) -> torch.Tensor:
    """Quantized logits [M, n] f32: one kernel launch for CUDA tensors, the
    plain version for CPU tensors."""
    if x.device.type == "cpu":
        return int8_vocab_plain(x, wq, scale, bias)[:, :n]
    m, k = x.shape
    ldw = wq.shape[1]
    if k % _BK or ldw % _BN or not 0 < n <= ldw:
        raise ValueError(
            f"int8_vocab kernel takes K % {_BK} == 0 and a padded width that is a multiple of "
            f"{_BN} and >= n; got K {k}, width {ldw}, n {n}"
        )
    dev, f32 = x.device, torch.float32
    xb = x.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:  # a view off 16-byte alignment: the kernel loads 16 bytes
        xb = xb.clone()
    out = torch.empty((m, n), dtype=f32, device=dev)
    if m == 0:
        return out
    ptrs = [
        build.check(xb, "x", (m, k), torch.bfloat16, dev),
        build.check(wq, "wq", (k, ldw), torch.int8, dev),
        build.check(scale, "scale", (1, ldw), f32, dev),
        build.check(bias, "bias", (1, ldw), f32, dev),
        build.check(out, "out", (m, n), f32, dev),
    ]
    if ptrs[1] % 16:
        raise ValueError("int8_vocab kernel: wq must be 16-byte aligned")
    rc = build.library().cxg_int8_vocab_fwd(*ptrs, m, k, n, ldw, build.stream_ptr(dev))
    build.raise_on_error(rc, "int8_vocab")
    int8_vocab_proj.launches += 1
    return out


int8_vocab_proj.launches = 0
