"""Dropout keep-masks for training, from an explicit `torch.Generator`.

`jax.random.bernoulli(key, p, shape)` is `uniform(key, shape) < p`; the
port draws the same form from a generator on the tensors' device. The
bits differ from JAX's (a generator is not a key), so the parity tests
replace `keep_mask` with JAX's masks and compare the arithmetic around it.
Callers look it up as `dropout.keep_mask` for that reason.

Under data parallelism a rank holds one block of the global batch's rows
(`shard` = (rank, ranks)). `keep_rows` draws the global batch's mask and
keeps the rank's block, so every row gets the mask the one-device step
gives it, and every rank's generator advances alike.
"""

from __future__ import annotations

import torch


def keep_mask(gen: torch.Generator, shape: tuple, rate: float, device) -> torch.Tensor:
    """bool [shape], True with probability 1 - rate."""
    return torch.rand(shape, generator=gen, device=device) < (1.0 - rate)


def keep_rows(gen: torch.Generator, shape: tuple, rate: float, device, batch_dim: int = 0,
              shard: tuple = (0, 1)) -> torch.Tensor:
    """`keep_mask` of `shape`, whose `batch_dim` holds block `shard[0]` of
    `shard[1]` equal blocks of the global batch's rows: the global mask is
    drawn and the block kept."""
    index, count = shard
    if count == 1:
        return keep_mask(gen, shape, rate, device)
    full = list(shape)
    full[batch_dim] *= count
    n = shape[batch_dim]
    return keep_mask(gen, tuple(full), rate, device).narrow(batch_dim, index * n, n)
