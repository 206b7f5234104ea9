"""Dropout keep-masks for training, from an explicit `torch.Generator`.

`jax.random.bernoulli(key, p, shape)` is `uniform(key, shape) < p`; the
port draws the same form from a generator on the tensors' device. The
bits differ from JAX's (a generator is not a key), so the parity tests
replace `keep_mask` with JAX's masks and compare the arithmetic around it.
Callers look it up as `dropout.keep_mask` for that reason.
"""

from __future__ import annotations

import torch


def keep_mask(gen: torch.Generator, shape: tuple, rate: float, device) -> torch.Tensor:
    """bool [shape], True with probability 1 - rate."""
    return torch.rand(shape, generator=gen, device=device) < (1.0 - rate)
