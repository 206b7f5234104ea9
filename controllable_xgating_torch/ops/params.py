"""Parameter helpers shared by the `init_*` functions.

Distributions follow the JAX package's initialisers; the numbers differ
because a `torch.Generator` is not a `jax.random` key. Weights that must
equal the JAX package's come through `bridge.from_numpy` instead.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def param(t: torch.Tensor) -> nn.Parameter:
    """Inference-only parameter (training switches requires_grad on)."""
    return nn.Parameter(t, requires_grad=False)


def uniform_fan_in(gen: torch.Generator, shape: tuple[int, ...]) -> torch.Tensor:
    """U(-1/sqrt(shape[0]), 1/sqrt(shape[0])), the JAX package's `u(k, shape)`."""
    s = 1.0 / math.sqrt(shape[0])
    return torch.empty(shape).uniform_(-s, s, generator=gen)


def uniform(gen: torch.Generator, shape: tuple[int, ...], scale: float) -> torch.Tensor:
    return torch.empty(shape).uniform_(-scale, scale, generator=gen)


def normal(gen: torch.Generator, shape: tuple[int, ...], std: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen) * std
