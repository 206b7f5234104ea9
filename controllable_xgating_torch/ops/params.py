"""Parameter helpers shared by the `init_*` functions.

Distributions follow the JAX package's initialisers; the numbers differ
because a `torch.Generator` is not a `jax.random` key. Weights that must
equal the JAX package's come through `bridge.from_numpy` instead. Without
a generator (`gen=None`) each helper returns uninitialised storage of the
shape, for a checkpoint to fill: no numbers are drawn.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


def param(t: torch.Tensor) -> nn.Parameter:
    """Inference-only parameter (training switches requires_grad on)."""
    return nn.Parameter(t, requires_grad=False)


def uniform_fan_in(gen: Optional[torch.Generator], shape: tuple[int, ...]) -> torch.Tensor:
    """U(-1/sqrt(shape[0]), 1/sqrt(shape[0])), the JAX package's `u(k, shape)`."""
    return uniform(gen, shape, 1.0 / math.sqrt(shape[0]))


def uniform(gen: Optional[torch.Generator], shape: tuple[int, ...], scale: float) -> torch.Tensor:
    t = torch.empty(shape)
    return t if gen is None else t.uniform_(-scale, scale, generator=gen)


def normal(gen: Optional[torch.Generator], shape: tuple[int, ...], std: float) -> torch.Tensor:
    return torch.empty(shape) if gen is None else torch.randn(shape, generator=gen) * std
