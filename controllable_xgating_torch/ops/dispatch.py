"""Kernel dispatch: plain PyTorch path vs the hand-written kernels.

Counterpart of `controllable_xgating_tpu/ops/dispatch.py`. Resolution
order: explicit call-site override > process-global setting > auto.

Auto turns the kernel path on everywhere, because the choice of device is
made one level down: each kernel wrapper (`ops/kernels/*.py`) launches its
CUDA kernel for a CUDA tensor and runs its plain PyTorch version for a CPU
tensor. `set_fused_kernels(False)` forces the model-level plain path on
every device, which is how a run on the card gets its reference.
"""

from __future__ import annotations

from typing import Optional

_STATE: dict[str, Optional[bool]] = {"fused": None}  # None = auto


def set_fused_kernels(on: Optional[bool]) -> None:
    """True/False force; None restores auto (kernel wrappers everywhere)."""
    _STATE["fused"] = on


def fused_enabled(override: Optional[bool] = None) -> bool:
    if override is not None:
        return override
    if _STATE["fused"] is not None:
        return _STATE["fused"]
    return True
