"""Kernel dispatch: plain PyTorch path vs the hand-written kernels.

Counterpart of `controllable_xgating_tpu/ops/dispatch.py`. Resolution
order: explicit call-site override > process-global setting > auto.

Auto turns the kernel path on everywhere, because the choice of device is
made one level down: each kernel wrapper (`ops/kernels/*.py`) launches its
CUDA kernel for a CUDA tensor and runs its plain PyTorch version for a CPU
tensor. `set_fused_kernels(False)` forces the model-level plain path on
every device, which is how a run on the card gets its reference.

`set_decode_graphs` is the same switch for the decode loops' execution
(`infer/graphs.py`): auto replays captured CUDA graphs for CUDA tensors
and steps the eager loop for CPU tensors; False steps the eager loop on
the card too, which is what the graphed loop is held against. The two
switches are orthogonal: graphs capture the kernel path and the plain
path alike.
"""

from __future__ import annotations

from typing import Optional

_STATE: dict[str, Optional[bool]] = {"fused": None, "graphs": None}  # None = auto


def set_fused_kernels(on: Optional[bool]) -> None:
    """True/False force; None restores auto (kernel wrappers everywhere)."""
    _STATE["fused"] = on


def fused_enabled(override: Optional[bool] = None) -> bool:
    if override is not None:
        return override
    if _STATE["fused"] is not None:
        return _STATE["fused"]
    return True


def set_decode_graphs(on: Optional[bool]) -> None:
    """True/False force; None restores auto (graphs for CUDA tensors)."""
    _STATE["graphs"] = on


def decode_graphs_setting(override: Optional[bool] = None) -> Optional[bool]:
    """The decode loops' graph setting: the call site's override, else the
    process-global one; None is auto (`infer/graphs.py::resolve_mode`
    decides from the device)."""
    return override if override is not None else _STATE["graphs"]
