"""Debug utilities: NaN localisation (`--debug_nans`) and the fast-vs-plain
divergence probe.

Counterpart of `controllable_xgating_tpu/utils/debug.py`. JAX's
`jax_debug_nans` re-runs a jitted function op by op on a NaN and raises
at the primitive that produced it; `jit_eager_diff` holds compiled
against eager. The port's counterparts:

  * `enable_nan_checks(on)`: every operator's result is checked as it is
    made (a `TorchDispatchMode` on the thread that enables it; the port's
    `nn.Module`s hold parameters and have no forward, so a forward hook
    would see nothing), and each hand-kernel wrapper's outputs
    (`ops/kernels/*.py`, `nan_guard`), since a kernel launched through
    ctypes is no operator. The first NaN raises `FloatingPointError`
    naming the operator, the port's function and line that called it and,
    inside a wrapper, the kernel (K1-K7). The backward runs under
    `torch.autograd.set_detect_anomaly(True, check_nan=True)`, which also
    covers K5's `autograd.Function` and the gradients `train/xe.py` takes
    with `autograd.grad`. The decode loops run eager
    (`ops/dispatch.py::set_decode_graphs(False)`, and `infer/graphs.py`
    never captures while the checks are on): a replayed CUDA graph cannot
    stop at an operation. The checks read every result back to the host,
    so they slow a run down; they never change a value. Only NaN raises,
    as in JAX: -inf is how the decoders mask tokens. `enable_nan_checks(False)`
    restores every setting it changed.
  * `kernel_plain_diff(fn, *args)`: `fn` on the fast path (the kernels,
    the decode graphs on the card) against the plain eager path
    (`set_fused_kernels(False)`, `set_decode_graphs(False)`).
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys
from typing import Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from controllable_xgating_torch.ops import dispatch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# operators whose results hold memory nothing has written yet
_UNWRITTEN = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
              "resize_", "set_"}
_STATE: dict = {"mode": None, "saved": None, "kernels": []}


def _caller(depth: int = 3) -> str:
    """`file:line in function` of the innermost port frame of each of the
    `depth` innermost modules of the port's package on the stack (this
    one left out), innermost first; '' when none is on it."""
    frames, seen, f = [], {__file__}, sys._getframe(1)
    while f is not None and len(frames) < depth:
        path = f.f_code.co_filename
        if path.startswith(_PKG) and path not in seen:
            seen.add(path)
            rel = os.path.relpath(path, os.path.dirname(_PKG))
            frames.append(f"{rel}:{f.f_lineno} in {f.f_code.co_name}")
        f = f.f_back
    return " <- ".join(frames)


def _has_nan(out) -> bool:
    leaves, _ = tree_flatten(out)
    return any(isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel()
               and bool(torch.isnan(t).any()) for t in leaves)


def _raise(what: str) -> None:
    where = _caller()
    inside = f", inside kernel {_STATE['kernels'][-1]}" if _STATE["kernels"] else ""
    raise FloatingPointError(f"NaN produced by {what}{' at ' + where if where else ''}{inside}")


class _NanCheck(TorchDispatchMode):
    """Raise at the first operator whose floating-point result holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func.overloadpacket.__name__ not in _UNWRITTEN and _has_nan(out):
            _raise(f"operator {func}")
        return out


def enable_nan_checks(on: bool = True) -> None:
    """Turn the NaN checks on or off (see the module docstring); turning
    them off restores the anomaly mode and the decode-graph setting they
    found."""
    if on and _STATE["mode"] is None:
        _STATE["saved"] = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled(),
                           dispatch.decode_graphs_setting())
        torch.autograd.set_detect_anomaly(True, check_nan=True)
        dispatch.set_decode_graphs(False)
        dispatch.set_nan_checks(True)
        _STATE["mode"] = _NanCheck()
        _STATE["mode"].__enter__()
    elif not on and _STATE["mode"] is not None:
        _STATE["mode"].__exit__(None, None, None)
        _STATE["mode"] = None
        anomaly, check_nan, graphs = _STATE["saved"]
        torch.autograd.set_detect_anomaly(anomaly, check_nan=check_nan)
        dispatch.set_decode_graphs(graphs)
        dispatch.set_nan_checks(False)


@contextlib.contextmanager
def nan_checks(on: bool = True):
    """`enable_nan_checks(True)` for the enclosed span where `on` and the
    checks are off; turned off again at its end."""
    turn = on and not dispatch.nan_checks_enabled()
    if turn:
        enable_nan_checks(True)
    try:
        yield
    finally:
        if turn:
            enable_nan_checks(False)


def nan_guard(kernel: str):
    """Decorator for a hand-kernel wrapper: with the checks on, a NaN in
    its outputs raises naming `kernel`, and so does one made by an
    operator of its plain version."""

    def wrap(fn):
        @functools.wraps(fn)
        def guarded(*args, **kwargs):
            if not dispatch.nan_checks_enabled():
                return fn(*args, **kwargs)
            _STATE["kernels"].append(kernel)
            try:
                out = fn(*args, **kwargs)
            finally:
                _STATE["kernels"].pop()
            if _has_nan(out):
                _raise(f"kernel {kernel}")
            return out

        return guarded

    return wrap


def _leaves(out) -> list:
    leaves, _ = tree_flatten(out)
    return [(t.detach().float() if t.is_floating_point() else t.detach()).cpu().numpy()
            if isinstance(t, torch.Tensor) else t for t in leaves]


def kernel_plain_diff(fn: Callable, *args, rtol: float = 1e-4, atol: float = 1e-5) -> dict:
    """Run `fn(*args)` through the kernels and the decode graphs (both
    switches at auto), then on the plain eager path; return the largest
    absolute difference of each output leaf (0 for exact leaves).

    Raises AssertionError where a floating-point leaf differs beyond the
    tolerance or any other leaf differs. Both switches are restored. `fn`
    must build inside itself whatever reads the switches when it is made
    (the caption factories do)."""
    saved = (dispatch.fused_setting(), dispatch.decode_graphs_setting())
    try:
        dispatch.set_fused_kernels(None)
        dispatch.set_decode_graphs(None)
        fast = _leaves(fn(*args))
        dispatch.set_fused_kernels(False)
        dispatch.set_decode_graphs(False)
        plain = _leaves(fn(*args))
    finally:
        dispatch.set_fused_kernels(saved[0])
        dispatch.set_decode_graphs(saved[1])
    if len(fast) != len(plain):
        raise AssertionError(f"{len(fast)} outputs on the fast path, {len(plain)} on the plain")
    diffs: dict[int, float] = {}
    for i, (f, p) in enumerate(zip(fast, plain)):
        if isinstance(f, np.ndarray) and np.issubdtype(f.dtype, np.floating):
            diffs[i] = float(np.max(np.abs(f - p))) if f.size else 0.0
            np.testing.assert_allclose(f, p, rtol=rtol, atol=atol, err_msg=f"output {i}")
        elif isinstance(f, np.ndarray):
            np.testing.assert_array_equal(f, p, err_msg=f"output {i}")
            diffs[i] = 0.0
        else:
            if f != p:
                raise AssertionError(f"output {i}: {f!r} != {p!r}")
            diffs[i] = 0.0
    return diffs

