"""Build and load the CUDA kernels under `csrc/`.

nvcc compiles every `csrc/*.cu` for `sm_90a`, one process per source, all
started together, and links the objects into one shared library with a
plain C interface, loaded through `ctypes` (no PyTorch headers, so a build
takes seconds). The build runs at first use, from the package's own
sources, into `build/kernels/` of the checkout that holds the package; the
library's name carries a hash of the sources and flags, so an edited
source never loads a stale build. nvcc's output,
`-Xptxas -v` register and shared-memory counts included, is kept in
`build.log` next to the library.

Nothing here runs at import: the CPU tests import every module, on
machines without nvcc.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional

import torch

from controllable_xgating_torch.utils import spans

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(PKG_DIR, "csrc")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_LIB: Optional[ctypes.CDLL] = None
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def build_dir() -> str:
    return os.path.join(os.path.dirname(PKG_DIR), "build", "kernels")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _sources() -> tuple[list[str], str]:
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return srcs, h.hexdigest()[:12]


def library_path() -> str:
    return os.path.join(build_dir(), f"libcxg_kernels_{_sources()[1]}.so")


def build() -> str:
    """Compile the library unless this exact build exists. Returns its path."""
    srcs, _ = _sources()
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(build_dir(), exist_ok=True)
    tmpdir = tempfile.mkdtemp(dir=build_dir())
    try:
        objs = [os.path.join(tmpdir, os.path.basename(src) + ".o") for src in srcs]
        cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, src] for src, obj in zip(srcs, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        logs = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in zip(cmds, procs)]
        tmp = os.path.join(tmpdir, "lib.so")
        if all(rc == 0 for _, _, rc in logs):
            cmd = [_nvcc(), "-shared", "-o", tmp, *objs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            logs.append((cmd, proc.stdout + proc.stderr, proc.returncode))
        with open(os.path.join(build_dir(), "build.log"), "w") as f:
            for cmd, text, _ in logs:
                f.write(" ".join(cmd) + "\n" + text)
        failed = [(cmd, text, rc) for cmd, text, rc in logs if rc != 0]
        if failed:
            cmd, text, rc = failed[0]
            raise RuntimeError(f"nvcc failed ({rc}) on {cmd[-1]}:\n{text[-4000:]}")
        os.replace(tmp, out)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return out


_SIGNATURES = {
    "cxg_xgate_fwd": [_I] + [_P] * 13 + [_I] * 4 + [_P],
    "cxg_xgate_chain_fwd": [_P] * 16 + [_I] * 4 + [_P],
    "cxg_pos_lstm_fwd": [_P] * 9 + [_I] * 3 + [_P],
    "cxg_pos_lstm_bf16_plan": [_P] * 5 + [_I] * 3,
    "cxg_pos_lstm_bf16_fwd": [_P, _I] + [_P] * 5 + [_I] * 3 + [_P],
    "cxg_pos_lstm_maps_bytes": [],
    "cxg_attn_lstm_fwd": [_P] * 21 + [_I] * 6 + [_P],
    "cxg_attn_lstm_bf16_fwd": [_P] * 18 + [_I] * 7 + [_P],
    "cxg_topk_tail_fwd": [_I] + [_P] * 10 + [_I] * 6 + [_P],
    "cxg_topk_tail_beam": [_I] + [_P] * 7 + [_I] * 6 + [_P] * 4 + [_I] + [_P] * 7 + [_I] * 2
                          + [_F, _P],
    "cxg_xent_fwd": [_P] * 5 + [_I] * 2 + [_P],
    "cxg_xent_bwd": [_P] * 7 + [_I] * 2 + [_P],
    "cxg_int8_vocab_fwd": [_P] * 5 + [_I] * 5 + [_P],
    "cxg_topk_extract_fwd": [_I] + [_P] * 10 + [_I] * 5 + [_P],
    "cxg_xgate_smem_bytes": [_I],
    "cxg_attn_smem_bytes": [_I] * 3,
    "cxg_attn_bf16_smem_bytes": [_I] * 3,
    "cxg_topk_wgmma_smem_bytes": [_I],
    "cxg_topk_extract_smem_bytes": [_I],
}


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        with spans.span("setup.library"):
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_long if name.endswith("_bytes") else ctypes.c_int
        _LIB = lib
    return _LIB


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"kernel operands must be float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]


def check(t: torch.Tensor, name: str, shape: tuple, dtype: torch.dtype, device) -> int:
    """Raise unless t is a contiguous CUDA tensor of this shape, dtype and
    device; return its data pointer."""
    if t.device == device and t.dtype == dtype and t.shape == shape and t.is_contiguous():
        return t.data_ptr()  # the common case, in one test (the wrappers' host time)
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    return t.data_ptr()


def smem_limit(device) -> int:
    """Dynamic shared memory one block may opt in to (227 KB on Hopper)."""
    props = torch.cuda.get_device_properties(device)
    return int(getattr(props, "shared_memory_per_block_optin", 232448))


def launch(fn, device, *args) -> int:
    """`fn(*args, stream)` with `device` current and its current stream
    last (the error code): the kernels raise their shared memory limits
    on, and launch into, the current device, whichever card the caller
    left current. Under `torch.profiler` the call is a user annotation
    named after the entry point (`cxg_xgate_chain_fwd`, ...): one per
    wrapper launch, beside the device kernels it starts."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if spans.profiling():
            with torch.profiler.record_function(fn.__name__):
                return fn(*args, stream)
        return fn(*args, stream)


def raise_on_error(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA kernel launch failed with cudaError_t {rc}")
