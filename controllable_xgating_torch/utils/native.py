"""ctypes bindings for the native host runtime (`native/cxg_native.cpp`,
`native/cxg_text.cpp`): PTB tokenization, the Porter stem, METEOR (with
an optional synonym table), ROUGE-L, and the CIDEr-D df table and scorer
over token ids.

Counterpart of `controllable_xgating_tpu/utils/native.py`, with the same
entry points and signatures. The library is the port's own build of the
two sources in `native/`, made at first use with the host C++ compiler
(`compiler`: g++ or c++ on PATH) and `native/Makefile`'s flags into
`build/native/` of the checkout; `native/` itself is never written. The
library's name carries a hash of the sources and flags, so an edited
source is rebuilt and never loaded stale. A build compiles to a temporary
file and renames it into place under a file lock, so processes that start
at once (test workers, ranks) build it once and never load a half-written
file.

Every entry point returns None where the library cannot be built or
loaded (no compiler, a failed build), and the callers take their
pure-Python paths, the golden references (tests/test_torch_native.py
holds the two equal); the reason is logged once.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional, Sequence

import numpy as np

from controllable_xgating_torch.utils.logging import get_logger

log = get_logger("cxg.native")

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCES = tuple(os.path.join(ROOT, "native", f) for f in ("cxg_native.cpp", "cxg_text.cpp"))
CXXFLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-shared"]  # native/Makefile's

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_i64 = ctypes.c_int64
_f32 = ctypes.c_float
_p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_p_u32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")


def compiler() -> Optional[str]:
    """The host C++ compiler: g++ on PATH, else c++, else `$CXX`; None if
    there is none. PATH's compiler comes first because a `$CXX` wrapper
    may link libstdc++ statically: the library then holds a second copy of
    it beside the shared one numpy and torch load, and the tokenizer's
    std::regex crashes on its first call."""
    for name in ("g++", "c++", os.environ.get("CXX")):
        found = name and shutil.which(name)
        if found:
            return found
    return None


def build_dir() -> str:
    return os.path.join(ROOT, "build", "native")


def library_path() -> str:
    h = hashlib.sha1(" ".join(CXXFLAGS).encode())
    for path in SOURCES:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return os.path.join(build_dir(), f"libcxg_native_{h.hexdigest()[:12]}.so")


def build() -> str:
    """Compile the library unless this exact build exists; returns its
    path. Raises where there is no compiler or the compile fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler on PATH (install g++, or set CXX)")
    os.makedirs(build_dir(), exist_ok=True)
    with open(os.path.join(build_dir(), ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one builder; the others wait, then load its file
        if os.path.exists(out):
            return out
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir())
        os.close(fd)
        try:
            proc = subprocess.run([cxx, *CXXFLAGS, "-o", tmp, *SOURCES],
                                  capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"{cxx} failed ({proc.returncode}): {proc.stderr[-2000:]}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        lib = ctypes.CDLL(build())
    except Exception as e:  # no compiler, a failed build or load
        log.info("native library unavailable (%s); using the Python paths", e)
        return None
    lib.cxg_build_df.restype = _i64
    lib.cxg_build_df.argtypes = [
        _p_i32, _p_i32, _i64, _i64, _i64, _p_i64, _i64,
        _p_u32, _p_u32, _p_f32, _i64,
    ]
    lib.cxg_cider_d.restype = None
    lib.cxg_cider_d.argtypes = [
        _p_i32, _i64, _i64, _p_i32,
        _p_i32, _p_i32, _i64, _i64, _i64,
        _p_u32, _p_u32, _p_f32, _i64, _f32, _p_f32,
    ]
    lib.cxg_ptb_tokenize.restype = _i64
    lib.cxg_ptb_tokenize.argtypes = [ctypes.c_char_p, ctypes.c_char_p, _i64]
    lib.cxg_porter_stem.restype = _i64
    lib.cxg_porter_stem.argtypes = [ctypes.c_char_p, ctypes.c_char_p, _i64]
    lib.cxg_meteor.restype = ctypes.c_double
    lib.cxg_meteor.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.cxg_meteor_syn.restype = ctypes.c_double
    lib.cxg_meteor_syn.argtypes = [ctypes.c_char_p, ctypes.c_char_p, _i64]
    lib.cxg_syn_table_new.restype = _i64
    lib.cxg_syn_table_new.argtypes = [ctypes.c_char_p]
    lib.cxg_syn_table_free.restype = None
    lib.cxg_syn_table_free.argtypes = [_i64]
    lib.cxg_rouge_l.restype = ctypes.c_double
    lib.cxg_rouge_l.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_double]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def build_df(
    caps: np.ndarray, ncaps: np.ndarray, df_video_indices: Sequence[int]
) -> Optional[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Sorted (h1, h2, df) arrays, or None if the native lib is absent."""
    lib = _load()
    if lib is None:
        return None
    caps = np.ascontiguousarray(caps, np.int32)
    ncaps = np.ascontiguousarray(ncaps, np.int32)
    idx = np.ascontiguousarray(df_video_indices, np.int64)
    n, s, l = caps.shape
    cap = max(int(ncaps.sum()) * l * 4 + 16, 1024)
    h1 = np.empty(cap, np.uint32)
    h2 = np.empty(cap, np.uint32)
    df = np.empty(cap, np.float32)
    count = lib.cxg_build_df(caps, ncaps, n, s, l, idx, len(idx), h1, h2, df, cap)
    if count < 0:
        raise RuntimeError(f"cxg_build_df failed: {count}")
    return h1[:count].copy(), h2[:count].copy(), df[:count].copy()


def cider_d(
    cand: np.ndarray,
    video_indices: np.ndarray,
    caps: np.ndarray,
    ncaps: np.ndarray,
    h1: np.ndarray,
    h2: np.ndarray,
    df: np.ndarray,
    log_n: float,
) -> Optional[np.ndarray]:
    """Batch CIDEr-D on token ids, or None if the native lib is absent."""
    lib = _load()
    if lib is None:
        return None
    cand = np.ascontiguousarray(cand, np.int32)
    caps = np.ascontiguousarray(caps, np.int32)
    ncaps = np.ascontiguousarray(ncaps, np.int32)
    vidx = np.ascontiguousarray(video_indices, np.int32)
    h1 = np.ascontiguousarray(h1, np.uint32)
    h2 = np.ascontiguousarray(h2, np.uint32)
    df = np.ascontiguousarray(df, np.float32)
    b, lc = cand.shape
    n, s, l = caps.shape
    out = np.empty(b, np.float32)
    lib.cxg_cider_d(
        cand, b, lc, vidx, caps, ncaps, n, s, l,
        h1, h2, df, len(h1), float(log_n), out,
    )
    return out


_REF_SEP = b"\x1e"


def ptb_tokenize(text: str) -> Optional[list[str]]:
    lib = _load()
    if lib is None:
        return None
    buf = ctypes.create_string_buffer(4 * len(text.encode()) + 64)
    n = lib.cxg_ptb_tokenize(text.encode(), buf, len(buf))
    if n < 0:
        raise RuntimeError("cxg_ptb_tokenize overflow")
    s = buf.value.decode()
    return s.split(" ") if s else []


def porter_stem(word: str) -> Optional[str]:
    lib = _load()
    if lib is None:
        return None
    buf = ctypes.create_string_buffer(2 * len(word.encode()) + 16)
    n = lib.cxg_porter_stem(word.encode(), buf, len(buf))
    if n < 0:
        raise RuntimeError("cxg_porter_stem overflow")
    return buf.value.decode()


def meteor(
    hyp: str, refs: Sequence[str], syn_handle: int = 0
) -> Optional[float]:
    lib = _load()
    if lib is None:
        return None
    joined = _REF_SEP.join(r.encode() for r in refs)
    if syn_handle:
        return float(lib.cxg_meteor_syn(hyp.encode(), joined, syn_handle))
    return float(lib.cxg_meteor(hyp.encode(), joined))


def syn_table_new(groups: Sequence[Sequence[str]]) -> int:
    """Register a METEOR synonym table (synset groups) with the native
    lib; returns a handle for meteor(syn_handle=...), or -1 when the
    library is absent (the caller falls back to Python)."""
    lib = _load()
    if lib is None:
        return -1
    serialized = "\n".join(" ".join(g) for g in groups)
    return int(lib.cxg_syn_table_new(serialized.encode()))


def syn_table_free(handle: int) -> None:
    lib = _load()
    if lib is not None and handle > 0:
        lib.cxg_syn_table_free(handle)


def rouge_l(hyp: str, refs: Sequence[str], beta: float = 1.2) -> Optional[float]:
    lib = _load()
    if lib is None:
        return None
    return float(
        lib.cxg_rouge_l(
            hyp.encode(), _REF_SEP.join(r.encode() for r in refs), beta
        )
    )
