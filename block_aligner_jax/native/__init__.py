"""Native (C++) runtime components, loaded via ctypes.

Every library builds on demand into ``build/`` (git-ignored) from the
sources beside this file.  The walker and exact-DP libraries have
pure-Python fallbacks, so a missing compiler only costs speed; the CUDA
fixed-block kernel and its host twin have none, and a failed build
raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

_DIR = Path(__file__).resolve().parent
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_EXACT: Optional[ctypes.CDLL] = None
_EXACT_TRIED = False


BUILD_DIR = _DIR / "build"


def _build(lib: str, sources, cmd) -> Path:
    """Build ``build/<lib>`` with ``cmd + [-o <tmp>]`` unless it is newer
    than every source, then move it into place (concurrent builders each
    write their own temporary, so a reader never sees a half-written
    library).  Raises RuntimeError with the compiler's output on failure."""
    out = BUILD_DIR / lib
    srcs = [_DIR / s for s in sources]
    if out.exists() and all(out.stat().st_mtime >= s.stat().st_mtime for s in srcs):
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        p = subprocess.run(cmd + ["-o", str(tmp)], capture_output=True,
                           text=True, timeout=900)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise RuntimeError(f"building {lib} failed: {exc}") from exc
    if p.returncode != 0:
        raise RuntimeError(f"building {lib} failed:\n{p.stdout}{p.stderr}")
    os.replace(tmp, out)
    return out


def _load_host_lib(src: str, lib: str) -> Optional[ctypes.CDLL]:
    """g++ build + load of a host library that has a Python fallback:
    None when the toolchain is missing or the build fails."""
    try:
        so = _build(lib, (src,), ["g++", "-O3", "-shared", "-fPIC",
                                  "-std=c++17", str(_DIR / src)])
        return ctypes.CDLL(str(so))
    except (RuntimeError, OSError):
        return None


FIXED_SOURCES = ("fixed_block.cuh",)


def build_fixed_host() -> Path:
    """g++ build of the fixed-block walk with an emulated lane group (the
    CPU tests' view of the CUDA kernel's source)."""
    src = _DIR / "fixed_block_host.cpp"
    return _build("libbafixedhost.so", FIXED_SOURCES + (src.name,),
                  ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", str(src)])


def build_fixed_cuda() -> Path:
    """nvcc build of the CUDA fixed-block kernel for Hopper (sm_90a)."""
    import jax.ffi

    src = _DIR / "fixed_block.cu"
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return _build("libbafixed.so", FIXED_SOURCES + (src.name,),
                  [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-I", jax.ffi.include_dir(), str(src)])


def load_exact() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native exact-DP oracle library."""
    global _EXACT, _EXACT_TRIED
    with _LOCK:
        if _EXACT is not None or _EXACT_TRIED:
            return _EXACT
        _EXACT_TRIED = True
        lib = _load_host_lib("exact.cpp", "libbaexact.so")
        if lib is None:
            return None
        i64, i32, p = ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p
        lib.ba_global_score.restype = i64
        lib.ba_global_score.argtypes = [p, i64, p, i64, p, i64, i32, i32]
        lib.ba_xdrop_score.restype = None
        lib.ba_xdrop_score.argtypes = [p, i64, p, i64, p, i64, i32, i32, i32,
                                       p, p, p]
        lib.ba_global_profile_score.restype = i64
        lib.ba_global_profile_score.argtypes = [p, i64, p, i64, p, p, p, i32]
        _EXACT = lib
        return _EXACT


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native walker; None if unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        lib = _load_host_lib("walker.cpp", "libbawalker.so")
        if lib is None:
            return None
        lib.ba_trace_cigar.restype = ctypes.c_int64
        lib.ba_trace_cigar.argtypes = [
            ctypes.c_void_p,  # trace_t (B,T,H) int8, pair-major
            ctypes.c_void_p,  # meta_t (B,T,2) int32, pair-major
            ctypes.c_int64,  # T
            ctypes.c_int64,  # B
            ctypes.c_int64,  # H
            ctypes.c_int64,  # iters
            ctypes.c_int64,  # b
            ctypes.c_int64,  # i
            ctypes.c_int64,  # j
            ctypes.c_int32,  # local_start
            ctypes.c_int32,  # free_query_start_gaps
            ctypes.c_int32,  # eq
            ctypes.c_void_p,  # qcodes (uint8, 1-based) or None
            ctypes.c_void_p,  # rcodes
            ctypes.c_void_p,  # out_ops int32*
            ctypes.c_int64,  # out_cap
        ]
        _LIB = lib
        return _LIB
