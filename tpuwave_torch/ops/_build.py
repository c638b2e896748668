"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` into a shared library with a plain
C interface, at first use, into ``tpuwave_torch/_build/`` (git-ignored).
The library's file name carries a hash of the sources and the flags, so a
stale build is never loaded. Nothing is built or imported when this module
is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build_library", "load_library"]

_PKG = Path(__file__).resolve().parent.parent
_SOURCES = (_PKG / "csrc" / "stencil_kernels.cu",)
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VP, _I, _LL, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_double)
_DP = ctypes.POINTER(ctypes.c_double)

#: C signature of every entry point of the library
_SIGNATURES = {
    "tw_constrained_apply": (_I, _VP, _VP, _I, _I, _DP, _D, _I, _VP),
    "tw_leapfrog_step": (_I, _VP, _VP, _VP, _I, _I, _DP, _D, _VP),
    "tw_leapfrog_multistep": (_I, _VP, _VP, _VP, _VP, _I, _I, _DP, _D, _I,
                              _I, _LL, _LL, _VP),
    "tw_max_dynamic_smem": (_I,),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels of tpuwave_torch are built from source on "
                       "a machine with the CUDA toolkit")


def _library_path() -> Path:
    h = hashlib.sha256()
    for src in _SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libtpuwave_torch_kernels_{h.hexdigest()[:16]}.so"


def build_library() -> tuple:
    """Compile the sources if the keyed library is missing.

    Returns ``(path, seconds, log)``: the library, the build time (0.0 when
    it was already built) and nvcc's output (register and spill report of
    ``-Xptxas -v``). Raises with nvcc's output when the build fails.
    """
    lib = _library_path()
    if lib.exists():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, secs, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with ctypes
    signatures declared for every entry point."""
    path, _, _ = build_library()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
