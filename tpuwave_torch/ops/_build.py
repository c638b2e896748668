"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled with ``nvcc -c`` (one process per source, all
started together), then the objects are linked into one shared library
with a plain C interface, at first use, into ``tpuwave_torch/_build/``
(git-ignored). The library's file name carries a hash of the sources, the
headers and the flags, so a stale build is never loaded. Nothing is built
or imported when this module is imported.
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

__all__ = ["COMPILE_FLAGS", "LINK_FLAGS", "build_library", "load_library"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_SOURCES = (_CSRC / "stencil_kernels.cu", _CSRC / "solver_kernels.cu",
            _CSRC / "fast_kernels.cu", _CSRC / "p2_kernels.cu",
            _CSRC / "varcoef_kernels.cu")
_HEADERS = (_CSRC / "grid_common.cuh",)
BUILD_DIR = _PKG / "_build"

_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v")
LINK_FLAGS = (*_ARCH, "-shared")

_VP, _I, _LL, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_double)
_DP = ctypes.POINTER(ctypes.c_double)
_IP = ctypes.POINTER(ctypes.c_int)

#: C signature of every entry point of the library
_SIGNATURES = {
    "tw_constrained_apply": (_I, _VP, _VP, _I, _I, _DP, _D, _I, _VP),
    "tw_constrained_apply_at": (_I, _VP, _VP, _I, _I, _DP, _D, _I, _I, _I,
                                _I, _I, _VP),
    "tw_leapfrog_step": (_I, _VP, _VP, _VP, _I, _I, _DP, _D, _VP),
    "tw_leapfrog_multistep": (_I, _VP, _VP, _VP, _VP, _VP, _I, _I, _DP, _D,
                              _I, _I, _LL, _LL, _VP),
    "tw_leapfrog_multistep_driven": (_I, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                                     _I, _I, _DP, _D, _I, _I, _VP),
    "tw_max_dynamic_smem": (_I,),
    "tw_noop": (_VP,),
    "tw_cheby_block": (_I, _VP, _VP, _VP, _VP, _VP, _I, _VP, _VP, _I, _I,
                       _DP, _D, _DP, _DP, _I, _I, _I, _VP),
    "tw_recurrence_r0": (_I, _VP, _VP, _VP, _VP, _VP, _I, _VP, _VP, _I, _I,
                         _DP, _D, _D, _I, _VP),
    "tw_recurrence_r0_blocks": (_I, _I),
    "tw_newmark_rhs_r0": (_I, _VP, _VP, _VP, _VP, _VP, _VP, _I, _VP, _I, _I,
                          _DP, _DP, _D, _D, _VP),
    "tw_newmark_update": (_I, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _D,
                          _D, _D, _VP),
    "tw_theta_r0u": (_I, _VP, _VP, _VP, _VP, _I, _VP, _VP, _I, _I, _I, _DP,
                     _DP, _D, _D, _D, _VP),
    "tw_theta_r0u_blocks": (_I, _I, _I),
    "tw_theta_r0v": (_I, _VP, _VP, _VP, _VP, _VP, _VP, _I, _VP, _I, _I, _DP,
                     _DP, _D, _D, _VP),
    "tw_fast_blocks": (_I, _I),
    "tw_p2_apply": (_I, _VP, _VP, _I, _I, _I, _I, _IP, _IP, _IP, _IP, _DP,
                    _I, _DP, _I, _VP),
    "tw_p2_apply_pattern": (_I, _VP, _VP, _I, _I, _I, _I, _DP, _DP, _I, _I,
                            _I, _I, _VP),
    "tw_p2_smooth": (_I, _I, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _DP,
                     _DP, _D, _DP, _DP, _I, _I, _I, _I, _I, _VP),
    "tw_varcoef_step": (_I, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _D, _VP),
    "tw_varcoef_multistep": (_I, _VP, _VP, _VP, _I, _VP, _I, _I, _I, _I, _I,
                             _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP, _VP,
                             _VP, _VP, _VP, _VP, _VP, _I, _I, _D, _VP),
    "tw_varcoef_adjoint_step": (_I, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                                _VP, _I, _I, _I, _D, _VP),
    "tw_varcoef_adjoint_step_band": (_I, _I, _I),
    "tw_varcoef_adjoint_multistep": (_I, _VP, _VP, _VP, _VP, _VP, _I, _VP,
                                     _VP, _VP, _I, _I, _I, _VP, _VP, _I, _I,
                                     _I, _I, _I, _VP, _VP, _VP, _VP, _VP, _VP,
                                     _VP, _I, _I, _D, _I, _VP),
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
    for src in (*_SOURCES, *_HEADERS):
        h.update(src.read_bytes())
    h.update(" ".join((*COMPILE_FLAGS, *LINK_FLAGS)).encode())
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
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _SOURCES]
    tmp = lib.with_name(f"{tag}.so.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        cmds = [[nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(_SOURCES, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for cmd in cmds]
        logs = ["".join(proc.communicate()) for proc in procs]
        for cmd, proc, log in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                   f"{' '.join(cmd)}\n{log}")
        link = [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                               f"{' '.join(link)}\n{logs[-1]}")
        os.replace(tmp, lib)
    finally:
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
    return lib, time.perf_counter() - t0, "\n".join(logs)


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
