#!/usr/bin/env python3
"""Kernel B3 (constrained_stencil_apply, the CG matvec) of two checkouts,
timed in alternating pairs in one process on one CUDA card.

Builds tpuwave_torch/csrc/stencil_kernels.cu of each checkout alone into
its git-ignored tpuwave_torch/_build/, loads both libraries, and for each
shape of the V-cycle's levels runs PAIRS rounds; a round times A and B
(alternating which goes first) by chip_smoke.cuda_ms, the median of calls
each timed alone after an L2 flush, as phase 3 does. Both read the same
random field (f64 and f32, the plain form that every caller uses) and
must agree bitwise. Prints per shape the median over the rounds of each,
their range, and in how many rounds B was faster. Needs nvcc and one card:

    python3 scripts/torch_b3_ab.py DIR_A DIR_B [--pairs 12]
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: (H, W) of the V-cycle's levels under 2049^2 and phase 19's 161^2 grid
SHAPES = ((9, 9), (17, 17), (33, 33), (65, 65), (129, 129), (161, 161),
          (257, 257), (641, 641))
STENCIL = (-0.11, -0.23, -0.07, -0.19, 1.31, -0.17, -0.05, -0.29, -0.13)


def build(tree: Path) -> ctypes.CDLL:
    """stencil_kernels.cu of ``tree`` alone, as one shared library."""
    from tpuwave_torch.ops import _build
    src = tree / "tpuwave_torch" / "csrc" / "stencil_kernels.cu"
    out = tree / "tpuwave_torch" / "_build" / "b3_ab.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.COMPILE_FLAGS, "-shared", "-o",
                    str(out), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    v, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.tw_constrained_apply.argtypes = [i, v, v, i, i,
                                         ctypes.POINTER(d), d, i, v]
    lib.tw_constrained_apply.restype = i
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a", type=Path)
    ap.add_argument("b", type=Path)
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--calls", type=int, default=100)
    args = ap.parse_args()
    import numpy as np
    import torch
    from chip_smoke import cuda_ms, nvidia_smi_line

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    print(nvidia_smi_line(), flush=True)
    libs = {"A": build(args.a.resolve()), "B": build(args.b.resolve())}
    print(f"A = {args.a}, B = {args.b}; {args.pairs} rounds of "
          f"{args.calls} calls each", flush=True)
    st = (ctypes.c_double * 9)(*STENCIL)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    rng = np.random.default_rng(3)
    for dtype, code in ((torch.float64, 1), (torch.float32, 0)):
        for h, w in SHAPES:
            x = torch.tensor(rng.uniform(-1.0, 1.0, (h, w)), dtype=dtype,
                             device="cuda")
            outs = {k: torch.empty_like(x) for k in libs}

            def call(k):
                rc = libs[k].tw_constrained_apply(
                    code, x.data_ptr(), outs[k].data_ptr(), h, w, st, 1.7,
                    0, stream)
                if rc != 0:
                    raise RuntimeError(f"{k}: cudaError {rc}")
            times = {"A": [], "B": []}
            for r in range(args.pairs):
                for k in ("AB" if r % 2 == 0 else "BA"):
                    times[k].append(cuda_ms(lambda k=k: call(k),
                                            args.calls) * 1e3)
            if not torch.equal(outs["A"], outs["B"]):
                raise AssertionError(f"{h}x{w} {dtype}: A and B differ")
            ta, tb = times["A"], times["B"]
            wins = sum(b < a for a, b in zip(ta, tb))
            print(f"{h}x{w} {str(dtype)[6:]}: A median {statistics.median(ta):.2f} "
                  f"us (range {min(ta):.2f}-{max(ta):.2f}), B median "
                  f"{statistics.median(tb):.2f} us (range {min(tb):.2f}-"
                  f"{max(tb):.2f}); B faster in {wins} of {args.pairs} rounds",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
