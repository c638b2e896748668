#!/usr/bin/env python3
"""Tile shapes of kernel B11's pattern kernel (p2_constrained_apply,
p2_apply_pattern_kernel of tpuwave_torch/csrc/p2_kernels.cu), timed side
by side in one process on one CUDA card.

Each VARIANT is ``f32:COLS,TY,ROWS`` or ``f64:...``: tiles of COLS
columns (one thread each) and TY x ROWS rows (TY threads in y, ROWS rows
a thread). Every variant is compiled alone (p2_kernels.cu with its
TW_P2_APPLY_GEOMETRIES given by nvcc --pre-include, all builds started
together), ptxas's registers and spills are printed, and each runs
chip_smoke.py phase 3's B11 inputs (chip_smoke.p2_system's Newmark system,
random values on every plane's support) in both forms (mask_input, and
the rhs form with zero diagonals) at 4 x 4099^2 f32, 4 x 1027^2 f64 and
4 x 163^2 f64, against the plain version, timed by chip_smoke.cuda_ms
(the median of calls each timed alone after an L2 flush). Needs nvcc and
one card:

    python3 scripts/torch_p2_apply_geometry.py [VARIANT ...]
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: the shapes compared when today's tiles were chosen (the first of each
#: dtype is the large tile p2_apply_geometry picks)
DEFAULT = ("f32:64,4,8", "f32:32,8,4", "f32:64,8,4", "f32:32,8,8",
           "f32:128,2,8", "f32:64,4,16", "f32:32,4,8", "f32:64,2,8",
           "f64:32,8,4", "f64:32,8,2", "f64:64,4,4", "f64:32,4,8",
           "f64:64,4,8", "f64:32,8,8", "f64:64,2,8")
#: (elements per side, dtype, timed calls)
CASES = ((4096, "f32", 30), (1024, "f64", 100), (160, "f64", 300))


def parse(spec: str):
    dt, geo = spec.split(":")
    return dt, tuple(int(v) for v in geo.split(","))


def build(specs, work: Path):
    """One library per variant; returns [(spec, lib or None)]."""
    from chip_smoke import ptxas_report
    from tpuwave_torch.ops import _build
    src = ROOT / "tpuwave_torch" / "csrc" / "p2_kernels.cu"
    procs = []
    for k, spec in enumerate(specs):
        dt, (cols, ty, rows) = parse(spec)
        hdr = work / f"v{k}.h"
        hdr.write_text(f"#define TW_P2_APPLY_GEOMETRIES(X) "
                       f"X({'float' if dt == 'f32' else 'double'}, {cols}, "
                       f"{ty}, {rows})\n")
        so = work / f"v{k}.so"
        cmd = [_build._nvcc(), *_build.COMPILE_FLAGS, "-shared", "-I",
               str(src.parent), "--pre-include", str(hdr), "-o", str(so),
               str(src)]
        procs.append((spec, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    out = []
    for spec, so, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            print(f"{spec}: build failed\n{log[-2000:]}", flush=True)
            out.append((spec, None))
            continue
        for ln in ptxas_report(log):
            if "p2_apply_pattern_kernel" in ln:
                print(f"{spec} {ln}", flush=True)
        lib = ctypes.CDLL(str(so))
        fn = lib.tw_p2_apply_pattern
        fn.argtypes = list(_build._SIGNATURES["tw_p2_apply_pattern"])
        fn.restype = ctypes.c_int
        out.append((spec, lib))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", default=DEFAULT)
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from tpuwave_torch.ops import kernels_p2 as kp

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    print(cs.nvidia_smi_line(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(args.variants, Path(tmp))
        for nel, tag, n in CASES:
            dtype = torch.float32 if tag == "f32" else torch.float64
            st = cs.p2_system(nel, 4e-3, 0.25, dtype, dev)
            key = tuple(tuple(t) for t in st.terms)
            diags = tuple(float(st.plane_diag[q]) for q in "VHWD")
            cshape = (nel + 3, nel + 3)
            x = (2 * torch.rand((4, *cshape), generator=gen, device=dev,
                                dtype=torch.float64) - 1).to(dtype)
            out = torch.empty_like(x)
            for mask in (True, False):
                dg = diags if mask else (0.0,) * 4
                want = kp.p2_constrained_apply_reference(x, st.terms, dg,
                                                         nel, nel, mask)
                peak = float(want.abs().max())
                for spec, lib in libs:
                    if lib is None or not spec.startswith(tag):
                        continue
                    _, geo = parse(spec)

                    def launch(lib=lib, geo=geo, dg=dg, mask=mask):
                        return lib.tw_p2_apply_pattern(
                            kp._DTYPES[dtype], kp._ptr(x), kp._ptr(out),
                            cshape[0], cshape[1], nel, nel,
                            kp._slot_arg(key), kp._four(dg), int(mask),
                            *geo, kp._stream(x))
                    if launch() != 0:
                        print(f"{spec}: refused", flush=True)
                        continue
                    err = float((out - want).abs().max()) / peak
                    ms = cs.cuda_ms(launch, n)
                    print(f"4 x {nel + 3}^2 {tag} mask_input={mask!s:<5} "
                          f"{spec:<14} {ms * 1e3:8.1f} us  max err / peak "
                          f"{err:.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
