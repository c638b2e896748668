#!/usr/bin/env python3
"""Slab shapes of kernels B12 / B13 (p2_presmooth / p2_postsmooth, the
register kernel of tpuwave_torch/csrc/p2_kernels.cu), timed side by side in
one process on one CUDA card.

Each VARIANT is ``f32:COLS,TY,ROWS,MINB`` or ``f64:...``: slabs of COLS
columns and TY x ROWS rows (TY threads in y, ROWS rows a thread), registers
capped so that MINB blocks fit an SM; a ``:late`` suffix builds the source
with B13 reading x_in after the chain instead of with r and corr. Every
variant is compiled alone (p2_kernels.cu with its TW_P2_SMOOTH_GEOMETRIES
given by nvcc --pre-include, all builds started together), ptxas's
registers and spills are printed, and each is run through
kernels_p2._smooth_launch on phase 3's inputs (chip_smoke.p2_system):
4 x 4099^2 f32 and 4 x 1027^2 f64 at degrees 4 and 2, 4 x 163^2 f64 at
degree 4, against the plain versions, timed by chip_smoke.cuda_ms (the
median of calls each timed alone after an L2 flush). Needs nvcc and one
card:

    python3 scripts/torch_p2_smooth_geometry.py [VARIANT ...]
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

#: the shapes compared when today's geometry was chosen (the first of each
#: dtype is the one p2_smooth_geometry picks)
DEFAULT = ("f32:64,4,8,2", "f32:64,4,8,1", "f32:64,8,8,1", "f32:64,8,4,1",
           "f32:32,8,4,3", "f32:32,8,8,2", "f32:32,4,8,4", "f32:32,16,4,1",
           "f32:64,4,6,2", "f32:96,4,8,1", "f32:128,4,8,1", "f32:128,2,8,2",
           "f32:64,4,8,2:late", "f64:32,8,4,2", "f64:32,8,4,1",
           "f64:64,4,8,1", "f64:64,8,4,1", "f64:32,4,8,2", "f64:64,4,4,2",
           "f64:32,4,4,4", "f64:32,8,8,1", "f64:32,8,5,2", "f64:32,8,6,2",
           "f64:128,2,8,1", "f64:96,4,8,1", "f64:32,8,4,2:late")

#: B13 reading x_in after the chain: x_out = x_in + (corr + d_0 + ...)
READ_X_LAST = (
    ("        xv[i][p] = t ? __ldg(xin + p * plane + g) : T(0);\n", ""),
    ("        d = dv[i][p];\n        xv[i][p] += d;",
     "        d = dv[i][p];\n        xv[i][p] = d;"),
    ("      out_x[p * plane + g] = xv[i][p];",
     "      out_x[p * plane + g] =\n"
     "          POST ? __ldg(xin + p * plane + g) + xv[i][p] : xv[i][p];"))


def parse(spec: str):
    dt, geo, *late = spec.split(":")
    cols, ty, rows, minb = (int(v) for v in geo.split(","))
    return dt, (cols, ty, rows, minb), bool(late)


def build(specs, work: Path):
    """One library per variant; returns [(spec, lib or None)]."""
    from chip_smoke import ptxas_report
    from tpuwave_torch.ops import _build
    src = ROOT / "tpuwave_torch" / "csrc" / "p2_kernels.cu"
    late_src = work / "p2_kernels_x_last.cu"
    text = src.read_text()
    for a, b in READ_X_LAST:
        if a not in text:
            raise RuntimeError("p2_kernels.cu changed: cannot build the "
                               "x-read-last variant")
        text = text.replace(a, b)
    late_src.write_text(text)
    procs = []
    for k, spec in enumerate(specs):
        dt, (cols, ty, rows, minb), late = parse(spec)
        hdr = work / f"v{k}.h"
        hdr.write_text(f"#define TW_P2_SMOOTH_GEOMETRIES(X) "
                       f"X({'float' if dt == 'f32' else 'double'}, {cols}, "
                       f"{ty}, {rows}, {minb})\n")
        so = work / f"v{k}.so"
        cmd = [_build._nvcc(), *_build.COMPILE_FLAGS, "-shared", "-I",
               str(src.parent), "--pre-include", str(hdr), "-o", str(so),
               str(late_src if late else src)]
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
            if "p2_smooth_reg_kernel" in ln:
                print(f"{spec} {ln}", flush=True)
        lib = ctypes.CDLL(str(so))
        lib.tw_p2_smooth.argtypes = list(_build._SIGNATURES["tw_p2_smooth"])
        lib.tw_p2_smooth.restype = ctypes.c_int
        out.append((spec, lib))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", default=DEFAULT)
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from tpuwave_torch.ops import kernels_p2 as kp
    from tpuwave_torch.solve.cheby_iter import chebyshev_coefficients

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    print(cs.nvidia_smi_line(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    lam = 2.5687343127455877
    # the variants' libraries hold p2_kernels.cu alone; every slab fits the
    # card's opt-in limit, which the kernel launch checks
    kp._max_smem = lambda *a: 232448
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(args.variants, Path(tmp))
        for nel, dt, dtype, degrees, n in (
                (4096, 4e-3, torch.float32, (4, 2), 10),
                (1024, 4e-3, torch.float64, (4, 2), 40),
                (160, 4e-2, torch.float64, (4,), 100)):
            st = cs.p2_system(nel, dt, 0.25, dtype, dev)
            inv = tuple(1.0 / float(st.plane_diag[q]) for q in "VHWD")
            slots = kp.smooth_slots(st.terms)
            cshape = (nel + 3, nel + 3)
            interior = kp.p2_canvas_interior(nel, nel, cshape, dev)

            def rnd(mask):
                x = 2 * torch.rand((4, *cshape), generator=gen, device=dev,
                                   dtype=torch.float64) - 1
                return torch.where(mask, x, 0.0).to(dtype)
            full = torch.ones_like(interior)
            b, x, corr = rnd(interior), rnd(full), rnd(full)
            tag = "f32" if dtype == torch.float32 else "f64"
            for degree in degrees:
                th, cf = chebyshev_coefficients(lam / 8.0, lam, degree)
                sm = [(float(a), float(c)) for a, c in cf]
                want = (*kp.p2_presmooth_reference(b, st.terms, inv, th, sm,
                                                   nel, nel),
                        kp.p2_postsmooth_reference(x, b, corr, st.terms, inv,
                                                   th, sm, nel, nel))
                peak = max(float(w.abs().max()) for w in want)
                for spec, lib in libs:
                    dt_name, (cols, ty, rows, _), _ = parse(spec)
                    if lib is None or dt_name != tag:
                        continue
                    if ty * rows <= 2 * degree or cols <= 2 * degree:
                        continue
                    geo = kp.SmoothGeometry(ty * rows - 2 * degree,
                                            cols - 2 * degree, ty, rows, 0)

                    def launch(post, lib=lib, geo=geo):
                        # the wrapper's launch with this variant's library
                        # and slab
                        kp._lib, kp.p2_smooth_geometry = (
                            lambda: lib, lambda *a: geo)
                        return kp._smooth_launch(
                            "p2_postsmooth" if post else "p2_presmooth",
                            post, b, x if post else None,
                            corr if post else None, slots, inv, th, sm, nel,
                            nel)
                    got = (*launch(False), launch(True))
                    err = max(float((g - w).abs().max())
                              for g, w in zip(got, want)) / peak
                    pre = cs.cuda_ms(lambda: launch(False), n)
                    post = cs.cuda_ms(lambda: launch(True), n)
                    print(f"4 x {nel + 3}^2 {str(dtype)[6:]} degree "
                          f"{degree} {spec:<20} B12 {pre * 1e3:8.1f} us  "
                          f"B13 {post * 1e3:8.1f} us  max err / peak "
                          f"{err:.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
