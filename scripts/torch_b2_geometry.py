#!/usr/bin/env python3
"""Block shapes and launch depths of kernel B2 (leapfrog_multistep, the
streaming-wavefront kernel of tpuwave_torch/csrc/stencil_kernels.cu),
timed side by side in one process on one CUDA card.

Each VARIANT is ``f32:THREADS,ITEMS,MINB,PF,RB`` or ``f64:...``: blocks
of THREADS threads, ITEMS (level, column group) items a thread, registers
capped so that MINB blocks fit an SM (and the rings sized to 1 / MINB of
the shared memory), the loads PF ticks ahead (1, 2 or 4), RB rows a level
steps per tick. Every variant is compiled alone (stencil_kernels.cu
with its TW_B2_SHAPES given by nvcc --pre-include, all builds started
together), ptxas's registers and spills are printed, and each runs
bench.py's 4097^2 leapfrog (chip_smoke.py phase 3's stiffness and time
step, random fields) through the C entry point at every launch depth of
--depths that divides into the pass as the wrapper splits it (a pass of k
steps is ceil(k / depth) launches), against the plain version, timed by
chip_smoke.cuda_ms (the median of calls each timed alone after an L2
flush). Needs nvcc and one card:

    python3 scripts/torch_b2_geometry.py [VARIANT ...] [--depths 8,16]
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

#: the shapes compared when today's shapes were chosen (the first of each
#: dtype is the one TW_B2_SHAPES builds)
DEFAULT = ("f32:512,3,1,4,2", "f32:512,2,1,4,2", "f32:512,3,1,2,2",
           "f32:512,2,1,1,4", "f32:512,1,2,4,2", "f32:256,2,2,2,4",
           "f64:512,2,1,4,2", "f64:512,2,1,2,2", "f64:512,1,1,2,4")
#: the other dtype's shape in a variant's build
BUILT = {"f32": "X(float, 512, 3, 1, 4, 2)",
         "f64": "X(double, 512, 2, 1, 4, 2)"}
#: (dtype, steps per call)
CASES = (("f32", 1), ("f32", 4), ("f32", 8), ("f32", 16), ("f32", 32),
         ("f64", 8), ("f64", 16))


def parse(spec: str):
    dt, geo = spec.split(":")
    return dt, tuple(int(v) for v in geo.split(","))


def build(specs, work: Path):
    """One library per variant; returns [(spec, lib or None)]."""
    from chip_smoke import ptxas_report
    from tpuwave_torch.ops import _build
    src = ROOT / "tpuwave_torch" / "csrc" / "stencil_kernels.cu"
    procs = []
    for k, spec in enumerate(specs):
        dt, (nt, ipt, minb, pf, rb) = parse(spec)
        mine = (f"X({'float' if dt == 'f32' else 'double'}, {nt}, {ipt}, "
                f"{minb}, {pf}, {rb})")
        other = BUILT["f64" if dt == "f32" else "f32"]
        hdr = work / f"v{k}.h"
        hdr.write_text(f"#define TW_B2_SHAPES(X) {mine} {other}\n")
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
        want = "<float" if spec.startswith("f32") else "<double"
        for ln in ptxas_report(log):
            if "leapfrog_wavefront_kernel" in ln and want in ln:
                print(f"{spec} {ln}", flush=True)
        lib = ctypes.CDLL(str(so))
        fn = lib.tw_leapfrog_multistep
        fn.argtypes = list(_build._SIGNATURES["tw_leapfrog_multistep"])
        fn.restype = ctypes.c_int
        out.append((spec, lib))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", default=DEFAULT)
    ap.add_argument("--depths", default="8,16,32",
                    help="comma-separated deepest launches to time")
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from tpuwave_torch.models.fast import FastWaveSolver
    from tpuwave_torch.ops import kernels as kn

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    print(cs.nvidia_smi_line(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    lf = FastWaveSolver((4096, 4096), ((0.0, 0.0), (1.0, 1.0)), 8e-5,
                        beta=0.0, dtype=torch.float32, device=dev)
    stencil, coef = lf.stiff.stencil, lf.dt * lf.dt / lf.mesh.det_j
    depths = [int(v) for v in args.depths.split(",")]
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(args.variants, Path(tmp))
        for tag, k in CASES:
            dtype = torch.float32 if tag == "f32" else torch.float64
            u, up = ((2 * torch.rand((4097, 4097), generator=gen,
                                     device=dev, dtype=torch.float64) - 1)
                     .to(dtype) for _ in range(2))
            h, w = u.shape
            want = kn.leapfrog_multistep_reference(u, up, stencil, coef, k)
            peak = max(float(t.abs().max()) for t in want)
            for deepest in sorted({min(d, k) for d in depths}):
                n = -(-k // deepest)
                out_u, out_up = torch.empty_like(u), torch.empty_like(u)
                scratch = (torch.empty((2 * min(n - 1, 2),
                                        h + 2 * (k - k // n), w),
                                       dtype=dtype, device=dev)
                           if n > 1 else None)
                for spec, lib in libs:
                    if lib is None or not spec.startswith(tag):
                        continue

                    def launch(lib=lib):
                        return lib.tw_leapfrog_multistep(
                            kn._DTYPES[dtype], kn._ptr(u), kn._ptr(up),
                            kn._ptr(out_u), kn._ptr(out_up),
                            None if scratch is None else kn._ptr(scratch),
                            h, w, kn._stencil_arg(stencil), float(coef), k,
                            -(-k // n), 0, h, kn._stream(u))
                    if launch() != 0:
                        # no slab of this shape holds that depth
                        print(f"4097^2 {tag} k={k:<2} {n} launch(es) of <= "
                              f"{-(-k // n):<2} {spec:<14} refused",
                              flush=True)
                        continue
                    err = max(float((g - t).abs().max()) for g, t in
                              zip((out_u, out_up), want)) / peak
                    ms = cs.cuda_ms(launch, 10)
                    print(f"4097^2 {tag} k={k:<2} {n} launch(es) of <= "
                          f"{-(-k // n):<2} {spec:<14} {ms * 1e3:8.1f} us "
                          f"({ms * 1e3 / k:6.1f} us/step)  max err / peak "
                          f"{err:.2e}", flush=True)
            del u, up, want
    return 0


if __name__ == "__main__":
    sys.exit(main())
