#!/usr/bin/env python3
"""FwiProblem's misfit_and_grad (kernel engine) and kernel B17 at several
steps_per_call, on one CUDA card, with the tpuwave_torch of a given
checkout (default: this one), so that two checkouts can be compared on
one card, run alternately.

For each k: the fused depth FwiProblem uses, misfit_and_grad's
time (best of --repeats after a warm run, host clock around a
synchronize) and the device-busy time of one call (torch.profiler: the
sum of its kernels' and copies' times, which the host's noise does not
move), the B15 and B17 launches of one call, the misfit and the
gradient's norm; at chip_smoke.py's phase-17 configuration (1024^2
elements, f32, dt 2e-4, 2000 steps, hard walls, c2 = 0.9 against the
disk model's traces) and at 512^2 f64 (dt 4e-4, 1000 steps). Then B15
and B17 alone on random fields at the same shapes and each k
(chip_smoke.cuda_ms: the median of calls each timed alone after an L2
flush), or the error it raises. Needs nvcc and one card:

    python3 scripts/torch_fwi_steps.py [--tree DIR] [--ks 4,8,16,24]
        [--repeats 3]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

#: (elements per side, dt, steps, dtype name)
CASES = ((1024, 2e-4, 2000, "float32"), (512, 4e-4, 1000, "float64"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=ROOT)
    ap.add_argument("--ks", default="4,6,8,12,16,20,24,30")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    ks = [int(k) for k in args.ks.split(",")]
    sys.path[:0] = [str(args.tree.resolve()), str(ROOT)]
    import numpy as np
    import torch
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile
    from tpuwave_torch.models.inverse import FwiProblem
    from tpuwave_torch.ops import kernels_varcoef as kv
    from tpuwave_torch.ops.kernels import LAUNCHES

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    print(cs.nvidia_smi_line(), flush=True)
    print(f"tpuwave_torch from {Path(kv.__file__).parents[2]}", flush=True)
    dev = torch.device("cuda")
    for nel, dt, n, dname in CASES:
        dtype = getattr(torch, dname)

        def prob(k):
            return FwiProblem((nel, nel), cs.UNIT_SQUARE, dt, n,
                              source=cs.FWI_SOURCE,
                              receivers=cs.FWI_RECEIVERS, dtype=dtype,
                              device=dev, steps_per_call=k)

        p = prob(8)
        c2t = torch.tensor(cs._fwi_disk(np, p), dtype=dtype, device=dev)
        c2i = torch.full_like(c2t, cs.FWI_C2_INIT)
        obs = p.simulate(c2t)
        for k in ks:
            p = prob(k)
            before = dict(LAUNCHES)
            p.misfit_and_grad(c2i, obs)
            torch.cuda.synchronize()
            n15, n17 = (LAUNCHES[m] - before.get(m, 0) for m in
                        ("varcoef_leapfrog_multistep",
                         "varcoef_adjoint_multistep"))
            best, (v, g) = cs._best_of(
                torch, lambda: p.misfit_and_grad(c2i, obs), args.repeats)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                p.misfit_and_grad(c2i, obs)
                torch.cuda.synchronize()
            busy = cs._device_time(prof)
            print(f"{nel}^2 {dname} {n} steps, steps_per_call {k}: fused "
                  f"depth {p._k}, misfit_and_grad {best * 1e3:.2f} ms "
                  f"(device busy "
                  f"{'not measured' if busy is None else f'{busy[1]:.2f} ms'}), "
                  f"{n15} B15 + {n17} B17 launches, misfit {float(v):.9e}, "
                  f"||grad|| {float(torch.linalg.vector_norm(g)):.9e}",
                  flush=True)
            del p

        p = prob(8)
        planes = p._stacked_planes(c2t)
        coef = p.dt ** 2 / p._det_j
        shape = p._grid
        rec = p._receivers
        gen = torch.Generator(device=dev)
        gen.manual_seed(3)

        def rnd(*s):
            return (2 * torch.rand(s, generator=gen, device=dev,
                                   dtype=torch.float64) - 1).to(dtype)

        un, uc, lam, lp = (rnd(*shape) for _ in range(4))
        wbar = rnd(7, *shape)
        src = (shape[0] // 3, shape[1] // 3)
        for k in ks:
            w, inj = rnd(k), rnd(k, rec.rows.numel())
            calls = (
                ("B15", "varcoef_leapfrog_multistep",
                 lambda: kv.varcoef_leapfrog_multistep(un, uc, planes, w, src,
                                                       coef, rec)),
                ("B17", "varcoef_adjoint_multistep",
                 lambda: kv.varcoef_adjoint_multistep(
                     un, uc, lam, lp, planes, wbar, w, inj, src, coef,
                     (rec.rows, rec.cols))))
            for tag, name, call in calls:
                try:
                    before = LAUNCHES[name]
                    call()
                    launches = LAUNCHES[name] - before
                    ms = cs.cuda_ms(call, 20)
                except ValueError as e:
                    print(f"  {tag} {shape[0]}^2 {dname} k={k}: {e}",
                          flush=True)
                    continue
                print(f"  {tag} {shape[0]}^2 {dname} k={k}: "
                      f"{ms * 1e3:.1f} us in {launches} launch(es), "
                      f"{ms * 1e3 / k:.2f} us/step", flush=True)
        del p, planes, un, uc, lam, lp, wbar
    print(f"done ({time.perf_counter() - cs.T_START:.0f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
