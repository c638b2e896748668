#!/usr/bin/env python3
"""Host wall and device-busy time of chip_smoke.py's P2 V-cycle, phase-14
implicit steps and phase-17 FWI calls, with the tpuwave_torch of a given
checkout (default: this one), so that two checkouts can be compared on one
card, run alternately (parent, new, new, parent, each in a process of its
own).

P2: one (p+h)-multigrid V-cycle of the R = 2 Newmark engine (beta 1/4, dt
4e-3, mg_pre_degree 4) at phase 11b's 4 x 4099^2 canvases in f32 and at
phase 11's 4 x 1027^2 in f64, on a random interior residual. Phase 8: 10
recurrence steps of the CLI's --solver 2term --precond mg engine (Newmark
beta 1/4, 2048^2 elements, f64, dt 4e-3) after its first step. Phase 14:
FastWaveSolver.run_implicit_mg_kernel at 4096^2 elements, f32, dt 1e-3, 20
steps, and the 2-term chain's 19 recurrence steps after its init, for
theta 1, theta 1/2 and Newmark beta 1/4. Phase 17: FwiProblem's
kernel engine at 1024^2 elements, f32, 2000 steps, steps_per_call 8, hard
walls and the sponge ring: simulate and misfit_and_grad. Each: the best
and the median of --repeats runs after a warm run (host clock around a
synchronize), then one run under torch.profiler: its device-busy time (the
sum of its kernels' and copies' times, which the host's noise does not
move), the idle share of that run's wall, and the device time and launches
of the kernels named (B4 cheby_block, B5 recurrence_r0, B9 theta_r0u,
the sums of norm partials where a checkout has that launch, B11, B12 and
B13 together, B14, B15, B16, B17) and of the largest device events. Needs nvcc and one card:

    python3 scripts/torch_device_time.py [--tree DIR] [--repeats 5]
        [--only P2,2term,newmark,sponge]

(--only: run the cases whose label holds one of these words.)
"""

from __future__ import annotations

import argparse
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

#: (tag, substring of the kernel's symbol)
NAMED = (("B4", "cheby_block"), ("B5", "recurrence_r0"),
         ("B9", "theta_r0u_kernel"), ("norm partials", "sum_partials"),
         ("B11", "p2_apply_kernel"), ("B12 + B13", "p2_smooth"),
         ("B14", "varcoef_step_kernel"),
         ("B15", "varcoef_multistep_kernel"),
         ("B16", "varcoef_adjoint_step_kernel"),
         ("B17", "varcoef_adjoint_multistep_kernel"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=ROOT)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--only", default="",
                    help="comma-separated words; run only the cases whose "
                    "label holds one")
    args = ap.parse_args()
    sys.path[:0] = [str(args.tree.resolve()), str(ROOT)]
    import numpy as np
    import torch
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile
    import tpuwave_torch
    from tpuwave_torch.models.fast import FastWaveSolver
    from tpuwave_torch.models.fast_engine import make_fast_solver
    from tpuwave_torch.models.inverse import FwiProblem
    from tpuwave_torch.utils.params import load_params

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    print(cs.nvidia_smi_line(), flush=True)
    print(f"tpuwave_torch from {Path(tpuwave_torch.__file__).parents[1]}",
          flush=True)

    words = [w for w in args.only.split(",") if w]

    def wanted(label):
        return not words or any(w in label for w in words)

    def measure(label, fn, per):
        """Print fn's best and median wall / ``per`` and its profile."""
        if not wanted(label):
            return
        fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        best, median = min(walls), statistics.median(walls)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = cs._device_time(prof)
        if busy is None:
            print(f"{label}: best {best / per * 1e3:.2f} ms, median "
                  f"{median / per * 1e3:.2f} ms (device busy not "
                  f"measured: the profiler saw no device time)", flush=True)
            return
        events = cs._device_events(prof)
        print(f"{label}: best {best / per * 1e3:.2f} ms, median "
              f"{median / per * 1e3:.2f} ms, device busy "
              f"{busy[1] / per:.3f} ms in {busy[0] / per:.1f} events, idle "
              f"share {1 - busy[1] / 1e3 / wall:.3f} (wall "
              f"{wall / per * 1e3:.2f} ms under the profiler)", flush=True)
        for tag, part in NAMED:
            hit = [e for e in events if part in e.key]
            if hit:
                us = sum(e.self_device_time_total for e in hit)
                print(f"    {tag}: {us / 1e3 / per:.3f} ms in "
                      f"{sum(e.count for e in hit) / per:.2f} launches = "
                      f"{us / 1e3 / busy[1]:.3f} of device time", flush=True)
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:5]:
            print(f"    {e.self_device_time_total / 1e3 / per:8.3f} ms "
                  f"{e.count / per:7.2f}x {e.key[:60]}", flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    for nel, dtype in ((4096, torch.float32), (1024, torch.float64)):
        label = f"P2 V-cycle 4 x {nel + 3}^2 {str(dtype)[6:]}"
        if not wanted(label):
            continue
        with tempfile.TemporaryDirectory() as tmp:
            case = cs._case(Path(tmp), Nel=str(nel), R="2", Dt="4e-3",
                            T="0.04", Beta="0.25", Gamma="0.5",
                            **{"Enable Logging": "false"})
            solver = make_fast_solver(load_params(str(case)), "newmark",
                                      precond="mg", device="cuda",
                                      dtype=dtype)
        prec = solver._prec_sys
        b = torch.rand((4, *solver._cshape), generator=gen, device="cuda",
                       dtype=torch.float64)
        b = torch.where(solver.interior, b, 0.0).to(dtype)
        measure(f"{label}, per cycle", lambda: prec(b), 1)
        del solver, prec, b

    label = "phase 8 2term CLI engine 2048^2 f64, per step"
    if wanted(label):
        dt = 4e-3
        with tempfile.TemporaryDirectory() as tmp:
            case = cs._case(Path(tmp), Nel="2048", Dt=str(dt), T="0.2",
                            Beta="0.25", Gamma="0.5",
                            **{"Enable Logging": "false"})
            solver = make_fast_solver(load_params(str(case)), "newmark",
                                      solver="2term", precond="mg",
                                      device="cuda")
        first, _ = solver.step(solver.initial_state(), dt)

        def recur(n=10):
            s = first
            for i in range(n):
                s, _ = solver.step(s, (2 + i) * dt)
            return s
        measure(label, recur, 10)
        del solver, first

    nel, dt, n = 4096, 1e-3, 20
    for name, kw in cs.FAST_SCHEMES.items():
        kernel = f"phase 14 {name} run_implicit_mg_kernel {nel}^2 f32"
        chain = f"phase 14 {name} 2term {nel}^2 f32"
        if not (wanted(kernel) or wanted(chain)):
            continue
        fs = FastWaveSolver((nel, nel), cs.UNIT_SQUARE, dt,
                            dtype=torch.float32, device="cuda", **kw)
        st = fs.initial_state(cs._standing(torch))
        measure(f"{kernel}, per step",
                lambda: fs.run_implicit_mg_kernel(st, n), n)
        if wanted(chain):
            lf0 = fs.implicit_2term_init(st)
            measure(f"{chain}, per recurrence step",
                    lambda: fs.run_implicit_mg_2term(lf0, n - 1), n - 1)
            del lf0
        del fs, st

    dev = torch.device("cuda")
    for label, kw in (("hard walls", {}),
                      ("sponge ring", dict(sponge_width=0.1,
                                           boundary_save="ring"))):
        if not wanted(f"phase 17 {label} simulate misfit_and_grad"):
            continue
        p = FwiProblem((cs.FWI_NEL, cs.FWI_NEL), cs.UNIT_SQUARE, cs.FWI_DT,
                       cs.FWI_STEPS, source=cs.FWI_SOURCE,
                       receivers=cs.FWI_RECEIVERS, dtype=torch.float32,
                       device=dev, steps_per_call=8, **kw)
        c2t = torch.tensor(cs._fwi_disk(np, p), dtype=torch.float32,
                           device=dev)
        c2i = torch.full_like(c2t, cs.FWI_C2_INIT)
        obs = p.simulate(c2t)
        measure(f"phase 17 {label} simulate", lambda: p.simulate(c2t), 1)
        measure(f"phase 17 {label} misfit_and_grad",
                lambda: p.misfit_and_grad(c2i, obs), 1)
        del p, c2t, c2i, obs
    print(f"done ({time.perf_counter() - cs.T_START:.0f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
