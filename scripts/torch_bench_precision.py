#!/usr/bin/env python3
"""f64 and compensated-f32 throughput at the 4096^2 bench scale on the
PyTorch / CUDA port (scripts/bench_precision.py's twin).

At the same 4096^2 standing-mode leapfrog configuration it measures:

  * f32 roll scan          (FastWaveSolver.run_leapfrog_scan, torch ops)
  * compensated f32        (TwoSum carries, ~f48 effective;
    run_leapfrog_compensated: 2 stencil applies + TwoSum bookkeeping a
    step, torch ops)
  * f64 roll scan

and the implicit rows: driven Crank-Nicolson through the 2-term MG
product engine (--solver 2term --precond mg: kernels B5, B3, B4) in f32
and in f64 (the H100 runs f64 natively), and the compensated f32 2-term
recurrence (run_implicit_mg_2term_comp_driven and the standing-mode
run_implicit_mg_2term_comp: CG matvecs on B3, the V-cycle on B4 / B3).

The same flags, defaults and printed rows as bench_precision.py, plus
``--device`` (default cuda). Each row runs once, then ``repeats`` more
times from where the last left off; the best host wall (read after a
device sync) gives us/step and DoF*steps/s.

Smoke: ``--nel 16 --steps 2 --device cpu``.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

NAMES = ["f32", "comp", "f64", "imp-f32", "imp-comp", "imp-f64"]


def implicit_case(nel: int) -> dict:
    """bench_precision.py's driven CN case: sin(4 pi t) on the x <= 1/3
    strip of the y = 0 edge, dt 1e-3."""
    return {
        "Nel": str(nel), "R": "1", "T": "1.0", "Theta": "0.5",
        "Dt": str(1e-3), "Save Solution": "false", "Log Every": "0",
        "C": {"Function expression": "1.0", "Variable names": "x, y, t"},
        "F": {"Function expression": "0.0", "Variable names": "x, y, t"},
        "U0": {"Function expression": "0.0", "Variable names": "x, y"},
        "V0": {"Function expression": "0.0", "Variable names": "x, y"},
        "G": {"Function expression":
              "if(y < 0.0001 && x < 0.34, sin(4*pi*t), 0)",
              "Variable names": "x, y, t"},
        "DGDT": {"Function expression":
                 "if(y < 0.0001 && x < 0.34, 4*pi*cos(4*pi*t), 0)",
                 "Variable names": "x, y, t"},
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nel", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--skip", nargs="*", default=[], choices=NAMES)
    ap.add_argument("--only", nargs="*", default=None, choices=NAMES)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.only is not None:
        args.skip = [n for n in NAMES if n not in args.only]
    return args


def main(argv=None):
    args = parse_args(argv)
    import torch
    from tpuwave_torch.config import resolve_device
    from tpuwave_torch.models.fast import FastWaveSolver
    from tpuwave_torch.models.fast_engine import make_fast_solver
    from tpuwave_torch.utils.params import load_params

    device = resolve_device(args.device)
    nel, steps = args.nel, args.steps
    geo = ((0.0, 0.0), (1.0, 1.0))
    print(f"# platform={device.type} nel={nel} steps={steps}", flush=True)

    def u0(xs, ys):
        return torch.sin(torch.pi * xs) * torch.sin(torch.pi * ys)

    def sync(x):
        return float(torch.sum(x.to(torch.float32)))

    def time_path(label, run, state, n_dofs, repeats=3):
        t0 = time.perf_counter()
        out = run(state)
        sync(out.u)
        print(f"# {label}: compile+first {time.perf_counter() - t0:.1f} s",
              flush=True)
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            out = run(out)
            sync(out.u)
            best = min(best, time.perf_counter() - t0)
        rate = n_dofs * steps / best
        print(f"{label}: {best / steps * 1e6:9.1f} us/step  "
              f"{rate:.3e} DoF*steps/s", flush=True)
        return rate

    def solver(dtype, **kw):
        return FastWaveSolver((nel, nel), geo, kw.pop("dt", 8e-5),
                              dtype=dtype, device=device, **kw)

    if "f32" not in args.skip:
        s32 = solver(torch.float32, beta=0.0)
        time_path("f32  roll scan   ",
                  lambda st: s32.run_leapfrog_scan(st, steps),
                  s32.initial_leapfrog_state(u0), s32.n_dofs)

    if "comp" not in args.skip:
        s32 = solver(torch.float32, beta=0.0)
        time_path("f32c compensated ",
                  lambda st: s32.run_leapfrog_compensated(st, steps),
                  s32.initial_compensated_state(u0), s32.n_dofs)

    if "f64" not in args.skip:
        s64 = solver(torch.float64, beta=0.0)
        time_path("f64  roll scan   ",
                  lambda st: s64.run_leapfrog_scan(st, steps),
                  s64.initial_leapfrog_state(u0), s64.n_dofs)

    def bench_engine(label, eng):
        ts = 1e-3 * (1.0 + torch.arange(steps, dtype=torch.float64))

        def run(state):
            out, _ = eng.run_steps(state, ts.tolist())
            return out

        time_path(label, run, eng.initial_state(), eng.disc.n_dofs)

    if "imp-f32" not in args.skip:
        bench_engine("f32  implicit CN driven (2term mg)",
                     make_fast_solver(load_params(implicit_case(nel)),
                                      "theta", solver="2term", precond="mg",
                                      dtype=torch.float32, device=device))

    if "imp-comp" not in args.skip:
        # the compensated displacement recurrence (CN form) on the same
        # strip drive as the f32 row above
        sc = solver(torch.float32, dt=1e-3, scheme="theta", theta=0.5,
                    lumped=False)

        def g_strip(xs, ys, t):
            return torch.where((ys <= 0.0) & (xs <= 1.0 / 3.0),
                               torch.sin(4.0 * torch.pi * t), 0.0)

        ts_d = (1e-3 * (1.0 + torch.arange(steps,
                                           dtype=torch.float64))).tolist()
        time_path("f32c implicit CN compensated 2term driven",
                  lambda st: sc.run_implicit_mg_2term_comp_driven(
                      st, ts_d, g_strip),
                  sc.implicit_2term_init_comp(sc.initial_state(u0)),
                  sc.n_dofs)
        # the standing-mode companion
        time_path("f32c implicit CN compensated 2term standing",
                  lambda st: sc.run_implicit_mg_2term_comp(st, steps),
                  sc.implicit_2term_init_comp(sc.initial_state(u0)),
                  sc.n_dofs)

    if "imp-f64" not in args.skip:
        bench_engine("f64  implicit CN driven (2term mg)",
                     make_fast_solver(load_params(implicit_case(nel)),
                                      "theta", solver="2term", precond="mg",
                                      dtype=torch.float64, device=device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
