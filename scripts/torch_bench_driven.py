#!/usr/bin/env python3
"""Bench of DRIVEN (time-dependent Dirichlet) cases at 4096^2 on the
PyTorch / CUDA port (scripts/bench_driven.py's twin).

A sine-membrane-style drive (an oscillating strip on one edge, reference
parameters/sine-membrane.json) through:

  * the explicit leapfrog, driven boundary (run_leapfrog_driven, torch ops)
  * the same on kernel B1 (run_leapfrog_driven_kernel)
  * the same temporally blocked on kernel B6, k = 8, 16, 32 steps a launch
    (run_leapfrog_driven_multistep)
  * the driven leapfrog with the consistent forcing load
  * implicit CN through the product engine (FastThetaSolver, MG-PCG), the
    2-term engine (B5, B3, B4) and the Chebyshev engine (B4); at R = 2
    the P2 engines (default-skipped, as in bench_driven.py)

The same flags, defaults and printed rows as bench_driven.py, with
``pallas`` rows on the hand-written kernels, plus ``--device`` (default
cuda). Each row runs once, then three more times from where the last left
off; the best host wall (read after a device sync) gives us/step and
DoF*steps/s.

Smoke: ``--nel 16 --steps 2 --device cpu``.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

LEGS = ["driven", "driven-pallas", "driven-multistep", "forced",
        "implicit", "implicit-2term", "implicit-cheby", "p2-implicit",
        "p2-2term"]


def implicit_case(nel: int, **over) -> dict:
    """bench_driven.py's driven CN case (dt 1e-3)."""
    case = {
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
    case.update(over)
    return case


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nel", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--skip", nargs="*", default=["p2-implicit", "p2-2term"],
                    choices=LEGS)
    ap.add_argument("--only", nargs="*", default=None, choices=LEGS)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.only is not None:
        args.skip = [n for n in LEGS if n not in args.only]
    return args


def main(argv=None):
    args = parse_args(argv)
    import torch
    from tpuwave_torch.config import resolve_device
    from tpuwave_torch.models.fast import FastWaveSolver
    from tpuwave_torch.models.fast_engine import (FastThetaSolver,
                                                  make_fast_solver)
    from tpuwave_torch.utils.params import load_params

    device = resolve_device(args.device)
    nel, steps = args.nel, args.steps
    geo = ((0.0, 0.0), (1.0, 1.0))
    dt = 8e-5
    print(f"# platform={device.type} nel={nel} steps={steps}", flush=True)

    def u0_fn(xs, ys):
        return torch.zeros_like(xs)

    def g_fn(xs, ys, t):
        # the drive: sin(4 pi t) on the x in [0, 1/3] strip of the y = 0
        # edge (t: a 0-d tensor, or (k, 1) on the multistep path)
        return torch.where((ys <= 0.0) & (xs <= 1.0 / 3.0),
                           torch.sin(4.0 * torch.pi * t), 0.0)

    def f_fn(xs, ys, t):
        return (torch.sin(2.0 * torch.pi * xs) * torch.sin(torch.pi * ys)
                * torch.cos(3.0 * t))

    def sync(x):
        return float(torch.sum(x.to(torch.float32)))

    s = FastWaveSolver((nel, nel), geo, dt, beta=0.0, dtype=torch.float32,
                       device=device)
    times = (dt * (1.0 + torch.arange(steps, dtype=torch.float64))).tolist()

    def bench(label, run, state, n_dofs=s.n_dofs):
        t0 = time.perf_counter()
        out = run(state)
        sync(out.u)
        print(f"# {label}: compile+first {time.perf_counter() - t0:.1f} s",
              flush=True)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = run(out)
            sync(out.u)
            best = min(best, time.perf_counter() - t0)
        print(f"{label}: {best / steps * 1e6:9.1f} us/step  "
              f"{n_dofs * steps / best:.3e} DoF*steps/s", flush=True)

    if "driven" not in args.skip:
        bench("explicit driven g(t)          ",
              lambda st: s.run_leapfrog_driven(st, times, g_fn),
              s.initial_leapfrog_state(u0_fn, g_fn=g_fn))

    if "driven-pallas" not in args.skip:
        bench("explicit driven g(t), pallas  ",
              lambda st: s.run_leapfrog_driven_kernel(st, times, g_fn),
              s.initial_leapfrog_state(u0_fn, g_fn=g_fn))

    if "driven-multistep" not in args.skip:
        # per-substep boundary injection inside the k-step kernel B6
        for k in (8, 16, 32):
            if steps % k:
                print(f"# explicit driven, k={k:2d} blocked: skipped "
                      f"(steps {steps} not a multiple of {k})", flush=True)
                continue
            bench(f"explicit driven, k={k:2d} blocked ",
                  lambda st, k=k: s.run_leapfrog_driven_multistep(
                      st, times, g_fn, steps_per_call=k),
                  s.initial_leapfrog_state(u0_fn, g_fn=g_fn))

    if "forced" not in args.skip:
        bench("explicit driven + forcing load",
              lambda st: s.run_leapfrog_driven(st, times, g_fn, f_fn),
              s.initial_leapfrog_state(u0_fn, f_fn=f_fn, g_fn=g_fn))

    ts = (1e-3 * (1.0 + torch.arange(steps, dtype=torch.float64))).tolist()

    def bench_engine(label, eng):
        def run(state):
            out, _ = eng.run_steps(state, ts)
            return out
        bench(label, run, eng.initial_state(), eng.disc.n_dofs)

    kw = dict(dtype=torch.float32, device=device)
    if "implicit" not in args.skip:
        # the product --engine fast path at scale: CN, driven strip, MG-PCG
        eng = FastThetaSolver(load_params(implicit_case(nel)),
                              precond="mg", **kw)
        bench_engine("implicit CN driven (fast engine, mg, dt=1e-3)", eng)

    if "implicit-2term" not in args.skip:
        bench_engine("implicit CN driven (2term, mg, dt=1e-3)",
                     make_fast_solver(load_params(implicit_case(nel)),
                                      "theta", solver="2term",
                                      precond="mg", **kw))

    if "p2-implicit" not in args.skip:
        # the R = 2 product engine at the same geometry (67.1 M DoF at
        # --nel 4096): driven implicit Newmark-AA on the canvases
        case2 = implicit_case(nel, R="2", Beta="0.25")
        bench_engine("implicit NM-AA driven P2 (mg,  dt=1e-3)",
                     make_fast_solver(load_params(case2), "newmark",
                                      precond="mg", **kw))

    if "p2-2term" not in args.skip:
        case3 = implicit_case(nel, R="2", Beta="0.25")
        bench_engine("implicit NM-AA driven P2 (2term, mg, dt=1e-3)",
                     make_fast_solver(load_params(case3), "newmark",
                                      solver="2term", precond="mg", **kw))

    if "implicit-cheby" not in args.skip:
        bench_engine("implicit CN driven (cheby,    dt=1e-3)",
                     make_fast_solver(load_params(implicit_case(nel)),
                                      "theta", solver="cheby", **kw))
    return 0


if __name__ == "__main__":
    sys.exit(main())
