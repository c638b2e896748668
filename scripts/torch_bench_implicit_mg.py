#!/usr/bin/env python3
"""Benchmark the large-dt implicit MG-PCG fast paths of the PyTorch / CUDA
port, torch ops against the hand-written kernels
(scripts/bench_implicit_mg.py's twin).

The regime where multigrid pays: dt far above the explicit CFL limit, so
single-level solvers need O(dt/h) iterations. Compares
``FastWaveSolver.run_implicit_mg`` (torch-op setup and matvecs; the
V-cycle's level operators on B3) with ``run_implicit_mg_kernel`` (setup
B7 / B9 / B10, CG matvecs B3, the V-cycle's fine level B4 + B3, update
B8) on the same trajectory, then the displacement-form 2-term path
(``run_implicit_mg_2term``: B5, B3, B4), and reports ms/step and the
relative end-state difference.

The same flags, defaults and printed rows as bench_implicit_mg.py, with
``kernel`` where it says ``Pallas``, plus ``--device`` (default cuda) and
a CG line per run. ``--interpret`` and ``--block-rows`` size tpuwave's
Pallas route and have no counterpart (accepted, unused). Times are the
best host wall of ``--repeats`` runs after a first one, around a device
synchronize.

Smoke: ``--nel 16 --steps 2 --device cpu``.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Implicit MG fast-path bench")
    p.add_argument("--nel", type=int, default=4096)
    p.add_argument("--dt", type=float, default=1e-3,
                   help="time step (default: CFL-breaking at 4096^2)")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    p.add_argument("--schemes", nargs="+",
                   default=["theta-1.0", "theta-0.5", "newmark-0.25"])
    p.add_argument("--interpret", action="store_true",
                   help="tpuwave's interpret mode (no counterpart)")
    p.add_argument("--block-rows", type=int, default=128,
                   help="tpuwave's Pallas block rows (no counterpart)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch
    from tpuwave_torch.config import resolve_device
    from tpuwave_torch.models.fast import FastWaveSolver

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    print([f"cuda:{torch.cuda.get_device_name(0)}" if on_card else "cpu"],
          flush=True)
    geom = ((0.0, 0.0), (1.0, 1.0))
    dtype = torch.float32 if args.dtype == "f32" else torch.float64

    def u0(x, y):
        return torch.sin(torch.pi * x) * torch.sin(torch.pi * y)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def measure(label, s, fn, state, n, repeats):
        print(f"  [{label}] first run ...", flush=True)
        sync()
        t0 = time.perf_counter()
        out = fn(state, n)
        sync()
        print(f"  [{label}] first run {time.perf_counter() - t0:.1f} s",
              flush=True)
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            out = fn(state, n)
            sync()
            best = min(best, (time.perf_counter() - t0) / n)
        print(f"  [{label}] CG iterations per step: {s.last_iterations}",
              flush=True)
        return best, out

    def rel(a, ref):
        return float(torch.linalg.vector_norm(a - ref)
                     / torch.linalg.vector_norm(ref))

    for name in args.schemes:
        family, val = name.rsplit("-", 1)
        kw = ({"theta": float(val)} if family == "theta"
              else {"beta": float(val), "lumped": False})
        s = FastWaveSolver((args.nel, args.nel), geom, args.dt,
                           scheme=family, dtype=dtype, device=device, **kw)
        st = s.initial_state(u0)
        t_x, out_x = measure(f"{name} torch-mg", s, s.run_implicit_mg,
                             st, args.steps, args.repeats)
        t_p, out_p = measure(f"{name} kernel-mg", s,
                             s.run_implicit_mg_kernel, st, args.steps,
                             args.repeats)
        print(f"{name} nel={args.nel} dt={args.dt}: "
              f"torch MG {t_x * 1e3:.2f} ms/step, "
              f"kernel MG {t_p * 1e3:.2f} ms/step ({t_x / t_p:.2f}x), "
              f"rel diff {rel(out_p.u, out_x.u):.2e}", flush=True)

        # displacement-form two-array path (one O(dt^2)-residual MG solve
        # a step, no mass / velocity solve; both families)
        lf0 = s.implicit_2term_init(st)
        t_2, out_2 = measure(f"{name} 2term-mg", s, s.run_implicit_mg_2term,
                             lf0, args.steps - 1, args.repeats)
        print(f"{name} nel={args.nel} dt={args.dt}: "
              f"2term MG {t_2 * 1e3:.2f} ms/step "
              f"({t_p / t_2:.2f}x vs kernel-mg), "
              f"rel diff {rel(out_2.u, out_x.u):.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
