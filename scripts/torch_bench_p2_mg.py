#!/usr/bin/env python3
"""Benchmark the P2 canvas solver's preconditioners at large dt on the
PyTorch / CUDA port (scripts/bench_p2_mg.py's twin).

The (p+h)-multigrid on the canvas layout (P2CanvasGmgPreconditioner:
smoothing on kernels B12 / B13, the P1 tail on B4 / B3) exists for
CFL-breaking dt where Jacobi-CG iteration counts grow with O(dt/h).
Compares precond=jacobi with precond=mg on the same trajectory (implicit
Newmark-AA by default) and reports ms/step, DoF*steps/s, the CG
iterations and the end-state differences, then the same for the 2-term
displacement recurrence.

The same flags, defaults and printed rows as bench_p2_mg.py, plus
``--device`` (default cuda) and a CG line per run. Every canvas apply is
kernel B11 on the card, so ``--no-pallas``, ``--interpret`` and
``--block-rows`` (tpuwave's Pallas route) are accepted and have no
counterpart. Times are the best host wall of ``--repeats`` runs after a
first one, around a device synchronize.

Smoke: ``--nel 16 --steps 2 --device cpu``.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="P2 canvas MG bench")
    p.add_argument("--nel", type=int, default=4096)
    p.add_argument("--dt", type=float, default=1e-3)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--scheme", default="newmark",
                   choices=["newmark", "theta"])
    p.add_argument("--preconds", nargs="+", default=["mg", "jacobi"])
    p.add_argument("--no-pallas", action="store_true",
                   help="tpuwave's XLA route (no counterpart: B11 always)")
    p.add_argument("--interpret", action="store_true",
                   help="tpuwave's interpret mode (no counterpart)")
    p.add_argument("--block-rows", type=int, default=64,
                   help="tpuwave's Pallas block rows (no counterpart)")
    p.add_argument("--mg-pre-degree", type=int, default=2)
    p.add_argument("--mg-smooth-range", type=float, default=8.0)
    p.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch
    from tpuwave_torch.config import resolve_device
    from tpuwave_torch.models.fast_p2 import P2CanvasSolver

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    dtype = torch.float32 if args.dtype == "f32" else torch.float64
    print([f"cuda:{torch.cuda.get_device_name(0)}" if on_card else "cpu"],
          flush=True)
    geom = ((0.0, 0.0), (1.0, 1.0))

    def u0(x, y):
        return torch.sin(torch.pi * x) * torch.sin(torch.pi * y)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def best_of(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        first = time.perf_counter() - t0
        best = float("inf")
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            out = fn()
            sync()
            best = min(best, time.perf_counter() - t0)
        return out, first, best

    def rel(a, b):
        return float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b))

    outs = {}
    for precond in args.preconds:
        s = P2CanvasSolver((args.nel, args.nel), geom, args.dt,
                           scheme=args.scheme, precond=precond, dtype=dtype,
                           device=device, use_pallas=not args.no_pallas,
                           pallas_block_rows=args.block_rows,
                           pallas_interpret=args.interpret,
                           mg_pre_degree=args.mg_pre_degree,
                           mg_smooth_range=args.mg_smooth_range)
        st = s.initial_state(u0)
        out, first, best = best_of(lambda: s.run_scan(st, args.steps))
        best /= args.steps
        its = s.last_iterations
        print(f"  [{precond}] first run {first:.1f} s", flush=True)
        outs[precond] = out
        dofs = s.n_dofs
        print(f"{args.scheme} P2 nel={args.nel} dt={args.dt} "
              f"precond={precond}: {best * 1e3:.2f} ms/step "
              f"({dofs / best:.3e} DoF*steps/s)", flush=True)
        print(f"  [{precond}] CG iterations per step: {its}", flush=True)

        # displacement-form 2-term path on the same solver / precond
        pair0 = s.implicit_2term_init(st)
        n2 = args.steps - 1
        out2, first2, best2 = best_of(lambda: s.run_implicit_2term(pair0,
                                                                   n2))
        best2 /= max(n2, 1)
        print(f"  [{precond} 2term] first run {first2:.1f} s", flush=True)
        rel2 = rel(out2.u, out.u)
        print(f"{args.scheme} P2 nel={args.nel} dt={args.dt} "
              f"precond={precond} 2term: {best2 * 1e3:.2f} ms/step "
              f"({dofs / best2:.3e} DoF*steps/s, {best / best2:.2f}x, "
              f"rel diff {rel2:.2e})", flush=True)
        print(f"  [{precond} 2term] CG iterations per step: "
              f"{s.last_iterations}", flush=True)

    if len(outs) == 2:
        a, b = (outs[p].u for p in args.preconds)
        print(f"end-state rel diff {args.preconds[0]} vs "
              f"{args.preconds[1]}: {rel(b, a):.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
