#!/usr/bin/env python3
"""Benchmark the FWI adjoint modes of the PyTorch / CUDA port: remat
autograd against time reversal (scripts/bench_fwi_adjoint.py's twin).

The same flags and defaults as bench_fwi_adjoint.py, with mode
``kernel`` (the fused CUDA kernels B14-B17 with the reversal adjoint)
where it says ``pallas``, and ``--device`` (default cuda).
``FwiProblem(adjoint="remat")`` runs torch.autograd through the step
loop with each step under torch.utils.checkpoint (one field kept per
step, so gradient memory grows linearly in n_steps);
``adjoint="reversal"`` reconstructs the forward states backwards, O(1)
memory in n_steps (tpuwave_torch/models/inverse.py).

For each step count it reports the best time of one misfit-and-gradient
evaluation per mode (host clock around a synchronize, after a first
call), the gradient agreement, and where a mode runs out of device
memory. ``--block-rows`` sizes tpuwave's Pallas blocks and has no
counterpart here (it is accepted and unused).

Smoke: ``--nel 64 --steps 20 40 --device cpu``.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def parse_args():
    p = argparse.ArgumentParser(description="FWI adjoint-mode bench")
    p.add_argument("--nel", type=int, default=1024)
    p.add_argument("--dt", type=float, default=2e-4)
    p.add_argument("--steps", type=int, nargs="+",
                   default=[500, 2000, 8000])
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    p.add_argument("--modes", nargs="+",
                   default=["remat", "reversal"],
                   choices=["remat", "reversal", "kernel"],
                   help="adjoint/engine variants: 'remat'/'reversal' use "
                        "the stencil-plane engine in torch ops; 'kernel' "
                        "is the fused-kernel engine with the reversal "
                        "adjoint")
    p.add_argument("--block-rows", type=int, default=128,
                   help="tpuwave's Pallas block rows (no counterpart)")
    p.add_argument("--steps-per-call", type=int, default=8,
                   help="temporal blocking for the kernel engine: fused "
                        "steps per kernel pass, applied to BOTH the "
                        "forward and the backward pass (1 disables)")
    p.add_argument("--forward-only", action="store_true",
                   help="time p.simulate instead of the gradient")
    p.add_argument("--sponge", type=float, default=0.0,
                   help="absorbing-layer width (physical units; 0 = hard "
                        "walls). With 'reversal' this exercises the "
                        "boundary-saving path; 'kernel' needs "
                        "--boundary-save ring")
    p.add_argument("--boundary-save", choices=("strip", "ring"),
                   default="strip",
                   help="reversal+sponge storage: every damped vertex "
                        "(exact everywhere) or just the interface ring "
                        "(exact on the physical region, O(perimeter) "
                        "memory)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p.parse_args()


def main():
    args = parse_args()
    import numpy as np
    import torch
    from tpuwave_torch.config import resolve_device
    from tpuwave_torch.models.inverse import FwiProblem

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    print([f"{device.type}:{torch.cuda.get_device_name(0)}" if on_card
           else "cpu"])
    geom = ((0.0, 0.0), (1.0, 1.0))
    recs = [(x, y) for x in (0.15, 0.5, 0.85) for y in (0.15, 0.85)]
    dtype = torch.float64 if args.dtype == "f64" else torch.float32

    def sync():
        if on_card:
            torch.cuda.synchronize()

    rows = []
    for n_steps in args.steps:
        grads = {}
        for mode in args.modes:
            engine = "kernel" if mode == "kernel" else "stencil"
            adjoint = "remat" if mode == "remat" else "reversal"
            p = FwiProblem((args.nel, args.nel), geom, args.dt, n_steps,
                           source=(0.25, 0.5), receivers=recs,
                           engine=engine, adjoint=adjoint, dtype=dtype,
                           device=device, sponge_width=args.sponge,
                           boundary_save=args.boundary_save,
                           steps_per_call=args.steps_per_call)
            if args.sponge > 0.0 and p._sponge_rects is not None:
                frac = p._sponge_saved_size / p.n_vertices
                print(f"  boundary save ({p.boundary_save}): "
                      f"{p._sponge_saved_size} vertices "
                      f"({100 * frac:.1f}% of the grid) saved per step")
            if engine == "kernel":
                print(f"  kernel engine: {p._k} fused steps/pass")
            cent = p.mesh.vertex_coords[np.asarray(p.mesh.cells)].mean(1)
            inside = np.sum((cent - [0.6, 0.5]) ** 2, 1) < 0.18 ** 2
            c2_true = torch.tensor(np.where(inside, 0.65, 1.0), dtype=dtype,
                                   device=device)
            c2_hom = torch.ones(p.n_cells, dtype=dtype, device=device)

            def time_fn(fn, *fargs):
                """(first-call seconds, best-of-repeats seconds, result)."""
                t0 = time.perf_counter()
                out = fn(*fargs)
                sync()
                first = time.perf_counter() - t0
                best = float("inf")
                for _ in range(args.repeats):
                    t0 = time.perf_counter()
                    fn(*fargs)
                    sync()
                    best = min(best, time.perf_counter() - t0)
                return first, best, out

            try:
                if args.forward_only:
                    with torch.no_grad():
                        compile_s, best, d_obs = time_fn(p.simulate,
                                                         c2_true)
                    val = 0.5 * float(torch.sum(d_obs * d_obs))
                    vlabel = "obs energy"   # no residual in forward mode
                    g = torch.zeros(1, dtype=dtype)
                else:
                    with torch.no_grad():
                        d_obs = p.simulate(c2_true)
                    compile_s, best, (val, g) = time_fn(p.misfit_and_grad,
                                                        c2_hom, d_obs)
                    vlabel = "misfit"
            except Exception as e:  # noqa: BLE001 - report OOM and move on
                kind = type(e).__name__
                msg = str(e).splitlines()[0][:100]
                print(f"nel={args.nel} steps={n_steps:>6} {mode:>8}:"
                      f"  FAILED ({kind}: {msg})")
                rows.append((n_steps, mode, None, None))
                del p
                if on_card:
                    torch.cuda.empty_cache()
                continue
            grads[mode] = g.double().cpu().numpy()
            unit = "s/fwd" if args.forward_only else "s/grad"
            print(f"nel={args.nel} steps={n_steps:>6} {mode:>8}:"
                  f"  {best:8.3f} {unit}  (first call {compile_s:.1f} s,"
                  f"  {vlabel} {float(val):.6e})")
            rows.append((n_steps, mode, best, float(val)))
            del p, d_obs, g
            if on_card:
                torch.cuda.empty_cache()
        if len(grads) >= 2 and not args.forward_only:
            base_mode = next(iter(grads))
            a = grads[base_mode]
            na = np.linalg.norm(a)
            for other, b in list(grads.items())[1:]:
                if na == 0.0:
                    print("              grad agreement: base grad is zero "
                          "(wavefront has not reached anomaly+receivers)")
                    break
                rel = np.linalg.norm(a - b) / na
                print(f"              grad agreement {base_mode} vs "
                      f"{other}: rel l2 diff {rel:.3e}")

    header = "".join(f"{m:>16}" for m in args.modes)
    print(f"\nsteps  s/grad:{header}")
    by = {}
    for n_steps, mode, best, _ in rows:
        by.setdefault(n_steps, {})[mode] = best
    for n_steps in args.steps:
        r = by.get(n_steps, {})
        fmt = lambda v: f"{v:16.3f}" if v is not None else "             OOM"
        print(f"{n_steps:>6} " + "".join(fmt(r.get(m)) for m in args.modes))
    return 0


if __name__ == "__main__":
    sys.exit(main())
