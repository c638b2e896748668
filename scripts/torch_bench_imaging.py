#!/usr/bin/env python3
"""Benchmark the encoded-source and linearized-imaging paths of the
PyTorch / CUDA port on one card (scripts/bench_imaging.py's twin).

The same flags and defaults as bench_imaging.py, and ``--device``
(default cuda). Three measurements over an S-shot surface acquisition
(tpuwave_torch/models/inverse.py, stencil engine, reversal adjoint):

1. ``sequential``: the gradient of one shot's misfit, times S: the
   classic gradient, S propagation pairs per evaluation;
2. ``encoded``: the gradient of ``misfit_encoded``, the supershot of
   Krebs et al. 2009: one propagation pair whatever S;
3. ``lsrtm-iter``: one CGLS iteration of least-squares RTM, one Born
   modelling (the step loop's tangent recurrence) and one migration (the
   reversal VJP) per shot, times S.

Each is timed as bench_imaging.py times it: a first call (reported as
"compile", which here is the first-use cost), then the best of
``--repeats`` calls, host clock around a synchronize.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def parse_args():
    p = argparse.ArgumentParser(description="encoded/imaging FWI bench")
    p.add_argument("--nel", type=int, default=512)
    p.add_argument("--dt", type=float, default=4e-4)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--shots", type=int, default=8)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    p.add_argument("--modes", nargs="+",
                   default=["sequential", "encoded", "lsrtm-iter"],
                   choices=["sequential", "encoded", "lsrtm-iter"])
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
    n = args.nel
    recs = [(x, 0.9) for x in np.linspace(0.1, 0.9, 9)]
    p = FwiProblem((n, n), geom, args.dt, args.steps,
                   source=(0.5, 0.1), receivers=recs,
                   engine="stencil", adjoint="reversal", device=device,
                   dtype=torch.float64 if args.dtype == "f64"
                   else torch.float32)
    srcs = p.snap_vertices([(x, 0.1)
                            for x in np.linspace(0.1, 0.9, args.shots)])
    rng = np.random.default_rng(0)
    c2 = torch.tensor(1.0 + 0.05 * rng.random(p.n_cells), dtype=p.dtype,
                      device=device)
    dm = torch.tensor(rng.normal(size=p.n_cells), dtype=p.dtype,
                      device=device)
    print(f"{n}x{n} grid ({p.n_vertices/1e6:.2f}M vertices), "
          f"{args.steps} steps, {args.shots} shots, {args.dtype}")
    m_true = torch.full((p.n_cells,), 1.1, dtype=p.dtype, device=device)
    with torch.no_grad():
        obs = p.simulate_shots(m_true, srcs)
    codes = torch.tensor(rng.choice([-1.0, 1.0], args.shots), dtype=p.dtype,
                         device=device)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def timeit(f, *xs):
        t0 = time.perf_counter()
        f(*xs)
        sync()
        compile_s = time.perf_counter() - t0
        best = float("inf")
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            f(*xs)
            sync()
            best = min(best, time.perf_counter() - t0)
        return best, compile_s

    def value_and_grad(loss):
        def f(m, *rest):
            m = m.detach().requires_grad_(True)
            with torch.enable_grad():
                val = loss(m, *rest)
                (g,) = torch.autograd.grad(val, m)
            return val.detach(), g
        return f

    results = {}
    if "sequential" in args.modes:
        # one-shot gradient x S: the cost of classic shot-by-shot FWI
        f = value_and_grad(lambda m: p.misfit(m, obs[0], wavelet=p.wavelet))
        s1, cs = timeit(f, c2)
        s = s1 * args.shots
        results["sequential"] = s
        print(f"sequential grad: {s1:.3f} s/shot x {args.shots} shots "
              f"= {s:.3f} s (compile {cs:.1f} s)")
    if "encoded" in args.modes:
        f = value_and_grad(lambda m, cd: p.misfit_encoded(m, srcs, cd, obs))
        s, cs = timeit(f, c2, codes)
        results["encoded"] = s
        print(f"encoded grad (1 supershot): {s:.3f} s "
              f"(compile {cs:.1f} s)")
    if "lsrtm-iter" in args.modes:
        # per-shot Born and migration (the data map is additive over
        # shots, so production LSRTM runs a shot loop and accumulates)
        sb, cb = timeit(p.born, c2, dm)
        sm, cm = timeit(p.migrate, c2, obs[0])
        tot = (sb + sm) * args.shots
        results["lsrtm-iter"] = tot
        print(f"born {sb:.3f} s + migrate {sm:.3f} s per shot x "
              f"{args.shots} shots = {tot:.3f} s / CGLS iter "
              f"(compile {cb:.0f}+{cm:.0f} s)")
    if "sequential" in results and "encoded" in results:
        print(f"encoding speedup: "
              f"{results['sequential'] / results['encoded']:.2f}x "
              f"(ideal {args.shots}x)")


if __name__ == "__main__":
    main()
