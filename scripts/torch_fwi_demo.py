#!/usr/bin/env python3
"""Full-waveform-inversion demo on the PyTorch / CUDA port: recover a
buried low-velocity anomaly (scripts/fwi_demo.py's twin).

The same flags and defaults as fwi_demo.py, with ``--engine kernel``
(the fused CUDA kernels B14-B17, which imply the reversal adjoint) where
fwi_demo.py says ``pallas``, and ``--device`` (default cuda). The same
acquisition, anomaly and printed lines; the descent runs through
tpuwave_torch's FwiProblem (models/inverse.py): Adam or L-BFGS,
multiscale, source estimation, encoded supershots (codes from key 0,
utils/prng.py) and checkpoint / resume.

Usage:
    python scripts/torch_fwi_demo.py [--nel 32] [--steps 160] [--iters 60]
                                     [--device cuda] [--out /tmp/fwi]
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nel", type=int, default=32)
    ap.add_argument("--steps", type=int, default=160)
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--dt", type=float, default=0.006)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--sponge", type=float, default=0.0,
                    help="absorbing sponge layer width (0 = hard walls)")
    ap.add_argument("--shots", type=int, default=1,
                    help=">1: multi-shot acquisition (a loop over shots)")
    ap.add_argument("--engine",
                    choices=("scatter", "grid", "stencil", "kernel"),
                    default="stencil",
                    help="stiffness engine (kernel = the fused CUDA "
                         "kernels, implies --adjoint reversal)")
    ap.add_argument("--adjoint", choices=("remat", "reversal"),
                    default="remat",
                    help="reversal = O(1)-memory time-reversed adjoint "
                         "(needs --engine stencil/kernel; with a sponge "
                         "it switches to boundary saving)")
    ap.add_argument("--boundary-save", choices=("strip", "ring"),
                    default="strip",
                    help="reversal+sponge storage: every damped vertex "
                         "(exact everywhere) or just the interface ring "
                         "(O(perimeter) memory, exact on the physical "
                         "region; required for --engine kernel)")
    ap.add_argument("--dtype", choices=("f32", "f64"), default="f64",
                    help="f32 for speed, f64 (default) for parity")
    ap.add_argument("--multiscale", type=float, nargs="*", default=None,
                    metavar="HZ",
                    help="frequency-continuation cutoffs (Hz, ascending); "
                         "an unfiltered full-band stage is appended")
    ap.add_argument("--estimate-wavelet", action="store_true",
                    help="co-estimate the source wavelet (joint (c2, w) "
                         "descent; single-scale only)")
    ap.add_argument("--optimizer", choices=("adam", "lbfgs"),
                    default="adam",
                    help="lbfgs = zoom-linesearch quasi-Newton "
                         "(fewer iterations on smooth problems)")
    ap.add_argument("--encoded", action="store_true",
                    help="source-encoded simultaneous-source descent "
                         "(needs --shots > 1): each iteration fires ALL "
                         "shots in ONE propagation with fresh random ±1 "
                         "codes — ~shots× cheaper per iteration")
    ap.add_argument("--checkpoint", default="",
                    help="npz snapshot path: saved every 10 iterations; "
                         "an existing file resumes the descent "
                         "(single-scale only)")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()

    import numpy as np
    import torch
    from tpuwave_torch.models.inverse import FwiProblem

    # sources/receivers around the domain edge, anomaly in the middle
    recs = [(x, y) for x in (0.15, 0.5, 0.85) for y in (0.15, 0.85)]
    recs += [(0.15, 0.5), (0.85, 0.5)]
    adjoint = "reversal" if args.engine == "kernel" else args.adjoint
    extra = {}
    if args.engine == "kernel" and args.sponge > 0.0:
        args.boundary_save = "ring"   # the only fused-path flavour
    if args.sponge > 0.0 and adjoint == "reversal":
        extra["boundary_save"] = args.boundary_save
    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    p = FwiProblem((args.nel, args.nel), ((0.0, 0.0), (1.0, 1.0)),
                   args.dt, args.steps, source=(0.25, 0.5), receivers=recs,
                   sponge_width=args.sponge, engine=args.engine,
                   adjoint=adjoint, dtype=dtype, device=args.device, **extra)

    cent = p.mesh.vertex_coords[np.asarray(p.mesh.cells)].mean(axis=1)
    inside = np.sum((cent - [0.6, 0.5]) ** 2, axis=1) < 0.18 ** 2
    c2_true = torch.tensor(np.where(inside, 0.65, 1.0), dtype=dtype,
                           device=p.device)
    ones = torch.ones(p.n_cells, dtype=dtype, device=p.device)
    print(f"mesh {args.nel}x{args.nel} ({p.n_cells} cells, "
          f"{p.n_vertices} vertices), {args.steps} steps, "
          f"{len(recs)} receivers")

    with torch.no_grad():
        if args.shots > 1:
            ring = [(0.2 + 0.6 * k / max(args.shots - 1, 1), 0.2)
                    for k in range(args.shots)]
            srcs = p.snap_vertices(ring)
            d_obs = p.simulate_shots(c2_true, srcs)
            m0 = float(p.misfit_shots(ones, srcs, d_obs))
        else:
            srcs = None
            d_obs = p.simulate(c2_true)
            m0 = float(p.misfit(ones, d_obs))
    print(f"initial misfit (homogeneous start): {m0:.6e}")

    if args.encoded and (args.shots <= 1 or args.multiscale is not None
                         or args.estimate_wavelet or args.engine == "kernel"
                         or args.checkpoint or args.optimizer != "adam"):
        print("--encoded needs --shots > 1 and a plain single-scale "
              "adam run on a non-kernel engine", file=sys.stderr)
        return 1

    t0 = time.perf_counter()
    if args.encoded:
        res = p.invert_encoded(d_obs, ones, sources=srcs, key=0,
                               n_iter=args.iters, learning_rate=args.lr,
                               bounds=(0.3, 2.0), verbose=True)
        n_total = args.iters
    elif args.multiscale is not None:
        if args.estimate_wavelet:
            print("--estimate-wavelet is single-scale only", file=sys.stderr)
            return 1
        cutoffs = list(args.multiscale) + [None]
        res = p.invert_multiscale(d_obs, ones, cutoffs=cutoffs,
                                  n_iter=args.iters, learning_rate=args.lr,
                                  bounds=(0.3, 2.0), sources=srcs,
                                  optimizer=args.optimizer, verbose=True)
        n_total = args.iters * len(cutoffs)
    else:
        res = p.invert(d_obs, ones, n_iter=args.iters,
                       learning_rate=args.lr, bounds=(0.3, 2.0),
                       sources=srcs, estimate_wavelet=args.estimate_wavelet,
                       optimizer=args.optimizer,
                       checkpoint=args.checkpoint or None, verbose=True)
        n_total = args.iters
    if p.device.type == "cuda":
        torch.cuda.synchronize()
    dt_wall = time.perf_counter() - t0

    c2_rec = res.c2.double().cpu().numpy()
    delta = c2_rec - 1.0
    print(f"\n{n_total} {args.optimizer} iterations in {dt_wall:.2f}s "
          f"({dt_wall / n_total * 1e3:.1f} ms/iter, forward+adjoint)")
    # encoded misfits are a noisy supershot proxy; report the clean
    # full-acquisition objective for the final comparison
    if args.encoded:
        with torch.no_grad():
            m_last = float(p.misfit_shots(res.c2, srcs, d_obs))
    else:
        m_last = float(res.misfits[-1])
    ratio = m0 / max(m_last, 1e-300)
    trend = (f"{ratio:.3g}x down" if ratio >= 1.0
             else f"{1.0 / max(ratio, 1e-300):.3g}x UP - try more "
                  f"--iters or a smaller --lr")
    print(f"misfit {m0:.3e} -> {m_last:.3e} ({trend})")
    print(f"recovered anomaly: mean dc2 inside {delta[inside].mean():+.4f} "
          f"(true -0.35), outside {delta[~inside].mean():+.4f} (true 0)")

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        np.savez(os.path.join(args.out, "fwi_result.npz"),
                 c2_true=c2_true.double().cpu().numpy(), c2_recovered=c2_rec,
                 misfits=res.misfits, centroids=cent)
        print(f"arrays written to {args.out}/fwi_result.npz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
