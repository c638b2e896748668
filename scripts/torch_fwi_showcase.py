#!/usr/bin/env python3
"""Production-style FWI showcase on the PyTorch / CUDA port: a layered
earth with a fault and a low-velocity lens, imaged from a surface and
crosswell acquisition (scripts/fwi_showcase.py's twin).

The same flags and defaults as fwi_showcase.py, with ``--engine kernel``
(the fused CUDA kernels B14-B17) where it says ``pallas`` (``auto``: the
kernel engine on a CUDA device, the stencil engine on the CPU; float32
on a CUDA device, float64 on the CPU, as fwi_showcase.py picks float32
on the TPU), and ``--device`` (default cuda). The same model, sponge
boundaries, multiscale inversion (L-BFGS by default) and printed lines.

The arrays (true, initial and recovered c2, the misfit history, the
stage lengths) always go to an .npz beside ``--out``; the 4-panel figure
is drawn where matplotlib imports, and the script says so where it
does not.

CPU smoke:  python scripts/torch_fwi_showcase.py --device cpu --nel 32 \
            --steps 120
Card run:   python scripts/torch_fwi_showcase.py --nel 384 --steps 1200
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def parse_args():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nel", type=int, default=96)
    ap.add_argument("--steps", type=int, default=360)
    ap.add_argument("--dt", type=float, default=None,
                    help="default: 0.35 * h (CFL-safe at c_max ~ 1.35)")
    ap.add_argument("--shots", type=int, default=6)
    ap.add_argument("--receivers", type=int, default=24)
    ap.add_argument("--iters", type=int, nargs="+", default=[20, 30],
                    help="iterations per multiscale stage (last stage is "
                         "full band)")
    ap.add_argument("--lr", type=float, default=0.03)
    ap.add_argument("--sponge", type=float, default=0.08)
    ap.add_argument("--reg", type=float, default=1e-3)
    ap.add_argument("--engine", choices=("auto", "stencil", "kernel"),
                    default="auto")
    ap.add_argument("--optimizer", choices=("adam", "lbfgs"),
                    default="lbfgs",
                    help="lbfgs (default): zoom line search avoids the "
                         "uniform-drift bias Adam shows on this "
                         "reflection geometry")
    ap.add_argument("--precondition", choices=("", "illumination"),
                    default="", help="gradient preconditioner (default "
                    "off: with a wide-aperture acquisition Adam's "
                    "per-coordinate normalisation is enough, and the "
                    "1/illumination boost amplifies noise in "
                    "unconstrained deep cells)")
    ap.add_argument("--out", default="analysis/figures/fwi_showcase.png")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args()


def layered_model(prob, np):
    """True c2: three layers + a dipping fault throw + a slow lens."""
    cent = prob.mesh.vertex_coords[np.asarray(prob.mesh.cells)].mean(axis=1)
    x, depth = cent[:, 0], 1.0 - cent[:, 1]      # y=1 is the "surface"
    # faulted interfaces: 0.08 of throw across x = 0.55
    throw = 0.08 * (x > 0.55)
    c2 = np.full(prob.n_cells, 1.0)
    c2[depth > 0.38 + throw] = 1.35
    c2[depth > 0.68 + throw] = 1.8
    # low-velocity lens (gas-cloud stand-in) on the upthrown side
    lens = ((x - 0.38) ** 2 / 0.14 ** 2
            + (depth - 0.52) ** 2 / 0.09 ** 2) < 1.0
    c2[lens] *= 0.72
    return c2


def cells_to_image(prob, c2, np):
    """(n_cells,) -> (ny, nx) grid image (mean of the 2 triangles/cell),
    flipped so row 0 is the surface (y = 1)."""
    nx, ny = prob.mesh.nx, prob.mesh.ny
    img = np.asarray(c2).reshape(ny, nx, 2).mean(axis=2)
    return img[::-1]


def main():
    args = parse_args()
    import numpy as np
    import torch
    from tpuwave_torch.config import resolve_device
    from tpuwave_torch.models.inverse import FwiProblem

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    engine = args.engine
    if engine == "auto":
        engine = "kernel" if on_card else "stencil"
    dt = args.dt if args.dt else 0.35 / args.nel

    # acquisition just inside the sponge: a surface spread plus two
    # borehole strings (left/right), the standard surface+crosswell
    # configuration that constrains reflectors AND transmission paths
    ysurf = 1.0 - args.sponge - 0.03
    xw = args.sponge + 0.03
    n3 = args.receivers // 3
    recs = [(x, ysurf) for x in np.linspace(0.12, 0.88, n3)]
    recs += [(xw, y) for y in np.linspace(0.15, 0.85, n3)]
    recs += [(1.0 - xw, y) for y in np.linspace(0.15, 0.85, n3)]
    p = FwiProblem((args.nel, args.nel), ((0.0, 0.0), (1.0, 1.0)),
                   dt, args.steps, source=(0.5, ysurf), receivers=recs,
                   dtype=torch.float32 if on_card else torch.float64,
                   device=device, sponge_width=args.sponge, engine=engine,
                   adjoint="reversal", boundary_save="ring",
                   interp_receivers=False)
    srcs = p.snap_vertices(
        [(x, ysurf) for x in np.linspace(0.15, 0.85, args.shots)])

    c2_true = torch.tensor(layered_model(p, np), dtype=p.dtype,
                           device=device)
    # initial model: the correct background gradient but no fault/lens —
    # a smooth 1D profile (the classic FWI starting point)
    cent = p.mesh.vertex_coords[np.asarray(p.mesh.cells)].mean(axis=1)
    depth = 1.0 - cent[:, 1]
    c2_init = torch.tensor(1.0 + 0.8 * np.clip((depth - 0.3) / 0.5, 0, 1),
                           dtype=p.dtype, device=device)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    print(f"{args.nel}x{args.nel} cells={p.n_cells} steps={args.steps} "
          f"dt={dt:.2e} shots={args.shots} engine={engine} "
          f"backend={device.type}")
    t0 = time.perf_counter()
    with torch.no_grad():
        d_obs = p.simulate_shots(c2_true, srcs)
    sync()
    print(f"observed data simulated in {time.perf_counter() - t0:.1f}s "
          f"(gather {tuple(d_obs.shape)})")

    # multiscale cutoffs from the wavelet's peak frequency
    f_peak = 1.0 / (20 * dt)
    cutoffs = [0.6 * f_peak, None]
    t0 = time.perf_counter()
    res = p.invert_multiscale(
        d_obs, c2_init, cutoffs=cutoffs, n_iter=args.iters,
        learning_rate=args.lr, bounds=(0.5, 2.2), sources=srcs,
        optimizer=args.optimizer,
        reg_lambda=args.reg, precondition=args.precondition or None,
        verbose=True)
    sync()
    dt_wall = time.perf_counter() - t0
    n_total = sum(args.iters)
    print(f"{n_total} iterations in {dt_wall:.1f}s "
          f"({dt_wall / n_total * 1e3:.0f} ms/iter incl. both stages)")

    phys = torch.as_tensor(p.sponge_interior_cell_mask, device=device)
    e0 = float(torch.linalg.vector_norm((c2_init - c2_true)[phys]))
    e1 = float(torch.linalg.vector_norm((res.c2 - c2_true)[phys]))
    print(f"model error (physical cells): {e0:.4f} -> {e1:.4f} "
          f"({e0 / max(e1, 1e-30):.2f}x down)")
    with torch.no_grad():
        m0 = float(p.misfit_shots(c2_init, srcs, d_obs))
    print(f"misfit {m0:.3e} -> {res.misfits[-1]:.3e}")

    host = {name: c2.double().cpu().numpy()
            for name, c2 in (("c2_true", c2_true), ("c2_init", c2_init),
                             ("c2_recovered", res.c2))}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    npz = out.with_suffix(".npz")
    np.savez(npz, misfits=res.misfits, iters=np.asarray(args.iters),
             **host)
    print(f"arrays written to {npz}")

    # ---- figure ---------------------------------------------------------
    try:
        import matplotlib
    except ImportError:
        print("matplotlib is not installed: no figure (the arrays are in "
              f"{npz})")
        return 0
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    imgs = {name: cells_to_image(p, host[key], np)
            for name, key in (("True model", "c2_true"),
                              ("Initial model", "c2_init"),
                              ("Recovered (FWI)", "c2_recovered"))}
    vmin = min(im.min() for im in imgs.values())
    vmax = max(im.max() for im in imgs.values())
    fig, axes = plt.subplots(2, 2, figsize=(10.5, 8.2))
    fig.suptitle("Full-waveform inversion: faulted layered earth with a "
                 "low-velocity lens", fontsize=12)
    for ax, (name, im) in zip(axes.flat[:3], imgs.items()):
        h = ax.imshow(im, cmap="viridis", vmin=vmin, vmax=vmax,
                      extent=(0, 1, 1, 0), aspect="auto")
        ax.set_title(name, fontsize=10)
        ax.set_xlabel("x")
        ax.set_ylabel("depth")
        fig.colorbar(h, ax=ax, shrink=0.85, label="c²")
    ax = axes.flat[3]
    it = np.arange(1, len(res.misfits) + 1)
    ax.semilogy(it, res.misfits, lw=2, color="#3b6fb6")
    ax.axvline(args.iters[0] + 0.5, lw=1, ls="--", color="#999999")
    ax.text(args.iters[0] + 1, res.misfits.max(), " full band",
            fontsize=8, color="#666666", va="top")
    ax.set_title("Multiscale misfit history", fontsize=10)
    ax.set_xlabel("iteration")
    ax.set_ylabel("misfit")
    ax.grid(True, alpha=0.25, lw=0.5)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    fig.tight_layout()
    fig.savefig(out, dpi=140)
    print(f"figure written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
