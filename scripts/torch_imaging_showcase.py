#!/usr/bin/env python3
"""Linearized-imaging showcase on the PyTorch / CUDA port: RTM against
least-squares RTM of a dipping reflector and point diffractors under a
surface acquisition (scripts/imaging_showcase.py's twin).

The same flags and defaults as imaging_showcase.py, and ``--device``
(default cuda; ``--dtype`` defaults to f32 on a CUDA device and f64 on
the CPU, as imaging_showcase.py picks f32 on the TPU). The same smooth
background, reflectivity, Born data and printed lines, through
tpuwave_torch's FwiProblem (stencil engine, reversal adjoint, ring
sponge): born (the linearized step loop), rtm_image and lsrtm (CGLS).

The arrays (true reflectivity, the RTM and LSRTM images, the CGLS
residual norms) always go to an .npz beside ``--out``; the 4-panel
figure is drawn where matplotlib imports, and the script says so where
it does not.

CPU smoke:  python scripts/torch_imaging_showcase.py --device cpu
Card run:   python scripts/torch_imaging_showcase.py --nel 256 --steps 800
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def parse_args():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nel", type=int, default=64)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--dt", type=float, default=None,
                    help="default: 0.35 * h")
    ap.add_argument("--shots", type=int, default=5)
    ap.add_argument("--receivers", type=int, default=24)
    ap.add_argument("--lsrtm-iters", type=int, default=10)
    ap.add_argument("--sponge", type=float, default=0.08)
    ap.add_argument("--dtype", choices=("f32", "f64"), default=None,
                    help="default: f32 on a CUDA device, f64 elsewhere")
    ap.add_argument("--out", default="analysis/figures/imaging_showcase.png")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args()


def reflectivity_model(prob, np):
    """True dm: a dipping reflector segment + two point diffractors."""
    cent = prob.mesh.vertex_coords[np.asarray(prob.mesh.cells)].mean(axis=1)
    x, depth = cent[:, 0], 1.0 - cent[:, 1]
    dm = np.zeros(prob.n_cells)
    # dipping reflector: depth = 0.45 + 0.2 (x - 0.2) over x in [0.2, 0.7]
    line = 0.45 + 0.2 * (x - 0.2)
    h = 1.0 / prob.mesh.nx
    on = (np.abs(depth - line) < 0.8 * h) & (x > 0.2) & (x < 0.7)
    dm[on] = 0.15
    for px, pd in ((0.8, 0.35), (0.35, 0.7)):
        dm[((x - px) ** 2 + (depth - pd) ** 2) < (1.5 * h) ** 2] = 0.2
    return dm


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
    dtype = args.dtype or ("f32" if on_card else "f64")
    dt = args.dt if args.dt else 0.35 / args.nel
    ysurf = 1.0 - args.sponge - 0.03
    recs = [(x, ysurf) for x in np.linspace(0.1, 0.9, args.receivers)]
    p = FwiProblem((args.nel, args.nel), ((0.0, 0.0), (1.0, 1.0)),
                   dt, args.steps, source=(0.5, ysurf), receivers=recs,
                   dtype=torch.float64 if dtype == "f64" else torch.float32,
                   device=device, sponge_width=args.sponge,
                   engine="stencil", adjoint="reversal",
                   boundary_save="ring")
    srcs = p.snap_vertices(
        [(x, ysurf) for x in np.linspace(0.15, 0.85, args.shots)])

    # smooth kinematic background + the unknown reflectivity on top
    cent = p.mesh.vertex_coords[np.asarray(p.mesh.cells)].mean(axis=1)
    depth = 1.0 - cent[:, 1]
    c2_bg = torch.tensor(1.0 + 0.6 * np.clip((depth - 0.2) / 0.6, 0, 1),
                         dtype=p.dtype, device=device)
    dm_true = torch.tensor(reflectivity_model(p, np), dtype=p.dtype,
                           device=device)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    print(f"{args.nel}x{args.nel} cells={p.n_cells} steps={args.steps} "
          f"dt={dt:.2e} shots={args.shots} dtype={dtype} "
          f"backend={device.type}")
    t0 = time.perf_counter()
    d = p.born(c2_bg, dm_true, sources=srcs)
    sync()
    print(f"Born data modeled in {time.perf_counter() - t0:.1f}s "
          f"(gather {tuple(d.shape)})")

    t0 = time.perf_counter()
    rtm = p.rtm_image(c2_bg, d, sources=srcs)
    sync()
    print(f"RTM image in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    m_ls, norms = p.lsrtm(c2_bg, d, n_iter=args.lsrtm_iters, sources=srcs,
                          verbose=True)
    sync()
    print(f"LSRTM ({args.lsrtm_iters} CGLS iters) in "
          f"{time.perf_counter() - t0:.1f}s; data residual "
          f"{norms[0]:.3e} -> {norms[-1]:.3e} "
          f"({norms[0] / max(norms[-1], 1e-300):.1f}x down)")

    def corr(a, b):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)
                              + 1e-300))

    host = {name: x.double().cpu().numpy()
            for name, x in (("dm_true", dm_true), ("rtm", rtm),
                            ("lsrtm", m_ls))}
    phys = np.asarray(p.sponge_interior_cell_mask)
    print(f"image-reflectivity correlation (physical cells): "
          f"RTM {corr(host['rtm'][phys], host['dm_true'][phys]):.3f}"
          f", LSRTM "
          f"{corr(host['lsrtm'][phys], host['dm_true'][phys]):.3f}")

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    npz = out.with_suffix(".npz")
    np.savez(npz, residual_norms=norms, **host)
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

    panels = (("True reflectivity", host["dm_true"], "RdBu_r"),
              ("RTM (illum.-normalized adjoint)", host["rtm"], "RdBu_r"),
              (f"LSRTM ({args.lsrtm_iters} CGLS iters)", host["lsrtm"],
               "RdBu_r"))
    fig, axes = plt.subplots(2, 2, figsize=(10.5, 8.2))
    fig.suptitle("Linearized imaging: RTM vs least-squares RTM",
                 fontsize=12)
    for ax, (name, field, cmap) in zip(axes.flat[:3], panels):
        im = cells_to_image(p, field, np)
        lim = float(np.abs(im).max()) or 1.0
        h = ax.imshow(im, cmap=cmap, vmin=-lim, vmax=lim,
                      extent=(0, 1, 1, 0), aspect="auto")
        ax.set_title(name, fontsize=10)
        ax.set_xlabel("x")
        ax.set_ylabel("depth")
        fig.colorbar(h, ax=ax, shrink=0.85, label="δc²")
    ax = axes.flat[3]
    ax.semilogy(np.arange(len(norms)), norms, lw=2, color="#3b6fb6",
                marker="o", ms=3)
    ax.set_title("LSRTM data-residual history", fontsize=10)
    ax.set_xlabel("CGLS iteration")
    ax.set_ylabel(r"$\|d - Lm\|$")
    ax.grid(True, alpha=0.25, lw=0.5)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    fig.tight_layout()
    fig.savefig(out, dpi=140)
    print(f"figure written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
