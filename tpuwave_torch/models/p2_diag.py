"""O(grid) diagnostics surface for the P2 product engine.

Counterpart of tpuwave's models/p2_diag.py: everything the run driver
needs (models/runner.py) reduces to plane arithmetic on the four P2
sub-grids of ops/stencil_p2.py (V vertices, H/W/D edge midpoints):

* interpolation = expression evaluation at plane coordinates,
* the energy quadratic forms = per-class (6, 6) element matrices
  contracted against 6 plane windows (with a varying c, u^T K u with K
  the varcoef stencil frozen at t = 0, as the reference freezes it for the
  energy),
* the L2/H1 errors = the r+2 rule (gauss_simplex(4)) with q-DEPENDENT
  per-class P2 gradients,
* the probe = closed-form cell/plane indexing.

State vectors are flat (n_dofs,) in the core/mesh.py numbering. Semantics
match tpuwave's P2GridDiagnostics to summation-order roundoff (identical
element matrices and quadrature; reference WaveEquationBase.cpp:148-222
energy/probe, :367-423 errors with the r+2 rule and the 1e-14 relative
guard).
"""

from __future__ import annotations

import numpy as np
import torch

from tpuwave_torch.core.mesh import FeSpace, StructuredTriMesh
from tpuwave_torch.core.quadrature import gauss_simplex
from tpuwave_torch.core.shape import simplex_shape
from tpuwave_torch.models.grid_diag import GridDiagnostics, _partial
from tpuwave_torch.ops.assembly import (element_mass_class,
                                        element_stiffness_class)
from tpuwave_torch.ops.stencil import P1_CLASS_CORNERS
from tpuwave_torch.ops.stencil_p2 import (_P2_POSITIONS, _PLANES,
                                          P2VarcoefStencil, flat_to_planes,
                                          p2_plane_shapes, p2_varcoef_data,
                                          p2_varcoef_scales)
from tpuwave_torch.utils.params import Params

__all__ = ["P2GridDiagnostics", "P2_PLANE_OFFS", "p2_plane_offsets",
           "p2_plane_coords", "p2_interpolate_flat"]

#: per-plane support-point offsets within the unit grid cell
P2_PLANE_OFFS = {"V": (0.0, 0.0), "H": (0.5, 0.0), "W": (0.0, 0.5),
                 "D": (0.5, 0.5)}


def p2_plane_offsets(nx: int, ny: int):
    """Flat start offset of each plane in the P2 DoF vector (plane order
    V, H, W, D = the core.mesh numbering: vertices, h/v/d edges)."""
    shapes = p2_plane_shapes(nx, ny)
    out, off = {}, 0
    for p in _PLANES:
        out[p] = off
        r, c = shapes[p]
        off += r * c
    return out


def p2_plane_coords(mesh: StructuredTriMesh, dtype, device):
    """Per-plane (x, y) coordinate tensors."""
    (x0, y0) = mesh.origin
    hx, hy = mesh.hx, mesh.hy
    out = {}
    for p, (r, c) in p2_plane_shapes(mesh.nx, mesh.ny).items():
        ox, oy = P2_PLANE_OFFS[p]
        ci = torch.arange(c, dtype=dtype, device=device)[None, :]
        ri = torch.arange(r, dtype=dtype, device=device)[:, None]
        out[p] = ((x0 + hx * (ci + ox)).expand(r, c),
                  (y0 + hy * (ri + oy)).expand(r, c))
    return out


def p2_interpolate_flat(mesh: StructuredTriMesh, expr, t, dtype, device):
    """Nodal interpolation of ``expr`` on the flat P2 DoF vector
    (VectorTools::interpolate at the vertex and edge-midpoint support
    points, reference WaveTheta.cpp:352-353), O(grid)."""
    shapes = p2_plane_shapes(mesh.nx, mesh.ny)
    if expr.is_zero:
        n = sum(r * c for r, c in shapes.values())
        return torch.zeros(n, dtype=dtype, device=device)
    parts = []
    for p, (xs, ys) in p2_plane_coords(mesh, dtype, device).items():
        vals = torch.broadcast_to(expr.evaluate(xs, ys, t).to(dtype),
                                  shapes[p])
        parts.append(vals.reshape(-1))
    return torch.cat(parts)


class P2GridDiagnostics:
    """The runner-facing diagnostics of a P2 structured rectangle run, on
    tensors of ``dtype`` on ``device``."""

    def __init__(self, params: Params, *, dtype: torch.dtype,
                 device: torch.device):
        if params.r != 2:
            raise ValueError("P2GridDiagnostics needs R = 2")
        self.params = params
        self.mesh = StructuredTriMesh(params.nel, params.geometry)
        self.dtype = dtype
        self.device = torch.device(device)
        nx, ny = self.mesh.nx, self.mesh.ny
        self.shapes = p2_plane_shapes(nx, ny)
        self.space = FeSpace(self.mesh, 2)
        self.n_dofs = self.n_vec = self.space.n_dofs

        quad = gauss_simplex(3)                     # assembly rule r + 1
        self._m_class = np.asarray(element_mass_class(self.space, quad))
        c_const = params.c.constant_value
        if c_const is not None:
            self._k_class = np.asarray(
                element_stiffness_class(self.space, quad, c_const ** 2))
        else:
            self._k_class = None
        #: varcoef: K frozen at t = 0 as a P2VarcoefStencil, built at the
        #: first energy call
        self._k_frozen = None

        # probe: containing cell + P2 basis at the domain centre
        # (reference VectorTools::point_value, WaveEquationBase.cpp:170-222)
        cell, ref = self.mesh.locate_point(self.mesh.center)
        k = cell % 2
        ci = (cell // 2) % nx
        cj = (cell // 2) // nx
        offs = p2_plane_offsets(nx, ny)
        dofs = []
        for pa, (ox, oy) in _P2_POSITIONS[k]:
            ncols = self.shapes[pa][1]
            dofs.append(offs[pa] + (cj + oy) * ncols + (ci + ox))
        self._probe_dofs = torch.tensor(dofs, dtype=torch.long,
                                        device=self.device)
        self._probe_vals = torch.tensor(
            simplex_shape(2, np.asarray(ref, dtype=np.float64)).values[0],
            dtype=dtype, device=self.device)
        self._sol = params.solution
        self._err_cache = None

    # -- interpolation / IO views ---------------------------------------
    def interpolate(self, expr, t=0.0):
        return p2_interpolate_flat(self.mesh, expr, t, self.dtype,
                                   self.device)

    def vertex_values(self, u):
        """Host numpy copy of the vertex values (plane V comes first in
        the DoF numbering)."""
        return u[:self.mesh.n_vertices].detach().cpu().numpy()

    @property
    def has_forcing(self) -> bool:
        return not self.params.f.is_zero

    # -- quadratic forms (energy) ---------------------------------------
    def _windows(self, planes, k):
        """The 6 per-cell local-DoF windows of class ``k``: window[a] has
        shape (ny, nx) with entry (cj, ci) = the value of local DoF a of
        the class-k triangle of grid cell (ci, cj)."""
        ny, nx = self.mesh.ny, self.mesh.nx
        return [planes[pa][oy:oy + ny, ox:ox + nx]
                for pa, (ox, oy) in _P2_POSITIONS[k]]

    @staticmethod
    def _quad_form_class(win, a_kij):
        """sum_cells w^T A_k w for one class with constant (6, 6) A."""
        acc = None
        for i in range(6):
            for j in range(6):
                a = float(a_kij[i, j])
                if a == 0.0:
                    continue
                term = a * (win[i] * win[j])
                acc = term if acc is None else acc + term
        return torch.sum(acc)

    def energy(self, u, v):
        """E = 1/2 (v^T M v + u^T K u) (reference WaveEquationBase.cpp:
        148-154; K contains c^2, frozen at t = 0 like the reference).
        0-d tensor."""
        nx, ny = self.mesh.nx, self.mesh.ny
        u = u.to(self.dtype)
        up = flat_to_planes(u, nx, ny)
        vp = flat_to_planes(v.to(self.dtype), nx, ny)
        em = ek = torch.zeros((), dtype=self.dtype, device=self.device)
        for k in range(2):
            em = em + self._quad_form_class(self._windows(vp, k),
                                            self._m_class[k])
            if self._k_class is not None:
                ek = ek + self._quad_form_class(self._windows(up, k),
                                                self._k_class[k])
        if self._k_class is None:
            ek = torch.dot(u, self._frozen_k()(u))
        return 0.5 * (em + ek)

    def _frozen_k(self) -> P2VarcoefStencil:
        if self._k_frozen is None:
            G, frac, w, det = p2_varcoef_data(self.space, gauss_simplex(3))
            scales = p2_varcoef_scales(self.mesh, self.params.c, 0.0, frac,
                                       w, det, self.dtype, self.device)
            self._k_frozen = P2VarcoefStencil(self.space, scales, G,
                                              self.dtype)
        return self._k_frozen

    # -- probe ----------------------------------------------------------
    def probe(self, u):
        return torch.dot(u[self._probe_dofs], self._probe_vals)

    # -- errors (r+2 rule, 1e-14 guard; WaveEquationBase.cpp:367-423) ---
    def _err_data(self):
        if self._err_cache is None:
            quad = gauss_simplex(4)                      # r + 2 = 4
            sh = self.space.shape_at(quad)
            vals = np.asarray(sh.values)                 # (Q2, 6)
            grads = np.asarray(self.space.physical_grads(sh))  # (2,Q2,6,2)
            ref = np.asarray(quad.points)
            frac = np.empty((2, len(ref), 2))
            for k in range(2):
                c0, c1, c2_ = (np.asarray(c, float)
                               for c in P1_CLASS_CORNERS[k])
                frac[k] = (c0[None]
                           + ref[:, 0:1] * (c1 - c0)[None]
                           + ref[:, 1:2] * (c2_ - c0)[None])
            self._err_cache = (vals, grads, frac,
                               np.asarray(quad.weights)
                               * float(self.mesh.det_j))
        return self._err_cache

    def errors(self, u, t):
        """(L2, H1, rel L2, rel H1) errors against the exact solution, as
        0-d tensors; the exact gradient is a forward-mode derivative of
        the solution expression."""
        vals, grads, frac, w = self._err_data()
        sol = self._sol
        ny, nx = self.mesh.ny, self.mesh.nx
        (x0, y0) = self.mesh.origin
        hx, hy = self.mesh.hx, self.mesh.hy
        ix = torch.arange(nx, dtype=self.dtype,
                          device=self.device)[None, :].expand(ny, nx)
        iy = torch.arange(ny, dtype=self.dtype,
                          device=self.device)[:, None].expand(ny, nx)
        up = flat_to_planes(u.to(self.dtype), nx, ny)

        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        l2_sq = semi_sq = ex_l2_sq = ex_semi_sq = zero
        for k in range(2):
            win = self._windows(up, k)
            for q in range(frac.shape[1]):
                fx, fy = float(frac[k, q, 0]), float(frac[k, q, 1])
                xs = x0 + (ix + fx) * hx
                ys = y0 + (iy + fy) * hy
                uh = sum(float(vals[q, a]) * win[a] for a in range(6))
                # P2 gradients are q-dependent: contract per (k, q)
                guh_x = sum(float(grads[k, q, a, 0]) * win[a]
                            for a in range(6))
                guh_y = sum(float(grads[k, q, a, 1]) * win[a]
                            for a in range(6))
                uex = torch.broadcast_to(sol.evaluate(xs, ys, t), (ny, nx))
                gex_x = _partial(lambda a: sol.evaluate(a, ys, t), xs)
                gex_y = _partial(lambda a: sol.evaluate(xs, a, t), ys)
                wq = float(w[q])
                l2_sq = l2_sq + wq * torch.sum((uh - uex) ** 2)
                semi_sq = semi_sq + wq * torch.sum(
                    (guh_x - gex_x) ** 2 + (guh_y - gex_y) ** 2)
                ex_l2_sq = ex_l2_sq + wq * torch.sum(uex ** 2)
                ex_semi_sq = ex_semi_sq + wq * torch.sum(
                    gex_x ** 2 + gex_y ** 2)

        err_l2 = torch.sqrt(l2_sq)
        err_h1 = torch.sqrt(l2_sq + semi_sq)
        ex_l2 = torch.sqrt(ex_l2_sq)
        ex_h1 = torch.sqrt(ex_l2_sq + ex_semi_sq)
        rel_l2 = torch.where(ex_l2 < 1e-14, err_l2, err_l2 / ex_l2)
        rel_h1 = torch.where(ex_h1 < 1e-14, err_h1, err_h1 / ex_h1)
        return err_l2, err_h1, rel_l2, rel_h1

    # -- divergence guard (WaveEquationBase.cpp:425-431) ----------------
    check_divergence = staticmethod(GridDiagnostics.check_divergence)
