"""O(grid) diagnostics surface for the product fast engine.

The run driver (models/runner.py) needs interpolation, energy, errors
against an exact solution, a probe value and the divergence check. On the
structured P1 rectangle all of them are grid-plane arithmetic: slice-window
quadratic forms and per-class quadrature over coordinate planes, so the
fast engine is O(grid) end to end and never builds a per-cell
discretisation.

Semantics match tpuwave's GridDiagnostics to summation-order roundoff
(identical element matrices and quadrature rules; reference
WaveEquationBase.cpp:148-222 energy/probe, :367-423 errors with the r+2
rule and the 1e-14 relative guard). A spatially varying c enters the
energy through per-cell scales det sum_q w_q c^2(x_q, 0) of the gradient
class matrices G (the reference freezes c at t = 0 for the energy
operator).

Sharded (``layout``, parallel/sharding.py::GridLayout): state vectors are
a rank's block, flattened. Each rank sums the cells its nodes anchor (its
block plus one halo row and column, :meth:`GridLayout.cell_block`), the
energy and error sums go through one ``all_sum`` each, and the probe's
three vertex values come from their owning ranks (summed into place, so
the probe is the unsharded dot exactly). Every rank must make the same
calls.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from tpuwave_torch.core.mesh import FeSpace, StructuredTriMesh
from tpuwave_torch.core.quadrature import gauss_simplex
from tpuwave_torch.core.shape import simplex_shape
from tpuwave_torch.ops.assembly import (element_mass_class,
                                        element_stiffness_class)
from tpuwave_torch.ops.stencil import P1_CLASS_CORNERS
from tpuwave_torch.utils.params import Params

__all__ = ["GridDiagnostics", "sharded_quad_form"]


def _partial(fn, a):
    """d fn / d a, elementwise (forward-mode AD with a unit tangent; the
    counterpart of tpuwave's jax.jvp)."""
    a = a.contiguous()
    with fwAD.dual_level():
        out = fn(fwAD.make_dual(a, torch.ones_like(a)))
        tangent = fwAD.unpack_dual(out).tangent
    if tangent is None:     # the expression does not depend on ``a``
        return torch.zeros_like(a)
    return torch.broadcast_to(tangent.to(a.dtype), a.shape)


def _class_form(win, a_class, k):
    """sum_ij A_k[i, j] w_i w_j over the windows ``win`` of class k."""
    acc = None
    for i in range(3):
        for j in range(3):
            a = float(a_class[k, i, j])
            if a == 0.0:
                continue
            term = a * (win[i] * win[j])
            acc = term if acc is None else acc + term
    return acc


def _local_quad_form(layout, wg, a_class):
    """This rank's share of sum_cells w_e^T A_e w_e (0-d, not summed)."""
    cb = layout.cell_block(wg)
    nyc, nxc = cb.shape[0] - 1, cb.shape[1] - 1
    total = None
    for k in range(2):
        win = [cb[oy:oy + nyc, ox:ox + nxc]
               for (ox, oy) in P1_CLASS_CORNERS[k]]
        s = torch.sum(_class_form(win, a_class, k))
        total = s if total is None else total + s
    return total


def sharded_quad_form(layout, wg, a_class):
    """sum_cells w_e^T A_e w_e of a sharded grid plane (``wg``: this
    rank's block), summed over the ranks."""
    return layout.all_sum(_local_quad_form(layout, wg, a_class))


class GridDiagnostics:
    """The runner-facing diagnostics of a P1 structured rectangle run,
    on tensors of ``dtype`` on ``device``. State vectors are flat
    (n_dofs,) in row-major vertex order, or, with a sharded ``layout``,
    this rank's block of them."""

    def __init__(self, params: Params, *, dtype: torch.dtype,
                 device: torch.device, layout=None):
        self.params = params
        self.mesh = StructuredTriMesh(params.nel, params.geometry)
        self.dtype = dtype
        self.device = torch.device(device)
        ny1, nx1 = self.mesh.ny + 1, self.mesh.nx + 1
        self.shape = (ny1, nx1)
        self.n_dofs = ny1 * nx1
        self.layout = layout if layout is not None and layout.sharded \
            else None
        self.block_shape = (self.shape if self.layout is None
                            else self.layout.block_shape)

        c_const = params.c.constant_value
        space = FeSpace(self.mesh, 1)
        quad = gauss_simplex(2)
        self._m_class = np.asarray(element_mass_class(space, quad))
        if c_const is not None:
            self._k_class = np.asarray(
                element_stiffness_class(space, quad, c_const ** 2))
            self._k_scales = None
        else:
            # varcoef: G gradient-product class matrices (q-independent
            # for P1) + per-cell scales det sum_q w_q c^2(x_q, 0)
            grads = np.asarray(space.physical_grads(space.shape_at(quad)))
            self._k_class = np.einsum("cqia,cqja->cqij", grads,
                                      grads)[:, 0]              # (2, 3, 3)
            self._k_scales = self._scales_at(0.0)               # (2, ny, nx)

        # probe: containing cell + P1 basis at the domain centre
        # (reference VectorTools::point_value, WaveEquationBase.cpp:170-222)
        cell, ref = self.mesh.locate_point(self.mesh.center)
        k = cell % 2
        ci = (cell // 2) % self.mesh.nx
        cj = (cell // 2) // self.mesh.nx
        verts = [(cj + oy) * nx1 + (ci + ox)
                 for (ox, oy) in P1_CLASS_CORNERS[k]]
        self._probe_dofs = torch.tensor(verts, dtype=torch.long,
                                        device=self.device)
        if self.layout is not None:
            lay = self.layout
            bw = lay.block_shape[1]
            rcs = [divmod(v, nx1) for v in verts]
            self._probe_own = torch.tensor([lay.owns(r, c) for r, c in rcs],
                                           device=self.device)
            self._probe_local = torch.tensor(
                [(r - lay.r0) * bw + (c - lay.c0) if lay.owns(r, c) else 0
                 for r, c in rcs], dtype=torch.long, device=self.device)
        self._probe_vals = torch.tensor(
            simplex_shape(1, np.asarray(ref, dtype=np.float64)).values[0],
            dtype=dtype, device=self.device)
        self._sol = params.solution
        self._err_cache = None

    # -- coordinates ----------------------------------------------------
    def _iota(self, n, m, dim):
        ar = torch.arange(m if dim == 1 else n, dtype=self.dtype,
                          device=self.device)
        return (ar[None, :] if dim == 1 else ar[:, None]).expand(n, m)

    def _grid_coords(self):
        (x0, y0) = self.mesh.origin
        if self.layout is not None:
            ix, iy = self.layout.iota(self.dtype)
            return x0 + self.mesh.hx * ix, y0 + self.mesh.hy * iy
        ny1, nx1 = self.shape
        xs = x0 + self.mesh.hx * self._iota(ny1, nx1, 1)
        ys = y0 + self.mesh.hy * self._iota(ny1, nx1, 0)
        return xs, ys

    def _cell_iota(self):
        """(column, row) index planes of the cells summed here: all of
        them, or this rank's (GridLayout.cell_bounds)."""
        if self.layout is not None:
            return self.layout.iota(self.dtype, cells=True)
        ny, nx = self.mesh.ny, self.mesh.nx
        return self._iota(ny, nx, 1), self._iota(ny, nx, 0)

    def norm(self, x):
        """Global 2-norm of a state vector (0-d)."""
        if self.layout is None:
            return torch.linalg.vector_norm(x)
        return self.layout.norm(x)

    @property
    def dof_coords(self):
        """Host (n_dofs, 2) support-point coordinates (the frozen-
        coefficient mg setup reads them)."""
        return self.mesh.vertex_coords

    # -- interpolation / IO views ---------------------------------------
    def interpolate(self, expr, t=0.0):
        if expr.is_zero:
            return torch.zeros(self.block_shape[0] * self.block_shape[1],
                               dtype=self.dtype, device=self.device)
        xs, ys = self._grid_coords()
        vals = torch.broadcast_to(
            expr.evaluate(xs, ys, t).to(self.dtype), self.block_shape)
        return vals.reshape(-1)

    def vertex_values(self, u):
        """Host numpy copy (P1: DoFs ARE the vertices, in mesh order);
        sharded, the whole grid gathered on every rank."""
        if self.layout is not None:
            u = self.layout.gather_all(u.reshape(self.block_shape))
            return u.detach().cpu().numpy().reshape(-1)
        return u.detach().cpu().numpy()

    # -- quadratic forms (energy) ---------------------------------------
    def _windows(self, wg, k):
        ny, nx = wg.shape[0] - 1, wg.shape[1] - 1
        return [wg[oy:oy + ny, ox:ox + nx]
                for (ox, oy) in P1_CLASS_CORNERS[k]]

    def _quad_form(self, wg, a_class, scales=None):
        """sum_cells w_e^T A_e w_e with per-class constant A (optionally
        per-cell scaled: the varcoef stiffness)."""
        total = None
        for k in range(2):
            win = self._windows(wg, k)
            acc = None
            for i in range(3):
                for j in range(3):
                    a = float(a_class[k, i, j])
                    if a == 0.0:
                        continue
                    term = a * (win[i] * win[j])
                    acc = term if acc is None else acc + term
            if scales is not None:
                acc = scales[k] * acc
            s = torch.sum(acc)
            total = s if total is None else total + s
        return total

    def energy(self, u, v):
        """E = 1/2 (v^T M v + u^T K u) (reference WaveEquationBase.cpp:
        148-154; K contains c^2). 0-d tensor."""
        if self.layout is not None:
            ug = u.to(self.dtype).reshape(self.block_shape)
            vg = v.to(self.dtype).reshape(self.block_shape)
            lay = self.layout
            return 0.5 * lay.all_sum(
                _local_quad_form(lay, vg, self._m_class)
                + _local_quad_form(lay, ug, self._k_class))
        ug = u.to(self.dtype).reshape(self.shape)
        vg = v.to(self.dtype).reshape(self.shape)
        return 0.5 * (self._quad_form(vg, self._m_class)
                      + self._quad_form(ug, self._k_class, self._k_scales))

    # -- probe ----------------------------------------------------------
    def probe(self, u):
        if self.layout is not None:
            # each vertex value from its owner, zeros elsewhere: the sum
            # puts it in place exactly
            vals = torch.where(self._probe_own, u[self._probe_local], 0.0)
            return torch.dot(self.layout.all_sum(vals), self._probe_vals)
        return torch.dot(u[self._probe_dofs], self._probe_vals)

    # -- varcoef scales ---------------------------------------------------
    def _scales_at(self, t):
        """(2, ny, nx) det * sum_q w_q c^2(x_kq, t) planes."""
        quad = gauss_simplex(2)
        ref = np.asarray(quad.points)
        w = np.asarray(quad.weights)
        det = float(self.mesh.det_j)
        ny, nx = self.mesh.ny, self.mesh.nx
        (x0, y0) = self.mesh.origin
        hx, hy = self.mesh.hx, self.mesh.hy
        ix = self._iota(ny, nx, 1)
        iy = self._iota(ny, nx, 0)
        out = []
        for k in range(2):
            c0, c1, c2_ = (np.asarray(c, float) for c in P1_CLASS_CORNERS[k])
            acc = None
            for q in range(len(w)):
                fx = float(c0[0] + ref[q, 0] * (c1[0] - c0[0])
                           + ref[q, 1] * (c2_[0] - c0[0]))
                fy = float(c0[1] + ref[q, 0] * (c1[1] - c0[1])
                           + ref[q, 1] * (c2_[1] - c0[1]))
                c2v = self.params.c.evaluate(
                    x0 + (ix + fx) * hx, y0 + (iy + fy) * hy,
                    t).to(self.dtype) ** 2
                term = float(w[q]) * torch.broadcast_to(c2v, (ny, nx))
                acc = term if acc is None else acc + term
            out.append(det * acc)
        return torch.stack(out)

    # -- errors (r+2 rule, 1e-14 guard; WaveEquationBase.cpp:367-423) ---
    def _err_data(self):
        if self._err_cache is None:
            space = FeSpace(self.mesh, 1)
            quad = gauss_simplex(3)                      # r + 2 = 3
            sh = space.shape_at(quad)
            vals = np.asarray(sh.values)                 # (Q2, 3)
            grads = np.asarray(space.physical_grads(sh))[:, 0]  # (2, 3, 2)
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
        0-d tensors. The exact gradient is a forward-mode derivative of the
        solution expression."""
        vals, grads, frac, w = self._err_data()
        sol = self._sol
        (x0, y0) = self.mesh.origin
        hx, hy = self.mesh.hx, self.mesh.hy
        ix, iy = self._cell_iota()
        ny, nx = ix.shape
        if self.layout is not None:
            ug = self.layout.cell_block(
                u.to(self.dtype).reshape(self.block_shape))
        else:
            ug = u.to(self.dtype).reshape(self.shape)

        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        l2_sq = semi_sq = ex_l2_sq = ex_semi_sq = zero
        for k in range(2):
            win = self._windows(ug, k)
            # P1 gradients are q-independent: one (gx, gy) pair per class
            guh_x = sum(float(grads[k, a, 0]) * win[a] for a in range(3))
            guh_y = sum(float(grads[k, a, 1]) * win[a] for a in range(3))
            for q in range(frac.shape[1]):
                fx, fy = float(frac[k, q, 0]), float(frac[k, q, 1])
                xs = x0 + (ix + fx) * hx
                ys = y0 + (iy + fy) * hy
                uh = sum(float(vals[q, a]) * win[a] for a in range(3))
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
        if self.layout is not None:
            l2_sq, semi_sq, ex_l2_sq, ex_semi_sq = self.layout.all_sum(
                torch.stack([l2_sq, semi_sq, ex_l2_sq, ex_semi_sq]))

        err_l2 = torch.sqrt(l2_sq)
        err_h1 = torch.sqrt(l2_sq + semi_sq)
        ex_l2 = torch.sqrt(ex_l2_sq)
        ex_h1 = torch.sqrt(ex_l2_sq + ex_semi_sq)
        rel_l2 = torch.where(ex_l2 < 1e-14, err_l2, err_l2 / ex_l2)
        rel_h1 = torch.where(ex_h1 < 1e-14, err_h1, err_h1 / ex_h1)
        return err_l2, err_h1, rel_l2, rel_h1

    # -- divergence guard (WaveEquationBase.cpp:425-431) ----------------
    @staticmethod
    def check_divergence(norm_u, norm_v, threshold=1e130):
        return (not np.isfinite(norm_u)) or (not np.isfinite(norm_v)) \
            or norm_u > threshold or norm_v > threshold
