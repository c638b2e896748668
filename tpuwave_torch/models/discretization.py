"""Problem discretisation of the parity engine: mesh + space + operators +
diagnostics.

Counterpart of tpuwave's models/discretization.py (the functional core of
the reference's ``WaveEquationBase``): given :class:`Params`, builds the
structured mesh, the P1/P2 space, the matrix-free mass and stiffness
operators of ops/operators.py, boundary data, nodal interpolation, the
load vector and the diagnostics (energy WaveEquationBase.cpp:148-168,
L2/H1 errors :367-423, centre probe :170-222, divergence check
:425-431), on tensors of ``dtype`` on ``device``. State vectors are flat
(n_dofs,) in the space's DoF numbering (P1: the row-major vertex grid; P2:
vertices, then the h, v and d edge midpoints).

The diagnostics answer the runner (models/runner.py) as
``GridDiagnostics`` does: 0-d tensors, and ``vertex_values`` as a host
numpy copy.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuwave_torch.config import resolve_device
from tpuwave_torch.core.mesh import FeSpace, StructuredTriMesh
from tpuwave_torch.core.quadrature import gauss_simplex
from tpuwave_torch.models.grid_diag import _partial
from tpuwave_torch.ops.assembly import (cell_quad_geometry,
                                        element_mass_class,
                                        element_stiffness_class,
                                        element_stiffness_scaled)
from tpuwave_torch.ops.operators import CellConnectivity, MatrixFreeOperator
from tpuwave_torch.utils.params import Params

__all__ = ["Discretization"]


class Discretization:
    """The parity engine's discretisation of ``params`` (structured
    rectangle, R = 1 or 2), tensors of ``dtype`` on ``device`` (default
    "cuda", which raises where there is no card)."""

    def __init__(self, params: Params, dtype: torch.dtype = torch.float64,
                 device="cuda"):
        self.params = params
        self.mesh = StructuredTriMesh(params.nel, params.geometry)
        self.space = FeSpace(self.mesh, params.r)
        self.quad = gauss_simplex(params.r + 1)       # assembly rule (ref :82)
        self.quad_err = gauss_simplex(params.r + 2)   # error rule (ref :371)
        self.dtype = dtype
        self.device = resolve_device(device)

        sp, quad = self.space, self.quad
        self.n_dofs = sp.n_dofs
        self.conn = CellConnectivity(sp.cell_dofs, self.n_dofs, self.device)

        anchors, offsets = cell_quad_geometry(sp, quad)
        self._anchors_t = self._tensor(anchors)
        self._offsets_t = self._tensor(offsets)

        # wave speed: the reference never calls c.set_time, so a
        # t-dependent C is evaluated at t=0 (FunctionParser default time)
        self.mass = MatrixFreeOperator(
            self.conn, a_class=element_mass_class(sp, quad), dtype=dtype)
        c_const = params.c.constant_value
        if c_const is not None:
            self.stiffness = MatrixFreeOperator(
                self.conn,
                a_class=element_stiffness_class(sp, quad, c_const ** 2),
                dtype=dtype)
        else:
            xq = self._quad_coords_host(quad)             # (n_cells, Q, 2)
            xq_t = torch.as_tensor(xq, dtype=torch.float64)
            cvals = params.c.evaluate(xq_t[..., 0], xq_t[..., 1],
                                      0.0).numpy()
            scale, a = element_stiffness_scaled(sp, quad, cvals ** 2)
            if scale is not None:
                self.stiffness = MatrixFreeOperator(
                    self.conn, a_class=a, scale=scale, dtype=dtype)
            else:
                self.stiffness = MatrixFreeOperator(self.conn, a_full=a,
                                                    dtype=dtype)

        self.mass_diag = self.mass.diagonal()
        self.lumped_mass = self.mass.row_sums()

        self.boundary_mask = torch.as_tensor(sp.boundary_mask,
                                             device=self.device)
        bidx = np.flatnonzero(sp.boundary_mask)
        self.boundary_idx = torch.as_tensor(bidx, device=self.device)
        self.boundary_coords = self._tensor(sp.dof_coords[bidx])
        self._dof_xy = self._tensor(sp.dof_coords)

        # assembly-rule shape data for the load vector
        sh = sp.shape_at(quad)
        self._load_vals = self._tensor(sh.values)                 # (Q, nloc)
        self._load_w = self._tensor(quad.weights * self.mesh.det_j)

        # error-rule shape data
        she = sp.shape_at(self.quad_err)
        self._err_vals = self._tensor(she.values)                 # (Q2, nloc)
        self._err_grads = self._tensor(sp.physical_grads(she))  # (2,Q2,nloc,2)
        self._err_w = self._tensor(self.quad_err.weights * self.mesh.det_j)
        self._err_offsets = self._tensor(sp.quad_offsets(self.quad_err))

        # probe point = domain centre (reference WaveEquationBase.cpp:177-179)
        cell, ref = self.mesh.locate_point(self.mesh.center)
        pdofs, pvals = sp.eval_basis_at(cell, ref)
        self._probe_dofs = torch.as_tensor(np.asarray(pdofs, dtype=np.int64),
                                           device=self.device)
        self._probe_vals = self._tensor(pvals)
        self._tdep_cache = None

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    @property
    def dof_coords(self) -> np.ndarray:
        """Host (n_dofs, 2) DoF support points (the frozen-coefficient mg
        setup reads them)."""
        return self.space.dof_coords

    # ------------------------------------------------------------------
    # geometry helpers
    # ------------------------------------------------------------------
    def _quad_coords_host(self, quad) -> np.ndarray:
        """(n_cells, Q, 2) physical quadrature coords (host, setup only)."""
        anchors, offsets = cell_quad_geometry(self.space, quad)
        xq = anchors[:, None, None, :] + offsets[None, :, :, :]
        return xq.reshape(self.mesh.n_cells, -1, 2)

    def _quad_coords(self, offsets):
        """(grid_cells, 2, Q, 2) quadrature coords on the device."""
        return self._anchors_t[:, None, None, :] + offsets[None, :, :, :]

    # ------------------------------------------------------------------
    # interpolation / boundary data
    # ------------------------------------------------------------------
    def interpolate(self, expr, t=0.0) -> torch.Tensor:
        """Nodal interpolation at DoF support points
        (= VectorTools::interpolate, reference WaveTheta.cpp:352-353)."""
        vals = expr.evaluate(self._dof_xy[:, 0], self._dof_xy[:, 1], t)
        return torch.broadcast_to(vals.to(self.dtype),
                                  (self.n_dofs,)).contiguous()

    def boundary_values(self, expr, t) -> torch.Tensor:
        """Dense vector with expr evaluated at boundary DoFs (zeros inside).

        Only boundary support points are evaluated
        (= VectorTools::interpolate_boundary_values)."""
        if expr.constant_value is not None:
            val = torch.tensor(expr.constant_value, dtype=self.dtype,
                               device=self.device)
            return torch.where(self.boundary_mask, val, 0.0)
        vals = expr.evaluate(self.boundary_coords[:, 0],
                             self.boundary_coords[:, 1], t)
        out = torch.zeros(self.n_dofs, dtype=self.dtype, device=self.device)
        out[self.boundary_idx] = vals.to(self.dtype)
        return out

    # ------------------------------------------------------------------
    # load vector
    # ------------------------------------------------------------------
    @property
    def has_forcing(self) -> bool:
        return not self.params.f.is_zero

    def load_vector(self, t) -> torch.Tensor:
        """L_i(t) = int f(x, t) phi_i dx assembled over all cells at once
        (the per-step forcing cell loop, reference WaveTheta.cpp:151-180)."""
        if not self.has_forcing:
            return torch.zeros(self.n_dofs, dtype=self.dtype,
                               device=self.device)
        xq = self._quad_coords(self._offsets_t)               # (G, 2, Q, 2)
        fq = self.params.f.evaluate(xq[..., 0], xq[..., 1], t)  # (G, 2, Q)
        cell_rhs = torch.einsum("gkq,q,qi->gki", fq, self._load_w,
                                self._load_vals)
        return self.conn.assemble(cell_rhs)

    # ------------------------------------------------------------------
    # time-dependent wave speed (tpuwave's extension; the reference always
    # freezes c at t = 0)
    # ------------------------------------------------------------------
    def _tdep_data(self):
        """("scaled", G_class (2, nloc, nloc), w * detJ (Q,)) at P1 or
        ("full", w_q detJ grad_i . grad_j (2, Q, nloc, nloc), None) at P2,
        built once."""
        if self._tdep_cache is None:
            sp, quad = self.space, self.quad
            grads = sp.physical_grads(sp.shape_at(quad))    # (2, Q, nloc, 2)
            if sp.degree == 1:
                # P1 gradients are q-independent: K_e = s_e(t) * G_class
                # with s_e = detJ * sum_q w_q c^2(x_q, t)
                g_class = np.einsum("cqia,cqja->cqij", grads, grads)[:, 0]
                self._tdep_cache = ("scaled", self._tensor(g_class),
                                    self._tensor(quad.weights
                                                 * self.mesh.det_j))
            else:
                gprod = np.einsum("q,kqia,kqja->kqij", quad.weights,
                                  grads, grads) * self.mesh.det_j
                self._tdep_cache = ("full", self._tensor(gprod), None)
        return self._tdep_cache

    def stiffness_payload_at(self, t) -> torch.Tensor:
        """The t-varying payload of K(t): a per-element ``scale`` (P1
        scaled storage) or ``a_full`` element matrices (P2). The theta
        stepper carries K^{n+1}'s payload into the next step as K^n."""
        kind, data, wdet = self._tdep_data()
        xq = self._quad_coords(self._offsets_t)              # (G, 2, Q, 2)
        c2 = self.params.c.evaluate(xq[..., 0], xq[..., 1], t) ** 2
        if kind == "scaled":
            return torch.einsum("gkq,q->gk", c2, wdet).reshape(-1)
        a_full = torch.einsum("gkq,kqij->gkij", c2, data)
        return a_full.reshape(-1, a_full.shape[-1], a_full.shape[-1])

    def stiffness_from_payload(self, payload) -> MatrixFreeOperator:
        """Rebuild the K(t) operator from :meth:`stiffness_payload_at`."""
        kind, data, _ = self._tdep_data()
        if kind == "scaled":
            return MatrixFreeOperator(self.conn, a_class=data, scale=payload,
                                      dtype=self.dtype)
        return MatrixFreeOperator(self.conn, a_full=payload,
                                  dtype=self.dtype)

    def stiffness_at(self, t) -> MatrixFreeOperator:
        """K(t): stiffness with c^2 evaluated at time ``t`` (used by the
        steppers when ``Time Dependent C`` is enabled)."""
        return self.stiffness_from_payload(self.stiffness_payload_at(t))

    # ------------------------------------------------------------------
    # diagnostics
    # ------------------------------------------------------------------
    def energy(self, u, v) -> torch.Tensor:
        """E = 1/2 (v^T M v + u^T K u), K already containing c^2
        (reference WaveEquationBase.cpp:148-154). 0-d tensor."""
        return 0.5 * (torch.dot(v, self.mass(v))
                      + torch.dot(u, self.stiffness(u)))

    def probe(self, u) -> torch.Tensor:
        """u_h at the domain centre (reference WaveEquationBase.cpp:170-222)."""
        return torch.dot(u[self._probe_dofs], self._probe_vals)

    def vertex_values(self, u) -> np.ndarray:
        """Host copy of the state at the mesh vertices in mesh order (VTU
        point data): the DoF numbering starts with the vertices."""
        return u[:self.mesh.n_vertices].detach().cpu().numpy()

    def _fe_at_err_quads(self, u):
        """(uh, grad_uh) at the error-rule quadrature points.

        uh: (G, 2, Q2); grad_uh: (G, 2, Q2, 2), class-resolved.
        """
        ue = self.conn.gather(u).reshape(-1, 2, self.space.n_local_dofs)
        uh = torch.einsum("qi,eki->ekq", self._err_vals, ue)
        guh = torch.einsum("kqia,eki->ekqa", self._err_grads, ue)
        return uh, guh

    def _exact_at_err_quads(self, t):
        """The exact solution and its gradient (forward-mode derivatives of
        the expression, where tpuwave takes jax.grad) at the error-rule
        quadrature points."""
        sol = self.params.solution
        xq = self._quad_coords(self._err_offsets)            # (G, 2, Q2, 2)
        x, y = xq[..., 0], xq[..., 1]
        uex = sol.evaluate(x, y, t)
        gex = torch.stack([_partial(lambda a: sol.evaluate(a, y, t), x),
                           _partial(lambda a: sol.evaluate(x, a, t), y)],
                          dim=-1)
        return uex, gex

    def errors(self, u, t):
        """(L2, H1, rel_L2, rel_H1) of u_h vs the exact solution at time t,
        as 0-d tensors.

        Quadrature degree r+2 and the exact-norm < 1e-14 guard exactly as
        the reference (WaveEquationBase.cpp:367-423). H1 is the full norm
        sqrt(L2^2 + |.|_{H1}^2) (deal.II VectorTools::H1_norm).
        """
        uh, guh = self._fe_at_err_quads(u)
        uex, gex = self._exact_at_err_quads(t)
        w = self._err_w
        l2_sq = torch.einsum("ekq,q->", (uh - uex) ** 2, w)
        semi_sq = torch.einsum("ekqa,q->", (guh - gex) ** 2, w)
        ex_l2_sq = torch.einsum("ekq,q->", uex ** 2, w)
        ex_semi_sq = torch.einsum("ekqa,q->", gex ** 2, w)

        err_l2 = torch.sqrt(l2_sq)
        err_h1 = torch.sqrt(l2_sq + semi_sq)
        ex_l2 = torch.sqrt(ex_l2_sq)
        ex_h1 = torch.sqrt(ex_l2_sq + ex_semi_sq)
        rel_l2 = torch.where(ex_l2 < 1e-14, err_l2, err_l2 / ex_l2)
        rel_h1 = torch.where(ex_h1 < 1e-14, err_h1, err_h1 / ex_h1)
        return err_l2, err_h1, rel_l2, rel_h1

    @staticmethod
    def check_divergence(norm_u, norm_v, threshold=1e130):
        """Reference WaveEquationBase.cpp:425-431."""
        return (not np.isfinite(norm_u)) or (not np.isfinite(norm_v)) \
            or norm_u > threshold or norm_v > threshold
