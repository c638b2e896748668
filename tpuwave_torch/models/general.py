"""Discretisation on an imported unstructured mesh + the mesh-path factory.

Counterpart of tpuwave's models/general.py. It activates the reference's
dormant ``Mesh File Name`` parameter (ParameterReader.cpp:51-54; never
consumed there — setup_mesh always regenerates the structured rectangle,
WaveEquationBase.cpp:37-72): when a parameter file sets ``Mesh File
Name``, the port imports that mesh (Gmsh .msh or legacy VTK,
core/unstructured.py) and solves on it with the same scheme steppers —
the same boundary treatment, CG contract and diagnostics.

On a general mesh the geometry is per cell: the operators are per-cell
element matrices (``a_full``) on the parity engine's gather -> per-cell
matvec -> gather-sum path (ops/operators.py), and the quadrature data are
(n_cells, ...) tensors on the device. The structured engines (stencils,
the CUDA kernels, ``--precond mg``) stay with generated rectangles and
with imports :func:`detect_structured` recognises as one.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpuwave_torch.config import resolve_device
from tpuwave_torch.core.quadrature import gauss_simplex
from tpuwave_torch.core.unstructured import (UnstructuredFeSpace,
                                             UnstructuredTriMesh,
                                             detect_structured,
                                             read_mesh_file)
from tpuwave_torch.models.discretization import Discretization
from tpuwave_torch.models.grid_diag import _partial
from tpuwave_torch.ops.operators import CellConnectivity, MatrixFreeOperator
from tpuwave_torch.utils.params import Params

__all__ = ["UnstructuredDiscretization", "make_discretization",
           "recognised_rectangle"]


def recognised_rectangle(params: Params, mesh: UnstructuredTriMesh = None):
    """``params`` with ``nel`` / ``geometry`` replaced by those of the
    rectangle triangulation that its imported mesh is, up to renumbering
    and IO roundoff (:func:`detect_structured`), and ``mesh_recognised``
    set; None when there is no import or it is not such a rectangle.
    ``mesh``: the import, already read (else it is read here).

    The discrete problem is the same triangulation, so trajectories on
    the structured engines agree to solver roundoff; only the DoF order
    (and so the VTU vertex numbering) changes."""
    if params.mesh_file is None:
        return None
    if params.mesh_recognised:
        return params
    hit = detect_structured(mesh if mesh is not None
                            else read_mesh_file(params.mesh_file))
    if hit is None:
        return None
    nel, geometry = hit
    return dataclasses.replace(params, nel=nel, geometry=geometry,
                               mesh_recognised=True)


def make_discretization(params: Params, dtype: torch.dtype = torch.float64,
                        device="cuda", *,
                        mesh: UnstructuredTriMesh = None) -> Discretization:
    """The parity engine's discretisation of ``params`` on ``device``
    (default "cuda"): the imported mesh when ``Mesh File Name`` was given,
    otherwise the structured rectangle. An import that
    :func:`recognised_rectangle` recognises is renumbered onto the
    structured :class:`Discretization`.

    ``mesh``: the already-read import (the CLI reads it first, to report a
    bad file in one line)."""
    if params.mesh_file is None or params.mesh_recognised:
        return Discretization(params, dtype=dtype, device=device)
    if mesh is None:
        mesh = read_mesh_file(params.mesh_file)
    rect = recognised_rectangle(params, mesh)
    if rect is not None:
        return Discretization(rect, dtype=dtype, device=device)
    return UnstructuredDiscretization(params, dtype=dtype, device=device,
                                      mesh=mesh)


class UnstructuredDiscretization(Discretization):
    """:class:`Discretization`'s surface on per-cell geometry.

    The scheme steppers (ThetaSolver / NewmarkSolver) and the run driver
    touch only the shared surface — mass / stiffness operators, boundary
    data, interpolate / load_vector, diagnostics — so they run on imported
    meshes unchanged. As in the reference, ``c`` is evaluated at t = 0
    unless ``Time Dependent C`` asks for :meth:`stiffness_at`.
    """

    def __init__(self, params: Params, dtype: torch.dtype = torch.float64,
                 device="cuda", mesh: UnstructuredTriMesh = None):
        # deliberately NOT calling super().__init__: the structured
        # constructor builds class-constant geometry that does not exist
        # here. interpolate, boundary_values, energy, probe, vertex_values
        # and check_divergence are inherited and work off the attributes
        # set below.
        self.params = params
        self.mesh = (mesh if mesh is not None
                     else read_mesh_file(params.mesh_file))
        self.space = UnstructuredFeSpace(self.mesh, params.r)
        self.quad = gauss_simplex(params.r + 1)       # assembly rule (ref :82)
        self.quad_err = gauss_simplex(params.r + 2)   # error rule (ref :371)
        self.dtype = dtype
        self.device = resolve_device(device)

        sp, quad = self.space, self.quad
        self.n_dofs = sp.n_dofs
        self.conn = CellConnectivity(sp.cell_dofs, self.n_dofs, self.device)
        det = self.mesh.det_j                          # (C,)
        sh = sp.shape_at(quad)
        w = quad.weights                               # (Q,)

        # per-cell element matrices (affine elements: mass = det-scaled
        # reference mass; stiffness needs the per-cell physical gradients)
        m_ref = np.einsum("q,qi,qj->ij", w, sh.values, sh.values)
        self.mass = MatrixFreeOperator(
            self.conn, a_full=det[:, None, None] * m_ref[None], dtype=dtype)

        g = sp.physical_grads(sh)                      # (C, Q, nloc, 2)
        xq = sp.quad_points(quad)                      # (C, Q, 2)
        xq_t = torch.as_tensor(xq)
        c0 = params.c.evaluate(xq_t[..., 0], xq_t[..., 1], 0.0)
        c2 = np.broadcast_to(np.asarray(c0, dtype=np.float64) ** 2,
                             xq.shape[:2])
        k_full = np.einsum("q,cq,cqia,cqja,c->cij", w, c2, g, g, det)
        self.stiffness = MatrixFreeOperator(self.conn, a_full=k_full,
                                            dtype=dtype)

        self.mass_diag = self.mass.diagonal()
        self.lumped_mass = self.mass.row_sums()

        self.boundary_mask = torch.as_tensor(sp.boundary_mask,
                                             device=self.device)
        bidx = np.flatnonzero(sp.boundary_mask)
        self.boundary_idx = torch.as_tensor(bidx, device=self.device)
        self.boundary_coords = self._tensor(sp.dof_coords[bidx])
        self._dof_xy = self._tensor(sp.dof_coords)

        # assembly-rule data: the load vector's quadrature coordinates and
        # det-weighted weights, and (time-dependent C) the gradients
        self._load_vals = self._tensor(sh.values)               # (Q, nloc)
        self._load_xq = self._tensor(xq)                        # (C, Q, 2)
        self._load_wdet = self._tensor(det[:, None] * w[None])  # (C, Q)
        self._quad_w = self._tensor(w)                          # (Q,)
        self._grads_host = g
        self._tdep_cache = None

        # error-rule data
        she = sp.shape_at(self.quad_err)
        self._err_vals = self._tensor(she.values)               # (Q2, nloc)
        self._err_grads = self._tensor(sp.physical_grads(she))  # (C,Q2,nloc,2)
        self._err_w = self._tensor(det[:, None]
                                   * self.quad_err.weights[None])  # (C, Q2)
        self._err_xq = self._tensor(sp.quad_points(self.quad_err))

        # probe point = domain (bounding-box) centre
        cell, ref = self.mesh.locate_point(self.mesh.center)
        pdofs, pvals = sp.eval_basis_at(cell, ref)
        self._probe_dofs = torch.as_tensor(np.asarray(pdofs, dtype=np.int64),
                                           device=self.device)
        self._probe_vals = self._tensor(pvals)

    # ------------------------------------------------------------------
    def load_vector(self, t) -> torch.Tensor:
        """L_i(t) = int f(x, t) phi_i dx over the per-cell quadrature,
        assembled by the deterministic gather-sum."""
        if not self.has_forcing:
            return torch.zeros(self.n_dofs, dtype=self.dtype,
                               device=self.device)
        xq = self._load_xq
        fq = self.params.f.evaluate(xq[..., 0], xq[..., 1], t)   # (C, Q)
        fq = torch.broadcast_to(fq.to(self.dtype), xq.shape[:2])
        cell_rhs = torch.einsum("cq,qi->ci", fq * self._load_wdet,
                                self._load_vals)
        return self.conn.assemble(cell_rhs)

    # ------------------------------------------------------------------
    # time-dependent wave speed (per-cell geometry)
    # ------------------------------------------------------------------
    def _tdep_data(self) -> torch.Tensor:
        """detJ grad_i . grad_j, built once: (C, nloc, nloc) at R = 1,
        where the gradients are constant on a cell, else (C, Q, nloc,
        nloc) with the quadrature weights w_q folded in."""
        if self._tdep_cache is None:
            g = self._grads_host
            det = self.mesh.det_j
            if self.params.r == 1:
                data = np.einsum("cia,cja,c->cij", g[:, 0], g[:, 0], det)
            else:
                data = np.einsum("cqia,cqja,c,q->cqij", g, g, det,
                                 self.quad.weights)
            self._tdep_cache = self._tensor(data)
        return self._tdep_cache

    def stiffness_payload_at(self, t) -> torch.Tensor:
        """Per-cell element matrices of K(t) (the theta stepper carries
        them across steps). At R = 1: the cell's table times one scale,
        sum_q w_q c^2(x_q, t)."""
        xq = self._load_xq
        c2 = self.params.c.evaluate(xq[..., 0], xq[..., 1], t) ** 2
        c2 = torch.broadcast_to(c2.to(self.dtype), xq.shape[:2])
        data = self._tdep_data()
        if self.params.r == 1:
            return (c2 @ self._quad_w)[:, None, None] * data
        return torch.einsum("cq,cqij->cij", c2, data)

    def stiffness_from_payload(self, payload) -> MatrixFreeOperator:
        """Rebuild K(t) from :meth:`stiffness_payload_at`."""
        return MatrixFreeOperator(self.conn, a_full=payload, dtype=self.dtype)

    # ------------------------------------------------------------------
    # errors (per-cell geometry)
    # ------------------------------------------------------------------
    def _fe_at_err_quads(self, u):
        """uh: (C, Q2); grad_uh: (C, Q2, 2)."""
        ue = self.conn.gather(u)                               # (C, nloc)
        uh = torch.einsum("qi,ci->cq", self._err_vals, ue)
        guh = torch.einsum("cqia,ci->cqa", self._err_grads, ue)
        return uh, guh

    def _exact_at_err_quads(self, t):
        """The exact solution and its gradient (forward-mode derivatives of
        the expression, where tpuwave takes jax.grad)."""
        sol = self.params.solution
        x, y = self._err_xq[..., 0], self._err_xq[..., 1]
        uex = torch.broadcast_to(sol.evaluate(x, y, t), x.shape)
        gex = torch.stack([_partial(lambda a: sol.evaluate(a, y, t), x),
                           _partial(lambda a: sol.evaluate(x, a, t), y)],
                          dim=-1)
        return uex, gex

    def errors(self, u, t):
        """Same contract as the structured version (quadrature degree r+2,
        < 1e-14 exact-norm guard, full H1 norm — reference
        WaveEquationBase.cpp:367-423), with per-cell |det J| weights."""
        uh, guh = self._fe_at_err_quads(u)
        uex, gex = self._exact_at_err_quads(t)
        w = self._err_w
        l2_sq = torch.sum((uh - uex) ** 2 * w)
        semi_sq = torch.sum(torch.sum((guh - gex) ** 2, dim=-1) * w)
        ex_l2_sq = torch.sum(uex ** 2 * w)
        ex_semi_sq = torch.sum(torch.sum(gex ** 2, dim=-1) * w)

        err_l2 = torch.sqrt(l2_sq)
        err_h1 = torch.sqrt(l2_sq + semi_sq)
        ex_l2 = torch.sqrt(ex_l2_sq)
        ex_h1 = torch.sqrt(ex_l2_sq + ex_semi_sq)
        rel_l2 = torch.where(ex_l2 < 1e-14, err_l2, err_l2 / ex_l2)
        rel_h1 = torch.where(ex_h1 < 1e-14, err_h1, err_h1 / ex_h1)
        return err_l2, err_h1, rel_l2, rel_h1
