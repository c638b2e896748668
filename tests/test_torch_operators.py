"""The parity engine's gather-path operators against tpuwave's, on the CPU
in f64 (tpuwave eager, no solver):

* ``MatrixFreeOperator`` in its three storage modes (class: the mass;
  scaled: the P1 stiffness of a varying c; full: the P2 one and an
  ``axpy`` of unlike modes): apply on a random vector, ``diagonal``,
  ``row_sums``, ``abs_row_sums``, ``axpy`` and ``to_dense``, at R = 1 and
  R = 2, rtol 1e-12 (summation order differs: tpuwave's ``segment_sum``
  against the port's gather-sum over the inverse connectivity);
* ``constrain_system`` on the same operators with random boundary data,
  rhs and warm start;
* the inverse connectivity: each DoF's slots ascending, padded with the
  zero slot to the valence (6 on the structured mesh; P2 edge midpoints
  2), and the gather-sum equal to an ``index_add_`` of the same values
  and bitwise equal from run to run.
"""

import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (one torch thread)
from tpuwave.core.mesh import FeSpace as JSpace
from tpuwave.core.mesh import StructuredTriMesh as JMesh
from tpuwave.core.quadrature import gauss_simplex as jgauss
from tpuwave.ops import assembly as jasm
from tpuwave.ops.operators import MatrixFreeOperator as JOp
from tpuwave.ops.operators import constrain_system as jconstrain
from tpuwave_torch.core.mesh import FeSpace, StructuredTriMesh
from tpuwave_torch.core.quadrature import gauss_simplex
from tpuwave_torch.ops import assembly as tasm
from tpuwave_torch.ops.operators import (CellConnectivity,
                                         MatrixFreeOperator,
                                         constrain_system)

CPU = torch.device("cpu")
GEOM = ((0.0, 0.0), (1.0, 0.8))


def _close(got, want, rtol=1e-12, scale=None):
    """Within rtol of ``want``, and absolutely within rtol of ``scale``
    (default: want's largest entry)."""
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if scale is None else scale
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * scale)


def _operators(r):
    """Each package's (mass, stiffness with a varying c, mass + 0.3 K)
    on a (5, 4) mesh at degree r, from the same host element data."""
    nel = (5, 4)
    jsp = JSpace(JMesh(nel, GEOM), r)
    tsp = FeSpace(StructuredTriMesh(nel, GEOM), r)
    quad, jquad = gauss_simplex(r + 1), jgauss(r + 1)
    rng = np.random.default_rng(7 + r)
    c2 = 1.0 + rng.random((tsp.mesh.n_cells, len(quad.weights)))
    m = tasm.element_mass_class(tsp, quad)
    scale, a = tasm.element_stiffness_scaled(tsp, quad, c2)
    j_scale, j_a = jasm.element_stiffness_scaled(jsp, jquad, c2)
    np.testing.assert_allclose(a, j_a, rtol=1e-14)
    if scale is not None:
        np.testing.assert_allclose(scale, j_scale, rtol=1e-14)
    conn = CellConnectivity(tsp.cell_dofs, tsp.n_dofs, CPU)
    t_m = MatrixFreeOperator(conn, a_class=m)
    j_m = JOp(jsp.cell_dofs, jsp.n_dofs, a_class=m)
    if scale is not None:
        t_k = MatrixFreeOperator(conn, a_class=a, scale=scale)
        j_k = JOp(jsp.cell_dofs, jsp.n_dofs, a_class=j_a, scale=j_scale)
    else:
        t_k = MatrixFreeOperator(conn, a_full=a)
        j_k = JOp(jsp.cell_dofs, jsp.n_dofs, a_full=j_a)
    ops = [(t_m, j_m), (t_k, j_k), (t_m.axpy(0.3, t_k), j_m.axpy(0.3, j_k)),
           (t_m.axpy(0.3, t_m), j_m.axpy(0.3, j_m))]
    return tsp, ops, rng


@pytest.mark.parametrize("r", [1, 2])
def test_operator_modes_match_tpuwave(r):
    tsp, ops, rng = _operators(r)
    # the three storage modes: class, scaled (R = 1) / full (R = 2), and
    # axpy of unlike modes (full) and of two class operators (class)
    modes = [(t.a_class is not None, t.scale is not None) for t, _ in ops]
    assert modes == [(True, False), (r == 1, r == 1), (False, False),
                     (True, False)]
    v = rng.standard_normal(tsp.n_dofs)
    for t_op, j_op in ops:
        _close(t_op(torch.as_tensor(v)).numpy(), j_op(v))
        _close(t_op.diagonal().numpy(), j_op.diagonal())
        abs_rows = np.asarray(j_op.abs_row_sums())
        _close(t_op.abs_row_sums().numpy(), abs_rows)
        # a stiffness row sums to zero: hold it to its |entries|' scale
        _close(t_op.row_sums().numpy(), j_op.row_sums(),
               scale=float(abs_rows.max()))
        _close(t_op.to_dense(), j_op.to_dense())


@pytest.mark.parametrize("r", [1, 2])
def test_constrain_system_matches_tpuwave(r):
    tsp, ops, rng = _operators(r)
    bnd = tsp.boundary_mask
    g, rhs, x_prev, w = (rng.standard_normal(tsp.n_dofs) for _ in range(4))
    for t_op, j_op in ops[1:3]:
        t_apply, t_rhs, t_x0 = constrain_system(
            t_op, t_op.diagonal(), torch.as_tensor(bnd), torch.as_tensor(g),
            torch.as_tensor(rhs), torch.as_tensor(x_prev))
        j_apply, j_rhs, j_x0 = jconstrain(j_op, j_op.diagonal(), bnd, g, rhs,
                                          x_prev)
        _close(t_rhs.numpy(), j_rhs)
        np.testing.assert_array_equal(t_x0.numpy(), np.asarray(j_x0))
        _close(t_apply(torch.as_tensor(w)).numpy(), j_apply(w))


@pytest.mark.parametrize("r", [1, 2])
def test_inverse_connectivity(r):
    sp = FeSpace(StructuredTriMesh((6, 5), GEOM), r)
    conn = CellConnectivity(sp.cell_dofs, sp.n_dofs, CPU)
    slots = conn.slots.numpy()
    pad = sp.mesh.n_cells * sp.n_local_dofs
    assert slots.shape == (sp.n_dofs, 6)
    n_used = (slots < pad).sum(axis=1)
    # interior vertices touch 6 triangles; P2 edge midpoints 1 or 2
    assert n_used[:sp.mesh.n_vertices].max() == 6
    if r == 2:
        assert n_used[sp.mesh.n_vertices:].max() == 2
    flat = sp.cell_dofs.reshape(-1)
    for i in range(sp.n_dofs):
        own = slots[i, :n_used[i]]
        assert (np.diff(own) > 0).all() and (flat[own] == i).all()
        assert (slots[i, n_used[i]:] == pad).all()
    we = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (sp.mesh.n_cells, sp.n_local_dofs)))
    y = conn.assemble(we)
    ref = torch.zeros(sp.n_dofs, dtype=we.dtype).index_add_(
        0, conn.flat, we.reshape(-1))
    _close(y.numpy(), ref.numpy(), rtol=1e-14)
    assert torch.equal(y, conn.assemble(we.clone()))
