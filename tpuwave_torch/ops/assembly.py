"""Per-class element matrices of the structured P1/P2 mesh.

Replacement for the reference's FEValues cell loop
(src/WaveTheta.cpp:56-117 / src/WaveNewmark.cpp:56-114) on the structured
mesh, which has exactly two congruent element classes (lower/upper
triangle) with constant Jacobians: for constant wave speed the element
mass and stiffness matrices are one (nloc x nloc) constant per class,
computed once on the host with numpy. ops/stencil.py folds them into the
grid stencils. (tpuwave's gather-path helpers, element_stiffness_scaled
and cell_quad_geometry, belong to the parity engine, ROADMAP A10.)
"""

from __future__ import annotations

import numpy as np

from tpuwave_torch.core.mesh import FeSpace
from tpuwave_torch.core.quadrature import TriangleQuadrature

__all__ = [
    "element_mass_class",
    "element_stiffness_class",
]


def element_mass_class(space: FeSpace, quad: TriangleQuadrature) -> np.ndarray:
    """(2, nloc, nloc) per-class element mass matrices: int phi_i phi_j.

    M_e[i,j] = sum_q w_q * detJ * N_q[i] * N_q[j]  (identical per class).
    """
    sh = space.shape_at(quad)
    m = np.einsum("q,qi,qj->ij", quad.weights, sh.values, sh.values)
    m = m * space.mesh.det_j
    return np.stack([m, m])


def element_stiffness_class(space: FeSpace, quad: TriangleQuadrature,
                            c2: float = 1.0) -> np.ndarray:
    """(2, nloc, nloc) per-class stiffness matrices for constant c^2.

    K_e[i,j] = c^2 * sum_q w_q * detJ * grad_i . grad_j  with physical
    (per-class) gradients.
    """
    sh = space.shape_at(quad)
    grads = space.physical_grads(sh)  # (2, Q, nloc, 2)
    k = np.einsum("q,cqia,cqja->cij", quad.weights, grads, grads)
    return c2 * k * space.mesh.det_j
