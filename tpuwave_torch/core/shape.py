"""Lagrange simplex shape functions (P1, P2) on the reference triangle.

Closed-form replacement for deal.II's ``FE_SimplexP<2>(r)``
(reference WaveEquationBase.cpp:78). Local DoF ordering:

  P1: [v0, v1, v2]                      (reference-triangle vertices
                                         (0,0), (1,0), (0,1))
  P2: [v0, v1, v2, e01, e12, e20]       (vertices then edge midpoints)

The ordering is internal to this framework — only the *set* of global DoFs
(vertices, plus edge midpoints for P2) must match the reference, which it
does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["SimplexShape", "simplex_shape", "P2_EDGES"]

#: local vertex pairs of the P2 edge DoFs, in local-DoF order 3, 4, 5
P2_EDGES = ((0, 1), (1, 2), (2, 0))


@dataclass(frozen=True)
class SimplexShape:
    degree: int
    n_dofs: int
    values: np.ndarray  # (Q, nloc) shape values at the quadrature points
    grads: np.ndarray   # (Q, nloc, 2) reference-space gradients
    points: np.ndarray  # (Q, 2) the evaluation points


def _p1_values(pts):
    x, y = pts[:, 0], pts[:, 1]
    lam0 = 1.0 - x - y
    return np.stack([lam0, x, y], axis=-1)


def _p1_grads(pts):
    q = pts.shape[0]
    g = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
    return np.broadcast_to(g, (q, 3, 2)).copy()


def _p2_values(pts):
    x, y = pts[:, 0], pts[:, 1]
    lam = [1.0 - x - y, x, y]
    vals = [l * (2.0 * l - 1.0) for l in lam]
    vals += [4.0 * lam[i] * lam[j] for (i, j) in P2_EDGES]
    return np.stack(vals, axis=-1)


def _p2_grads(pts):
    x, y = pts[:, 0], pts[:, 1]
    lam = [1.0 - x - y, x, y]
    dlam = [np.array([-1.0, -1.0]), np.array([1.0, 0.0]), np.array([0.0, 1.0])]
    grads = []
    for i in range(3):
        grads.append((4.0 * lam[i] - 1.0)[:, None] * dlam[i][None, :])
    for (i, j) in P2_EDGES:
        grads.append(4.0 * (lam[i][:, None] * dlam[j][None, :] +
                            lam[j][:, None] * dlam[i][None, :]))
    return np.stack(grads, axis=1)


def simplex_shape(degree: int, points: np.ndarray) -> SimplexShape:
    """Tabulate P1/P2 shape values and reference gradients at ``points``."""
    points = np.atleast_2d(np.asarray(points, dtype=np.float64))
    if degree == 1:
        return SimplexShape(1, 3, _p1_values(points), _p1_grads(points), points)
    if degree == 2:
        return SimplexShape(2, 6, _p2_values(points), _p2_grads(points), points)
    raise ValueError(f"Unsupported simplex degree {degree} (P1/P2 only)")
