"""Gauss quadrature on the reference triangle.

TPU-native stand-in for deal.II's ``QGaussSimplex<2>(n)`` (used at reference
WaveEquationBase.cpp:82 with n = r+1 for assembly and n = r+2 for error
integration). Rules are tabulated as constant numpy arrays on the unit
reference triangle T = {(x, y) : x, y >= 0, x + y <= 1} (area 1/2); weights
sum to 1/2.

Selected rules (symmetric, all-positive weights):
  n=1 -> 1 point,  exact to degree 1 (centroid)
  n=2 -> 3 points, exact to degree 2
  n=3 -> 7 points, exact to degree 5 (Radon)
  n=4 -> 16 points, exact to degree 7 (conical product, computed)

Polynomial exactness makes the assembled M and K *identical* to the
reference's for every preset (all presets use constant wave speed, and the
integrands are then polynomials within the rule's degree); only
transcendental forcing/error integrands see rule-level differences, at
discretisation-error magnitude.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["TriangleQuadrature", "gauss_simplex"]


@dataclass(frozen=True)
class TriangleQuadrature:
    points: np.ndarray   # (Q, 2) reference coordinates
    weights: np.ndarray  # (Q,), sum = 1/2
    degree: int          # maximal total degree integrated exactly

    @property
    def n_points(self) -> int:
        return self.points.shape[0]


def _from_barycentric(groups):
    """Build (points, weights) from (weight, barycentric-coords) orbit list.

    ``groups`` is a list of (w, (l1, l2, l3)) with weights normalised to sum
    to 1 over the triangle; all distinct permutations of the barycentric
    coordinates are generated. Reference coords: x = l2, y = l3.
    """
    pts, wts = [], []
    for w, lam in groups:
        seen = set()
        import itertools
        for perm in itertools.permutations(lam):
            if perm in seen:
                continue
            seen.add(perm)
            pts.append((perm[1], perm[2]))
            wts.append(w)
    points = np.asarray(pts, dtype=np.float64)
    weights = 0.5 * np.asarray(wts, dtype=np.float64)  # scale to area 1/2
    return points, weights


def _rule_1():
    points, weights = _from_barycentric([(1.0, (1 / 3, 1 / 3, 1 / 3))])
    return TriangleQuadrature(points, weights, degree=1)


def _rule_3():
    points, weights = _from_barycentric([(1 / 3, (2 / 3, 1 / 6, 1 / 6))])
    return TriangleQuadrature(points, weights, degree=2)


def _rule_7():
    # Radon's 7-point rule, degree 5.
    a1 = 0.059715871789770
    b1 = 0.470142064105115
    a2 = 0.797426985353087
    b2 = 0.101286507323456
    points, weights = _from_barycentric([
        (0.225, (1 / 3, 1 / 3, 1 / 3)),
        (0.132394152788506, (a1, b1, b1)),
        (0.125939180544827, (a2, b2, b2)),
    ])
    return TriangleQuadrature(points, weights, degree=5)


def _gauss_jacobi_01(n: int, alpha: float):
    """n-point Gauss-Jacobi rule for int_0^1 (1-t)^alpha f(t) dt
    (Golub-Welsch on the monic-Jacobi recurrence, beta = 0)."""
    import math
    beta0 = 0.0
    a = np.zeros(n)
    b = np.zeros(n)
    ab = alpha + beta0
    for k in range(n):
        denom = (2 * k + ab) * (2 * k + ab + 2)
        a[k] = (beta0**2 - alpha**2) / denom if denom != 0 else \
            (beta0 - alpha) / (ab + 2)
        if k > 0:
            num = 4 * k * (k + alpha) * (k + beta0) * (k + ab)
            den = (2 * k + ab) ** 2 * (2 * k + ab + 1) * (2 * k + ab - 1)
            b[k] = num / den
    mu0 = 2 ** (ab + 1) * math.gamma(alpha + 1) * math.gamma(beta0 + 1) \
        / math.gamma(ab + 2)
    jmat = np.diag(a) + np.diag(np.sqrt(b[1:]), 1) + np.diag(np.sqrt(b[1:]), -1)
    eigval, eigvec = np.linalg.eigh(jmat)
    x = eigval  # nodes on [-1, 1]
    w = mu0 * eigvec[0, :] ** 2
    # map to [0, 1]: int_0^1 (1-t)^alpha f dt = sum w_i / 2^(alpha+1) f(t_i)
    t = (1.0 + x) / 2.0
    return t, w / 2 ** (alpha + 1)


def _rule_16():
    """Conical-product Gauss rule, 4x4 = 16 points, exact to total degree 7.

    Collapsed-square construction: x = xi (1 - eta), y = eta with 4-point
    Gauss-Legendre in xi and 4-point Gauss-Jacobi (weight (1-eta)) in eta.
    All weights positive; plays the role of deal.II QGaussSimplex(4) for
    the r+2 error-integration rule.
    """
    n = 4
    xi, w_xi = _gauss_jacobi_01(n, 0.0)   # Gauss-Legendre on [0,1]
    eta, w_eta = _gauss_jacobi_01(n, 1.0)  # weight (1-eta) on [0,1]
    pts = np.empty((n * n, 2))
    wts = np.empty(n * n)
    k = 0
    for j in range(n):
        for i in range(n):
            pts[k, 0] = xi[i] * (1.0 - eta[j])
            pts[k, 1] = eta[j]
            wts[k] = w_xi[i] * w_eta[j]
            k += 1
    return TriangleQuadrature(pts, wts, degree=7)


_RULES = {1: _rule_1, 2: _rule_3, 3: _rule_7, 4: _rule_16}


def gauss_simplex(n_points_1d: int) -> TriangleQuadrature:
    """Quadrature for ``QGaussSimplex<2>(n_points_1d)``-style requests."""
    if n_points_1d not in _RULES:
        raise ValueError(f"No tabulated simplex rule for n_points_1d={n_points_1d}")
    return _RULES[n_points_1d]()
