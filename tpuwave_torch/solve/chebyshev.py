"""Chebyshev preconditioning (``--precond chebyshev``).

Counterpart of ``chebyshev_apply`` in tpuwave's solve/chebyshev.py: a
fixed-degree Chebyshev polynomial in the Jacobi-preconditioned operator
D^{-1} A, targeting the spectrum [lambda_max / eig_ratio, lambda_max].
It is symmetric and positive for SPD A, so it is a valid CG
preconditioner; one application is ``degree - 1`` operator applies (the
fast engines pass the constrained apply, kernel B3 on the card).
"""

from __future__ import annotations

from typing import Callable

__all__ = ["chebyshev_apply"]


def chebyshev_apply(apply_a: Callable, inv_diag, r, *, lambda_max,
                    eig_ratio: float = 30.0, degree: int = 4):
    """One Chebyshev preconditioner application z ~= (D^-1 A)^-1 D^-1 r.
    Degree 0 is plain Jacobi."""
    if degree <= 0:
        return inv_diag * r
    lmax = lambda_max
    lmin = lmax / eig_ratio
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)

    z = (1.0 / theta) * (inv_diag * r)
    if degree == 1:
        return z
    rho = delta / theta
    p = z
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * theta / delta - rho)
        resid = inv_diag * (r - apply_a(z))
        p = (2.0 * rho_new / delta) * resid + (rho_new * rho) * p
        z = z + p
        rho = rho_new
    return z
