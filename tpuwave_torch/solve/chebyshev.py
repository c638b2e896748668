"""Chebyshev preconditioning (``--precond chebyshev``).

Counterpart of ``chebyshev_apply`` in tpuwave's solve/chebyshev.py: a
fixed-degree Chebyshev polynomial in the Jacobi-preconditioned operator
D^{-1} A, targeting the spectrum [lambda_max / eig_ratio, lambda_max].
It is symmetric and positive for SPD A, so it is a valid CG
preconditioner; one application is ``degree - 1`` operator applies (the
fast engines pass the constrained apply, kernel B3 or B11 on the card).
``estimate_lambda_max`` is the power iteration the P2 V-cycle's smoother
is sized by.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["chebyshev_apply", "estimate_lambda_max"]


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


def estimate_lambda_max(apply_a: Callable, inv_diag, n: int, *,
                        iters: int = 25, seed: int = 0) -> float:
    """Largest eigenvalue of D^{-1} A by power iteration (returns a float,
    slightly inflated for safety like deal.II's 1.2 factor).

    ``inv_diag`` is a tensor of the operator's dtype and device. The start
    vector is n standard normals from ``torch.Generator().manual_seed(seed)``,
    drawn on the CPU in float64, then cast and moved to ``inv_diag``'s
    device, so a run on the card and one on the CPU start from the same
    vector. tpuwave draws it with ``jax.random.normal(PRNGKey(seed))``,
    which torch cannot reproduce: the two estimates agree to the power
    iteration's accuracy (a few percent), not bit for bit.
    """
    gen = torch.Generator().manual_seed(seed)
    v = torch.randn(n, generator=gen, dtype=torch.float64)
    v = v.to(dtype=inv_diag.dtype, device=inv_diag.device)
    v = v / torch.linalg.vector_norm(v)
    for _ in range(iters):
        w = inv_diag * apply_a(v)
        v = w / torch.linalg.vector_norm(w)
    w = inv_diag * apply_a(v)
    lam = torch.dot(v, w) / torch.dot(v, v)
    return float(lam) * 1.2
