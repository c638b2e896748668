"""Chebyshev preconditioning (``--precond chebyshev``).

Counterpart of ``chebyshev_apply`` in tpuwave's solve/chebyshev.py: a
fixed-degree Chebyshev polynomial in the Jacobi-preconditioned operator
D^{-1} A, targeting the spectrum [lambda_max / eig_ratio, lambda_max].
It is symmetric and positive for SPD A, so it is a valid CG
preconditioner; one application is ``degree - 1`` operator applies (the
fast engines pass the constrained apply, kernel B3 or B11 on the card).
``estimate_lambda_max`` is the power iteration the P2 V-cycle's smoother
and the parity engine's :class:`ChebyshevPreconditioner` are sized by.
"""

from __future__ import annotations

from typing import Callable

import torch

from tpuwave_torch.utils.prng import threefry_normal

__all__ = ["chebyshev_apply", "estimate_lambda_max",
           "ChebyshevPreconditioner"]


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
    vector is tpuwave's, ``jax.random.normal(PRNGKey(seed), (n,), dtype)``,
    reproduced by :func:`tpuwave_torch.utils.prng.threefry_normal` on
    ``inv_diag``'s device, so runs on the card, on the CPU and tpuwave's
    start from the same vector (to erfinv's last bits).
    """
    v = threefry_normal(seed, n, inv_diag.dtype, inv_diag.device)
    v = v / torch.linalg.vector_norm(v)
    for _ in range(iters):
        w = inv_diag * apply_a(v)
        v = w / torch.linalg.vector_norm(w)
    w = inv_diag * apply_a(v)
    lam = torch.dot(v, w) / torch.dot(v, v)
    return float(lam) * 1.2


class ChebyshevPreconditioner:
    """z = P(r): fixed ``degree`` Chebyshev iteration on D^{-1}A r = z
    (the parity engine's ``--precond chebyshev``, its lambda_max from
    :func:`estimate_lambda_max` at setup).

    Symmetric and positive for SPD A (valid CG preconditioner). All state
    is a handful of scalars; application is ``degree`` operator applies.
    """

    def __init__(self, apply_a: Callable, diag, *, lambda_max: float,
                 eig_ratio: float = 30.0, degree: int = 4):
        self.apply_a = apply_a
        self.inv_diag = 1.0 / diag
        self.degree = int(degree)
        self.lmax = float(lambda_max)
        self.lmin = self.lmax / float(eig_ratio)

    def __call__(self, r):
        return chebyshev_apply(self.apply_a, self.inv_diag, r,
                               lambda_max=self.lmax,
                               eig_ratio=self.lmax / self.lmin,
                               degree=self.degree)
