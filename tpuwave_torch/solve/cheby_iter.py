"""Chebyshev iteration as the linear solver of the implicit fast path.

Counterpart of tpuwave's solve/cheby_iter.py. For the wave-equation
systems ``M + c K`` the iteration coefficients are data-independent
scalars computed on the host from ANALYTIC eigenvalue bounds (the range
of the constant stencil's symbol), so a block of ``degree`` iterations
needs no dot product and runs as one pass of kernel B4
(``ops/kernels.py::cheby_block``). Blocks are restarted between residual
checks, which keeps every block identical.

:func:`chebyshev_solve` is a Python loop over blocks with one host read of
``||r||^2`` per block, for any operator with known spectrum bounds (the P2
engine's block-symbol bounds; :func:`stencil_chebyshev` gives the P1
stencil's B3 apply, symbol bounds and B4 block); its stopping rule is
tpuwave's ReductionControl
contract, ``||r|| <= max(abs_tol, reduction * ||r0||)``, evaluated as
``||r||^2`` against the squared tolerance.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, List, Tuple

import numpy as np
import torch

from tpuwave_torch.ops import kernels
from tpuwave_torch.solve.cg import CgResult, vdot

__all__ = ["stencil_symbol_bounds", "chebyshev_coefficients",
           "block_contraction", "chebyshev_block", "chebyshev_solve",
           "stencil_chebyshev"]


def stencil_symbol_bounds(stencil, n: int = 512,
                          pad_rel: float = 1e-3) -> Tuple[float, float]:
    """Spectrum bounds of a constant-stencil operator from its symbol.

    ``stencil``: (3, 3) coefficients, s[1+dj][1+di] = coupling to the
    neighbour at offset (di, dj); must be symmetric (s_d == s_{-d}), which
    holds for every FEM operator here. The Dirichlet (interior) matrix is
    a principal submatrix of the circulant whose eigenvalues are the
    symbol values, so its spectrum lies in [min lam, max lam]; pinned rows
    contribute exactly the diagonal s[1][1] = the symbol mean, inside the
    range. The symbol is a degree-1 trig polynomial per axis — a 512^2
    sample plus a relative pad far over-resolves its extrema.
    """
    if isinstance(stencil, tuple):
        return _symbol_bounds_cached(stencil, n, pad_rel)
    return _symbol_bounds_impl(np.asarray(stencil), n, pad_rel)


@functools.lru_cache(maxsize=256)
def _symbol_bounds_cached(stencil: Tuple, n: int, pad_rel: float):
    return _symbol_bounds_impl(np.asarray(stencil), n, pad_rel)


def _symbol_bounds_impl(stencil, n: int, pad_rel: float):
    s = np.asarray(stencil, dtype=np.float64)
    th = np.linspace(0.0, 2.0 * np.pi, n, endpoint=False)
    tx = th[None, :]
    ty = th[:, None]
    lam = np.zeros((n, n))
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            c = s[1 + dj, 1 + di]
            if c != 0.0:
                lam = lam + c * np.cos(di * tx + dj * ty)
    lo, hi = float(lam.min()), float(lam.max())
    pad = pad_rel * (hi - lo)
    return lo - pad, hi + pad


def chebyshev_coefficients(lam_min: float, lam_max: float,
                           degree: int) -> Tuple[float, List[Tuple[float, float]]]:
    """Host-side coefficient schedule for one degree-``degree`` block.

    Returns (theta, [(c1_j, c2_j)]) for the three-term recurrence
    (Saad, Iterative Methods, alg. 12.1):

        d_1 = r / theta;  x += d_1;  r -= A d_1
        for j = 1..degree-1:
            d_{j+1} = c1_j d_j + c2_j r;  x += d_{j+1};  r -= A d_{j+1}

    with c1_j = rho_j rho_{j-1}, c2_j = 2 rho_j / delta.
    """
    if not (0.0 < lam_min < lam_max):
        raise ValueError(f"need 0 < lam_min < lam_max, got "
                         f"[{lam_min}, {lam_max}]")
    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)
    sigma = theta / delta
    rho = 1.0 / sigma
    coeffs = []
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        coeffs.append((rho_new * rho, 2.0 * rho_new / delta))
        rho = rho_new
    return theta, coeffs


def block_contraction(lam_min: float, lam_max: float, degree: int) -> float:
    """Guaranteed residual-reduction factor of one block: 1 / T_k(sigma)."""
    sigma = (lam_max + lam_min) / (lam_max - lam_min)
    return 1.0 / math.cosh(degree * math.acosh(sigma))


def chebyshev_block(apply_a: Callable, x, r, theta: float, coeffs):
    """One restarted Chebyshev block for any operator ``apply_a``.
    Returns (x, r); the constant-stencil form of the same block is
    kernel B4 (``ops/kernels.py::cheby_block``)."""
    d = r * (1.0 / theta)
    x = x + d
    r = r - apply_a(d)
    for c1, c2 in coeffs:
        d = c1 * d + c2 * r
        x = x + d
        r = r - apply_a(d)
    return x, r


def chebyshev_solve(apply_a: Callable, b, x0, *, lam_min: float,
                    lam_max: float, degree: int = 8, abs_tol=1e-12,
                    reduction: float = 1e-6, max_iter: int = 10000,
                    r0=None, norm0_sq=None, block=None,
                    all_sum=None) -> CgResult:
    """Solve ``apply_a`` x = b, an SPD operator with spectrum in [lam_min,
    lam_max], by restarted Chebyshev iteration (tpuwave's
    ``chebyshev_solve``): one host read of ||r||^2 per block of ``degree``
    iterations. ``block(x, r, theta, coeffs) -> (x, r, ||r||^2)`` runs a
    block, by default ``chebyshev_block`` and a dot product;
    :func:`stencil_chebyshev` gives the constant-stencil arguments (r0
    through kernel B3, every block one pass of kernel B4; the P2 engine
    passes its B11 apply and block-symbol bounds).

    Same stopping contract and result type as solve/cg.py::pcg;
    ``iterations`` counts ``degree`` per block. ``b`` and ``x0`` follow
    the constrained-system convention (pinned entries consistent with the
    diagonal rows), so the residual is zero on pinned rows and the
    iterates keep x0 there. ``r0`` / ``norm0_sq`` as in pcg;
    ``all_sum`` as in pcg, for a rank's block of a sharded grid (the
    default block's ||r||^2 and the initial one go through it).
    """
    theta, coeffs = chebyshev_coefficients(lam_min, lam_max, degree)
    total = (lambda v: v) if all_sum is None else all_sum
    if block is None:
        def block(x, r, th, cf):
            x, r = chebyshev_block(apply_a, x, r, th, cf)
            return x, r, total(vdot(r, r))
    if r0 is None:
        r0 = b - apply_a(x0)
    rr = total(vdot(r0, r0)) if norm0_sq is None else norm0_sq
    tol = torch.clamp(reduction * torch.sqrt(rr).to(b.dtype),
                      min=torch.as_tensor(abs_tol, dtype=b.dtype,
                                          device=b.device))
    tol_sq = float(tol) ** 2
    x, r, k = x0, r0, 0
    # one host read of ||r||^2 per block
    while k < max_iter and float(rr) > tol_sq:
        x, r, rr = block(x, r, theta, coeffs)
        k += degree
    rnorm = torch.sqrt(rr).to(b.dtype)
    return CgResult(x=x, iterations=k, residual_norm=rnorm,
                    converged=float(rr) <= tol_sq)


def stencil_chebyshev(stencil, layout=None) -> dict:
    """:func:`chebyshev_solve`'s operator arguments for the constrained
    system of the constant ``stencil`` (interior rows S(x masked on pinned
    rows), pinned rows s[1][1] * x): its apply (kernel B3 on the card),
    the analytic symbol bounds and, as the block, one pass of kernel B4.

    On a rank's block of a sharded grid (``layout``) every apply is B3
    after a one-node halo exchange and the block is the recurrence of
    :func:`chebyshev_block` (B4 would need a halo as deep as its degree
    and norms over the owned nodes only), its norms summed over the
    ranks."""
    lo, hi = stencil_symbol_bounds(stencil)
    if layout is not None:
        from tpuwave_torch.ops.stencil import constrained_apply_on

        def apply_s(x):
            return constrained_apply_on(layout, x, stencil, stencil[1][1])
        return dict(apply_a=apply_s, lam_min=lo, lam_max=hi,
                    all_sum=layout.all_sum)

    def apply_a(x):
        return kernels.constrained_stencil_apply(x, stencil, stencil[1][1])

    def block(x, r, theta, coeffs):
        return kernels.cheby_block(x, r, stencil, theta, coeffs)
    return dict(apply_a=apply_a, lam_min=lo, lam_max=hi, block=block)
