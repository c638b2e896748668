"""Preconditioned conjugate gradients on torch tensors.

Replaces Trilinos ``SolverCG`` + ``ReductionControl(10000, 1e-12, 1e-6)``
(reference WaveTheta.cpp:288-293, WaveNewmark.cpp:256-261), with tpuwave's
rule unchanged: stop when ||r||_2 <= max(abs_tol, reduction * ||r0||_2) or
after ``max_iter`` iterations, warm-started from ``x0``, and return the
performed-iteration count for iterations.csv parity.

The loop is a Python loop. Its stopping test reads ``||r||`` back to the
host once per iteration, so the iteration counts are exactly tpuwave's;
that device-to-host sync per iteration is the known cost of this design
(on a GPU it serialises the launch queue once per iteration).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["pcg", "CgResult", "vdot"]


class CgResult(NamedTuple):
    x: torch.Tensor
    iterations: int                # number of CG iterations performed
    residual_norm: torch.Tensor    # 0-d, on the solve's device
    converged: bool                # residual target met within max_iter


def vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Real dot product of two same-shaped tensors (0-d tensor)."""
    return torch.dot(a.reshape(-1), b.reshape(-1))


def pcg(apply_a: Callable, b: torch.Tensor, x0: torch.Tensor, *,
        precond_inv_diag=None, max_iter: int = 10000, abs_tol=1e-12,
        reduction: float = 1e-6, r0=None, norm0_sq=None) -> CgResult:
    """Solve A x = b with (Jacobi-)preconditioned CG.

    ``precond_inv_diag``: elementwise inverse diagonal (a float or a
    tensor), a callable SPD preconditioner, or None. ``abs_tol`` may be a
    float or a 0-d tensor (the f32 backward-error floor).

    ``r0`` / ``norm0_sq``: optional precomputed initial residual
    ``b - A x0`` and its squared norm (a 0-d tensor, e.g. from the fused
    2-term setup kernel); they skip the operator application and the
    reduction here.
    """
    if precond_inv_diag is None:
        def precond(r):
            return r
    elif callable(precond_inv_diag):
        precond = precond_inv_diag
    else:
        def precond(r):
            return precond_inv_diag * r

    r = b - apply_a(x0) if r0 is None else r0
    norm0 = (torch.linalg.vector_norm(r) if norm0_sq is None
             else torch.sqrt(norm0_sq).to(b.dtype))
    tol = torch.clamp(reduction * norm0,
                      min=torch.as_tensor(abs_tol, dtype=b.dtype,
                                          device=b.device))
    tol_host = float(tol)

    x = x0
    z = precond(r)
    p = z
    rz = vdot(r, z)
    rnorm = norm0
    k = 0
    # one host read of ||r|| per iteration: the stopping test of tpuwave's
    # lax.while_loop, evaluated on the host
    while k < max_iter and float(rnorm) > tol_host:
        ap = apply_a(p)
        alpha = rz / vdot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new = vdot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        rnorm = torch.linalg.vector_norm(r)
        k += 1
    return CgResult(x=x, iterations=k, residual_norm=rnorm,
                    converged=float(rnorm) <= tol_host)
