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
        reduction: float = 1e-6, r0=None, norm0_sq=None,
        all_sum=None) -> CgResult:
    """Solve A x = b with (Jacobi-)preconditioned CG.

    ``precond_inv_diag``: elementwise inverse diagonal (a float or a
    tensor), a callable SPD preconditioner, or None. ``abs_tol`` may be a
    float or a 0-d tensor (the f32 backward-error floor).

    ``r0`` / ``norm0_sq``: optional precomputed initial residual
    ``b - A x0`` and its squared norm (a 0-d tensor, e.g. from the fused
    2-term setup kernel); they skip the operator application and the
    reduction here.

    ``all_sum``: on a sharded grid (b, x0 a rank's block), the sum over
    the ranks (parallel/sharding.py::GridLayout.all_sum). Every dot
    product and norm then goes through it, r.z and ||r||^2 in one call, so
    every rank reads the same ||r|| and stops at the same iteration (a
    rank that stopped alone would leave the others waiting).
    """
    precond = _precond_fn(precond_inv_diag)
    dot, dot_norm = _reductions(all_sum)
    r = b - apply_a(x0) if r0 is None else r0
    z = precond(r)
    if norm0_sq is None:
        rz, norm0 = dot_norm(r, z)
    else:
        rz, norm0 = dot(r, z), torch.sqrt(norm0_sq).to(b.dtype)
    tol = torch.clamp(reduction * norm0,
                      min=torch.as_tensor(abs_tol, dtype=b.dtype,
                                          device=b.device))
    tol_host = float(tol)

    x, p, rnorm, k = x0, z, norm0, 0
    # one host read of ||r|| per iteration: the stopping test of tpuwave's
    # lax.while_loop, evaluated on the host
    while k < max_iter and float(rnorm) > tol_host:
        ap = apply_a(p)
        alpha = rz / dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new, rnorm = dot_norm(r, z)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        k += 1
    return CgResult(x=x, iterations=k, residual_norm=rnorm,
                    converged=float(rnorm) <= tol_host)


def _precond_fn(precond_inv_diag):
    if precond_inv_diag is None:
        return lambda r: r
    if callable(precond_inv_diag):
        return precond_inv_diag
    return lambda r: precond_inv_diag * r


def _reductions(all_sum):
    """``(dot, dot_norm)``: ``dot(a, b)`` is a.b and ``dot_norm(r, z)`` is
    (r.z, ||r||), over the whole grid; on a sharded grid both sum their
    block's parts over the ranks, ``dot_norm`` in one call."""
    if all_sum is None:
        return vdot, lambda r, z: (vdot(r, z), torch.linalg.vector_norm(r))

    def dot_norm(r, z):
        both = all_sum(torch.stack([vdot(r, z), vdot(r, r)]))
        return both[0], torch.sqrt(both[1])

    return (lambda a, b: all_sum(vdot(a, b))), dot_norm
