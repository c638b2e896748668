"""theta-method time stepper of the parity engine (Forward Euler /
Crank-Nicolson / Backward Euler).

Counterpart of tpuwave's models/theta.py: the first-order-system scheme of
the reference ``WaveTheta`` (src/WaveTheta.cpp; update equations in
WaveTheta.hpp:28-44). Per step, two SPD solves:

  (M + (theta dt)^2 K) u^{n+1} = M u^n - dt^2 th(1-th) K u^n + dt M v^n
                                 + th dt^2 (th f^{n+1} + (1-th) f^n)
  M v^{n+1} = M v^n - dt (1-th) K u^n - dt th K u^{n+1}
                                 + dt (th f^{n+1} + (1-th) f^n)

with Dirichlet data u|dOmega = g(t^{n+1}) and v|dOmega = dg/dt(t^{n+1})
imposed by symmetric elimination (reference solve_u/solve_v,
WaveTheta.cpp:251-339). Both solves are consistent-mass CG, warm-started,
even for theta = 0, as in the reference.

The operators are the gather-path operators of ops/operators.py on the
flat DoF vector (models/discretization.py). The time loop is the
engines' ``StepLoopMixin`` (tpuwave's ``ScanMixin`` compiles the same
loop into one ``lax.scan``). ``_frozen_c_ref`` is shared with the fast
engines (models/fast_engine.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tpuwave_torch.models.discretization import Discretization
from tpuwave_torch.models.fast_engine import StepLoopMixin, _frozen_c_ref
from tpuwave_torch.ops.operators import constrain_system
from tpuwave_torch.solve.cg import pcg

__all__ = ["ThetaSolver", "ThetaState"]


class ThetaState(NamedTuple):
    u: torch.Tensor
    v: torch.Tensor
    #: K(t^n) payload (``Discretization.stiffness_payload_at``) carried
    #: across steps when `Time Dependent C` is enabled, else None: the
    #: K^{n+1} built on one step is the next step's K^n, halving the
    #: per-step operator builds.
    k_payload: Optional[torch.Tensor] = None


def setup_precond(disc, system, diag, precond: str, time_dep_c: bool,
                  stiff_coef: float, cheby_degree: int):
    """The preconditioner of the implicit system ``system`` = M +
    stiff_coef K with assembled diagonal ``diag``, as both parity solvers
    build it: the Jacobi inverse diagonal; the Chebyshev polynomial sized
    by power iteration (static C; with a time-dependent C the step bounds
    it per step instead); or the V-cycle, frozen at the rms c(x, y, 0)
    under a time-dependent C (a fixed SPD V-cycle remains a valid CG
    preconditioner for the per-step-varying SPD system)."""
    prec = 1.0 / diag
    if precond == "chebyshev" and not time_dep_c:
        from tpuwave_torch.solve.chebyshev import (ChebyshevPreconditioner,
                                                   estimate_lambda_max)
        lmax = estimate_lambda_max(system, prec, disc.n_dofs)
        return ChebyshevPreconditioner(system, diag, lambda_max=lmax,
                                       degree=cheby_degree)
    if precond == "mg":
        from tpuwave_torch.solve.multigrid import gmg_flat_preconditioner
        return gmg_flat_preconditioner(
            disc, stiff_coef,
            c_ref=_frozen_c_ref(disc) if time_dep_c else None)
    if precond not in ("jacobi", "chebyshev"):
        raise ValueError(f"Unknown preconditioner {precond!r}")
    return prec


def gershgorin_chebyshev(system, diag, apply_c, prec, degree: int):
    """Chebyshev preconditioner of a system rebuilt this step (`Time
    Dependent C`): lambda_max from the Gershgorin bound on D^-1 A, the
    polynomial on the CONSTRAINED apply so that it preserves the pinned
    boundary subspace (the unconstrained bound still majorises it:
    constrained boundary rows are pure diagonal, interior rows only lose
    entries)."""
    from tpuwave_torch.solve.chebyshev import chebyshev_apply
    lmax = torch.max(system.abs_row_sums() / diag)

    def apply(r):
        return chebyshev_apply(apply_c, prec, r, lambda_max=lmax,
                               degree=degree)
    return apply


class ThetaSolver(StepLoopMixin):
    method_name = "theta"

    def __init__(self, disc: Discretization, *, precond: str = "jacobi",
                 cheby_degree: int = 3):
        self.disc = disc
        p = disc.params
        self.theta = p.theta
        self.dt = p.dt
        #: tpuwave's extension: rebuild K(t) inside each step from
        #: c(x, y, t); the u-system then varies per step, so its diagonal
        #: and preconditioner are rebuilt per step too
        self.time_dep_c = p.time_dependent_c and p.c.time_dependent
        coef = (p.theta * p.dt) ** 2
        if precond == "auto":
            # mg when the u-system is stiffness-dominated on an
            # mg-eligible discretisation, jacobi otherwise
            from tpuwave_torch.solve.multigrid import auto_precond
            precond = auto_precond(p, disc.mesh, coef)
        #: resolved preconditioner choice ('jacobi'/'chebyshev'/'mg')
        self.precond = precond
        self.cheby_degree = int(cheby_degree)

        # matrix_u = M + (theta dt)^2 K; matrix_v = M (WaveTheta.cpp:110-116),
        # merged into single element operators
        self.matrix_u = disc.mass.axpy(coef, disc.stiffness)
        self.matrix_v = disc.mass
        self.diag_u = self.matrix_u.diagonal()
        self.diag_v = disc.mass_diag
        self.prec_v = 1.0 / self.diag_v
        # the v-system is the bare mass (mesh-independent conditioning):
        # Jacobi always
        self.prec_u = setup_precond(disc, self.matrix_u, self.diag_u,
                                    precond, self.time_dep_c, coef,
                                    self.cheby_degree)

    def method_params_suffix(self) -> str:
        from tpuwave_torch.utils.naming import clean_double
        return "-theta" + clean_double(self.theta)

    # ------------------------------------------------------------------
    def initial_state(self) -> ThetaState:
        d = self.disc
        u0 = d.interpolate(d.params.u0)
        v0 = d.interpolate(d.params.v0)
        pay = d.stiffness_payload_at(0.0) if self.time_dep_c else None
        return ThetaState(u=u0, v=v0, k_payload=pay)

    def step(self, state: ThetaState, t: float):
        """Advance from t^n = t - dt to t^{n+1} = t (time already
        incremented, as in the reference run loop WaveTheta.cpp:374-375)."""
        d = self.disc
        th, dt = self.theta, self.dt
        u_n, v_n = state.u, state.v

        pay_np1 = None
        if self.time_dep_c:
            # theta-weighted evaluation of the time-varying operator: K^n
            # on the explicit terms, K^{n+1} on the implicit ones. K^n is
            # the payload carried in the state (built as K^{n+1} on the
            # previous step); a bare ThetaState(u, v) rebuilds it.
            if state.k_payload is not None:
                k_n = d.stiffness_from_payload(state.k_payload)
            else:
                k_n = d.stiffness_at(t - dt)
            pay_np1 = d.stiffness_payload_at(t)
            k_np1 = d.stiffness_from_payload(pay_np1)
            matrix_u = d.mass.axpy((th * dt) ** 2, k_np1)
            diag_u = matrix_u.diagonal()
            # mg: the frozen-coefficient V-cycle built in __init__
            prec_u = self.prec_u if self.precond == "mg" else 1.0 / diag_u
            ku = k_n(u_n)
        else:
            k_np1 = d.stiffness
            matrix_u, diag_u, prec_u = self.matrix_u, self.diag_u, self.prec_u
            ku = d.stiffness(u_n)

        mu = d.mass(u_n)
        mv = d.mass(v_n)

        if d.has_forcing:
            f_avg = th * d.load_vector(t) + (1.0 - th) * d.load_vector(t - dt)
        else:
            f_avg = None

        # ---- u system (WaveTheta.cpp:119-186, 251-294) -------------------
        rhs_u = mu - (dt * dt * th * (1.0 - th)) * ku + dt * mv
        if f_avg is not None:
            rhs_u = rhs_u + (th * dt * dt) * f_avg

        g_np1 = d.boundary_values(d.params.g, t)
        apply_u, rhs_u_c, x0_u = constrain_system(
            matrix_u, diag_u, d.boundary_mask, g_np1, rhs_u, u_n)
        if self.time_dep_c and self.precond == "chebyshev":
            prec_u = gershgorin_chebyshev(matrix_u, diag_u, apply_u, prec_u,
                                          self.cheby_degree)
        res_u = pcg(apply_u, rhs_u_c, x0_u, precond_inv_diag=prec_u)
        u_np1 = res_u.x

        # ---- v system (WaveTheta.cpp:188-249, 296-339) -------------------
        rhs_v = mv - (dt * (1.0 - th)) * ku - (dt * th) * k_np1(u_np1)
        if f_avg is not None:
            rhs_v = rhs_v + dt * f_avg

        dg_np1 = d.boundary_values(d.params.dgdt, t)
        apply_v, rhs_v_c, x0_v = constrain_system(
            self.matrix_v, self.diag_v, d.boundary_mask, dg_np1, rhs_v, v_n)
        res_v = pcg(apply_v, rhs_v_c, x0_v, precond_inv_diag=self.prec_v)
        v_np1 = res_v.x

        new_state = ThetaState(u=u_np1, v=v_np1, k_payload=pay_np1)
        info = {
            "iterations_1": res_u.iterations,
            "iterations_2": res_v.iterations,
            "norm_u": torch.linalg.vector_norm(u_np1),
            "norm_v": torch.linalg.vector_norm(v_np1),
        }
        return new_state, info
