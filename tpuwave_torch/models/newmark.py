"""Newmark-beta time stepper of the parity engine (explicit central
difference / average acceleration).

Counterpart of tpuwave's models/newmark.py: the scheme of the reference
``WaveNewmark`` (src/WaveNewmark.cpp; WaveNewmark.hpp:24-37). One SPD
solve per step:

  (M + beta dt^2 K) a^{n+1} = F^{n+1} - K z,
      z = u^n + dt v^n + dt^2 (1/2 - beta) a^n
  u^{n+1} = z + beta dt^2 a^{n+1}
  v^{n+1} = v^n + dt [(1-gamma) a^n + gamma a^{n+1}]

Acceleration Dirichlet data (reference solve_a, WaveNewmark.cpp:177-262):
  beta > 0:  a|b = (g(t^{n+1}) - z|b) / (beta dt^2)   (so u^{n+1}|b = g)
  beta = 0:  a|b = (g(t^{n+1}) - 2 g(t^n) + g(t^{n-1})) / dt^2

Consistent initial acceleration: M a^0 = F(0) - K u^0 with
a^0|b = (g(dt) - 2 g(0) + g(-dt)) / dt^2 (reference run(), :298-390).

The consistent-mass CG path gives parity with the reference even at
beta = 0; ``lumped_explicit`` is the row-sum lumped, solve-free
alternative at beta = 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpuwave_torch.models.discretization import Discretization
from tpuwave_torch.models.fast_engine import StepLoopMixin
from tpuwave_torch.models.theta import gershgorin_chebyshev, setup_precond
from tpuwave_torch.ops.operators import constrain_system
from tpuwave_torch.solve.cg import pcg

__all__ = ["NewmarkSolver", "NewmarkState"]


class NewmarkState(NamedTuple):
    u: torch.Tensor
    v: torch.Tensor
    a: torch.Tensor


class NewmarkSolver(StepLoopMixin):
    method_name = "newmark"

    def __init__(self, disc: Discretization, *, lumped_explicit: bool = False,
                 precond: str = "jacobi", cheby_degree: int = 3):
        self.disc = disc
        p = disc.params
        self.beta = p.beta
        self.gamma = p.gamma
        self.dt = p.dt
        #: performance mode: diagonal (row-sum lumped) mass, no CG. Only
        #: meaningful at beta = 0; parity mode keeps consistent-mass CG.
        self.lumped_explicit = bool(lumped_explicit) and p.beta <= 1e-12
        #: tpuwave's extension: rebuild K(t^{n+1}) inside each step (the
        #: elastic force acts at t^{n+1})
        self.time_dep_c = p.time_dependent_c and p.c.time_dependent
        coef = p.beta * p.dt * p.dt
        if precond == "auto":
            # mg when the a-system is stiffness-dominated on an
            # mg-eligible discretisation, jacobi otherwise (beta = 0: the
            # a-system is M, always jacobi)
            from tpuwave_torch.solve.multigrid import auto_precond
            precond = auto_precond(p, disc.mesh, coef)
        #: resolved preconditioner choice ('jacobi'/'chebyshev'/'mg')
        self.precond = precond
        self.cheby_degree = int(cheby_degree)

        # matrix_a = M + beta dt^2 K (WaveNewmark.cpp:110-112)
        self.matrix_a = disc.mass.axpy(coef, disc.stiffness)
        self.diag_a = self.matrix_a.diagonal()
        self.prec_a = setup_precond(disc, self.matrix_a, self.diag_a,
                                    precond, self.time_dep_c, coef,
                                    self.cheby_degree)

    def method_params_suffix(self) -> str:
        from tpuwave_torch.utils.naming import clean_double
        return ("-gamma" + clean_double(self.gamma)
                + "-beta" + clean_double(self.beta))

    # ------------------------------------------------------------------
    def _boundary_accel(self, t, z=None):
        """Acceleration boundary values at t^{n+1} = t."""
        d, dt = self.disc, self.dt
        if self.beta > 1e-12:
            g_np1 = d.boundary_values(d.params.g, t)
            return (g_np1 - z) / (self.beta * dt * dt)
        g_p = d.boundary_values(d.params.g, t)
        g_0 = d.boundary_values(d.params.g, t - dt)
        g_m = d.boundary_values(d.params.g, t - 2.0 * dt)
        return (g_p - 2.0 * g_0 + g_m) / (dt * dt)

    def initial_state(self) -> NewmarkState:
        """Interpolate u0, v0 and solve M a0 = F(0) - K u0 (ref :292-390)."""
        d, dt = self.disc, self.dt
        u0 = d.interpolate(d.params.u0)
        v0 = d.interpolate(d.params.v0)

        rhs = -d.stiffness(u0)
        if d.has_forcing:
            rhs = rhs + d.load_vector(0.0)

        g_p = d.boundary_values(d.params.g, dt)
        g_0 = d.boundary_values(d.params.g, 0.0)
        g_m = d.boundary_values(d.params.g, -dt)
        a0_bc = (g_p - 2.0 * g_0 + g_m) / (dt * dt)

        if self.lumped_explicit:
            # diagonal-mass a0 so the whole trajectory is solve-free
            a0 = torch.where(d.boundary_mask, a0_bc, rhs / d.lumped_mass)
            self.initial_iterations = 0
            return NewmarkState(u=u0, v=v0, a=a0)

        apply_m, rhs_c, x0 = constrain_system(
            d.mass, d.mass_diag, d.boundary_mask, a0_bc, rhs,
            torch.zeros_like(u0))
        res = pcg(apply_m, rhs_c, x0, precond_inv_diag=1.0 / d.mass_diag)
        self.initial_iterations = int(res.iterations)
        return NewmarkState(u=u0, v=v0, a=res.x)

    def step(self, state: NewmarkState, t: float):
        d = self.disc
        dt, beta, gamma = self.dt, self.beta, self.gamma
        u_n, v_n, a_n = state.u, state.v, state.a

        # z = u^n + dt v^n + dt^2 (0.5 - beta) a^n  (WaveNewmark.cpp:123-126)
        z = u_n + dt * v_n + (dt * dt * (0.5 - beta)) * a_n
        if self.time_dep_c:
            k_np1 = d.stiffness_at(t)
            matrix_a = d.mass.axpy(beta * dt * dt, k_np1)
            diag_a = matrix_a.diagonal()
            # mg: the frozen-coefficient V-cycle built in __init__
            prec_a = self.prec_a if self.precond == "mg" else 1.0 / diag_a
            rhs = -k_np1(z)
        else:
            matrix_a, diag_a, prec_a = self.matrix_a, self.diag_a, self.prec_a
            rhs = -d.stiffness(z)
        if d.has_forcing:
            rhs = rhs + d.load_vector(t)

        a_bc = self._boundary_accel(t, z)
        if self.lumped_explicit:
            # diag-mass inverse; boundary rows overridden with the BC value
            a_np1 = torch.where(d.boundary_mask, a_bc, rhs / d.lumped_mass)
            iters = 0
        else:
            apply_a, rhs_c, x0 = constrain_system(
                matrix_a, diag_a, d.boundary_mask, a_bc, rhs, a_n)
            if self.time_dep_c and self.precond == "chebyshev":
                prec_a = gershgorin_chebyshev(matrix_a, diag_a, apply_a,
                                              prec_a, self.cheby_degree)
            res = pcg(apply_a, rhs_c, x0, precond_inv_diag=prec_a)
            a_np1, iters = res.x, res.iterations

        # Newmark update (WaveNewmark.cpp:264-278)
        u_np1 = z + (beta * dt * dt) * a_np1
        v_np1 = v_n + dt * ((1.0 - gamma) * a_n + gamma * a_np1)

        new_state = NewmarkState(u=u_np1, v=v_np1, a=a_np1)
        info = {
            "iterations_1": iters,
            "iterations_2": 0,
            "norm_u": torch.linalg.vector_norm(u_np1),
            "norm_v": torch.linalg.vector_norm(v_np1),
        }
        return new_state, info
