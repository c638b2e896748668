"""Displacement-form (2-term) implicit P2 solvers (``--solver 2term`` at
R = 2).

Counterpart of tpuwave's models/fast_engine_p2_2term.py: the P2 form of
models/fast_engine_2term.py (see that module's docstring for the
derivation). Eliminating the auxiliary variables gives the displacement
recurrence

  A u^{n+1} = M (2u^n - u^{n-1}) - dt^2 K [c_u u^n + c_up u^{n-1}]
              + dt^2 F-combo

whose extrapolated warm start x0 = 2u^n - u^{n-1} leaves an O(dt^2)-small
residual, ~1 MG-PCG iteration per step and no mass or velocity solve. The
recurrence coefficients are family-level and element-degree-agnostic;
what is degree-specific is the boundary machinery, handled on the canvas
layout of models/fast_engine_p2.py:

* the driven boundary lift subtracts A(delta 1_b) with delta =
  g(t^{n+1}) - 2 u^n|b + u^{n-1}|b over the THREE boundary plane families
  (V perimeter, H top/bottom rows, W left/right columns; the D plane has
  no Dirichlet DoFs);
* the Newmark derived-BC recurrence a^{n+1}|b = (g - z)/(beta dt^2)
  (WaveNewmark.cpp:196-210) is advanced on O(perimeter) strips, EIGHT
  strip families (4 V edges, 2 H rows, 2 W columns);
* velocity reconstruction (``state_velocity``, called by the run driver
  at diagnostics / IO points only): an exact mass solve for theta,
  consistent M a^j = F^j - K u^j solves with the carried strip BCs for
  Newmark.

Every canvas apply is kernel B11 on the card (the recurrence stencil and
the lift read the true driven boundary values: ``mask_input=False``), and
the correction solve's V-cycle runs B12 / B13; with a spatially varying c
the K applies of the recurrence are torch ops (``P2VarcoefStencil``) and
the mass part of the system stays on B11. Scope: a constant or spatially
varying wave speed (the elimination assumes K static in time), beta > 0
for Newmark.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpuwave_torch.models.fast_engine_p2 import _FastP2EngineBase, _P2Op
from tpuwave_torch.solve.cg import pcg, vdot

__all__ = ["P22TermState", "FastP22TermThetaSolver",
           "FastP22TermNewmarkSolver"]

#: strip family order: V-bottom, V-top, V-left, V-right,
#: H-bottom, H-top, W-left, W-right
_N_STRIPS = 8


class P22TermState(NamedTuple):
    u: torch.Tensor        #: (4, Hc, Wc) u^n canvases (boundary = g(t^n))
    u_prev: torch.Tensor   #: u^{n-1} canvases (zeros before the first step)
    v0: torch.Tensor       #: initial velocity (step 1 and t = 0 IO)
    a0: torch.Tensor       #: consistent initial acceleration (Newmark)
    n: int                 #: steps taken (a host int: no device read)
    #: Newmark boundary strips (8, L): per-family edge values of v^n, a^n
    #: and a^{n-1}, advanced by the exact derived-BC recurrence. Zeros for
    #: the theta family.
    vb: torch.Tensor
    ab: torch.Tensor
    ab_prev: torch.Tensor


class _FastP22TermBase(_FastP2EngineBase):
    """Shared 2-term machinery on top of the canvas P2 engine base
    (operators, boundary / forcing evaluators, elimination and the mg
    plumbing are inherited)."""

    def __init__(self, problem, *, precond: str = "mg", **kw):
        kw.pop("solver", None)
        if problem.time_dependent_c and problem.c.time_dependent:
            raise ValueError(
                "--solver 2term needs a time-static wave speed (the "
                "displacement elimination assumes K constant in time); "
                "use the 3term engine for `Time Dependent C`")
        super().__init__(problem, precond=precond, **kw)
        if self.method_name == "newmark":
            if self.beta <= 1e-12:
                raise ValueError(
                    "--solver 2term needs Beta > 0 for Newmark (explicit "
                    "beta = 0 is the leapfrog path)")
            self._c_u = self.gamma + 0.5
            self._c_up = 0.5 - self.gamma
            b, g = self.beta, self.gamma
            self._f_w = (b, g + 0.5 - 2.0 * b, 0.5 - g + b)
        else:
            th = self.theta
            self._c_u = 2.0 * th
            self._c_up = 1.0 - 2.0 * th
            self._f_w = (th * th, 2.0 * th * (1.0 - th), (1.0 - th) ** 2)
        # the boundary lift A(delta 1_b) is needed whenever the state's
        # boundary values can differ from the pure extrapolation: driven
        # g, any Newmark run (derived-BC decay), or theta with initial
        # data nonzero on the boundary
        self._needs_lift = (not self._g.is_zero
                            or self.method_name == "newmark")
        if not self._needs_lift:
            u0 = self._cdata(self.disc.params.u0, 0.0)
            self._needs_lift = bool(torch.any(
                torch.where(self.boundary, u0, 0.0) != 0.0))
        # noise-anchored f32 stopping scale: r0's own computation noise is
        # ~ eps * s_abs * |u| elementwise; the Gershgorin bound majorises
        # the K row magnitudes
        self._s_abs = (abs(self._c_u) + abs(self._c_up)) \
            * self.dt * self.dt * self._k_op.lam_hi

    # -- forcing -------------------------------------------------------
    def _f_combo(self, t):
        """dt^2-scaled three-point forcing combination of the recurrence
        (None when the problem has no forcing)."""
        if self._f is None:
            return None
        dt = self.dt
        out = None
        for w, tt in zip(self._f_w, (t, t - dt, t - 2.0 * dt)):
            if w == 0.0:
                continue
            term = (dt * dt * w) * self.grid_load(tt)
            out = term if out is None else out + term
        return out

    # -- correction solve ----------------------------------------------
    def _solve_corr(self, sys_op: _P2Op, r0, x0_norm):
        """PCG for A w = r0 from w = 0 (the O(dt^2) correction), with the
        noise-anchored stopping rule: ALWAYS demand at least a 2x
        reduction (min with 0.5 ||r0||): a floor above ||r0|| silently
        degenerates the recurrence to pure extrapolation."""
        rn2 = vdot(r0, r0)
        half = 0.5 * torch.sqrt(rn2).to(self.dtype)
        if self.dtype == torch.float64:
            abs_tol = torch.clamp(half, max=1e-12)
        else:
            eta = float(torch.finfo(self.dtype).eps)
            abs_tol = torch.minimum(eta * self._s_abs * x0_norm,
                                    half).to(self.dtype)
        return pcg(sys_op.apply_c, r0, torch.zeros_like(r0),
                   r0=r0, norm0_sq=rn2,
                   precond_inv_diag=self._sys_precond(sys_op),
                   abs_tol=abs_tol, max_iter=self._max_iter)

    # -- boundary strips (Newmark driven-v machinery) -------------------
    def _advance_strips(self, vb, ab, ub, t):
        """One exact step of the parity boundary recurrence
        (WaveNewmark.cpp:177-278 restricted to boundary rows):
        z_b = u_b + dt v_b + dt^2(1/2-b) a_b; a' = (g(t) - z_b)/(b dt^2);
        v' = v_b + dt((1-g) a_b + g a'). ``ub`` = u^n strip values."""
        dt, beta, gamma = self.dt, self.beta, self.gamma
        g_np1 = self._edge_vals(self._g, t)
        z_b = ub + dt * vb + (dt * dt * (0.5 - beta)) * ab
        a_new = (g_np1 - z_b) / (beta * dt * dt)
        v_new = vb + dt * ((1.0 - gamma) * ab + gamma * a_new)
        return v_new, a_new

    # -- stepping ------------------------------------------------------
    def initial_state(self) -> P22TermState:
        p = self.disc.params
        u0 = self._cdata(p.u0, 0.0)
        v0 = self._cdata(p.v0, 0.0)
        zb = self._zeros(_N_STRIPS, self._strip_len)
        if self.method_name == "newmark":
            a0 = self._consistent_a0(u0)
            vb = self._canvas_edges(v0)
            ab = self._canvas_edges(a0)
        else:
            a0 = torch.zeros_like(u0)
            vb = ab = zb
        return P22TermState(u=u0, u_prev=torch.zeros_like(u0), v0=v0,
                            a0=a0, n=0, vb=vb, ab=ab, ab_prev=zb)

    def _consistent_a0(self, u0):
        """M a0 = F(0) - K u0 with the second-difference accel BC
        (reference WaveNewmark.cpp:298-390)."""
        dt = self.dt
        rhs = -self._k_op.apply_i(u0)
        if self._f is not None:
            rhs = rhs + self.grid_load(0.0)
        g_p = self._bdata(self._g, dt)
        g_0 = self._bdata(self._g, 0.0)
        g_m = self._bdata(self._g, -dt)
        a0_bc = (g_p - 2.0 * g_0 + g_m) / (dt * dt)
        res = self._solve(self._mass_op, rhs, a0_bc, torch.zeros_like(u0),
                          self._prec_mass, g_zero=self._g.is_zero)
        return res.x.to(self.dtype)

    def _first_step(self, state: P22TermState, t):
        """Step 1 solved directly in u-form:
          theta:   A u^1 = M u^0 - dt^2 t(1-t) K u^0 + dt M v^0
                           + t dt^2 [t F^1 + (1-t) F^0]
          Newmark: A u^1 = M z + b dt^2 F^1,
                   z = u^0 + dt v^0 + dt^2 (1/2 - b) a^0
        with u^1|b = g(t^1) by the standard elimination."""
        dt = self.dt
        u0, v0 = state.u, state.v0
        sys_op = self._sys_op
        m_rhs = self._mass_op.apply_i
        if self.method_name == "theta":
            th = self.theta
            rhs = m_rhs(u0) \
                - (dt * dt * th * (1.0 - th)) * self._k_op.apply_i(u0) \
                + dt * m_rhs(v0)
            if self._f is not None:
                fa = (th * self.grid_load(t)
                      + (1.0 - th) * self.grid_load(t - dt))
                rhs = rhs + (th * dt * dt) * fa
            x_prev = u0
        else:
            beta = self.beta
            z = u0 + dt * v0 + (dt * dt * (0.5 - beta)) * state.a0
            rhs = m_rhs(z)
            if self._f is not None:
                rhs = rhs + (beta * dt * dt) * self.grid_load(t)
            x_prev = z
        res = self._solve(sys_op, rhs, self._bdata(self._g, t), x_prev,
                          self._sys_precond(sys_op),
                          g_zero=self._g.is_zero)
        u1 = res.x.to(self.dtype)
        if self.method_name == "newmark":
            vb1, ab1 = self._advance_strips(state.vb, state.ab,
                                            self._canvas_edges(u0), t)
            strips = (vb1, ab1, state.ab)
        else:
            strips = (state.vb, state.ab, state.ab_prev)
        return self._pack(u1, u0, state, res.iterations, strips)

    def _recur_step(self, state: P22TermState, t):
        dt = self.dt
        c_u, c_up = self._c_u, self._c_up
        u, up = state.u, state.u_prev
        sys_op = self._sys_op

        combo = (u if (c_u == 1.0 and c_up == 0.0)
                 else c_u * u + c_up * up)
        # the recurrence stencil reads the true driven boundary values:
        # interior-masked unmasked-input applies (kernel B11)
        r0 = -(dt * dt) * self._k_op.apply_i(combo)
        fc = self._f_combo(t)
        if fc is not None:
            r0 = r0 + fc
        g_s = None
        if self._needs_lift:
            # driven lift: x0's boundary is g(t^{n+1}), not the
            # extrapolation 2 u^n|b - u^{n-1}|b: subtract A(delta 1_b),
            # delta from the ACTUAL state boundary values (strips)
            g_s = self._edge_vals(self._g, t)
            delta_s = g_s - 2.0 * self._canvas_edges(u) \
                + self._canvas_edges(up)
            r0 = r0 - sys_op.apply_i(self._strip_canvas(delta_s))
        interior = self.interior
        r0 = torch.where(interior, r0, 0.0)
        x0 = torch.where(interior, 2.0 * u - up, 0.0)
        res = self._solve_corr(sys_op, r0, torch.linalg.vector_norm(x0))
        if self._g.is_zero:
            u_new = torch.where(interior, x0 + res.x, 0.0)
        else:
            u_new = torch.where(interior, x0 + res.x,
                                self._strip_canvas(g_s))
        if self.method_name == "newmark":
            # u^n boundary = g(t^n) exactly from step 1 on (derived BC)
            vb1, ab1 = self._advance_strips(
                state.vb, state.ab, self._edge_vals(self._g, t - dt), t)
            strips = (vb1, ab1, state.ab)
        else:
            strips = (state.vb, state.ab, state.ab_prev)
        return self._pack(u_new.to(self.dtype), u, state, res.iterations,
                          strips)

    def _pack(self, u_new, u_old, state, iters, strips):
        new_state = P22TermState(u=u_new, u_prev=u_old, v0=state.v0,
                                 a0=state.a0, n=state.n + 1, vb=strips[0],
                                 ab=strips[1], ab_prev=strips[2])
        info = {
            "iterations_1": iters,
            "iterations_2": 0,
            "norm_u": torch.linalg.vector_norm(u_new),
            # backward-difference proxy: divergence check and console
            # only; CSVs reconstruct the exact v
            "norm_v": torch.linalg.vector_norm(u_new - u_old) / self.dt,
        }
        return new_state, info

    def step(self, state: P22TermState, t: float):
        if state.n == 0:
            return self._first_step(state, t)
        return self._recur_step(state, t)

    # -- velocity reconstruction (diagnostics / IO cadence only) --------
    def state_velocity(self, state: P22TermState, t):
        """Exact (u, u_prev) -> v at time ``t`` (canvases). Called by the
        run driver at log and output points; one or two mass solves."""
        if state.n == 0:
            return state.v0
        return self._reconstruct_v(state, t)

    def _reconstruct_v(self, state, t):
        dt = self.dt
        u, up = state.u, state.u_prev
        diff = (u - up) / dt
        if self.method_name == "theta":
            th = self.theta
            rhs = self._mass_op.apply_i(diff)
            if th != 1.0:
                combo = up if th == 0.0 else th * u + (1.0 - th) * up
                rhs = rhs - (dt * (1.0 - th)) \
                    * self._k_op.apply_i(combo)
                if self._f is not None:
                    fa = (th * self.grid_load(t)
                          + (1.0 - th) * self.grid_load(t - dt))
                    rhs = rhs + (dt * (1.0 - th)) * fa
            res = self._solve(self._mass_op, rhs,
                              self._bdata(self._dgdt, t), diff,
                              self._prec_mass, g_zero=self._dgdt.is_zero)
            return res.x.to(self.dtype)
        beta, gamma = self.beta, self.gamma
        a_n = self._consistent_a(u, t, state.ab)
        a_m = self._consistent_a(up, t - dt, state.ab_prev)
        v = diff + dt * ((0.5 + beta - gamma) * a_m
                         + (gamma - beta) * a_n)
        # boundary velocity comes straight off the carried strip (the
        # exact parity boundary recurrence); padding stays zero
        v = torch.where(self.interior, v, self._strip_canvas(state.vb))
        return v.to(self.dtype)

    def _consistent_a(self, u_c, t, ab_strip):
        """M a = F(t) - K u with the CARRIED derived-BC boundary
        acceleration (the parity a satisfies this identity along the
        trajectory, WaveNewmark.cpp:264-278)."""
        rhs = -self._k_op.apply_i(u_c)
        if self._f is not None:
            rhs = rhs + self.grid_load(t)
        res = self._solve(self._mass_op, rhs, self._strip_canvas(ab_strip),
                          torch.zeros_like(u_c), self._prec_mass,
                          g_zero=False)
        return res.x.to(self.dtype)


class FastP22TermThetaSolver(_FastP22TermBase):
    method_name = "theta"

    def method_params_suffix(self) -> str:
        from tpuwave_torch.utils.naming import clean_double
        return "-theta" + clean_double(self.theta)


class FastP22TermNewmarkSolver(_FastP22TermBase):
    method_name = "newmark"

    def method_params_suffix(self) -> str:
        from tpuwave_torch.utils.naming import clean_double
        return ("-gamma" + clean_double(self.gamma)
                + "-beta" + clean_double(self.beta))
