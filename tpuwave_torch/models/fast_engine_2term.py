"""Displacement-form (2-term) implicit solvers (``--solver 2term``).

Counterpart of tpuwave's models/fast_engine_2term.py. Eliminating the
auxiliary variables from the schemes (with the semi-discrete relations
M a^j = F^j - K u^j for Newmark and the two theta update equations)
gives, on interior rows, with A the implicit system:

  Newmark: A u^{n+1} = M (2u^n - u^{n-1})
                       - dt^2 (g + 1/2 - 2b) K u^n - dt^2 (1/2 - g + b) K u^{n-1}
                       + dt^2 [ b F^{n+1} + (g + 1/2 - 2b) F^n + (1/2 - g + b) F^{n-1} ]
  theta:   A u^{n+1} = M (2u^n - u^{n-1})
                       - dt^2 K [ 2t(1-t) u^n + (1-t)^2 u^{n-1} ]
                       + dt^2 [ t^2 F^{n+1} + 2t(1-t) F^n + (1-t)^2 F^{n-1} ]

(b = beta, g = gamma, t = theta.) The warm start x0 = 2u^n - u^{n-1}
leaves the O(dt^2)-small residual

  r0 = -dt^2 K [ c_u u^n + c_up u^{n-1} ] + dt^2 F-combo - A (delta 1_b),
  delta = g(t^{n+1}) - 2 u^n|b + u^{n-1}|b,

with c_u = gamma + 1/2 / 2 theta and c_up = 1/2 - gamma / 1 - 2 theta, so
each step is one r0 pass plus ~1 preconditioned CG iteration, and no mass
or velocity solve.

The step is one code path. Without forcing (and unless a one-level mg
hierarchy turns the fused path off, as in tpuwave), r0, x0 and both norms
come from ONE pass of kernel B5 (``kernels.recurrence_r0`` with
``mask_combo=False``, so the stencil reads the true driven boundary
values) and the boundary lift is an O(perimeter) ring correction
(``_ring_lift``); the correction solve is MG-PCG, or restarted Chebyshev
blocks of kernel B4 with ``precond='chebyshev'``. With forcing the
unfused algebra runs. On the CPU the kernels' plain versions run.

Velocity is implicit in the state pair and reconstructed on demand
(``state_velocity``, called by the run driver at log and output points):

  theta:   M v^N = M (u^N - u^{N-1})/dt - dt(1-t) K [t u^N + (1-t) u^{N-1}]
                   + dt(1-t) [t F^N + (1-t) F^{N-1}],  v|b = dg/dt(t^N)
  Newmark: v^N = (u^N - u^{N-1})/dt + dt [(1/2+b-g) a^{N-1} + (g-b) a^N]
           with consistent M a^j = F^j - K u^j. The boundary acceleration
           follows the derived-BC recurrence a^{n+1}|b = (g - z)/(b dt^2),
           which two displacement slices cannot recover, so the state
           carries O(perimeter) strips (v_b, a_b, a_b^{prev}) advanced by
           that recurrence every step.

The per-step console ||v|| is the backward difference ||(u^{n+1} - u^n)/dt||
(the divergence check's proxy); CSV rows at log points use the exact
reconstruction.

Scope: constant or spatially varying wave speed (the varcoef K is the
static 9-plane operator of models/fast_engine.py, in torch ops, and the
step takes the unfused algebra; time-dependent C is rejected, as in
tpuwave: the elimination assumes K static) and beta > 0 for Newmark.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpuwave_torch.models.fast_engine import _FastEngineBase
from tpuwave_torch.ops import kernels
from tpuwave_torch.solve.cg import pcg, vdot
from tpuwave_torch.solve.cheby_iter import (chebyshev_solve,
                                            stencil_chebyshev)
from tpuwave_torch.solve.multigrid import KernelGmgPreconditioner

__all__ = ["Fast2TermState", "Fast2TermThetaSolver",
           "Fast2TermNewmarkSolver"]


class Fast2TermState(NamedTuple):
    u: torch.Tensor        #: flat u^n (boundary = g(t^n))
    u_prev: torch.Tensor   #: flat u^{n-1} (zeros before the first step)
    v0: torch.Tensor       #: initial velocity (step 1 and t = 0 IO)
    a0: torch.Tensor       #: consistent initial acceleration (Newmark)
    n: int                 #: steps taken (a host int: no device read)
    #: Newmark boundary strips (4, max(h, w)): bottom/top/left/right edge
    #: values of v^n, a^n and a^{n-1}, advanced by the exact derived-BC
    #: recurrence. Zeros for the theta family (v|b = dg/dt is pinned).
    vb: torch.Tensor
    ab: torch.Tensor
    ab_prev: torch.Tensor


class _Fast2TermBase(_FastEngineBase):
    """Shared 2-term machinery on top of the P1 engine base (operators,
    boundary / forcing evaluators, elimination, preconditioners)."""

    def __init__(self, problem, *, precond: str = "mg", **kw):
        kw.pop("solver", None)
        if problem.time_dependent_c and problem.c.time_dependent:
            raise ValueError(
                "--solver 2term needs a time-static wave speed (the "
                "displacement elimination assumes K constant in time); "
                "use the 3term engine for `Time Dependent C`")
        super().__init__(problem, precond=precond, **kw)
        fs = self.fs
        if self.method_name == "newmark":
            if fs.beta <= 1e-12:
                raise ValueError(
                    "--solver 2term needs Beta > 0 for Newmark (explicit "
                    "beta = 0 is the leapfrog path)")
            b, g = fs.beta, fs.gamma
            self._c_u, self._c_up = g + 0.5, 0.5 - g
            self._f_w = (b, g + 0.5 - 2.0 * b, 0.5 - g + b)
        else:
            th = fs.theta
            self._c_u, self._c_up = 2.0 * th, 1.0 - 2.0 * th
            self._f_w = (th * th, 2.0 * th * (1.0 - th), (1.0 - th) ** 2)
        # the boundary lift A(delta 1_b) is needed whenever the state's
        # boundary values can differ from the pure extrapolation: driven
        # g, any Newmark run (derived-BC decay), or theta with initial
        # data nonzero on the boundary (u^1|b = 0 while u^0|b is not)
        self._needs_lift = (not self._g.is_zero
                            or self.method_name == "newmark")
        if not self._needs_lift:
            u0 = self.disc.interpolate(self.disc.params.u0).to(self.dtype)
            hits = torch.sum(torch.where(
                fs.boundary, u0.reshape(fs.block_shape), 0.0) != 0.0)
            if self.layout is not None:
                hits = self.layout.all_sum(hits)
            self._needs_lift = bool(hits > 0)
        # noise-anchored f32 stopping scale: r0's own computation noise is
        # ~ eps * s_abs * |u| elementwise
        k = self._k_static
        if k.stencil is not None:
            k_mag = sum(abs(c) for row in k.stencil for c in row)
        else:
            k_mag = k.lam_hi   # Gershgorin-class majorant (varcoef)
        self._s_abs = (abs(self._c_u) + abs(self._c_up)) \
            * self.dt * self.dt * k_mag
        self._sys_op_static = self._system_of(k)
        # one B5 pass + ring lift per step: tpuwave's _fused_ok without
        # its f32-on-an-accelerator gate (a one-level mg hierarchy turns
        # its fused path off, fast_engine.py:374-382)
        # (and, as there, a constant stencil: B5 applies one)
        # (sharded, unfused: B5 sums its norms over the tensor it is
        # given, tpuwave_torch's counterpart of tpuwave's
        # fast_engine_2term.py:315)
        self._fused_ok = (
            k.stencil is not None and self._f is None
            and self.layout is None and not (
                self.precond == "mg"
                and not isinstance(self._prec_sys, KernelGmgPreconditioner)))
        if self._fused_ok:
            dt = self.dt
            self._kneg = tuple(tuple(-dt * dt * cc for cc in row)
                               for row in k.stencil)

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
            term = (dt * dt * w) * self.fs.grid_load(self._f.evaluate, tt)
            out = term if out is None else out + term
        return out

    def _k_diff(self, x):
        """K x in the zero-row-sum difference form (quieter in f32) for the
        constant stencil, the assembled varcoef planes otherwise; interior
        rows are exact for any boundary values."""
        if self._k_static.stencil is not None:
            return self.fs._stiff_diff(x)
        return self._k_static.apply(x)

    # -- correction solve ----------------------------------------------
    def _corr_abs_tol(self, rn2, x0_norm):
        """The noise-anchored stopping floor of the correction solve:
        ALWAYS demand at least a 2x reduction (min with 0.5 ||r0||) — a
        floor above ||r0|| silently degenerates the recurrence to pure
        extrapolation."""
        half = 0.5 * torch.sqrt(rn2).to(self.dtype)
        if self.dtype == torch.float64:
            return torch.clamp(half, max=1e-12)
        eta = float(torch.finfo(self.dtype).eps)
        return torch.minimum(eta * self._s_abs * x0_norm, half)

    def _solve_corr(self, r0, rn2, x0_norm):
        """The correction solve A w = r0 from w = 0 (the O(dt^2)
        correction; tpuwave's ``_solve_corr`` and ``_solve_corr_pad``):
        preconditioned CG, or in the fused step with precond ==
        'chebyshev' restarted Chebyshev blocks of kernel B4 (analytic
        symbol bounds, no dot products)."""
        sys_op = self._sys_op_static
        kw = dict(abs_tol=self._corr_abs_tol(rn2, x0_norm),
                  reduction=self.fs.cg_reduction, max_iter=self._max_iter,
                  r0=r0, norm0_sq=rn2)
        if self.layout is not None:
            return pcg(self._constrained_apply(sys_op), r0,
                       torch.zeros_like(r0),
                       precond_inv_diag=self._sys_precond(sys_op),
                       all_sum=self.layout.all_sum, **kw)
        if self._fused_ok and self.precond == "chebyshev":
            return chebyshev_solve(b=r0, x0=torch.zeros_like(r0),
                                   **stencil_chebyshev(sys_op.stencil),
                                   degree=self._cheby_solver_degree, **kw)
        return pcg(self._constrained_apply(sys_op), r0, torch.zeros_like(r0),
                   precond_inv_diag=self._sys_precond(sys_op), **kw)

    # -- boundary strips (Newmark driven-v machinery) -------------------
    def _zeros(self, *shape):
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    @property
    def _strip_len(self):
        return max(self.fs.shape)

    def _edge_coords(self):
        fs = self.fs
        (x0, y0) = fs.mesh.origin
        hx, hy = fs.mesh.hx, fs.mesh.hy
        h, w = fs.shape
        xs = x0 + hx * torch.arange(w, dtype=self.dtype, device=self.device)
        ys = y0 + hy * torch.arange(h, dtype=self.dtype, device=self.device)
        return xs, ys, x0, x0 + hx * (w - 1), y0, y0 + hy * (h - 1)

    def _edge_vals(self, expr, t):
        """(4, L) bottom/top/left/right edge values of expr(x, y, t),
        zero-padded to L = max(h, w)."""
        h, w = self.fs.shape
        out = self._zeros(4, self._strip_len)
        if expr.is_zero:
            return out
        xs, ys, x0, x1, y0, y1 = self._edge_coords()
        for k, (x, y, n) in enumerate((
                (xs, torch.full_like(xs, y0), w),
                (xs, torch.full_like(xs, y1), w),
                (torch.full_like(ys, x0), ys, h),
                (torch.full_like(ys, x1), ys, h))):
            vals = torch.as_tensor(expr.evaluate(x, y, t), dtype=self.dtype,
                                   device=self.device)
            out[k, :n] = torch.broadcast_to(vals, (n,))
        return out

    def _grid_edges(self, xg):
        """(4, L) edge extraction of a (h, w) grid array (sharded: of the
        grid whose block ``xg`` is, on every rank)."""
        h, w = self.fs.shape
        out = self._zeros(4, self._strip_len)
        lay = self.layout
        if lay is None:
            out[0, :w] = xg[0, :]
            out[1, :w] = xg[h - 1, :]
            out[2, :h] = xg[:, 0]
            out[3, :h] = xg[:, w - 1]
            return out
        # each edge node from its owner, zeros elsewhere: the sum puts
        # every value in place exactly
        r0, r1, c0, c1 = lay.r0, lay.r1, lay.c0, lay.c1
        if r0 == 0:
            out[0, c0:c1] = xg[0, :]
        if r1 == h:
            out[1, c0:c1] = xg[-1, :]
        if c0 == 0:
            out[2, r0:r1] = xg[:, 0]
        if c1 == w:
            out[3, r0:r1] = xg[:, -1]
        return lay.all_sum(out)

    def _strip_plane(self, strip):
        """(4, L) strip -> (h, w) plane with the strip values on the four
        edges (zeros inside; the four recurrences agree at corners);
        sharded, this rank's block of it."""
        h, w = self.fs.shape
        lay = self.layout
        if lay is None:
            out = self._zeros(h, w)
            out[:, 0] = strip[2, :h]
            out[:, w - 1] = strip[3, :h]
            out[0, :] = strip[0, :w]
            out[h - 1, :] = strip[1, :w]
            return out
        r0, r1, c0, c1 = lay.r0, lay.r1, lay.c0, lay.c1
        out = self._zeros(*lay.block_shape)
        if c0 == 0:
            out[:, 0] = strip[2, r0:r1]
        if c1 == w:
            out[:, -1] = strip[3, r0:r1]
        if r0 == 0:
            out[0, :] = strip[0, c0:c1]
        if r1 == h:
            out[-1, :] = strip[1, c0:c1]
        return out

    def _advance_strips(self, vb, ab, ub, t):
        """One exact step of the parity boundary recurrence
        (WaveNewmark.cpp:177-278 restricted to boundary rows):
        z_b = u_b + dt v_b + dt^2(1/2-b) a_b; a' = (g(t) - z_b)/(b dt^2);
        v' = v_b + dt((1-g) a_b + g a'). ``ub`` = u^n edge values."""
        dt, beta, gamma = self.dt, self.fs.beta, self.fs.gamma
        z_b = ub + dt * vb + (dt * dt * (0.5 - beta)) * ab
        a_new = (self._edge_vals(self._g, t) - z_b) / (beta * dt * dt)
        v_new = vb + dt * ((1.0 - gamma) * ab + gamma * a_new)
        return v_new, a_new

    def _next_strips(self, state, t, u_grid=None):
        """(vb, ab, ab_prev) after the step to ``t`` (Newmark; the theta
        family carries its zeros). The strips advance from u^n's edges:
        ``u_grid``'s at step 1, g(t - dt) exactly from then on."""
        if self.method_name != "newmark":
            return state.vb, state.ab, state.ab_prev
        ub = (self._edge_vals(self._g, t - self.dt) if u_grid is None
              else self._grid_edges(u_grid))
        vb1, ab1 = self._advance_strips(state.vb, state.ab, ub, t)
        return vb1, ab1, state.ab

    # -- stepping ------------------------------------------------------
    def initial_state(self) -> Fast2TermState:
        d = self.disc
        u0 = d.interpolate(d.params.u0).to(self.dtype).contiguous()
        v0 = d.interpolate(d.params.v0).to(self.dtype).contiguous()
        zb = self._zeros(4, self._strip_len)
        if self.method_name == "newmark":
            a0 = self._consistent_a0(u0)
            vb = self._grid_edges(v0.reshape(self.fs.block_shape))
            ab = self._grid_edges(a0.reshape(self.fs.block_shape))
        else:
            a0 = torch.zeros_like(u0)
            vb = ab = zb
        return Fast2TermState(u=u0, u_prev=torch.zeros_like(u0), v0=v0,
                              a0=a0, n=0, vb=vb, ab=ab, ab_prev=zb)

    def _consistent_a0(self, u0_flat):
        """M a0 = F(0) - K u0 with the second-difference accel BC
        (reference WaveNewmark.cpp:298-390)."""
        fs, dt = self.fs, self.dt
        u0 = u0_flat.reshape(fs.block_shape)
        rhs = -self._k_diff(u0)
        if self._f is not None:
            rhs = rhs + fs.grid_load(self._f.evaluate, 0.0)
        a0_bc = (self._plane(self._g, dt) - 2.0 * self._plane(self._g, 0.0)
                 + self._plane(self._g, -dt)) / (dt * dt)
        res = self._solve(self._mass_op, rhs, a0_bc, torch.zeros_like(u0),
                          self._prec_mass, g_zero=self._g.is_zero)
        return res.x.to(self.dtype).reshape(-1)

    def _first_step(self, state: Fast2TermState, t):
        """Step 1 solved directly in u-form:
          theta:   A u^1 = M u^0 - dt^2 t(1-t) K u^0 + dt M v^0
                           + t dt^2 [t F^1 + (1-t) F^0]
          Newmark: A u^1 = M z + b dt^2 F^1,
                   z = u^0 + dt v^0 + dt^2 (1/2 - b) a^0
        with u^1|b = g(t^1) by the standard elimination."""
        fs, dt = self.fs, self.dt
        u0 = state.u.reshape(fs.block_shape)
        v0 = state.v0.reshape(fs.block_shape)
        k_op = self._k_static
        sys_op = self._system_of(k_op)
        if self.method_name == "theta":
            th = fs.theta
            rhs = self._mass_op.apply(u0) \
                - (dt * dt * th * (1.0 - th)) * k_op.apply(u0) \
                + dt * self._mass_op.apply(v0)
            if self._f is not None:
                fa = (th * fs.grid_load(self._f.evaluate, t)
                      + (1.0 - th) * fs.grid_load(self._f.evaluate, t - dt))
                rhs = rhs + (th * dt * dt) * fa
            x_prev = u0
        else:
            beta = fs.beta
            a0 = state.a0.reshape(fs.block_shape)
            z = u0 + dt * v0 + (dt * dt * (0.5 - beta)) * a0
            rhs = self._mass_op.apply(z)
            if self._f is not None:
                rhs = rhs + (beta * dt * dt) * fs.grid_load(
                    self._f.evaluate, t)
            x_prev = z
        res = self._solve(sys_op, rhs, self._plane(self._g, t), x_prev,
                          self._sys_precond(sys_op), g_zero=self._g.is_zero)
        u1 = res.x.to(self.dtype)
        strips = self._next_strips(state, t, u0)
        return self._pack(u1, u0, state, res.iterations, strips)

    def _recur_step(self, state: Fast2TermState, t):
        if self._fused_ok:
            return self._recur_step_fused(state, t)
        fs, dt = self.fs, self.dt
        u = state.u.reshape(fs.block_shape)
        up = state.u_prev.reshape(fs.block_shape)
        sys_op = self._sys_op_static

        combo = (u if (self._c_u == 1.0 and self._c_up == 0.0)
                 else self._c_u * u + self._c_up * up)
        r0 = -(dt * dt) * self._k_diff(combo)
        fc = self._f_combo(t)
        if fc is not None:
            r0 = r0 + fc
        if self._needs_lift:
            # driven lift: x0's boundary is g(t^{n+1}), not the
            # extrapolation 2 u^n|b - u^{n-1}|b; delta comes from the
            # actual state boundary values
            delta = self._plane(self._g, t) - 2.0 * u + up
            r0 = r0 - sys_op.apply(torch.where(fs.boundary, delta, 0.0))
        r0 = torch.where(fs.interior, r0, 0.0)
        x0 = torch.where(fs.interior, 2.0 * u - up, 0.0)
        rn2 = vdot(r0, r0)
        if self.layout is not None:
            rn2 = self.layout.all_sum(rn2)
        res = self._solve_corr(r0, rn2, self.fs._norm(x0))
        u_new = torch.where(fs.interior, x0 + res.x,
                            self._plane(self._g, t))
        strips = self._next_strips(state, t)
        return self._pack(u_new.to(self.dtype), u, state, res.iterations,
                          strips)

    def _ring_lift(self, r0, rn2, delta4):
        """Subtract interior(A(delta 1_b)) from r0 in O(perimeter)
        arithmetic (A(delta 1_b) lives on the first interior ring) and
        return the corrected (r0, ||r0||^2). r0 is updated in place.

        The boundary is partitioned corner-exactly: left/right columns
        take ALL rows (incl. the four corners), bottom/top rows take
        cols 1..w-2 only — each boundary cell contributes once."""
        h, w = self.fs.shape
        A = self._sys_op_static.stencil
        db = torch.zeros_like(delta4[0, :w])
        dtp = torch.zeros_like(db)
        db[1:w - 1] = delta4[0, 1:w - 1]
        dtp[1:w - 1] = delta4[1, 1:w - 1]
        dl = delta4[2, :h]
        dr = delta4[3, :h]
        # output (1, j) <- boundary (0, j+di): coeff A[0][1+di]
        row1 = A[0][0] * db[0:w - 2] + A[0][1] * db[1:w - 1] \
            + A[0][2] * db[2:w]
        # output (h-2, j) <- boundary (h-1, j+di): coeff A[2][1+di]
        rowh = A[2][0] * dtp[0:w - 2] + A[2][1] * dtp[1:w - 1] \
            + A[2][2] * dtp[2:w]
        # output (i, 1) <- boundary (i+dj, 0): coeff A[1+dj][0]
        col1 = A[0][0] * dl[0:h - 2] + A[1][0] * dl[1:h - 1] \
            + A[2][0] * dl[2:h]
        # output (i, w-2) <- boundary (i+dj, w-1): coeff A[1+dj][2]
        colw = A[0][2] * dr[0:h - 2] + A[1][2] * dr[1:h - 1] \
            + A[2][2] * dr[2:h]

        def ring_sq(rp):
            return sum(torch.dot(v, v) for v in (
                rp[1, 1:w - 1], rp[h - 2, 1:w - 1], rp[2:h - 2, 1],
                rp[2:h - 2, w - 2]))

        old = ring_sq(r0)
        r0[1, 1:w - 1] -= row1
        r0[h - 2, 1:w - 1] -= rowh
        r0[1:h - 1, 1] -= col1
        r0[1:h - 1, w - 2] -= colw
        return r0, rn2 + (ring_sq(r0) - old)

    def _recur_step_fused(self, state: Fast2TermState, t):
        """The fused recurrence step: ONE B5 pass (mask_combo=False — the
        stencil reads the true driven boundary values) + the
        O(perimeter) ring lift + the correction solve + edge overlays."""
        fs, dt = self.fs, self.dt
        h, w = fs.shape
        u = state.u.reshape(fs.block_shape)
        up = state.u_prev.reshape(fs.block_shape)
        r0, x0, rn2, xn2 = kernels.recurrence_r0(
            u, up, self._kneg, self._c_u, self._c_up, mask_combo=False)
        g_edges = None
        if self._needs_lift:
            g_edges = self._edge_vals(self._g, t)
            delta4 = (g_edges - 2.0 * self._grid_edges(u)
                      + self._grid_edges(up))
            r0, rn2 = self._ring_lift(r0, rn2, delta4)
        res = self._solve_corr(r0, rn2, torch.sqrt(xn2))
        u_new = x0 + res.x
        if g_edges is not None:
            u_new[0, :] = g_edges[0, :w]
            u_new[h - 1, :] = g_edges[1, :w]
            u_new[:, 0] = g_edges[2, :h]
            u_new[:, w - 1] = g_edges[3, :h]
        strips = self._next_strips(state, t)
        return self._pack(u_new.to(self.dtype), u, state, res.iterations,
                          strips)

    def _pack(self, u_new, u_old, state, iters, strips):
        u_flat = u_new.reshape(-1)
        u_old_flat = u_old.reshape(-1)
        new_state = Fast2TermState(u=u_flat, u_prev=u_old_flat,
                                   v0=state.v0, a0=state.a0, n=state.n + 1,
                                   vb=strips[0], ab=strips[1],
                                   ab_prev=strips[2])
        info = {
            "iterations_1": iters,
            "iterations_2": 0,
            "norm_u": self.fs._norm(u_new),
            # backward-difference proxy (module docstring): divergence
            # check and console only; CSVs reconstruct the exact v
            "norm_v": self.fs._norm(u_flat - u_old_flat) / self.dt,
        }
        return new_state, info

    def step(self, state: Fast2TermState, t: float):
        if state.n == 0:
            return self._first_step(state, t)
        return self._recur_step(state, t)

    # -- velocity reconstruction (diagnostics/IO cadence only) ---------
    def state_velocity(self, state: Fast2TermState, t):
        """Exact (u, u_prev) -> v at time ``t`` (flat). Called by the run
        driver at log and output points; one or two mass solves."""
        if state.n == 0:
            return state.v0
        return self._reconstruct_v(state, t)

    def _reconstruct_v(self, state, t):
        fs, dt = self.fs, self.dt
        u = state.u.reshape(fs.block_shape)
        up = state.u_prev.reshape(fs.block_shape)
        diff = (u - up) / dt
        if self.method_name == "theta":
            th = fs.theta
            rhs = self._mass_op.apply(diff)
            if th != 1.0:
                combo = up if th == 0.0 else th * u + (1.0 - th) * up
                rhs = rhs - (dt * (1.0 - th)) * self._k_diff(combo)
                if self._f is not None:
                    fa = (th * fs.grid_load(self._f.evaluate, t)
                          + (1.0 - th) * fs.grid_load(self._f.evaluate,
                                                      t - dt))
                    rhs = rhs + (dt * (1.0 - th)) * fa
            res = self._solve(self._mass_op, rhs,
                              self._plane(self._dgdt, t), diff,
                              self._prec_mass, g_zero=self._dgdt.is_zero)
            return res.x.to(self.dtype).reshape(-1)
        beta, gamma = fs.beta, fs.gamma
        a_n = self._consistent_a(u, t, state.ab)
        a_m = self._consistent_a(up, t - dt, state.ab_prev)
        v = diff + dt * ((0.5 + beta - gamma) * a_m + (gamma - beta) * a_n)
        # boundary velocity straight off the carried strip (the exact
        # parity boundary recurrence)
        v = torch.where(fs.interior, v, self._strip_plane(state.vb))
        return v.to(self.dtype).reshape(-1)

    def _consistent_a(self, u_grid, t, ab_strip):
        """M a = F(t) - K u with the CARRIED derived-BC boundary
        acceleration (the parity a satisfies this identity along the
        trajectory, WaveNewmark.cpp:264-278)."""
        rhs = -self._k_diff(u_grid)
        if self._f is not None:
            rhs = rhs + self.fs.grid_load(self._f.evaluate, t)
        res = self._solve(self._mass_op, rhs, self._strip_plane(ab_strip),
                          torch.zeros_like(u_grid), self._prec_mass,
                          g_zero=False)
        return res.x.to(self.dtype)


class Fast2TermThetaSolver(_Fast2TermBase):
    method_name = "theta"

    def method_params_suffix(self) -> str:
        from tpuwave_torch.utils.naming import clean_double
        return "-theta" + clean_double(self.fs.theta)


class Fast2TermNewmarkSolver(_Fast2TermBase):
    method_name = "newmark"

    def method_params_suffix(self) -> str:
        from tpuwave_torch.utils.naming import clean_double
        return ("-gamma" + clean_double(self.fs.gamma)
                + "-beta" + clean_double(self.fs.beta))
