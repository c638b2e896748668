"""Fast (production) solver path: P1 grid-stencil schemes on torch tensors.

The operator is a constant 7-point stencil on the vertex grid
(ops/stencil.py); the explicit Newmark path uses a row-sum lumped mass (no
linear solve at all), the implicit schemes (Newmark beta > 0, theta) solve
their constrained systems by preconditioned CG (solve/cg.py) or restarted
Chebyshev blocks. The time loops are Python loops over steps; the hot
passes are the hand-written CUDA kernels of ops/kernels.py:

* :meth:`FastWaveSolver.run_leapfrog_kernel`    one launch of B1 per step
* :meth:`FastWaveSolver.run_leapfrog_multistep` one launch of B2 per
  ``steps_per_call`` steps (temporal blocking)
* :meth:`FastWaveSolver.run_leapfrog_driven_kernel` one launch of B1 per
  driven step, then an O(perimeter) overlay of g (optional forcing pass)
* :meth:`FastWaveSolver.run_leapfrog_driven_multistep` one launch of B6
  per ``steps_per_call`` driven steps (g injected inside the kernel)
* :meth:`FastWaveSolver.run_implicit_kernel`    every CG matvec through B3
* :meth:`FastWaveSolver.run_implicit_mg_kernel` MG-PCG steps: setup B7 (B9,
  B10 for theta), matvec B3, V-cycle fine level B4 + B3, update B8
* :meth:`FastWaveSolver.run_implicit_cheby`     the same setups and update
  around restarted Chebyshev blocks (B4) instead of CG
* :meth:`FastWaveSolver.run_implicit_mg_2term`  displacement-form steps:
  setup B5, matvec B3, V-cycle B4 + B3

:meth:`FastWaveSolver.run_scan` and :meth:`FastWaveSolver.run_implicit_mg`
are the same schemes in plain torch ops (the V-cycle's level operators
are B3 on the card).

:meth:`FastWaveSolver.run_leapfrog_driven` and
:meth:`FastWaveSolver.run_leapfrog_tdep` (time-dependent wave speed, the
varcoef planes of ops/stencil.py rebuilt every step) are torch ops.

Scope: P1 elements; the implicit paths take a constant wave speed,
homogeneous Dirichlet data and zero forcing — the reference's scalability
configuration (scripts/scalability_sweep.py:85-120: standing-mode, IO
off). The product engines (models/fast_engine.py) add driven g(t),
forcing and varying / time-dependent c on top of the same operators.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from tpuwave_torch.config import resolve_device
from tpuwave_torch.core.mesh import FeSpace, StructuredTriMesh
from tpuwave_torch.core.quadrature import gauss_simplex
from tpuwave_torch.ops import kernels
from tpuwave_torch.ops.assembly import (element_mass_class,
                                        element_stiffness_class)
from tpuwave_torch.ops.stencil import (P1_CLASS_CORNERS, GridStencilOperator,
                                       apply_stencil_diff,
                                       apply_varcoef_planes,
                                       assemble_varcoef_planes,
                                       boundary_mask_grid,
                                       class_matrices_to_stencil,
                                       lumped_mass_grid)
from tpuwave_torch.solve.cg import pcg, vdot
from tpuwave_torch.solve.cheby_iter import (chebyshev_coefficients,
                                            stencil_symbol_bounds)
from tpuwave_torch.solve.multigrid import gmg_for_system, kernel_cycle

__all__ = ["FastWaveSolver", "FastState", "LeapfrogState",
           "EDGE_TABLES_RANGE"]

#: the torch.profiler range around each chunk's edge tables in
#: FastWaveSolver.run_leapfrog_driven_multistep (its g_fn calls and stacks)
EDGE_TABLES_RANGE = "tpuwave_torch.edge_tables"


class FastState(NamedTuple):
    u: torch.Tensor  # (ny+1, nx+1)
    v: torch.Tensor
    a: torch.Tensor


class LeapfrogState(NamedTuple):
    """Two-array state for the explicit fast path.

    Newmark beta=0, gamma=1/2 with lumped mass is algebraically identical
    to the leapfrog / central-difference recurrence

        u^{n+1} = 2 u^n - u^{n-1} - dt^2 M_L^{-1} K u^n

    which needs only (u^n, u^{n-1}) — read 2 + write 1 arrays per step
    instead of read 3 + write 3. v^n is recoverable as
    (u^{n+1} - u^{n-1}) / (2 dt).
    """
    u: torch.Tensor
    u_prev: torch.Tensor


class FastWaveSolver:
    """Grid-stencil wave solver (explicit lumped Newmark + implicit CG).

    Parameters
    ----------
    nel, geometry : mesh spec (P1 vertex grid (ny+1, nx+1))
    dt            : time step
    c             : constant wave speed
    scheme        : 'newmark' (beta/gamma) or 'theta' (theta)
    lumped        : explicit beta=0 diagonal-mass path (no CG)
    dtype, device : of every tensor the solver builds; the device defaults
                    to "cuda" and raises where there is no card
    """

    def __init__(self, nel: Tuple[int, int], geometry, dt: float, *,
                 c: float = 1.0, scheme: str = "newmark", beta: float = 0.0,
                 gamma: float = 0.5, theta: float = 0.5, lumped: bool = True,
                 dtype: torch.dtype = torch.float32,
                 device="cuda", cg_reduction: float = 1e-6):
        self.mesh = StructuredTriMesh(tuple(nel), geometry)
        self.space = FeSpace(self.mesh, 1)
        self.shape = (self.mesh.ny + 1, self.mesh.nx + 1)
        self.dt = float(dt)
        self.c = float(c)
        self.scheme = scheme
        self.beta = float(beta)
        self.gamma = float(gamma)
        self.theta = float(theta)
        self.dtype = dtype
        self.device = resolve_device(device)
        #: CG relative-reduction factor (reference ReductionControl 1e-6)
        self.cg_reduction = float(cg_reduction)
        self.lumped = bool(lumped) and scheme == "newmark" and beta == 0.0

        quad = gauss_simplex(2)
        m_class = element_mass_class(self.space, quad)
        k_class = element_stiffness_class(self.space, quad, c * c)
        self.mass = GridStencilOperator(class_matrices_to_stencil(m_class),
                                        self.shape, dtype, self.device)
        self.stiff = GridStencilOperator(class_matrices_to_stencil(k_class),
                                         self.shape, dtype, self.device)
        self.inv_lumped = torch.tensor(1.0 / lumped_mass_grid(self.space),
                                       dtype=dtype, device=self.device)
        bnd = boundary_mask_grid(self.space)
        self.boundary = torch.tensor(bnd, device=self.device)
        self.interior = torch.tensor(~bnd, device=self.device)

        if scheme == "newmark":
            self.system = self.mass.axpy(self.beta * self.dt * self.dt,
                                         self.stiff)
        else:
            self.system = self.mass.axpy((self.theta * self.dt) ** 2,
                                         self.stiff)
        self._inv_diag = 1.0 / self.system.stencil[1][1]
        self._n_dofs = self.shape[0] * self.shape[1]
        self._load_cache = None
        self._tdep_cache = None
        self._energy_ops = None
        #: linear-solver iterations of the last ``run_*`` call, one entry
        #: per step: an int (Newmark: the a-solve; 2-term: the u-solve) or
        #: a (u-solve, v-solve) pair (theta)
        self.last_iterations = []

    # ------------------------------------------------------------------
    def grid_coords(self):
        """(ny+1, nx+1) x and y coordinate planes on the solver's device."""
        (x0, y0) = self.mesh.origin
        ny1, nx1 = self.shape
        ix = torch.arange(nx1, dtype=self.dtype, device=self.device)
        iy = torch.arange(ny1, dtype=self.dtype, device=self.device)
        xs = (x0 + self.mesh.hx * ix)[None, :].expand(ny1, nx1)
        ys = (y0 + self.mesh.hy * iy)[:, None].expand(ny1, nx1)
        return xs, ys

    def _stiff_diff(self, u):
        """K u in zero-row-sum difference form (apply_stencil_diff)."""
        return apply_stencil_diff(u, self.stiff.stencil)

    def _as_grid(self, v):
        return torch.broadcast_to(
            torch.as_tensor(v, dtype=self.dtype, device=self.device),
            self.shape).contiguous()

    def initial_state(self, u0_fn, v0_fn=None) -> FastState:
        """Interpolate initial data; consistent a0 from the lumped mass."""
        xs, ys = self.grid_coords()
        u0 = self._as_grid(u0_fn(xs, ys))
        v0 = (torch.zeros(self.shape, dtype=self.dtype, device=self.device)
              if v0_fn is None else self._as_grid(v0_fn(xs, ys)))
        a0 = torch.where(self.boundary, 0.0,
                         -self._stiff_diff(u0) * self.inv_lumped)
        return FastState(u=u0, v=v0, a=a0.to(self.dtype))

    def initial_state_consistent(self, u0_fn, v0_fn=None) -> FastState:
        """Consistent-mass a0: solve M a0 = -K u0 by CG to the parity
        tolerances (reference WaveNewmark.cpp:298-390; homogeneous data so
        a0|boundary = 0) — use for digit-parity runs of the implicit
        schemes instead of the lumped a0 of initial_state."""
        st = self.initial_state(u0_fn, v0_fn)
        return FastState(u=st.u, v=st.v, a=self._consistent_accel(st.u))

    # ------------------------------------------------------------------
    def _explicit_step(self, state: FastState) -> FastState:
        """Lumped-mass central difference (Newmark beta=0, gamma=1/2):
        one stencil apply + elementwise updates, zero solves."""
        dt = self.dt
        u, v, a = state
        z = u + dt * v + (0.5 * dt * dt) * a
        a_new = torch.where(self.boundary, 0.0,
                            -self.stiff(z) * self.inv_lumped)
        a_new = a_new.to(self.dtype)
        v_new = v + (0.5 * dt) * (a + a_new)
        return FastState(u=z, v=v_new, a=a_new)

    def _solve_abs_tol(self, rhs, x0, op):
        """Absolute residual floor for the fast-path solves: the
        reference's 1e-12 in f64; in f32 the backward-error floor
        eta * (lam_max ||x0|| + ||b||), eta = 8 eps (a fixed floor would
        stop at zero iterations on fine meshes; tpuwave
        models/fast.py::_solve_abs_tol)."""
        if self.dtype == torch.float64:
            return 1e-12
        from tpuwave_torch.solve.cheby_iter import stencil_symbol_bounds
        lam_max = stencil_symbol_bounds(op.stencil)[1]
        eta = 8 * float(torch.finfo(self.dtype).eps)
        return eta * (lam_max * torch.linalg.vector_norm(x0)
                      + torch.linalg.vector_norm(rhs))

    @property
    def _max_iter(self) -> int:
        return 10000 if self.dtype == torch.float64 else 2000

    def _constrained(self, op, kernel: bool = False):
        """The constrained operator of the implicit solves: interior rows
        op(w masked to 0 on pinned nodes), pinned rows diag * w. In torch
        ops, or with ``kernel`` through kernel B3."""
        st, diag = op.stencil, op.stencil[1][1]
        if kernel:
            def apply_c(w):
                return kernels.constrained_stencil_apply(w, st, diag)
        else:
            def apply_c(w):
                return torch.where(
                    self.interior, op(torch.where(self.interior, w, 0.0)),
                    diag * w)
        return apply_c

    def _implicit_newmark_step(self, state: FastState, precond=None,
                               kernel: bool = False):
        """One Newmark (beta > 0) step; returns (state, CG iterations)."""
        dt, beta, gamma = self.dt, self.beta, self.gamma
        u, v, a = state
        z = u + dt * v + (dt * dt * (0.5 - beta)) * a
        rhs = torch.where(self.interior, -self.stiff(z), 0.0)

        x0 = torch.where(self.interior, a, 0.0)
        res = pcg(self._constrained(self.system, kernel), rhs, x0,
                  precond_inv_diag=(self._inv_diag if precond is None
                                    else precond),
                  abs_tol=self._solve_abs_tol(rhs, x0, self.system),
                  max_iter=self._max_iter, reduction=self.cg_reduction)
        a_new = res.x.to(self.dtype)
        u_new = z + (beta * dt * dt) * a_new
        v_new = v + dt * ((1.0 - gamma) * a + gamma * a_new)
        return FastState(u=u_new, v=v_new, a=a_new), res.iterations

    def _theta_step(self, state: FastState, precond=None,
                    kernel: bool = False):
        """Stencil theta-method (homogeneous BCs, no forcing): two CG
        solves per step like the reference WaveTheta, on grid stencils.
        ``precond`` overrides the u-system preconditioner (the v-system is
        the bare mass: mesh-independent conditioning, Jacobi suffices).
        Both solves warm-start from the old values, as the fused setups
        (kernels B9, B10) do. Returns (state, (u-solve, v-solve)
        iterations)."""
        dt, th = self.dt, self.theta
        u, v, a = state
        mu, ku, mv = self.mass(u), self.stiff(u), self.mass(v)

        rhs_u = torch.where(
            self.interior,
            mu - (dt * dt * th * (1.0 - th)) * ku + dt * mv, 0.0)
        x0_u = torch.where(self.interior, u, 0.0)
        res_u = pcg(self._constrained(self.system, kernel), rhs_u, x0_u,
                    precond_inv_diag=(self._inv_diag if precond is None
                                      else precond),
                    abs_tol=self._solve_abs_tol(rhs_u, x0_u, self.system),
                    max_iter=self._max_iter, reduction=self.cg_reduction)
        u_new = res_u.x.to(self.dtype)

        rhs_v = torch.where(
            self.interior,
            mv - (dt * (1.0 - th)) * ku - (dt * th) * self.stiff(u_new),
            0.0)
        x0_v = torch.where(self.interior, v, 0.0)
        res_v = pcg(self._constrained(self.mass, kernel), rhs_v, x0_v,
                    precond_inv_diag=1.0 / self.mass.stencil[1][1],
                    abs_tol=self._solve_abs_tol(rhs_v, x0_v, self.mass),
                    max_iter=self._max_iter, reduction=self.cg_reduction)
        v_new = res_v.x.to(self.dtype)
        return (FastState(u=u_new, v=v_new, a=a),
                (res_u.iterations, res_v.iterations))

    def _step_counted(self, state: FastState, precond=None,
                      kernel: bool = False):
        """(next state, solver iterations) of one step of the scheme."""
        if self.scheme == "theta":
            return self._theta_step(state, precond, kernel)
        if self.lumped:
            return self._explicit_step(state), 0
        return self._implicit_newmark_step(state, precond, kernel)

    def step(self, state: FastState) -> FastState:
        return self._step_counted(state)[0]

    # ------------------------------------------------------------------
    # leapfrog (two-array) explicit path — same trajectory as the lumped
    # Newmark beta=0 path, minimal memory traffic
    # ------------------------------------------------------------------
    def initial_leapfrog_state(self, u0_fn, v0_fn=None, f_fn=None,
                               g_fn=None) -> LeapfrogState:
        """(u^1, u^0): the first step is taken via the 3-array scheme so the
        trajectory matches the Newmark path bit-for-bit from step 2 on.

        Optional ``f_fn`` makes the start forcing-aware (consistent load in
        a^0 and the half-step, reference WaveNewmark.cpp:298-343); optional
        ``g_fn`` pins u^1 boundary data at t = dt. Both get t as a 0-d
        tensor of the state's dtype.
        """
        if f_fn is None and g_fn is None:
            st = self.initial_state(u0_fn, v0_fn)
            st1 = self._explicit_step(st)
            return LeapfrogState(u=st1.u, u_prev=st.u)
        dt = self.dt
        xs, ys = self.grid_coords()
        u0 = self._as_grid(u0_fn(xs, ys))
        v0 = (torch.zeros(self.shape, dtype=self.dtype, device=self.device)
              if v0_fn is None else self._as_grid(v0_fn(xs, ys)))
        t0, t1 = self._times((0.0, dt))
        rhs = -self._stiff_diff(u0)
        if f_fn is not None:
            rhs = rhs + self.grid_load(f_fn, t0)
        a0 = torch.where(self.boundary, 0.0, rhs * self.inv_lumped)
        u1 = u0 + dt * v0 + (0.5 * dt * dt) * a0
        if g_fn is None:
            u1 = torch.where(self.boundary, 0.0, u1)
        else:
            u1 = torch.where(self.boundary, self._as_grid(g_fn(xs, ys, t1)),
                             u1)
        return LeapfrogState(u=u1.to(self.dtype), u_prev=u0)

    def leapfrog_step(self, state: LeapfrogState) -> LeapfrogState:
        """One plain-PyTorch leapfrog step (roll stencil, lumped mass)."""
        dt2 = self.dt * self.dt
        u, u_prev = state
        u_next = 2.0 * u - u_prev - dt2 * (self.stiff(u) * self.inv_lumped)
        u_next = torch.where(self.boundary, 0.0, u_next).to(self.dtype)
        return LeapfrogState(u=u_next, u_prev=u)

    def run_leapfrog_scan(self, state: LeapfrogState,
                          n_steps: int) -> LeapfrogState:
        """``n_steps`` plain leapfrog steps (the reference path the kernel
        runners are held against)."""
        for _ in range(int(n_steps)):
            state = self.leapfrog_step(state)
        return state

    # ------------------------------------------------------------------
    # driven (time-dependent Dirichlet) leapfrog: u|boundary = g(x, y, t)
    # pinned at every step. ``g_fn`` / ``f_fn`` are callables
    # (x, y, t) -> tensor (or a number) on torch tensors, such as
    # utils/expr.py::Expression.evaluate; ``t`` comes as a 0-d tensor of
    # the state's dtype on its device.
    # ------------------------------------------------------------------
    def _times(self, times) -> torch.Tensor:
        return torch.as_tensor(times, dtype=self.dtype,
                               device=self.device).reshape(-1)

    def leapfrog_step_driven(self, state: LeapfrogState, t, g_fn,
                             f_fn=None) -> LeapfrogState:
        """One leapfrog step with u|dOmega = g_fn(x, y, t) at the NEW time.

        Interior recurrence identical to leapfrog_step; boundary nodes are
        pinned to g. ``t`` is the time being stepped TO (t^{n+1}). Optional
        ``f_fn`` adds the quadrature-consistent forcing load F(t^n) (the
        semi-discrete recurrence reads M a^n = F^n - K u^n, so f acts at
        the FROM time t - dt; :meth:`grid_load`)."""
        dt2 = self.dt * self.dt
        u, u_prev = state
        accel = -self.stiff(u) * self.inv_lumped
        if f_fn is not None:
            accel = accel + self.grid_load(f_fn, t - self.dt) * self.inv_lumped
        u_next = 2.0 * u - u_prev + dt2 * accel
        xs, ys = self.grid_coords()
        u_next = torch.where(self.boundary, self._as_grid(g_fn(xs, ys, t)),
                             u_next).to(self.dtype)
        return LeapfrogState(u=u_next, u_prev=u)

    def run_leapfrog_driven(self, state: LeapfrogState, times, g_fn,
                            f_fn=None) -> LeapfrogState:
        """One :meth:`leapfrog_step_driven` per stamp of ``times`` (the
        times being stepped TO, accumulated like the reference loop), in
        torch ops."""
        for t in self._times(times):
            state = self.leapfrog_step_driven(state, t, g_fn, f_fn)
        return state

    def _edge_coords(self):
        """((x, y) of the bottom row, top row, left column, right column),
        each a pair of (1, n) tensors cut from :meth:`grid_coords`, so an
        edge value equals the full-grid evaluation's bit for bit."""
        xs, ys = self.grid_coords()
        return ((xs[:1], ys[:1]), (xs[-1:], ys[-1:]),
                (xs[:, 0][None], ys[:, 0][None]),
                (xs[:, -1][None], ys[:, -1][None]))

    def _edge_values(self, g_fn, t):
        """g on the four edges at time(s) ``t``: a 0-d tensor gives four
        (1, n) rows; a (k, 1) tensor gives four (k, n) tables."""
        out = []
        for x, y in self._edge_coords():
            shape = (t.shape[0] if t.dim() else 1, x.shape[1])
            out.append(torch.broadcast_to(torch.as_tensor(
                g_fn(x, y, t), dtype=self.dtype, device=self.device), shape))
        return out

    def run_leapfrog_driven_kernel(self, state: LeapfrogState, times, g_fn,
                                   f_fn=None) -> LeapfrogState:
        """Driven leapfrog on kernel B1 (tpuwave: run_leapfrog_driven_pallas).

        B1 computes the interior update and zeroes the pinned nodes; an
        optional forcing pass adds dt^2 F(t - dt) / M_L on interior nodes;
        the driven data at ``t`` are then overlaid on the four edges
        (O(perimeter) slice writes) — the algebra of
        :meth:`leapfrog_step_driven`. For temporal blocking use
        :meth:`run_leapfrog_driven_multistep` (no forcing there)."""
        stencil, coef = self._kernel_args()
        dt2 = self.dt * self.dt
        h, w = self.shape
        u, up = state.u.contiguous(), state.u_prev.contiguous()
        for t in self._times(times):
            un = kernels.leapfrog_step(u, up, stencil, coef)
            if f_fn is not None:
                load = self.grid_load(f_fn, t - self.dt) * self.inv_lumped
                un = torch.where(self.interior, un + dt2 * load, un)
            g_bot, g_top, g_lft, g_rgt = self._edge_values(g_fn, t)
            un[0, :] = g_bot[0]
            un[h - 1, :] = g_top[0]
            un[:, 0] = g_lft[0]
            un[:, w - 1] = g_rgt[0]
            u, up = un, u
        return LeapfrogState(u=u, u_prev=up)

    def run_leapfrog_driven_multistep(self, state: LeapfrogState, times,
                                      g_fn, steps_per_call: int = 8
                                      ) -> LeapfrogState:
        """Driven leapfrog with temporal blocking: ``steps_per_call`` steps
        per launch of kernel B6, which injects each substep's boundary
        values inside the kernel by global coordinates (tpuwave:
        run_leapfrog_driven_multistep).

        ``times``: the stamps being stepped TO, a multiple of
        ``steps_per_call`` long. No forcing on this path (a full f plane
        per substep would defeat the blocking; use
        :meth:`run_leapfrog_driven_kernel`). Each chunk's edge tables come
        from FOUR calls of ``g_fn`` with t as a (k, 1) tensor against
        (1, n) edge coordinates, so ``g_fn`` must broadcast in t (torch
        callables and Expression.evaluate do)."""
        k = int(steps_per_call)
        times = self._times(times)
        n = int(times.shape[0])
        if k < 1 or n % k != 0:
            raise ValueError("len(times) must be a multiple of "
                             "steps_per_call")
        stencil, coef = self._kernel_args()
        u, up = state.u.contiguous(), state.u_prev.contiguous()
        for c in range(n // k):
            ts = times[c * k:(c + 1) * k].reshape(k, 1)
            # a profiler range: the host's time on the chunk's tables
            with torch.profiler.record_function(EDGE_TABLES_RANGE):
                g_bot, g_top, g_lft, g_rgt = self._edge_values(g_fn, ts)
                gtb = torch.stack([g_bot, g_top], dim=1)   # (k, 2, W)
                glr = torch.stack([g_lft, g_rgt], dim=2)   # (k, H, 2)
            u, up = kernels.leapfrog_multistep_driven(u, up, gtb, glr,
                                                      stencil, coef, k)
        return LeapfrogState(u=u, u_prev=up)

    def leapfrog_velocity(self, state_next: LeapfrogState,
                          state: LeapfrogState):
        """v^n = (u^{n+1} - u^{n-1}) / (2 dt)."""
        return (state_next.u - state.u_prev) / (2.0 * self.dt)

    # ------------------------------------------------------------------
    # consistent P1 load vector (forcing)
    # ------------------------------------------------------------------
    def _load_data(self):
        if self._load_cache is None:
            quad = gauss_simplex(2)
            sh = self.space.shape_at(quad)
            vals = np.asarray(sh.values)                    # (Q, 3)
            ref = np.asarray(quad.points)                   # (Q, 2)
            frac = np.empty((2, len(ref), 2))
            for k in range(2):
                c0, c1, c2_ = (np.asarray(c, float)
                               for c in P1_CLASS_CORNERS[k])
                frac[k] = (c0[None]
                           + ref[:, 0:1] * (c1 - c0)[None]
                           + ref[:, 1:2] * (c2_ - c0)[None])
            self._load_cache = (vals, frac, np.asarray(quad.weights),
                                float(self.mesh.det_j))
        return self._load_cache

    def grid_load(self, f_fn, t):
        """Consistent P1 load vector on the (ny+1, nx+1) vertex grid.

        ``f_fn(x, y, t)`` is evaluated at the 2x3 assembly quadrature
        points of every triangle; contributions scatter to the three
        incident vertices by slice-adds (exact everywhere, including
        boundary rows — no roll wrap involved).
        """
        vals, frac, w, det = self._load_data()
        ny, nx = self.mesh.ny, self.mesh.nx
        (x0, y0) = self.mesh.origin
        hx, hy = self.mesh.hx, self.mesh.hy
        ix = torch.arange(nx, dtype=self.dtype,
                          device=self.device)[None, :].expand(ny, nx)
        iy = torch.arange(ny, dtype=self.dtype,
                          device=self.device)[:, None].expand(ny, nx)
        out = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        for k in range(2):
            for q in range(frac.shape[1]):
                fx, fy = float(frac[k, q, 0]), float(frac[k, q, 1])
                fv = torch.broadcast_to(torch.as_tensor(
                    f_fn(x0 + (ix + fx) * hx, y0 + (iy + fy) * hy, t),
                    dtype=self.dtype, device=self.device), (ny, nx))
                for a in range(3):
                    ox, oy = P1_CLASS_CORNERS[k][a]
                    out[oy:oy + ny, ox:ox + nx] += (
                        (det * float(w[q]) * float(vals[q, a])) * fv)
        return out

    # ------------------------------------------------------------------
    # time-dependent wave speed on the explicit path: the variable-
    # coefficient 9-plane stencil (ops/stencil.py, shared with the FWI
    # propagator) reassembled from c(x, y, t) at the assembly quadrature
    # points every step, in torch ops (tpuwave has no kernel here)
    # ------------------------------------------------------------------
    def _tdep_data(self):
        """(G class matrices (2, 3, 3), quadrature offsets in the unit
        cell (2, Q, 2), weights (Q,), det J): host constants."""
        if self._tdep_cache is None:
            quad = gauss_simplex(2)
            sh = self.space.shape_at(quad)
            grads = np.asarray(self.space.physical_grads(sh))  # (2,Q,3,2)
            g_class = np.einsum("cqia,cqja->cqij", grads, grads)[:, 0]
            ref = np.asarray(quad.points)                   # (Q, 2)
            frac = np.empty((2, len(ref), 2))
            for k in range(2):
                c0, c1, c2_ = (np.asarray(c, float)
                               for c in P1_CLASS_CORNERS[k])
                frac[k] = (c0[None]
                           + ref[:, 0:1] * (c1 - c0)[None]
                           + ref[:, 1:2] * (c2_ - c0)[None])
            self._tdep_cache = (g_class, frac, np.asarray(quad.weights),
                                float(self.mesh.det_j))
        return self._tdep_cache

    def _tdep_scales(self, c_fn, t):
        """(ny, nx, 2) per-triangle scales det * sum_q w_q c^2(x_q, t):
        the compact payload the varcoef planes are assembled from (the
        time-dependent engines carry it across steps)."""
        _, frac, w, det = self._tdep_data()
        ny, nx = self.mesh.ny, self.mesh.nx
        (x0, y0) = self.mesh.origin
        hx, hy = self.mesh.hx, self.mesh.hy
        ix = torch.arange(nx, dtype=self.dtype,
                          device=self.device)[None, :].expand(ny, nx)
        iy = torch.arange(ny, dtype=self.dtype,
                          device=self.device)[:, None].expand(ny, nx)
        out = []
        for k in range(2):
            acc = None
            for q in range(frac.shape[1]):
                fx, fy = float(frac[k, q, 0]), float(frac[k, q, 1])
                c2 = torch.as_tensor(
                    c_fn(x0 + (ix + fx) * hx, y0 + (iy + fy) * hy, t),
                    dtype=self.dtype, device=self.device) ** 2
                term = float(w[q]) * torch.broadcast_to(c2, (ny, nx))
                acc = term if acc is None else acc + term
            out.append(det * acc)
        return torch.stack(out, dim=-1)

    def _planes_from_scales(self, s):
        return assemble_varcoef_planes(s, self._tdep_data()[0],
                                       self.mesh.ny, self.mesh.nx)

    def _tdep_planes(self, c_fn, t):
        return self._planes_from_scales(self._tdep_scales(c_fn, t))

    def leapfrog_step_tdep(self, state: LeapfrogState, t, c_fn, g_fn=None,
                           f_fn=None) -> LeapfrogState:
        """One explicit lumped-mass leapfrog step with c = c_fn(x, y, t).

        Semi-discrete equation at t^n: M a^n = F^n - K(t^n) u^n, so the
        stiffness is evaluated at the time being stepped FROM (``t`` =
        t^n; the state lands at t^n + dt). Optional ``g_fn`` pins
        time-dependent Dirichlet data at t^{n+1}; optional ``f_fn`` adds
        the quadrature-consistent forcing load F(t^n)."""
        dt2 = self.dt * self.dt
        u, u_prev = state
        ku = apply_varcoef_planes(self._tdep_planes(c_fn, t), u)
        accel = -ku * self.inv_lumped
        if f_fn is not None:
            accel = accel + self.grid_load(f_fn, t) * self.inv_lumped
        u_next = 2.0 * u - u_prev + dt2 * accel
        if g_fn is None:
            u_next = torch.where(self.boundary, 0.0, u_next)
        else:
            xs, ys = self.grid_coords()
            u_next = torch.where(self.boundary,
                                 self._as_grid(g_fn(xs, ys, t + self.dt)),
                                 u_next)
        return LeapfrogState(u=u_next.to(self.dtype), u_prev=u)

    def run_leapfrog_tdep(self, state: LeapfrogState, times, c_fn,
                          g_fn=None, f_fn=None) -> LeapfrogState:
        """One :meth:`leapfrog_step_tdep` per FROM-time stamp of ``times``
        (t^n values; each step lands at t^n + dt), the planes rebuilt
        every step."""
        for t in self._times(times):
            state = self.leapfrog_step_tdep(state, t, c_fn, g_fn, f_fn)
        return state

    # ------------------------------------------------------------------
    # the hand-written kernels (ops/kernels.py): B1 and B2
    # ------------------------------------------------------------------
    def _kernel_args(self):
        # interior lumped mass = detJ (6 triangles x detJ/6)
        return self.stiff.stencil, self.dt * self.dt / self.mesh.det_j

    def run_leapfrog_kernel(self, state: LeapfrogState,
                            n_steps: int) -> LeapfrogState:
        """``n_steps`` leapfrog steps, one launch of kernel B1 each
        (tpuwave: run_leapfrog_pallas). On CPU tensors the kernel's plain
        version runs."""
        stencil, coef = self._kernel_args()
        u, up = state.u.contiguous(), state.u_prev.contiguous()
        for _ in range(int(n_steps)):
            u, up = kernels.leapfrog_step(u, up, stencil, coef), u
        return LeapfrogState(u=u, u_prev=up)

    def run_leapfrog_multistep(self, state: LeapfrogState, n_steps: int,
                               steps_per_call: int = 4) -> LeapfrogState:
        """Temporally blocked path: ``steps_per_call`` steps per launch of
        kernel B2 (device-memory traffic ~ (2 reads + 2 writes) /
        steps_per_call arrays per step). ``n_steps`` must be a multiple
        of ``steps_per_call``."""
        if n_steps % steps_per_call != 0:
            raise ValueError("n_steps must be a multiple of steps_per_call")
        stencil, coef = self._kernel_args()
        u, up = state.u.contiguous(), state.u_prev.contiguous()
        for _ in range(n_steps // steps_per_call):
            u, up = kernels.leapfrog_multistep(u, up, stencil, coef,
                                               steps_per_call)
        return LeapfrogState(u=u, u_prev=up)

    # ------------------------------------------------------------------
    def _run(self, state, n_steps: int, step_counted):
        """``n_steps`` of ``step_counted(state) -> (state, iterations)``,
        the iteration counts kept in ``last_iterations``."""
        self.last_iterations = []
        for _ in range(int(n_steps)):
            state, its = step_counted(state)
            self.last_iterations.append(its)
        return state

    def _require_implicit(self, name: str) -> None:
        if self.scheme not in ("newmark", "theta"):
            raise ValueError(f"{name} needs scheme newmark/theta")
        if self.scheme == "newmark" and self.beta <= 1e-12:
            raise ValueError(
                f"{name} needs beta > 0 (explicit beta=0 is the "
                "leapfrog/lumped path: run_leapfrog_* / run_scan)")

    def run_scan(self, state: FastState, n_steps: int) -> FastState:
        """The whole time loop of :meth:`step` (the fast-mode analogue of
        the reference while-loop, WaveTheta.cpp:372-411, with IO off), in
        torch ops."""
        return self._run(state, n_steps, self._step_counted)

    # ------------------------------------------------------------------
    # implicit stepping with geometric-multigrid-preconditioned CG: the
    # large-dt path. Single-level polynomial solvers need O(dt/h)
    # iterations once (theta dt / h)^2 or (beta dt^2 / h^2) dominates; the
    # V-cycle's contraction is h- and dt-independent (solve/multigrid.py),
    # replacing the reference's ML-AMG (WaveTheta.cpp:276-286) with a
    # geometric hierarchy.
    # ------------------------------------------------------------------
    def gmg_preconditioner(self, *, pre_degree: int = 1,
                           smooth_range: float = 8.0,
                           coarse_tol: float = 1e-2):
        """V-cycle preconditioner for this solver's implicit system
        (M + beta dt^2 K for Newmark, M + (theta dt)^2 K for theta), with
        tpuwave's default smoother degree 1 (``gmg_for_system``'s own is 2);
        CG's stopping rule keeps the solution accuracy, only the iteration
        split changes."""
        coef = (self.beta * self.dt * self.dt if self.scheme == "newmark"
                else (self.theta * self.dt) ** 2)
        return gmg_for_system(
            (self.mesh.nx, self.mesh.ny), self.mesh.geometry, self.c, coef,
            pre_degree=pre_degree, smooth_range=smooth_range,
            coarse_tol=coarse_tol)

    def _kernel_gmg(self, **mg):
        """The V-cycle for the kernel paths: its fine level on B4 / B3
        (:class:`KernelGmgPreconditioner`) when the hierarchy has >= 2
        levels, else the one-level cycle of :meth:`gmg_preconditioner`
        (nothing to fuse; its level operator is B3 all the same)."""
        return kernel_cycle(self.gmg_preconditioner(**mg))

    def run_implicit_mg(self, state: FastState, n_steps: int, *,
                        pre_degree: int = 1, smooth_range: float = 8.0,
                        coarse_tol: float = 1e-2) -> FastState:
        """Newmark (beta>0) or theta stepping with MG-PCG linear solves
        (same stopping contract as the other implicit paths), setup and
        matvec in torch ops."""
        self._require_implicit("run_implicit_mg")
        precond = self.gmg_preconditioner(
            pre_degree=pre_degree, smooth_range=smooth_range,
            coarse_tol=coarse_tol)
        return self._run(state, n_steps,
                         lambda st: self._step_counted(st, precond))

    def run_implicit_kernel(self, state: FastState,
                            n_steps: int) -> FastState:
        """Newmark (beta>0) or theta stepping where every CG matvec is
        kernel B3 (tpuwave: run_implicit_pallas), Jacobi-preconditioned;
        the setup stays in torch ops."""
        self._require_implicit("run_implicit_kernel")
        return self._run(
            state, n_steps,
            lambda st: self._step_counted(st, kernel=True))

    def _abs_tol_of(self, op, bn2, xn2, eta):
        """The backward-error floor eta (lam_max ||x0|| + ||b||) from the
        squared norms a setup kernel reduced (see _solve_abs_tol)."""
        lam_max = stencil_symbol_bounds(op.stencil)[1]
        return eta * (lam_max * torch.sqrt(xn2) + torch.sqrt(bn2))

    def setup_coefficients(self) -> dict:
        """Scalar arguments of the setup / update kernels B7-B10 for this
        scheme and time step, keyed by kernel (rhs_r0, update, r0u, r0v)
        in the wrappers' argument order."""
        dt, beta, gamma, th = self.dt, self.beta, self.gamma, self.theta
        return dict(
            rhs_r0=dict(c_zv=dt, c_za=dt * dt * (0.5 - beta)),
            update=dict(c_ua=beta * dt * dt, c_va=dt * (1.0 - gamma),
                        c_van=dt * gamma),
            r0u=dict(c_comb=-dt * dt * th * (1.0 - th), c_r0k=-dt * dt * th,
                     c_mv=dt),
            r0v=dict(c_ku=-dt * (1.0 - th), c_kun=-dt * th))

    def _fused_steps(self, solve_sys, solve_mass):
        """One step of the fused implicit paths around two linear solvers.

        ``solve_*(r0, rn2, bn2, xn2) -> (e, iterations)`` solves the
        system / mass equation A e = r0 from e = 0, given the squared norms
        of r0, rhs and x0 for its stopping rule. Newmark: B7 -> solve ->
        B8. Theta: B9 -> solve -> B10 -> mass solve; v' = masked(v) + e_v
        stays a torch op."""
        cf = self.setup_coefficients()
        m_st, k_st = self.mass.stencil, self.stiff.stencil
        a_st = self.system.stencil

        def newmark(st):
            u, v, a = st
            r0, z, rn2, bn2, xn2 = kernels.newmark_rhs_r0(
                u, v, a, k_st, a_st, **cf["rhs_r0"])
            e, its = solve_sys(r0, rn2, bn2, xn2)
            u_new, v_new, a_new = kernels.newmark_update(
                z, v, a, e.to(self.dtype), **cf["update"])
            return FastState(u=u_new, v=v_new, a=a_new), its

        def theta(st):
            u, v, a = st
            r0u, rn2, bn2, xn2 = kernels.theta_r0u(u, v, m_st, k_st,
                                                   **cf["r0u"])
            e_u, its_u = solve_sys(r0u, rn2, bn2, xn2)
            u_new, r0v, rn2v, bn2v, xn2v = kernels.theta_r0v(
                u, e_u.to(self.dtype), v, m_st, k_st, **cf["r0v"])
            e_v, its_v = solve_mass(r0v, rn2v, bn2v, xn2v)
            v_new = torch.where(self.interior, v, 0.0) + e_v
            return (FastState(u=u_new, v=v_new.to(self.dtype), a=a),
                    (its_u, its_v))

        return newmark if self.scheme == "newmark" else theta

    def run_implicit_mg_kernel(self, state: FastState, n_steps: int, *,
                               pre_degree: int = 1, smooth_range: float = 8.0,
                               coarse_tol: float = 1e-2) -> FastState:
        """MG-PCG stepping with the solve setup (r0 + stopping-rule norms:
        kernel B7, or B9 / B10), every CG matvec (B3), the V-cycle's fine
        level (B4 + B3) and the Newmark state update (B8) on the
        hand-written kernels — the production form of
        :meth:`run_implicit_mg` (tpuwave: run_implicit_mg_pallas). The
        state stays at its true shape, on any grid size. With a one-level
        hierarchy the V-cycle is the plain one-level cycle (nothing to
        fuse); B7-B10 and B3 run all the same. The theta v-solve is
        Jacobi-CG on the bare mass."""
        self._require_implicit("run_implicit_mg_kernel")
        precond = self._kernel_gmg(pre_degree=pre_degree,
                                   smooth_range=smooth_range,
                                   coarse_tol=coarse_tol)
        eta = (None if self.dtype == torch.float64
               else 8 * float(torch.finfo(self.dtype).eps))

        def solver(op, prec):
            apply_c = self._constrained(op, kernel=True)

            def solve(r0, rn2, bn2, xn2):
                res = pcg(apply_c, r0, torch.zeros_like(r0), r0=r0,
                          norm0_sq=rn2, precond_inv_diag=prec,
                          abs_tol=(1e-12 if eta is None else
                                   self._abs_tol_of(op, bn2, xn2, eta)),
                          max_iter=self._max_iter,
                          reduction=self.cg_reduction)
                return res.x, res.iterations
            return solve

        step = self._fused_steps(
            solver(self.system, precond),
            solver(self.mass, 1.0 / self.mass.stencil[1][1]))
        return self._run(state, n_steps, step)

    def run_implicit_cheby(self, state: FastState, n_steps: int,
                           degree: int = 8,
                           degree_v: int | None = None) -> FastState:
        """Newmark (beta>0) or theta stepping where each linear system is
        solved by restarted Chebyshev iteration with analytic stencil-symbol
        eigenvalue bounds, ``degree`` iterations per pass of kernel B4,
        around the fused setups and update (B7-B10). One host read of
        ||r||^2 per block.

        Stopping rule (tpuwave's, unchanged): ||r||^2 <= max(floor^2,
        1e-12 ||r0||^2) with floor = eta (lam_max ||x0|| + ||rhs||), eta =
        8 eps in f32 and 1e-12 in f64 — a fixed 1e-6 reduction that does
        not read ``cg_reduction``; the iteration count advances by the
        block degree.

        ``degree_v`` sets a separate block degree for the theta v-solve
        (default 10), whose operator is the bare mass matrix: its condition
        number is mesh-independent, so the iterations needed are fixed
        regardless of mesh, while the best degree for the
        stiffness-dominated u-system varies with theta dt / h."""
        self._require_implicit("run_implicit_cheby")
        eta = (1e-12 if self.dtype == torch.float64
               else 8 * float(torch.finfo(self.dtype).eps))
        # tpuwave's relative factor: 1e-12 rounded to f32
        rel2 = float(np.float32(1e-12))
        max_iter = self._max_iter

        def solver(op, deg):
            st = op.stencil
            lo, hi = stencil_symbol_bounds(st)
            theta_c, coeffs = chebyshev_coefficients(lo, hi, deg)
            coeffs = tuple(coeffs)

            def solve(r0, rn2, bn2, xn2):
                floor = self._abs_tol_of(op, bn2, xn2, eta)
                tol2 = torch.maximum(floor * floor, rel2 * rn2)
                rr, tol2 = torch.stack([rn2, tol2]).tolist()
                x, r, k = torch.zeros_like(r0), r0, 0
                while rr > tol2 and k < max_iter:
                    x, r, rn2 = kernels.cheby_block(x, r, st, theta_c,
                                                    coeffs)
                    rr = float(rn2)
                    k += deg
                return x, k
            return solve

        step = self._fused_steps(
            solver(self.system, int(degree)),
            solver(self.mass, 10 if degree_v is None else int(degree_v)))
        return self._run(state, n_steps, step)

    # ------------------------------------------------------------------
    # displacement-form implicit stepping (two-array state): the
    # implicit twin of the leapfrog path. Eliminating the auxiliary
    # variables (v, a for Newmark using M a^n = -K u^n, exact along the
    # discrete trajectory; v for the theta family from its two update
    # equations) gives 3-term displacement recurrences
    #
    #   Newmark: (M + b dt^2 K) u^{n+1} = M (2u^n - u^{n-1})
    #                             - dt^2 (g + 1/2 - 2b) K u^n
    #                             - dt^2 (1/2 - g + b)  K u^{n-1}
    #   theta:   (M + t^2 dt^2 K) u^{n+1} = M (2u^n - u^{n-1})
    #                             - dt^2 K [2t(1-t) u^n + (1-t)^2 u^{n-1}]
    #
    # (b = beta, g = gamma, t = theta). The free extrapolated warm start
    # x0 = 2u^n - u^{n-1} leaves the O(dt^2)-small residual
    #
    #   Newmark: r0 = -dt^2 K [ (g + 1/2) u^n + (1/2 - g) u^{n-1} ]
    #   theta:   r0 = -dt^2 K [ 2t u^n + (1 - 2t) u^{n-1} ]
    #
    # so each step costs ONE fused stencil pass for r0 (kernel B5) plus a
    # near-converged MG-PCG solve — no mass/velocity solve, two-array
    # state. In f32 the implicit velocity (u^n - u^{n-1})/dt amplifies
    # per-step rounding noise by ~1/(omega dt); where noise-floor accuracy
    # matters use the 3-array paths or f64 (where this path is
    # digit-clean).
    # ------------------------------------------------------------------
    def implicit_2term_init(self, state: FastState, *, pre_degree: int = 1,
                            smooth_range: float = 8.0,
                            coarse_tol: float = 1e-2) -> LeapfrogState:
        """(u^1, u^0) from one implicit step taken in CORRECTION u-form.

        The first step is solved for u^1 directly (algebraically
        identical to the 3-array step):
          theta:   A u^1 = M u^0 - dt^2 t(1-t) K u^0 + dt M v^0,
                   x0 = u^0,  r0 = dt M v^0 - t dt^2 K u^0
          Newmark: A u^1 = M z,  z = u^0 + dt v^0 + dt^2(1/2-b) a^0,
                   x0 = z,   r0 = -b dt^2 K z
        with K applied in difference form: composing u^1 = z + b dt^2 a^1
        from the 3-array step would inject the acceleration's amplified
        f32 noise into the (u^1, u^0) pair. For Newmark, start from
        ``initial_state_consistent`` for exact agreement with the 3-array
        trajectory (the recurrence derivation uses M a^0 = -K u^0)."""
        precond = self.gmg_preconditioner(
            pre_degree=pre_degree, smooth_range=smooth_range,
            coarse_tol=coarse_tol)
        dt = self.dt
        u, v, a = state
        if self.scheme == "theta":
            th = self.theta
            x0 = torch.where(self.interior, u, 0.0)
            r0 = torch.where(self.interior,
                             dt * self.mass(v)
                             - (th * dt * dt) * self._stiff_diff(u), 0.0)
            s_init = th * dt * dt
        else:
            beta = self.beta
            z = u + dt * v + (dt * dt * (0.5 - beta)) * a
            x0 = torch.where(self.interior, z, 0.0)
            r0 = torch.where(self.interior,
                             (-beta * dt * dt) * self._stiff_diff(z), 0.0)
            s_init = beta * dt * dt
        if self.dtype == torch.float64:
            abs_tol = 1e-12
        else:
            eps = float(torch.finfo(self.dtype).eps)
            s_abs = s_init * sum(abs(cc) for row in self.stiff.stencil
                                 for cc in row)
            abs_tol = torch.minimum(
                eps * s_abs * torch.linalg.vector_norm(x0),
                0.5 * torch.linalg.vector_norm(r0))
        res = pcg(self._constrained(self.system), r0, torch.zeros_like(r0),
                  r0=r0, precond_inv_diag=precond, abs_tol=abs_tol,
                  max_iter=self._max_iter, reduction=self.cg_reduction)
        self.last_iterations = [res.iterations]
        return LeapfrogState(u=(x0 + res.x).to(self.dtype), u_prev=state.u)

    def _consistent_accel(self, u):
        """a = -M^{-1} K u by Jacobi-CG to the fast-path tolerances (K in
        difference form: the rhs must not be cancellation-noise-bound)."""
        rhs = torch.where(self.interior, -self._stiff_diff(u), 0.0)
        x0 = torch.zeros_like(rhs)
        res = pcg(self._constrained(self.mass), rhs, x0,
                  precond_inv_diag=1.0 / self.mass.stencil[1][1],
                  abs_tol=self._solve_abs_tol(rhs, x0, self.mass),
                  max_iter=self._max_iter, reduction=self.cg_reduction)
        return res.x.to(self.dtype)

    def implicit_2term_finish(self, state: LeapfrogState) -> FastState:
        """Exact (u, u_prev) -> (u, v, a) conversion (one-time mass
        solves, no approximation on top of the CG tolerances).

        Newmark:  v^N = (u^N - u^{N-1})/dt
                        + dt [ (1/2 + b - g) a^{N-1} + (g - b) a^N ]
                  with consistent M a = -K u at both times.
        theta:    v^N = (u^N - u^{N-1})/dt
                        - dt (1-t) M^{-1} K [ t u^N + (1-t) u^{N-1} ]
                  (exactly (u^N - u^{N-1})/dt for BE, t=1); a is not a
                  theta state variable and is returned as the consistent
                  acceleration of u^N for convenience."""
        dt = self.dt
        if self.scheme == "theta":
            th = self.theta
            a = self._consistent_accel(state.u)
            if th == 1.0:
                corr = 0.0
            else:
                combo = (th * state.u + (1.0 - th) * state.u_prev
                         if th != 0.0 else state.u_prev)
                # M^{-1} K combo = -consistent_accel(combo)
                corr = dt * (1.0 - th) * self._consistent_accel(combo)
            v = (state.u - state.u_prev) / dt + corr
        else:
            beta, gamma = self.beta, self.gamma
            a_prev = self._consistent_accel(state.u_prev)
            a = self._consistent_accel(state.u)
            v = ((state.u - state.u_prev) / dt
                 + dt * ((0.5 + beta - gamma) * a_prev
                         + (gamma - beta) * a))
        v = torch.where(self.interior, v, 0.0).to(self.dtype)
        return FastState(u=state.u, v=v, a=a)

    def run_implicit_mg_2term(self, state: LeapfrogState, n_steps: int, *,
                              pre_degree: int = 1, smooth_range: float = 8.0,
                              coarse_tol: float = 1e-2,
                              kernel: bool = True) -> LeapfrogState:
        """Displacement-form implicit stepping for both scheme families
        (see block comment above). ``kernel=True`` runs the r0 setup as
        kernel B5, every CG matvec as B3 and the V-cycle's fine level on
        B4 + B3 (the plain one-level cycle when the hierarchy has a single
        level); ``kernel=False`` is the same step in torch ops."""
        self._require_implicit("run_implicit_mg_2term")
        if self.scheme == "newmark":
            c_u, c_up = self.gamma + 0.5, 0.5 - self.gamma
        else:
            c_u, c_up = 2.0 * self.theta, 1.0 - 2.0 * self.theta
        dt = self.dt
        mg = dict(pre_degree=pre_degree, smooth_range=smooth_range,
                  coarse_tol=coarse_tol)
        eta = (None if self.dtype == torch.float64
               else float(torch.finfo(self.dtype).eps))
        # noise-anchored stopping for the correction solve: r0 is the
        # dt^2-scaled stencil pass -dt^2 K(combo), whose own f32
        # computation noise is ~ eps * dt^2 * sum|K coeffs| * |u|
        # elementwise. Stop at that floor when the signal is strong, and
        # ALWAYS demand at least a 2x reduction (min with 0.5 ||r0||): a
        # lam_max-based backward-error floor can exceed ||r0|| here, and
        # 0-iteration steps degenerate the recurrence to pure
        # extrapolation.
        s_abs = (abs(c_u) + abs(c_up)) * dt * dt * sum(
            abs(cc) for row in self.stiff.stencil for cc in row)

        apply_sys = self._constrained(self.system, kernel)
        if kernel:
            precond = self._kernel_gmg(**mg)
            # -dt^2 folded into the K stencil, evaluated in zero-row-sum
            # difference form (r0 must not be bound by the direct form's
            # f32 cancellation noise)
            kneg = tuple(tuple(-dt * dt * cc for cc in row)
                         for row in self.stiff.stencil)

            def setup(cu, cup):
                return kernels.recurrence_r0(cu, cup, kneg, c_u, c_up)
        else:
            precond = self.gmg_preconditioner(**mg)
            interior = self.interior

            def setup(cu, cup):
                combo = (cu if (c_u == 1.0 and c_up == 0.0)
                         else c_u * cu + c_up * cup)
                r0 = torch.where(interior,
                                 (-dt * dt) * self._stiff_diff(combo), 0.0)
                x0 = torch.where(interior, 2.0 * cu - cup, 0.0)
                return r0, x0, vdot(r0, r0), vdot(x0, x0)

        def step(c):
            cu, cup = c
            r0, x0, rn2, xn2 = setup(cu, cup)
            abs_tol = (1e-12 if eta is None
                       else torch.minimum(eta * s_abs * torch.sqrt(xn2),
                                          0.5 * torch.sqrt(rn2)))
            res = pcg(apply_sys, r0, torch.zeros_like(r0), r0=r0,
                      norm0_sq=rn2, precond_inv_diag=precond,
                      abs_tol=abs_tol, max_iter=self._max_iter,
                      reduction=self.cg_reduction)
            return (LeapfrogState(u=(x0 + res.x).to(self.dtype), u_prev=cu),
                    res.iterations)

        return self._run(LeapfrogState(state.u.contiguous(),
                                       state.u_prev.contiguous()),
                         n_steps, step)

    def energy(self, state: FastState) -> torch.Tensor:
        """E = 1/2 (v M v + u K u) in f64, a 0-d tensor: the boundary-
        correct quadratic forms of the parity engine's element operators
        (ops/operators.py), built once and cached."""
        if self._energy_ops is None:
            from tpuwave_torch.ops.operators import (CellConnectivity,
                                                     MatrixFreeOperator)
            quad = gauss_simplex(2)
            conn = CellConnectivity(self.space.cell_dofs, self.space.n_dofs,
                                    self.device)
            self._energy_ops = tuple(
                MatrixFreeOperator(conn, a_class=a, dtype=torch.float64)
                for a in (element_mass_class(self.space, quad),
                          element_stiffness_class(self.space, quad,
                                                  self.c * self.c)))
        mass, stiff = self._energy_ops
        u = state.u.reshape(-1).to(torch.float64)
        v = state.v.reshape(-1).to(torch.float64)
        return 0.5 * (torch.dot(v, mass(v)) + torch.dot(u, stiff(u)))

    @property
    def n_dofs(self) -> int:
        return self._n_dofs
