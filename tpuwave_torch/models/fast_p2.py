"""P2 bench solvers on the plane-stencil operators.

Counterpart of tpuwave's models/fast_p2.py, the solvers its bench scripts
drive (scripts/bench_p2_mg.py and its twin torch_bench_p2_mg.py):
implicit consistent-mass Newmark / theta stepping for quadratic elements
with homogeneous Dirichlet data and zero forcing (P2 row-sum lumping is
singular, so there is no explicit P2 path).

* :class:`P2FastSolver` keeps the state as the flat P2 DoF vector
  (vertices, then the h / v / d edge planes: reshapes of the four planes
  of ops/stencil_p2.py) and applies the constant block-stencils in torch
  ops. ``precond="mg"`` is the (p+h)-multigrid of
  ``solve/multigrid.py::p2_gmg_for_system``, whose P1 levels run kernel B3
  on the card. ``step_tdep`` / ``run_scan_tdep`` take a time-dependent
  wave speed: K(t) is a ``P2VarcoefStencil`` rebuilt from c(x, y, t) every
  step, the system M + coef K(t) its constant-part form
  (``P2PlaneStencil.axpy_varcoef``).
* :class:`P2CanvasSolver` keeps the state as four (ny+3, nx+3) plane
  canvases, the port's true canvas (tpuwave pads it to Mosaic's block and
  lane multiples on its Pallas route). Every canvas apply, the CG matvecs
  and the rhs -K z among them, is kernel B11
  (``ops/kernels_p2.py::p2_constrained_apply``) on a CUDA tensor and its
  plain version on a CPU tensor, whatever ``use_pallas`` says: tpuwave's
  XLA and Pallas routes compute the same operator, and the port has the
  kernel route only (``pallas_block_rows`` and ``pallas_interpret`` have
  no counterpart). ``precond="mg"`` is the canvas V-cycle
  ``P2CanvasGmgPreconditioner``: smoothing blocks on B12 / B13, the P1
  tail on B4 / B3 (tpuwave smooths through repeated constrained applies;
  the polynomial is the same). ``run_implicit_2term`` is the displacement
  recurrence of ``FastWaveSolver.run_implicit_mg_2term`` on the canvases.

The loops are Python loops over steps, with the solver iterations of the
last ``run_*`` call in ``last_iterations`` (tpuwave jits them with
``cached_scan``). Every tensor is built on the solver's device, "cuda" by
default, which raises where there is no card.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple, Tuple

import torch

from tpuwave_torch.config import resolve_device
from tpuwave_torch.core.mesh import FeSpace, StructuredTriMesh
from tpuwave_torch.core.quadrature import gauss_simplex
from tpuwave_torch.models.p2_diag import P2_PLANE_OFFS, p2_plane_coords
from tpuwave_torch.ops import kernels_p2
from tpuwave_torch.ops.assembly import (element_mass_class,
                                        element_stiffness_class)
from tpuwave_torch.ops.stencil_p2 import (_PLANES, P2PlaneStencil,
                                          P2VarcoefStencil, canvas_shape,
                                          canvases_to_planes,
                                          p2_varcoef_data, p2_varcoef_scales,
                                          planes_to_flat)
from tpuwave_torch.solve.cg import pcg, vdot

__all__ = ["P2FastSolver", "P2State", "P2CanvasSolver", "P2CanvasState",
           "P2CanvasPair"]


class P2State(NamedTuple):
    u: torch.Tensor  # flat (n_dofs,)
    v: torch.Tensor
    a: torch.Tensor


def _check_scheme(scheme: str) -> None:
    if scheme not in ("newmark", "theta"):
        raise ValueError(f"unknown scheme {scheme!r}")


def _resolve_precond(precond: str, sys_coef: float, c: float, mesh) -> str:
    """tpuwave's ``auto`` rule: mg when the system is stiffness-dominated
    enough that the V-cycle pays, else jacobi."""
    if precond == "auto":
        from tpuwave_torch.solve.multigrid import AUTO_MG_THRESHOLD
        q = sys_coef * c * c / (mesh.hx * mesh.hy)
        return "mg" if q >= AUTO_MG_THRESHOLD else "jacobi"
    if precond not in ("mg", "jacobi"):
        raise ValueError(f"Unknown preconditioner {precond!r}")
    return precond


class _P2Base:
    """Mesh, stencils, tolerances and the step loop both solvers share."""

    def __init__(self, nel, geometry, dt, c, scheme, beta, gamma, theta,
                 dtype, device, cg_reduction):
        _check_scheme(scheme)
        self.mesh = StructuredTriMesh(tuple(nel), geometry)
        self.space = FeSpace(self.mesh, 2)
        self.nx, self.ny = self.mesh.nx, self.mesh.ny
        self.dt = float(dt)
        self.c = float(c)
        self.scheme = scheme
        self.beta, self.gamma = float(beta), float(gamma)
        self.theta = float(theta)
        self.dtype = dtype
        self.device = resolve_device(device)
        #: CG relative-reduction stopping factor (reference
        #: ReductionControl 1e-6)
        self.cg_reduction = float(cg_reduction)
        self.n_dofs = self.space.n_dofs
        quad = gauss_simplex(3)
        self.mass = P2PlaneStencil(
            self.space, element_mass_class(self.space, quad), dtype,
            self.device)
        self.stiff = P2PlaneStencil(
            self.space, element_stiffness_class(self.space, quad, c * c),
            dtype, self.device)
        #: matrix_a = M + beta dt^2 K | matrix_u = M + (theta dt)^2 K
        self.sys_coef = (self.beta * self.dt * self.dt
                         if scheme == "newmark" else (self.theta * self.dt) ** 2)
        self.system = self.mass.axpy(self.sys_coef, self.stiff)
        #: solver iterations of the last ``run_*`` call, one entry a step:
        #: an int (Newmark, 2-term) or a (u-solve, v-solve) pair (theta)
        self.last_iterations = []

    @property
    def _max_iter(self) -> int:
        return 10000 if self.dtype == torch.float64 else 2000

    @property
    def _abs_tol(self) -> float:
        return 1e-6 if self.dtype == torch.float32 else 1e-12

    def _pcg(self, apply_c, rhs, x0, prec, **kw):
        return pcg(apply_c, rhs, x0, precond_inv_diag=prec,
                   abs_tol=kw.pop("abs_tol", self._abs_tol),
                   max_iter=self._max_iter, reduction=self.cg_reduction,
                   **kw)

    def _run(self, state, n_steps: int, step_counted):
        self.last_iterations = []
        for _ in range(int(n_steps)):
            state, its = step_counted(state)
            self.last_iterations.append(its)
        return state

    def step(self, state):
        state, its = self._step_counted(state)
        self.last_iterations = [its]
        return state

    def run_scan(self, state, n_steps: int):
        """``n_steps`` of :meth:`step`."""
        return self._run(state, n_steps, self._step_counted)

    def _step_counted(self, state):
        if self.scheme == "theta":
            return self._theta_step(state)
        return self._newmark_step(state)


class P2FastSolver(_P2Base):
    """Implicit Newmark / theta stepping with P2 plane-stencil operators on
    the flat DoF vector."""

    def __init__(self, nel: Tuple[int, int], geometry, dt: float, *,
                 c: float = 1.0, scheme: str = "newmark", beta: float = 0.25,
                 gamma: float = 0.5, theta: float = 0.5,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 cg_reduction: float = 1e-6, precond: str = "jacobi",
                 mg_pre_degree: int = 1, mg_smooth_range: float = 8.0):
        super().__init__(nel, geometry, dt, c, scheme, beta, gamma, theta,
                         dtype, device, cg_reduction)
        self._interior = self.interior_mask()
        self._sys_prec = 1.0 / self.system.diagonal()
        self._mass_prec = 1.0 / self.mass.diagonal()
        self._apply_sys = self._constrained(self.system, self._interior)
        self._apply_mass = self._constrained(self.mass, self._interior)
        self.precond = _resolve_precond(precond, self.sys_coef, self.c,
                                        self.mesh)
        if self.precond == "mg":
            # (p+h)-multigrid for the system solves; the mass v-solve
            # keeps Jacobi (mesh-independent conditioning)
            from tpuwave_torch.solve.multigrid import p2_gmg_for_system
            self._sys_prec = p2_gmg_for_system(
                tuple(nel), geometry, self.c, self.sys_coef, dtype=dtype,
                device=self.device, pre_degree=mg_pre_degree,
                smooth_range=mg_smooth_range)
        self._tdep_cache = None
        self._k_last = None

    def interior_mask(self) -> torch.Tensor:
        """Flat interior (non-Dirichlet) mask."""
        mask = kernels_p2.p2_canvas_interior(
            self.nx, self.ny, canvas_shape(self.nx, self.ny), self.device)
        return planes_to_flat(canvases_to_planes(mask, self.nx, self.ny))

    def _flat_data(self, fn):
        coords = p2_plane_coords(self.mesh, self.dtype, self.device)
        return planes_to_flat({
            p: torch.broadcast_to(torch.as_tensor(
                fn(xs, ys), dtype=self.dtype, device=self.device), xs.shape)
            for p, (xs, ys) in coords.items()})

    def _initial(self, u0_fn, v0_fn, stiff_of_u0) -> P2State:
        u0 = self._flat_data(u0_fn)
        v0 = (torch.zeros_like(u0) if v0_fn is None
              else self._flat_data(v0_fn))
        if self.scheme == "theta":
            # first-order system: no acceleration state
            return P2State(u=u0, v=v0, a=torch.zeros_like(u0))
        # consistent a0: M a0 = -K u0 (homogeneous data), interior-masked
        rhs = torch.where(self._interior, -stiff_of_u0(u0), 0.0)
        res = self._pcg(self._apply_mass, rhs, torch.zeros_like(u0),
                        self._mass_prec)
        self.last_iterations = [res.iterations]
        return P2State(u=u0, v=v0, a=res.x.to(self.dtype))

    def initial_state(self, u0_fn, v0_fn=None) -> P2State:
        """Interpolated u0 / v0 (``fn(x, y)`` on torch tensors); Newmark's
        consistent a0 by Jacobi-CG on the mass."""
        return self._initial(u0_fn, v0_fn, self.stiff)

    @staticmethod
    def _constrained(op, interior):
        diag = op.diagonal()

        def apply_c(w):
            return torch.where(interior, op(torch.where(interior, w, 0.0)),
                               diag * w)
        return apply_c

    def _newmark_step(self, state: P2State):
        """Implicit Newmark-beta step (homogeneous BCs, zero forcing)."""
        dt, beta, gamma = self.dt, self.beta, self.gamma
        interior = self._interior
        u, v, a = state
        z = u + dt * v + (dt * dt * (0.5 - beta)) * a
        rhs = torch.where(interior, -self.stiff(z), 0.0)
        res = self._pcg(self._apply_sys, rhs,
                        torch.where(interior, a, 0.0), self._sys_prec)
        a_new = res.x.to(self.dtype)
        u_new = z + (beta * dt * dt) * a_new
        v_new = v + dt * ((1.0 - gamma) * a + gamma * a_new)
        return P2State(u=u_new, v=v_new, a=a_new), res.iterations

    def _theta_step(self, state: P2State):
        """theta-method step: two consistent-mass CG solves a step, the
        reference WaveTheta algebra (src/WaveTheta.cpp:119-339)."""
        dt, th = self.dt, self.theta
        interior = self._interior
        u, v, a = state
        mu, ku, mv = self.mass(u), self.stiff(u), self.mass(v)
        rhs_u = torch.where(
            interior, mu - (dt * dt * th * (1.0 - th)) * ku + dt * mv, 0.0)
        res_u = self._pcg(self._apply_sys, rhs_u,
                          torch.where(interior, u, 0.0), self._sys_prec)
        u_new = res_u.x.to(self.dtype)
        rhs_v = torch.where(interior, mv - (dt * (1.0 - th)) * ku
                            - (dt * th) * self.stiff(u_new), 0.0)
        res_v = self._pcg(self._apply_mass, rhs_v,
                          torch.where(interior, v, 0.0), self._mass_prec)
        return (P2State(u=u_new, v=res_v.x.to(self.dtype), a=a),
                (res_u.iterations, res_v.iterations))

    # ------------------------------------------------------------------
    # time-dependent wave speed: K(t) the varcoef P2 block-stencil rebuilt
    # from c(x, y, t) every step. ``c_fn(x, y, t)`` takes torch tensors,
    # t a 0-d tensor of the solver's dtype on its device.
    # ------------------------------------------------------------------
    def _times(self, times) -> torch.Tensor:
        return torch.as_tensor(times, dtype=self.dtype,
                               device=self.device).reshape(-1)

    def _tdep_data(self):
        """(G, frac, w, det) of ``p2_varcoef_data``: host constants."""
        if self._tdep_cache is None:
            self._tdep_cache = p2_varcoef_data(self.space, gauss_simplex(3))
        return self._tdep_cache

    def _tdep_scales(self, c_fn, t) -> torch.Tensor:
        """(2, Q, ny, nx) planes det * w_q * c^2(x_ekq, t)."""
        _, frac, w, det = self._tdep_data()
        dtype, device = self.dtype, self.device
        c = SimpleNamespace(evaluate=lambda x, y, tt: torch.as_tensor(
            c_fn(x, y, tt), dtype=dtype, device=device))
        return p2_varcoef_scales(self.mesh, c, self._times(t)[0], frac, w,
                                 det, dtype, device)

    def _stiff_from_scales(self, s) -> P2VarcoefStencil:
        """K from the scale planes ``s``; the operator last built is reused
        for the same ``s`` (theta's K^n is the last step's K^{n+1})."""
        if self._k_last is not None and self._k_last[0] is s:
            return self._k_last[1]
        op = P2VarcoefStencil(self.space, s, self._tdep_data()[0],
                              self.dtype)
        self._k_last = (s, op)
        return op

    def _stiff_at(self, c_fn, t) -> P2VarcoefStencil:
        return self._stiff_from_scales(self._tdep_scales(c_fn, t))

    def step_tdep(self, state: P2State, t, c_fn, k_n_scales=None,
                  k_np1_scales=None) -> P2State:
        """One step with K = K(t), ``t`` the time stepped TO (homogeneous
        BCs, zero forcing). The elastic force acts at t^{n+1} for Newmark
        and is theta-weighted K^n / K^{n+1} for the theta family (the
        parity tdep semantics). ``k_n_scales`` / ``k_np1_scales``: scale
        planes already built (``run_scan_tdep`` carries them). The system
        solves are Jacobi-CG on M + coef K(t^{n+1})."""
        state, its = self._step_tdep_counted(state, t, c_fn, k_n_scales,
                                             k_np1_scales)
        self.last_iterations = [its]
        return state

    def _step_tdep_counted(self, state, t, c_fn, k_n_scales, k_np1_scales):
        dt = self.dt
        interior = self._interior
        t = self._times(t)[0]
        k_np1 = (self._stiff_from_scales(k_np1_scales)
                 if k_np1_scales is not None else self._stiff_at(c_fn, t))
        system = self.mass.axpy_varcoef(self.sys_coef, k_np1)
        apply_sys = self._constrained(system, interior)
        sys_prec = 1.0 / system.diagonal()
        u, v, a = state
        if self.scheme == "newmark":
            beta, gamma = self.beta, self.gamma
            z = u + dt * v + (dt * dt * (0.5 - beta)) * a
            rhs = torch.where(interior, -k_np1(z), 0.0)
            res = self._pcg(apply_sys, rhs, torch.where(interior, a, 0.0),
                            sys_prec)
            a_new = res.x.to(self.dtype)
            u_new = z + (beta * dt * dt) * a_new
            v_new = v + dt * ((1.0 - gamma) * a + gamma * a_new)
            return P2State(u=u_new, v=v_new, a=a_new), res.iterations
        th = self.theta
        k_n = (self._stiff_from_scales(k_n_scales)
               if k_n_scales is not None else self._stiff_at(c_fn, t - dt))
        mu, ku, mv = self.mass(u), k_n(u), self.mass(v)
        rhs_u = torch.where(
            interior, mu - (dt * dt * th * (1.0 - th)) * ku + dt * mv, 0.0)
        res_u = self._pcg(apply_sys, rhs_u, torch.where(interior, u, 0.0),
                          sys_prec)
        u_new = res_u.x.to(self.dtype)
        rhs_v = torch.where(interior, mv - (dt * (1.0 - th)) * ku
                            - (dt * th) * k_np1(u_new), 0.0)
        res_v = self._pcg(self._apply_mass, rhs_v,
                          torch.where(interior, v, 0.0), self._mass_prec)
        return (P2State(u=u_new, v=res_v.x.to(self.dtype), a=a),
                (res_u.iterations, res_v.iterations))

    def initial_state_tdep(self, u0_fn, c_fn, v0_fn=None) -> P2State:
        """u0 / v0 interpolation with the consistent a0 solved against
        K(0)."""
        return self._initial(u0_fn, v0_fn,
                             lambda u0: self._stiff_at(c_fn, 0.0)(u0))

    def run_scan_tdep(self, state: P2State, times, c_fn) -> P2State:
        """One :meth:`step_tdep` per entry of ``times`` (each the t^{n+1}
        being stepped TO), K(t) rebuilt each step; the theta family's K^n
        is the last step's K^{n+1}, so each step builds one operator."""
        ts = self._times(times)
        s_n = self._tdep_scales(c_fn, ts[0] - self.dt)
        self.last_iterations = []
        for t in ts:
            s_np1 = self._tdep_scales(c_fn, t)
            state, its = self._step_tdep_counted(state, t, c_fn, s_n, s_np1)
            self.last_iterations.append(its)
            s_n = s_np1
        return state


class P2CanvasState(NamedTuple):
    u: torch.Tensor  # (4, Hc, Wc) canvas stacks, plane order V, H, W, D
    v: torch.Tensor
    a: torch.Tensor


class P2CanvasPair(NamedTuple):
    """Two-array displacement state of the canvas 2-term path (the P2
    twin of models/fast.py::LeapfrogState)."""
    u: torch.Tensor       # (4, Hc, Wc)
    u_prev: torch.Tensor


class P2CanvasSolver(_P2Base):
    """P2 solver on four (ny+3, nx+3) plane canvases, its applies on
    kernel B11 (see the module docstring). Semantics match P2FastSolver
    (implicit Newmark / theta, homogeneous BCs, zero forcing)."""

    def __init__(self, nel: Tuple[int, int], geometry, dt: float, *,
                 c: float = 1.0, beta: float = 0.25, gamma: float = 0.5,
                 scheme: str = "newmark", theta: float = 0.5,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 sharding=None, row_multiple: int = 1,
                 use_pallas: bool = False, pallas_block_rows: int = 64,
                 pallas_interpret: bool = False, cg_reduction: float = 1e-6,
                 precond: str = "jacobi", mg_pre_degree: int = 1,
                 mg_smooth_range: float = 8.0):
        if sharding is not None:
            raise ValueError("sharding= is not ported yet (ROADMAP A11(b))")
        if int(row_multiple) != 1:
            raise ValueError("row_multiple= (the sharded canvas rows) is not "
                             "ported yet (ROADMAP A11(b))")
        super().__init__(nel, geometry, dt, c, scheme, beta, gamma, theta,
                         dtype, device, cg_reduction)
        self.cshape = canvas_shape(self.nx, self.ny)
        self.interior = kernels_p2.p2_canvas_interior(
            self.nx, self.ny, self.cshape, self.device)
        self._mass_prec = self._plane_column(
            [1.0 / self.mass.plane_diag[p] for p in _PLANES])
        self._sys_prec = self._plane_column(
            [1.0 / self.system.plane_diag[p] for p in _PLANES])
        self._apply_sys = self._constrained(self.system)
        self._apply_mass = self._constrained(self.mass)
        self.precond = _resolve_precond(precond, self.sys_coef, self.c,
                                        self.mesh)
        if self.precond == "mg":
            # the canvas (p+h)-multigrid: smoothing on B12 / B13, the P1
            # tail on B4 / B3; the mass v-solve keeps Jacobi
            from tpuwave_torch.solve.multigrid import (
                P2CanvasGmgPreconditioner, kernel_cycle, p2_gmg_for_system)
            flat_pre = p2_gmg_for_system(
                tuple(nel), geometry, self.c, self.sys_coef, dtype=dtype,
                device=self.device, pre_degree=mg_pre_degree,
                smooth_range=mg_smooth_range)
            self._sys_prec = P2CanvasGmgPreconditioner(
                self.system, flat_pre.sm_theta, flat_pre.sm_coeffs,
                kernel_cycle(flat_pre.p1_cycle), self.cshape)

    def _plane_column(self, vals) -> torch.Tensor:
        return torch.tensor(vals, dtype=self.dtype,
                            device=self.device).reshape(4, 1, 1)

    def _canvas_data(self, fn) -> torch.Tensor:
        """fn(x, y) at the canvas points of each plane, zero off the
        interior."""
        (x0, y0) = self.mesh.origin
        hx, hy = self.mesh.hx, self.mesh.hy
        hc, wc = self.cshape
        kw = dict(dtype=self.dtype, device=self.device)
        ri = torch.arange(hc, **kw)[:, None].expand(hc, wc) - 1.0
        ci = torch.arange(wc, **kw)[None, :].expand(hc, wc) - 1.0
        vals = torch.stack([torch.broadcast_to(torch.as_tensor(
            fn(x0 + hx * (ci + P2_PLANE_OFFS[p][0]),
               y0 + hy * (ri + P2_PLANE_OFFS[p][1])), **kw), self.cshape)
            for p in _PLANES])
        return torch.where(self.interior, vals, 0.0)

    def initial_state(self, u0_fn, v0_fn=None) -> P2CanvasState:
        """Interpolated u0 / v0 on the interior canvases; Newmark's
        consistent a0 by Jacobi-CG on the mass."""
        u0 = self._canvas_data(u0_fn)
        v0 = (torch.zeros_like(u0) if v0_fn is None
              else self._canvas_data(v0_fn))
        if self.scheme == "theta":
            return P2CanvasState(u=u0, v=v0, a=torch.zeros_like(u0))
        res = self._pcg(self._apply_mass, self._rhs_stiff(u0),
                        torch.zeros_like(u0), self._mass_prec)
        self.last_iterations = [res.iterations]
        return P2CanvasState(u=u0, v=v0, a=res.x.to(self.dtype))

    def _apply_i(self, op: P2PlaneStencil, xc) -> torch.Tensor:
        """where(interior, A x, 0), x read unmasked: kernel B11."""
        return kernels_p2.p2_constrained_apply(
            xc, op.terms, (0.0, 0.0, 0.0, 0.0), self.nx, self.ny,
            mask_input=False)

    def _rhs_stiff(self, z) -> torch.Tensor:
        """Interior-masked -K z (homogeneous data)."""
        return -self._apply_i(self.stiff, z)

    def _constrained(self, op: P2PlaneStencil):
        """The constrained canvas apply (input masking, block-stencil and
        pinning in one pass of B11)."""
        terms, nx, ny = op.terms, self.nx, self.ny
        diags = tuple(float(op.plane_diag[p]) for p in _PLANES)

        def apply_c(w):
            return kernels_p2.p2_constrained_apply(w, terms, diags, nx, ny)
        return apply_c

    def _newmark_step(self, state: P2CanvasState):
        dt, beta, gamma = self.dt, self.beta, self.gamma
        u, v, a = state
        z = u + dt * v + (dt * dt * (0.5 - beta)) * a
        res = self._pcg(self._apply_sys, self._rhs_stiff(z),
                        torch.where(self.interior, a, 0.0), self._sys_prec)
        a_new = res.x.to(self.dtype)
        u_new = z + (beta * dt * dt) * a_new
        v_new = v + dt * ((1.0 - gamma) * a + gamma * a_new)
        return P2CanvasState(u=u_new, v=v_new, a=a_new), res.iterations

    def _theta_step(self, state: P2CanvasState):
        """theta-method step on the canvases (reference WaveTheta algebra,
        src/WaveTheta.cpp:119-339)."""
        dt, th = self.dt, self.theta
        interior = self.interior
        u, v, _ = state
        um = torch.where(interior, u, 0.0)
        vm = torch.where(interior, v, 0.0)
        mu = self._apply_i(self.mass, um)
        ku = self._apply_i(self.stiff, um)
        mv = self._apply_i(self.mass, vm)
        rhs_u = torch.where(
            interior, mu - (dt * dt * th * (1.0 - th)) * ku + dt * mv, 0.0)
        res_u = self._pcg(self._apply_sys, rhs_u, um, self._sys_prec)
        u_new = res_u.x.to(self.dtype)
        kun = self._apply_i(self.stiff, torch.where(interior, u_new, 0.0))
        rhs_v = torch.where(
            interior, mv - (dt * (1.0 - th)) * ku - (dt * th) * kun, 0.0)
        res_v = self._pcg(self._apply_mass, rhs_v, vm, self._mass_prec)
        return (P2CanvasState(u=u_new, v=res_v.x.to(self.dtype),
                              a=state.a),
                (res_u.iterations, res_v.iterations))

    # ------------------------------------------------------------------
    # displacement-form (two-array) implicit stepping on the canvases:
    # the P2 port of FastWaveSolver.run_implicit_mg_2term (see the block
    # comment there). One O(dt^2)-residual system solve a step, no mass
    # or velocity solve.
    # ------------------------------------------------------------------
    def _consistent_accel_canvas(self, u):
        """a = -M^{-1} K u by Jacobi-CG on the canvases."""
        rhs = self._rhs_stiff(torch.where(self.interior, u, 0.0))
        res = self._pcg(self._apply_mass, rhs, torch.zeros_like(u),
                        self._mass_prec)
        return res.x.to(self.dtype)

    def _correction_solve(self, r0):
        """The system solve A e = r0 from e = 0, stopped at the smaller of
        the absolute floor and 0.5 ||r0|| (at least one iteration: a floor
        above ||r0|| degenerates the recurrence to extrapolation)."""
        rn2 = vdot(r0, r0)
        abs_tol = torch.minimum(
            torch.tensor(self._abs_tol, dtype=self.dtype, device=self.device),
            0.5 * torch.sqrt(rn2).to(self.dtype))
        return self._pcg(self._apply_sys, r0, torch.zeros_like(r0),
                         self._sys_prec, r0=r0, norm0_sq=rn2,
                         abs_tol=abs_tol)

    def implicit_2term_init(self, state: P2CanvasState) -> P2CanvasPair:
        """(u^1, u^0) from the first step solved in correction u-form (a
        composed u^1 would inject an incoherent (u^1, u^0) mismatch that
        the undamped recurrence amplifies; see
        FastWaveSolver.implicit_2term_init)."""
        dt = self.dt
        u, v, a = state
        if self.scheme == "theta":
            th = self.theta
            x0 = torch.where(self.interior, u, 0.0)
            vm = torch.where(self.interior, v, 0.0)
            r0 = (dt * self._apply_i(self.mass, vm)
                  + (th * dt * dt) * self._rhs_stiff(x0))
        else:
            z = u + dt * v + (dt * dt * (0.5 - self.beta)) * a
            x0 = torch.where(self.interior, z, 0.0)
            r0 = (self.beta * dt * dt) * self._rhs_stiff(x0)
        res = self._correction_solve(r0)
        self.last_iterations = [res.iterations]
        return P2CanvasPair(u=(x0 + res.x).to(self.dtype),
                            u_prev=torch.where(self.interior, u, 0.0))

    def run_implicit_2term(self, pair: P2CanvasPair,
                           n_steps: int) -> P2CanvasPair:
        """3-term displacement recurrence: each step one -dt^2 K(combo)
        pass (B11) and ~1 MG / Jacobi-PCG iteration on the system from the
        extrapolated warm start 2u^n - u^{n-1}."""
        if self.scheme == "newmark":
            if self.beta <= 1e-12:
                raise ValueError("run_implicit_2term needs beta > 0 for "
                                 "Newmark")
            c_u, c_up = self.gamma + 0.5, 0.5 - self.gamma
        else:
            c_u, c_up = 2.0 * self.theta, 1.0 - 2.0 * self.theta
        dt = self.dt

        def step(p):
            cu, cup = p
            combo = (cu if (c_u == 1.0 and c_up == 0.0)
                     else c_u * cu + c_up * cup)
            r0 = (dt * dt) * self._rhs_stiff(combo)
            x0 = torch.where(self.interior, 2.0 * cu - cup, 0.0)
            res = self._correction_solve(r0)
            return (P2CanvasPair(u=(x0 + res.x).to(self.dtype), u_prev=cu),
                    res.iterations)

        return self._run(pair, n_steps, step)

    def implicit_2term_finish(self, pair: P2CanvasPair) -> P2CanvasState:
        """Exact (u, u_prev) -> (u, v, a) conversion (one-time mass
        solves; the identities of FastWaveSolver.implicit_2term_finish)."""
        dt = self.dt
        a = self._consistent_accel_canvas(pair.u)
        if self.scheme == "theta":
            th = self.theta
            if th == 1.0:
                corr = 0.0
            else:
                combo = (th * pair.u + (1.0 - th) * pair.u_prev
                         if th != 0.0 else pair.u_prev)
                corr = dt * (1.0 - th) * self._consistent_accel_canvas(combo)
            v = (pair.u - pair.u_prev) / dt + corr
        else:
            beta, gamma = self.beta, self.gamma
            a_prev = self._consistent_accel_canvas(pair.u_prev)
            v = ((pair.u - pair.u_prev) / dt
                 + dt * ((0.5 + beta - gamma) * a_prev
                         + (gamma - beta) * a))
        v = torch.where(self.interior, v, 0.0).to(self.dtype)
        return P2CanvasState(u=pair.u, v=v, a=a)

    def to_flat(self, xc) -> torch.Tensor:
        """(4, Hc, Wc) canvas stack -> flat (n_dofs,) core.mesh vector."""
        return planes_to_flat(canvases_to_planes(xc, self.nx, self.ny))
