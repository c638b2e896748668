"""Fast (production) solver path: P1 grid-stencil schemes on torch tensors.

The operator is a constant 7-point stencil on the vertex grid
(ops/stencil.py); the explicit Newmark path uses a row-sum lumped mass (no
linear solve at all). The time loops are Python loops over steps; the hot
passes are the hand-written CUDA kernels of ops/kernels.py:

* :meth:`FastWaveSolver.run_leapfrog_kernel`    one launch of B1 per step
* :meth:`FastWaveSolver.run_leapfrog_multistep` one launch of B2 per
  ``steps_per_call`` steps (temporal blocking)

Scope of this slice: P1 elements, constant wave speed, homogeneous
Dirichlet data, zero forcing on the explicit path — the reference's
scalability configuration (scripts/scalability_sweep.py:85-120:
standing-mode, IO off). The product engines (models/fast_engine.py) add
driven g(t), forcing and the implicit schemes on top of the same
operators.
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
                                       apply_stencil_diff, boundary_mask_grid,
                                       class_matrices_to_stencil,
                                       lumped_mass_grid)

__all__ = ["FastWaveSolver", "FastState", "LeapfrogState"]


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
    """Grid-stencil wave solver (explicit lumped Newmark / leapfrog).

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
        self._n_dofs = self.shape[0] * self.shape[1]
        self._load_cache = None

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

    def step(self, state: FastState) -> FastState:
        if self.lumped:
            return self._explicit_step(state)
        raise NotImplementedError(
            "implicit FastWaveSolver.step (run_implicit_* paths) is not "
            "ported yet (ROADMAP A8); the implicit product schemes run in "
            "models/fast_engine.py")

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
        ``g_fn`` pins u^1 boundary data at t = dt.
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
        rhs = -self._stiff_diff(u0)
        if f_fn is not None:
            rhs = rhs + self.grid_load(f_fn, 0.0)
        a0 = torch.where(self.boundary, 0.0, rhs * self.inv_lumped)
        u1 = u0 + dt * v0 + (0.5 * dt * dt) * a0
        if g_fn is None:
            u1 = torch.where(self.boundary, 0.0, u1)
        else:
            u1 = torch.where(self.boundary, self._as_grid(g_fn(xs, ys, dt)),
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

    @property
    def n_dofs(self) -> int:
        return self._n_dofs
