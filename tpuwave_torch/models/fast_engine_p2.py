"""P2 (R = 2) product-surface engine on plane canvases.

Counterpart of tpuwave's models/fast_engine_p2.py.
:class:`FastP2ThetaSolver` and :class:`FastP2NewmarkSolver` implement the
EXACT parity step algebra of the P1 engines (models/fast_engine.py) on the
four P2 DoF planes (ops/stencil_p2.py): symmetric Dirichlet elimination
with time-dependent g on the vertex AND edge-midpoint boundary planes,
the derived acceleration boundary formulas (WaveNewmark.cpp:177-262), the
quadrature-consistent P2 load (r+1 rule = gauss_simplex(3)), the
consistent a0 solve, and the same ReductionControl stopping contract,
with tpuwave's wave-speed class:

* constant c          -> constant block-stencils M, K and M + coef K
* spatially varying c -> K a :class:`P2VarcoefStencil` from the scale
                         planes det w_q c^2(x_kq), built once
* `Time Dependent C`  -> K(t) rebuilt from c(x, y, t) every step; the
                         theta family carries K(t^n)'s (2, Q, ny, nx)
                         scale planes across steps in
                         ``FastGridState.k_payload`` (the operator built
                         from them is kept beside them)

The state lives as four zero-padded CANVASES (4, ny+3, nx+3) for the whole
step. Every constant-stencil canvas apply goes through
``ops/kernels_p2.py::p2_constrained_apply`` (kernel B11 on a CUDA tensor,
in f32 and f64; its plain version on the CPU): the CG matvecs with
``mask_input=True``, the rhs assembly and the boundary lift with
``mask_input=False`` and zero diagonals. With ``precond="mg"`` the
(p+h)-multigrid V-cycle smooths through kernels B12 / B13 and runs its P1
tail on ``KernelGmgPreconditioner`` (B4 + B3). tpuwave used its fused
kernels only for f32 on an accelerator, because Mosaic has no f64; the
CUDA kernels take both, so every run on the card goes through them.

With a varying C the K applies are torch ops (tpuwave runs no fused
kernel on its varcoef operator either); the mass applies stay on B11,
including the mass part of the system M + coef K(c), whose constrained
apply is B11's interior form plus coef times the varcoef apply.
``--precond mg`` then builds a frozen constant-c V-cycle at the rms of
c(x, y, 0) (``_frozen_c_ref``) that still smooths on B12 / B13 and runs
its P1 tail on B4 / B3. ``--solver cheby`` needs a constant c.

Flat vectors appear only at the diagnostics / IO boundary (log cadence),
through :class:`_CanvasDiag` around :class:`P2GridDiagnostics`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from tpuwave_torch.config import resolve_device
from tpuwave_torch.core.mesh import FeSpace, StructuredTriMesh
from tpuwave_torch.core.quadrature import gauss_simplex
from tpuwave_torch.models.fast_engine import (FastGridState, StepLoopMixin,
                                              fast_engine_ineligible_reason)
from tpuwave_torch.models.p2_diag import (P2_PLANE_OFFS, P2GridDiagnostics,
                                          p2_plane_coords)
from tpuwave_torch.ops import kernels_p2
from tpuwave_torch.ops.assembly import (element_mass_class,
                                        element_stiffness_class)
from tpuwave_torch.ops.stencil import P1_CLASS_CORNERS
from tpuwave_torch.ops.stencil_p2 import (_P2_POSITIONS, _PLANES,
                                          P2PlaneStencil, P2VarcoefStencil,
                                          canvas_shape, canvases_to_planes,
                                          p2_plane_shapes, p2_varcoef_data,
                                          p2_varcoef_scales, planes_to_flat)
from tpuwave_torch.solve.cg import pcg

__all__ = ["FastP2ThetaSolver", "FastP2NewmarkSolver"]


class _P2Op(NamedTuple):
    """Canvas P2 operator: ``apply_c`` the constrained apply (the CG
    matvec), ``apply_i`` = where(interior, A x, 0) with x read unmasked
    (the rhs assembly and the boundary lift), the assembled diagonal
    ((4, 1, 1) plane constants, or (4, Hc, Wc) canvases with 1.0 padding)
    and an upper eigenvalue bound (f32 backward-error floor / Chebyshev),
    a host float. A constant block-stencil has ``stencil`` and its applies
    are kernel B11 on the card; a varcoef operator has ``stencil`` None
    and ``var`` its P2VarcoefStencil (torch ops)."""
    stencil: Optional[P2PlaneStencil]
    apply_c: Callable
    apply_i: Callable
    diag: torch.Tensor
    lam_hi: float
    var: Optional[P2VarcoefStencil] = None


def _gershgorin_plane_stencil(op: P2PlaneStencil) -> float:
    """max over output planes of sum |coeff|: a Gershgorin row-sum bound
    on the constant P2 block-stencil (host float)."""
    sums = {p: 0.0 for p in _PLANES}
    for (pa, _pb, _ox, _oy), c in op.coeffs.items():
        sums[pa] += abs(c)
    return max(sums.values())


class _CanvasDiag:
    """Runner-facing diagnostics adapter: accepts the engine's canvas state
    tensors and forwards flat vectors to the wrapped P2GridDiagnostics.
    The conversions are crops and a concatenation, at log / IO cadence."""

    def __init__(self, inner, nx: int, ny: int):
        self._inner = inner
        self._nx, self._ny = int(nx), int(ny)

    def to_flat(self, x):
        if x.dim() == 1:
            return x
        return planes_to_flat(canvases_to_planes(x, self._nx, self._ny))

    def energy(self, u, v):
        return self._inner.energy(self.to_flat(u), self.to_flat(v))

    def errors(self, u, t):
        return self._inner.errors(self.to_flat(u), t)

    def probe(self, u):
        return self._inner.probe(self.to_flat(u))

    def vertex_values(self, u):
        return self._inner.vertex_values(self.to_flat(u))

    def interpolate(self, expr, t=0.0):
        return self._inner.interpolate(expr, t)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class _FastP2EngineBase(StepLoopMixin):
    """Shared plumbing: canvas plane operators, boundary / forcing data,
    symmetric Dirichlet elimination on the canvas P2 state."""

    def __init__(self, problem, *, dtype: torch.dtype = torch.float64,
                 device="cuda", precond: str = "jacobi",
                 cheby_degree: int = 3, solver: str = "3term",
                 cheby_solver_degree: int = 8, mg_pre_degree: int = 4,
                 mg_smooth_range: float = 8.0):
        reason = fast_engine_ineligible_reason(problem)
        if reason is not None:
            raise ValueError(f"fast engine unavailable: {reason}")
        p = problem
        if p.r != 2:
            raise ValueError("FastP2*Solver needs R = 2")
        c_const = p.c.constant_value
        if p.time_dependent_c and p.c.time_dependent:
            self._c_mode = "tdep"
        elif c_const is None:
            self._c_mode = "varcoef"
        else:
            self._c_mode = "const"
        if solver not in ("3term", "cheby"):
            raise ValueError(f"unknown solver {solver!r} for this engine "
                             "(3term | cheby; 2term is the displacement-"
                             "form classes in models/fast_engine_p2_2term)")
        if solver == "cheby" and self._c_mode != "const":
            raise ValueError(
                "--solver cheby needs a constant wave speed (block-symbol "
                "eigenvalue bounds); use 3term for varcoef or "
                "time-dependent C")
        self.device = resolve_device(device)
        self.mesh = StructuredTriMesh(p.nel, p.geometry)
        self.space = FeSpace(self.mesh, 2)
        self.nx, self.ny = self.mesh.nx, self.mesh.ny
        self.disc = _CanvasDiag(
            P2GridDiagnostics(p, dtype=dtype, device=self.device),
            self.nx, self.ny)
        self.dtype = dtype
        self.dt = p.dt
        self.theta, self.beta, self.gamma = p.theta, p.beta, p.gamma
        self.n_dofs = self.space.n_dofs
        self._max_iter = 10000 if dtype == torch.float64 else 2000
        self._g = p.g
        self._dgdt = p.dgdt
        self._f = p.f if not p.f.is_zero else None
        self._c = p.c
        self._solver = solver
        self._cheby_solver_degree = int(cheby_solver_degree)

        quad = gauss_simplex(3)                       # assembly rule r + 1
        mass = P2PlaneStencil(
            self.space, element_mass_class(self.space, quad), dtype,
            self.device)
        #: the Gershgorin bound of K(c = 1): lam(K(c)) <= max(c^2) times it
        self._k_unit_lam = _gershgorin_plane_stencil(P2PlaneStencil(
            self.space, element_stiffness_class(self.space, quad, 1.0),
            dtype, self.device))
        #: system coefficient: M + coef * K
        self.coef = (p.beta * p.dt * p.dt if self.method_name == "newmark"
                     else (p.theta * p.dt) ** 2)

        self._cshape = canvas_shape(self.nx, self.ny)
        shapes = p2_plane_shapes(self.nx, self.ny)
        hc, wc = self._cshape
        ri = torch.arange(hc, device=self.device)[:, None]
        ci = torch.arange(wc, device=self.device)[None, :]
        #: (4, Hc, Wc) True on each plane's support window / at interior
        #: (free) DoFs / at Dirichlet DoFs
        self.support = torch.stack([
            (ri >= 1) & (ri < 1 + r) & (ci >= 1) & (ci < 1 + c)
            for r, c in (shapes[q] for q in _PLANES)])
        self.interior = kernels_p2.p2_canvas_interior(
            self.nx, self.ny, self._cshape, self.device)
        self.boundary = self.support & ~self.interior
        self._mass_op = self._op(mass)
        #: the last varcoef K built, beside the scale planes it came from
        self._k_last = None
        #: K and the system M + coef K: built here for a constant or a
        #: spatially varying c, per step (None here) for a time-dependent c
        if self._c_mode == "const":
            self._k_op = self._op(P2PlaneStencil(
                self.space, element_stiffness_class(self.space, quad,
                                                    float(c_const) ** 2),
                dtype, self.device))
        elif self._c_mode == "varcoef":
            self._k_op = self._k_from_scales(self._tdep_scales(0.0))
        else:
            self._k_op = None
        self._sys_op = (self._system_of(self._k_op)
                        if self._k_op is not None else None)
        self._prec_mass = 1.0 / self._mass_op.diag

        # preconditioner of the implicit system (the theta v-system is the
        # bare mass: mesh-independent conditioning, Jacobi always)
        if solver == "cheby":
            precond = "jacobi"   # cheby IS the solver; skip mg setup
        elif precond == "auto":
            from tpuwave_torch.solve.multigrid import auto_precond
            precond = auto_precond(p, self.mesh, self.coef)
        self.precond = precond
        self.cheby_degree = int(cheby_degree)
        if precond == "mg":
            # a varying c freezes the hierarchy at the rms wave speed (a
            # fixed SPD V-cycle stays a valid CG preconditioner for a
            # varying SPD system)
            c_ref = (float(c_const) if c_const is not None
                     else self._frozen_c_ref())
            self._prec_sys = self._build_mg(p, c_ref, int(mg_pre_degree),
                                            float(mg_smooth_range))
        elif precond in ("jacobi", "chebyshev"):
            self._prec_sys = None   # derived from the system op per solve
        else:
            raise ValueError(f"Unknown preconditioner {precond!r}")

        if solver == "cheby":
            self._cheby_bounds = self._p2_symbol_bounds(
                self._sys_op.stencil)

    def _build_mg(self, p, c: float, pre_degree: int, smooth_range: float):
        """The canvas (p+h)-multigrid V-cycle at wave speed ``c``:
        smoothing blocks through kernels B12 / B13 on the system stencil
        (the constant one of ``p2_gmg_for_system`` when c varies), the P1
        tail on KernelGmgPreconditioner (B4 + B3) when the hierarchy has
        >= 2 levels."""
        from tpuwave_torch.solve.multigrid import (P2CanvasGmgPreconditioner,
                                                   kernel_cycle,
                                                   p2_gmg_for_system)
        flat_pre = p2_gmg_for_system(
            (self.nx, self.ny), p.geometry, c, self.coef, dtype=self.dtype,
            device=self.device, pre_degree=pre_degree,
            smooth_range=smooth_range)
        p1_cycle = kernel_cycle(flat_pre.p1_cycle)
        mg_st = (self._sys_op.stencil if self._c_mode == "const"
                 else flat_pre.system)
        return P2CanvasGmgPreconditioner(mg_st, flat_pre.sm_theta,
                                         flat_pre.sm_coeffs, p1_cycle,
                                         self._cshape)

    # -- spectrum bounds for the cheby solver ---------------------------
    @staticmethod
    def _p2_symbol_bounds(st: P2PlaneStencil, n: int = 128,
                          pad_rel: float = 0.02):
        """Spectrum bounds of the constant P2 block-stencil from its 4x4
        Hermitian symbol S(theta)[pa, pb] = sum C e^{i theta . off} (the
        block generalisation of solve/cheby_iter.py::
        stencil_symbol_bounds; pinned rows contribute the plane
        diagonals, folded into the range). The outward pad only loosens
        the Chebyshev interval (safe)."""
        order = {p: i for i, p in enumerate(_PLANES)}
        th = np.linspace(0.0, 2.0 * np.pi, n, endpoint=False)
        tx = th[None, :]
        ty = th[:, None]
        S = np.zeros((n, n, 4, 4), dtype=np.complex128)
        for (pa, pb, ox, oy), c in st.coeffs.items():
            S[..., order[pa], order[pb]] += c * np.exp(
                1j * (ox * tx + oy * ty))
        lam = np.linalg.eigvalsh(S)
        lo, hi = float(lam.min()), float(lam.max())
        for q in _PLANES:
            d = float(st.plane_diag[q])
            lo, hi = min(lo, d), max(hi, d)
        pad = pad_rel * (hi - lo)
        lo = max(lo - pad, 1e-12 * hi)
        return lo, hi + pad

    # -- wave-speed machinery -------------------------------------------
    def _frozen_c_ref(self) -> float:
        """rms of c(x, y, 0) over the DoF support points, in f64."""
        tot = cnt = 0.0
        for xs, ys in p2_plane_coords(self.mesh, torch.float64,
                                      self.device).values():
            cv = torch.broadcast_to(
                self._c.evaluate(xs, ys, 0.0).to(torch.float64), xs.shape)
            tot += float(torch.sum(cv ** 2))
            cnt += cv.numel()
        return float(np.sqrt(tot / cnt))

    def _tdep_data(self):
        if getattr(self, "_tdep_cache", None) is None:
            self._tdep_cache = p2_varcoef_data(self.space, gauss_simplex(3))
        return self._tdep_cache

    def _tdep_scales(self, t) -> torch.Tensor:
        """(2, Q, ny, nx) planes det * w_q * c^2(x_ekq, t)."""
        _, frac, w, det = self._tdep_data()
        return p2_varcoef_scales(self.mesh, self._c, t, frac, w, det,
                                 self.dtype, self.device)

    def _k_from_scales(self, s: torch.Tensor) -> _P2Op:
        """The varcoef K from the scale planes ``s`` (the operator last
        built is reused for the same ``s``); lam_hi by the SPD majorant
        K(c) <= max(c^2) K(1), read to the host once per build."""
        if self._k_last is not None and self._k_last[0] is s:
            return self._k_last[1]
        G, _, w, det = self._tdep_data()
        op = P2VarcoefStencil(self.space, s, G, self.dtype)
        wdet = torch.tensor(det * np.asarray(w), dtype=self.dtype,
                            device=self.device)
        c2max = float(torch.max(s / wdet[None, :, None, None]))
        # padding pinned to 1.0 (a zero pad diagonal would NaN the Jacobi
        # scaling: inf * 0 residual)
        diag = torch.where(self.support,
                           op.diagonal_canvases(self._cshape), 1.0)
        interior = self.interior

        def apply_c(w):
            return torch.where(
                interior, op.apply_canvases(torch.where(interior, w, 0.0)),
                diag * w)

        def apply_i(xc):
            return torch.where(interior, op.apply_canvases(xc), 0.0)
        k_op = _P2Op(None, apply_c, apply_i, diag,
                     c2max * self._k_unit_lam, op)
        self._k_last = (s, k_op)
        return k_op

    def _k_at(self, t) -> _P2Op:
        if self._k_op is not None:
            return self._k_op
        return self._k_from_scales(self._tdep_scales(t))

    def _system_of(self, k_op: _P2Op) -> _P2Op:
        """M + coef * K as one canvas operator: the merged constant
        stencil when K is constant; else B11's interior form of M plus
        coef times the varcoef apply (only interior rows of M x are
        read)."""
        coef = self.coef
        m_op = self._mass_op
        if coef == 0.0:   # theta = 0 / beta = 0: the system is bare mass
            return m_op
        if k_op.stencil is not None:
            return self._op(m_op.stencil.axpy(coef, k_op.stencil))
        m_terms, nx, ny = m_op.stencil.terms, self.nx, self.ny
        zeros = (0.0, 0.0, 0.0, 0.0)
        k_var, interior = k_op.var, self.interior
        diag = torch.where(self.support, m_op.diag + coef * k_op.diag, 1.0)

        def apply_c(w):
            y = kernels_p2.p2_constrained_apply(w, m_terms, zeros, nx, ny) \
                + coef * k_var.apply_canvases(torch.where(interior, w, 0.0))
            return torch.where(interior, y, diag * w)

        def apply_i(xc):
            y = kernels_p2.p2_constrained_apply(
                xc, m_terms, zeros, nx, ny, mask_input=False) \
                + coef * k_var.apply_canvases(xc)
            return torch.where(interior, y, 0.0)
        return _P2Op(None, apply_c, apply_i, diag,
                     m_op.lam_hi + coef * k_op.lam_hi, k_var)

    # -- canvas layout helpers ------------------------------------------
    def to_flat(self, xc) -> torch.Tensor:
        """(4, Hc, Wc) canvas stack -> flat (n_dofs,) core.mesh vector."""
        return self.disc.to_flat(xc)

    def _zeros(self, *shape):
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def _canvas_coords(self):
        """Per-plane (x, y) canvas coordinate tensors."""
        (x0, y0) = self.mesh.origin
        hx, hy = self.mesh.hx, self.mesh.hy
        hc, wc = self._cshape
        ri = torch.arange(hc, dtype=self.dtype,
                          device=self.device)[:, None].expand(hc, wc) - 1.0
        ci = torch.arange(wc, dtype=self.dtype,
                          device=self.device)[None, :].expand(hc, wc) - 1.0
        return [(x0 + hx * (ci + P2_PLANE_OFFS[p][0]),
                 y0 + hy * (ri + P2_PLANE_OFFS[p][1])) for p in _PLANES]

    def _cdata(self, expr, t):
        """expr(x, y, t) at ALL canvas support points (zero padding): the
        u0 / v0 interpolation."""
        if expr.is_zero:
            return self._zeros(4, *self._cshape)
        vals = torch.stack([torch.broadcast_to(
            expr.evaluate(xs, ys, t).to(self.dtype), self._cshape)
            for xs, ys in self._canvas_coords()])
        return torch.where(self.support, vals, 0.0)

    def _bdata(self, expr, t):
        """expr(x, y, t) on the BOUNDARY DoFs only (zeros elsewhere),
        evaluated on the eight O(perimeter) strip families."""
        if expr.is_zero:
            return self._zeros(4, *self._cshape)
        return self._strip_canvas(self._edge_vals(expr, t))

    # -- boundary strip families (V perimeter, H rows, W columns) -------
    @property
    def _strip_len(self):
        return max(self.nx + 1, self.ny + 1)

    def _strip_coords(self):
        """(xs, ys) per strip family: V-bottom/top/left/right,
        H-bottom/top, W-left/right."""
        (x0, y0) = self.mesh.origin
        hx, hy = self.mesh.hx, self.mesh.hy
        nx, ny = self.nx, self.ny
        kw = dict(dtype=self.dtype, device=self.device)
        xs_v = x0 + hx * torch.arange(nx + 1, **kw)
        ys_v = y0 + hy * torch.arange(ny + 1, **kw)
        xs_h = x0 + hx * (torch.arange(nx, **kw) + 0.5)
        ys_w = y0 + hy * (torch.arange(ny, **kw) + 0.5)
        x1, y1 = x0 + hx * nx, y0 + hy * ny
        return [(xs_v, torch.full_like(xs_v, y0)),       # V-bottom
                (xs_v, torch.full_like(xs_v, y1)),       # V-top
                (torch.full_like(ys_v, x0), ys_v),       # V-left
                (torch.full_like(ys_v, x1), ys_v),       # V-right
                (xs_h, torch.full_like(xs_h, y0)),       # H-bottom
                (xs_h, torch.full_like(xs_h, y1)),       # H-top
                (torch.full_like(ys_w, x0), ys_w),       # W-left
                (torch.full_like(ys_w, x1), ys_w)]       # W-right

    def _edge_vals(self, expr, t):
        """(8, L) strip-family values of expr(x, y, t), zero-padded."""
        out = self._zeros(8, self._strip_len)
        if expr.is_zero:
            return out
        for k, (xs, ys) in enumerate(self._strip_coords()):
            out[k, :xs.shape[0]] = torch.broadcast_to(
                expr.evaluate(xs, ys, t).to(self.dtype), xs.shape)
        return out

    def _canvas_edges(self, xc):
        """(8, L) boundary-strip extraction of a canvas stack."""
        nx, ny = self.nx, self.ny
        out = self._zeros(8, self._strip_len)
        out[0, :nx + 1] = xc[0, 1, 1:nx + 2]            # V-bottom
        out[1, :nx + 1] = xc[0, 1 + ny, 1:nx + 2]       # V-top
        out[2, :ny + 1] = xc[0, 1:ny + 2, 1]            # V-left
        out[3, :ny + 1] = xc[0, 1:ny + 2, 1 + nx]       # V-right
        out[4, :nx] = xc[1, 1, 1:nx + 1]                # H-bottom
        out[5, :nx] = xc[1, 1 + ny, 1:nx + 1]           # H-top
        out[6, :ny] = xc[2, 1:ny + 1, 1]                # W-left
        out[7, :ny] = xc[2, 1:ny + 1, 1 + nx]           # W-right
        return out

    def _strip_canvas(self, strips):
        """(8, L) strips -> (4, Hc, Wc) canvas stack with the values on the
        boundary DoFs (zeros elsewhere). The V corners take the left /
        right column values (tpuwave's select order; the four V families
        agree there)."""
        nx, ny = self.nx, self.ny
        out = self._zeros(4, *self._cshape)
        out[0, 1, 1:nx + 2] = strips[0, :nx + 1]
        out[0, 1 + ny, 1:nx + 2] = strips[1, :nx + 1]
        out[0, 1:ny + 2, 1] = strips[2, :ny + 1]
        out[0, 1:ny + 2, 1 + nx] = strips[3, :ny + 1]
        out[1, 1, 1:nx + 1] = strips[4, :nx]
        out[1, 1 + ny, 1:nx + 1] = strips[5, :nx]
        out[2, 1:ny + 1, 1] = strips[6, :ny]
        out[2, 1:ny + 1, 1 + nx] = strips[7, :ny]
        return out

    # -- operators -------------------------------------------------------
    def _op(self, st: P2PlaneStencil) -> _P2Op:
        """The canvas operator of a constant block-stencil; its applies
        are kernel B11 on the card (its plain version on the CPU)."""
        coeffs = st.terms
        diags = tuple(float(st.plane_diag[q]) for q in _PLANES)
        nx, ny = self.nx, self.ny

        def apply_c(xc):
            return kernels_p2.p2_constrained_apply(xc, coeffs, diags, nx, ny)

        def apply_i(xc):
            return kernels_p2.p2_constrained_apply(
                xc, coeffs, (0.0, 0.0, 0.0, 0.0), nx, ny, mask_input=False)
        diag = torch.tensor(diags, dtype=self.dtype,
                            device=self.device).reshape(4, 1, 1)
        return _P2Op(st, apply_c, apply_i, diag, _gershgorin_plane_stencil(st))

    def _sys_precond(self, sys_op: _P2Op):
        """Resolve the preconditioner for the system operator."""
        if self.precond == "mg":
            return self._prec_sys
        inv_diag = 1.0 / sys_op.diag
        if self.precond == "jacobi":
            return inv_diag
        # chebyshev on the CONSTRAINED apply; the Gershgorin bound of the
        # unconstrained operator majorises it (pinned rows pure diagonal)
        from tpuwave_torch.solve.chebyshev import chebyshev_apply
        if sys_op.stencil is not None:
            dmin = min(sys_op.stencil.plane_diag[q] for q in _PLANES)
        else:
            dmin = float(torch.min(torch.where(self.support, sys_op.diag,
                                               torch.inf)))
        lmax = sys_op.lam_hi / dmin
        deg = self.cheby_degree

        def prec(r):
            return chebyshev_apply(sys_op.apply_c, inv_diag, r,
                                   lambda_max=lmax, degree=deg)
        return prec

    # -- problem data ----------------------------------------------------
    def _load_data(self):
        if getattr(self, "_load_cache", None) is None:
            quad = gauss_simplex(3)
            sh = self.space.shape_at(quad)
            vals = np.asarray(sh.values)                    # (Q, 6)
            ref = np.asarray(quad.points)
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

    def grid_load(self, t):
        """Quadrature-consistent P2 load vector on the canvases, by the
        assembly r+1 rule (the plane form of the reference's per-step
        forcing cell loop, WaveTheta.cpp:164-172):
        L_i = sum_T det w_q phi_i(q) f(x_Tq), added to the six incident
        plane positions at the (1, 1) embedding."""
        vals, frac, w, det = self._load_data()
        ny, nx = self.ny, self.nx
        (x0, y0) = self.mesh.origin
        hx, hy = self.mesh.hx, self.mesh.hy
        kw = dict(dtype=self.dtype, device=self.device)
        ix = torch.arange(nx, **kw)[None, :].expand(ny, nx)
        iy = torch.arange(ny, **kw)[:, None].expand(ny, nx)
        idx = {p: i for i, p in enumerate(_PLANES)}
        out = self._zeros(4, *self._cshape)
        f_eval = self._f.evaluate
        for k in range(2):
            pos = _P2_POSITIONS[k]
            for q in range(frac.shape[1]):
                fx, fy = float(frac[k, q, 0]), float(frac[k, q, 1])
                fv = torch.broadcast_to(
                    f_eval(x0 + (ix + fx) * hx, y0 + (iy + fy) * hy,
                           t).to(self.dtype), (ny, nx))
                for a in range(6):
                    pa, (ox, oy) = pos[a]
                    out[idx[pa], 1 + oy:1 + oy + ny, 1 + ox:1 + ox + nx] += \
                        (det * float(w[q]) * float(vals[q, a])) * fv
        return out

    # -- Dirichlet elimination ------------------------------------------
    def _constrain(self, op: _P2Op, rhs, g_cv, x_prev, *, g_zero: bool):
        """Canvas form of deal.II apply_boundary_values with
        eliminate_columns=true. ``g_zero`` skips the lift apply for
        homogeneous data."""
        interior = self.interior
        apply_c = op.apply_c
        if g_zero:
            rhs_c = torch.where(interior, rhs, 0.0)
            x0 = torch.where(interior, x_prev, 0.0)
            return apply_c, rhs_c, x0
        g_ext = torch.where(self.boundary, g_cv, 0.0)
        # the boundary lift A(g 1_b) through the interior-masked
        # unmasked-input apply: where(interior, rhs - A g, diag g)
        rhs_c = torch.where(interior, rhs, op.diag * g_ext) \
            - op.apply_i(g_ext)
        x0 = torch.where(self.boundary, g_ext,
                         torch.where(interior, x_prev, 0.0))
        return apply_c, rhs_c, x0

    def _abs_tol(self, rhs, x0, op: _P2Op):
        """Reference 1e-12 floor in f64; backward-error floor in f32
        (models/fast.py::_solve_abs_tol rationale)."""
        if self.dtype == torch.float64:
            return 1e-12
        eta = 8 * float(torch.finfo(self.dtype).eps)
        return eta * (op.lam_hi * torch.linalg.vector_norm(x0)
                      + torch.linalg.vector_norm(rhs))

    def _solve(self, op: _P2Op, rhs, g_cv, x_prev, precond, *,
               g_zero: bool):
        apply_c, rhs_c, x0 = self._constrain(op, rhs, g_cv, x_prev,
                                             g_zero=g_zero)
        if self._solver == "cheby":
            return self._solve_cheby(op, apply_c, rhs_c, x0)
        return pcg(apply_c, rhs_c, x0, precond_inv_diag=precond,
                   abs_tol=self._abs_tol(rhs_c, x0, op),
                   max_iter=self._max_iter)

    def _solve_cheby(self, op: _P2Op, apply_c, rhs_c, x0):
        """Restarted Chebyshev iteration on the constrained canvas system
        (--solver cheby at R = 2): coefficient schedules from the 4x4
        block-symbol bounds, blocks of ``cheby_solver_degree`` iterations
        between residual checks, the ReductionControl stopping contract.
        The mass solves (and a bare-mass system) keep the parity CG."""
        from tpuwave_torch.solve.cheby_iter import chebyshev_solve
        if self.coef == 0.0 or op is not self._sys_op:
            return pcg(apply_c, rhs_c, x0, precond_inv_diag=1.0 / op.diag,
                       abs_tol=self._abs_tol(rhs_c, x0, op),
                       max_iter=self._max_iter)
        lo, hi = self._cheby_bounds
        return chebyshev_solve(
            apply_c, rhs_c, x0, lam_min=lo, lam_max=hi,
            degree=self._cheby_solver_degree,
            abs_tol=self._abs_tol(rhs_c, x0, op), max_iter=self._max_iter)


class FastP2ThetaSolver(_FastP2EngineBase):
    """theta-method on the P2 canvases: the parity algebra of tpuwave's
    models/theta.py (reference WaveTheta.cpp:119-339), including
    time-dependent Dirichlet g on vertex AND edge-midpoint planes,
    theta-weighted forcing, and variable / time-dependent wave speed."""

    method_name = "theta"

    def method_params_suffix(self) -> str:
        from tpuwave_torch.utils.naming import clean_double
        return "-theta" + clean_double(self.theta)

    def initial_state(self) -> FastGridState:
        p = self.disc.params
        u0 = self._cdata(p.u0, 0.0)
        v0 = self._cdata(p.v0, 0.0)
        pay = self._tdep_scales(0.0) if self._c_mode == "tdep" else None
        return FastGridState(u=u0, v=v0, a=torch.zeros_like(u0),
                             k_payload=pay)

    def step(self, state: FastGridState, t: float):
        dt, th = self.dt, self.theta
        u, v = state.u, state.v
        pay_np1 = None
        if self._c_mode == "tdep":
            # K^n from the carried payload (built as K^{n+1} last step);
            # K^{n+1} rebuilt from c(x, y, t): one build per step
            k_n = (self._k_from_scales(state.k_payload)
                   if state.k_payload is not None
                   else self._k_at(t - dt))
            pay_np1 = self._tdep_scales(t)
            k_np1 = self._k_from_scales(pay_np1)
            sys_op = self._system_of(k_np1)
        else:
            k_n = k_np1 = self._k_op
            sys_op = self._sys_op
        prec_sys = self._sys_precond(sys_op)

        m_rhs = self._mass_op.apply_i
        mu, ku = m_rhs(u), k_n.apply_i(u)
        mv = m_rhs(v)

        if self._f is not None:
            f_avg = (th * self.grid_load(t)
                     + (1.0 - th) * self.grid_load(t - dt))
        else:
            f_avg = None

        # u system (WaveTheta.cpp:119-186, 251-294)
        rhs_u = mu - (dt * dt * th * (1.0 - th)) * ku + dt * mv
        if f_avg is not None:
            rhs_u = rhs_u + (th * dt * dt) * f_avg
        res_u = self._solve(sys_op, rhs_u, self._bdata(self._g, t), u,
                            prec_sys, g_zero=self._g.is_zero)
        u_new = res_u.x.to(self.dtype)

        # v system (WaveTheta.cpp:188-249, 296-339)
        rhs_v = mv - (dt * (1.0 - th)) * ku \
            - (dt * th) * k_np1.apply_i(u_new)
        if f_avg is not None:
            rhs_v = rhs_v + dt * f_avg
        res_v = self._solve(self._mass_op, rhs_v,
                            self._bdata(self._dgdt, t), v,
                            self._prec_mass, g_zero=self._dgdt.is_zero)
        v_new = res_v.x.to(self.dtype)

        new_state = FastGridState(u=u_new, v=v_new, a=state.a,
                                  k_payload=pay_np1)
        info = {
            "iterations_1": res_u.iterations,
            "iterations_2": res_v.iterations,
            "norm_u": torch.linalg.vector_norm(u_new),
            "norm_v": torch.linalg.vector_norm(v_new),
        }
        return new_state, info


class FastP2NewmarkSolver(_FastP2EngineBase):
    """Newmark-beta on the P2 canvases: the parity algebra of tpuwave's
    models/newmark.py (reference WaveNewmark.cpp:116-390): consistent-mass
    a-solve (also at beta = 0), the derived acceleration boundary
    formulas, consistent a0, per-step forcing, variable / time-dependent
    wave speed."""

    method_name = "newmark"

    def method_params_suffix(self) -> str:
        from tpuwave_torch.utils.naming import clean_double
        return ("-gamma" + clean_double(self.gamma)
                + "-beta" + clean_double(self.beta))

    # -- acceleration boundary data (WaveNewmark.cpp:177-262) ----------
    def _accel_bc(self, t, z):
        dt = self.dt
        if self.beta > 1e-12:
            return (self._bdata(self._g, t) - z) / (self.beta * dt * dt)
        g_p = self._bdata(self._g, t)
        g_0 = self._bdata(self._g, t - dt)
        g_m = self._bdata(self._g, t - 2.0 * dt)
        return (g_p - 2.0 * g_0 + g_m) / (dt * dt)

    def initial_state(self) -> FastGridState:
        """u0, v0 interpolation + consistent M a0 = F(0) - K(0) u0 with
        a0|b = (g(dt) - 2 g(0) + g(-dt)) / dt^2 (reference :298-390)."""
        p, dt = self.disc.params, self.dt
        u0 = self._cdata(p.u0, 0.0)
        v0 = self._cdata(p.v0, 0.0)
        rhs = -self._k_at(0.0).apply_i(u0)
        if self._f is not None:
            rhs = rhs + self.grid_load(0.0)
        g_p = self._bdata(self._g, dt)
        g_0 = self._bdata(self._g, 0.0)
        g_m = self._bdata(self._g, -dt)
        a0_bc = (g_p - 2.0 * g_0 + g_m) / (dt * dt)
        res = self._solve(self._mass_op, rhs, a0_bc, torch.zeros_like(u0),
                          self._prec_mass, g_zero=self._g.is_zero)
        self.initial_iterations = int(res.iterations)
        return FastGridState(u=u0, v=v0, a=res.x.to(self.dtype))

    def step(self, state: FastGridState, t: float):
        dt, beta, gamma = self.dt, self.beta, self.gamma
        u, v, a = state.u, state.v, state.a

        # the elastic force acts at t^{n+1}
        k_np1 = self._k_at(t)
        sys_op = (self._sys_op if self._sys_op is not None
                  else self._system_of(k_np1))
        prec_sys = self._sys_precond(sys_op)

        # z = u + dt v + dt^2 (1/2 - beta) a  (WaveNewmark.cpp:123-126)
        z = u + dt * v + (dt * dt * (0.5 - beta)) * a
        rhs = -k_np1.apply_i(z)
        if self._f is not None:
            rhs = rhs + self.grid_load(t)

        a_bc = self._accel_bc(t, z)
        # NB for beta > 0 the derived BC (g - z)/(beta dt^2) is nonzero
        # even for g == 0 whenever the state is nonzero on the boundary —
        # the homogeneous shortcut applies only to the beta = 0
        # second-difference formula
        res = self._solve(sys_op, rhs, a_bc, a, prec_sys,
                          g_zero=self._g.is_zero and beta <= 1e-12)
        a_new = res.x.to(self.dtype)

        u_new = (z + (beta * dt * dt) * a_new).to(self.dtype)
        v_new = (v + dt * ((1.0 - gamma) * a + gamma * a_new)).to(
            self.dtype)
        new_state = FastGridState(u=u_new, v=v_new, a=a_new)
        info = {
            "iterations_1": res.iterations,
            "iterations_2": 0,
            "norm_u": torch.linalg.vector_norm(u_new),
            "norm_v": torch.linalg.vector_norm(v_new),
        }
        return new_state, info
