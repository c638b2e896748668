"""Product-surface engines: the fast grid-stencil Newmark and theta solvers.

:class:`FastThetaSolver` and :class:`FastNewmarkSolver` implement the
EXACT parity step algebra of tpuwave's models/fast_engine.py — symmetric
Dirichlet elimination with time-dependent g (reference solve_u/solve_v
WaveTheta.cpp:251-339), the derived acceleration boundary formulas
(WaveNewmark.cpp:177-262), the theta-weighted quadrature-consistent forcing
(WaveTheta.cpp:119-186), the consistent a0 solve (WaveNewmark.cpp:298-390)
and the same ReductionControl stopping contract — on grid-plane operators.

Every constrained solve runs preconditioned CG (solve/cg.py). With a
constant wave speed its matvec is ``ops.kernels.constrained_stencil_apply``:
on a CUDA device that is the hand-written kernel B3, in f32 and f64 alike;
on the CPU its plain version. This covers the Newmark a-system, the theta
u-system and the theta v (mass) system. The preconditioner of the
implicit system is ``precond`` = jacobi | chebyshev | mg | auto (tpuwave's
set): mg is the geometric V-cycle of solve/multigrid.py, whose fine level
runs as kernel B4 blocks. ``solver="cheby"`` replaces CG by restarted Chebyshev
iteration, one kernel-B4 pass per block (``_solve_cheby``);
``solver="2term"`` is the displacement recurrence of
models/fast_engine_2term.py (``make_fast_solver`` routes it). tpuwave
uses its fused kernels only for f32 on an accelerator, because Mosaic has
no f64; the CUDA kernels take both, so every run on the card goes through
them.

Wave-speed coverage (tpuwave's, at R = 1):

* constant c          -> constant 7-point stencils (ops/stencil.py)
* spatially varying c -> static variable-coefficient 9-plane operator
                         (assemble_varcoef_planes; per-class G scaled by
                         det sum_q w_q c^2(x_q), built once)
* `Time Dependent C`  -> the planes rebuilt from c(x, y, t) every step;
                         the theta family carries K(t^n)'s scales across
                         steps in ``FastGridState.k_payload``

The varcoef and tdep matvecs are torch ops (tpuwave's fused kernels need a
constant stencil too); the mass solves keep B3, and ``--precond mg``
sizes a frozen constant-c V-cycle (rms c at t = 0, ``_frozen_c_ref``)
whose fine level still runs on B4 / B3. ``--solver cheby`` needs a
constant c. R = 2 problems route to the P2 canvas engines
(models/fast_engine_p2.py, models/fast_engine_p2_2term.py), which take
the same three kinds of c. ``resolve_engine`` falls back to the parity
engine (models/theta.py, models/newmark.py) where this one is ineligible.

State vectors stay FLAT (n_dofs,) for the run driver's diagnostics/IO;
the steppers reshape to the (ny+1, nx+1) vertex grid internally (free: the
P1 DoF numbering is row-major over the grid).

Sharded (``sharding=``, parallel/sharding.py, tpuwave's ``_shard_grid``
hook): at R = 1 with a constant c, each rank holds its block of every
state vector (flattened), every constrained matvec is kernel B3 at the
block's global offsets after a one-node halo exchange, the V-cycle is
solve/multigrid.py::ShardedGmgPreconditioner, ``--solver cheby`` runs the
unfused block recurrence, and every dot product and norm is summed over
the ranks, so the CG counts are the ranks' common ones. The fused
kernels B4-B10 take no part there, as tpuwave's Pallas path is off under
sharding. A varying or time-dependent c and R = 2 under sharding raise
(ROADMAP A11(b)).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from tpuwave_torch.config import resolve_device
from tpuwave_torch.models.fast import FastWaveSolver
from tpuwave_torch.ops.stencil import (apply_varcoef_planes,
                                       constrained_apply_on)
from tpuwave_torch.solve.cg import pcg
from tpuwave_torch.solve.chebyshev import chebyshev_apply
from tpuwave_torch.solve.cheby_iter import (chebyshev_solve,
                                            stencil_chebyshev,
                                            stencil_symbol_bounds)
from tpuwave_torch.solve.multigrid import (auto_precond, gmg_for_system,
                                           shard_cycle)
from tpuwave_torch.utils.params import Params

__all__ = ["FastGridState", "FastThetaSolver", "FastNewmarkSolver",
           "StepLoopMixin", "fast_engine_ineligible_reason",
           "make_fast_solver", "resolve_engine"]


class FastGridState(NamedTuple):
    #: flat (n_dofs,) at R = 1; (4, ny+3, nx+3) canvases at R = 2
    u: torch.Tensor
    v: torch.Tensor
    a: torch.Tensor   # consistent acceleration (Newmark); zeros for theta
    #: K(t^n) varcoef scales carried across steps under `Time Dependent C`
    #: (theta family only; None otherwise), as tpuwave's: (ny, nx, 2) at
    #: R = 1, (2, Q, ny, nx) at R = 2
    k_payload: Optional[torch.Tensor] = None


class _Op(NamedTuple):
    """Grid operator: apply(u), assembled diagonal (a scalar, or a plane
    for varcoef operators), an upper eigenvalue bound (for the f32
    backward-error stopping floor and Chebyshev) and, for constant
    operators, the 3x3 stencil the kernels apply (None for varcoef)."""
    apply: Callable
    diag: Any
    lam_hi: Any
    stencil: Any = None


def _frozen_c_ref(disc) -> float:
    """Reference constant for the frozen-coefficient mg hierarchy under a
    varying or `Time Dependent C`: rms of c(x, y, 0) over the DoF support
    points (a copy of tpuwave's models/theta.py::_frozen_c_ref)."""
    xy = torch.as_tensor(np.asarray(disc.dof_coords, dtype=float))
    cv = disc.params.c.evaluate(xy[:, 0], xy[:, 1], 0.0).numpy()
    return float(np.sqrt(np.mean(cv ** 2)))


def fast_engine_ineligible_reason(problem) -> Optional[str]:
    """None when ``problem`` (a Params) can run on the grid-stencil engine
    of this port, else why not (tpuwave's texts). Params of an import
    run here only as models/general.py::recognised_rectangle returns
    them."""
    if not isinstance(problem, Params):
        return "the port's fast engine takes Params"
    p = problem
    if p.mesh_file is not None and not p.mesh_recognised:
        return "imported mesh (factory routes recognisable rectangles)"
    if p.r not in (1, 2):
        return f"fast engine supports R = 1/2 (R = {p.r})"
    if min(p.nel) < 2:
        return "mesh has no interior band (Nel < 2)"
    return None


def make_fast_solver(problem, family: str, *, precond: str = "jacobi",
                     cheby_degree: int = 3, solver: str = "3term",
                     **engine_kwargs):
    """Factory used by the CLI ``--engine fast|auto`` routing.

    ``solver``: the implicit-solve strategy (``--solver``): ``3term`` (the
    parity CG contract, default), ``2term`` (the displacement recurrence,
    models/fast_engine_2term.py) or ``cheby`` (restarted Chebyshev
    iteration). ``engine_kwargs`` take ``dtype`` and ``device`` (default
    "cuda", which raises where there is no card). R = 2 problems, with a
    constant, spatially varying or time-dependent c, route to the P2
    plane-canvas engines, which also take ``cheby_solver_degree``,
    ``mg_pre_degree`` and ``mg_smooth_range``."""
    p = problem
    if engine_kwargs.get("sharding") is not None:
        if p.r != 1:
            raise ValueError("sharding at R = 2 is not ported yet "
                             "(ROADMAP A11(b))")
        if p.c.constant_value is None:
            raise ValueError("sharding with a varying or time-dependent C "
                             "is not ported yet (ROADMAP A11(b))")
    if p.r == 2:
        if solver == "2term":
            from tpuwave_torch.models.fast_engine_p2_2term import (
                FastP22TermNewmarkSolver, FastP22TermThetaSolver)
            cls2 = {"theta": FastP22TermThetaSolver,
                    "newmark": FastP22TermNewmarkSolver}.get(family)
        else:
            from tpuwave_torch.models.fast_engine_p2 import (
                FastP2NewmarkSolver, FastP2ThetaSolver)
            cls2 = {"theta": FastP2ThetaSolver,
                    "newmark": FastP2NewmarkSolver}.get(family)
        if cls2 is None:
            raise ValueError(f"unknown solver family {family!r}")
        allowed = {"device", "dtype", "cheby_solver_degree",
                   "mg_pre_degree", "mg_smooth_range"}
        if set(engine_kwargs) - allowed:
            raise TypeError("P2 fast engine does not accept "
                            f"{sorted(set(engine_kwargs) - allowed)}")
        if solver != "2term":
            engine_kwargs["solver"] = solver
        return cls2(problem, precond=precond, cheby_degree=cheby_degree,
                    **engine_kwargs)
    if solver == "2term":
        from tpuwave_torch.models.fast_engine_2term import (
            Fast2TermNewmarkSolver, Fast2TermThetaSolver)
        cls = {"theta": Fast2TermThetaSolver,
               "newmark": Fast2TermNewmarkSolver}.get(family)
        if cls is None:
            raise ValueError(f"unknown solver family {family!r}")
        return cls(problem, precond=precond, cheby_degree=cheby_degree,
                   **engine_kwargs)
    cls = {"theta": FastThetaSolver,
           "newmark": FastNewmarkSolver}.get(family)
    if cls is None:
        raise ValueError(f"unknown solver family {family!r}")
    return cls(problem, precond=precond, cheby_degree=cheby_degree,
               solver=solver, **engine_kwargs)


def resolve_engine(params, family: str, engine: str, *, make_disc,
                   mesh=None, **solver_kwargs):
    """Shared ``--engine auto|fast|parity`` resolution of the CLI and
    :mod:`tpuwave_torch.api`, tpuwave's contract.

    ``make_disc``: zero-argument callable building the parity
    discretisation (models/general.py::make_discretization), invoked only
    when the parity engine runs. ``mesh``: the import of ``params``,
    already read (else it is read here). An import that is recognisably
    a rectangle runs on the fast engine with its ``nel`` / ``geometry``.
    Returns ``(solver_or_None, disc_or_None, reason_or_None)``:

    * solver set          -> a fast engine was built (disc None)
    * solver None, parity -> the caller builds the parity solver on ``disc``
    * solver None + engine == 'fast' -> unsatisfiable; error with reason
    """
    if engine == "parity":
        return None, make_disc(), None
    if engine not in ("auto", "fast"):
        raise ValueError(f"Unknown engine {engine!r}")
    reason = fast_engine_ineligible_reason(params)
    if (reason is not None and params.mesh_file is not None
            and not params.mesh_recognised):
        from tpuwave_torch.models.general import recognised_rectangle
        rect = recognised_rectangle(params, mesh)
        if rect is None:
            reason = "mesh is not a generated structured rectangle"
        else:
            params, reason = rect, fast_engine_ineligible_reason(rect)
    if reason is None:
        return make_fast_solver(params, family, **solver_kwargs), None, None
    return None, make_disc(), reason


class StepLoopMixin:
    """The engines' time loops over ``self.step`` (R = 1 and R = 2)."""

    def run_steps(self, state, times):
        """Advance ``len(times)`` steps; returns (final_state, per-step
        info as host numpy arrays, one transfer per call)."""
        return self.run_steps_diag(state, times, None)

    def run_steps_diag(self, state, times, diag_fn):
        """``run_steps`` with ``diag_fn(new_state, t) -> dict of 0-d
        tensors`` evaluated after every step and stacked."""
        its1, its2, rows = [], [], []
        for t in times:
            state, info = self.step(state, float(t))
            its1.append(info["iterations_1"])
            its2.append(info["iterations_2"])
            row = {"norm_u": info["norm_u"], "norm_v": info["norm_v"]}
            if diag_fn is not None:
                row.update(diag_fn(state, float(t)))
            rows.append(row)
        out = {"iterations_1": np.asarray(its1, dtype=np.int64),
               "iterations_2": np.asarray(its2, dtype=np.int64)}
        for key in (rows[0] if rows else {}):
            out[key] = torch.stack([r[key] for r in rows]).cpu().numpy()
        return state, out


class _FastEngineBase(StepLoopMixin):
    """Shared plumbing: operators, boundary/forcing data, elimination."""

    def __init__(self, problem, *, dtype: torch.dtype = torch.float64,
                 device="cuda", precond: str = "jacobi",
                 cheby_degree: int = 3, solver: str = "3term",
                 cheby_solver_degree: int = 8, sharding=None):
        reason = fast_engine_ineligible_reason(problem)
        if reason is not None:
            raise ValueError(f"fast engine unavailable: {reason}")
        if solver not in ("3term", "cheby"):
            raise ValueError(f"unknown solver {solver!r} for this engine "
                             "(3term | cheby; 2term is the displacement-"
                             "form classes in models/fast_engine_2term.py)")
        if problem.r != 1:
            raise ValueError("the P1 engine needs R = 1 (R = 2: "
                             "models/fast_engine_p2.py)")
        p = problem
        c_const = p.c.constant_value
        if p.time_dependent_c and p.c.time_dependent:
            self._c_mode = "tdep"
        elif c_const is None:
            self._c_mode = "varcoef"
        else:
            self._c_mode = "const"
        if solver == "cheby" and self._c_mode != "const":
            raise ValueError(
                "--solver cheby needs a constant wave speed (analytic "
                "stencil-symbol bounds); use 3term/2term for varcoef or "
                "time-dependent C")

        if sharding is not None and self._c_mode != "const":
            raise ValueError("sharding with a varying or time-dependent C "
                             "is not ported yet (ROADMAP A11(b))")

        from tpuwave_torch.models.grid_diag import GridDiagnostics
        self.device = resolve_device(device)
        self.dt = p.dt
        self.fs = FastWaveSolver(
            p.nel, p.geometry, p.dt,
            c=1.0 if c_const is None else float(c_const),
            scheme=self.method_name, beta=p.beta, gamma=p.gamma,
            theta=p.theta, lumped=False, dtype=dtype, device=self.device,
            sharding=sharding)
        fs = self.fs
        self.sharding = sharding
        #: this rank's block (None: the whole grid)
        self.layout = fs.layout
        self.disc = GridDiagnostics(p, dtype=dtype, device=self.device,
                                    layout=fs.layout)
        self.dtype = dtype
        self._max_iter = 10000 if dtype == torch.float64 else 2000

        # problem data
        self._g = p.g
        self._dgdt = p.dgdt
        self._f = p.f if not p.f.is_zero else None
        self._c_eval = p.c.evaluate

        #: system coefficient: M + coef * K
        self.coef = (p.beta * p.dt * p.dt if self.method_name == "newmark"
                     else (p.theta * p.dt) ** 2)

        self._mass_op = _Op(fs.mass, fs.mass.stencil[1][1],
                            stencil_symbol_bounds(fs.mass.stencil)[1],
                            fs.mass.stencil)
        if self._c_mode == "const":
            self._k_static = _Op(fs.stiff, fs.stiff.stencil[1][1],
                                 stencil_symbol_bounds(fs.stiff.stencil)[1],
                                 fs.stiff.stencil)
        elif self._c_mode == "varcoef":
            # static 9-plane operator, built once
            self._k_static = self._k_from_scales(
                fs._tdep_scales(self._c_eval, 0.0))
        else:
            self._k_static = None   # rebuilt per step from c(x, y, t)
        self._prec_mass = 1.0 / fs.mass.stencil[1][1]

        # preconditioner of the implicit system; the theta v-system is the
        # bare mass (mesh-independent conditioning): Jacobi always
        if solver == "cheby":
            precond = "jacobi"   # cheby IS the solver; skip mg setup
        elif precond == "auto":
            precond = auto_precond(p, fs.mesh, self.coef)
        self.precond = precond
        self.cheby_degree = int(cheby_degree)
        self._solver = solver
        self._cheby_solver_degree = int(cheby_solver_degree)
        if precond == "mg":
            # non-constant c freezes the hierarchy at the rms wave speed
            # (a fixed SPD V-cycle stays a valid CG preconditioner for a
            # varying SPD system)
            c_ref = (_frozen_c_ref(self.disc) if c_const is None
                     else float(c_const))
            # a one-level hierarchy stays the plain cycle (and the 2-term
            # step then takes its unfused setup)
            self._prec_sys = shard_cycle(gmg_for_system(
                (fs.mesh.nx, fs.mesh.ny), fs.mesh.geometry, c_ref,
                self.coef), fs.layout)
        elif precond in ("jacobi", "chebyshev"):
            self._prec_sys = None   # derived from the system op per solve
        else:
            raise ValueError(f"Unknown preconditioner {precond!r}")

    # -- operators -------------------------------------------------------
    def _k_from_planes(self, planes) -> _Op:
        """Varcoef K operator from 9 coefficient planes (torch ops), with
        the Gershgorin majorant sum_d max |w_d| as the eigenvalue bound."""
        def apply(u, _p=planes):
            return apply_varcoef_planes(_p, u)
        lam_hi = sum(torch.max(torch.abs(w)) for w in planes.values())
        return _Op(apply, planes[(0, 0)], lam_hi)

    def _k_from_scales(self, s) -> _Op:
        return self._k_from_planes(self.fs._planes_from_scales(s))

    def _k_at(self, t) -> _Op:
        if self._k_static is not None:
            return self._k_static
        return self._k_from_scales(self.fs._tdep_scales(self._c_eval, t))

    def _system_of(self, k_op: _Op) -> _Op:
        coef = self.coef
        if coef == 0.0:   # theta = 0 / beta = 0: the system is bare mass
            return self._mass_op
        m = self._mass_op

        def apply(u):
            return m.apply(u) + coef * k_op.apply(u)
        st = None
        if k_op.stencil is not None:
            st = tuple(tuple(mc + coef * kc for mc, kc in zip(mr, kr))
                       for mr, kr in zip(m.stencil, k_op.stencil))
        return _Op(apply, m.diag + coef * k_op.diag,
                   m.lam_hi + coef * k_op.lam_hi, st)

    def _sys_precond(self, sys_op: _Op):
        """The preconditioner of the implicit system operator: the
        V-cycle, the Jacobi inverse diagonal, or the Chebyshev polynomial
        on the constrained apply (the symbol bound majorises it: pinned
        rows are pure diagonal)."""
        if self.precond == "mg":
            return self._prec_sys
        inv_diag = 1.0 / sys_op.diag
        if self.precond == "jacobi":
            return inv_diag
        apply_c = self._constrained_apply(sys_op)
        dmin = (torch.min(sys_op.diag) if isinstance(sys_op.diag, torch.Tensor)
                else sys_op.diag)
        lmax = sys_op.lam_hi / dmin
        deg = self.cheby_degree

        def prec(r):
            return chebyshev_apply(apply_c, inv_diag, r, lambda_max=lmax,
                                   degree=deg)
        return prec

    # -- helpers -------------------------------------------------------
    def _plane(self, expr, t):
        """expr(x, y, t) on the full vertex grid (only boundary entries
        are ever consumed; interior values are masked away)."""
        shape = self.fs.block_shape
        if expr.is_zero:
            return torch.zeros(shape, dtype=self.dtype, device=self.device)
        cv = expr.constant_value
        if cv is not None:
            return torch.full(shape, cv, dtype=self.dtype,
                              device=self.device)
        xs, ys = self.fs.grid_coords()
        return torch.broadcast_to(expr.evaluate(xs, ys, t).to(self.dtype),
                                  shape)

    def _constrained_apply(self, op: _Op):
        """The CG matvec: interior S(interior-masked w), pinned diag * w —
        for a constant stencil kernel B3 on a CUDA tensor, its plain
        version on a CPU one; torch ops for a varcoef operator."""
        st, diag = op.stencil, op.diag
        if st is None:
            interior = self.fs.interior

            def apply_v(w):
                return torch.where(
                    interior, op.apply(torch.where(interior, w, 0.0)),
                    diag * w)
            return apply_v

        layout = self.layout

        def apply_c(w):
            return constrained_apply_on(layout, w, st, diag)
        return apply_c

    def _constrain(self, op: _Op, rhs, g_plane, x_prev, *, g_zero: bool):
        """Grid-plane form of deal.II apply_boundary_values with
        eliminate_columns=true: pinned diagonal boundary rows, rhs lifted
        by -A(g 1_b), warm start with boundary entries set to g.
        ``g_zero`` skips the lift apply for homogeneous data."""
        fs = self.fs
        apply_c = self._constrained_apply(op)
        if g_zero:
            rhs_c = torch.where(fs.interior, rhs, 0.0)
            x0 = torch.where(fs.interior, x_prev, 0.0)
            return apply_c, rhs_c, x0
        g_ext = torch.where(fs.boundary, g_plane, 0.0)
        rhs_c = torch.where(fs.interior, rhs - op.apply(g_ext),
                            op.diag * g_ext)
        x0 = torch.where(fs.boundary, g_ext, x_prev)
        return apply_c, rhs_c, x0

    def _abs_tol(self, rhs, x0, op: _Op):
        """Reference 1e-12 floor in f64; backward-error floor in f32
        (models/fast.py::_solve_abs_tol rationale)."""
        if self.dtype == torch.float64:
            return 1e-12
        eta = 8 * float(torch.finfo(self.dtype).eps)
        return eta * (op.lam_hi * self.fs._norm(x0) + self.fs._norm(rhs))

    def _solve(self, op: _Op, rhs, g_plane, x_prev, precond, *,
               g_zero: bool):
        apply_c, rhs_c, x0 = self._constrain(op, rhs, g_plane, x_prev,
                                             g_zero=g_zero)
        rhs_c, x0 = rhs_c.contiguous(), x0.contiguous()
        if self._solver == "cheby":
            return self._solve_cheby(op, rhs_c, x0)
        return pcg(apply_c, rhs_c, x0, precond_inv_diag=precond,
                   abs_tol=self._abs_tol(rhs_c, x0, op),
                   max_iter=self._max_iter, reduction=self.fs.cg_reduction,
                   all_sum=self.fs._all_sum())

    def _solve_cheby(self, op: _Op, rhs_c, x0):
        """Restarted Chebyshev iteration on the constrained system
        (--solver cheby): coefficient schedules from the analytic
        stencil-symbol bounds, so a block of ``cheby_solver_degree``
        iterations has no dot product and is one B4 pass; r0 comes
        through B3. The loop reads ||r||^2 back once per block and stops
        by the ReductionControl contract of the CG paths."""
        return chebyshev_solve(
            b=rhs_c, x0=x0, **stencil_chebyshev(op.stencil, self.layout),
            degree=self._cheby_solver_degree,
            abs_tol=self._abs_tol(rhs_c, x0, op),
            reduction=self.fs.cg_reduction, max_iter=self._max_iter)

class FastThetaSolver(_FastEngineBase):
    """theta-method on the grid planes — parity algebra of tpuwave's
    models/theta.py (reference WaveTheta.cpp:119-339), including
    time-dependent Dirichlet g, theta-weighted forcing, and variable /
    time-dependent wave speed."""

    method_name = "theta"

    def method_params_suffix(self) -> str:
        from tpuwave_torch.utils.naming import clean_double
        return "-theta" + clean_double(self.fs.theta)

    def initial_state(self) -> FastGridState:
        d = self.disc
        u0 = d.interpolate(d.params.u0).to(self.dtype).contiguous()
        v0 = d.interpolate(d.params.v0).to(self.dtype).contiguous()
        pay = (self.fs._tdep_scales(self._c_eval, 0.0)
               if self._c_mode == "tdep" else None)
        return FastGridState(u=u0, v=v0, a=torch.zeros_like(u0),
                             k_payload=pay)

    def step(self, state: FastGridState, t: float):
        fs = self.fs
        dt, th = self.dt, fs.theta
        u = state.u.reshape(fs.block_shape)
        v = state.v.reshape(fs.block_shape)

        pay_np1 = None
        if self._c_mode == "tdep":
            # K^n from the carried payload (built as K^{n+1} last step);
            # K^{n+1} rebuilt from c(x, y, t): one build per step
            k_n = (self._k_from_scales(state.k_payload)
                   if state.k_payload is not None
                   else self._k_at(t - dt))
            pay_np1 = fs._tdep_scales(self._c_eval, t)
            k_np1 = self._k_from_scales(pay_np1)
        else:
            k_n = k_np1 = self._k_at(t)
        sys_op = self._system_of(k_np1)
        prec_sys = self._sys_precond(sys_op)

        mu, ku, mv = self._mass_op.apply(u), k_n.apply(u), \
            self._mass_op.apply(v)

        if self._f is not None:
            f_avg = (th * fs.grid_load(self._f.evaluate, t)
                     + (1.0 - th) * fs.grid_load(self._f.evaluate, t - dt))
        else:
            f_avg = None

        # u system (WaveTheta.cpp:119-186, 251-294)
        rhs_u = mu - (dt * dt * th * (1.0 - th)) * ku + dt * mv
        if f_avg is not None:
            rhs_u = rhs_u + (th * dt * dt) * f_avg
        res_u = self._solve(sys_op, rhs_u, self._plane(self._g, t), u,
                            prec_sys, g_zero=self._g.is_zero)
        u_new = res_u.x.to(self.dtype)

        # v system (WaveTheta.cpp:188-249, 296-339)
        rhs_v = mv - (dt * (1.0 - th)) * ku - (dt * th) * k_np1.apply(u_new)
        if f_avg is not None:
            rhs_v = rhs_v + dt * f_avg
        res_v = self._solve(self._mass_op, rhs_v,
                            self._plane(self._dgdt, t), v,
                            self._prec_mass, g_zero=self._dgdt.is_zero)
        v_new = res_v.x.to(self.dtype)

        new_state = FastGridState(u=u_new.reshape(-1), v=v_new.reshape(-1),
                                  a=state.a, k_payload=pay_np1)
        info = {
            "iterations_1": res_u.iterations,
            "iterations_2": res_v.iterations,
            "norm_u": fs._norm(u_new),
            "norm_v": fs._norm(v_new),
        }
        return new_state, info


class FastNewmarkSolver(_FastEngineBase):
    """Newmark-beta on the grid planes — parity algebra of tpuwave's
    models/newmark.py (reference WaveNewmark.cpp:116-390): consistent-mass
    a-solve (also at beta = 0), derived acceleration boundary formulas,
    consistent a0, per-step forcing, variable / time-dependent wave
    speed."""

    method_name = "newmark"

    def method_params_suffix(self) -> str:
        from tpuwave_torch.utils.naming import clean_double
        return ("-gamma" + clean_double(self.fs.gamma)
                + "-beta" + clean_double(self.fs.beta))

    # -- acceleration boundary data (WaveNewmark.cpp:177-262) ----------
    def _accel_bc_plane(self, t, z):
        fs, dt = self.fs, self.dt
        if fs.beta > 1e-12:
            return (self._plane(self._g, t) - z) / (fs.beta * dt * dt)
        g_p = self._plane(self._g, t)
        g_0 = self._plane(self._g, t - dt)
        g_m = self._plane(self._g, t - 2.0 * dt)
        return (g_p - 2.0 * g_0 + g_m) / (dt * dt)

    def initial_state(self) -> FastGridState:
        """u0, v0 interpolation + consistent M a0 = F(0) - K(0) u0 with
        a0|b = (g(dt) - 2 g(0) + g(-dt)) / dt^2 (reference :298-390)."""
        d, fs, dt = self.disc, self.fs, self.dt
        u0 = d.interpolate(d.params.u0).to(self.dtype).contiguous()
        v0 = d.interpolate(d.params.v0).to(self.dtype).contiguous()
        u0g = u0.reshape(fs.block_shape)
        rhs = -self._k_at(0.0).apply(u0g)
        if self._f is not None:
            rhs = rhs + fs.grid_load(self._f.evaluate, 0.0)
        g_p = self._plane(self._g, dt)
        g_0 = self._plane(self._g, 0.0)
        g_m = self._plane(self._g, -dt)
        a0_bc = (g_p - 2.0 * g_0 + g_m) / (dt * dt)
        res = self._solve(self._mass_op, rhs, a0_bc, torch.zeros_like(u0g),
                          self._prec_mass, g_zero=self._g.is_zero)
        self.initial_iterations = int(res.iterations)
        return FastGridState(u=u0, v=v0,
                             a=res.x.to(self.dtype).reshape(-1))

    def step(self, state: FastGridState, t: float):
        fs = self.fs
        dt, beta, gamma = self.dt, fs.beta, fs.gamma
        u = state.u.reshape(fs.block_shape)
        v = state.v.reshape(fs.block_shape)
        a = state.a.reshape(fs.block_shape)

        # the elastic force acts at t^{n+1}
        k_np1 = self._k_at(t)
        sys_op = self._system_of(k_np1)
        prec_sys = self._sys_precond(sys_op)

        # z = u + dt v + dt^2 (1/2 - beta) a  (WaveNewmark.cpp:123-126)
        z = u + dt * v + (dt * dt * (0.5 - beta)) * a
        rhs = -k_np1.apply(z)
        if self._f is not None:
            rhs = rhs + fs.grid_load(self._f.evaluate, t)

        a_bc = self._accel_bc_plane(t, z)
        # NB for beta > 0 the derived BC (g - z)/(beta dt^2) is nonzero
        # even for g == 0 whenever the state is nonzero on the boundary —
        # the homogeneous shortcut applies only to the beta = 0
        # second-difference formula
        res = self._solve(sys_op, rhs, a_bc, a, prec_sys,
                          g_zero=self._g.is_zero and fs.beta <= 1e-12)
        a_new = res.x.to(self.dtype)

        u_new = z + (beta * dt * dt) * a_new
        v_new = v + dt * ((1.0 - gamma) * a + gamma * a_new)
        new_state = FastGridState(u=u_new.reshape(-1).to(self.dtype),
                                  v=v_new.reshape(-1).to(self.dtype),
                                  a=a_new.reshape(-1))
        info = {
            "iterations_1": res.iterations,
            "iterations_2": 0,
            "norm_u": fs._norm(u_new),
            "norm_v": fs._norm(v_new),
        }
        return new_state, info
