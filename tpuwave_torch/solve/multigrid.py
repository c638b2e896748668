"""Geometric multigrid for the grid-stencil systems (``--precond mg``).

Counterpart of tpuwave's solve/multigrid.py. At time steps beyond the
CFL limit the implicit system ``M + c K`` becomes stiffness-dominated
(condition ~ (dt/h)^2) and single-level solvers need O(dt/h)
iterations; a V-cycle keeps the count flat. On the structured
triangulated rectangle the spaces are nested: the P1 space on the Nel/2
mesh is a subspace of the fine one, the inclusion P is P1 interpolation
(coincident nodes copy, edge midpoints average their endpoints,
including the (+1, +1) triangulation diagonal), so the Galerkin coarse
operator P^T (M + c K) P is exactly the coarse-mesh FEM stencil. Smoothing
and the coarsest solve are fixed Chebyshev polynomials with analytic
eigenvalue bounds (solve/cheby_iter.py), so one V-cycle is a fixed SPD
operator, a valid CG preconditioner.

Boundary handling is the constrained-system convention of the fast
engines: level operators act as ``diag * x`` on pinned rows, and
residuals / corrections are zeroed there around the transfers.

Every level operator is ``kernels.constrained_stencil_apply`` (kernel B3
on the card, any grid shape). :class:`KernelGmgPreconditioner` also runs
the fine level's smoothing as kernel B4 blocks; the Chebyshev recurrences
of the coarse levels and the transfers are torch ops, as tpuwave computes
them in XLA outside its Pallas kernels.

P2 (the second half): a p-level on top of the P1 h-hierarchy. P1 on the
same mesh is a subspace of P2 and the inclusion is nodal (an edge
midpoint takes the average of its endpoints), so the Galerkin coarse
operator of the P2 system is the P1 system on the same mesh: the fine
level of ``gmg_for_system``. :class:`P2CanvasGmgPreconditioner` smooths on
the (4, Hc, Wc) canvases of the P2 engine, each smoothing block one pass
of kernel B12 / B13.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpuwave_torch.core.mesh import FeSpace, StructuredTriMesh
from tpuwave_torch.ops import kernels, kernels_p2
from tpuwave_torch.ops.stencil import (apply_stencil, constrained_apply_on,
                                       on_block)
from tpuwave_torch.ops.stencil_p2 import (P2PlaneStencil, canvas_shape,
                                          canvases_to_planes, flat_to_planes,
                                          planes_to_canvases, planes_to_flat)
from tpuwave_torch.solve.cheby_iter import (chebyshev_block,
                                            chebyshev_coefficients,
                                            stencil_symbol_bounds)

__all__ = ["prolong_p1", "restrict_p1", "MgLevel", "build_gmg_levels",
           "GmgPreconditioner", "KernelGmgPreconditioner", "gmg_for_system",
           "auto_precond", "AUTO_MG_THRESHOLD", "kernel_cycle",
           "gmg_flat_preconditioner", "prolong_p1_to_p2", "restrict_p2_to_p1",
           "ShardedGmgPreconditioner", "shard_cycle", "restrict_on",
           "prolong_on",
           "P2GmgPreconditioner", "P2CanvasGmgPreconditioner",
           "p2_gmg_for_system"]

#: ``precond='auto'`` switches to the V-cycle once the dimensionless
#: stiffness ratio q = stiff_coef * c^2 / (hx * hy) of the system
#: M + stiff_coef * K crosses this value (Jacobi-CG counts grow ~sqrt(q),
#: MG-PCG's stay flat; tpuwave's threshold, kept for identical routing).
AUTO_MG_THRESHOLD = 8.0

# the P1 inclusion weights as a 3x3 stencil on the fine grid (layout of
# ops/stencil.py: s[1+dj][1+di] couples offset (di, dj))
_P_STENCIL = ((0.5, 0.5, 0.0),
              (0.5, 1.0, 0.5),
              (0.0, 0.5, 0.5))


# ----------------------------------------------------------------------
# transfer operators (P = nested-P1 inclusion, R = P^T)
# ----------------------------------------------------------------------
def prolong_p1(c: torch.Tensor) -> torch.Tensor:
    """(ny+1, nx+1) coarse plane -> (2ny+1, 2nx+1) fine plane by P1
    interpolation: coincident nodes copy; horizontal, vertical and
    diagonal edge midpoints take 0.5 * first + 0.5 * second endpoint."""
    h, w = c.shape
    fine = c.new_zeros((2 * h - 1, 2 * w - 1))
    fine[0::2, 0::2] = c
    fine[0::2, 1::2] = 0.5 * c[:, :-1] + 0.5 * c[:, 1:]
    fine[1::2, 0::2] = 0.5 * c[:-1, :] + 0.5 * c[1:, :]
    fine[1::2, 1::2] = 0.5 * c[:-1, :-1] + 0.5 * c[1:, 1:]
    return fine


def restrict_p1(r: torch.Tensor) -> torch.Tensor:
    """(2ny+1, 2nx+1) fine plane -> (ny+1, nx+1) coarse plane, R = P^T:
    each coarse node gathers its own fine value plus half of the six fine
    edge midpoints it interpolates into (the _P_STENCIL pass over a zero
    ring, then every second node)."""
    y = apply_stencil(F.pad(r, (1, 1, 1, 1)), _P_STENCIL)[1:-1, 1:-1]
    return y[0::2, 0::2].contiguous()


# ----------------------------------------------------------------------
# level construction
# ----------------------------------------------------------------------
class MgLevel(NamedTuple):
    stencil: Tuple            # (3,3) tuple-of-tuples operator stencil
    shape: Tuple[int, int]    # (ny+1, nx+1) plane shape
    sm_theta: float           # smoother Chebyshev schedule
    sm_coeffs: Tuple


def _spd_symbol_bounds(stencil) -> Tuple[float, float]:
    """Analytic SPD spectrum bounds; keeps the lower bound positive even
    when the default relative pad would cross zero (stiffness-dominated
    stencils have lam_min << lam_max)."""
    lo, hi = stencil_symbol_bounds(stencil)
    if lo <= 0.0:
        lo0, _ = stencil_symbol_bounds(stencil, pad_rel=0.0)
        if lo0 <= 0.0:
            raise ValueError(f"stencil symbol not SPD: min {lo0}")
        # 512^2 sampling of the degree-1 trig symbol is accurate to
        # ~1e-5 relative; halving is a generous safety margin
        lo = 0.5 * lo0
    return lo, hi


def build_gmg_levels(system_stencil_of: Callable[[int, int], np.ndarray],
                     nel: Tuple[int, int], *, pre_degree: int = 2,
                     smooth_range: float = 8.0, min_coarse: int = 8,
                     coarse_tol: float = 1e-2,
                     max_coarse_degree: int = 96) -> Tuple[List[MgLevel],
                                                           float, Tuple]:
    """Build the level hierarchy.

    ``system_stencil_of(nx, ny)`` returns the (3, 3) operator stencil
    assembled on the (nx, ny) mesh (by nestedness the Galerkin coarse
    operator). Coarsening halves both axes while they stay even and at
    least ``min_coarse`` after halving.

    Returns (levels, coarse_theta, coarse_coeffs): every level carries a
    degree-``pre_degree`` Chebyshev smoother targeting the upper
    [lam_max/smooth_range, lam_max] band of its symbol spectrum; the
    coarsest level's full-range schedule is sized to reduce the residual
    by ``coarse_tol``.
    """
    nx, ny = int(nel[0]), int(nel[1])
    levels: List[MgLevel] = []
    while True:
        st = np.asarray(system_stencil_of(nx, ny))
        st_t = tuple(tuple(float(v) for v in row) for row in st)
        _, hi = _spd_symbol_bounds(st_t)
        th, cf = chebyshev_coefficients(hi / smooth_range, hi, pre_degree)
        levels.append(MgLevel(stencil=st_t, shape=(ny + 1, nx + 1),
                              sm_theta=th, sm_coeffs=tuple(cf)))
        if nx % 2 or ny % 2 or min(nx, ny) // 2 < min_coarse:
            break
        nx //= 2
        ny //= 2

    lo, hi = _spd_symbol_bounds(levels[-1].stencil)
    sigma = (hi + lo) / (hi - lo)
    need = math.acosh(1.0 / coarse_tol) / math.acosh(sigma)
    degree = min(max(int(math.ceil(need)), pre_degree), max_coarse_degree)
    c_theta, c_coeffs = chebyshev_coefficients(lo, hi, degree)
    return levels, c_theta, tuple(c_coeffs)


# ----------------------------------------------------------------------
# the V-cycle
# ----------------------------------------------------------------------
class GmgPreconditioner:
    """z = V(b): one V(pre, post)-cycle on the constrained level operators.

    A fixed SPD linear operator (fixed-polynomial Chebyshev smoothing and
    coarse solve, R = P^T): pass it as ``precond_inv_diag`` to
    solve/cg.py::pcg. Every level's matvec is kernel B3 on the card.
    """

    def __init__(self, levels: Sequence[MgLevel], coarse_theta: float,
                 coarse_coeffs: Tuple):
        self.levels = list(levels)
        self.coarse_theta = float(coarse_theta)
        self.coarse_coeffs = tuple(coarse_coeffs)
        self._masks: Dict[Tuple[int, torch.device], torch.Tensor] = {}

    def _interior(self, l: int, device) -> torch.Tensor:
        """Interior mask of level ``l`` (built once per device)."""
        key = (l, device)
        if key not in self._masks:
            self._masks[key] = ~kernels.pinned_mask(self.levels[l].shape,
                                                    device)
        return self._masks[key]

    @staticmethod
    def _constrained(lev: MgLevel) -> Callable:
        # interior rows S(x masked on pinned rows), pinned rows diag * x:
        # block-diagonal over interior / boundary, hence symmetric
        st, diag = lev.stencil, lev.stencil[1][1]

        def apply_c(x):
            return kernels.constrained_stencil_apply(x, st, diag)
        return apply_c

    def _coarse_solve(self, apply_c: Callable, b):
        """Fixed-schedule Chebyshev on the coarsest level."""
        x = b * (1.0 / self.coarse_theta)
        r = b - apply_c(x)
        d = x
        for c1, c2 in self.coarse_coeffs:
            d = c1 * d + c2 * r
            x = x + d
            r = r - apply_c(d)
        return x

    def _cycle(self, l: int, b):
        lev = self.levels[l]
        apply_c = self._constrained(lev)
        if l == len(self.levels) - 1:
            return self._coarse_solve(apply_c, b)
        interior = self._interior(l, b.device)
        # pre-smoothing (zero initial guess -> r stays consistent)
        x, r = chebyshev_block(apply_c, torch.zeros_like(b), b,
                               lev.sm_theta, lev.sm_coeffs)
        # coarse correction (boundary rows masked first: restriction must
        # be the exact transpose of the masked prolongation for symmetry)
        bc = restrict_p1(torch.where(interior, r, 0.0))
        bc = torch.where(self._interior(l + 1, b.device), bc, 0.0)
        ec = self._cycle(l + 1, bc)
        x = x + torch.where(interior, prolong_p1(ec), 0.0)
        r = b - apply_c(x)
        # post-smoothing (same polynomial -> symmetric cycle)
        x, _ = chebyshev_block(apply_c, x, r, lev.sm_theta, lev.sm_coeffs)
        return x

    def __call__(self, b):
        return self._cycle(0, b)


class KernelGmgPreconditioner(GmgPreconditioner):
    """The V-cycle with its fine level on the hand-written kernels (the
    port of tpuwave's ``PallasGmgPreconditioner``): pre-smoothing from a
    zero guess as one B4 block (the guess not read), the post-correction
    residual through B3, post-smoothing as one B4 block. The fine level is
    ~3/4 of the cycle's work in 2D. Works on the true grid; levels >= 1 keep the cycle of
    :class:`GmgPreconditioner`. Same fixed SPD polynomial as the parent.
    """

    def __init__(self, levels: Sequence[MgLevel], coarse_theta: float,
                 coarse_coeffs: Tuple):
        super().__init__(levels, coarse_theta, coarse_coeffs)
        if len(self.levels) < 2:
            raise ValueError("KernelGmgPreconditioner needs >= 2 levels "
                             "(single-level hierarchies: use "
                             "GmgPreconditioner)")

    def __call__(self, b):
        """b: residual plane, zero on pinned rows (the fast-path CG
        invariant). Returns z = V(b)."""
        lev = self.levels[0]
        st, th, cf = lev.stencil, lev.sm_theta, lev.sm_coeffs
        x, r, _ = kernels.cheby_block(None, b, st, th, cf)
        # the kernel left r zero on pinned rows: already interior-masked
        bc = torch.where(self._interior(1, b.device), restrict_p1(r), 0.0)
        ec = self._cycle(1, bc)
        x = x + torch.where(self._interior(0, b.device), prolong_p1(ec), 0.0)
        ax = kernels.constrained_stencil_apply(x, st, st[1][1])
        x, _, _ = kernels.cheby_block(x, b - ax, st, th, cf)
        return x


def restrict_on(layout, r: torch.Tensor) -> torch.Tensor:
    """:func:`restrict_p1` on a rank's block of a sharded fine grid: the
    _P_STENCIL pass after a one-node halo exchange, then the nodes of even
    global row and column (the coarse nodes this rank owns, see
    parallel/sharding.py::GridLayout.coarsen). The same sums in the same
    order as the whole-grid transfer."""
    y = on_block(layout, lambda v: apply_stencil(v, _P_STENCIL), r)
    return y[layout.r0 % 2::2, layout.c0 % 2::2].contiguous()


def prolong_on(fine, coarse, c: torch.Tensor) -> torch.Tensor:
    """:func:`prolong_p1` onto a rank's fine block (layout ``fine``) from
    its coarse block (layout ``coarse``, derived from ``fine``): a
    one-node coarse halo covers every fine node the rank owns."""
    cp = coarse.exchange(c, 1)
    f = prolong_p1(cp)
    a = fine.r0 - 2 * (coarse.r0 - 1)
    b = fine.c0 - 2 * (coarse.c0 - 1)
    h, w = fine.block_shape
    return f[a:a + h, b:b + w]


class ShardedGmgPreconditioner(GmgPreconditioner):
    """The V-cycle of :class:`GmgPreconditioner` on a rank's block of a
    sharded grid (``layout``, parallel/sharding.py).

    Each level's partition derives from the finer one (coarse node i is
    fine node 2 i, on the fine node's rank); every level operator is kernel
    B3 at the block's global offsets after a one-node halo exchange, and
    the transfers take a one-node halo too. Where a rank would own fewer
    than 2 rows or columns of a level, that level and every coarser one
    are agglomerated: the restricted residual is summed into the whole
    level grid on every rank and the rest of the cycle runs replicated
    (the plain cycle on the whole grid), each rank keeping its block of
    the prolongated correction. The fine level is not fused into B4 (it
    would need a halo as deep as the smoother's degree), as tpuwave turns
    its Pallas cycle off under sharding. The same fixed SPD polynomial.
    """

    def __init__(self, levels: Sequence[MgLevel], coarse_theta: float,
                 coarse_coeffs: Tuple, layout):
        super().__init__(levels, coarse_theta, coarse_coeffs)
        if tuple(layout.shape) != tuple(self.levels[0].shape):
            raise ValueError(f"layout {layout.shape} does not lie on the "
                             f"fine level {self.levels[0].shape}")
        lays = [layout]
        for _ in self.levels[1:]:
            lays.append(None if lays[-1] is None else lays[-1].coarsen())
        self.layouts = lays
        self._block_masks: Dict[int, torch.Tensor] = {}

    def _block_interior(self, l: int) -> torch.Tensor:
        if l not in self._block_masks:
            self._block_masks[l] = ~self.layouts[l].pinned()
        return self._block_masks[l]

    def _cycle_block(self, l: int, b):
        lay, lev = self.layouts[l], self.levels[l]
        st, diag = lev.stencil, lev.stencil[1][1]

        def apply_c(x):
            return constrained_apply_on(lay, x, st, diag)
        if l == len(self.levels) - 1:
            return self._coarse_solve(apply_c, b)
        interior = self._block_interior(l)
        x, r = chebyshev_block(apply_c, torch.zeros_like(b), b,
                               lev.sm_theta, lev.sm_coeffs)
        bc = restrict_on(lay, torch.where(interior, r, 0.0))
        nxt = self.layouts[l + 1]
        if nxt is not None:
            bc = torch.where(self._block_interior(l + 1), bc, 0.0)
            corr = prolong_on(lay, nxt, self._cycle_block(l + 1, bc))
        else:
            # agglomerate: the whole level on every rank
            full = b.new_zeros(self.levels[l + 1].shape)
            r0, c0 = -(-lay.r0 // 2), -(-lay.c0 // 2)
            full[r0:r0 + bc.shape[0], c0:c0 + bc.shape[1]] = bc
            full = lay.all_sum(full)
            full = torch.where(self._interior(l + 1, b.device), full, 0.0)
            corr = lay.local(prolong_p1(self._cycle(l + 1, full)))
        x = x + torch.where(interior, corr, 0.0)
        r = b - apply_c(x)
        x, _ = chebyshev_block(apply_c, x, r, lev.sm_theta, lev.sm_coeffs)
        return x

    def __call__(self, b):
        return self._cycle_block(0, b)


def shard_cycle(gmg: GmgPreconditioner, layout) -> GmgPreconditioner:
    """``gmg``'s cycle on a rank's block (:class:`ShardedGmgPreconditioner`)
    when ``layout`` is sharded; else its kernel form
    (:func:`kernel_cycle`)."""
    if layout is None or not layout.sharded:
        return kernel_cycle(gmg)
    return ShardedGmgPreconditioner(gmg.levels, gmg.coarse_theta,
                                    gmg.coarse_coeffs, layout)


def gmg_for_system(nel: Tuple[int, int], geometry, c: float,
                   stiff_coef: float, *, pre_degree: int = 2,
                   smooth_range: float = 8.0, min_coarse: int = 8,
                   coarse_tol: float = 1e-2) -> GmgPreconditioner:
    """GMG preconditioner for ``M + stiff_coef * K`` on the structured
    (nel, geometry) P1 mesh (``stiff_coef`` = beta dt^2 for Newmark,
    (theta dt)^2 for the theta u-system). Level operators are the
    coarse-mesh FEM stencils; all setup is host-side numpy."""
    from tpuwave_torch.core.quadrature import gauss_simplex
    from tpuwave_torch.ops.assembly import (element_mass_class,
                                            element_stiffness_class)
    from tpuwave_torch.ops.stencil import class_matrices_to_stencil

    quad = gauss_simplex(2)

    def stencil_of(nx, ny):
        space = FeSpace(StructuredTriMesh((nx, ny), geometry), 1)
        m = class_matrices_to_stencil(element_mass_class(space, quad))
        k = class_matrices_to_stencil(
            element_stiffness_class(space, quad, c * c))
        return m + stiff_coef * k

    levels, c_theta, c_coeffs = build_gmg_levels(
        stencil_of, nel, pre_degree=pre_degree, smooth_range=smooth_range,
        min_coarse=min_coarse, coarse_tol=coarse_tol)
    return GmgPreconditioner(levels, c_theta, c_coeffs)


def auto_precond(params, mesh, stiff_coef: float) -> str:
    """Resolve ``precond='auto'`` for the system ``M + stiff_coef * K``:
    ``'mg'`` when the V-cycle applies (structured mesh ``mesh``, constant
    wave speed, R in {1, 2}, C not time-dependent) and the system is
    stiffness-dominated enough that it pays (q = stiff_coef * c^2 /
    (hx * hy) >= AUTO_MG_THRESHOLD), ``'jacobi'`` otherwise (an imported
    mesh among them, as in tpuwave)."""
    p = params
    eligible = (type(mesh) is StructuredTriMesh
                and p.c.constant_value is not None and p.r in (1, 2)
                and not (p.time_dependent_c and p.c.time_dependent))
    if not eligible:
        return "jacobi"
    c = float(p.c.constant_value)
    q = float(stiff_coef) * c * c / (mesh.hx * mesh.hy)
    return "mg" if q >= AUTO_MG_THRESHOLD else "jacobi"


def kernel_cycle(gmg: GmgPreconditioner) -> GmgPreconditioner:
    """The same cycle with its fine level on kernels B4 / B3
    (:class:`KernelGmgPreconditioner`) when the hierarchy has >= 2 levels;
    a one-level hierarchy has no fine level to fuse and stays plain, as in
    tpuwave's routing (fast_engine.py:374-382)."""
    if len(gmg.levels) < 2:
        return gmg
    return KernelGmgPreconditioner(gmg.levels, gmg.coarse_theta,
                                   gmg.coarse_coeffs)


def gmg_flat_preconditioner(disc, stiff_coef: float, c_ref=None,
                            **kw) -> Callable:
    """GMG V-cycle as a FLAT-DoF-vector preconditioner for the parity
    solvers (models/theta.py, models/newmark.py), whose state is the flat
    DoF vector of models/discretization.py, on ``disc``'s dtype and
    device.

    Needs the structured discretization with a constant wave speed, or an
    explicit frozen coefficient ``c_ref``. At R = 1 the flat DoF numbering
    IS the row-major vertex grid, so the adapter is a pair of reshapes
    around the V-cycle; at R = 2 it is the plane concatenation of
    ops/stencil_p2.py, on which :class:`P2GmgPreconditioner` runs
    directly. Either way the P1 V-cycle's fine level runs on B4 / B3 when
    the hierarchy has >= 2 levels. Raises ValueError otherwise (tpuwave's
    text: an imported mesh, a varying c without ``c_ref``, R > 2).
    """
    p = disc.params
    mesh = disc.mesh
    if type(mesh) is not StructuredTriMesh:
        raise ValueError("mg preconditioner needs the structured mesh")
    c_val = p.c.constant_value if c_ref is None else float(c_ref)
    if c_val is None:
        raise ValueError("mg preconditioner needs a constant wave speed C "
                         "(or an explicit c_ref frozen coefficient)")
    if p.r == 2:
        pre = p2_gmg_for_system(mesh.nel, mesh.geometry, float(c_val),
                                stiff_coef, dtype=disc.dtype,
                                device=disc.device, **kw)
        pre.p1_cycle = kernel_cycle(pre.p1_cycle)
        return pre
    if p.r != 1:
        raise ValueError("mg preconditioner supports only R=1/R=2")
    shape = (mesh.ny + 1, mesh.nx + 1)
    inner = kernel_cycle(gmg_for_system(mesh.nel, mesh.geometry,
                                       float(c_val), stiff_coef, **kw))

    def precond(r):
        return inner(r.reshape(shape)).reshape(-1)

    precond.cycle = inner
    return precond


# ----------------------------------------------------------------------
# P2: p-multigrid (P2 -> P1 on the same mesh, then the h-hierarchy)
# ----------------------------------------------------------------------
def prolong_p1_to_p2(c: torch.Tensor) -> dict:
    """(ny+1, nx+1) P1 vertex grid -> P2 plane dict (V, H, W, D): nodal
    P1-in-P2 interpolation (edge midpoints average their endpoints; the
    D plane sits on the (+1,+1) triangulation diagonal)."""
    return {"V": c,
            "H": 0.5 * (c[:, :-1] + c[:, 1:]),
            "W": 0.5 * (c[:-1, :] + c[1:, :]),
            "D": 0.5 * (c[:-1, :-1] + c[1:, 1:])}


def restrict_p2_to_p1(planes: dict) -> torch.Tensor:
    """P2 plane dict -> (ny+1, nx+1) P1 grid, the exact transpose of
    ``prolong_p1_to_p2`` (out-of-range edge neighbours read as zero —
    they only affect boundary rows, which every caller masks)."""
    v, h, w, d = planes["V"], planes["H"], planes["W"], planes["D"]
    hterm = F.pad(h, (1, 0)) + F.pad(h, (0, 1))
    wterm = F.pad(w, (0, 0, 1, 0)) + F.pad(w, (0, 0, 0, 1))
    dterm = F.pad(d, (1, 0, 1, 0)) + F.pad(d, (0, 1, 0, 1))
    return v + 0.5 * (hterm + wterm + dterm)


def _smooth_block_jacobi(apply_c: Callable, inv_d, x, r, theta: float,
                         coeffs):
    """Chebyshev smoothing block on the Jacobi-scaled operator D^{-1}A
    (the P2 planes have different diagonals): the fixed polynomial
    q(D^{-1}A) D^{-1}, symmetric positive, so the cycle stays a valid CG
    preconditioner. ``theta``/``coeffs`` target the D^{-1}A spectrum."""
    d = (1.0 / theta) * (inv_d * r)
    x = x + d
    r = r - apply_c(d)
    for c1, c2 in coeffs:
        d = c1 * d + c2 * (inv_d * r)
        x = x + d
        r = r - apply_c(d)
    return x, r


def _p2_interior_flat(nx: int, ny: int, device) -> torch.Tensor:
    """Flat P2 non-Dirichlet mask (plane order V, H, W, D)."""
    mask = kernels_p2.p2_canvas_interior(nx, ny, canvas_shape(nx, ny),
                                         device)
    return planes_to_flat(canvases_to_planes(mask, nx, ny))


class P2GmgPreconditioner:
    """One (p+h)-multigrid V-cycle on the flat P2 DoF vector: Jacobi-
    Chebyshev smoothing on the P2 plane-stencil system, coarse correction
    by the full P1 h-hierarchy. SPD, valid for pcg. The P2 engine takes
    its ``system``, ``sm_theta``, ``sm_coeffs`` and ``p1_cycle`` and runs
    the canvas form (:class:`P2CanvasGmgPreconditioner`)."""

    def __init__(self, system, interior, diag, sm_theta: float,
                 sm_coeffs: Tuple, p1_cycle: GmgPreconditioner,
                 nx: int, ny: int):
        self.system = system            # P2PlaneStencil (flat call surface)
        self.interior = interior
        self.diag = diag
        self.sm_theta = float(sm_theta)
        self.sm_coeffs = tuple(sm_coeffs)
        self.p1_cycle = p1_cycle
        self.nx, self.ny = int(nx), int(ny)

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        interior, diag = self.interior, self.diag
        inv_diag = 1.0 / diag

        def apply_c(x):
            xi = torch.where(interior, x, 0.0)
            return torch.where(interior, self.system(xi), diag * x)

        x, r = _smooth_block_jacobi(apply_c, inv_diag, torch.zeros_like(b),
                                    b, self.sm_theta, self.sm_coeffs)
        planes = flat_to_planes(torch.where(interior, r, 0.0),
                                self.nx, self.ny)
        grid_int = ~kernels.pinned_mask((self.ny + 1, self.nx + 1),
                                        b.device)
        bc = torch.where(grid_int, restrict_p2_to_p1(planes), 0.0)
        ec = torch.where(grid_int, self.p1_cycle(bc), 0.0)
        corr = torch.where(interior, planes_to_flat(prolong_p1_to_p2(ec)),
                           0.0)
        x = x + corr
        r = r - apply_c(corr)
        x, _ = _smooth_block_jacobi(apply_c, inv_diag, x, r,
                                    self.sm_theta, self.sm_coeffs)
        return x


class P2CanvasGmgPreconditioner:
    """(p+h)-MG V-cycle on the (4, Hc, Wc) canvas layout of the P2 engine.

    Same algebra as :class:`P2GmgPreconditioner` on the constrained
    canvas operator of ``system`` (a ``P2PlaneStencil``): the
    pre-smoothing block is one pass of kernel B12 (b -> (x, r)), the
    coarse-correction residual update and the post-smoothing block one
    pass of B13 (their plain versions on CPU tensors); the p <-> h
    transfers go canvas -> planes -> P1 grid. A fixed SPD polynomial,
    valid as a pcg preconditioner.
    """

    def __init__(self, system, sm_theta: float, sm_coeffs: Tuple, p1_cycle,
                 cshape: Tuple[int, int]):
        self.nx, self.ny = system.nx, system.ny
        self.terms = system.terms
        self.inv_diags = tuple(1.0 / float(system.plane_diag[q])
                               for q in "VHWD")
        self.sm_theta = float(sm_theta)
        self.sm_coeffs = tuple((float(a), float(c)) for a, c in sm_coeffs)
        self.p1_cycle = p1_cycle
        self.cshape = tuple(cshape)
        self._grid_int = ~kernels.pinned_mask((self.ny + 1, self.nx + 1),
                                              system.device)

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        """b: (4, Hc, Wc) canvas residual, zero on pinned and pad entries
        (the canvas-CG invariant). Returns the canvas z = V(b)."""
        smooth = (self.terms, self.inv_diags, self.sm_theta, self.sm_coeffs,
                  self.nx, self.ny)
        # B12's outputs are supported on the interior
        x, r = kernels_p2.p2_presmooth(b, *smooth)
        planes = canvases_to_planes(r, self.nx, self.ny)
        bc = torch.where(self._grid_int, restrict_p2_to_p1(planes), 0.0)
        ec = torch.where(self._grid_int, self.p1_cycle(bc), 0.0)
        corr = planes_to_canvases(prolong_p1_to_p2(ec), self.cshape)
        return kernels_p2.p2_postsmooth(x, r, corr, *smooth)


def p2_gmg_for_system(nel: Tuple[int, int], geometry, c: float,
                      stiff_coef: float, *, dtype=torch.float64,
                      device="cuda", pre_degree: int = 2,
                      smooth_range: float = 8.0, min_coarse: int = 8,
                      coarse_tol: float = 1e-2,
                      lambda_max: float | None = None) -> P2GmgPreconditioner:
    """(p+h)-MG preconditioner for the P2 system ``M + stiff_coef * K``
    on the structured (nel, geometry) mesh, tensors of ``dtype`` on
    ``device`` (default "cuda", which raises where there is no card).

    The P2-level smoother needs lam_max of D^{-1}A; there is no scalar
    symbol, so it is estimated once by power iteration
    (solve/chebyshev.py::estimate_lambda_max, from tpuwave's start
    vector) unless passed in.
    """
    from tpuwave_torch.config import resolve_device
    from tpuwave_torch.core.quadrature import gauss_simplex
    from tpuwave_torch.ops.assembly import (element_mass_class,
                                            element_stiffness_class)
    from tpuwave_torch.solve import chebyshev

    device = resolve_device(device)
    nx, ny = int(nel[0]), int(nel[1])
    space = FeSpace(StructuredTriMesh((nx, ny), geometry), 2)
    quad = gauss_simplex(3)
    mass = P2PlaneStencil(space, element_mass_class(space, quad), dtype,
                          device)
    stiff = P2PlaneStencil(space,
                           element_stiffness_class(space, quad, c * c),
                           dtype, device)
    system = mass.axpy(stiff_coef, stiff)
    interior = _p2_interior_flat(nx, ny, device)
    diag = system.diagonal()
    inv_diag = 1.0 / diag

    def apply_c(x):
        xi = torch.where(interior, x, 0.0)
        return torch.where(interior, system(xi), diag * x)

    if lambda_max is None:
        lambda_max = chebyshev.estimate_lambda_max(apply_c, inv_diag,
                                                   space.n_dofs)
    th, cf = chebyshev_coefficients(lambda_max / smooth_range,
                                    lambda_max, pre_degree)
    p1_cycle = gmg_for_system((nx, ny), geometry, c, stiff_coef,
                              pre_degree=pre_degree,
                              smooth_range=smooth_range,
                              min_coarse=min_coarse, coarse_tol=coarse_tol)
    return P2GmgPreconditioner(system, interior, diag, th, tuple(cf),
                               p1_cycle, nx, ny)
