"""The hand-written CUDA kernels of the FWI propagator and their plain
PyTorch versions.

Counterpart of tpuwave/ops/pallas_varcoef.py. Four kernels (B14-B17) of
``csrc/varcoef_kernels.cu``, built by ``ops/_build.py``: one leapfrog
step and k fused steps with the variable-coefficient 7-plane stencil, and
the matching backward steps of the time-reversal adjoint. Each public
function is a wrapper: on CUDA tensors it launches its kernel or raises;
on CPU tensors it runs the ``*_reference`` plain version, which the
kernel is held against.

Every grid is the TRUE (ny+1, nx+1) vertex grid: no padding, no row-block
rule. The stencil is

    (K u)[I] = sum_j planes[j][I] * u[I + OFFSETS[j]]

with ``OFFSETS`` = (dx, dy) in tpuwave's plane order. A node is pinned
(Dirichlet) on the grid's outer rows and columns; pinned nodes come out 0
in every updated field, and a neighbour outside the grid reads as 0
(nothing wraps).

Receivers are given as points: ``rows``/``cols`` (P,) int32 grid indices
and ``weights`` (P,), ``per`` consecutive points per receiver (1 for the
nearest vertex, 3 for P1 interpolation in a triangle); a trace sample is
sum_j weights[j] * u[point j] over a receiver's points, summed in point
order.

Launches are counted in ``ops/kernels.py``'s ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from tpuwave_torch.ops.kernels import (LAUNCHES, _DTYPES, _grid_size, _lib,
                                       _max_smem, _ptr, _raise_on, _stream,
                                       pinned_mask)

__all__ = ["OFFSETS", "Receivers", "varcoef_stencil",
           "varcoef_leapfrog_step", "varcoef_leapfrog_step_reference",
           "varcoef_leapfrog_multistep",
           "varcoef_leapfrog_multistep_reference",
           "varcoef_adjoint_step", "varcoef_adjoint_step_reference",
           "varcoef_adjoint_multistep",
           "varcoef_adjoint_multistep_reference", "MAX_FUSED_STEPS",
           "multistep_tile", "adjoint_tile", "fused_chunks"]

#: (dx, dy) neighbour offsets; plane j multiplies u[r + dy_j, c + dx_j]
#: (tpuwave's order, pallas_varcoef.py:55)
OFFSETS = ((0, 0), (-1, 0), (1, 0), (0, -1), (-1, -1), (0, 1), (1, 1))


class Receivers(NamedTuple):
    """Receiver points on the grid (see the module docstring)."""
    rows: torch.Tensor      # (P,) int32
    cols: torch.Tensor      # (P,) int32
    weights: torch.Tensor   # (P,) grid dtype
    per: int                # points per receiver

    @property
    def n_rec(self) -> int:
        return self.rows.numel() // self.per


# -- plain helpers ----------------------------------------------------------
def _shifts(u: torch.Tensor) -> torch.Tensor:
    """(7, H, W) stack of u[I + OFFSETS[j]], 0 outside the grid."""
    h, w = u.shape
    p = torch.nn.functional.pad(u, (1, 1, 1, 1))
    return torch.stack([p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                        for dx, dy in OFFSETS])


def varcoef_stencil(u: torch.Tensor, planes: torch.Tensor,
                    shifts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(K u) with the first 7 of ``planes``, summed in OFFSETS order."""
    s = _shifts(u) if shifts is None else shifts
    out = planes[0] * s[0]
    for j in range(1, 7):
        out = out + planes[j] * s[j]
    return out


def _sample(u: torch.Tensor, rec: Receivers) -> torch.Tensor:
    vals = (u[rec.rows.long(), rec.cols.long()] * rec.weights).reshape(
        -1, rec.per)
    out = vals[:, 0]
    for j in range(1, rec.per):
        out = out + vals[:, j]
    return out


def _add_at(u: torch.Tensor, r: int, c: int, v) -> torch.Tensor:
    u[r, c] += v
    return u


# -- checks ------------------------------------------------------------------
def _check(name: str, grid: torch.Tensor, *grids: torch.Tensor,
           other=()) -> None:
    """``grid``, ``grids`` ((H, W) or (n, H, W) stacks of the grid's shape)
    and ``other`` tensors share device and dtype and are contiguous."""
    if not isinstance(grid, torch.Tensor) or grid.dim() != 2:
        raise ValueError(f"{name}: expected a 2-D grid tensor")
    if grid.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {grid.dtype} (float32 | float64)")
    if grid.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {grid.device}")
    for t in (grid, *grids, *other):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected tensors, got {type(t)}")
        if (t.device, t.dtype) != (grid.device, grid.dtype):
            raise ValueError(f"{name}: operands differ in device or dtype")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor is not contiguous")
    for t in grids:
        if t.dim() not in (2, 3) or tuple(t.shape[-2:]) != tuple(grid.shape):
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)} "
                             f"on a {tuple(grid.shape)} grid")
    if 9 * grid.numel() >= 2 ** 31:
        raise ValueError(f"{name}: grid of {grid.numel()} nodes exceeds the "
                         "kernels' 32-bit plane indexing")


def _n_planes(name: str, planes: torch.Tensor, allowed) -> int:
    if planes.dim() != 3 or planes.shape[0] not in allowed:
        raise ValueError(f"{name}: planes must be ({' | '.join(map(str, allowed))}"
                         f", H, W), got {tuple(planes.shape)}")
    return int(planes.shape[0])


def _check_points(name: str, grid: torch.Tensor, rows, cols) -> None:
    for t in (rows, cols):
        if (t.dtype != torch.int32 or t.device != grid.device or t.dim() != 1
                or not t.is_contiguous()):
            raise ValueError(f"{name}: point indices must be contiguous "
                             "(P,) int32 tensors on the grid's device")
    if rows.numel() != cols.numel():
        raise ValueError(f"{name}: rows and cols differ in length")


def _src(name: str, grid: torch.Tensor, src) -> Tuple[int, int]:
    r, c = int(src[0]), int(src[1])
    if not (0 <= r < grid.shape[0] and 0 <= c < grid.shape[1]):
        raise ValueError(f"{name}: source {(r, c)} outside the grid")
    return r, c


def _ring_args(name: str, grid: torch.Tensor, ring):
    if ring is None:
        return (-1, -1, -1, -1)
    ra, rb, ca, cb = (int(x) for x in ring)
    h, w = grid.shape
    if not (0 <= ra <= rb < h and 0 <= ca <= cb < w):
        raise ValueError(f"{name}: ring {ring} outside the {h}x{w} grid")
    return ra, rb, ca, cb


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


#: the most steps one B15 or B17 launch fuses: each has a fixed slab, so
#: each further step shrinks its tile and adds halo work; a pass of k
#: steps is fused_chunks(k) launches (B15 splits it in C, B17 here)
MAX_FUSED_STEPS = 8
#: B15's slab side per dtype, as csrc/varcoef_kernels.cu
#: MultistepGeometry has it (the launcher refuses another): a block
#: covers a side x side slab, its tile plus an n_steps + 1 halo on each
#: side, and keeps the planes and u_prev of its nodes in registers
_MULTISTEP_SIDE = {torch.float32: 60, torch.float64: 48}


def multistep_tile(n_steps: int, dtype: torch.dtype) -> int:
    """Tile side of one B15 launch of ``n_steps`` <= MAX_FUSED_STEPS
    steps: its slab side less an ``n_steps`` + 1 halo on each side."""
    k = int(n_steps)
    if not 1 <= k <= MAX_FUSED_STEPS:
        raise ValueError(f"varcoef_leapfrog_multistep: one launch fuses 1 "
                         f"to {MAX_FUSED_STEPS} steps, not {k}")
    return _MULTISTEP_SIDE[dtype] - 2 * (k + 1)


def fused_chunks(n_steps: int) -> tuple:
    """The steps of each B15 or B17 launch for a pass of ``n_steps``
    fused steps: as few launches of at most MAX_FUSED_STEPS as will do,
    as even as they can be."""
    k = int(n_steps)
    n = -(-k // MAX_FUSED_STEPS)
    return tuple((k * (i + 1)) // n - (k * i) // n for i in range(n))


#: B17's slab side per dtype (csrc/varcoef_kernels.cu AdjointGeometry): a
#: block covers a side x side slab, its tile plus an n_steps halo on each
#: side, and keeps the planes of its nodes in registers
_ADJOINT_SIDE = {torch.float32: 48, torch.float64: 32}
#: the smallest B17 tile that adjoint_tile allows (the kernel takes any
#: tile >= 1; below 8 the halo's redundant work swamps it)
_MIN_ADJOINT_TILE = 8


def _adjoint_smem(dtype: torch.dtype) -> int:
    """B17's shared memory: u_cur and the masked blam, double buffered,
    over its slab (with a spare row above and below and a spare value at
    each end), and one bit per slab node for the receiver points."""
    side = _ADJOINT_SIDE[dtype]
    buf = side * side + 2 * (side + 1)
    return 4 * buf * _itemsize(dtype) + 4 * ((side * side + 31) // 32)


def adjoint_tile(n_steps: int, n_planes: int, dtype: torch.dtype,
                 max_smem: int) -> int:
    """Tile side of B17: its slab side less an ``n_steps`` halo on each
    side (the planes, any ``n_planes``, live in registers), at least 8;
    raises when k is too large or the slabs do not fit ``max_smem``."""
    tile = _ADJOINT_SIDE[dtype] - 2 * int(n_steps)
    if tile < _MIN_ADJOINT_TILE or _adjoint_smem(dtype) > max_smem:
        raise ValueError(
            f"varcoef_adjoint_multistep: n_steps={n_steps} in {dtype} leaves "
            f"a tile of {tile} in its {_ADJOINT_SIDE[dtype]}-node slab "
            f"(at least {_MIN_ADJOINT_TILE}) or needs "
            f"{_adjoint_smem(dtype)} B of shared memory (the card allows "
            f"{max_smem} B)")
    return tile


# -- B14: one variable-coefficient leapfrog step -----------------------------
def varcoef_leapfrog_step_reference(u, u_prev, planes, coef, damp=None):
    """u' = 2u - u_prev - coef K u, or (2u - dnum u_prev - coef K u) dden
    with ``damp`` = (dnum, dden); pinned nodes set to 0."""
    ku = varcoef_stencil(u, planes)
    if damp is None:
        un = 2.0 * u - u_prev - coef * ku
    else:
        dnum, dden = damp
        un = (2.0 * u - dnum * u_prev - coef * ku) * dden
    return torch.where(pinned_mask(u.shape, u.device), 0.0, un)


def varcoef_leapfrog_step(u: torch.Tensor, u_prev: torch.Tensor,
                          planes: torch.Tensor, coef: float,
                          damp: Optional[Tuple[torch.Tensor, torch.Tensor]]
                          = None) -> torch.Tensor:
    """One fused variable-coefficient leapfrog step (replaces
    ``varcoef_leapfrog_step_pallas``). ``planes``: (7, H, W) in OFFSETS
    order; ``coef`` = dt^2 / lumped interior mass; ``damp``: the sponge's
    (dnum, dden) grids, None for the undamped hard-wall update."""
    name = "varcoef_leapfrog_step"
    extra = () if damp is None else tuple(damp)
    _check(name, u, u_prev, planes, *extra)
    _n_planes(name, planes, (7,))
    if u.device.type == "cpu":
        return varcoef_leapfrog_step_reference(u, u_prev, planes, coef, damp)
    out = torch.empty_like(u)
    h, w = u.shape
    dnum, dden = (None, None) if damp is None else damp
    with torch.cuda.device(u.device):
        rc = _lib().tw_varcoef_step(
            _DTYPES[u.dtype], _ptr(u), _ptr(u_prev), _ptr(planes),
            None if dnum is None else _ptr(dnum),
            None if dden is None else _ptr(dden), _ptr(out), h, w,
            float(coef), _stream(u))
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out


# -- B15: k fused forward steps -------------------------------------------------
def varcoef_leapfrog_multistep_reference(u, u_prev, planes, wchunk, src,
                                         coef, rec: Receivers, ring=None):
    """``len(wchunk)`` forward steps. Undamped (7 planes):
    u' = mask0(2u - u_prev - coef K u); damped (9 planes: the dden-folded
    stencil, p2 = 2 dden, pm = dden dnum): u' = mask0(p2 u - pm u_prev -
    coef K' u). After the mask the source gets wchunk[s] * coef (times
    dden = p2 / 2 when damped). Returns (u, u_prev, traces (k, n_rec)) and,
    with ``ring`` = (rA, rB, cA, cB), ring_rows (k, 2, W) = rows rA, rB and
    ring_cols (k, H, 2) = cols cA, cB after every step."""
    damped = planes.shape[0] == 9
    sr, sc = int(src[0]), int(src[1])
    pinned = pinned_mask(u.shape, u.device)
    ssel = coef * (0.5 * planes[7, sr, sc]) if damped else coef
    cur, prev = u, u_prev
    traces, rows, cols = [], [], []
    for s in range(wchunk.shape[0]):
        ku = varcoef_stencil(cur, planes)
        if damped:
            nxt = planes[7] * cur - planes[8] * prev - coef * ku
        else:
            nxt = 2.0 * cur - prev - coef * ku
        nxt = _add_at(torch.where(pinned, 0.0, nxt), sr, sc,
                      wchunk[s] * ssel)
        prev, cur = cur, nxt
        traces.append(_sample(cur, rec))
        if ring is not None:
            ra, rb, ca, cb = ring
            rows.append(torch.stack([cur[ra], cur[rb]]))
            cols.append(torch.stack([cur[:, ca], cur[:, cb]], dim=1))
    out = (cur, prev, torch.stack(traces))
    if ring is not None:
        out += (torch.stack(rows), torch.stack(cols))
    return out


def varcoef_leapfrog_multistep(u: torch.Tensor, u_prev: torch.Tensor,
                               planes: torch.Tensor, wchunk: torch.Tensor,
                               src, coef: float, rec: Receivers,
                               ring: Optional[Tuple[int, int, int, int]]
                               = None):
    """``len(wchunk)`` fused forward steps (replaces
    ``varcoef_leapfrog_multistep_pallas``), as fused_chunks(k) launches
    from one C call: source injection at ``src`` = (row, col) in the
    kernel, receiver samples written after every inner step, and with
    ``ring`` the interface ring saved after every inner step. Returns (u,
    u_prev, traces[, ring_rows, ring_cols]) as the plain version does."""
    name = "varcoef_leapfrog_multistep"
    _check(name, u, u_prev, planes, other=(wchunk, rec.weights))
    n_planes = _n_planes(name, planes, (7, 9))
    _check_points(name, u, rec.rows, rec.cols)
    k = int(wchunk.numel())
    if wchunk.dim() != 1 or k < 1:
        raise ValueError(f"{name}: wchunk must be (n_steps >= 1,)")
    sr, sc = _src(name, u, src)
    ra, rb, ca, cb = _ring_args(name, u, ring)
    if u.device.type == "cpu":
        return varcoef_leapfrog_multistep_reference(
            u, u_prev, planes, wchunk, (sr, sc), coef, rec, ring)
    h, w = u.shape
    traces = torch.empty((k, rec.n_rec), dtype=u.dtype, device=u.device)
    ring_rows = ring_cols = None
    if ring is not None:
        ring_rows = torch.empty((k, 2, w), dtype=u.dtype, device=u.device)
        ring_cols = torch.empty((k, h, 2), dtype=u.dtype, device=u.device)
    out_u, out_up = torch.empty_like(u), torch.empty_like(u)
    # the state between the launches of a split pass
    scratch = ((torch.empty_like(u), torch.empty_like(u))
               if k > MAX_FUSED_STEPS else (None, None))
    with torch.cuda.device(u.device):
        rc = _lib().tw_varcoef_multistep(
            _DTYPES[u.dtype], _ptr(u), _ptr(u_prev), _ptr(planes), n_planes,
            _ptr(wchunk), k, MAX_FUSED_STEPS, _MULTISTEP_SIDE[u.dtype], sr,
            sc, _ptr(rec.rows), _ptr(rec.cols), _ptr(rec.weights), rec.n_rec,
            rec.per, ra, rb, ca, cb, _ptr(out_u), _ptr(out_up),
            *(None if s is None else _ptr(s) for s in scratch), _ptr(traces),
            None if ring_rows is None else _ptr(ring_rows),
            None if ring_cols is None else _ptr(ring_cols), h, w,
            float(coef), _stream(u))
    _raise_on(rc, name)
    LAUNCHES[name] += len(fused_chunks(k))
    out = (out_u, out_up, traces)
    return out if ring is None else out + (ring_rows, ring_cols)


# -- B16: one backward step --------------------------------------------------
def varcoef_adjoint_step_reference(u_next, u_cur, lam_next, lam_partial,
                                   planes, wbar, coef):
    """blam = mask0(lam_next); lam_cur = mask0(lam_partial + 2 blam -
    coef K blam); u_prev = mask0(2 u_cur - u_next - coef K u_cur);
    lam_partial' = -blam; wbar[j] -= coef blam * u_cur[I + OFFSETS[j]]
    (in place). Returns (u_prev, lam_cur, lam_partial', wbar)."""
    pinned = pinned_mask(u_cur.shape, u_cur.device)
    blam = torch.where(pinned, 0.0, lam_next)
    s_u = _shifts(u_cur)
    k_blam = varcoef_stencil(blam, planes)
    k_u = varcoef_stencil(u_cur, planes, s_u)
    lam_cur = torch.where(pinned, 0.0,
                          lam_partial + 2.0 * blam - coef * k_blam)
    u_prev = torch.where(pinned, 0.0, 2.0 * u_cur - u_next - coef * k_u)
    wbar.sub_((coef * blam)[None] * s_u)
    return u_prev, lam_cur, -blam, wbar


def varcoef_adjoint_step(u_next: torch.Tensor, u_cur: torch.Tensor,
                         lam_next: torch.Tensor, lam_partial: torch.Tensor,
                         planes: torch.Tensor, wbar: torch.Tensor,
                         coef: float):
    """One fused backward step of the time-reversal adjoint (replaces
    ``varcoef_adjoint_step_pallas``), hard-wall algebra; ``wbar`` (7, H, W)
    is updated in place (tpuwave donates it). Returns (u_prev,
    lam_cur (before receiver injection), lam_partial', wbar)."""
    name = "varcoef_adjoint_step"
    _check(name, u_next, u_cur, lam_next, lam_partial, planes, wbar)
    _n_planes(name, planes, (7,))
    _n_planes(name, wbar, (7,))
    if u_next.device.type == "cpu":
        return varcoef_adjoint_step_reference(u_next, u_cur, lam_next,
                                              lam_partial, planes, wbar, coef)
    h, w = u_next.shape
    u_prev, lam_cur, lp_new = (torch.empty_like(u_next) for _ in range(3))
    with torch.cuda.device(u_next.device):
        band = _grid_size("tw_varcoef_adjoint_step_band",
                          torch.cuda.current_device(), u_next.dtype, h, w)
        rc = _lib().tw_varcoef_adjoint_step(
            _DTYPES[u_next.dtype], _ptr(u_next), _ptr(u_cur), _ptr(lam_next),
            _ptr(lam_partial), _ptr(planes), _ptr(wbar), _ptr(u_prev),
            _ptr(lam_cur), _ptr(lp_new), h, w, band, float(coef),
            _stream(u_next))
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return u_prev, lam_cur, lp_new, wbar


# -- B17: k fused backward steps -----------------------------------------------
def varcoef_adjoint_multistep_reference(u_next, u_cur, lam, lam_partial,
                                        planes, wbar, wchunk, inj, src, coef,
                                        points, ring=None, ring_rows=None,
                                        ring_cols=None):
    """``len(wchunk)`` backward steps in time-descending order. Step s:
    wavbar[s] = coef lam[src] (before the update); blam = mask0(lam) (damped,
    9 planes [K planes, dden, dnum]: mask0(dden lam)); lam' = mask0(lpart +
    2 blam - coef K blam) + inj[s] at the receiver points; u_prev =
    mask0(2 B - A - coef K B) + coef wchunk[s] at src; with ``ring`` every
    node strictly outside [rA..rB] x [cA..cB] zeroed, then cols cA, cB and
    rows rA, rB restored from ring_cols[s] / ring_rows[s]; wbar[j] -=
    coef blam * B[I + OFFSETS[j]] (in place); (A, B, lam, lpart) <-
    (B, u_prev, lam', -blam (damped: -dnum blam)). Returns (A, B, lam,
    lpart, wbar, wavbar (k,))."""
    damped = planes.shape[0] == 9
    sr, sc = int(src[0]), int(src[1])
    pr, pc = points[0].long(), points[1].long()
    pinned = pinned_mask(u_cur.shape, u_cur.device)
    a, b, lpart = u_next, u_cur, lam_partial
    wavbar = []
    for s in range(wchunk.shape[0]):
        wavbar.append(coef * lam[sr, sc])
        blam = torch.where(pinned, 0.0, planes[7] * lam if damped else lam)
        s_b = _shifts(b)
        k_blam = varcoef_stencil(blam, planes)
        k_b = varcoef_stencil(b, planes, s_b)
        lam_new = torch.where(pinned, 0.0, lpart + 2.0 * blam - coef * k_blam)
        lam_new.index_put_((pr, pc), inj[s], accumulate=True)
        u_prev = _add_at(torch.where(pinned, 0.0, 2.0 * b - a - coef * k_b),
                         sr, sc, wchunk[s] * coef)
        if ring is not None:
            ra, rb, ca, cb = ring
            gr = torch.arange(b.shape[0], device=b.device)[:, None]
            gc = torch.arange(b.shape[1], device=b.device)[None, :]
            u_prev = torch.where((gr < ra) | (gr > rb) | (gc < ca)
                                 | (gc > cb), 0.0, u_prev)
            u_prev[:, ca] = ring_cols[s, :, 0]
            u_prev[:, cb] = ring_cols[s, :, 1]
            u_prev[ra] = ring_rows[s, 0]
            u_prev[rb] = ring_rows[s, 1]
        wbar.sub_((coef * blam)[None] * s_b)
        a, b, lam, lpart = (b, u_prev, lam_new,
                            -(planes[8] * blam) if damped else -blam)
    return a, b, lam, lpart, wbar, torch.stack(wavbar)


def varcoef_adjoint_multistep(u_next: torch.Tensor, u_cur: torch.Tensor,
                              lam: torch.Tensor, lam_partial: torch.Tensor,
                              planes: torch.Tensor, wbar: torch.Tensor,
                              wchunk: torch.Tensor, inj: torch.Tensor, src,
                              coef: float, points,
                              ring: Optional[Tuple[int, int, int, int]] = None,
                              ring_rows: Optional[torch.Tensor] = None,
                              ring_cols: Optional[torch.Tensor] = None):
    """``len(wchunk)`` fused backward steps (replaces
    ``varcoef_adjoint_multistep_pallas``), in fused_chunks(k) launches
    (looped here: a B17 launch takes longer than the host needs to issue
    the next). ``inj``: (k, P) pre-weighted receiver cotangents at
    ``points`` = (rows, cols) (P,) int32; ``wchunk``, ``inj``,
    ``ring_rows`` (k, 2, W) and ``ring_cols`` (k, H, 2) are in the
    kernel's time-descending step order. ``wbar`` is
    updated in place. Returns (u_next', u_cur', lam', lam_partial', wbar,
    wavbar (k,)) as the plain version does."""
    name = "varcoef_adjoint_multistep"
    k = int(wchunk.numel())
    rows, cols = points
    extra = () if ring is None else (ring_rows, ring_cols)
    _check(name, u_next, u_cur, lam, lam_partial, planes, wbar,
           other=(wchunk, inj, *extra))
    n_planes = _n_planes(name, planes, (7, 9))
    _n_planes(name, wbar, (7,))
    _check_points(name, u_next, rows, cols)
    if wchunk.dim() != 1 or k < 1 or tuple(inj.shape) != (k, rows.numel()):
        raise ValueError(f"{name}: wchunk must be (k,) and inj (k, P)")
    if ring is not None and (tuple(ring_rows.shape) != (k, 2, u_next.shape[1])
                             or tuple(ring_cols.shape)
                             != (k, u_next.shape[0], 2)):
        raise ValueError(f"{name}: ring saves must be (k, 2, W) and "
                         "(k, H, 2)")
    sr, sc = _src(name, u_next, src)
    ra, rb, ca, cb = _ring_args(name, u_next, ring)
    if u_next.device.type == "cpu":
        return varcoef_adjoint_multistep_reference(
            u_next, u_cur, lam, lam_partial, planes, wbar, wchunk, inj,
            (sr, sc), coef, points, ring, ring_rows, ring_cols)
    lib = _lib()
    max_smem = _max_smem(lib, name, u_next.device)
    h, w = u_next.shape
    fields = (u_next, u_cur, lam, lam_partial)
    wavbar = torch.empty(k, dtype=u_next.dtype, device=u_next.device)
    s0 = 0
    for kc in fused_chunks(k):
        # steps s0 .. s0 + kc - 1; wbar accumulates in place across launches
        per_step = (wchunk, inj, wavbar, ring_rows, ring_cols)
        if kc < k:
            per_step = tuple(None if t is None else t[s0:s0 + kc]
                             for t in per_step)
        w_c, inj_c, wavbar_c, rows_c, cols_c = per_step
        tile = adjoint_tile(kc, n_planes, u_next.dtype, max_smem)
        outs = [torch.empty_like(u_next) for _ in range(4)]
        with torch.cuda.device(u_next.device):
            rc = lib.tw_varcoef_adjoint_multistep(
                _DTYPES[u_next.dtype], *(_ptr(f) for f in fields),
                _ptr(planes), n_planes, _ptr(wbar), _ptr(w_c), _ptr(inj_c),
                kc, sr, sc, _ptr(rows), _ptr(cols), rows.numel(), ra, rb,
                ca, cb, None if ring is None else _ptr(rows_c),
                None if ring is None else _ptr(cols_c),
                *(_ptr(o) for o in outs), _ptr(wavbar_c), h, w, float(coef),
                tile, _stream(u_next))
        _raise_on(rc, name)
        LAUNCHES[name] += 1
        fields, s0 = outs, s0 + kc
    return (*fields, wbar, wavbar)
