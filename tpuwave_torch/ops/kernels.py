"""The hand-written CUDA stencil kernels and their plain PyTorch versions.

Counterpart of tpuwave/ops/pallas_kernels.py for the structured-P1 wave
step and its implicit solvers. Each public function is a wrapper: on a
CUDA tensor it launches its kernel from ``csrc/stencil_kernels.cu`` (B1-B3,
B6), ``csrc/solver_kernels.cu`` (B4, B5) or ``csrc/fast_kernels.cu`` (B7-B10),
built by ``ops/_build.py``, or raises; on a CPU tensor it runs the ``*_reference`` plain version, which
the kernel is held against. Every tensor is the grid at its TRUE shape
(ny+1, nx+1): no padding, no block-size rule. Squared norms come back as
0-d tensors of the grid's dtype on its device, reduced without atomics.

A node is pinned (Dirichlet) when its global row is <= 0 or >= n_rows - 1,
or its column is <= 0 or >= n_cols - 1; ``n_rows`` / ``n_cols`` are the
grid's own unless a block of a larger grid is stepped (B2's
``row_offset``, B3's ``row_offset`` and ``col_offset``).

``LAUNCHES`` counts kernel launches per wrapper (only real CUDA launches,
never the plain path), so a run can show it went through the kernels; it
also counts the P2 kernels of ``ops/kernels_p2.py`` (B11-B13) and the FWI
kernels of ``ops/kernels_varcoef.py`` (B14-B17).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from tpuwave_torch.ops.stencil import apply_stencil, apply_stencil_diff

__all__ = ["LAUNCHES", "reset_launches", "pinned_mask",
           "constrained_stencil_apply", "constrained_stencil_apply_reference",
           "leapfrog_step", "leapfrog_step_reference",
           "leapfrog_multistep", "leapfrog_multistep_reference",
           "MULTISTEP_MAX_DEPTH", "MultistepGeometry", "multistep_slab",
           "multistep_geometry", "leapfrog_multistep_driven",
           "leapfrog_multistep_driven_reference",
           "cheby_block", "cheby_block_reference",
           "cheby_tile", "MAX_CHEBY_DEGREE", "recurrence_r0",
           "recurrence_r0_reference", "newmark_rhs_r0",
           "newmark_rhs_r0_reference", "newmark_update",
           "newmark_update_reference", "theta_r0u", "theta_r0u_reference",
           "theta_r0v", "theta_r0v_reference"]

#: kernel launches per wrapper since the last reset_launches()
LAUNCHES = {"constrained_stencil_apply": 0, "leapfrog_step": 0,
            "leapfrog_multistep": 0, "leapfrog_multistep_driven": 0,
            "cheby_block": 0, "recurrence_r0": 0,
            "newmark_rhs_r0": 0, "newmark_update": 0, "theta_r0u": 0,
            "theta_r0v": 0,
            "p2_constrained_apply": 0, "p2_presmooth": 0,
            "p2_postsmooth": 0, "varcoef_leapfrog_step": 0,
            "varcoef_leapfrog_multistep": 0, "varcoef_adjoint_step": 0,
            "varcoef_adjoint_multistep": 0}

_DTYPES = {torch.float32: 0, torch.float64: 1}
_TILES = (64, 32, 16)
#: highest block degree kernel B4 takes (csrc/solver_kernels.cu kMaxCoeffs)
MAX_CHEBY_DEGREE = 32


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -- checks and marshalling -------------------------------------------------
def _check(name: str, *tensors: torch.Tensor) -> None:
    ref = tensors[0]
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected tensors, got {type(t)}")
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name}: unsupported device {t.device}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name}: dtype {t.dtype} (float32 | float64)")
        if t.dim() != 2:
            raise ValueError(f"{name}: expected a 2-D grid, got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor is not contiguous")
        if (t.device, t.dtype, t.shape) != (ref.device, ref.dtype,
                                             ref.shape):
            raise ValueError(f"{name}: operands differ in device, dtype or "
                             "shape")
    if ref.numel() >= 2 ** 31:
        raise ValueError(f"{name}: grid of {ref.numel()} nodes exceeds the "
                         "kernels' 32-bit indexing")


def _stencil_arg(stencil):
    flat = [float(c) for row in stencil for c in row]
    if len(flat) != 9:
        raise ValueError("stencil must be 3x3")
    return (ctypes.c_double * 9)(*flat)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError {rc}")


def _lib():
    from tpuwave_torch.ops._build import load_library
    return load_library()


@functools.lru_cache(maxsize=None)
def _grid_size(entry: str, device: int, dtype: torch.dtype, h: int,
               w: int) -> int:
    """What the C function ``entry`` sizes a kernel's grid by on an h x w
    grid on card ``device`` (B9's blocks, B16's band rows: one wave of
    resident blocks, csrc/grid_common.cuh resident_blocks); cached per
    card, dtype and shape."""
    n = getattr(_lib(), entry)(_DTYPES[dtype], h, w)
    if n < 1:
        raise RuntimeError(f"{entry}: cannot size the grid (cudaError "
                           f"{-n})")
    return n


def _max_smem(lib, name: str, device: torch.device) -> int:
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    max_smem = lib.tw_max_dynamic_smem(index)
    if max_smem <= 0:
        raise RuntimeError(f"{name}: cannot read the card's shared-memory "
                           "limit")
    return max_smem


def _largest_tile(name: str, slab_bytes, max_smem: int,
                  tiles=_TILES) -> int:
    """Largest tile side in ``tiles`` whose shared-memory slabs
    (``slab_bytes(tile)`` bytes) fit ``max_smem``; raises when none
    does."""
    for tile in tiles:
        if slab_bytes(tile) <= max_smem:
            return tile
    raise ValueError(
        f"{name} needs {slab_bytes(tiles[-1])} B of shared memory even at "
        f"the smallest tile; the card allows {max_smem} B")


def _dot(a: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), a.reshape(-1))


# -- masks ---------------------------------------------------------------
def pinned_mask(shape, device, *, row_offset: int = 0, col_offset: int = 0,
                n_rows=None, n_cols=None) -> torch.Tensor:
    """(H, W) bool: Dirichlet nodes (global row <= 0 or >= n_rows - 1,
    global column <= 0 or >= n_cols - 1), for a block of a larger grid
    whose node (row_offset, col_offset) is the block's (0, 0)."""
    h, w = shape
    n_rows = h if n_rows is None else n_rows
    n_cols = w if n_cols is None else n_cols
    gr = row_offset + torch.arange(h, device=device)[:, None]
    gc = col_offset + torch.arange(w, device=device)[None, :]
    return (gr <= 0) | (gr >= n_rows - 1) | (gc <= 0) | (gc >= n_cols - 1)


# -- B3: constrained stencil apply -------------------------------------------
def constrained_stencil_apply_reference(x, stencil, diag, diff=False, *,
                                        row_offset: int = 0,
                                        col_offset: int = 0, n_rows=None,
                                        n_cols=None):
    """Interior: S(x masked to 0 on pinned nodes); pinned: diag * x (raw).
    ``diff=True``: sum_{d != 0} s_d (xm_d - xm_c), the zero-row-sum
    difference form. With offsets the walls are those of the larger grid
    (see :func:`constrained_stencil_apply`)."""
    pinned = pinned_mask(x.shape, x.device, row_offset=row_offset,
                         col_offset=col_offset, n_rows=n_rows, n_cols=n_cols)
    a = torch.where(pinned, 0.0, x)
    s = apply_stencil_diff(a, stencil) if diff else apply_stencil(a, stencil)
    return torch.where(pinned, diag * x, s)


def constrained_stencil_apply(x: torch.Tensor, stencil, diag: float,
                              diff: bool = False, *, row_offset: int = 0,
                              col_offset: int = 0, n_rows=None,
                              n_cols=None) -> torch.Tensor:
    """The constrained operator of the implicit solves (the CG matvec).

    Replaces tpuwave's ``constrained_stencil_apply_pallas``: same algebra
    on the true (H, W) grid. ``row_offset`` / ``col_offset`` / ``n_rows`` /
    ``n_cols``: the tensor is a block of an (n_rows, n_cols) grid whose
    node (row_offset, col_offset) is its (0, 0) (a rank's halo-padded
    block), and the Dirichlet walls are that grid's; only outputs whose
    3 x 3 neighbourhood lies in the block are exact there."""
    _check("constrained_stencil_apply", x)
    h, w = x.shape
    n_rows = h if n_rows is None else int(n_rows)
    n_cols = w if n_cols is None else int(n_cols)
    if x.device.type == "cpu":
        return constrained_stencil_apply_reference(
            x, stencil, diag, diff, row_offset=row_offset,
            col_offset=col_offset, n_rows=n_rows, n_cols=n_cols)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _lib().tw_constrained_apply_at(
            _DTYPES[x.dtype], _ptr(x), _ptr(out), h, w,
            _stencil_arg(stencil), float(diag), int(bool(diff)),
            int(row_offset), int(col_offset), n_rows, n_cols, _stream(x))
    _raise_on(rc, "constrained_stencil_apply")
    LAUNCHES["constrained_stencil_apply"] += 1
    return out


# -- B1: one leapfrog step ---------------------------------------------------
def leapfrog_step_reference(u, u_prev, stencil, coef):
    """u' = 2u - u_prev - coef * S(u), pinned nodes set to 0."""
    un = 2.0 * u - u_prev - coef * apply_stencil(u, stencil)
    return torch.where(pinned_mask(u.shape, u.device), 0.0, un)


def leapfrog_step(u: torch.Tensor, u_prev: torch.Tensor, stencil,
                  coef: float) -> torch.Tensor:
    """One lumped leapfrog step (replaces ``leapfrog_step_pallas``);
    ``coef`` = dt^2 / detJ."""
    _check("leapfrog_step", u, u_prev)
    if u.device.type == "cpu":
        return leapfrog_step_reference(u, u_prev, stencil, coef)
    out = torch.empty_like(u)
    h, w = u.shape
    with torch.cuda.device(u.device):
        rc = _lib().tw_leapfrog_step(
            _DTYPES[u.dtype], _ptr(u), _ptr(u_prev), _ptr(out), h, w,
            _stencil_arg(stencil), float(coef), _stream(u))
    _raise_on(rc, "leapfrog_step")
    LAUNCHES["leapfrog_step"] += 1
    return out


# -- B2: n_steps leapfrog steps in one pass ----------------------------------
def leapfrog_multistep_reference(u, u_prev, stencil, coef, n_steps: int,
                                 row_offset: int = 0, n_rows=None):
    """``n_steps`` leapfrog steps with the mask re-applied at every step.

    Nodes outside the array start at 0 and are stepped too unless pinned
    (what a row block of a taller grid sees at its edges): the grid is
    extended by ``n_steps`` zero rows above and below, the domain of
    dependence of ``n_steps`` steps, and sliced back. Columns 0 and W - 1
    are pinned, so the column wrap of ``torch.roll`` reaches no stepped
    node. Returns (u, u_prev) after the last step.
    """
    h, w = u.shape
    k = int(n_steps)
    n_rows = h if n_rows is None else n_rows
    pad = (0, 0, k, k)
    cur = torch.nn.functional.pad(u, pad)
    prev = torch.nn.functional.pad(u_prev, pad)
    pinned = pinned_mask(cur.shape, u.device, row_offset=row_offset - k,
                         n_rows=n_rows)
    for _ in range(k):
        nxt = 2.0 * cur - prev - coef * apply_stencil(cur, stencil)
        prev, cur = cur, torch.where(pinned, 0.0, nxt)
    return cur[k:k + h].contiguous(), prev[k:k + h].contiguous()


#: B2's deepest launch per dtype (csrc/stencil_kernels.cu): a pass of k
#: steps is ceil(k / K) launches of depths as even as they can be
MULTISTEP_MAX_DEPTH = {torch.float32: 16, torch.float64: 8}
#: csrc/stencil_kernels.cu's B2 constants: the widest slab, and per dtype
#: the block shape of TW_B2_SHAPES (threads, items per thread, blocks per
#: SM) and the ring rows per level it implies
_B2_MAX_SLAB = 512
_B2_SHAPE = {torch.float32: (512, 3, 1, 8), torch.float64: (512, 2, 1, 8)}


class MultistepGeometry(NamedTuple):
    """The launches of one B2 or B6 pass: the steps of each (``depths``,
    the first the shallowest), and the shared memory of the deepest
    launch's widest slab."""
    depths: tuple
    smem_bytes: int

    @property
    def starts(self) -> tuple:
        """Each launch's first step of the pass (B6 reads its edge tables
        from there)."""
        return tuple(sum(self.depths[:i]) for i in range(len(self.depths)))


def multistep_slab(depth: int, dtype: torch.dtype, max_smem: int) -> int:
    """Widest B2 slab (columns) of a launch of ``depth`` steps, as
    csrc/stencil_kernels.cu b2_slab picks it: a multiple of the 16-byte
    vector's V values, at most ``threads * items / depth`` groups of V and
    512 columns, whose depth + 2 rings fit the shared memory of
    one of the shape's blocks per SM (``max_smem`` / blocks, less 1 KB
    each where they are several) with a tile of at least 2 depth columns,
    else all of ``max_smem`` with a tile of at least one column; 0 where
    none fits."""
    isz = torch.empty((), dtype=dtype).element_size()
    v = 16 // isz
    threads, ipt, minb, ring = _B2_SHAPE[dtype]
    cap = v * min(threads * ipt // depth, _B2_MAX_SLAB // v)
    level = (depth + 2) * ring * isz
    for budget, min_tile in (
            (max_smem // minb - (1024 if minb > 1 else 0), 2 * depth),
            (max_smem, 1)):
        sw = min(cap, (budget // level - 2 * v) // v * v)
        if sw - 2 * depth >= min_tile:
            return sw
    return 0


@functools.lru_cache(maxsize=None)
def multistep_geometry(n_steps: int, dtype: torch.dtype,
                       max_smem: int) -> MultistepGeometry:
    """The launches of a B2 or B6 pass of ``n_steps`` steps: as few
    launches of at most MULTISTEP_MAX_DEPTH[dtype] steps (less where
    ``max_smem`` bytes of shared memory hold no slab that deep) as will
    do, as even as they can be. Raises ValueError where not even one step
    fits."""
    k = int(n_steps)
    if k < 1:
        raise ValueError("n_steps must be >= 1")
    deepest = min(MULTISTEP_MAX_DEPTH[dtype], k)
    while deepest >= 1 and multistep_slab(deepest, dtype, max_smem) <= 0:
        deepest -= 1
    if deepest < 1:
        raise ValueError(f"leapfrog_multistep in {dtype}: no slab fits "
                         f"{max_smem} B of shared memory")
    n = -(-k // deepest)
    depths = tuple((k * (i + 1)) // n - (k * i) // n for i in range(n))
    d = max(depths)
    sw = multistep_slab(d, dtype, max_smem)
    isz = torch.empty((), dtype=dtype).element_size()
    return MultistepGeometry(
        depths, (d + 2) * _B2_SHAPE[dtype][3] * (sw + 32 // isz) * isz)


def leapfrog_multistep(u: torch.Tensor, u_prev: torch.Tensor, stencil,
                       coef: float, n_steps: int, row_offset: int = 0,
                       n_rows=None):
    """``n_steps`` fused leapfrog steps (replaces
    ``leapfrog_multistep_pallas``), in ``len(multistep_geometry(...).depths)``
    kernel launches from one C call. Returns (u, u_prev).

    ``row_offset``: global row of the tensor's row 0, for a row block of a
    taller grid whose height is ``n_rows`` (default: the tensor's own)."""
    _check("leapfrog_multistep", u, u_prev)
    k = int(n_steps)
    if k < 1:
        raise ValueError("n_steps must be >= 1")
    if u.device.type == "cpu":
        return leapfrog_multistep_reference(u, u_prev, stencil, coef, k,
                                            row_offset, n_rows)
    lib = _lib()
    geo = multistep_geometry(k, u.dtype,
                             _max_smem(lib, "leapfrog_multistep", u.device))
    n = len(geo.depths)
    h, w = u.shape
    out_u = torch.empty_like(u)
    out_up = torch.empty_like(u)
    # the state between launches: the rows a single pass still steps
    scratch = (torch.empty((2 * min(n - 1, 2), h + 2 * (k - geo.depths[0]),
                            w), dtype=u.dtype, device=u.device)
               if n > 1 else None)
    with torch.cuda.device(u.device):
        rc = lib.tw_leapfrog_multistep(
            _DTYPES[u.dtype], _ptr(u), _ptr(u_prev), _ptr(out_u),
            _ptr(out_up), None if scratch is None else _ptr(scratch), h, w,
            _stencil_arg(stencil), float(coef), k, -(-k // n),
            int(row_offset), int(h if n_rows is None else n_rows),
            _stream(u))
    _raise_on(rc, "leapfrog_multistep")
    LAUNCHES["leapfrog_multistep"] += n
    return out_u, out_up


# -- B6: n_steps driven leapfrog steps in one pass ---------------------------
def leapfrog_multistep_driven_reference(u, u_prev, gtb, glr, stencil,
                                        coef, n_steps: int):
    """``n_steps`` leapfrog steps on the full grid; after substep s the
    Dirichlet nodes take that substep's data, overlaid in tpuwave's order
    (left ``glr[s, :, 0]``, right ``glr[s, :, 1]``, bottom ``gtb[s, 0]``,
    top ``gtb[s, 1]``: the rows win at the corners). Returns (u, u_prev)
    after the last step."""
    h, w = u.shape
    cur, prev = u, u_prev
    for s in range(int(n_steps)):
        nxt = 2.0 * cur - prev - coef * apply_stencil(cur, stencil)
        nxt[:, 0] = glr[s, :, 0]
        nxt[:, w - 1] = glr[s, :, 1]
        nxt[0, :] = gtb[s, 0]
        nxt[h - 1, :] = gtb[s, 1]
        prev, cur = cur, nxt
    return cur, prev


def _check_edges(name: str, u: torch.Tensor, gtb: torch.Tensor,
                 glr: torch.Tensor, n_steps: int) -> None:
    h, w = u.shape
    for t, want in ((gtb, (n_steps, 2, w)), (glr, (n_steps, h, 2))):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected tensors, got {type(t)}")
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: edge table of shape {tuple(t.shape)}, "
                             f"expected {want}")
        if (t.device, t.dtype) != (u.device, u.dtype):
            raise ValueError(f"{name}: edge tables differ from the state in "
                             "device or dtype")
        if not t.is_contiguous():
            raise ValueError(f"{name}: edge table is not contiguous")


def leapfrog_multistep_driven(u: torch.Tensor, u_prev: torch.Tensor,
                              gtb: torch.Tensor, glr: torch.Tensor, stencil,
                              coef: float, n_steps: int):
    """``n_steps`` fused driven leapfrog steps (replaces
    ``leapfrog_multistep_driven_pallas``) on B2's wavefront, in
    ``len(multistep_geometry(...).depths)`` kernel launches from one C
    call; launch i steps the pass's steps ``starts[i]`` onwards and reads
    its edge tables from there. ``gtb`` (n_steps, 2, W) holds each
    substep's bottom and top rows, ``glr`` (n_steps, H, 2) its left and
    right columns, in the state's dtype. Returns (u, u_prev)."""
    _check("leapfrog_multistep_driven", u, u_prev)
    k = int(n_steps)
    if k < 1:
        raise ValueError("n_steps must be >= 1")
    _check_edges("leapfrog_multistep_driven", u, gtb, glr, k)
    if u.device.type == "cpu":
        return leapfrog_multistep_driven_reference(u, u_prev, gtb, glr,
                                                   stencil, coef, k)
    lib = _lib()
    geo = multistep_geometry(k, u.dtype, _max_smem(
        lib, "leapfrog_multistep_driven", u.device))
    n = len(geo.depths)
    h, w = u.shape
    out_u = torch.empty_like(u)
    out_up = torch.empty_like(u)
    # the state between launches: H x W pairs (rows outside the array
    # are 0 at every substep)
    scratch = (torch.empty((2 * min(n - 1, 2), h, w), dtype=u.dtype,
                           device=u.device) if n > 1 else None)
    with torch.cuda.device(u.device):
        rc = lib.tw_leapfrog_multistep_driven(
            _DTYPES[u.dtype], _ptr(u), _ptr(u_prev), _ptr(gtb), _ptr(glr),
            _ptr(out_u), _ptr(out_up),
            None if scratch is None else _ptr(scratch), h, w,
            _stencil_arg(stencil), float(coef), k, -(-k // n), _stream(u))
    _raise_on(rc, "leapfrog_multistep_driven")
    LAUNCHES["leapfrog_multistep_driven"] += n
    return out_u, out_up


# -- B4: one restarted Chebyshev block ---------------------------------------
def cheby_block_reference(x, r, stencil, theta: float, coeffs):
    """One restarted Chebyshev block of degree 1 + len(coeffs) on the
    constrained system: r masked to 0 on pinned nodes, d = r / theta,
    x += d, r = masked(r - S d), then d = c1 d + c2 r, x += d,
    r = masked(r - S d) per coefficient pair; x None: a zero initial guess.
    Returns (x, r, ||r||^2)."""
    pinned = pinned_mask(r.shape, r.device)
    r = torch.where(pinned, 0.0, r)
    d = (1.0 / theta) * r
    x = d if x is None else x + d
    r = torch.where(pinned, 0.0, r - apply_stencil(d, stencil))
    for c1, c2 in coeffs:
        d = c1 * d + c2 * r
        x = x + d
        r = torch.where(pinned, 0.0, r - apply_stencil(d, stencil))
    return x, r, _dot(r)


#: B4's register kernels (csrc/solver_kernels.cu ChebyGeometry): 64-column
#: slabs of (rows up to degree _CHEBY_SMALL_DEGREE, rows up to
#: _CHEBY_REG_MAX_DEGREE) per dtype; the tile is the slab less a ``degree``
#: halo on each side. Higher degrees take the shared-memory kernel's square
#: tiles.
_CHEBY_SLAB_COLS = 64
_CHEBY_SLAB_ROWS = {torch.float32: (64, 64), torch.float64: (32, 64)}
_CHEBY_SMALL_DEGREE, _CHEBY_REG_MAX_DEGREE = 2, 16


@functools.lru_cache(maxsize=None)
def cheby_tile(degree: int, dtype: torch.dtype, max_smem: int) -> tuple:
    """(rows, cols) of the tile of one B4 block: the register kernel's slab
    less a ``degree`` halo on each side (its d slabs, double buffered,
    must fit ``max_smem``), or above degree 16 the largest square tile
    whose r and d slabs, (tile + 2 degree)^2 each, and x tile fit."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    if degree <= _CHEBY_REG_MAX_DEGREE:
        rows = _CHEBY_SLAB_ROWS[dtype][degree > _CHEBY_SMALL_DEGREE]
        cols = _CHEBY_SLAB_COLS
        smem = 2 * (rows * cols + 2 * (cols + 1)) * itemsize
        if smem > max_smem:
            raise ValueError(f"cheby_block: degree {degree} in {dtype} needs "
                             f"{smem} B of shared memory; the card allows "
                             f"{max_smem} B")
        return rows - 2 * degree, cols - 2 * degree
    tile = _largest_tile(
        f"cheby_block: degree {degree} in {dtype}",
        lambda t: (2 * (t + 2 * degree) ** 2 + t * t) * itemsize, max_smem)
    return tile, tile


#: per (device, stream): the one-int ticket of B4's, B5's and B9's
#: last-block reductions, 0 between calls (the kernel's last block resets
#: it); kernels on one stream run in turn, so they share it
_TICKETS = {}


def _ticket(device: torch.device, stream: int) -> torch.Tensor:
    key = (device, stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _TICKETS[key]


def cheby_block(x, r: torch.Tensor, stencil, theta: float, coeffs):
    """One restarted Chebyshev block in one kernel launch (replaces
    ``cheby_block_pallas``), ||r||^2 included. ``x`` None: a zero initial
    guess, which the kernel does not read (the V-cycle's pre-smoothing).
    ``theta`` / ``coeffs`` come from
    ``solve/cheby_iter.py::chebyshev_coefficients``. Returns
    ``(x_new, r_new, rr)``, rr = ||r_new||^2 as a 0-d tensor of the
    inputs' dtype on their device."""
    _check("cheby_block", r, *(() if x is None else (x,)))
    coeffs = [(float(c1), float(c2)) for c1, c2 in coeffs]
    degree = 1 + len(coeffs)
    if degree > MAX_CHEBY_DEGREE:
        raise ValueError(f"cheby_block: degree {degree} exceeds "
                         f"{MAX_CHEBY_DEGREE}")
    if r.device.type == "cpu":
        return cheby_block_reference(x, r, stencil, theta, coeffs)
    lib = _lib()
    tile_r, tile_c = cheby_tile(degree, r.dtype,
                                _max_smem(lib, "cheby_block", r.device))
    h, w = r.shape
    n_blocks = -(-h // tile_r) * -(-w // tile_c)
    out_x, out_r = torch.empty_like(r), torch.empty_like(r)
    # the blocks' partials, then ||r||^2
    partials = torch.empty(n_blocks + 1, dtype=r.dtype, device=r.device)
    n = max(len(coeffs), 1)
    c1 = (ctypes.c_double * n)(*(c for c, _ in coeffs))
    c2 = (ctypes.c_double * n)(*(c for _, c in coeffs))
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with torch.cuda.device(r.device):
        rc = lib.tw_cheby_block(
            _DTYPES[r.dtype], None if x is None else _ptr(x), _ptr(r),
            _ptr(out_x), _ptr(out_r), _ptr(partials), n_blocks,
            _ptr(_ticket(r.device, stream)),
            ctypes.c_void_p(partials.data_ptr()
                            + n_blocks * partials.element_size()),
            h, w, _stencil_arg(stencil), 1.0 / float(theta), c1, c2,
            len(coeffs), tile_r, tile_c, ctypes.c_void_p(stream))
    _raise_on(rc, "cheby_block")
    LAUNCHES["cheby_block"] += 1
    return out_x, out_r, partials[n_blocks]


# -- B5: the fused 2-term step setup -------------------------------------------
def recurrence_r0_reference(u, u_prev, k_stencil, c_u: float, c_up: float,
                            mask_combo: bool = True):
    """x0 = masked(2u - u_prev); r0 = masked(DiffStencil(k_stencil, combo)),
    combo = c_u u + c_up u_prev (pinned values zeroed when
    ``mask_combo``). Returns (r0, x0, ||r0||^2, ||x0||^2)."""
    pinned = pinned_mask(u.shape, u.device)
    combo = c_u * u + c_up * u_prev
    if mask_combo:
        combo = torch.where(pinned, 0.0, combo)
    r0 = torch.where(pinned, 0.0, apply_stencil_diff(combo, k_stencil))
    x0 = torch.where(pinned, 0.0, 2.0 * u - u_prev)
    return r0, x0, _dot(r0), _dot(x0)


def recurrence_r0(u: torch.Tensor, u_prev: torch.Tensor, k_stencil,
                  c_u: float, c_up: float, mask_combo: bool = True):
    """The setup of one displacement-recurrence step in one kernel launch
    (replaces ``recurrence_r0_pallas``), both squared norms included (the
    last block, by B4's ticket). ``k_stencil`` carries the -dt^2 scale and
    is evaluated in difference form. Returns ``(r0, x0, rr0, xx0)`` with
    the squared norms as 0-d tensors."""
    _check("recurrence_r0", u, u_prev)
    if u.device.type == "cpu":
        return recurrence_r0_reference(u, u_prev, k_stencil, c_u, c_up,
                                       mask_combo)
    lib = _lib()
    h, w = u.shape
    n = 2 * lib.tw_recurrence_r0_blocks(h, w)
    r0, x0 = torch.empty_like(u), torch.empty_like(u)
    # the blocks' partials of ||r0||^2, then of ||x0||^2, then the norms
    partials = torch.empty(n + 2, dtype=u.dtype, device=u.device)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    with torch.cuda.device(u.device):
        rc = lib.tw_recurrence_r0(
            _DTYPES[u.dtype], _ptr(u), _ptr(u_prev), _ptr(r0), _ptr(x0),
            _ptr(partials), n, _ptr(_ticket(u.device, stream)),
            ctypes.c_void_p(partials.data_ptr()
                            + n * partials.element_size()),
            h, w, _stencil_arg(k_stencil), float(c_u), float(c_up),
            int(bool(mask_combo)), ctypes.c_void_p(stream))
    _raise_on(rc, "recurrence_r0")
    LAUNCHES["recurrence_r0"] += 1
    return r0, x0, partials[n], partials[n + 1]


# -- B7-B10: the fused setups and update of the implicit FastWaveSolver steps
def _masked(pinned, x):
    return torch.where(pinned, 0.0, x)


def _three_norms(lib, ref: torch.Tensor):
    """(partials, norms) buffers of the two-launch setup kernels B7 and
    B10."""
    n_blocks = lib.tw_fast_blocks(*ref.shape)
    partials = torch.empty(3 * n_blocks, dtype=ref.dtype, device=ref.device)
    norms = torch.empty(3, dtype=ref.dtype, device=ref.device)
    return partials, norms


def newmark_rhs_r0_reference(u, v, a, k_stencil, a_stencil, c_zv: float,
                             c_za: float):
    """z = masked(u + c_zv v + c_za a); rhs = masked(-K z); x0 = masked(a);
    r0 = rhs - masked(A x0). Returns (r0, z, ||r0||^2, ||rhs||^2,
    ||x0||^2)."""
    pinned = pinned_mask(u.shape, u.device)
    z = _masked(pinned, u + c_zv * v + c_za * a)
    x0 = _masked(pinned, a)
    rhs = _masked(pinned, -apply_stencil(z, k_stencil))
    r0 = rhs - _masked(pinned, apply_stencil(x0, a_stencil))
    return r0, z, _dot(r0), _dot(rhs), _dot(x0)


def newmark_rhs_r0(u: torch.Tensor, v: torch.Tensor, a: torch.Tensor,
                   k_stencil, a_stencil, c_zv: float, c_za: float):
    """The setup of one implicit Newmark a-solve in one kernel pass
    (replaces ``newmark_rhs_r0_pallas``): the caller solves A e = r0 from
    e = 0 and sets a' = masked(a) + e. ``k_stencil`` is the stiffness,
    ``a_stencil`` the system M + beta dt^2 K, ``c_zv`` = dt, ``c_za`` =
    dt^2 (1/2 - beta). Returns ``(r0, z, rr0, bb, xx0)``, the squared
    norms of r0, rhs and x0 = masked(a) as 0-d tensors; z comes back with
    pinned nodes set to 0."""
    _check("newmark_rhs_r0", u, v, a)
    if u.device.type == "cpu":
        return newmark_rhs_r0_reference(u, v, a, k_stencil, a_stencil, c_zv,
                                        c_za)
    lib = _lib()
    h, w = u.shape
    r0, z = torch.empty_like(u), torch.empty_like(u)
    partials, norms = _three_norms(lib, u)
    with torch.cuda.device(u.device):
        rc = lib.tw_newmark_rhs_r0(
            _DTYPES[u.dtype], _ptr(u), _ptr(v), _ptr(a), _ptr(r0), _ptr(z),
            _ptr(partials), partials.numel(), _ptr(norms), h, w,
            _stencil_arg(k_stencil), _stencil_arg(a_stencil), float(c_zv),
            float(c_za), _stream(u))
    _raise_on(rc, "newmark_rhs_r0")
    LAUNCHES["newmark_rhs_r0"] += 1
    return r0, z, norms[0], norms[1], norms[2]


def newmark_update_reference(z, v, a, e, c_ua: float, c_va: float,
                             c_van: float):
    """a' = masked(a) + e; u' = z + c_ua a'; v' = v + c_va a + c_van a'
    (the raw a in v'). Returns (u', v', a')."""
    a_new = _masked(pinned_mask(a.shape, a.device), a) + e
    return z + c_ua * a_new, v + c_va * a + c_van * a_new, a_new


def newmark_update(z: torch.Tensor, v: torch.Tensor, a: torch.Tensor,
                   e: torch.Tensor, c_ua: float, c_va: float, c_van: float):
    """The Newmark state update in one elementwise kernel pass (replaces
    ``newmark_update_pallas``): ``c_ua`` = beta dt^2, ``c_va`` =
    dt (1 - gamma), ``c_van`` = dt gamma. Returns ``(u', v', a')``."""
    _check("newmark_update", z, v, a, e)
    if z.device.type == "cpu":
        return newmark_update_reference(z, v, a, e, c_ua, c_va, c_van)
    h, w = z.shape
    out_u, out_v, out_a = (torch.empty_like(z) for _ in range(3))
    with torch.cuda.device(z.device):
        rc = _lib().tw_newmark_update(
            _DTYPES[z.dtype], _ptr(z), _ptr(v), _ptr(a), _ptr(e),
            _ptr(out_u), _ptr(out_v), _ptr(out_a), h, w, float(c_ua),
            float(c_va), float(c_van), _stream(z))
    _raise_on(rc, "newmark_update")
    LAUNCHES["newmark_update"] += 1
    return out_u, out_v, out_a


def theta_r0u_reference(u, v, m_stencil, k_stencil, c_comb: float,
                        c_r0k: float, c_mv: float):
    """On masked u, v: r0 = masked(c_r0k K u + c_mv M v); rhs =
    masked(M u + c_comb K u + c_mv M v), reduced only. Returns
    (r0, ||r0||^2, ||rhs||^2, ||masked u||^2)."""
    pinned = pinned_mask(u.shape, u.device)
    um, vm = _masked(pinned, u), _masked(pinned, v)
    ku, mu = apply_stencil(um, k_stencil), apply_stencil(um, m_stencil)
    mv = apply_stencil(vm, m_stencil)
    r0 = _masked(pinned, c_r0k * ku + c_mv * mv)
    rhs = _masked(pinned, mu + c_comb * ku + c_mv * mv)
    return r0, _dot(r0), _dot(rhs), _dot(um)


def theta_r0u(u: torch.Tensor, v: torch.Tensor, m_stencil, k_stencil,
              c_comb: float, c_r0k: float, c_mv: float):
    """The setup of one theta u-solve in one kernel pass (replaces
    ``theta_r0u_pallas``): with the warm start x0 = masked(u) the M u
    terms of rhs - A x0 cancel, so r0 = masked(c_r0k K u + c_mv M v) with
    ``c_r0k`` = -dt^2 theta, ``c_mv`` = dt; ``c_comb`` = -dt^2 theta
    (1 - theta) enters only ||rhs||^2. The caller solves A e = r0 from
    e = 0. Returns ``(r0, rr0, bb, xx0)``."""
    _check("theta_r0u", u, v)
    if u.device.type == "cpu":
        return theta_r0u_reference(u, v, m_stencil, k_stencil, c_comb, c_r0k,
                                   c_mv)
    lib = _lib()
    h, w = u.shape
    with torch.cuda.device(u.device):
        n_blocks = _grid_size("tw_theta_r0u_blocks",
                              torch.cuda.current_device(), u.dtype, h, w)
        r0 = torch.empty_like(u)
        # the blocks' partials of the three norms, then the norms
        n = 3 * n_blocks
        partials = torch.empty(n + 3, dtype=u.dtype, device=u.device)
        stream = torch.cuda.current_stream(u.device).cuda_stream
        rc = lib.tw_theta_r0u(
            _DTYPES[u.dtype], _ptr(u), _ptr(v), _ptr(r0), _ptr(partials), n,
            _ptr(_ticket(u.device, stream)),
            ctypes.c_void_p(partials.data_ptr()
                            + n * partials.element_size()),
            h, w, n_blocks, _stencil_arg(m_stencil), _stencil_arg(k_stencil),
            float(c_comb), float(c_r0k), float(c_mv), ctypes.c_void_p(stream))
    _raise_on(rc, "theta_r0u")
    LAUNCHES["theta_r0u"] += 1
    return r0, partials[n], partials[n + 1], partials[n + 2]


def theta_r0v_reference(u, e, v, m_stencil, k_stencil, c_ku: float,
                        c_kun: float):
    """u' = masked(u) + masked(e); r0 = masked(c_ku K u + c_kun K u');
    rhs = masked(M v + c_ku K u + c_kun K u'), reduced only. Returns
    (u', r0, ||r0||^2, ||rhs||^2, ||masked v||^2)."""
    pinned = pinned_mask(u.shape, u.device)
    um, vm = _masked(pinned, u), _masked(pinned, v)
    un = um + _masked(pinned, e)
    ku, kun = apply_stencil(um, k_stencil), apply_stencil(un, k_stencil)
    mv = apply_stencil(vm, m_stencil)
    r0 = _masked(pinned, c_ku * ku + c_kun * kun)
    rhs = _masked(pinned, mv + c_ku * ku + c_kun * kun)
    return un, r0, _dot(r0), _dot(rhs), _dot(vm)


def theta_r0v(u: torch.Tensor, e: torch.Tensor, v: torch.Tensor, m_stencil,
              k_stencil, c_ku: float, c_kun: float):
    """The theta u update and the setup of the v-solve in one kernel pass
    (replaces ``theta_r0v_pallas``): u' = masked(u) + masked(e) with e the
    u-solve's correction; with the warm start x0 = masked(v) the M v terms
    cancel, so r0 = masked(c_ku K u + c_kun K u'), ``c_ku`` =
    -dt (1 - theta), ``c_kun`` = -dt theta. The caller solves M e_v = r0
    from e_v = 0 and sets v' = masked(v) + e_v. Returns
    ``(u', r0, rr0, bb, xx0)``."""
    _check("theta_r0v", u, e, v)
    if u.device.type == "cpu":
        return theta_r0v_reference(u, e, v, m_stencil, k_stencil, c_ku,
                                   c_kun)
    lib = _lib()
    h, w = u.shape
    un, r0 = torch.empty_like(u), torch.empty_like(u)
    partials, norms = _three_norms(lib, u)
    with torch.cuda.device(u.device):
        rc = lib.tw_theta_r0v(
            _DTYPES[u.dtype], _ptr(u), _ptr(e), _ptr(v), _ptr(un), _ptr(r0),
            _ptr(partials), partials.numel(), _ptr(norms), h, w,
            _stencil_arg(m_stencil), _stencil_arg(k_stencil), float(c_ku),
            float(c_kun), _stream(u))
    _raise_on(rc, "theta_r0v")
    LAUNCHES["theta_r0v"] += 1
    return un, r0, norms[0], norms[1], norms[2]
