"""The hand-written CUDA kernels of the P2 canvas engine and their plain
PyTorch versions.

Counterpart of tpuwave/ops/pallas_p2.py. Each public function is a
wrapper: on a CUDA tensor it launches its kernel from
``csrc/p2_kernels.cu`` (B11-B13), built by ``ops/_build.py``, or raises; on
a CPU tensor it runs the ``*_reference`` plain version, which the kernel is
held against. Every tensor is a (4, Hc, Wc) canvas stack, plane order V, H,
W, D, each plane embedded at (1, 1), at its true shape (Hc >= ny + 3,
Wc >= nx + 3; the engine's canvases are exactly (ny+3, nx+3)).

The block-stencil is given as ``coeffs``, the tuple of
``stencil_p2.coeffs_to_static`` (``P2PlaneStencil.terms``: terms (target
plane, source plane, ox, oy, c), sorted), and its terms are summed per
target plane in that order. B11 takes any such list: one that fits the
fixed 46-term pattern of the P2 mass, stiffness and system stencils
(``SMOOTH_PATTERN``, compiled into the kernels) runs B11's pattern kernel,
any other its general kernel (``p2_apply_route``, by the terms alone). B12
and B13 take only the pattern and raise ValueError for a term outside it
or out of its order, on either device. Their kernel
(``p2_smooth_geometry``) is chosen by the smoothing degree alone: up to
degree 8 the register kernel, above it the shared-slab kernel. The plain
versions are built on
``stencil_p2.apply_terms`` and on ``solve/multigrid.py``'s
``_smooth_block_jacobi``. Launches are counted in ``ops.kernels.LAUNCHES``
(only real CUDA launches).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from tpuwave_torch.ops.kernels import (_DTYPES, LAUNCHES, _largest_tile,
                                       _lib, _max_smem, _ptr, _raise_on,
                                       _stream)
from tpuwave_torch.ops.stencil_p2 import apply_terms

__all__ = ["p2_canvas_interior", "MAX_TERMS",
           "MAX_SMOOTH_DEGREE", "p2_constrained_apply",
           "p2_constrained_apply_reference", "p2_presmooth",
           "p2_presmooth_reference", "p2_postsmooth",
           "p2_postsmooth_reference", "SMOOTH_PATTERN", "smooth_slots",
           "SmoothGeometry", "SMOOTH_REG_MAX_DEGREE", "p2_smooth_geometry",
           "p2_apply_route", "ApplyGeometry", "p2_apply_geometry"]

#: most block-stencil terms the kernels take (csrc/p2_kernels.cu kMaxTerms)
MAX_TERMS = 64
#: highest smoothing degree (1 + coefficient pairs) B12/B13 take
MAX_SMOOTH_DEGREE = 32

def p2_canvas_interior(nx: int, ny: int, cshape, device) -> torch.Tensor:
    """(4, Hc, Wc) bool, True at interior (free) DoFs: canvas rows
    2..ny (V, H) or 1..ny (W, D), columns 2..nx (V, W) or 1..nx (H, D)."""
    hc, wc = cshape
    ri = torch.arange(hc, device=device)[:, None]
    ci = torch.arange(wc, device=device)[None, :]
    masks = []
    for row_lo, col_lo in ((2, 2), (2, 1), (1, 2), (1, 1)):
        masks.append((ri >= row_lo) & (ri <= ny) & (ci >= col_lo)
                     & (ci <= nx))
    return torch.stack(masks)


# -- checks and marshalling -------------------------------------------------
def _check(name: str, nx: int, ny: int, *tensors: torch.Tensor) -> None:
    ref = tensors[0]
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected tensors, got {type(t)}")
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name}: unsupported device {t.device}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name}: dtype {t.dtype} (float32 | float64)")
        if t.dim() != 3 or t.shape[0] != 4:
            raise ValueError(f"{name}: expected a (4, Hc, Wc) canvas stack, "
                             f"got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor is not contiguous")
        if (t.device, t.dtype, t.shape) != (ref.device, ref.dtype,
                                             ref.shape):
            raise ValueError(f"{name}: operands differ in device, dtype or "
                             "shape")
    if ref.shape[1] < ny + 3 or ref.shape[2] < nx + 3:
        raise ValueError(f"{name}: canvas {tuple(ref.shape[1:])} smaller "
                         f"than (ny + 3, nx + 3) = ({ny + 3}, {nx + 3})")
    if ref.numel() >= 2 ** 31:
        raise ValueError(f"{name}: stack of {ref.numel()} values exceeds "
                         "the kernels' 32-bit indexing")


def _terms_arg(coeffs):
    """ctypes arrays (target, source, ox, oy, c) of the block-stencil."""
    n = max(len(coeffs), 1)
    cols = list(zip(*coeffs)) if coeffs else [()] * 5
    ints = [(ctypes.c_int * n)(*(int(v) for v in col)) for col in cols[:4]]
    return (*ints, (ctypes.c_double * n)(*(float(v) for v in cols[4])),
            len(coeffs))


def _four(vals) -> ctypes.Array:
    vals = [float(v) for v in vals]
    if len(vals) != 4:
        raise ValueError("expected one value per plane (V, H, W, D)")
    return (ctypes.c_double * 4)(*vals)


# -- B11: the constrained block-stencil apply ---------------------------------
def p2_constrained_apply_reference(xc, coeffs, diags, nx: int, ny: int,
                                   mask_input: bool = True):
    """Interior: A(x masked to the interior, or raw when ``mask_input`` is
    False); elsewhere diags_p * x."""
    interior = p2_canvas_interior(nx, ny, xc.shape[1:], xc.device)
    xin = torch.where(interior, xc, 0.0) if mask_input else xc
    diag = torch.tensor([float(d) for d in diags], dtype=xc.dtype,
                        device=xc.device).reshape(4, 1, 1)
    return torch.where(interior, apply_terms(xin, coeffs), diag * xc)


def p2_constrained_apply(xc: torch.Tensor, coeffs, diags, nx: int, ny: int,
                         mask_input: bool = True) -> torch.Tensor:
    """The constrained P2 operator on canvases (the CG matvec; with
    ``mask_input=False`` and zero ``diags`` the rhs / lift form
    where(interior, A x, 0)). Replaces ``p2_constrained_apply_pallas``. On
    the card, terms on the fixed pattern run the pattern kernel, others the
    general kernel (``p2_apply_route``)."""
    _check("p2_constrained_apply", nx, ny, xc)
    if len(coeffs) > MAX_TERMS:
        raise ValueError(f"p2_constrained_apply: {len(coeffs)} block-stencil "
                         f"terms exceed the kernels' limit of {MAX_TERMS}")
    diag = _four(diags)
    if xc.device.type == "cpu":
        return p2_constrained_apply_reference(xc, coeffs, diags, nx, ny,
                                              mask_input)
    out = torch.empty_like(xc)
    _, hc, wc = xc.shape
    key = tuple(tuple(t) for t in coeffs)
    with torch.cuda.device(xc.device):
        if p2_apply_route(key) == "pattern":
            geo = p2_apply_geometry(xc.dtype, hc, wc)
            rc = _lib().tw_p2_apply_pattern(
                _DTYPES[xc.dtype], _ptr(xc), _ptr(out), hc, wc, nx, ny,
                _slot_arg(key), diag, int(bool(mask_input)),
                geo.tile_cols, geo.threads_y, geo.rows_per_thread,
                _stream(xc))
        else:
            rc = _lib().tw_p2_apply(
                _DTYPES[xc.dtype], _ptr(xc), _ptr(out), hc, wc, nx, ny,
                *_terms_arg(key), diag,
                int(bool(mask_input)), _stream(xc))
    _raise_on(rc, "p2_constrained_apply")
    LAUNCHES["p2_constrained_apply"] += 1
    return out


@functools.lru_cache(maxsize=64)
def p2_apply_route(coeffs: tuple) -> str:
    """B11's kernel for the terms ``coeffs`` (``coeffs_to_static`` terms,
    as a tuple of tuples): "pattern" where they map onto SMOOTH_PATTERN
    (``smooth_slots``: every stencil the engines build), "general" for
    any other list (a foreign, reordered or repeated term)."""
    try:
        smooth_slots(coeffs)
    except ValueError:
        return "general"
    return "pattern"


@functools.lru_cache(maxsize=64)
def _slot_arg(coeffs: tuple) -> ctypes.Array:
    slots = smooth_slots(coeffs)
    return (ctypes.c_double * len(slots))(*slots)


class ApplyGeometry(NamedTuple):
    """The tile of one B11 pattern-kernel block: tile_cols columns (one
    thread each) by threads_y x rows_per_thread rows."""
    tile_cols: int
    threads_y: int
    rows_per_thread: int


#: B11's pattern-kernel tiles per dtype (csrc/p2_kernels.cu
#: TW_P2_APPLY_GEOMETRIES): (large canvases, canvases of fewer than
#: _APPLY_LARGE_SITES sites a plane)
_APPLY_TILES = {torch.float32: ((128, 2, 8), (32, 8, 2)),
                torch.float64: ((64, 2, 4), (32, 8, 2))}
_APPLY_LARGE_SITES = 1 << 18


def p2_apply_geometry(dtype: torch.dtype, hc: int, wc: int) -> ApplyGeometry:
    """B11's pattern-kernel tile for (hc, wc) canvases of ``dtype``: 128 x
    16 sites (f32) or 64 x 8 (f64) from 2^18 sites a plane, 32 x 16 below
    (more blocks for the card's SMs on the small levels); the shapes that
    scripts/torch_p2_apply_geometry.py timed fastest."""
    large, small = _APPLY_TILES[dtype]
    return ApplyGeometry(*(large if hc * wc >= _APPLY_LARGE_SITES
                           else small))


# -- B12 / B13: the V-cycle smoothing blocks ----------------------------------
def _smoothing_operands(ref, coeffs, inv_diags, nx: int, ny: int):
    """A_I = where(interior, A ., 0) and the (4, 1, 1) inverse plane
    diagonals: the operator and the Jacobi scaling of the smoothing
    blocks on interior-supported canvases."""
    interior = p2_canvas_interior(nx, ny, ref.shape[1:], ref.device)
    inv = torch.tensor([float(v) for v in inv_diags], dtype=ref.dtype,
                       device=ref.device).reshape(4, 1, 1)
    return (lambda d: torch.where(interior, apply_terms(d, coeffs), 0.0),
            inv, interior)


def p2_presmooth_reference(b, coeffs, inv_diags, theta: float, sm_coeffs,
                           nx: int, ny: int):
    """(x, r) of the Jacobi-Chebyshev smoothing block from x = 0 on the
    constrained operator; ``b`` is supported on the interior."""
    from tpuwave_torch.solve.multigrid import _smooth_block_jacobi
    apply_i, inv, _ = _smoothing_operands(b, coeffs, inv_diags, nx, ny)
    return _smooth_block_jacobi(apply_i, inv, torch.zeros_like(b), b, theta,
                                sm_coeffs)


def p2_postsmooth_reference(x, r, corr, coeffs, inv_diags, theta: float,
                            sm_coeffs, nx: int, ny: int):
    """The V-cycle tail: corr masked to the interior, x + corr and
    r - A corr, then the smoothing block; returns x."""
    from tpuwave_torch.solve.multigrid import _smooth_block_jacobi
    apply_i, inv, interior = _smoothing_operands(x, coeffs, inv_diags, nx,
                                                 ny)
    corr = torch.where(interior, corr, 0.0)
    out, _ = _smooth_block_jacobi(apply_i, inv, x + corr, r - apply_i(corr),
                                  theta, sm_coeffs)
    return out


#: B12 / B13's fixed term pattern: the 46 (target plane, source plane, ox,
#: oy) slots of the P2 mass, stiffness and Newmark-system stencils in
#: ``coeffs_to_static`` order (csrc/p2_kernels.cu slot_at)
SMOOTH_PATTERN = (
    (0, 0, -1, -1), (0, 0, -1, 0), (0, 0, 0, -1), (0, 0, 0, 0),
    (0, 0, 0, 1), (0, 0, 1, 0), (0, 0, 1, 1), (0, 1, -1, -1), (0, 1, -1, 0),
    (0, 1, 0, 0), (0, 1, 0, 1), (0, 2, -1, -1), (0, 2, 0, -1), (0, 2, 0, 0),
    (0, 2, 1, 0), (0, 3, -1, -1), (0, 3, -1, 0), (0, 3, 0, -1), (0, 3, 0, 0),
    (1, 0, 0, -1), (1, 0, 0, 0), (1, 0, 1, 0), (1, 0, 1, 1), (1, 1, 0, 0),
    (1, 2, 0, -1), (1, 2, 1, 0), (1, 3, 0, -1), (1, 3, 0, 0), (2, 0, -1, 0),
    (2, 0, 0, 0), (2, 0, 0, 1), (2, 0, 1, 1), (2, 1, -1, 0), (2, 1, 0, 1),
    (2, 2, 0, 0), (2, 3, -1, 0), (2, 3, 0, 0), (3, 0, 0, 0), (3, 0, 0, 1),
    (3, 0, 1, 0), (3, 0, 1, 1), (3, 1, 0, 0), (3, 1, 0, 1), (3, 2, 0, 0),
    (3, 2, 1, 0), (3, 3, 0, 0))
_SLOT = {t: k for k, t in enumerate(SMOOTH_PATTERN)}


@functools.lru_cache(maxsize=64)
def smooth_slots(coeffs: tuple) -> tuple:
    """The coefficients of ``coeffs`` (``coeffs_to_static`` terms) on the
    46 slots of SMOOTH_PATTERN, 0.0 where a term is absent (a stencil that
    dropped an exact zero). Raises ValueError for a term outside the
    pattern or terms out of its order: the kernels sum each plane's terms
    in slot order."""
    out = [0.0] * len(SMOOTH_PATTERN)
    last = -1
    for term in coeffs:
        key = tuple(int(v) for v in term[:4])
        k = _SLOT.get(key)
        if k is None:
            raise ValueError(f"p2 smoothing: term {key} lies outside the "
                             "fixed pattern of the P2 stencils")
        if k <= last:
            raise ValueError(f"p2 smoothing: term {key} is out of "
                             "coeffs_to_static order")
        out[k] = float(term[4])
        last = k
    return tuple(out)


class SmoothGeometry(NamedTuple):
    """The blocks of one B12 / B13 launch. ``threads_y`` > 0: the register
    kernel, slabs of tile_cols + 2 degree columns (one thread each) and
    threads_y x rows_per_thread rows; 0: the shared-slab kernel, square
    tiles."""
    tile_rows: int
    tile_cols: int
    threads_y: int
    rows_per_thread: int
    smem_bytes: int


#: the register kernel's slab (columns, threads in y, rows per thread) per
#: dtype, one of csrc/p2_kernels.cu's TW_P2_SMOOTH_GEOMETRIES, and the
#: highest degree it takes (kRegMaxDegree)
_SMOOTH_REG_SLAB = {torch.float32: (64, 4, 8), torch.float64: (32, 8, 4)}
SMOOTH_REG_MAX_DEGREE = 8


@functools.lru_cache(maxsize=None)
def p2_smooth_geometry(degree: int, dtype: torch.dtype,
                       max_smem: int) -> SmoothGeometry:
    """Blocks of B12 / B13 at ``degree`` (1 + coefficient pairs, the halo
    of a tile): up to degree 8 the register kernel's slab of the dtype,
    less the halo (its double-buffered d slabs of the four planes and their
    pads must fit ``max_smem`` bytes); above it the shared-slab kernel's
    largest square tile (64, 32, 16) whose r and d slabs of the four
    planes, (tile + 2 degree)^2 each, the four x tiles and the staged terms
    fit. Raises ValueError where none fits."""
    isz = torch.empty((), dtype=dtype).element_size()
    if degree <= SMOOTH_REG_MAX_DEGREE:
        cols, ty, rows = _SMOOTH_REG_SLAB[dtype]
        smem = 2 * (4 * cols * ty * rows + 2 * (cols + 1)) * isz
        if smem > max_smem:
            raise ValueError(f"p2 smoothing: degree {degree} in {dtype} "
                             f"needs {smem} B of shared memory; the card "
                             f"allows {max_smem} B")
        return SmoothGeometry(ty * rows - 2 * degree, cols - 2 * degree, ty,
                              rows, smem)

    def slab_bytes(t):
        return (4 * (2 * (t + 2 * degree) ** 2 + t * t) * isz
                + MAX_TERMS * (isz + 4) + 32)
    tile = _largest_tile(f"p2 smoothing: degree {degree} in {dtype}",
                         slab_bytes, max_smem)
    return SmoothGeometry(tile, tile, 0, 0, slab_bytes(tile))


def _smooth_launch(name, post, rin, xin, corr, slots, inv_diags, theta,
                   sm, nx, ny):
    lib = _lib()
    geo = p2_smooth_geometry(1 + len(sm), rin.dtype,
                             _max_smem(lib, name, rin.device))
    n = max(len(sm), 1)
    c1 = (ctypes.c_double * n)(*(a for a, _ in sm))
    c2 = (ctypes.c_double * n)(*(b for _, b in sm))
    out_x = torch.empty_like(rin)
    out_r = None if post else torch.empty_like(rin)
    _, hc, wc = rin.shape
    null = ctypes.c_void_p(None)
    with torch.cuda.device(rin.device):
        rc = lib.tw_p2_smooth(
            _DTYPES[rin.dtype], int(post), _ptr(rin),
            _ptr(xin) if post else null, _ptr(corr) if post else null,
            _ptr(out_x), null if post else _ptr(out_r), hc, wc, nx, ny,
            (ctypes.c_double * len(slots))(*slots), _four(inv_diags),
            1.0 / float(theta), c1, c2, len(sm), geo.tile_rows,
            geo.tile_cols, geo.threads_y, geo.rows_per_thread, _stream(rin))
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out_x if post else (out_x, out_r)


def _smooth_args(name, coeffs, sm_coeffs):
    """(slot coefficients, coefficient pairs) of a smoothing call; raises
    for a degree above MAX_SMOOTH_DEGREE or terms off the fixed pattern."""
    if 1 + len(sm_coeffs) > MAX_SMOOTH_DEGREE:
        raise ValueError(f"{name}: degree {1 + len(sm_coeffs)} exceeds "
                         f"{MAX_SMOOTH_DEGREE}")
    slots = smooth_slots(tuple(tuple(t) for t in coeffs))
    return slots, [(float(a), float(b)) for a, b in sm_coeffs]


def p2_presmooth(b: torch.Tensor, coeffs, inv_diags, theta: float,
                 sm_coeffs, nx: int, ny: int):
    """Pre-smoothing block in one kernel pass: b -> (x, r) (replaces
    ``p2_presmooth_pallas``). ``b`` must be supported on the interior (the
    canvas-CG residual invariant); ``theta`` / ``sm_coeffs`` are the
    smoother's Chebyshev schedule on the D^{-1}A spectrum; ``coeffs`` must
    fit SMOOTH_PATTERN. On the card the degree alone picks the kernel
    (``p2_smooth_geometry``): the register kernel up to degree 8, the
    shared-slab kernel above."""
    _check("p2_presmooth", nx, ny, b)
    slots, sm = _smooth_args("p2_presmooth", coeffs, sm_coeffs)
    if b.device.type == "cpu":
        return p2_presmooth_reference(b, coeffs, inv_diags, theta,
                                      sm_coeffs, nx, ny)
    return _smooth_launch("p2_presmooth", False, b, None, None, slots,
                          inv_diags, theta, sm, nx, ny)


def p2_postsmooth(x: torch.Tensor, r: torch.Tensor, corr: torch.Tensor,
                  coeffs, inv_diags, theta: float, sm_coeffs, nx: int,
                  ny: int) -> torch.Tensor:
    """The V-cycle tail in one kernel pass: x_out = postsmooth(x + corr,
    r - A corr), corr masked to the interior in the kernel (replaces
    ``p2_postsmooth_pallas``). Same pattern and kernel choice as
    ``p2_presmooth``."""
    _check("p2_postsmooth", nx, ny, x, r, corr)
    slots, sm = _smooth_args("p2_postsmooth", coeffs, sm_coeffs)
    if x.device.type == "cpu":
        return p2_postsmooth_reference(x, r, corr, coeffs, inv_diags, theta,
                                       sm_coeffs, nx, ny)
    return _smooth_launch("p2_postsmooth", True, r, x, corr, slots,
                          inv_diags, theta, sm, nx, ny)
