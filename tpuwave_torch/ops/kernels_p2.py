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
target plane in that order. The plain versions are built on
``stencil_p2.apply_terms`` and on ``solve/multigrid.py``'s
``_smooth_block_jacobi``. Launches are counted in ``ops.kernels.LAUNCHES``
(only real CUDA launches).
"""

from __future__ import annotations

import ctypes
import torch

from tpuwave_torch.ops.kernels import (_DTYPES, LAUNCHES, _largest_tile,
                                       _lib, _max_smem, _ptr, _raise_on,
                                       _stream)
from tpuwave_torch.ops.stencil_p2 import apply_terms

__all__ = ["p2_canvas_interior", "MAX_TERMS",
           "MAX_SMOOTH_DEGREE", "p2_constrained_apply",
           "p2_constrained_apply_reference", "p2_presmooth",
           "p2_presmooth_reference", "p2_postsmooth",
           "p2_postsmooth_reference", "p2_smooth_tile"]

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


def _terms_arg(name: str, coeffs):
    """ctypes arrays (target, source, ox, oy, c) of the block-stencil."""
    if len(coeffs) > MAX_TERMS:
        raise ValueError(f"{name}: {len(coeffs)} block-stencil terms exceed "
                         f"the kernels' limit of {MAX_TERMS}")
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
    where(interior, A x, 0)). Replaces ``p2_constrained_apply_pallas``."""
    _check("p2_constrained_apply", nx, ny, xc)
    terms = _terms_arg("p2_constrained_apply", coeffs)
    diag = _four(diags)
    if xc.device.type == "cpu":
        return p2_constrained_apply_reference(xc, coeffs, diags, nx, ny,
                                              mask_input)
    out = torch.empty_like(xc)
    _, hc, wc = xc.shape
    with torch.cuda.device(xc.device):
        rc = _lib().tw_p2_apply(
            _DTYPES[xc.dtype], _ptr(xc), _ptr(out), hc, wc, nx, ny, *terms,
            diag, int(bool(mask_input)), _stream(xc))
    _raise_on(rc, "p2_constrained_apply")
    LAUNCHES["p2_constrained_apply"] += 1
    return out


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


def p2_smooth_tile(degree: int, dtype: torch.dtype, max_smem: int) -> int:
    """Largest tile side whose r and d slabs of the four planes,
    (tile + 2 degree)^2 each, the four x tiles and the staged terms fit
    ``max_smem`` bytes of shared memory (the smem_bytes of
    csrc/p2_kernels.cu)."""
    isz = torch.empty((), dtype=dtype).element_size()
    return _largest_tile(
        f"p2 smoothing: degree {degree} in {dtype}",
        lambda t: (4 * (2 * (t + 2 * degree) ** 2 + t * t) * isz
                   + MAX_TERMS * (isz + 4) + 32), max_smem)


def _smooth_launch(name, post, rin, xin, corr, coeffs, inv_diags, theta,
                   sm_coeffs, nx, ny):
    sm = [(float(a), float(b)) for a, b in sm_coeffs]
    lib = _lib()
    tile = p2_smooth_tile(1 + len(sm), rin.dtype,
                          _max_smem(lib, name, rin.device))
    terms = _terms_arg(name, coeffs)
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
            *terms, _four(inv_diags), 1.0 / float(theta), c1, c2, len(sm),
            tile, _stream(rin))
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out_x if post else (out_x, out_r)


def _check_degree(name, sm_coeffs):
    if 1 + len(sm_coeffs) > MAX_SMOOTH_DEGREE:
        raise ValueError(f"{name}: degree {1 + len(sm_coeffs)} exceeds "
                         f"{MAX_SMOOTH_DEGREE}")


def p2_presmooth(b: torch.Tensor, coeffs, inv_diags, theta: float,
                 sm_coeffs, nx: int, ny: int):
    """Pre-smoothing block in one kernel pass: b -> (x, r) (replaces
    ``p2_presmooth_pallas``). ``b`` must be supported on the interior (the
    canvas-CG residual invariant); ``theta`` / ``sm_coeffs`` are the
    smoother's Chebyshev schedule on the D^{-1}A spectrum."""
    _check("p2_presmooth", nx, ny, b)
    _check_degree("p2_presmooth", sm_coeffs)
    if b.device.type == "cpu":
        return p2_presmooth_reference(b, coeffs, inv_diags, theta,
                                      sm_coeffs, nx, ny)
    return _smooth_launch("p2_presmooth", False, b, None, None, coeffs,
                          inv_diags, theta, sm_coeffs, nx, ny)


def p2_postsmooth(x: torch.Tensor, r: torch.Tensor, corr: torch.Tensor,
                  coeffs, inv_diags, theta: float, sm_coeffs, nx: int,
                  ny: int) -> torch.Tensor:
    """The V-cycle tail in one kernel pass: x_out = postsmooth(x + corr,
    r - A corr), corr masked to the interior in the kernel (replaces
    ``p2_postsmooth_pallas``)."""
    _check("p2_postsmooth", nx, ny, x, r, corr)
    _check_degree("p2_postsmooth", sm_coeffs)
    if x.device.type == "cpu":
        return p2_postsmooth_reference(x, r, corr, coeffs, inv_diags, theta,
                                       sm_coeffs, nx, ny)
    return _smooth_launch("p2_postsmooth", True, r, x, corr, coeffs,
                          inv_diags, theta, sm_coeffs, nx, ny)
