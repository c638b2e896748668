"""P2 plane-stencil operators: the structured fast path for quadratics.

Counterpart of tpuwave's ops/stencil_p2.py (constant wave speed). On the
structured triangulated rectangle the P2 DoFs split into FOUR
translation-invariant sub-grids ("planes"):

    V: vertices                  (ny+1, nx+1)
    H: horizontal-edge midpoints (ny+1, nx)
    W: vertical-edge midpoints   (ny,   nx+1)
    D: diagonal-edge midpoints   (ny,   nx)

and for constant wave speed both M and K are CONSTANT block-stencils
between planes: y_p[n] = sum_{q, off} C[p,q,off] * x_q[n + off] with
offsets in {-1, 0, 1}^2. Each plane is embedded at (1, 1) in a common
zero-padded (ny+3, nx+3) canvas, so the cross-plane shifts are uniform and
``torch.roll`` wraparound lands only in the canvas halo ring, outside every
plane's support. The canvas is the true (ny+3, nx+3): no row or column
multiple (tpuwave's Mosaic alignment) is needed on the card.

The flat DoF ordering (core/mesh.py: vertices, then h/v/d edge blocks,
each row-major) makes flat <-> planes a reshape/concat. These are the
plain PyTorch forms; the CUDA kernels of ``ops/kernels_p2.py`` apply the
same block-stencil.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from tpuwave_torch.config import resolve_device
from tpuwave_torch.core.mesh import FeSpace

__all__ = ["P2PlaneStencil", "p2_plane_shapes", "flat_to_planes",
           "planes_to_flat", "canvas_shape", "planes_to_canvases",
           "canvases_to_planes", "coeffs_to_static", "apply_terms"]

# local-DoF -> (plane, (di, dj)) cell-relative positions, per element class
# (ordering matches core.mesh.FeSpace.cell_dofs: v0 v1 v2 e01 e12 e20)
_P2_POSITIONS = (
    # lower triangle (v00, v10, v11, h(i,j), v(i+1,j), d(i,j))
    (("V", (0, 0)), ("V", (1, 0)), ("V", (1, 1)),
     ("H", (0, 0)), ("W", (1, 0)), ("D", (0, 0))),
    # upper triangle (v00, v11, v01, d(i,j), h(i,j+1), v(i,j))
    (("V", (0, 0)), ("V", (1, 1)), ("V", (0, 1)),
     ("D", (0, 0)), ("H", (0, 1)), ("W", (0, 0))),
)

_PLANES = ("V", "H", "W", "D")
_PLANE_INDEX = {p: i for i, p in enumerate(_PLANES)}


def p2_plane_shapes(nx: int, ny: int) -> Dict[str, Tuple[int, int]]:
    """(rows, cols) of each plane (rows = y index, cols = x index)."""
    return {"V": (ny + 1, nx + 1), "H": (ny + 1, nx),
            "W": (ny, nx + 1), "D": (ny, nx)}


def flat_to_planes(x: torch.Tensor, nx: int,
                   ny: int) -> Dict[str, torch.Tensor]:
    shapes = p2_plane_shapes(nx, ny)
    out = {}
    off = 0
    for p in _PLANES:
        r, c = shapes[p]
        out[p] = x[off:off + r * c].reshape(r, c)
        off += r * c
    return out


def planes_to_flat(planes: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.cat([planes[p].reshape(-1) for p in _PLANES])


def canvas_shape(nx: int, ny: int) -> Tuple[int, int]:
    """Common zero-padded canvas shape holding any plane at offset (1, 1)."""
    return (ny + 3, nx + 3)


def planes_to_canvases(planes: Dict[str, torch.Tensor],
                       cshape) -> torch.Tensor:
    """(4, Hc, Wc) stack, plane order V,H,W,D, each embedded at (1, 1)."""
    ref = planes["V"]
    out = ref.new_zeros((4, *cshape))
    for i, p in enumerate(_PLANES):
        r, c = planes[p].shape
        out[i, 1:1 + r, 1:1 + c] = planes[p]
    return out


def canvases_to_planes(xc: torch.Tensor, nx: int,
                       ny: int) -> Dict[str, torch.Tensor]:
    shapes = p2_plane_shapes(nx, ny)
    return {p: xc[i, 1:1 + shapes[p][0], 1:1 + shapes[p][1]]
            for i, p in enumerate(_PLANES)}


def _build_coefficients(a_class: np.ndarray) -> Dict[Tuple, float]:
    """(2, 6, 6) per-class element matrices -> {(pa, pb, ox, oy): coeff}.

    coeff is the interior coupling of plane pa's node to plane pb's node
    at cell offset (ox, oy), summed over the incident triangles.
    """
    coeffs: Dict[Tuple, float] = {}
    for k in range(2):
        pos = _P2_POSITIONS[k]
        for i in range(6):
            pa, (xa, ya) = pos[i]
            for j in range(6):
                pb, (xb, yb) = pos[j]
                key = (pa, pb, xb - xa, yb - ya)
                coeffs[key] = coeffs.get(key, 0.0) + float(a_class[k, i, j])
    return {k: v for k, v in coeffs.items() if v != 0.0}


def coeffs_to_static(coeffs: Dict[Tuple, float]) -> Tuple:
    """{(pa, pb, ox, oy): c} -> sorted ((ia, ib, ox, oy, c), ...): the
    term list of the kernels of ops/kernels_p2.py, in their order."""
    return tuple(sorted((_PLANE_INDEX[pa], _PLANE_INDEX[pb], ox, oy, float(c))
                        for (pa, pb, ox, oy), c in coeffs.items()))


def apply_terms(xc: torch.Tensor, terms) -> torch.Tensor:
    """The block-stencil ``terms`` (``coeffs_to_static``) on stacked
    canvases (4, Hc, Wc), plane order V,H,W,D: per target plane the sum of
    c * x_src shifted by (ox, oy) (``torch.roll``), in the order of
    ``terms``.

    The caller guarantees xc is zero outside each plane's support;
    wrapped roll values then only reach non-support cells, which the
    caller masks again."""
    shifted = {}
    outs = [None] * len(_PLANES)
    for ia, ib, ox, oy, c in terms:
        if (ib, ox, oy) not in shifted:
            term = xc[ib]
            if (ox, oy) != (0, 0):
                term = torch.roll(term, shifts=(-oy, -ox), dims=(0, 1))
            shifted[(ib, ox, oy)] = term
        t = c * shifted[(ib, ox, oy)]
        outs[ia] = t if outs[ia] is None else outs[ia] + t
    return torch.stack([o if o is not None else torch.zeros_like(xc[0])
                        for o in outs])


class P2PlaneStencil:
    """Constant block-stencil P2 operator on flat DoF vectors and on
    (4, Hc, Wc) canvas stacks, with tensors of ``dtype`` on ``device``
    (default "cuda", which raises where there is no card)."""

    def __init__(self, space: FeSpace, a_class: np.ndarray, dtype,
                 device="cuda"):
        if space.degree != 2:
            raise ValueError("P2PlaneStencil requires a P2 space")
        self.nx, self.ny = space.mesh.nx, space.mesh.ny
        self.shapes = p2_plane_shapes(self.nx, self.ny)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.coeffs = _build_coefficients(np.asarray(a_class))
        self.terms = coeffs_to_static(self.coeffs)
        self.n_dofs = space.n_dofs
        #: interior diagonal per plane (V/H/W/D), for Jacobi/BC pinning
        self.plane_diag = {p: self.coeffs.get((p, p, 0, 0), 1.0)
                           for p in _PLANES}

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        planes = flat_to_planes(x, self.nx, self.ny)
        out = self.apply_canvases(
            planes_to_canvases(planes, canvas_shape(self.nx, self.ny)))
        return planes_to_flat(canvases_to_planes(out, self.nx, self.ny))

    def diagonal(self) -> torch.Tensor:
        """Flat diagonal using the constant interior values per plane
        (boundary rows differ but are only used for BC pinning, where any
        nonzero diagonal is exact — same convention as the P1 stencil)."""
        parts = []
        for p in _PLANES:
            r, c = self.shapes[p]
            parts.append(torch.full((r * c,), self.plane_diag[p],
                                    dtype=self.dtype, device=self.device))
        return torch.cat(parts)

    def apply_canvases(self, xc: torch.Tensor) -> torch.Tensor:
        """Apply on stacked canvases (4, Hc, Wc) (see ``apply_terms``)."""
        return apply_terms(xc, self.terms)

    def axpy(self, coef: float, other: "P2PlaneStencil") -> "P2PlaneStencil":
        merged = object.__new__(P2PlaneStencil)
        merged.nx, merged.ny = self.nx, self.ny
        merged.shapes = self.shapes
        merged.dtype = self.dtype
        merged.device = self.device
        merged.n_dofs = self.n_dofs
        keys = set(self.coeffs) | set(other.coeffs)
        merged.coeffs = {k: self.coeffs.get(k, 0.0)
                         + coef * other.coeffs.get(k, 0.0) for k in keys}
        merged.terms = coeffs_to_static(merged.coeffs)
        merged.plane_diag = {p: merged.coeffs.get((p, p, 0, 0), 1.0)
                             for p in _PLANES}
        return merged
