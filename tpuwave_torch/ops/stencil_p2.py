"""P2 plane-stencil operators: the structured fast path for quadratics.

Counterpart of tpuwave's ops/stencil_p2.py. On the structured
triangulated rectangle the P2 DoFs split into FOUR
translation-invariant sub-grids ("planes"):

    V: vertices                  (ny+1, nx+1)
    H: horizontal-edge midpoints (ny+1, nx)
    W: vertical-edge midpoints   (ny,   nx+1)
    D: diagonal-edge midpoints   (ny,   nx)

and for constant wave speed both M and K are CONSTANT block-stencils
between planes: y_p[n] = sum_{q, off} C[p,q,off] * x_q[n + off] with
offsets in {-1, 0, 1}^2 (:class:`P2PlaneStencil`); a spatially varying or
time-dependent c makes K a variable-coefficient operator
(:class:`P2VarcoefStencil`). Each plane is embedded at (1, 1) in a common
zero-padded (ny+3, nx+3) canvas, so the cross-plane shifts are uniform and
``torch.roll`` wraparound lands only in the canvas halo ring, outside every
plane's support. The canvas is the true (ny+3, nx+3): no row or column
multiple (tpuwave's Mosaic alignment) is needed on the card.

The flat DoF ordering (core/mesh.py: vertices, then h/v/d edge blocks,
each row-major) makes flat <-> planes a reshape/concat. These are the
plain PyTorch forms; the CUDA kernels of ``ops/kernels_p2.py`` apply the
same constant block-stencil. The varcoef operator, and its optional
constant part (``P2PlaneStencil.axpy_varcoef``), are torch ops (tpuwave
runs no fused kernel on them either).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from tpuwave_torch.config import resolve_device
from tpuwave_torch.core.mesh import FeSpace
from tpuwave_torch.ops.stencil import P1_CLASS_CORNERS

__all__ = ["P2PlaneStencil", "p2_plane_shapes", "flat_to_planes",
           "planes_to_flat", "canvas_shape", "planes_to_canvases",
           "canvases_to_planes", "coeffs_to_static", "apply_terms",
           "p2_varcoef_data", "p2_varcoef_scales", "P2VarcoefStencil"]

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

    def axpy_varcoef(self, coef: float,
                     other: "P2VarcoefStencil") -> "P2VarcoefStencil":
        """M + coef * K(t) with K a varcoef stencil: a varcoef operator
        whose constant part is this stencil."""
        return other.with_constant_part(self, coef)


# ---------------------------------------------------------------------------
# variable-coefficient P2 operator (time / space-dependent wave speed)
# ---------------------------------------------------------------------------

def p2_varcoef_data(space: FeSpace, quad):
    """Host constants for the varcoef P2 stiffness on the structured grid.

    Returns ``(G, frac, w, det)``: per-class per-quad gradient products
    G[k, q, i, j] = grad phi_i(q) . grad phi_j(q) (physical), fractional
    quadrature offsets frac[k, q, 2] within the unit grid cell, quadrature
    weights w[q], and the constant |det J|. The element matrix at time t is
    K_e = det * sum_q w_q c^2(x_eq, t) G[k, q]: unlike P1, G is
    q-DEPENDENT for quadratics, so the scales are kept per (k, q).
    """
    sh = space.shape_at(quad)
    grads = np.asarray(space.physical_grads(sh))        # (2, Q, 6, 2)
    G = np.einsum("kqia,kqja->kqij", grads, grads)      # (2, Q, 6, 6)
    ref = np.asarray(quad.points)                       # (Q, 2)
    frac = np.empty((2, len(ref), 2))
    for k in range(2):
        c0, c1, c2_ = (np.asarray(c, float) for c in P1_CLASS_CORNERS[k])
        frac[k] = (c0[None]
                   + ref[:, 0:1] * (c1 - c0)[None]
                   + ref[:, 1:2] * (c2_ - c0)[None])
    return G, frac, np.asarray(quad.weights), float(space.mesh.det_j)


def p2_varcoef_scales(mesh, c, t, frac, w, det, dtype,
                      device) -> torch.Tensor:
    """(2, Q, ny, nx) scale planes det * w_q * c^2(x_ekq, t) of the varcoef
    P2 stiffness: ``c`` is the wave-speed expression, ``frac``, ``w`` and
    ``det`` come from :func:`p2_varcoef_data`."""
    ny, nx = mesh.ny, mesh.nx
    (x0, y0) = mesh.origin
    hx, hy = mesh.hx, mesh.hy
    ix = torch.arange(nx, dtype=dtype, device=device)[None, :].expand(ny, nx)
    iy = torch.arange(ny, dtype=dtype, device=device)[:, None].expand(ny, nx)
    rows = []
    for k in range(2):
        qrows = []
        for q in range(frac.shape[1]):
            fx, fy = float(frac[k, q, 0]), float(frac[k, q, 1])
            c2 = c.evaluate(x0 + (ix + fx) * hx, y0 + (iy + fy) * hy,
                            t).to(dtype) ** 2
            qrows.append((det * float(w[q]))
                         * torch.broadcast_to(c2, (ny, nx)))
        rows.append(torch.stack(qrows))
    return torch.stack(rows)


class P2VarcoefStencil:
    """Variable-coefficient P2 stiffness, plus an optional constant part.

    ``scales``: (2, Q, ny, nx) per-class / per-quad-point planes
    det * w_q * c^2(x_ekq, t) (:func:`p2_varcoef_scales`). Every
    element-matrix entry (k, i, j) couples fixed plane positions, scaled by
    its own (ny, nx) coefficient plane sum_q G[k, q, i, j] * scales[k, q].
    tpuwave sums those planes inside every apply, where XLA fuses them; in
    eager torch that is over a thousand launches a matvec, so here the (at
    most 72) planes are built ONCE per operator, in tpuwave's order of
    summation over q and times ``var_coef``, and an apply is one
    ``addcmul_`` per plane on canvas slices, in tpuwave's (k, i, j) order.
    Memory: 72 planes of (ny, nx), ~0.6 GB at 1024^2 in f64.

    ``const_op`` (a :class:`P2PlaneStencil`) adds ``const_coef`` times its
    apply and its diagonal: ``M.axpy_varcoef(coef, K)`` is the system
    M + coef K(t) of P2FastSolver's time-dependent step, with
    ``var_coef = coef`` (:meth:`with_constant_part`).
    """

    def __init__(self, space: FeSpace, scales: torch.Tensor, G, dtype,
                 const_op: "P2PlaneStencil" = None, const_coef: float = 1.0,
                 var_coef: float = 1.0):
        self.nx, self.ny = space.mesh.nx, space.mesh.ny
        self.dtype = dtype
        self.n_dofs = space.n_dofs
        self.scales = scales                  # (2, Q, ny, nx)
        self.G = np.asarray(G)                # (2, Q, 6, 6) host constants
        self.const_op = const_op
        self.const_coef = float(const_coef)
        self.var_coef = float(var_coef)
        #: {(k, i, j): sum_q G[k, q, i, j] * scales[k, q]}, nonzero only
        self._sums = self._coeff_sums()
        self.planes = self._scaled(self._sums)

    def with_constant_part(self, const_op: "P2PlaneStencil",
                           var_coef: float) -> "P2VarcoefStencil":
        """const_op + var_coef * (this operator's varcoef part), sharing
        its scale and coefficient planes."""
        out = object.__new__(P2VarcoefStencil)
        out.nx, out.ny = self.nx, self.ny
        out.dtype = self.dtype
        out.n_dofs = self.n_dofs
        out.scales = self.scales
        out.G = self.G
        out.const_op = const_op
        out.const_coef = 1.0
        out.var_coef = float(var_coef)
        out._sums = self._sums
        out.planes = out._scaled(self._sums)
        return out

    def _scaled(self, sums):
        """The coefficient planes times ``var_coef`` (tpuwave's
        ``(vc * cp)``, formed once)."""
        if self.var_coef == 1.0:
            return sums
        return {k: self.var_coef * cp for k, cp in sums.items()}

    def _coeff_sums(self):
        """sum_q scales[k, q] * G[k, q, i, j] -> (ny, nx) for every (k, i,
        j) with a nonzero G (tpuwave's ``_coeff_plane``)."""
        sums = {}
        for k in range(2):
            for i in range(6):
                for j in range(6):
                    acc = None
                    for q in range(self.G.shape[1]):
                        g = float(self.G[k, q, i, j])
                        if g == 0.0:
                            continue
                        term = g * self.scales[k, q]
                        acc = term if acc is None else acc + term
                    if acc is not None:
                        sums[(k, i, j)] = acc
        return sums

    def _canvas_shape(self):
        return (self.ny + 3, self.nx + 3)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        cs = self._canvas_shape()
        xc = planes_to_canvases(flat_to_planes(x, self.nx, self.ny), cs)
        y = planes_to_flat(canvases_to_planes(self._var_apply(xc), self.nx,
                                              self.ny))
        if self.const_op is not None:
            y = y + self.const_coef * self.const_op(x)
        return y

    def apply_canvases(self, xc: torch.Tensor) -> torch.Tensor:
        """Apply on stacked common canvases (4, Hc, Wc) (plane order V, H,
        W, D, each embedded at (1, 1)): every plane's output window +=
        coefficient plane * the source window. The caller guarantees zeros
        outside each plane's support; every slice window stays inside the
        canvas for any Hc >= ny + 3, Wc >= nx + 3."""
        y = self._var_apply(xc)
        if self.const_op is not None:
            y = y + self.const_coef * self.const_op.apply_canvases(xc)
        return y

    def _var_apply(self, xc: torch.Tensor) -> torch.Tensor:
        """The varcoef part's apply on canvases (see ``apply_canvases``)."""
        out = torch.zeros_like(xc)
        ny, nx = self.ny, self.nx
        for (k, i, j), cp in self.planes.items():
            pa, (xa, ya) = _P2_POSITIONS[k][i]
            pb, (xb, yb) = _P2_POSITIONS[k][j]
            out[_PLANE_INDEX[pa], 1 + ya:1 + ya + ny,
                1 + xa:1 + xa + nx].addcmul_(
                cp, xc[_PLANE_INDEX[pb], 1 + yb:1 + yb + ny,
                       1 + xb:1 + xb + nx])
        return out

    def diagonal_canvases(self, cshape) -> torch.Tensor:
        """(4, Hc, Wc) EXACT assembled diagonal on the common canvases
        (support entries only; zero on padding: callers pin the padding to
        a harmless 1.0 themselves). Canvas twin of :meth:`diagonal`."""
        diag = self._var_diagonal(cshape)
        if self.const_op is not None:
            # the constant part on each plane's support only, so the
            # padding stays exactly zero
            hc, wc = cshape
            ri = torch.arange(hc, device=diag.device)[:, None]
            ci = torch.arange(wc, device=diag.device)[None, :]
            shapes = p2_plane_shapes(self.nx, self.ny)
            supp = torch.stack([(ri >= 1) & (ri < 1 + shapes[p][0])
                                & (ci >= 1) & (ci < 1 + shapes[p][1])
                                for p in _PLANES])
            cd = torch.tensor([self.const_op.plane_diag[p] for p in _PLANES],
                              dtype=diag.dtype,
                              device=diag.device).reshape(4, 1, 1)
            diag = diag + torch.where(supp, self.const_coef * cd, 0.0)
        return diag

    def _var_diagonal(self, cshape) -> torch.Tensor:
        """The varcoef part's assembled diagonal on canvases."""
        ny, nx = self.ny, self.nx
        diag = self.scales.new_zeros((4, *cshape))
        for k in range(2):
            for i in range(6):
                cp = self.planes.get((k, i, i))
                if cp is None:
                    continue
                pa, (xa, ya) = _P2_POSITIONS[k][i]
                diag[_PLANE_INDEX[pa], 1 + ya:1 + ya + ny,
                     1 + xa:1 + xa + nx] += cp
        return diag

    def diagonal(self) -> torch.Tensor:
        """Flat EXACT assembled diagonal (the varcoef diagonal varies per
        node, so it is assembled instead of broadcast)."""
        d = planes_to_flat(canvases_to_planes(
            self._var_diagonal(self._canvas_shape()), self.nx, self.ny))
        if self.const_op is not None:
            d = d + self.const_coef * self.const_op.diagonal()
        return d
