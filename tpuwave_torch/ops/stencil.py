"""Grid-stencil operators: the P1 structured-mesh fast path.

On the structured triangulated rectangle, P1 DoFs ARE the vertex grid
(ny+1, nx+1), and for constant wave speed both M and K reduce to CONSTANT
7-point stencils (the diagonal split couples (+1,+1) and (-1,-1) but not
the anti-diagonal). ``s[1 + dj][1 + di]`` couples node (r, c) to node
(r + dj, c + di): rows are y, columns are x.

Boundary-row caveat: the shifted adds wrap cyclically (``torch.roll``
semantics), so ONLY interior rows of the result are exact. Every solver use
masks boundary rows anyway (Dirichlet elimination overrides them).

The variable-coefficient planes (one coefficient grid per neighbour
offset, linear in the per-element c^2) serve the FWI propagator
(``models/inverse.py``).

These are the plain PyTorch forms; the CUDA kernels of ``ops/kernels.py``
and ``ops/kernels_varcoef.py`` are held against them.

Sharded grids (parallel/sharding.py): an operator with a ``layout`` acts
on a rank's block; it exchanges a one-node halo and applies the stencil
to the padded block, and the masks come from global coordinates.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tpuwave_torch.core.mesh import FeSpace

__all__ = [
    "class_matrices_to_stencil",
    "apply_stencil",
    "apply_stencil_diff",
    "lumped_mass_grid",
    "boundary_mask_grid",
    "GridStencilOperator",
    "on_block",
    "constrained_apply_on",
    "P1_CLASS_CORNERS",
    "assemble_varcoef_planes",
    "apply_varcoef_planes",
]

# local DoF -> (di, dj) grid offset from the cell anchor v00, per class
_P1_OFFSETS = (
    ((0, 0), (1, 0), (1, 1)),  # lower triangle (v00, v10, v11)
    ((0, 0), (1, 1), (0, 1)),  # upper triangle (v00, v11, v01)
)

#: corner offsets (x, y) of the two triangle classes per structured grid
#: cell (core/mesh.py::cells: lower (v00, v10, v11), upper (v00, v11, v01))
P1_CLASS_CORNERS = (((0, 0), (1, 0), (1, 1)), ((0, 0), (1, 1), (0, 1)))


def class_matrices_to_stencil(a_class: np.ndarray) -> np.ndarray:
    """(2, 3, 3) per-class element matrices -> (3, 3) stencil coefficients.

    Output s[1 + dj, 1 + di] is the coupling of an INTERIOR node to its
    neighbour at grid offset (di, dj): the sum of A[i, j] over the six
    incident triangles where local i sits on the node and local j on the
    neighbour.
    """
    a = np.asarray(a_class)
    s = np.zeros((3, 3))
    for k in range(2):
        offs = _P1_OFFSETS[k]
        for i in range(3):
            for j in range(3):
                di = offs[j][0] - offs[i][0]
                dj = offs[j][1] - offs[i][1]
                s[1 + dj, 1 + di] += a[k, i, j]
    return s


def apply_stencil(u: torch.Tensor, s) -> torch.Tensor:
    """y[n] = sum_d s[d] * u[n + d] with cyclic wrap (rows: y, cols: x).

    Exact for interior nodes; boundary rows carry wrapped garbage that the
    callers mask. Summation order is tpuwave's (centre, then dj, di in
    -1, 0, 1 order), so f64 results agree to the last bits.
    """
    out = s[1][1] * u
    # dim 0 = y (dj), dim 1 = x (di); u[n + d] = roll(u, -d)
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            if (di, dj) == (0, 0):
                continue
            c = s[1 + dj][1 + di]
            if c == 0.0:
                continue
            out = out + c * torch.roll(u, shifts=(-dj, -di), dims=(0, 1))
    return out


def apply_stencil_diff(u: torch.Tensor, s) -> torch.Tensor:
    """Zero-row-sum stencil in DIFFERENCE form:
    y[n] = sum_{d != 0} s[d] * (u[n + d] - u[n]).

    Algebraically equal to apply_stencil when the stencil rows sum to
    zero (every stiffness stencil: K * const = 0), and numerically quieter
    in f32: each neighbour difference rounds at eps * |u[n+d] - u[n]|
    instead of eps * |u|. Same wrap caveat as apply_stencil.
    """
    out = None
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            if (di, dj) == (0, 0):
                continue
            c = s[1 + dj][1 + di]
            if c == 0.0:
                continue
            shifted = torch.roll(u, shifts=(-dj, -di), dims=(0, 1))
            t = c * (shifted - u)
            out = t if out is None else out + t
    return out if out is not None else torch.zeros_like(u)


def lumped_mass_grid(space: FeSpace) -> np.ndarray:
    """(ny+1, nx+1) row-sum lumped mass, exact INCLUDING boundary rows.

    Each triangle contributes |T|/3 = detJ/6 to each of its vertices, so
    the lumped value is detJ/6 x (#incident triangles): 6 in the interior,
    3 on edges, and 1 or 2 at corners depending on the diagonal direction.
    """
    m = space.mesh
    nx, ny = m.nx, m.ny
    base = m.det_j / 6.0
    plane = np.full((ny + 1, nx + 1), 6.0)
    plane[0, :] = plane[-1, :] = 3.0
    plane[:, 0] = plane[:, -1] = 3.0
    plane[0, 0] = plane[-1, -1] = 2.0   # corners on the diagonal
    plane[0, -1] = plane[-1, 0] = 1.0   # corners off the diagonal
    return base * plane


def boundary_mask_grid(space: FeSpace) -> np.ndarray:
    """(ny+1, nx+1) boolean Dirichlet mask."""
    m = space.mesh
    mask = np.zeros((m.ny + 1, m.nx + 1), dtype=bool)
    mask[0, :] = mask[-1, :] = True
    mask[:, 0] = mask[:, -1] = True
    return mask


def on_block(layout, fn, u: torch.Tensor) -> torch.Tensor:
    """``fn`` (a 3 x 3 stencil pass) on a rank's block of a sharded grid
    (parallel/sharding.py::GridLayout): exchange a one-node halo, apply,
    crop. Every owned output is exact, the global walls included where
    ``fn`` reads no wrapped value (halos beyond the grid are zeros);
    ``layout`` None applies ``fn`` to the whole grid."""
    if layout is None:
        return fn(u)
    return fn(layout.exchange(u, 1))[1:-1, 1:-1]


def constrained_apply_on(layout, x: torch.Tensor, stencil, diag: float,
                         diff: bool = False) -> torch.Tensor:
    """The constrained operator (ops/kernels.py::constrained_stencil_apply,
    kernel B3 on the card) on a rank's block: a one-node halo exchange,
    then B3 on the padded block at its global offsets, so the Dirichlet
    walls are the global grid's; ``layout`` None is the whole grid."""
    from tpuwave_torch.ops import kernels
    if layout is None:
        return kernels.constrained_stencil_apply(x, stencil, diag, diff)
    xp = layout.exchange(x, 1)
    out = kernels.constrained_stencil_apply(
        xp, stencil, diag, diff, row_offset=layout.r0 - 1,
        col_offset=layout.c0 - 1, n_rows=layout.shape[0],
        n_cols=layout.shape[1])
    return out[1:-1, 1:-1]


class GridStencilOperator:
    """Constant-stencil operator acting on (ny+1, nx+1) grid tensors, or,
    with a ``layout``, on a rank's block of one (halo exchange, then the
    local apply: :func:`on_block`).

    ``diag`` is the interior diagonal broadcast everywhere — boundary rows
    are only ever used through Dirichlet elimination, where any nonzero
    diagonal yields x_b = g_b exactly.
    """

    def __init__(self, stencil: np.ndarray, shape: Tuple[int, int],
                 dtype: torch.dtype, device: torch.device, layout=None):
        self.stencil = tuple(tuple(float(c) for c in row)
                             for row in np.asarray(stencil))
        self.shape = shape
        self.dtype = dtype
        self.device = device
        self.layout = layout

    def __call__(self, u):
        if self.layout is None:
            return apply_stencil(u, self.stencil)
        return on_block(self.layout,
                        lambda x: apply_stencil(x, self.stencil), u)

    def diff(self, u):
        """The zero-row-sum difference form (:func:`apply_stencil_diff`)."""
        return on_block(self.layout,
                        lambda x: apply_stencil_diff(x, self.stencil), u)

    def axpy(self, coef: float,
             other: "GridStencilOperator") -> "GridStencilOperator":
        s = np.asarray(self.stencil) + coef * np.asarray(other.stencil)
        return GridStencilOperator(s, self.shape, self.dtype, self.device,
                                   self.layout)


# ---------------------------------------------------------------------------
# variable-coefficient (per-element-scaled) stencil planes
# ---------------------------------------------------------------------------

def assemble_varcoef_planes(s: torch.Tensor, g_class_np, ny: int,
                            nx: int) -> dict:
    """Assembled variable-coefficient 9-point stencil on the vertex grid.

    ``s``: (ny, nx, 2) per-element scales (det_j * sum_q w_q c^2, one per
    triangle class); ``g_class_np``: (2, 3, 3) reference-gradient products
    (q-independent for P1). Returns ``{(dx, dy): w_d}`` planes of shape
    (ny+1, nx+1), on ``s``'s device and dtype, with
    ``y[I] = sum_d w_d[I] * u[I + d]``. Linear (hence differentiable by
    autograd) in ``s``; interior-exact, boundary rows must be masked by
    the caller. The planes come out in tpuwave's insertion order, so
    :func:`apply_varcoef_planes` sums in the same order.
    """
    planes = {}
    for k in range(2):
        sk = s[..., k]
        for i in range(3):
            oix, oiy = P1_CLASS_CORNERS[k][i]
            for j in range(3):
                g = float(g_class_np[k, i, j])
                if g == 0.0:
                    continue
                ojx, ojy = P1_CLASS_CORNERS[k][j]
                d = (ojx - oix, ojy - oiy)
                if d not in planes:
                    planes[d] = s.new_zeros((ny + 1, nx + 1))
                # slice-add on a fresh tensor keeps autograd's graph
                planes[d] = planes[d] + torch.nn.functional.pad(
                    g * sk, (oix, 1 - oix, oiy, 1 - oiy))
    return planes


def apply_varcoef_planes(planes: dict, ug: torch.Tensor) -> torch.Tensor:
    """y = sum_d w_d * roll(u, -d) on the (ny+1, nx+1) vertex grid (same
    wrap-garbage-on-boundary caveat as :func:`apply_stencil`)."""
    out = planes[(0, 0)] * ug
    for (dx, dy), w in planes.items():
        if (dx, dy) == (0, 0):
            continue
        out = out + w * torch.roll(ug, shifts=(-dy, -dx), dims=(0, 1))
    return out
