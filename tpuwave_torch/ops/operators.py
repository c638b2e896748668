"""Matrix-free global operators and Dirichlet elimination (the parity
engine's gather path).

Counterpart of tpuwave's ops/operators.py, which replaces
``TrilinosWrappers::SparseMatrix`` vmult/add/compress (reference
WaveTheta.cpp:103-116, 127-135) with gather -> per-cell matvec -> scatter-
add, and ``MatrixTools::apply_boundary_values(..., eliminate_columns=true)``
(reference WaveTheta.cpp:258-273, WaveNewmark.cpp:186-241) with mask-based
symmetric elimination that reproduces deal.II's semantics:

  * row j (boundary): zeroed except the ORIGINAL diagonal d_j;
    rhs_j = d_j * g_j; initial guess x_j = g_j
  * column j eliminated from every interior row: rhs_i -= A_ij g_j

so the constrained operator stays SPD and CG trajectories match.

The scatter-add is deterministic, as tpuwave's ``segment_sum`` is (its
parity path is asserted bitwise reproducible): ``index_add_`` of floats on
CUDA adds with atomics in no fixed order. :class:`CellConnectivity` builds
the inverse connectivity once on the host instead: for each DoF its
(cell, local) slots in ascending order, padded to the largest valence with
the index of a zero slot. That valence is the mesh's own: 6 on the
structured mesh for P1 and for P2 vertices (2 for P2 edge midpoints), the
largest number of cells around a vertex of an imported mesh (the table
pads every DoF to it). A scatter-add is then one gather and one sum
over the slot axis, in the same order on every run. The same gather-sum
assembles diagonals, row sums and the load vector
(models/discretization.py, models/general.py).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = ["CellConnectivity", "MatrixFreeOperator", "constrain_system"]


class CellConnectivity:
    """Cell -> DoF connectivity on a device, with its inverse for the
    deterministic scatter-add.

    ``cell_dofs``: (n_cells, nloc) host integer array in any cell order:
    the structured mesh's interleaved [lower, upper] pairs (core/mesh.py)
    or an imported mesh's cells (core/unstructured.py). Only the class and
    scaled storage of :class:`MatrixFreeOperator` read the pairing.
    """

    def __init__(self, cell_dofs, n_dofs: int, device):
        cd = np.asarray(cell_dofs, dtype=np.int64)
        self.n_dofs = int(n_dofs)
        self.n_cells, self.n_local = cd.shape
        self.device = torch.device(device)
        flat = cd.reshape(-1)
        # slot s = e * nloc + i; a stable sort by DoF keeps each DoF's slots
        # ascending
        order = np.argsort(flat, kind="stable")
        counts = np.bincount(flat, minlength=self.n_dofs)
        starts = np.cumsum(counts) - counts
        pos = np.arange(flat.size) - np.repeat(starts, counts)
        table = np.full((self.n_dofs, int(counts.max())), flat.size,
                        dtype=np.int64)
        table[flat[order], pos] = order
        #: (n_cells * nloc,) DoF of each slot
        self.flat = torch.as_tensor(flat, device=self.device)
        #: (n_dofs, max valence) slots of each DoF; n_cells * nloc = the
        #: zero slot
        self.slots = torch.as_tensor(table, device=self.device)
        self._cell_dofs_host = cd

    def cell_dofs(self) -> np.ndarray:
        """Host (n_cells, nloc) connectivity."""
        return self._cell_dofs_host

    def gather(self, v: torch.Tensor) -> torch.Tensor:
        """(n_cells, nloc) element values v[cell_dofs]."""
        return v.index_select(0, self.flat).reshape(self.n_cells,
                                                    self.n_local)

    def assemble(self, we: torch.Tensor) -> torch.Tensor:
        """(n_dofs,) y_i = sum of the element values at i's slots, summed
        in ascending slot order (the deterministic scatter-add)."""
        w = torch.cat([we.reshape(-1), we.new_zeros(1)])
        return w[self.slots].sum(dim=1)


class MatrixFreeOperator:
    """y = A @ v applied cell-wise: y = scatter_add(A_e @ v[cells_e]).

    Three storage modes, cheapest first:
      * class:  a_class (2, nloc, nloc), cells interleaved [lower, upper]
      * scaled: class matrices times a per-element scalar (n_cells,)
      * full:   a_full (n_cells, nloc, nloc), any cell order (imported
        meshes, models/general.py)

    ``conn`` is the :class:`CellConnectivity` of the space (shared by all
    operators on it). The arrays may be numpy or tensors; they are kept as
    tensors of ``dtype`` on ``conn.device``.
    """

    def __init__(self, conn: CellConnectivity, *, a_class=None, scale=None,
                 a_full=None, dtype=torch.float64):
        self.conn = conn
        self.n_dofs = conn.n_dofs
        self.n_cells, self.n_local = conn.n_cells, conn.n_local
        self.dtype = dtype
        self.device = conn.device

        def dev(a):
            return None if a is None else torch.as_tensor(
                a, dtype=dtype, device=self.device)
        self.a_class = dev(a_class)
        self.scale = dev(scale)
        self.a_full = dev(a_full)
        if (self.a_class is None) == (self.a_full is None):
            raise ValueError("Provide exactly one of a_class / a_full")

    # -- application --------------------------------------------------------
    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        ve = self.conn.gather(v)                           # (n_cells, nloc)
        if self.a_full is not None:
            we = torch.einsum("eij,ej->ei", self.a_full, ve)
        else:
            ve2 = ve.reshape(-1, 2, self.n_local)
            we = torch.einsum("kij,ekj->eki", self.a_class, ve2)
            if self.scale is not None:
                we = we * self.scale.reshape(-1, 2, 1)
        return self.conn.assemble(we)

    # -- derived data -------------------------------------------------------
    def _per_element(self, fn, abs_scale: bool = False) -> torch.Tensor:
        """(n_cells, nloc): ``fn`` of each element matrix's rows (``fn``
        maps (..., nloc, nloc) to (..., nloc)); in scaled storage times the
        element's scale, or its absolute value with ``abs_scale``."""
        if self.a_full is not None:
            return fn(self.a_full)
        re = fn(self.a_class).expand(self.n_cells // 2, 2, self.n_local)
        if self.scale is not None:
            s = torch.abs(self.scale) if abs_scale else self.scale
            re = re * s.reshape(-1, 2, 1)
        return re.reshape(-1, self.n_local)

    def diagonal(self) -> torch.Tensor:
        """Assembled diagonal (for Jacobi preconditioning / BC rows)."""
        return self.conn.assemble(self._per_element(
            lambda a: torch.diagonal(a, dim1=-2, dim2=-1)))

    def abs_row_sums(self) -> torch.Tensor:
        """Assembled per-row sums of element-level |entries| — an upper
        bound on the true Gershgorin row sums (triangle inequality over
        element contributions). Used for the per-step lambda_max(D^-1 A)
        bound when the operator changes every step (Time Dependent C +
        Chebyshev preconditioning)."""
        return self.conn.assemble(self._per_element(
            lambda a: torch.sum(torch.abs(a), dim=-1), abs_scale=True))

    def row_sums(self) -> torch.Tensor:
        """Assembled row sums (row-sum mass lumping for the explicit path)."""
        return self.conn.assemble(self._per_element(
            lambda a: torch.sum(a, dim=-1)))

    # -- algebra ------------------------------------------------------------
    def axpy(self, coef: float, other: "MatrixFreeOperator"
             ) -> "MatrixFreeOperator":
        """self + coef * other, merged into ONE operator (the analogue of
        reference matrix_u = M + (theta dt)^2 K, WaveTheta.cpp:110-112 —
        one gather/scatter per apply): class storage when both are
        unscaled class operators, else full element matrices."""
        if self.conn is not other.conn:
            raise ValueError("Operators live on different connectivities")
        if (self.a_class is not None and other.a_class is not None
                and self.scale is None and other.scale is None):
            return MatrixFreeOperator(
                self.conn, a_class=self.a_class + coef * other.a_class,
                dtype=self.dtype)
        return MatrixFreeOperator(
            self.conn, a_full=self._densify_elements()
            + coef * other._densify_elements(), dtype=self.dtype)

    def _densify_elements(self) -> torch.Tensor:
        if self.a_full is not None:
            return self.a_full
        ae = self.a_class.expand(self.n_cells // 2, 2, self.n_local,
                                 self.n_local)
        if self.scale is not None:
            ae = ae * self.scale.reshape(-1, 2, 1, 1)
        return ae.reshape(-1, self.n_local, self.n_local)

    # -- testing helpers ----------------------------------------------------
    def to_dense(self) -> np.ndarray:
        """Assemble the full dense matrix (tests / tiny meshes only)."""
        cd = self.conn.cell_dofs()
        ae = self._densify_elements().cpu().numpy()
        out = np.zeros((self.n_dofs, self.n_dofs))
        for e in range(cd.shape[0]):
            out[np.ix_(cd[e], cd[e])] += ae[e]
        return out


def constrain_system(apply_a: Callable, diag_a, boundary_mask,
                     boundary_values, rhs, x_prev):
    """Symmetric Dirichlet elimination, matrix-free.

    Given the unconstrained operator ``apply_a`` with assembled diagonal
    ``diag_a``, the boundary mask b, prescribed values g (dense vector,
    arbitrary off-boundary entries), the raw rhs and the previous solution
    (warm start), returns ``(apply_constrained, rhs_constrained, x0)``
    reproducing deal.II apply_boundary_values(..., eliminate_columns=true):

        A~ v  = interior(A(interior(v))) + d * v      on boundary rows
        rhs~  = interior(rhs - A(g 1_b)) + d * g      on boundary rows
        x0    = x_prev with boundary entries set to g
    """
    bnd = boundary_mask
    interior = ~bnd
    g_ext = torch.where(bnd, boundary_values, 0.0)

    def apply_constrained(v):
        w = apply_a(torch.where(interior, v, 0.0))
        return torch.where(interior, w, diag_a * v)

    rhs_c = torch.where(interior, rhs - apply_a(g_ext), diag_a * g_ext)
    x0 = torch.where(bnd, g_ext, x_prev)
    return apply_constrained, rhs_c, x0
