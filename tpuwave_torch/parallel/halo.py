"""Explicit halo-exchange leapfrog over row slabs (tpuwave's
parallel/halo.py).

Each rank holds one row slab of the (ny+1, nx+1) grid. A step exchanges
the slab's edge rows with its neighbours (parallel/sharding.py::
GridLayout.exchange, ``dist.batch_isend_irecv``), pads the slab with them
and steps it locally: the direct counterpart of the reference's ghost-row
exchange (WaveEquationBase.cpp:182-185).

:func:`make_multistep_halo_leapfrog` trades one k-row exchange for k
local steps (temporal blocking): the stepped region shrinks one row a
step, which the k-row halo exactly feeds. The k steps run as kernel B2
(``ops/kernels.py::leapfrog_multistep``) on the padded slab at its global
row offset, so only the true domain walls are pinned (tpuwave's
``engine="pallas"``; on a CPU tensor B2 runs its plain version). B2 takes
any slab height and width, so tpuwave's Mosaic block rules
(``block_rows``, W % 128) do not apply; its uneven-split and thin-slab
errors do.

Both functions return ``(advance, layout)``: ``advance`` maps a
:class:`LeapfrogState` of this rank's slabs to the next, ``layout`` is the
slab's :class:`~tpuwave_torch.parallel.sharding.GridLayout` (``local``,
``gather``, ``scatter``).
"""

from __future__ import annotations

from tpuwave_torch.models.fast import FastWaveSolver, LeapfrogState
from tpuwave_torch.ops import kernels

__all__ = ["make_halo_leapfrog_step", "make_multistep_halo_leapfrog"]


def _slab_layout(mesh, solver: FastWaveSolver):
    from tpuwave_torch.parallel.sharding import GridLayout
    h, _ = solver.shape
    n = mesh.shape[0] * mesh.shape[1]
    if mesh.shape[1] != 1:
        raise ValueError("halo leapfrog needs a 1-D rank grid over rows")
    if h % n != 0:
        raise ValueError(f"{h} rows do not divide over {n} shards")
    return GridLayout(solver.shape, mesh, solver.device)


def make_halo_leapfrog_step(mesh, solver: FastWaveSolver):
    """One leapfrog step with a one-row halo exchange per step.

    The grid rows must divide evenly over the rank grid's ranks. The
    local step is kernel B2 (one step) on the padded slab at its row
    offset."""
    return make_multistep_halo_leapfrog(mesh, solver, 1)


def make_multistep_halo_leapfrog(mesh, solver: FastWaveSolver,
                                 k_steps: int = 4):
    """Temporally blocked halo exchange: one k-row exchange, then k local
    steps on the (rows/shard + 2k, W) padded slab; returns
    ``(advance, layout)``, ``advance`` taking a state ``k_steps`` steps."""
    layout = _slab_layout(mesh, solver)
    local_rows = layout.block_shape[0]
    k = int(k_steps)
    if k < 1:
        raise ValueError("k_steps must be >= 1")
    if k > 1 and k >= local_rows:
        raise ValueError("k_steps must be smaller than the rows per shard")
    h, _ = solver.shape
    stencil, coef = solver._kernel_args()
    row0 = layout.r0 - k          # global row of the padded slab's top

    def advance(state: LeapfrogState) -> LeapfrogState:
        cur = layout.exchange(state.u, k, cols=False)
        prev = layout.exchange(state.u_prev, k, cols=False)
        cur, prev = kernels.leapfrog_multistep(
            cur.contiguous(), prev.contiguous(), stencil, coef, k,
            row_offset=row0, n_rows=h)
        return LeapfrogState(u=cur[k:k + local_rows].contiguous(),
                             u_prev=prev[k:k + local_rows].contiguous())

    return advance, layout
