"""Rank grids and grid layouts: domain decomposition over torch.distributed.

The reference's only parallelism is MPI domain decomposition of the mesh
(reference WaveEquationBase.cpp:65-69). tpuwave hands GSPMD a
``NamedSharding`` of the (ny+1, nx+1) vertex grid and lets XLA insert the
halo permutes and the reductions; PyTorch has no such partitioner, so this
module writes the communication out:

* one process is one rank; it owns one row slab (``rows``, a 1-D rank
  grid) or one block of a 2-D rank grid (``blocks``) of the global grid,
  uneven splits included (the first ``n % parts`` slabs take a row more);
* :meth:`GridLayout.exchange` fills a halo of ``depth`` rows and columns
  around the rank's block from its neighbours: rows first, then columns
  of the row-extended block, so the 9-point stencil gets its corners.
  Each phase posts all sends and receives at once
  (``dist.batch_isend_irecv``), so no ordering can deadlock; halos beyond
  the global grid are zeros;
* :meth:`GridLayout.all_sum` is the reduction of every dot product and
  norm, so every rank reads the same value and takes the same branch;
* :meth:`GridLayout.gather` / :meth:`GridLayout.scatter` move whole grids
  to and from rank 0 (output, checkpoints, tests).

The backend is an explicit argument of :func:`init_distributed`: ``nccl``
for ranks with a card each (the default for ``cuda``), ``gloo`` on the CPU
(the default for ``cpu``). gloo moves only CPU tensors, so under gloo a
CUDA tensor's halo and sums are staged through host memory; that is also
how several ranks share one card (NCCL refuses two ranks on one card).
Nothing switches the backend on its own.

A process that was started alone (no launcher environment) is a world of
one: every layout is then the whole grid and nothing communicates.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["init_distributed", "device_mesh", "dcn_device_mesh",
           "grid_sharding", "replicated", "shard_grid_arrays", "RankGrid",
           "GridSharding", "GridLayout", "split_bounds", "blocks_shape",
           "world_rank", "world_size", "DEFAULT_TIMEOUT_S"]

#: seconds a collective may wait for a peer before the process group
#: raises (a failed rank then ends the others instead of hanging them)
DEFAULT_TIMEOUT_S = 120.0


def world_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     backend: Optional[str] = None, device="cuda",
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group of a multi-rank run (the counterpart of
    tpuwave's ``init_distributed`` and of the reference's
    MPI_InitFinalize, main-theta.cpp:25).

    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` default to the launcher's environment (``torchrun``:
    ``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). Returns
    False, and does nothing, where neither names a coordinator: a
    process started alone is a world of one. ``backend`` defaults to
    ``nccl`` for a ``cuda`` device and ``gloo`` for ``cpu``; pass
    ``gloo`` explicitly for several ranks on one card. A CUDA rank binds
    the card ``LOCAL_RANK % device_count`` first, so ``"cuda"`` names
    its own card.
    """
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None:
        if not env.get("MASTER_ADDR") or not env.get("MASTER_PORT"):
            return False
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(env.get("RANK", "0"))
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} (nccl | gloo)")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: device 'cuda' requested "
                               "but torch.cuda.is_available() is False")
        local = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=float(timeout_s)))
    return True


# ---------------------------------------------------------------------------
# rank grids
# ---------------------------------------------------------------------------
class RankGrid:
    """A (ry, rx) grid of global ranks, row-major, with the process group
    they communicate in (None: the whole world). tpuwave's device mesh:
    axis ``y`` splits grid rows, ``x`` grid columns."""

    def __init__(self, ranks: Sequence[int], shape: Tuple[int, int],
                 group=None):
        self.ranks = tuple(int(r) for r in ranks)
        self.shape = (int(shape[0]), int(shape[1]))
        if self.shape[0] * self.shape[1] != len(self.ranks):
            raise ValueError(f"mesh shape {self.shape} != "
                             f"{len(self.ranks)} ranks")
        self.group = group

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def member(self) -> bool:
        """Whether this process is one of the grid's ranks."""
        return world_rank() in self.ranks

    def position(self, rank: Optional[int] = None) -> Tuple[int, int]:
        i = self.ranks.index(world_rank() if rank is None else rank)
        return divmod(i, self.shape[1])

    def rank_at(self, iy: int, ix: int) -> Optional[int]:
        ry, rx = self.shape
        if 0 <= iy < ry and 0 <= ix < rx:
            return self.ranks[iy * rx + ix]
        return None


def blocks_shape(n: int) -> Tuple[int, int]:
    """tpuwave's ``--shard blocks`` rank grid for ``n`` ranks: the largest
    divisor d <= sqrt(n), as (max(d, n / d), min(d, n / d))
    (tpuwave/cli/_common.py:194-201)."""
    ry = 1
    for d in range(int(n ** 0.5), 0, -1):
        if n % d == 0:
            ry = d
            break
    return (max(ry, n // ry), min(ry, n // ry))


def device_mesh(n_devices: Optional[int] = None,
                shape: Optional[Tuple[int, int]] = None,
                devices: Optional[Sequence[int]] = None) -> RankGrid:
    """Rank grid over the first ``n_devices`` ranks of the world (or the
    ranks ``devices``): 1-D over rows by default, ``shape=(ry, rx)`` for
    2-D blocks. A grid smaller than the world gets a process group of its
    own; every rank of the world must make that call, as
    ``dist.new_group`` requires."""
    ranks = list(devices if devices is not None else range(world_size()))
    if n_devices is not None:
        ranks = ranks[:int(n_devices)]
    if shape is None:
        shape = (len(ranks), 1)
    group = None
    if dist.is_initialized() and len(ranks) != world_size():
        group = dist.new_group(ranks)
    return RankGrid(ranks, shape, group)


def dcn_device_mesh() -> RankGrid:
    """Rank grid for multi-host runs: grid rows over hosts, columns over
    each host's local ranks (``LOCAL_WORLD_SIZE``), so only the thin row
    boundary between hosts crosses the slower link. A world of one gets
    a (1, 1) grid."""
    n = world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if n % local:
        raise ValueError(f"{n} ranks do not split into hosts of {local}")
    return device_mesh(shape=(n // local, local))


class GridSharding:
    """How a grid lies over a rank grid (tpuwave's ``NamedSharding``):
    ``spec`` ("y", None) for row slabs, ("y", "x") for blocks, () for a
    grid every rank holds whole. Shape-free: a solver makes its
    :class:`GridLayout` with :meth:`layout`."""

    def __init__(self, mesh: RankGrid, spec: Tuple):
        self.mesh = mesh
        self.spec = tuple(spec)

    def layout(self, shape: Tuple[int, int], device) -> "GridLayout":
        if not self.spec:
            return GridLayout.whole(shape, device)
        return GridLayout(shape, self.mesh, device)


def grid_sharding(mesh: RankGrid) -> GridSharding:
    """Sharding of (ny+1, nx+1) grid arrays: rows over ``y`` (and
    columns over ``x`` when the rank grid is 2-D)."""
    if mesh.shape[1] > 1:
        return GridSharding(mesh, ("y", "x"))
    return GridSharding(mesh, ("y", None))


def replicated(mesh: RankGrid) -> GridSharding:
    """Every rank holds the whole grid (no halo, no sums)."""
    return GridSharding(mesh, ())


def shard_grid_arrays(sharding, *arrays):
    """Each global (H, W) array's block on this rank (``sharding``: a
    :class:`GridSharding` or a :class:`RankGrid`)."""
    if isinstance(sharding, RankGrid):
        sharding = grid_sharding(sharding)
    out = tuple(sharding.layout(tuple(a.shape), a.device).local(a)
                for a in arrays)
    return out if len(out) != 1 else out[0]


# ---------------------------------------------------------------------------
# grid layouts
# ---------------------------------------------------------------------------
def split_bounds(n: int, parts: int) -> List[Tuple[int, int]]:
    """[start, stop) of ``parts`` contiguous pieces of ``n``: the first
    ``n % parts`` take one more."""
    q, r = divmod(int(n), int(parts))
    out, a = [], 0
    for i in range(int(parts)):
        b = a + q + (1 if i < r else 0)
        out.append((a, b))
        a = b
    return out


class GridLayout:
    """One rank's block of a global (H, W) grid over a :class:`RankGrid`:
    its owned rows [r0, r1) and columns [c0, c1), its neighbours, and the
    halo exchange, sums and whole-grid moves of its group.

    ``row_bounds`` / ``col_bounds`` give every rank's range (default: the
    even split of :func:`split_bounds`); a multigrid level derives its
    own from the finer level's (:meth:`coarsen`)."""

    def __init__(self, shape: Tuple[int, int], mesh: Optional[RankGrid],
                 device, *, row_bounds=None, col_bounds=None):
        self.shape = (int(shape[0]), int(shape[1]))
        self.mesh = mesh
        self.device = torch.device(device)
        h, w = self.shape
        if mesh is None:
            ry = rx = 1
            iy = ix = 0
        else:
            if not mesh.member:
                raise ValueError(f"rank {world_rank()} is not in the rank "
                                 f"grid {mesh.ranks}")
            ry, rx = mesh.shape
            iy, ix = mesh.position()
        self.row_bounds = list(row_bounds or split_bounds(h, ry))
        self.col_bounds = list(col_bounds or split_bounds(w, rx))
        self.r0, self.r1 = self.row_bounds[iy]
        self.c0, self.c1 = self.col_bounds[ix]
        self.block_shape = (self.r1 - self.r0, self.c1 - self.c0)
        self.size = 1 if mesh is None else mesh.size
        self.position = (iy, ix)
        self.group = None if mesh is None else mesh.group
        if mesh is None or self.size == 1:
            self.up = self.down = self.left = self.right = None
        else:
            self.up = mesh.rank_at(iy - 1, ix)
            self.down = mesh.rank_at(iy + 1, ix)
            self.left = mesh.rank_at(iy, ix - 1)
            self.right = mesh.rank_at(iy, ix + 1)
        self._p2p_ready = False
        #: CUDA tensors through gloo go by host memory
        self.staged = (self.size > 1 and self.device.type == "cuda"
                       and dist.get_backend(self.group) == "gloo")
        #: this rank's slot in the group (rank 0 of the group writes)
        self.index = iy * (rx if mesh is not None else 1) + ix
        self.min_rows = min(b - a for a, b in self.row_bounds)
        self.min_cols = min(b - a for a, b in self.col_bounds)
        if self.min_rows < 1 or self.min_cols < 1:
            raise ValueError(f"grid {self.shape} is too small for a "
                             f"{ry} x {rx} rank grid")

    @classmethod
    def whole(cls, shape, device) -> "GridLayout":
        """The layout of a world of one: the whole grid, no peers."""
        return cls(shape, None, device)

    @property
    def sharded(self) -> bool:
        return self.size > 1

    @property
    def is_root(self) -> bool:
        return self.index == 0

    # -- indexing ----------------------------------------------------------
    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of a global (H, W) tensor (a view)."""
        return x[self.r0:self.r1, self.c0:self.c1]

    def owns(self, row: int, col: int) -> bool:
        return self.r0 <= row < self.r1 and self.c0 <= col < self.c1

    def pinned(self) -> torch.Tensor:
        """(h, w) bool Dirichlet mask of the block, by global position."""
        from tpuwave_torch.ops.kernels import pinned_mask
        return pinned_mask(self.block_shape, self.device,
                           row_offset=self.r0, col_offset=self.c0,
                           n_rows=self.shape[0], n_cols=self.shape[1])

    def iota(self, dtype, *, cells: bool = False):
        """Global (column, row) index planes of the block's nodes, or with
        ``cells`` of its cells (:meth:`cell_bounds`)."""
        (a, b), (c, d) = self.cell_bounds() if cells else (
            (self.r0, self.r1), (self.c0, self.c1))
        ix = torch.arange(c, d, dtype=dtype, device=self.device)
        iy = torch.arange(a, b, dtype=dtype, device=self.device)
        return (ix[None, :].expand(b - a, d - c),
                iy[:, None].expand(b - a, d - c))

    def cell_bounds(self):
        """The rows and columns of the (H - 1, W - 1) cell grid this rank
        owns: the cells anchored at its nodes (the last node row and
        column anchor none)."""
        h, w = self.shape
        return ((self.r0, min(self.r1, h - 1)),
                (self.c0, min(self.c1, w - 1)))

    def cell_block(self, x: torch.Tensor) -> torch.Tensor:
        """The nodes of this rank's cells: its block extended by one row
        below and one column to the right (from the neighbours)."""
        (a, b), (c, d) = self.cell_bounds()
        if not self.sharded:
            return x
        xp = self.exchange(x, 1)
        return xp[1:1 + (b - a) + 1, 1:1 + (d - c) + 1]

    # -- communication ---------------------------------------------------
    def _p2p(self, sends, recvs):
        """Post every send and receive of one phase at once. ``sends``:
        [(tensor, peer, tag)], ``recvs``: [(shape, peer, tag)]; returns
        the received tensors in order."""
        stage = self.staged
        ops, bufs = [], []
        for t, peer, tag in sends:
            t = t.contiguous()
            if stage:
                t = t.cpu()
            ops.append(dist.P2POp(dist.isend, t, peer, self.group, tag))
        for (shape, dtype, dev), peer, tag in recvs:
            buf = torch.empty(shape, dtype=dtype,
                              device="cpu" if stage else dev)
            bufs.append(buf)
            ops.append(dist.P2POp(dist.irecv, buf, peer, self.group, tag))
        if ops:
            if not self._p2p_ready:
                # NCCL sets up a group's point-to-point links at its first
                # batch, which every rank of the group must join: a barrier
                # first (every rank reaches this exchange together)
                dist.barrier(group=self.group)
                self._p2p_ready = True
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return [b.to(self.device) if stage else b for b in bufs]

    def _edges(self, x, d, dim, lo, hi):
        """x extended by ``d`` slices on each side of ``dim`` from the
        ranks ``lo`` (before) and ``hi`` (after); zeros where there is
        none."""
        n = x.shape[dim]
        first, last = x.narrow(dim, 0, d), x.narrow(dim, n - d, d)
        shape = list(x.shape)
        shape[dim] = d
        meta = (tuple(shape), x.dtype, x.device)
        sends, recvs, slots = [], [], []
        # tag 0 travels towards lo, tag 1 towards hi
        if lo is not None:
            sends.append((first, lo, 0))
            recvs.append((meta, lo, 1))
            slots.append("lo")
        if hi is not None:
            sends.append((last, hi, 1))
            recvs.append((meta, hi, 0))
            slots.append("hi")
        got = dict(zip(slots, self._p2p(sends, recvs)))
        zero = x.new_zeros(shape)
        return torch.cat([got.get("lo", zero), x, got.get("hi", zero)],
                         dim=dim)

    def exchange(self, x: torch.Tensor, depth: int = 1, *,
                 cols: bool = True) -> torch.Tensor:
        """The block with a halo of ``depth`` rows (and, with ``cols``,
        columns) on each side: (h + 2 depth, w + 2 depth). Rows come
        first, then the columns of the row-extended block, so the corners
        hold the diagonal neighbours' values. Halos beyond the global grid
        are zeros. Every neighbour must own at least ``depth`` rows
        (columns)."""
        d = int(depth)
        if d < 1:
            return x
        if d > self.min_rows or (cols and d > self.min_cols):
            raise ValueError(f"halo depth {d} exceeds the thinnest block "
                             f"({self.min_rows} rows, {self.min_cols} "
                             "columns)")
        xr = self._edges(x, d, 0, self.up, self.down)
        if not cols:
            return xr
        return self._edges(xr, d, 1, self.left, self.right)

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the group (a new tensor, the same bits on
        every rank)."""
        if not self.sharded:
            return t
        buf = t.detach().to("cpu" if self.staged else t.device,
                            copy=True).contiguous()
        dist.all_reduce(buf, group=self.group)
        return buf.to(t.device) if self.staged else buf

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Global dot product of two blocks (0-d)."""
        return self.all_sum(torch.dot(a.reshape(-1), b.reshape(-1)))

    def norm(self, a: torch.Tensor) -> torch.Tensor:
        """Global 2-norm of a block (0-d)."""
        if not self.sharded:
            return torch.linalg.vector_norm(a)
        return torch.sqrt(self.dot(a, a))

    def gather_all(self, x: torch.Tensor) -> torch.Tensor:
        """The global (H, W) grid on every rank, from each rank's block."""
        if not self.sharded:
            return x
        mh = max(b - a for a, b in self.row_bounds)
        mw = max(b - a for a, b in self.col_bounds)
        dev = "cpu" if self.staged else x.device
        buf = torch.zeros((mh, mw), dtype=x.dtype, device=dev)
        h, w = self.block_shape
        buf[:h, :w] = x
        parts = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(parts, buf, group=self.group)
        out = torch.empty(self.shape, dtype=x.dtype, device=dev)
        rx = len(self.col_bounds)
        for i, part in enumerate(parts):
            (a, b), (c, d) = (self.row_bounds[i // rx],
                              self.col_bounds[i % rx])
            out[a:b, c:d] = part[:b - a, :d - c]
        return out.to(self.device)

    def gather(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        """The global grid on the group's rank 0, None elsewhere."""
        full = self.gather_all(x)
        return full if self.is_root else None

    def scatter(self, x: Optional[torch.Tensor]) -> torch.Tensor:
        """This rank's block of the global grid ``x`` held by the group's
        rank 0 (the others pass None)."""
        if not self.sharded:
            return x
        dev = "cpu" if self.staged else self.device
        if self.is_root:
            buf = x.to(dev).contiguous()
            meta = torch.tensor([_DTYPE_CODE[x.dtype]], dtype=torch.int64,
                                device=dev)
        else:
            meta = torch.zeros(1, dtype=torch.int64, device=dev)
        dist.broadcast(meta, self.mesh.ranks[0], group=self.group)
        if not self.is_root:
            buf = torch.empty(self.shape, dtype=_CODE_DTYPE[int(meta[0])],
                              device=dev)
        dist.broadcast(buf, self.mesh.ranks[0], group=self.group)
        return self.local(buf).to(self.device).contiguous()

    # -- multigrid levels --------------------------------------------------
    def coarsen(self) -> Optional["GridLayout"]:
        """The layout of the next coarser level ((H + 1) / 2 x (W + 1) /
        2 nodes; coarse node i is fine node 2 i, owned by the fine node's
        rank), or None where a rank would own fewer than 2 rows or
        columns there (the level is then agglomerated)."""
        h, w = self.shape

        def half(bounds):
            return [(-(-a // 2), -(-b // 2)) for a, b in bounds]
        rows, cols = half(self.row_bounds), half(self.col_bounds)
        if min(b - a for a, b in rows) < 2 or min(b - a for a, b in cols) < 2:
            return None
        return GridLayout(((h + 1) // 2, (w + 1) // 2), self.mesh,
                          self.device, row_bounds=rows, col_bounds=cols)


_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bool: 2,
               torch.int64: 3}
_CODE_DTYPE = {v: k for k, v in _DTYPE_CODE.items()}
