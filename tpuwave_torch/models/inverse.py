"""Differentiable wave propagation and full-waveform inversion (FWI).

Port of tpuwave/models/inverse.py. The forward model (P1 FEM, lumped-mass
leapfrog, homogeneous Dirichlet walls or an absorbing sponge)

    M_L u''  +  K(c2) u = w(t) e_src,     u|dOmega = 0,   u(0)=u0, u'(0)=0

is a function of the per-cell squared wave speed ``c2_cell`` and of the
source wavelet.

Leapfrog recurrence (models/fast.py::leapfrog_step with varying c):

    u^{n+1} = 2 u^n - u^{n-1} + dt^2 M_L^{-1} (w_n e_src - K u^n)

Four engines, one algebra:

- ``"kernel"`` (the port's default; tpuwave's ``"pallas"``): the fused CUDA
  kernels B14-B17 of ``ops/kernels_varcoef.py`` on the true (ny+1, nx+1)
  grid, up to ``steps_per_call`` steps per kernel pass in both
  directions;
- ``"stencil"``: the same recurrence on flat vectors with the assembled
  coefficient planes and ``torch.roll``, the plain twin of the kernel
  engine;
- ``"grid"``: K(c2) u as slab multiply-adds on (ny, nx) coefficient planes
  every step (:meth:`FwiProblem.stiffness_apply`);
- ``"scatter"``: gather, class matvec, and the deterministic gather-sum
  over the inverse connectivity (``ops/operators.py::CellConnectivity``),
  the reference-parity form (tpuwave's default).

Two adjoints give the gradients:

- ``"reversal"`` (the port's default; kernel and stencil engines): the
  hand-written adjoint-state method, a ``torch.autograd.Function`` whose
  backward pass RECONSTRUCTS the forward states by running the
  time-reversible leapfrog backwards from the final pair, so memory is
  O(1) in the step count (with a sponge the forward pass saves the
  interface ring or the damped strip, "boundary saving");
- ``"remat"`` (tpuwave's default; scatter, grid and stencil engines):
  ``torch.autograd`` through the Python step loop, each step under
  ``torch.utils.checkpoint`` (``remat=True``) so that only its inputs,
  two fields, are kept.

On top of the propagator: encoded supershots (Krebs et al. 2009), Born
modelling (the tangent recurrence of the plain step loop), migration and
RTM as its adjoint, LSRTM (CGLS), Gauss-Newton, the illumination
preconditioner, multiscale inversion, and Adam or L-BFGS descent
(``solve/lbfgs.py``: optax's ``lbfgs()``).

On a CPU device the kernel engine's wrappers run their plain versions.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint as _checkpoint

from tpuwave_torch.config import DEFAULT_DTYPE, resolve_device
from tpuwave_torch.core.mesh import FeSpace, StructuredTriMesh
from tpuwave_torch.core.quadrature import gauss_simplex
from tpuwave_torch.ops import kernels_varcoef as kv
from tpuwave_torch.ops.operators import CellConnectivity
from tpuwave_torch.ops.stencil import (P1_CLASS_CORNERS,
                                       apply_varcoef_planes,
                                       assemble_varcoef_planes)
from tpuwave_torch.solve.lbfgs import Lbfgs
from tpuwave_torch.utils import prng
from tpuwave_torch.utils.checkpoint import load_inversion, save_inversion

__all__ = ["FwiProblem", "FwiResult", "ricker_wavelet", "lowpass_time",
           "envelope_time", "trace_misfit"]

#: the engines that run the plain step loop (Born modelling, several
#: sources)
_PLAIN_ENGINES = "('scatter', 'grid', 'stencil')"


def _adam_leaves(opt, params) -> list:
    """``torch.optim.Adam``'s state as the leaves of tpuwave's optax Adam
    state: ``count`` (int32), then ``mu`` and ``nu`` in parameter order."""
    states = [opt.state[q] for q in params]
    count = np.asarray(int(states[0]["step"]), np.int32)
    return ([count] + [st["exp_avg"] for st in states]
            + [st["exp_avg_sq"] for st in states])


def _restore_adam(opt, params, p_leaves, o_leaves):
    """Load ``save_inversion``'s leaves into the parameters (in place) and
    into ``opt`` (the inverse of :func:`_adam_leaves`)."""
    n = len(params)
    count = float(np.asarray(o_leaves[0]))
    with torch.no_grad():
        for i, q in enumerate(params):
            q.copy_(torch.as_tensor(p_leaves[i]))
            opt.state[q] = {
                # torch keeps Adam's step as a host float tensor
                "step": torch.tensor(count, dtype=torch.float32),
                "exp_avg": torch.as_tensor(o_leaves[1 + i]).to(q),
                "exp_avg_sq": torch.as_tensor(o_leaves[1 + n + i]).to(q)}


def ricker_wavelet(times, peak_freq: float, delay: Optional[float] = None):
    """Ricker (Mexican-hat) source wavelet w(t), the standard FWI source
    (host numpy, f64)."""
    times = np.asarray(times, dtype=np.float64)
    t0 = delay if delay is not None else 1.2 / peak_freq
    arg = (np.pi * peak_freq * (times - t0)) ** 2
    return (1.0 - 2.0 * arg) * np.exp(-arg)


def lowpass_time(x, dt: float, cutoff: float, axis: int = 0,
                 rolloff: float = 0.2) -> torch.Tensor:
    """Zero-phase low-pass along a time axis: a real-FFT filter with a
    raised-cosine rolloff, |H(f)| = 1 for f <= (1-rolloff)*cutoff,
    cosine-tapered to 0 at cutoff. Returns a tensor (f64 for array
    input)."""
    x = torch.as_tensor(x)
    n = x.shape[axis]
    freqs = np.fft.rfftfreq(n, d=dt)
    f0 = (1.0 - rolloff) * cutoff
    h = np.ones_like(freqs)
    band = (freqs > f0) & (freqs < cutoff)
    h[band] = 0.5 * (1.0 + np.cos(np.pi * (freqs[band] - f0)
                                  / max(cutoff - f0, 1e-300)))
    h[freqs >= cutoff] = 0.0
    shape = [1] * x.dim()
    shape[axis] = len(freqs)
    hx = torch.as_tensor(h.reshape(shape), dtype=x.dtype, device=x.device)
    return torch.fft.irfft(torch.fft.rfft(x, dim=axis) * hx, n=n, dim=axis)


def envelope_time(x, axis: int = -2, eps: float = 1e-30) -> torch.Tensor:
    """Instantaneous-amplitude envelope |x + i H(x)| along a time axis (H =
    Hilbert transform, by the FFT analytic-signal trick). Differentiable;
    ``eps`` regularises the |.| kink at exact zeros."""
    x = torch.as_tensor(x)
    n = x.shape[axis]
    h = np.zeros(n)
    h[0] = 1.0
    if n % 2 == 0:
        h[n // 2] = 1.0
        h[1:n // 2] = 2.0
    else:
        h[1:(n + 1) // 2] = 2.0
    shape = [1] * x.dim()
    shape[axis] = n
    hx = torch.as_tensor(h.reshape(shape), dtype=x.dtype, device=x.device)
    a = torch.fft.ifft(torch.fft.fft(x, dim=axis) * hx, dim=axis)
    return torch.sqrt(a.real ** 2 + a.imag ** 2 + eps)


def trace_misfit(sim, obs, kind: str = "l2", *, huber_delta: float = 1.0,
                 time_axis: int = -2) -> torch.Tensor:
    """Data misfit over receiver gathers (last two axes (n_steps, n_rec); a
    leading shot axis is fine): ``"l2"`` 0.5 ||r||^2, ``"huber"``
    (quadratic for |r| <= huber_delta, linear beyond) or ``"envelope"``
    (0.5 ||env(sim) - env(obs)||^2)."""
    sim = torch.as_tensor(sim)
    obs = torch.as_tensor(obs, dtype=sim.dtype, device=sim.device)
    r = sim - obs
    if kind == "l2":
        return 0.5 * torch.sum(r * r)
    if kind == "huber":
        q = torch.abs(r)
        return torch.sum(torch.where(q <= huber_delta, 0.5 * q * q,
                                     huber_delta * (q - 0.5 * huber_delta)))
    if kind == "envelope":
        e = (envelope_time(sim, axis=time_axis)
             - envelope_time(obs, axis=time_axis))
        return 0.5 * torch.sum(e * e)
    raise ValueError(f"unknown misfit kind {kind!r}")


class FwiResult(NamedTuple):
    c2: torch.Tensor                          # recovered per-cell c^2
    misfits: np.ndarray                       # misfit per iteration
    wavelet: Optional[torch.Tensor] = None    # co-estimated source


class _ReversalSim(torch.autograd.Function):
    """(c2, wavelet) -> traces with the reconstruction-based backward pass
    (tpuwave: the ``jax.custom_vjp`` of ``_reversal_sim``). ``src`` is a
    vertex id or a tuple of them (one column of ``wavelet`` each). Forward
    saves (c2, wavelet, u_last, u_prevlast[, boundary saves]); backward
    returns c2's cotangent through the VJP of the linear plane assembly
    and the wavelet's; the sources get none."""

    @staticmethod
    def forward(ctx, c2, wavelet, problem, src):
        traces, (u_last, u_prevlast, saves) = problem._propagate(
            c2, src, wavelet, return_final=True)
        ctx.problem, ctx.src = problem, src
        ctx.save_for_backward(c2, wavelet, u_last, u_prevlast,
                              *(saves or ()))
        return traces

    @staticmethod
    def backward(ctx, ybar):
        c2, wavelet, u_last, u_prevlast, *saves = ctx.saved_tensors
        prob = ctx.problem
        back = (prob._adjoint_backward_kernel if prob.engine == "kernel"
                else prob._adjoint_backward)
        c2_bar, wav_bar = back(c2, ctx.src, wavelet, u_last, u_prevlast,
                               ybar.contiguous(), tuple(saves) or None)
        return c2_bar, wav_bar, None, None


class FwiProblem:
    """Differentiable forward model, adjoint gradients, linearized imaging
    and the inversion loops (port of tpuwave's ``FwiProblem``).

    Parameters
    ----------
    nel : (nx, ny) structured-rectangle resolution (2 triangles per cell).
    geometry : ((x0, y0), (x1, y1)) bounding box.
    dt, n_steps : time grid (t_n = n dt, n = 1..n_steps recorded).
    source : (x, y) source location, snapped to the nearest vertex.
    receivers : (x, y) receiver locations, snapped likewise, or sampled at
        the exact locations by P1 barycentric interpolation with
        ``interp_receivers=True``.
    wavelet : (n_steps,) source time series (default: a Ricker wavelet at
        1 / (20 dt)).
    dtype, device : default torch.float64 and "cuda" (raises without a
        card; "cpu" runs the kernel engine's plain versions).
    remat : with ``adjoint="remat"``, run each step under
        ``torch.utils.checkpoint`` (recompute it in the backward pass
        instead of keeping its intermediates).
    sponge_width, sponge_strength : absorbing layer along the walls
        (sigma = strength * q^2, q ramping 0 -> 1 toward the wall; the
        damped leapfrog (1 + s) u' = 2u - (1 - s) u_prev + ..., s = sigma
        dt / 2); 0 keeps hard reflecting walls.
    engine : "kernel" (the CUDA kernels B14-B17, tpuwave's "pallas"),
        "stencil" (the plain plane-stencil recurrence), "grid" (slab
        multiply-adds) or "scatter" (gather / class matvec / gather-sum).
    adjoint : "reversal" (O(1)-memory state reconstruction; engines
        "kernel" and "stencil") or "remat" (autograd through the step
        loop; every engine but "kernel").
    boundary_save : with a sponge and the reversal adjoint, what the
        forward pass saves for the reconstruction: "strip" (every sigma >
        0 vertex; stencil engine only) or "ring" (the interface ring;
        gradients exact on ``sponge_interior_cell_mask``).
    steps_per_call : fused steps per kernel pass (B15 / B17), in both
        directions. Results do not depend on it. B15 and B17 run a pass
        of k > 8 steps as ceil(k / 8) launches; 1 runs one step per
        launch (B14 / B16).

    The port's defaults (engine "kernel", adjoint "reversal", device
    "cuda") differ from tpuwave's ("scatter" / "remat");
    ``models/convert.py::fwi_problem_kwargs`` maps a tpuwave construction
    onto the port's.
    """

    def __init__(self, nel: Tuple[int, int], geometry, dt: float,
                 n_steps: int, *, source: Tuple[float, float],
                 receivers: Sequence[Tuple[float, float]],
                 wavelet=None, dtype: Optional[torch.dtype] = None,
                 device="cuda", remat: bool = True,
                 sponge_width: float = 0.0,
                 sponge_strength: float = 30.0, engine: str = "kernel",
                 adjoint: str = "reversal", boundary_save: str = "strip",
                 interp_receivers: bool = False, steps_per_call: int = 8):
        if engine not in ("scatter", "grid", "stencil", "kernel"):
            raise ValueError(f"unknown engine {engine!r} (scatter | grid | "
                             "stencil | kernel; tpuwave's 'pallas' is "
                             "'kernel' here)")
        if adjoint not in ("remat", "reversal"):
            raise ValueError(f"unknown adjoint {adjoint!r}")
        if boundary_save not in ("strip", "ring"):
            raise ValueError(f"unknown boundary_save {boundary_save!r}")
        if adjoint == "reversal" and engine not in ("stencil", "kernel"):
            raise ValueError("adjoint='reversal' needs engine='stencil' "
                             "or 'kernel' (the reconstruction runs on the "
                             "assembled stencil planes)")
        if (adjoint == "reversal" and engine == "kernel"
                and sponge_width > 0.0 and boundary_save != "ring"):
            raise ValueError("engine='kernel' with a sponge requires "
                             "boundary_save='ring' (the fused path saves "
                             "only the interface ring; use "
                             "engine='stencil' for the exact-everywhere "
                             "'strip' mode)")
        if engine == "kernel" and adjoint != "reversal":
            raise ValueError("engine='kernel' requires adjoint='reversal' "
                             "(the fused kernels have no autograd rule, so "
                             "gradients go through the hand-written "
                             "time-reversal backward pass)")
        self.engine = engine
        self.adjoint = adjoint
        self.remat = bool(remat)
        self.boundary_save = boundary_save
        self.steps_per_call = max(1, int(steps_per_call))
        self.dtype = dtype or DEFAULT_DTYPE
        self.device = resolve_device(device)
        self.mesh = StructuredTriMesh(tuple(nel), geometry)
        self.space = FeSpace(self.mesh, 1)
        self.dt = float(dt)
        self.n_steps = int(n_steps)
        rows, cols = self.mesh.ny + 1, self.mesh.nx + 1
        self._grid = (rows, cols)

        quad = gauss_simplex(2)
        grads = self.space.physical_grads(self.space.shape_at(quad))
        # P1: q-independent physical gradients -> K_e = s_e * G_class
        self._g_class_np = np.einsum("cqia,cqja->cqij", grads, grads)[:, 0]
        self._g_class = self._t(self._g_class_np)
        self._w_sum = float(np.sum(quad.weights))
        self._det_j = float(self.mesh.det_j)

        cells = np.asarray(self.mesh.cells, dtype=np.int64)
        self.n_cells = cells.shape[0]
        self.n_vertices = self.mesh.n_vertices
        self._cells = torch.as_tensor(cells, device=self.device)
        if engine == "scatter":
            self._conn = CellConnectivity(cells, self.n_vertices,
                                          self.device)
        # row-sum lumped mass: detJ/6 per triangle on each of its vertices,
        # accumulated in cell order
        lumped = np.bincount(cells.ravel(), minlength=self.n_vertices,
                             weights=np.full(cells.size, self._det_j / 6.0))
        self._inv_lumped = self._t(1.0 / lumped)
        self._interior = self._t(~self.mesh.boundary_vertex_mask)

        coords = self.mesh.vertex_coords
        (x0, y0) = self.mesh.origin
        x1, y1 = x0 + self.mesh.extent[0], y0 + self.mesh.extent[1]
        if sponge_width > 0.0:
            d_wall = np.minimum.reduce([coords[:, 0] - x0, x1 - coords[:, 0],
                                        coords[:, 1] - y0, y1 - coords[:, 1]])
            q = np.clip(1.0 - d_wall / float(sponge_width), 0.0, 1.0)
            sigma = float(sponge_strength) * q * q
        else:
            sigma = np.zeros(self.n_vertices)
        s_half = 0.5 * self.dt * sigma
        self._damp_num = self._t(1.0 - s_half)
        self._damp_den = self._t(1.0 / (1.0 + s_half))
        self._sigma_np = sigma

        self.source_vertex = self._nearest(source)
        self._sponge_keep = None
        self._sponge_rects = None
        self._ring = None
        if sponge_width > 0.0 and adjoint == "reversal":
            self._boundary_saving(sigma, boundary_save)

        self.receiver_vertices = torch.tensor(
            [self._nearest(r) for r in receivers], dtype=torch.int64,
            device=self.device)
        self.interp_receivers = bool(interp_receivers)
        if interp_receivers:
            vr, wr = [], []
            for r in receivers:
                cell, (xi, eta) = self.mesh.locate_point(r)
                vr.append(cells[cell])
                wr.append((1.0 - xi - eta, xi, eta))
            self._rec_tri_verts = torch.tensor(np.asarray(vr),
                                               device=self.device)
            self._rec_tri_w = self._t(np.asarray(wr))
            pts, w, per = np.asarray(vr).ravel(), np.asarray(wr).ravel(), 3
        else:
            pts = self.receiver_vertices.cpu().numpy()
            w, per = np.ones(pts.size), 1
        i32 = dict(dtype=torch.int32, device=self.device)
        self._receivers = kv.Receivers(
            torch.tensor(pts // cols, **i32), torch.tensor(pts % cols, **i32),
            self._t(w), per)

        if wavelet is None:
            times = self.dt * np.arange(1, self.n_steps + 1)
            wavelet = ricker_wavelet(times, peak_freq=1.0 / (20 * self.dt))
        w = torch.as_tensor(wavelet, dtype=self.dtype, device=self.device)
        self.wavelet = torch.broadcast_to(w, (self.n_steps,)).contiguous()

    # -- set-up helpers ------------------------------------------------------
    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               dtype=self.dtype, device=self.device)

    def _as(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def _nearest(self, p) -> int:
        return int(np.argmin(np.sum(
            (self.mesh.vertex_coords - np.asarray(p)) ** 2, axis=1)))

    def _boundary_saving(self, sigma, boundary_save: str) -> None:
        """The saved rectangles of the reversal + sponge reconstruction:
        "strip" every sigma > 0 vertex (the 4 bands around the sigma == 0
        rectangle), "ring" its 1-ring (2 full rows and 2 full columns
        hugging the rectangle) with the deeper sponge zeroed."""
        nyv, nxv = self._grid
        sig_g = sigma.reshape(nyv, nxv)
        zr = np.where((sig_g == 0.0).any(axis=1))[0]
        zc = np.where((sig_g == 0.0).any(axis=0))[0]
        if zr.size == 0 or zc.size == 0:
            raise ValueError("sponge_width covers the whole domain; the "
                             "reversal adjoint needs a sigma == 0 interior")
        r0, r1, c0, c1 = int(zr[0]), int(zr[-1]), int(zc[0]), int(zc[-1])
        self._sponge_rect = (r0, r1, c0, c1)
        if boundary_save == "ring":
            rects = [(r0 - 1, r0, 0, nxv), (r1 + 1, r1 + 2, 0, nxv),
                     (0, nyv, c0 - 1, c0), (0, nyv, c1 + 1, c1 + 2)]
            keep = np.ones((nyv, nxv))
            keep[sig_g > 0.0] = 0.0
            for (a, b, c, d) in rects:
                keep[a:b, c:d] = 1.0
            self._sponge_keep = self._t(keep.reshape(-1))
            self._ring = (r0 - 1, r1 + 1, c0 - 1, c1 + 1)
            if sigma[self.source_vertex] > 0.0:
                raise ValueError(
                    "boundary_save='ring' needs the source outside the "
                    "sponge (the undamped reconstruction formula re-applies "
                    "the source term at sigma == 0 points only)")
        else:
            rects = [(0, r0, 0, nxv), (r1 + 1, nyv, 0, nxv),
                     (r0, r1 + 1, 0, c0), (r0, r1 + 1, c1 + 1, nxv)]
        self._sponge_rects = [(a, b, c, d) for (a, b, c, d) in rects
                              if (b - a) > 0 and (d - c) > 0]
        self._sponge_saved_size = sum(
            (b - a) * (d - c) for (a, b, c, d) in self._sponge_rects)

    # -- boundary saving (stencil engine) ----------------------------------
    def _sponge_save(self, u_flat):
        u_g = u_flat.reshape(self._grid)
        return torch.cat([u_g[a:b, c:d].reshape(-1)
                          for (a, b, c, d) in self._sponge_rects])

    def _sponge_restore(self, u_flat, saved):
        u_g = u_flat.reshape(self._grid).clone()
        off = 0
        for (a, b, c, d) in self._sponge_rects:
            n = (b - a) * (d - c)
            u_g[a:b, c:d] = saved[off:off + n].reshape(b - a, d - c)
            off += n
        return u_g.reshape(-1)

    # -- receiver sampling -----------------------------------------------------
    def _sample(self, u):
        """Receiver traces of a flat field: nearest vertex, or P1
        barycentric interpolation at the exact locations."""
        if self.interp_receivers:
            return torch.sum(u[self._rec_tri_verts] * self._rec_tri_w,
                             dim=-1)
        return u[self.receiver_vertices]

    def _inject(self, vec, ybar_row):
        """Adjoint of :meth:`_sample` (u_bar[v_rj] += w_rj * ybar_r)."""
        if self.interp_receivers:
            return vec.index_add(0, self._rec_tri_verts.reshape(-1),
                                 (self._rec_tri_w
                                  * ybar_row[:, None]).reshape(-1))
        return vec.index_add(0, self.receiver_vertices, ybar_row)

    # -- model regularisation ------------------------------------------------
    @functools.cached_property
    def _cell_adjacency(self) -> np.ndarray:
        """(2, n_pairs) int64 indices of edge-sharing triangle pairs: each
        cell's lower and upper triangle, the lower triangle and the upper
        one of the cell below, the upper triangle and the lower one of the
        cell to the left."""
        nx, ny = self.mesh.nx, self.mesh.ny
        gi = 2 * (np.arange(ny)[:, None] * nx + np.arange(nx))
        pairs = [np.stack([gi.ravel(), gi.ravel() + 1])]
        if ny > 1:
            pairs.append(np.stack([gi[1:, :].ravel(),
                                   gi[:-1, :].ravel() + 1]))
        if nx > 1:
            pairs.append(np.stack([gi[:, 1:].ravel() + 1,
                                   gi[:, :-1].ravel()]))
        return np.concatenate(pairs, axis=1).astype(np.int64)

    @property
    def sponge_interior_cell_mask(self) -> np.ndarray:
        """Bool (n_cells,): cells whose 3 vertices all have sigma == 0 (with
        ``boundary_save="ring"`` the c2 gradient is exact there)."""
        sig_v = self._sigma_np[np.asarray(self.mesh.cells)]
        return (sig_v == 0.0).all(axis=1)

    def roughness(self, c2_cell) -> torch.Tensor:
        """Sum of squared c2 jumps across edge-sharing triangle pairs, the
        Tikhonov functional of ``reg_lambda``."""
        ia, ib = (torch.as_tensor(a, device=self.device)
                  for a in self._cell_adjacency)
        d = self._as(c2_cell)
        diff = d[ia] - d[ib]
        return torch.sum(diff * diff)

    # -- stiffness --------------------------------------------------------
    def _scales(self, c2_cell) -> torch.Tensor:
        ny, nx = self.mesh.ny, self.mesh.nx
        return ((self._det_j * self._w_sum)
                * self._as(c2_cell).reshape(ny, nx, 2))

    def stiffness_apply(self, c2_cell, u) -> torch.Tensor:
        """K(c2) u on a flat field, exact on boundary rows too, and
        differentiable in c2: the gather / class matvec / gather-sum form
        on the scatter engine, slab multiply-adds (tpuwave's grid form,
        ``_stiffness_apply_grid``) on the others."""
        return self._k_apply(c2_cell, exact=True)(self._as(u))

    def _k_apply(self, c2_cell, exact: bool = False):
        """u -> K(c2) u for one c2, its scales or planes formed once. On
        the stencil engine the plane apply, which wraps garbage onto the
        boundary rows that every step loop masks; ``exact`` takes the grid
        form there instead."""
        if self.engine == "scatter":
            scale = ((self._det_j * self._w_sum)
                     * self._as(c2_cell)).reshape(-1, 2, 1)
            conn = self._conn

            def apply(u):
                ve = conn.gather(u).reshape(-1, 2, 3)   # class pairs
                we = torch.einsum("kij,ekj->eki", self._g_class, ve)
                return conn.assemble(we * scale)
            return apply
        if self.engine == "stencil" and not exact:
            return functools.partial(self._apply_stencil_planes,
                                     self._assemble_stencil_planes(c2_cell))
        return functools.partial(self._stiffness_apply_grid,
                                 self._scales(c2_cell))

    def _stiffness_apply_grid(self, s, u) -> torch.Tensor:
        """2 classes x the nonzero (i, j) pairs of slab multiply-adds on
        (ny, nx) planes of the scales ``s``."""
        ny, nx = self.mesh.ny, self.mesh.nx
        ug = u.reshape(self._grid)
        acc = torch.zeros_like(ug)
        for k in range(2):
            sk = s[..., k]
            for i in range(3):
                oix, oiy = P1_CLASS_CORNERS[k][i]
                for j in range(3):
                    g = float(self._g_class_np[k, i, j])
                    if g == 0.0:
                        continue
                    ojx, ojy = P1_CLASS_CORNERS[k][j]
                    acc = acc + torch.nn.functional.pad(
                        g * sk * ug[ojy:ojy + ny, ojx:ojx + nx],
                        (oix, 1 - oix, oiy, 1 - oiy))
        return acc.reshape(-1)

    def _assemble_stencil_planes(self, c2_cell) -> dict:
        """{(dx, dy): (ny+1, nx+1) plane}, linear in c2 (see
        ops/stencil.py::assemble_varcoef_planes)."""
        return assemble_varcoef_planes(self._scales(c2_cell),
                                       self._g_class_np, self.mesh.ny,
                                       self.mesh.nx)

    def _apply_stencil_planes(self, planes, u):
        return apply_varcoef_planes(planes, u.reshape(self._grid)).reshape(-1)

    def _stacked_planes(self, c2_cell) -> torch.Tensor:
        """(7, ny+1, nx+1) planes in kernels_varcoef.OFFSETS order."""
        planes = self._assemble_stencil_planes(c2_cell)
        zero = torch.zeros(self._grid, dtype=self.dtype, device=self.device)
        return torch.stack([planes.get(d, zero) for d in kv.OFFSETS])

    def _planes_vjp(self, c2_cell, wbar) -> torch.Tensor:
        """c2's cotangent of the (linear) plane assembly: ``wbar`` is the
        (7, H, W) stack (kernel engine) or the plane dict (stencil)."""
        with torch.enable_grad():
            c = c2_cell.detach().requires_grad_(True)
            if isinstance(wbar, dict):
                planes = self._assemble_stencil_planes(c)
                outs = [planes[d] for d in planes]
                cots = [wbar[d] for d in planes]
            else:
                outs, cots = [self._stacked_planes(c)], [wbar]
            (g,) = torch.autograd.grad(outs, c, grad_outputs=cots)
        return g

    # -- kernel engine (B14-B17) ------------------------------------------------
    @property
    def _k(self) -> int:
        """Fused steps per kernel pass: ``steps_per_call`` (B15 and B17 run
        a pass of k steps as kernels_varcoef.fused_chunks(k) launches of at
        most 8)."""
        return self.steps_per_call

    @property
    def _kernel_damp(self):
        """(dnum, dden, keep) grids of the sponge, None without one."""
        if self._sponge_rects is None:
            return None
        return tuple(v.reshape(self._grid) for v in
                     (self._damp_num, self._damp_den, self._sponge_keep))

    def _planes9_forward(self, planes7):
        """B15's damped stack: dden-folded planes, p2 = 2 dden, pm = dden
        dnum."""
        dnum, dden, _ = self._kernel_damp
        return torch.cat([planes7 * dden[None], (2.0 * dden)[None],
                          (dden * dnum)[None]])

    def _planes9_adjoint(self, planes7):
        """B17's damped stack: plain planes, dden, dnum."""
        dnum, dden, _ = self._kernel_damp
        return torch.cat([planes7, dden[None], dnum[None]])

    def _inject_grid(self, vec_g, ybar_row):
        return self._inject(vec_g.reshape(-1), ybar_row).reshape(self._grid)

    def _ring_save(self, u_g):
        """Interface-ring values: rows (2, W), cols (H, 2)."""
        ra, rb, ca, cb = self._ring
        return (torch.stack([u_g[ra], u_g[rb]]),
                torch.stack([u_g[:, ca], u_g[:, cb]], dim=1))

    def _ring_restore(self, u_g, rows, cols):
        """Restore the saved ring (cols first, then rows)."""
        ra, rb, ca, cb = self._ring
        u_g = u_g.clone()
        u_g[:, ca], u_g[:, cb] = cols[:, 0], cols[:, 1]
        u_g[ra], u_g[rb] = rows[0], rows[1]
        return u_g

    def _propagate_kernel(self, c2_cell, src, wavelet, u0=None,
                          return_final: bool = False):
        """Forward leapfrog on the grid: the half start and single steps
        through B14, runs of k steps through B15 (source injection and
        receiver samples in the kernel)."""
        planes = self._stacked_planes(self._as(c2_cell))
        coef = self.dt * self.dt / self._det_j
        rows, cols = self._grid
        sr, sc = divmod(int(src), cols)
        u0_g = (torch.zeros(self._grid, dtype=self.dtype, device=self.device)
                if u0 is None else self._as(u0).reshape(self._grid))
        # Taylor half-start: u1 = mask(u0 - dt^2/2 M^-1 K u0) + dt^2/2 M^-1 w0
        u1 = kv.varcoef_leapfrog_step(u0_g, u0_g, planes, 0.5 * coef)
        u1[sr, sc] += 0.5 * coef * wavelet[0]
        damp3 = self._kernel_damp
        damp = None if damp3 is None else damp3[:2]
        # the source rides inside the damped update: dden at the source
        src_dden = 1.0 if damp3 is None else damp3[1][sr, sc]
        save = damp3 is not None and return_final
        traces = [self._sample(u1.reshape(-1))[None]]
        rings = [self._ring_save(u1)] if save else []
        u, up = u1, u0_g
        w_rest = wavelet[1:]
        k = self._k
        n_chunks = w_rest.shape[0] // k if k > 1 else 0
        if n_chunks:
            planes_ms = (self._planes9_forward(planes) if damp3 is not None
                         else planes)
            for ch in range(n_chunks):
                outs = kv.varcoef_leapfrog_multistep(
                    u, up, planes_ms, w_rest[ch * k:(ch + 1) * k], (sr, sc),
                    coef, self._receivers, self._ring if save else None)
                u, up = outs[0], outs[1]
                traces.append(outs[2])
                if save:
                    rings.append((outs[3], outs[4]))
        for w_n in w_rest[n_chunks * k:]:
            un = kv.varcoef_leapfrog_step(u, up, planes, coef, damp)
            un[sr, sc] += coef * w_n * src_dden
            u, up = un, u
            traces.append(self._sample(un.reshape(-1))[None])
            if save:
                rings.append(self._ring_save(un))
        traces = torch.cat(traces)
        if not return_final:
            return traces
        saves = None
        if save:
            saves = (torch.cat([r.reshape(-1, 2, cols) for r, _ in rings]),
                     torch.cat([c.reshape(-1, rows, 2) for _, c in rings]))
        return traces, (u, up, saves)

    def _adjoint_backward_kernel(self, c2_cell, src, wavelet, u_last,
                                 u_prevlast, ybar, saves=None):
        """Kernel twin of :meth:`_adjoint_backward` on the grid: runs of k
        reverse steps through B17 (last run first), the rest through B16;
        the seven plane correlations accumulate in place. Returns
        (c2_bar, wavelet_bar)."""
        c2_cell = self._as(c2_cell)
        planes = self._stacked_planes(c2_cell)
        coef = self.dt * self.dt / self._det_j
        rows, cols = self._grid
        sr, sc = divmod(int(src), cols)
        zeros = torch.zeros(self._grid, dtype=self.dtype, device=self.device)
        u_next, u_cur = u_last, u_prevlast
        lam, lpart = self._inject_grid(zeros, ybar[-1]), zeros
        wbar = torch.zeros_like(planes)
        ybar_part, w_part = ybar[:-1], wavelet[1:]
        damp3 = self._kernel_damp
        has_sponge = saves is not None and damp3 is not None
        m = ybar_part.shape[0]
        if has_sponge:
            dnum_g, dden_g, keep_g = damp3
            # row i = saved ring of u_i (row 0: the zero start)
            rows_all, cols_all = saves
            rows_xs = torch.cat([torch.zeros_like(rows_all[:1]),
                                 rows_all[:-2]])[:m]
            cols_xs = torch.cat([torch.zeros_like(cols_all[:1]),
                                 cols_all[:-2]])[:m]
        wav = torch.empty(m, dtype=self.dtype, device=self.device)
        k = self._k
        n_chunks, rem = divmod(m, k) if k > 1 else (0, m)
        if n_chunks:
            planes_ms = self._planes9_adjoint(planes) if has_sponge else planes
            points = (self._receivers.rows, self._receivers.cols)
            for ch in reversed(range(n_chunks)):
                lo, hi = rem + ch * k, rem + (ch + 1) * k
                yb = ybar_part[lo:hi]
                inj = ((yb[:, :, None] * self._rec_tri_w[None]).reshape(k, -1)
                       if self.interp_receivers else yb)
                ring = ((self._ring, rows_xs[lo:hi].flip(0).contiguous(),
                         cols_xs[lo:hi].flip(0).contiguous())
                        if has_sponge else (None, None, None))
                u_next, u_cur, lam, lpart, wbar, wavbar = \
                    kv.varcoef_adjoint_multistep(
                        u_next, u_cur, lam, lpart, planes_ms, wbar,
                        w_part[lo:hi].flip(0).contiguous(),
                        inj.flip(0).contiguous(), (sr, sc), coef, points,
                        *ring)
                wav[lo:hi] = wavbar.flip(0)
        for i in reversed(range(rem)):
            lam_next = dden_g * lam if has_sponge else lam
            wav[i] = coef * lam_next[sr, sc]
            u_prev, lam_cur, lp_new, wbar = kv.varcoef_adjoint_step(
                u_next, u_cur, lam_next, lpart, planes, wbar, coef)
            if has_sponge:
                # exact damped-leapfrog transpose; ring boundary saving
                lp_new = dnum_g * lp_new
                u_prev = self._ring_restore(u_prev * keep_g, rows_xs[i],
                                            cols_xs[i])
            u_prev[sr, sc] += coef * w_part[i]
            u_next, u_cur, lam, lpart = (u_cur, u_prev,
                                         self._inject_grid(lam_cur,
                                                           ybar_part[i]),
                                         lp_new)
        wav_0 = 0.5 * coef * lam[sr, sc]
        wavelet_bar = torch.cat([wav_0[None], wav])
        return self._planes_vjp(c2_cell, wbar), wavelet_bar

    # -- the plain step loop (stencil, grid and scatter engines) ------------
    def _src_index(self, src) -> torch.Tensor:
        """(S,) int64 vertex ids of a source id or a sequence of them."""
        return torch.as_tensor(np.asarray(src, np.int64).reshape(-1),
                               device=self.device)

    def _propagate(self, c2_cell, src, wavelet, u0=None,
                   return_final: bool = False):
        """Core leapfrog loop over (c2_cell, src, wavelet, u0). ``src`` is a
        vertex id with an (n_steps,) wavelet, or S ids with an (n_steps,
        S) wavelet (repeated ids add up). With ``remat``, where autograd
        records the loop, each step runs under torch.utils.checkpoint."""
        if self.engine == "kernel":
            return self._propagate_kernel(c2_cell, src, wavelet, u0,
                                          return_final)
        dt2 = self.dt * self.dt
        c2 = self._as(c2_cell)
        k_apply = self._k_apply(c2)
        src_idx = self._src_index(src)

        def forced_accel(u, w_n):
            f = (-k_apply(u)).index_add(0, src_idx, w_n.reshape(-1))
            return f * self._inv_lumped

        def step(u, u_prev, w_n):
            u_next = (2.0 * u - self._damp_num * u_prev
                      + dt2 * forced_accel(u, w_n)) * self._damp_den
            u_next = u_next * self._interior
            return u_next, self._sample(u_next)

        u0 = (torch.zeros(self.n_vertices, dtype=self.dtype,
                          device=self.device) if u0 is None
              else self._as(u0).reshape(-1))
        u1 = (u0 + 0.5 * dt2 * forced_accel(u0, wavelet[0])) * self._interior
        save = self._sponge_rects is not None and return_final
        # checkpoint only where autograd records the loop
        ckpt = self.remat and torch.is_grad_enabled() and any(
            t.requires_grad for t in (c2, wavelet, u0))
        traces = [self._sample(u1)]
        strips = [self._sponge_save(u1)] if save else []
        u, u_prev = u1, u0
        for w_n in wavelet[1:]:
            if ckpt:
                # the step draws no random numbers: keeping the RNG state
                # would read the device's each step
                u_next, tr = _checkpoint(step, u, u_prev, w_n,
                                         use_reentrant=False,
                                         preserve_rng_state=False)
            else:
                u_next, tr = step(u, u_prev, w_n)
            traces.append(tr)
            if save:
                strips.append(self._sponge_save(u_next))
            u, u_prev = u_next, u
        traces = torch.stack(traces)
        if not return_final:
            return traces
        return traces, (u, u_prev, (torch.stack(strips),) if save else None)

    def _adjoint_backward(self, c2_cell, src, wavelet, u_last, u_prevlast,
                          ybar, saves=None):
        """Hand-written reverse pass of :meth:`_propagate` (stencil engine,
        zero start): a reverse-time loop that (a) reconstructs u_{k-1} from
        (u_{k+1}, u_k) -- with a sponge the saved strip or ring overwrites
        the damped region --, (b) propagates the adjoint field lambda
        driven by the receiver cotangents (the exact damped-leapfrog
        transpose), (c) accumulates the plane correlations
        W_d = -sum_k mu_{k+1} shift(u_k, d), chained through the plane
        assembly to dJ/dc2. Returns (c2_bar, wavelet_bar), the latter of
        ``wavelet``'s shape."""
        c2_cell = self._as(c2_cell)
        dt2 = self.dt * self.dt
        planes = self._assemble_stencil_planes(c2_cell)
        interior, inv_m = self._interior, self._inv_lumped
        keep = self._sponge_keep
        has_sponge = saves is not None and self._sponge_rects is not None
        bden = interior * self._damp_den if has_sponge else interior
        src_idx = self._src_index(src)

        def k_apply(u):
            return self._apply_stencil_planes(planes, u)

        n = self.n_steps
        zero_v = torch.zeros(self.n_vertices, dtype=self.dtype,
                             device=self.device)
        lam = self._inject(zero_v, ybar[-1])
        lam_partial = zero_v
        u_next, u_cur = u_last, u_prevlast
        wbar = {d: torch.zeros(self._grid, dtype=self.dtype,
                               device=self.device) for d in planes}
        if has_sponge:
            (strips,) = saves
            strip_xs = torch.cat([torch.zeros_like(strips[:1]),
                                  strips[:-2]])[:n - 1]
        wav = torch.empty((n - 1, src_idx.numel()), dtype=self.dtype,
                          device=self.device)
        for i in reversed(range(n - 1)):
            blam = bden * lam
            mu = dt2 * inv_m * blam
            lam_cur = self._inject(lam_partial + 2.0 * blam - k_apply(mu),
                                   ybar[i])
            lam_prev_partial = (-(self._damp_num * blam) if has_sponge
                                else -blam)
            f = (-k_apply(u_cur)).index_add(0, src_idx,
                                            wavelet[i + 1].reshape(-1))
            u_prev = interior * (2.0 * u_cur - u_next + dt2 * inv_m * f)
            if has_sponge:
                if keep is not None:
                    u_prev = u_prev * keep
                u_prev = self._sponge_restore(u_prev, strip_xs[i])
            mu_g = mu.reshape(self._grid)
            u_g = u_cur.reshape(self._grid)
            wbar = {d: wbar[d] - mu_g * torch.roll(u_g, (-d[1], -d[0]),
                                                   (0, 1))
                    for d in wbar}
            wav[i] = mu[src_idx]
            u_next, u_cur, lam, lam_partial = (u_cur, u_prev, lam_cur,
                                               lam_prev_partial)
        # u_1 = B(dt^2/2 M^-1 w_0 e_src): only the wavelet depends
        wav_0 = 0.5 * dt2 * (inv_m * (interior * lam))[src_idx]
        wavelet_bar = torch.cat([wav_0[None], wav]).reshape(wavelet.shape)
        return self._planes_vjp(c2_cell, wbar), wavelet_bar

    # -- forward model --------------------------------------------------------
    def _sim(self, c2, src, wavelet) -> torch.Tensor:
        """Traces of one propagation through the configured adjoint: the
        reconstruction backward pass, or autograd through the step loop."""
        if self.adjoint == "reversal":
            return _ReversalSim.apply(c2, wavelet, self, src)
        return self._propagate(c2, src, wavelet)

    def simulate(self, c2_cell, u0=None, wavelet=None) -> torch.Tensor:
        """Receiver traces (n_steps, n_rec), differentiable in c2_cell and
        the wavelet through the configured adjoint. u'(0) = 0; the first
        step is the Taylor start u^1 = u^0 + dt^2/2 M_L^{-1} (w_0 e_src -
        K u^0). With ``u0`` (a non-zero start, which the reversal adjoint
        does not cover) the reversal run is forward only; the remat run
        stays differentiable."""
        w = self.wavelet if wavelet is None else self._as(wavelet)
        c2 = self._as(c2_cell)
        if u0 is None:
            return self._sim(c2, self.source_vertex, w)
        if self.adjoint == "reversal":
            with torch.no_grad():
                return self._propagate(c2, self.source_vertex, w, u0)
        return self._propagate(c2, self.source_vertex, w, u0)

    def snap_vertices(self, points) -> torch.Tensor:
        """Nearest-vertex ids (int64) for a list of (x, y) points."""
        return torch.tensor([self._nearest(p) for p in points],
                            dtype=torch.int64)

    def _shot_wavelets(self, n_src: int, wavelets) -> torch.Tensor:
        if wavelets is None:
            return self.wavelet.expand(n_src, self.n_steps)
        return self._as(wavelets)

    @staticmethod
    def _ids(sources) -> list:
        return [int(s) for s in np.asarray(
            torch.as_tensor(sources).cpu()).reshape(-1)]

    def simulate_shots(self, c2_cell, sources, wavelets=None) -> torch.Tensor:
        """Independent shots, one after the other -> (S, n_steps, n_rec).
        ``sources``: (S,) vertex ids (:meth:`snap_vertices`); ``wavelets``:
        (S, n_steps) per-shot time series (default: this problem's)."""
        srcs = self._ids(sources)
        ws = self._shot_wavelets(len(srcs), wavelets)
        c2 = self._as(c2_cell)
        return torch.stack([self._sim(c2, s, ws[i])
                            for i, s in enumerate(srcs)])

    def misfit_shots(self, c2_cell, sources, observed, wavelets=None,
                     kind: str = "l2", huber_delta: float = 1.0):
        """Misfit over the multi-shot gather (see :func:`trace_misfit`)."""
        return trace_misfit(self.simulate_shots(c2_cell, sources, wavelets),
                            self._as(observed), kind,
                            huber_delta=huber_delta)

    # -- source encoding (simultaneous-source / supershot FWI) ---------------
    def simulate_supershot(self, c2_cell, sources, codes,
                           wavelets=None) -> torch.Tensor:
        """One propagation with all sources firing at once, source s
        scaled by ``codes[s]`` -> (n_steps, n_rec): the encoded-source
        trick (Krebs et al. 2009). The injection is linear in the force,
        so an S-source supershot costs one single-shot simulation; with
        random +-1 codes redrawn per iteration the expected encoded misfit
        is the sum of the per-shot misfits plus a model-independent
        constant. ``sources``: (S,) vertex ids; ``codes``: (S,) weights;
        ``wavelets``: optional (S, n_steps) series. Differentiable in
        (c2_cell, codes, wavelets) on every engine but "kernel", whose
        fused kernels inject a single source."""
        if self.engine == "kernel":
            raise ValueError("simulate_supershot needs engine in "
                             f"{_PLAIN_ENGINES}; the fused kernel engine "
                             "('kernel') injects a single source")
        srcs = tuple(self._ids(sources))
        codes = self._as(codes)
        ws = self._shot_wavelets(len(srcs), wavelets)
        wmat = (ws.T * codes[None, :]).contiguous()     # (n_steps, S)
        return self._sim(self._as(c2_cell), srcs, wmat)

    def misfit_encoded(self, c2_cell, sources, codes, observed,
                       wavelets=None) -> torch.Tensor:
        """0.5 ||supershot(c2; codes) - sum_s codes_s observed_s||^2, whose
        Rademacher expectation is ``misfit_shots`` plus a constant;
        ``observed`` is the (S, n_steps, n_rec) per-shot gather."""
        codes = self._as(codes)
        d_enc = torch.einsum("s,snr->nr", codes, self._as(observed))
        r = self.simulate_supershot(c2_cell, sources, codes, wavelets) - d_enc
        return 0.5 * torch.sum(r * r)

    def invert_encoded(self, observed, c2_init, *, sources, key,
                       n_iter: int = 50, learning_rate: float = 0.1,
                       bounds: Optional[Tuple[float, float]] = None,
                       wavelets=None, reg_lambda: float = 0.0,
                       redraw_every: int = 1,
                       verbose: bool = False) -> FwiResult:
        """Stochastic encoded-source Adam descent: fresh +-1 codes every
        ``redraw_every`` iterations (``key, sub = split(key)``, then
        ``rademacher(sub, S)``, as tpuwave draws them with jax.random:
        ``key`` is its raw key's two words or an int seed,
        ``utils/prng.py``), each step on the S-times cheaper
        :meth:`misfit_encoded`. The misfits are the encoded values."""
        observed = self._as(observed)
        srcs = self._ids(sources)
        key = prng.key_words(key)
        c2 = self._as(c2_init).detach().clone().requires_grad_(True)
        opt = torch.optim.Adam([c2], lr=learning_rate, betas=(0.9, 0.999),
                               eps=1e-8)
        misfits = np.empty(n_iter)
        codes = None
        for i in range(n_iter):
            if codes is None or i % max(1, redraw_every) == 0:
                key, sub = prng.split(key)
                codes = prng.rademacher(sub, len(srcs), self.dtype,
                                        self.device)
            opt.zero_grad(set_to_none=True)
            with torch.enable_grad():
                val = self.misfit_encoded(c2, srcs, codes, observed,
                                          wavelets)
                if reg_lambda > 0.0:
                    val = val + reg_lambda * self.roughness(c2)
                val.backward()
            opt.step()
            if bounds is not None:
                with torch.no_grad():
                    c2.clamp_(bounds[0], bounds[1])
            misfits[i] = float(val.detach())
            if verbose:
                print(f"iter {i:3d}  encoded misfit {misfits[i]:.6e}")
        return FwiResult(c2=c2.detach(), misfits=misfits, wavelet=None)

    # -- Born modelling / RTM / least-squares migration ---------------------
    def _plain_only(self, what: str, why: str) -> None:
        if self.engine == "kernel":
            raise ValueError(f"{what} needs engine in {_PLAIN_ENGINES}; "
                             f"{why}")

    def _data_map(self, c2, sources=None, wavelets=None) -> torch.Tensor:
        """The model -> data map at ``c2``: single-shot (n_steps, n_rec)
        or multi-shot (S, n_steps, n_rec) traces."""
        if sources is None:
            return self.simulate(c2)
        return self.simulate_shots(c2, sources, wavelets)

    def _vjp(self, c2_cell, cotangent, sources=None, wavelets=None):
        """(data map at c2, its VJP of ``cotangent(traces)``)."""
        c2 = self._as(c2_cell).detach().requires_grad_(True)
        with torch.enable_grad():
            out = self._data_map(c2, sources, wavelets)
            ct = cotangent(out.detach())
            (g,) = torch.autograd.grad(out, c2, grad_outputs=ct)
        return out.detach(), g

    def born(self, c2_cell, dc2_cell, sources=None,
             wavelets=None) -> torch.Tensor:
        """Linearized (Born) modelling: the directional derivative
        d(traces)/d(c2) . dc2_cell at the background ``c2_cell``, what
        forward-mode AD of the plain step loop computes (tpuwave's
        jax.jvp), so not on the kernel engine. K is linear in c2, so the
        derivative of K(c2) u along dm is K(c2) du + K(dm) u: the tangent
        recurrence runs beside the step loop, three K applies a step."""
        self._plain_only("born", "the fused kernels (engine='kernel') have "
                         "no JVP rule")
        c2 = self._as(c2_cell).detach()
        dm = self._as(dc2_cell).detach()
        with torch.no_grad():
            if sources is None:
                return self._born(c2, dm, self.source_vertex, self.wavelet)
            srcs = self._ids(sources)
            ws = self._shot_wavelets(len(srcs), wavelets)
            return torch.stack([self._born(c2, dm, s, ws[i])
                                for i, s in enumerate(srcs)])

    def _born(self, c2, dm, src, wavelet) -> torch.Tensor:
        """Born traces of one shot from a zero start: u and its tangent du
        stepped together (du^1 = 0, as u^0 = 0)."""
        dt2 = self.dt * self.dt
        k_apply, dk_apply = self._k_apply(c2), self._k_apply(dm)
        src_idx = self._src_index(src)
        num, den, interior = self._damp_num, self._damp_den, self._interior
        u_prev = torch.zeros(self.n_vertices, dtype=self.dtype,
                             device=self.device)
        f = (-k_apply(u_prev)).index_add(0, src_idx, wavelet[0].reshape(-1))
        u = (u_prev + 0.5 * dt2 * (f * self._inv_lumped)) * interior
        du, du_prev = torch.zeros_like(u), torch.zeros_like(u)
        traces = [self._sample(du)]
        for w_n in wavelet[1:]:
            f = (-k_apply(u)).index_add(0, src_idx, w_n.reshape(-1))
            u_next = (2.0 * u - num * u_prev
                      + dt2 * (f * self._inv_lumped)) * den * interior
            df = -(dk_apply(u) + k_apply(du))
            du_next = (2.0 * du - num * du_prev
                       + dt2 * (df * self._inv_lumped)) * den * interior
            traces.append(self._sample(du_next))
            u, u_prev, du, du_prev = u_next, u, du_next, du
        return torch.stack(traces)

    def migrate(self, c2_cell, data, sources=None,
                wavelets=None) -> torch.Tensor:
        """Adjoint of :meth:`born`, the RTM operator L^T d: the VJP of the
        configured data map (on the kernel engine B14-B17's time
        reversal), a per-cell image."""
        data = self._as(data)
        return self._vjp(c2_cell, lambda _: data, sources, wavelets)[1]

    def rtm_image(self, c2_cell, observed, sources=None, wavelets=None,
                  normalize: Optional[str] = "illumination",
                  precond_eps: float = 1e-3) -> torch.Tensor:
        """Reverse-time-migration image of ``observed`` over the smooth
        background ``c2_cell``; ``normalize="illumination"`` divides by
        (I + precond_eps max I) (:meth:`illumination`), ``None`` returns
        the raw L^T d."""
        img = self.migrate(c2_cell, observed, sources, wavelets)
        if normalize is None:
            return img
        if normalize != "illumination":
            raise ValueError(f"unknown normalize {normalize!r}")
        illum = self.illumination(c2_cell, sources=sources,
                                  wavelets=wavelets)
        return img / (illum + precond_eps * torch.max(illum))

    def lsrtm(self, c2_cell, observed, *, n_iter: int = 10, sources=None,
              wavelets=None, verbose: bool = False):
        """Least-squares RTM: min_m 0.5 ||L m - d||^2 by CGLS, one Born
        modelling and one migration per iteration. Returns (m,
        residual_norms), residual_norms[k] = ||d - L m_k||."""
        self._plain_only("lsrtm", "Born modeling has no JVP rule on the "
                         "fused kernel engine ('kernel')")
        c2 = self._as(c2_cell)
        d = self._as(observed)

        def L(m):
            return self.born(c2, m, sources, wavelets)

        def Lt(r):
            return self.migrate(c2, r, sources, wavelets)

        m = torch.zeros(self.n_cells, dtype=self.dtype, device=self.device)
        r = d
        s = Lt(r)
        p = s
        gamma = torch.sum(s * s)
        norms = [float(torch.sqrt(torch.sum(r * r)))]
        for k in range(n_iter):
            q = L(p)
            alpha = gamma / torch.sum(q * q)
            m = m + alpha * p
            r = r - alpha * q
            norms.append(float(torch.sqrt(torch.sum(r * r))))
            if verbose:
                print(f"lsrtm iter {k:3d}  ||r|| {norms[-1]:.6e}")
            s = Lt(r)
            gamma_new = torch.sum(s * s)
            p = s + (gamma_new / gamma) * p
            gamma = gamma_new
        return m, np.asarray(norms)

    def gauss_newton_hvp(self, c2_cell, v, sources=None, wavelets=None,
                         damping: float = 0.0) -> torch.Tensor:
        """(J^T J + damping I) v at ``c2_cell``, J = d(traces)/d(c2): one
        Born modelling and one migration."""
        v = self._as(v)
        hv = self.migrate(c2_cell, self.born(c2_cell, v, sources, wavelets),
                          sources, wavelets)
        if damping:
            hv = hv + damping * v
        return hv

    def invert_gauss_newton(self, observed, c2_init, *, n_outer: int = 5,
                            n_cg: int = 5, damping: float = 0.0,
                            step: float = 1.0,
                            bounds: Optional[Tuple[float, float]] = None,
                            sources=None, wavelets=None,
                            verbose: bool = False) -> FwiResult:
        """Truncated Gauss-Newton FWI (Levenberg-Marquardt for ``damping``
        > 0): each outer iteration solves (J^T J + damping I) p = -g by
        ``n_cg`` CG iterations from p = 0 with :meth:`gauss_newton_hvp`
        and sets c2 <- clip(c2 + step p). Returns the per-outer-iteration
        misfits."""
        self._plain_only("invert_gauss_newton", "Born modeling has no JVP "
                         "rule on the fused kernel engine ('kernel')")
        d = self._as(observed)
        c2 = self._as(c2_init)
        misfits = np.empty(n_outer)
        for k in range(n_outer):
            sim, g = self._vjp(c2, lambda out: out - d, sources, wavelets)
            r = sim - d
            misfits[k] = float(0.5 * torch.sum(r * r))
            if verbose:
                print(f"gn outer {k:3d}  misfit {misfits[k]:.6e}")
            p = torch.zeros_like(c2)
            r = -g
            q = r
            rho = torch.sum(r * r)
            for _ in range(n_cg):
                hq = self.gauss_newton_hvp(c2, q, sources, wavelets,
                                           damping=damping)
                alpha = rho / torch.sum(q * hq)
                p = p + alpha * q
                r = r - alpha * hq
                rho_new = torch.sum(r * r)
                q = r + (rho_new / rho) * q
                rho = rho_new
            c2 = c2 + step * p
            if bounds is not None:
                c2 = torch.clamp(c2, bounds[0], bounds[1])
        return FwiResult(c2=c2, misfits=misfits, wavelet=None)

    # -- illumination / gradient preconditioning -----------------------------
    def illumination(self, c2_cell, sources=None,
                     wavelets=None) -> torch.Tensor:
        """Per-cell source illumination I_e = sum_k mean_v u_k[v]^2 (v over
        the cell's 3 vertices; summed over shots with ``sources``), the
        diagonal pseudo-Hessian proxy of classic FWI. On every engine the
        plain stencil-plane forward in torch ops, as in tpuwave; a
        constant (no gradient)."""
        dt2 = self.dt * self.dt
        with torch.no_grad():
            planes = self._assemble_stencil_planes(self._as(c2_cell))

            def one(src, w):
                src_idx = self._src_index(src)

                def accel(u, w_n):
                    f = (-self._apply_stencil_planes(planes, u)).index_add(
                        0, src_idx, w_n.reshape(-1))
                    return f * self._inv_lumped

                u0 = torch.zeros(self.n_vertices, dtype=self.dtype,
                                 device=self.device)
                u = (u0 + 0.5 * dt2 * accel(u0, w[0])) * self._interior
                u_prev, acc = u0, u * u
                for w_n in w[1:]:
                    u_next = (2.0 * u - self._damp_num * u_prev
                              + dt2 * accel(u, w_n)) * self._damp_den
                    u_next = u_next * self._interior
                    u, u_prev, acc = u_next, u, acc + u_next * u_next
                return acc

            if sources is None:
                acc = one(self.source_vertex, self.wavelet)
            else:
                srcs = self._ids(sources)
                ws = self._shot_wavelets(len(srcs), wavelets)
                acc = torch.stack([one(s, ws[i])
                                   for i, s in enumerate(srcs)]).sum(0)
            return acc[self._cells].mean(1)

    # -- inversion ----------------------------------------------------------
    def misfit(self, c2_cell, observed, wavelet=None, kind: str = "l2",
               huber_delta: float = 1.0):
        """Single-shot data misfit (default 0.5 ||r||^2)."""
        return trace_misfit(self.simulate(c2_cell, wavelet=wavelet),
                            self._as(observed), kind,
                            huber_delta=huber_delta)

    def misfit_and_grad(self, c2_cell, observed):
        """(misfit, dmisfit/dc2_cell), both detached tensors."""
        c2 = self._as(c2_cell).detach().requires_grad_(True)
        with torch.enable_grad():
            val = self.misfit(c2, observed)
            (g,) = torch.autograd.grad(val, c2)
        return val.detach(), g

    def invert(self, observed, c2_init, *, n_iter: int = 50,
               learning_rate: float = 0.1,
               bounds: Optional[Tuple[float, float]] = None,
               sources=None, wavelet=None, wavelets=None,
               estimate_wavelet: bool = False, wavelet_init=None,
               optimizer: str = "adam", reg_lambda: float = 0.0,
               precondition: Optional[str] = None,
               precond_eps: float = 1e-3,
               misfit_kind: str = "l2", huber_delta: float = 1.0,
               checkpoint: Optional[str] = None,
               checkpoint_every: int = 10,
               verbose: bool = False) -> FwiResult:
        """Descent on the misfit with the box ``bounds`` projection of c2
        after every step. ``reg_lambda`` adds ``reg_lambda *
        roughness(c2)``; ``misfit_kind`` selects the data functional; with
        ``sources`` the (S, n_steps, n_rec) gather is fitted shot by shot
        (``wavelets`` (S, n_steps), or ``wavelet`` for every shot).
        ``estimate_wavelet`` co-estimates one shared source time series
        from ``wavelet_init`` (default: this problem's); the projection
        applies to c2 only. The misfit history holds each iteration's
        value before its update.

        ``optimizer``: "adam" (``torch.optim.Adam``: beta (0.9, 0.999),
        eps 1e-8, optax's defaults, step ``learning_rate``) or "lbfgs"
        (``solve/lbfgs.py``: optax's ``lbfgs()``, memory 10, zoom line
        search; ``learning_rate`` is ignored; an iteration's misfit is the
        line search's last value, at the step before the projection).
        ``precondition="illumination"`` (Adam only) divides the c2
        gradient by (I + precond_eps max I), I the :meth:`illumination`
        at ``c2_init``.

        ``checkpoint``: path of a single .npz snapshot (model, optimizer
        state, misfit history; utils/checkpoint.py) written every
        ``checkpoint_every`` iterations and at the end; if the file
        already exists the descent resumes from it (``n_iter`` counts
        total iterations). The optimizer state is written as the leaves
        of tpuwave's optax state (Adam: ``count`` as int32, then the first
        moments, then the second moments, each in parameter order;
        L-BFGS: ``Lbfgs.leaves``), so a snapshot written by either
        package resumes in the other."""
        if estimate_wavelet and (wavelets is not None or wavelet is not None):
            raise ValueError("estimate_wavelet=True estimates one shared "
                             "wavelet; drop the fixed `wavelet(s)` argument")
        if precondition not in (None, "illumination"):
            raise ValueError(f"unknown precondition {precondition!r}")
        if precondition == "illumination" and optimizer != "adam":
            raise ValueError("precondition='illumination' needs "
                             "optimizer='adam' (a scaled gradient breaks "
                             "the L-BFGS line search)")
        if optimizer not in ("adam", "lbfgs"):
            raise ValueError(f"unknown optimizer {optimizer!r}")
        observed = self._as(observed)
        fixed_w = None if wavelet is None else self._as(wavelet)

        def loss(c2, w_est):
            w = w_est if w_est is not None else fixed_w
            if sources is None:
                val = self.misfit(c2, observed, wavelet=w, kind=misfit_kind,
                                  huber_delta=huber_delta)
            else:
                n_src = torch.as_tensor(sources).numel()
                ws = wavelets
                if ws is None:
                    ws = (self.wavelet if w is None else w).expand(
                        n_src, self.n_steps)
                val = self.misfit_shots(c2, sources, observed, ws,
                                        kind=misfit_kind,
                                        huber_delta=huber_delta)
            if reg_lambda > 0.0:
                val = val + reg_lambda * self.roughness(c2)
            return val

        params = [self._as(c2_init).detach().clone()]
        if estimate_wavelet:
            params.append((self.wavelet if wavelet_init is None
                           else self._as(wavelet_init)).detach().clone())
        g_scale = None
        if precondition == "illumination":
            illum = self.illumination(params[0], sources=sources,
                                      wavelets=wavelets)
            g_scale = 1.0 / (illum + precond_eps * torch.max(illum))
        if optimizer == "adam":
            step, opt_leaves, restore, n_leaves = self._adam_steps(
                loss, params, learning_rate, bounds, g_scale)
        else:
            step, opt_leaves, restore, n_leaves = self._lbfgs_steps(
                loss, params, bounds)
        misfits = np.empty(n_iter)
        start = 0
        if checkpoint is not None:
            ck = load_inversion(checkpoint)
            if ck is not None:
                n_done, hist, p_leaves, o_leaves = ck
                if (len(p_leaves) != len(params)
                        or len(o_leaves) != n_leaves):
                    raise ValueError(
                        f"checkpoint {checkpoint} does not match this "
                        "inversion configuration (different optimizer or "
                        "estimate_wavelet setting)")
                restore(p_leaves, o_leaves)
                start = min(n_done, n_iter)
                misfits[:start] = hist[:start]
                if verbose:
                    print(f"resumed from {checkpoint} at iteration {start}")
        for i in range(start, n_iter):
            misfits[i] = step()
            if verbose:
                print(f"iter {i:3d}  misfit {misfits[i]:.6e}")
            if checkpoint is not None and ((i + 1) % checkpoint_every == 0
                                           or i + 1 == n_iter):
                save_inversion(checkpoint, i + 1, misfits[:i + 1], params,
                               opt_leaves())
        return FwiResult(c2=params[0].detach(), misfits=misfits,
                         wavelet=(params[1].detach() if estimate_wavelet
                                  else None))

    def _adam_steps(self, loss, params, learning_rate, bounds, g_scale):
        """(step, leaves, restore, number of leaves) of Adam over
        ``params`` (updated in place); ``step()`` returns the misfit before
        its update."""
        for q in params:
            q.requires_grad_(True)
        opt = torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                               eps=1e-8)

        def step() -> float:
            opt.zero_grad(set_to_none=True)
            with torch.enable_grad():
                val = loss(*params, *([None] * (2 - len(params))))
                val.backward()
            if g_scale is not None:
                params[0].grad.mul_(g_scale)
            opt.step()
            if bounds is not None:
                with torch.no_grad():
                    params[0].clamp_(bounds[0], bounds[1])
            return float(val.detach())

        return (step, lambda: _adam_leaves(opt, params),
                lambda p_leaves, o_leaves: _restore_adam(opt, params,
                                                         p_leaves, o_leaves),
                1 + 2 * len(params))

    def _lbfgs_steps(self, loss, params, bounds):
        """(step, leaves, restore, number of leaves) of optax's L-BFGS over
        ``params`` (replaced in place in the list)."""
        opt = Lbfgs(params)

        def vg(ps):
            leaves = [q.detach().requires_grad_(True) for q in ps]
            with torch.enable_grad():
                val = loss(*leaves, *([None] * (2 - len(leaves))))
                grads = torch.autograd.grad(val, leaves)
            return float(val.detach()), [g.detach() for g in grads]

        def step() -> float:
            val, g = opt.value_and_grad(params, vg)
            updates = opt.update(g, params, val, vg)
            params[:] = [q + u for q, u in zip(params, updates)]
            if bounds is not None:
                params[0] = torch.clamp(params[0], bounds[0], bounds[1])
            return float(val)

        def restore(p_leaves, o_leaves):
            params[:] = [torch.as_tensor(np.asarray(a)).to(q)
                         for a, q in zip(p_leaves, params)]
            opt.load_leaves(o_leaves)

        return step, opt.leaves, restore, opt.n_leaves()

    def invert_multiscale(self, observed, c2_init, *, cutoffs,
                          n_iter=50, learning_rate: float = 0.1,
                          bounds: Optional[Tuple[float, float]] = None,
                          sources=None, optimizer: str = "adam",
                          reg_lambda: float = 0.0,
                          precondition: Optional[str] = None,
                          misfit_kind: str = "l2",
                          huber_delta: float = 1.0,
                          verbose: bool = False) -> FwiResult:
        """Frequency-continuation FWI (Bunks et al. 1995): :meth:`invert`
        over the low-pass ``cutoffs`` (Hz, ascending; None is the
        unfiltered band), the observed data and the source wavelet
        filtered to each stage's band (:func:`lowpass_time`), each stage
        warm-started from the last. ``n_iter`` is one count or one per
        stage. Returns the last stage's model and every stage's misfits,
        concatenated."""
        observed = self._as(observed)
        c2 = self._as(c2_init)
        if isinstance(n_iter, (list, tuple)):
            if len(n_iter) != len(cutoffs):
                raise ValueError("need one n_iter per cutoff stage")
            iters = list(n_iter)
        else:
            iters = [n_iter] * len(cutoffs)
        histories = []
        for k, fc in enumerate(cutoffs):
            if fc is None:
                d_k, w_k = observed, None
            else:
                d_k = lowpass_time(observed, self.dt, fc, axis=-2)
                w_k = lowpass_time(self.wavelet, self.dt, fc)
            if verbose:
                print(f"stage {k}: cutoff "
                      f"{'full band' if fc is None else f'{fc:g} Hz'}")
            res = self.invert(d_k, c2, n_iter=iters[k],
                              learning_rate=learning_rate, bounds=bounds,
                              sources=sources, wavelet=w_k,
                              wavelets=None, optimizer=optimizer,
                              reg_lambda=reg_lambda,
                              precondition=precondition,
                              misfit_kind=misfit_kind,
                              huber_delta=huber_delta, verbose=verbose)
            c2 = res.c2
            histories.append(res.misfits)
        return FwiResult(c2=c2, misfits=np.concatenate(histories))
