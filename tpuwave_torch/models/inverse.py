"""Differentiable wave propagation and full-waveform inversion (FWI).

Port of tpuwave/models/inverse.py's time-reversal path. The forward model
(P1 FEM, lumped-mass leapfrog, homogeneous Dirichlet walls or an absorbing
sponge)

    M_L u''  +  K(c2) u = w(t) e_src,     u|dOmega = 0,   u(0)=u0, u'(0)=0

is a function of the per-cell squared wave speed ``c2_cell`` and of the
source wavelet; the misfit's gradient comes from the hand-written
adjoint-state method: the backward pass RECONSTRUCTS the forward states by
running the time-reversible leapfrog backwards from the final pair, so
memory is O(1) in the step count (with a sponge the forward pass saves the
interface ring, "boundary saving"). It is a ``torch.autograd.Function``,
so ``torch.autograd`` chains it with the misfit and the optimizer.

Leapfrog recurrence (models/fast.py::leapfrog_step with varying c):

    u^{n+1} = 2 u^n - u^{n-1} + dt^2 M_L^{-1} (w_n e_src - K u^n)

Two engines, one algebra:

- ``"kernel"`` (default; tpuwave's ``"pallas"``): the fused CUDA kernels
  B14-B17 of ``ops/kernels_varcoef.py`` on the true (ny+1, nx+1) grid, up
  to ``steps_per_call`` steps per kernel pass in both directions;
- ``"stencil"``: the same recurrence on flat vectors with the assembled
  coefficient planes and ``torch.roll`` -- the plain twin of the kernel
  engine, tpuwave's ``engine="stencil"``.

On a CPU device the kernel engine's wrappers run their plain versions.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from tpuwave_torch.config import DEFAULT_DTYPE, resolve_device
from tpuwave_torch.core.mesh import FeSpace, StructuredTriMesh
from tpuwave_torch.core.quadrature import gauss_simplex
from tpuwave_torch.ops import kernels_varcoef as kv
from tpuwave_torch.ops.stencil import (P1_CLASS_CORNERS,
                                       apply_varcoef_planes,
                                       assemble_varcoef_planes)
from tpuwave_torch.utils.checkpoint import load_inversion, save_inversion

__all__ = ["FwiProblem", "FwiResult", "ricker_wavelet", "lowpass_time",
           "envelope_time", "trace_misfit"]

_A12 = "(ROADMAP A12: not ported yet)"


def _not_ported(what: str):
    raise NotImplementedError(f"{what} {_A12}")


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
    (tpuwave: the ``jax.custom_vjp`` of ``_reversal_sim``). Forward saves
    (c2, wavelet, u_last, u_prevlast[, boundary saves]); backward returns
    c2's cotangent through the VJP of the linear plane assembly and the
    wavelet's; the source index gets none."""

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
    """Differentiable forward model, time-reversal gradients and the
    inversion loop (port of tpuwave's ``FwiProblem``).

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
    sponge_width, sponge_strength : absorbing layer along the walls
        (sigma = strength * q^2, q ramping 0 -> 1 toward the wall; the
        damped leapfrog (1 + s) u' = 2u - (1 - s) u_prev + ..., s = sigma
        dt / 2); 0 keeps hard reflecting walls.
    engine : "kernel" (the CUDA kernels B14-B17, tpuwave's "pallas") or
        "stencil" (the plain plane-stencil recurrence).
    adjoint : "reversal" (the only one ported: O(1)-memory state
        reconstruction).
    boundary_save : with a sponge, what the forward pass saves for the
        reconstruction: "strip" (every sigma > 0 vertex; stencil engine
        only) or "ring" (the interface ring; gradients exact on
        ``sponge_interior_cell_mask``).
    steps_per_call : fused steps per kernel pass (B15 / B17), in both
        directions. Results do not depend on it. B15 and B17 run a pass
        of k > 8 steps as ceil(k / 8) launches; 1 runs one step per
        launch (B14 / B16).

    The port's defaults (engine "kernel", adjoint "reversal", device
    "cuda") differ from tpuwave's ("scatter" / "remat"): the scatter and
    grid engines and the remat adjoint are not ported yet (ROADMAP A12).
    """

    def __init__(self, nel: Tuple[int, int], geometry, dt: float,
                 n_steps: int, *, source: Tuple[float, float],
                 receivers: Sequence[Tuple[float, float]],
                 wavelet=None, dtype: Optional[torch.dtype] = None,
                 device="cuda", sponge_width: float = 0.0,
                 sponge_strength: float = 30.0, engine: str = "kernel",
                 adjoint: str = "reversal", boundary_save: str = "strip",
                 interp_receivers: bool = False, steps_per_call: int = 8):
        if engine in ("scatter", "grid"):
            _not_ported(f"engine={engine!r}")
        if engine not in ("kernel", "stencil"):
            raise ValueError(f"unknown engine {engine!r} (kernel | stencil; "
                             "tpuwave's 'pallas' is 'kernel' here)")
        if adjoint == "remat":
            _not_ported("adjoint='remat'")
        if adjoint != "reversal":
            raise ValueError(f"unknown adjoint {adjoint!r}")
        if boundary_save not in ("strip", "ring"):
            raise ValueError(f"unknown boundary_save {boundary_save!r}")
        if (engine == "kernel" and sponge_width > 0.0
                and boundary_save != "ring"):
            raise ValueError("engine='kernel' with a sponge requires "
                             "boundary_save='ring' (the fused path saves "
                             "only the interface ring; use "
                             "engine='stencil' for the exact-everywhere "
                             "'strip' mode)")
        self.engine = engine
        self.adjoint = adjoint
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
        self._w_sum = float(np.sum(quad.weights))
        self._det_j = float(self.mesh.det_j)

        cells = np.asarray(self.mesh.cells, dtype=np.int64)
        self.n_cells = cells.shape[0]
        self.n_vertices = self.mesh.n_vertices
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
        if sponge_width > 0.0:
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
        """K(c2) u on a flat field, exact on boundary rows too: 2 classes x
        the nonzero (i, j) pairs of slab multiply-adds (tpuwave's grid
        form, ``_stiffness_apply_grid``). Differentiable in c2."""
        ny, nx = self.mesh.ny, self.mesh.nx
        s = self._scales(c2_cell)
        ug = self._as(u).reshape(self._grid)
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

    # -- stencil engine ---------------------------------------------------------
    def _propagate(self, c2_cell, src, wavelet, u0=None,
                   return_final: bool = False):
        """Core leapfrog loop over (c2_cell, src, wavelet, u0)."""
        if self.engine == "kernel":
            return self._propagate_kernel(c2_cell, src, wavelet, u0,
                                          return_final)
        dt2 = self.dt * self.dt
        planes = self._assemble_stencil_planes(self._as(c2_cell))
        src_idx = torch.tensor([int(src)], device=self.device)

        def forced_accel(u, w_n):
            f = (-self._apply_stencil_planes(planes, u)).index_add(
                0, src_idx, w_n.reshape(1))
            return f * self._inv_lumped

        u0 = (torch.zeros(self.n_vertices, dtype=self.dtype,
                          device=self.device) if u0 is None
              else self._as(u0).reshape(-1))
        u1 = (u0 + 0.5 * dt2 * forced_accel(u0, wavelet[0])) * self._interior
        save = self._sponge_rects is not None and return_final
        traces = [self._sample(u1)]
        strips = [self._sponge_save(u1)] if save else []
        u, u_prev = u1, u0
        for w_n in wavelet[1:]:
            u_next = (2.0 * u - self._damp_num * u_prev
                      + dt2 * forced_accel(u, w_n)) * self._damp_den
            u_next = u_next * self._interior
            traces.append(self._sample(u_next))
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
        assembly to dJ/dc2. Returns (c2_bar, wavelet_bar)."""
        c2_cell = self._as(c2_cell)
        dt2 = self.dt * self.dt
        planes = self._assemble_stencil_planes(c2_cell)
        interior, inv_m = self._interior, self._inv_lumped
        keep = self._sponge_keep
        has_sponge = saves is not None and self._sponge_rects is not None
        bden = interior * self._damp_den if has_sponge else interior
        src = int(src)
        src_idx = torch.tensor([src], device=self.device)

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
        wav = torch.empty(n - 1, dtype=self.dtype, device=self.device)
        for i in reversed(range(n - 1)):
            blam = bden * lam
            mu = dt2 * inv_m * blam
            lam_cur = self._inject(lam_partial + 2.0 * blam - k_apply(mu),
                                   ybar[i])
            lam_prev_partial = (-(self._damp_num * blam) if has_sponge
                                else -blam)
            f = (-k_apply(u_cur)).index_add(0, src_idx,
                                            wavelet[i + 1].reshape(1))
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
            wav[i] = mu[src]
            u_next, u_cur, lam, lam_partial = (u_cur, u_prev, lam_cur,
                                               lam_prev_partial)
        # u_1 = B(dt^2/2 M^-1 w_0 e_src): only the wavelet depends
        wav_0 = 0.5 * dt2 * (inv_m * (interior * lam))[src]
        return (self._planes_vjp(c2_cell, wbar),
                torch.cat([wav_0[None], wav]))

    # -- forward model --------------------------------------------------------
    def simulate(self, c2_cell, u0=None, wavelet=None) -> torch.Tensor:
        """Receiver traces (n_steps, n_rec), differentiable in c2_cell and
        the wavelet through the time-reversal adjoint. u'(0) = 0; the first
        step is the Taylor start u^1 = u^0 + dt^2/2 M_L^{-1} (w_0 e_src -
        K u^0). With ``u0`` (a non-zero start, which the reversal adjoint
        does not cover) the run is forward only."""
        w = self.wavelet if wavelet is None else self._as(wavelet)
        c2 = self._as(c2_cell)
        if u0 is None:
            return _ReversalSim.apply(c2, w, self, self.source_vertex)
        with torch.no_grad():
            return self._propagate(c2, self.source_vertex, w, u0)

    def snap_vertices(self, points) -> torch.Tensor:
        """Nearest-vertex ids (int64) for a list of (x, y) points."""
        return torch.tensor([self._nearest(p) for p in points],
                            dtype=torch.int64)

    def simulate_shots(self, c2_cell, sources, wavelets=None) -> torch.Tensor:
        """Independent shots, one after the other -> (S, n_steps, n_rec).
        ``sources``: (S,) vertex ids (:meth:`snap_vertices`); ``wavelets``:
        (S, n_steps) per-shot time series (default: this problem's)."""
        srcs = [int(s) for s in torch.as_tensor(sources).reshape(-1)]
        if wavelets is None:
            ws = self.wavelet.expand(len(srcs), self.n_steps)
        else:
            ws = self._as(wavelets)
        c2 = self._as(c2_cell)
        return torch.stack([_ReversalSim.apply(c2, ws[i], self, s)
                            for i, s in enumerate(srcs)])

    def misfit_shots(self, c2_cell, sources, observed, wavelets=None,
                     kind: str = "l2", huber_delta: float = 1.0):
        """Misfit over the multi-shot gather (see :func:`trace_misfit`)."""
        return trace_misfit(self.simulate_shots(c2_cell, sources, wavelets),
                            self._as(observed), kind,
                            huber_delta=huber_delta)

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

    # -- inversion --------------------------------------------------------------
    def invert(self, observed, c2_init, *, n_iter: int = 50,
               learning_rate: float = 0.1,
               bounds: Optional[Tuple[float, float]] = None,
               sources=None, wavelet=None, wavelets=None,
               estimate_wavelet: bool = False, wavelet_init=None,
               optimizer: str = "adam", reg_lambda: float = 0.0,
               precondition: Optional[str] = None,
               misfit_kind: str = "l2", huber_delta: float = 1.0,
               checkpoint: Optional[str] = None,
               checkpoint_every: int = 10,
               verbose: bool = False) -> FwiResult:
        """Adam descent on the misfit (``torch.optim.Adam``: beta (0.9,
        0.999), eps 1e-8, optax's defaults), with the box ``bounds``
        projection of c2 after every step. ``reg_lambda`` adds
        ``reg_lambda * roughness(c2)``; ``misfit_kind`` selects the data
        functional; with ``sources`` the (S, n_steps, n_rec) gather is
        fitted shot by shot (``wavelets`` (S, n_steps), or ``wavelet`` for
        every shot). ``estimate_wavelet`` co-estimates one shared source
        time series from ``wavelet_init`` (default: this problem's); the
        projection applies to c2 only. The misfit history holds each
        iteration's value before its update.

        ``checkpoint``: path of a single .npz snapshot (model, optimizer
        state, misfit history; utils/checkpoint.py) written every
        ``checkpoint_every`` iterations and at the end; if the file
        already exists the descent resumes from it (``n_iter`` counts
        total iterations). The optimizer state is written as tpuwave's
        optax Adam state leaves (``count`` as int32, then the first
        moments, then the second moments, each in parameter order), so a
        snapshot written by either package resumes in the other."""
        if optimizer == "lbfgs":
            _not_ported("optimizer='lbfgs'")
        if optimizer != "adam":
            raise ValueError(f"unknown optimizer {optimizer!r}")
        if precondition is not None:
            _not_ported(f"precondition={precondition!r}")
        if estimate_wavelet and (wavelets is not None or wavelet is not None):
            raise ValueError("estimate_wavelet=True estimates one shared "
                             "wavelet; drop the fixed `wavelet(s)` argument")
        observed = self._as(observed)
        c2 = self._as(c2_init).detach().clone().requires_grad_(True)
        params, w_est = [c2], None
        if estimate_wavelet:
            w_est = (self.wavelet if wavelet_init is None
                     else self._as(wavelet_init)).detach().clone()
            params.append(w_est.requires_grad_(True))
        fixed_w = None if wavelet is None else self._as(wavelet)

        def loss():
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

        opt = torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                               eps=1e-8)
        misfits = np.empty(n_iter)
        start = 0
        if checkpoint is not None:
            ck = load_inversion(checkpoint)
            if ck is not None:
                n_done, hist, p_leaves, o_leaves = ck
                if (len(p_leaves) != len(params)
                        or len(o_leaves) != 1 + 2 * len(params)):
                    raise ValueError(
                        f"checkpoint {checkpoint} does not match this "
                        "inversion configuration (different optimizer or "
                        "estimate_wavelet setting)")
                _restore_adam(opt, params, p_leaves, o_leaves)
                start = min(n_done, n_iter)
                misfits[:start] = hist[:start]
                if verbose:
                    print(f"resumed from {checkpoint} at iteration {start}")
        for i in range(start, n_iter):
            opt.zero_grad(set_to_none=True)
            with torch.enable_grad():
                val = loss()
                val.backward()
            opt.step()
            if bounds is not None:
                with torch.no_grad():
                    c2.clamp_(bounds[0], bounds[1])
            misfits[i] = float(val.detach())
            if verbose:
                print(f"iter {i:3d}  misfit {misfits[i]:.6e}")
            if checkpoint is not None and ((i + 1) % checkpoint_every == 0
                                           or i + 1 == n_iter):
                save_inversion(checkpoint, i + 1, misfits[:i + 1], params,
                               _adam_leaves(opt, params))
        return FwiResult(c2=c2.detach(), misfits=misfits,
                         wavelet=None if w_est is None else w_est.detach())

    # -- not ported yet (ROADMAP A12) ---------------------------------------------
    def invert_multiscale(self, *args, **kwargs):
        _not_ported("invert_multiscale")

    def illumination(self, *args, **kwargs):
        _not_ported("illumination")

    def simulate_supershot(self, *args, **kwargs):
        _not_ported("simulate_supershot")

    def misfit_encoded(self, *args, **kwargs):
        _not_ported("misfit_encoded")

    def invert_encoded(self, *args, **kwargs):
        _not_ported("invert_encoded")

    def born(self, *args, **kwargs):
        _not_ported("born")

    def migrate(self, *args, **kwargs):
        _not_ported("migrate")

    def rtm_image(self, *args, **kwargs):
        _not_ported("rtm_image")

    def lsrtm(self, *args, **kwargs):
        _not_ported("lsrtm")

    def gauss_newton_hvp(self, *args, **kwargs):
        _not_ported("gauss_newton_hvp")

    def invert_gauss_newton(self, *args, **kwargs):
        _not_ported("invert_gauss_newton")
