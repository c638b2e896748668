"""The port's driven and time-dependent explicit leapfrog
(tpuwave_torch/models/fast.py) against tpuwave's XLA paths, on the CPU in
f64.

* ``run_leapfrog_driven`` (torch ops), ``run_leapfrog_driven_kernel`` (B1
  and the edge overlay, with and without forcing) and
  ``run_leapfrog_driven_multistep`` (B6) at k in {1, 8, 32}, each against
  tpuwave's ``leapfrog_step_driven`` loop (the XLA step, not its Pallas
  kernels: tpuwave's interpret-mode tests of the rewritten k-step overlay
  stop at k = 16), on tpuwave's own test shapes: (24, 70) with
  g = 0.1 sin(3t)(1 + xy) over 32 steps, (24, 20) with forcing, and the
  oscillating-boundary strip drive of tests/test_fast.py;
* ``leapfrog_velocity``, ``leapfrog_step_tdep`` and ``run_leapfrog_tdep``
  with and without g and f (the MMS of tests/test_tdep_c.py);
* B6's plain version against tpuwave's
  ``leapfrog_multistep_driven_pallas`` in interpret mode at k = 1, 3 and 4.

On the CPU the kernel paths run the kernels' plain versions. Tolerance
rtol 1e-13 in the L2 norm, as tpuwave holds its own driven kernels: the
two sides group dt^2, M_L^{-1} and the stencil differently (~1e-16 per
step).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (one torch thread)
from tpuwave.models.fast import FastWaveSolver as JFast
from tpuwave.models.fast import LeapfrogState as JState
from tpuwave_torch.models.fast import FastWaveSolver as TFast
from tpuwave_torch.models.fast import LeapfrogState as TState
from tpuwave_torch.ops import kernels as tk

CPU = torch.device("cpu")
GEOM = ((0.0, 0.0), (1.0, 1.0))
RTOL = 1e-13


def g_jax(x, y, t):
    return 0.1 * jnp.sin(3.0 * t) * (1.0 + x * y)


def g_torch(x, y, t):
    return 0.1 * torch.sin(3.0 * t) * (1.0 + x * y)


def f_jax(x, y, t):
    return jnp.sin(2 * jnp.pi * x) * jnp.cos(jnp.pi * y) * jnp.cos(t)


def f_torch(x, y, t):
    return (torch.sin(2 * math.pi * x) * torch.cos(math.pi * y)
            * torch.cos(t))


def u0_jax(x, y):
    return jnp.sin(jnp.pi * x) * jnp.sin(jnp.pi * y)


def u0_torch(x, y):
    return torch.sin(math.pi * x) * torch.sin(math.pi * y)


def _pair(nel, dt):
    return (JFast(nel, GEOM, dt, beta=0.0, dtype=jnp.float64),
            TFast(nel, GEOM, dt, beta=0.0, dtype=torch.float64, device=CPU))


def _held(got, want, rtol=RTOL):
    """Both arrays of the state within rtol of ||want.u|| (L2)."""
    nu = float(jnp.linalg.norm(want.u))
    assert np.linalg.norm(got.u.numpy() - np.asarray(want.u)) <= rtol * nu
    assert np.linalg.norm(got.u_prev.numpy()
                          - np.asarray(want.u_prev)) <= rtol * nu


@pytest.fixture(scope="module")
def driven70():
    """tpuwave's k-step test problem (tests/test_fast_engine.py:530),
    extended to 32 steps: both starts and tpuwave's XLA end state."""
    js, ts = _pair((24, 70), 5e-3)
    sj = js.initial_leapfrog_state(u0_jax, g_fn=g_jax)
    st = ts.initial_leapfrog_state(u0_torch, g_fn=g_torch)
    _held(st, sj)
    times = 5e-3 * (1.0 + np.arange(32))
    want = sj
    for t in times:
        want = js.leapfrog_step_driven(want, float(t), g_jax)
    return ts, st, times, want


@pytest.mark.parametrize("path,k", [("torch", None), ("kernel", None),
                                    ("multistep", 1), ("multistep", 8),
                                    ("multistep", 32)])
def test_driven_paths_match_tpuwave_xla(driven70, path, k):
    ts, st, times, want = driven70
    tk.reset_launches()
    if path == "torch":
        got = ts.run_leapfrog_driven(st, times, g_torch)
    elif path == "kernel":
        got = ts.run_leapfrog_driven_kernel(st, times, g_torch)
    else:
        got = ts.run_leapfrog_driven_multistep(st, times, g_torch,
                                               steps_per_call=k)
    _held(got, want)
    # CPU tensors run the plain versions: no kernel launch is counted
    assert all(v == 0 for v in tk.LAUNCHES.values())


@pytest.mark.parametrize("path", ["torch", "kernel"])
def test_driven_forcing_matches_tpuwave_xla(path):
    """tests/test_fast_engine.py's forced driven case at (24, 20): the
    forcing-aware start and 12 steps with f acting at t - dt."""
    js, ts = _pair((24, 20), 5e-3)
    sj = js.initial_leapfrog_state(u0_jax, f_fn=f_jax, g_fn=g_jax)
    st = ts.initial_leapfrog_state(u0_torch, f_fn=f_torch, g_fn=g_torch)
    _held(st, sj)
    times = 5e-3 * (1.0 + np.arange(12))
    want = js.run_leapfrog_driven(sj, times, g_jax, f_jax)
    run = (ts.run_leapfrog_driven if path == "torch"
           else ts.run_leapfrog_driven_kernel)
    _held(run(st, times, g_torch, f_torch), want)


@pytest.mark.parametrize("path", ["torch", "kernel", "multistep"])
def test_oscillating_boundary_matches_tpuwave(path):
    """tests/test_fast.py::test_driven_boundary_leapfrog's strip drive
    (g = sin(6 pi t) on x < 0.1) from rest, Nel 16, dt 0.005, 20 steps;
    the boundary carries g exactly."""
    js, ts = _pair((16, 16), 0.005)

    def gj(x, y, t):
        return jnp.where((x < 0.1) & (y >= 0) & (y <= 1),
                         jnp.sin(6 * math.pi * t), 0.0)

    def gt(x, y, t):
        return torch.where((x < 0.1) & (y >= 0) & (y <= 1),
                           torch.sin(6 * math.pi * t), 0.0)

    zj = jnp.zeros(js.shape, jnp.float64)
    zt = torch.zeros(ts.shape, dtype=torch.float64)
    times = 0.005 * (1.0 + np.arange(20))
    want = js.run_leapfrog_driven(JState(u=zj, u_prev=zj), times, gj)
    if path == "torch":
        got = ts.run_leapfrog_driven(TState(zt, zt), times, gt)
    elif path == "kernel":
        got = ts.run_leapfrog_driven_kernel(TState(zt, zt), times, gt)
    else:
        got = ts.run_leapfrog_driven_multistep(TState(zt, zt), times, gt,
                                               steps_per_call=4)
    _held(got, want)
    xs, ys = ts.grid_coords()
    g_end = gt(xs, ys, torch.tensor(times[-1], dtype=torch.float64))
    assert torch.equal(got.u[ts.boundary], g_end[ts.boundary])
    assert float(torch.linalg.vector_norm(got.u[ts.interior])) > 1e-3


def test_leapfrog_velocity_matches_tpuwave(driven70):
    ts, st, times, _ = driven70
    js, _ = _pair((24, 70), 5e-3)
    sj = js.initial_leapfrog_state(u0_jax, g_fn=g_jax)
    nj = js.leapfrog_step_driven(sj, float(times[0]), g_jax)
    nt = ts.leapfrog_step_driven(st, torch.tensor(times[0],
                                                  dtype=torch.float64),
                                 g_torch)
    vj = np.asarray(js.leapfrog_velocity(nj, sj))
    vt = ts.leapfrog_velocity(nt, st).numpy()
    assert np.linalg.norm(vt - vj) <= RTOL * np.linalg.norm(vj)


def test_multistep_driven_plain_version_matches_pallas_interpret():
    """B6's plain version (the port's run on CPU tensors) against
    tpuwave's leapfrog_multistep_driven_pallas in interpret mode, k = 4,
    as tests/test_fast_engine.py runs it (block_rows 8)."""
    js, ts = _pair((24, 70), 5e-3)
    sj = js.initial_leapfrog_state(u0_jax, g_fn=g_jax)
    st = ts.initial_leapfrog_state(u0_torch, g_fn=g_torch)
    times = 5e-3 * (1.0 + np.arange(8))
    want = js.run_leapfrog_driven_multistep(sj, times, g_jax,
                                            steps_per_call=4, block_rows=8,
                                            interpret=True)
    got = ts.run_leapfrog_driven_multistep(st, times, g_torch,
                                           steps_per_call=4)
    _held(got, want)


@pytest.mark.parametrize("k", [1, 3])
def test_multistep_driven_plain_version_matches_pallas_interpret_at_k(k):
    """The same at k = 1 (one substep a chunk) and k = 3 (a depth that is
    no multiple of tpuwave's 8-row halo), on the (24, 70) grid (71 x 25
    nodes)."""
    js, ts = _pair((24, 70), 5e-3)
    sj = js.initial_leapfrog_state(u0_jax, g_fn=g_jax)
    st = ts.initial_leapfrog_state(u0_torch, g_fn=g_torch)
    times = 5e-3 * (1.0 + np.arange(2 * k))
    want = js.run_leapfrog_driven_multistep(sj, times, g_jax,
                                            steps_per_call=k, block_rows=8,
                                            interpret=True)
    got = ts.run_leapfrog_driven_multistep(st, times, g_torch,
                                           steps_per_call=k)
    _held(got, want)


def test_multistep_driven_reference_overlay_order_and_checks():
    """The plain version's overlay: left, right, bottom, top (rows win at
    the corners); the wrapper checks the edge tables' shapes."""
    rng = np.random.default_rng(5)
    h, w, k = 9, 7, 3
    u, up = (torch.tensor(rng.standard_normal((h, w))) for _ in range(2))
    gtb = torch.tensor(rng.standard_normal((k, 2, w)))
    glr = torch.tensor(rng.standard_normal((k, h, 2)))
    st = ((0.1, 0.2, 0.0), (0.3, -1.2, 0.3), (0.0, 0.2, 0.1))
    cu, cp = tk.leapfrog_multistep_driven(u, up, gtb, glr, st, 0.2, k)
    assert torch.equal(cu[0], gtb[-1, 0]) and torch.equal(cu[-1], gtb[-1, 1])
    assert torch.equal(cu[1:-1, 0], glr[-1, 1:-1, 0])
    assert torch.equal(cu[1:-1, -1], glr[-1, 1:-1, 1])
    assert torch.equal(cp[0], gtb[-2, 0])
    # one step at a time through B1's plain version and the same overlay
    a, b = u, up
    for s in range(k):
        n = tk.leapfrog_step(a, b, st, 0.2)
        n[:, 0], n[:, -1] = glr[s, :, 0], glr[s, :, 1]
        n[0], n[-1] = gtb[s, 0], gtb[s, 1]
        a, b = n, a
    np.testing.assert_allclose(cu.numpy(), a.numpy(), rtol=1e-14,
                               atol=1e-14)
    with pytest.raises(ValueError, match="edge table"):
        tk.leapfrog_multistep_driven(u, up, gtb[:, :, :-1], glr, st, 0.2, k)
    with pytest.raises(ValueError, match="edge table"):
        tk.leapfrog_multistep_driven(u, up, gtb, glr, st, 0.2, k + 1)
    with pytest.raises(ValueError, match="multiple"):
        TFast((8, 8), GEOM, 0.01, dtype=torch.float64,
              device=CPU).run_leapfrog_driven_multistep(
            TState(u[:9, :9].contiguous(), u[:9, :9].contiguous()),
            [0.01, 0.02, 0.03], g_torch, steps_per_call=2)


# ---------------------------------------------------------------------------
# time-dependent wave speed (tests/test_tdep_c.py's fast-path MMS)
# ---------------------------------------------------------------------------
def c_jax(x, y, t):
    return jnp.sqrt(1.0 + 0.5 * jnp.sin(2.0 * t)) * (1.0 + 0.3 * x * y)


def c_torch(x, y, t):
    return torch.sqrt(1.0 + 0.5 * torch.sin(2.0 * t)) * (1.0 + 0.3 * x * y)


def mms_f_jax(x, y, t):
    c2 = 1.0 + 0.5 * jnp.sin(2.0 * t)
    return ((2.0 * jnp.pi ** 2 * c2 - 1.0) * jnp.cos(t)
            * jnp.sin(jnp.pi * x) * jnp.sin(jnp.pi * y))


def mms_f_torch(x, y, t):
    c2 = 1.0 + 0.5 * torch.sin(2.0 * t)
    return ((2.0 * math.pi ** 2 * c2 - 1.0) * torch.cos(t)
            * torch.sin(math.pi * x) * torch.sin(math.pi * y))


@pytest.mark.parametrize("with_g", [False, True])
@pytest.mark.parametrize("with_f", [False, True])
def test_run_leapfrog_tdep_matches_tpuwave(with_g, with_f):
    """A varying and time-dependent c (the MMS speed times 1 + 0.3 xy) on
    tests/test_tdep_c.py's 24^2 grid, dt 0.01, 12 steps from a random
    state, with and without g and f."""
    js, ts = _pair((24, 24), 0.01)
    rng = np.random.default_rng(11)
    u, up = rng.standard_normal(ts.shape), rng.standard_normal(ts.shape)
    times = 0.01 * (1.0 + np.arange(12))
    want = js.run_leapfrog_tdep(
        JState(u=jnp.asarray(u), u_prev=jnp.asarray(up)),
        jnp.asarray(times), c_jax, g_jax if with_g else None,
        mms_f_jax if with_f else None)
    got = ts.run_leapfrog_tdep(
        TState(torch.tensor(u), torch.tensor(up)), times, c_torch,
        g_torch if with_g else None, mms_f_torch if with_f else None)
    _held(got, want)


def test_leapfrog_step_tdep_and_scales_match_tpuwave():
    """One step and the (ny, nx, 2) scale payload at t = 0.3, and the
    constant-c planes reproduce the constant stencil path
    (tests/test_tdep_c.py:295)."""
    js, ts = _pair((24, 24), 0.005)
    t = 0.3
    np.testing.assert_allclose(
        ts._tdep_scales(c_torch, torch.tensor(t, dtype=torch.float64))
        .numpy(), np.asarray(js._tdep_scales(c_jax, t)), rtol=1e-14)
    sj = js.initial_leapfrog_state(u0_jax)
    st = ts.initial_leapfrog_state(u0_torch)
    _held(ts.leapfrog_step_tdep(
        st, torch.tensor(t, dtype=torch.float64), c_torch, g_torch,
        mms_f_torch), js.leapfrog_step_tdep(sj, t, c_jax, g_jax, mms_f_jax))
    want = ts.run_leapfrog_scan(st, 10)
    got = ts.run_leapfrog_tdep(st, ts.dt * (1.0 + np.arange(10)),
                               lambda x, y, t: 1.0)
    np.testing.assert_allclose(got.u.numpy(), want.u.numpy(), rtol=1e-12,
                               atol=1e-14)


def test_tdep_mms_matches_tpuwave():
    """tests/test_tdep_c.py::_fast_tdep_error's run (Nel 24, dt 0.01,
    T 0.4, c^2 = 1 + 0.5 sin 2t, consistent first step): the end states
    agree, and so do the errors against the exact solution."""
    from tpuwave.ops.stencil import apply_varcoef_planes as japply
    from tpuwave_torch.ops.stencil import apply_varcoef_planes as tapply
    nel, dt, t_end = 24, 0.01, 0.4
    js, ts = _pair((nel, nel), dt)

    def cj(x, y, t):
        return jnp.sqrt(1.0 + 0.5 * jnp.sin(2.0 * t))

    def ct(x, y, t):
        return torch.sqrt(1.0 + 0.5 * torch.sin(2.0 * t))

    xj, yj = js.grid_coords()
    u0 = jnp.where(js.boundary, 0.0, u0_jax(xj, yj))
    a0 = (-japply(js._tdep_planes(cj, 0.0), u0) * js.inv_lumped
          + mms_f_jax(xj, yj, 0.0))
    sj = JState(u=jnp.where(js.boundary, 0.0, u0 + 0.5 * dt * dt * a0),
                u_prev=u0)
    xt, yt = ts.grid_coords()
    zero = torch.tensor(0.0, dtype=torch.float64)
    v0 = torch.where(ts.boundary, 0.0, u0_torch(xt, yt))
    b0 = (-tapply(ts._tdep_planes(ct, zero), v0) * ts.inv_lumped
          + mms_f_torch(xt, yt, zero))
    st = TState(torch.where(ts.boundary, 0.0, v0 + 0.5 * dt * dt * b0), v0)
    n = int(round(t_end / dt))
    times = dt * (1.0 + np.arange(n - 1))
    want = js.run_leapfrog_tdep(sj, jnp.asarray(times), cj, f_fn=mms_f_jax)
    got = ts.run_leapfrog_tdep(st, times, ct, f_fn=mms_f_torch)
    _held(got, want)
    uex = np.where(np.asarray(js.boundary), 0.0, math.cos(n * dt)
                   * np.asarray(u0_jax(xj, yj)))
    err_j = np.linalg.norm(np.asarray(want.u) - uex) / np.linalg.norm(uex)
    err_t = np.linalg.norm(got.u.numpy() - uex) / np.linalg.norm(uex)
    assert err_t < 5e-3
    assert abs(err_t - err_j) <= 1e-10 * err_j
