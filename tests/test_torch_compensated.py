"""The port's error-compensated f32 paths (FastWaveSolver's
``run_leapfrog_compensated``, ``run_implicit_mg_2term_comp`` and
``run_implicit_mg_2term_comp_driven``) against tpuwave's, on the CPU.

The same f32 inputs, made from a seed with numpy, go through both
packages: the compensated leapfrog's steps are the same separate
roundings, so head and tail agree with tpuwave's step run op by op (its
jitted scan lets XLA fuse the step, which moves the tail); the compensated 2-term
paths run f32 CG, whose iteration counts may move with the summation
order, so their end states are held to tpuwave's at f32 round-off.
Then tpuwave's own accuracy gates (tests/test_fast.py,
tests/test_multigrid.py) on the port alone: the compensated pair beats
the plain f32 path against the f64 trajectory, and the driven variant
tracks the f64 2-term engine. The initial data of those gates is the
standing mode evaluated in f64 and rounded to the solver's dtype.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (one torch thread)
from tpuwave.models.fast import CompensatedState as JCompensatedState
from tpuwave.models.fast import FastState as JFastState
from tpuwave.models.fast import FastWaveSolver as JFast
from tpuwave_torch.models import convert
from tpuwave_torch.models.fast import FastState, FastWaveSolver

CPU = torch.device("cpu")
GEOM = ((0.0, 0.0), (1.0, 1.0))


def _standing(x, y):
    """sin(pi x) sin(pi y) evaluated in f64, rounded to x's dtype."""
    v = torch.sin(torch.pi * x.double()) * torch.sin(torch.pi * y.double())
    return v.to(x.dtype)


def _seeded_grid(n, seed):
    """A smooth mode plus seeded noise on the (n+1)^2 grid, zero on the
    walls, in f32."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 1.0, n + 1)
    u = np.sin(np.pi * x)[None, :] * np.sin(2 * np.pi * x)[:, None]
    u = u + 0.05 * rng.standard_normal((n + 1, n + 1))
    u[0, :] = u[-1, :] = u[:, 0] = u[:, -1] = 0.0
    return u.astype(np.float32)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return (np.linalg.norm(np.asarray(got, np.float64) - want)
            / np.linalg.norm(want))


def _full(st):
    """head + tail, summed in f64."""
    return (np.asarray(st.u, np.float64) + np.asarray(st.u_lo, np.float64))


def test_compensated_leapfrog_matches_tpuwave():
    n, steps = 32, 40
    dt = 0.9 / (n * np.sqrt(2.0) * 2)
    u0 = _seeded_grid(n, 1)
    js = JFast((n, n), GEOM, dt, dtype=jnp.float32)
    ts = FastWaveSolver((n, n), GEOM, dt, dtype=torch.float32, device=CPU)
    cj = js.initial_compensated_state(lambda x, y: jnp.asarray(u0))
    ct = ts.initial_compensated_state(lambda x, y: torch.tensor(u0))
    # the first (explicit) step may round differently in XLA's fusion
    assert _rel(ct.u.numpy(), cj.u) <= 2e-7
    # from tpuwave's start (the converter carries its state across), the
    # port's steps round as tpuwave's step does op by op; tpuwave's jitted
    # scan lets XLA fuse the step and moves the tail by ~2e-8
    ct = convert.to_torch({k: np.asarray(v) for k, v in cj._asdict().items()},
                          CPU, torch.float32, kind="CompensatedState")
    ct = ts.run_leapfrog_compensated(ct, steps)
    jit = js.run_leapfrog_compensated(cj, steps)
    for _ in range(steps):
        cj = js.leapfrog_step_compensated(cj)
    assert ct.u.dtype == ct.u_lo.dtype == torch.float32
    assert _rel(ct.u.numpy(), jit.u) <= 2e-7
    assert _rel(ct.u.numpy(), cj.u) <= 2e-7
    assert _rel(_full(ct), _full(cj)) <= 1e-9


def test_compensated_2term_paths_match_tpuwave():
    """Both compensated 2-term paths from the same f32 start (the u-form
    first step of each package), 8 steps: Newmark 1/4 standing, theta
    1/2 driven."""
    n, dt, steps = 24, 1e-2, 8
    rng = np.random.default_rng(2)
    u0 = _seeded_grid(n, 3)
    v0 = (0.1 * rng.standard_normal(u0.shape)).astype(np.float32)
    v0[0, :] = v0[-1, :] = v0[:, 0] = v0[:, -1] = 0.0

    def g_j(xs, ys, t):
        return jnp.where((ys <= 0.0) & (xs <= 1.0 / 3.0),
                         jnp.sin(4.0 * jnp.pi * t), 0.0)

    def g_t(xs, ys, t):
        return torch.where((ys <= 0.0) & (xs <= 1.0 / 3.0),
                           torch.sin(4.0 * torch.pi * t), 0.0)

    for kw, driven in ((dict(scheme="newmark", beta=0.25), False),
                       (dict(scheme="theta", theta=0.5), True)):
        js = JFast((n, n), GEOM, dt, lumped=False, dtype=jnp.float32, **kw)
        ts = FastWaveSolver((n, n), GEOM, dt, lumped=False,
                            dtype=torch.float32, device=CPU, **kw)
        a0 = np.zeros_like(u0)
        cj = js.implicit_2term_init_comp(JFastState(
            u=jnp.asarray(u0), v=jnp.asarray(v0), a=jnp.asarray(a0)))
        ct = ts.implicit_2term_init_comp(convert.to_torch(
            {"u": u0, "v": v0, "a": a0}, CPU, torch.float32,
            kind="FastState"))
        if driven:
            times = dt * (1.0 + np.arange(steps))
            cj = js.run_implicit_mg_2term_comp_driven(
                cj, jnp.asarray(times, jnp.float32), g_j, pallas=False)
            ct = ts.run_implicit_mg_2term_comp_driven(ct, times, g_t)
        else:
            cj = js.run_implicit_mg_2term_comp(cj, steps, pallas=False)
            ct = ts.run_implicit_mg_2term_comp(ct, steps)
        assert isinstance(cj, JCompensatedState)
        assert len(ts.last_iterations) == steps
        assert min(ts.last_iterations) >= 1
        assert _rel(ct.u.numpy(), cj.u) <= 2e-6
        assert _rel(_full(ct), _full(cj)) <= 2e-6
        fin = ts.implicit_2term_finish_comp(ct)
        assert isinstance(fin, FastState) and fin.u.shape == (n + 1, n + 1)


def test_compensated_leapfrog_beats_plain_f32():
    """tests/test_fast.py::test_compensated_leapfrog_beats_plain_f32 on the
    port: ec < ep / 10 and eh < 2 ep against the f64 leapfrog."""
    n, steps = 128, 400
    dt = 0.9 / (n * np.sqrt(2.0) * 2)
    s64 = FastWaveSolver((n, n), GEOM, dt, dtype=torch.float64, device=CPU)
    ref = s64.run_leapfrog_scan(s64.initial_leapfrog_state(_standing),
                                steps)
    s32 = FastWaveSolver((n, n), GEOM, dt, dtype=torch.float32, device=CPU)
    plain = s32.run_leapfrog_scan(s32.initial_leapfrog_state(_standing),
                                  steps)
    comp = s32.run_leapfrog_compensated(
        s32.initial_compensated_state(_standing), steps)
    ref = ref.u.numpy()
    ep = _rel(plain.u.numpy(), ref)
    assert _rel(_full(comp), ref) < ep / 10
    assert _rel(comp.u.numpy(), ref) < 2 * ep


def test_implicit_2term_compensated_beats_plain():
    """tests/test_multigrid.py::test_implicit_2term_compensated_beats_plain
    on the port (48^2, 80 steps, tol_factor 1e-3): ec < ep / 8 against the
    f64 2-term trajectory, on the kernel route (B3 / B4's plain versions
    here)."""
    n, dt, steps = 48, 4e-3, 80

    def mk(d):
        return FastWaveSolver((n, n), GEOM, dt, scheme="newmark", beta=0.25,
                              lumped=False, dtype=d, device=CPU)
    s64 = mk(torch.float64)
    ref = s64.run_implicit_mg_2term(
        s64.implicit_2term_init(s64.initial_state_consistent(_standing)),
        steps - 1)
    s32 = mk(torch.float32)
    st32 = s32.initial_state_consistent(_standing)
    plain = s32.run_implicit_mg_2term(s32.implicit_2term_init(st32),
                                      steps - 1)
    comp = s32.run_implicit_mg_2term_comp(
        s32.implicit_2term_init_comp(st32), steps - 1, tol_factor=1e-3)
    ref = ref.u.numpy()
    assert _rel(_full(comp), ref) < _rel(plain.u.numpy(), ref) / 8
    assert s32.implicit_2term_finish_comp(comp).u.shape == (n + 1, n + 1)


def test_implicit_2term_comp_driven_tracks_f64():
    """tests/test_multigrid.py::test_implicit_2term_comp_driven_tracks_f64
    on the port: within 3e-6 (max rel) of the f64 driven 2-term engine at
    24^2, 20 steps."""
    from tpuwave_torch.models.fast_engine import make_fast_solver
    from tpuwave_torch.utils.params import load_params
    n, dt, steps = 24, 1e-2, 20
    case = {
        "Nel": str(n), "R": "1", "T": "1.0", "Theta": "0.5",
        "Dt": str(dt), "Save Solution": "false", "Log Every": "0",
        "C": {"Function expression": "1.0", "Variable names": "x, y, t"},
        "F": {"Function expression": "0.0", "Variable names": "x, y, t"},
        "U0": {"Function expression": "0.0", "Variable names": "x, y"},
        "V0": {"Function expression": "0.0", "Variable names": "x, y"},
        "G": {"Function expression":
              "if(y < 0.0001 && x < 0.34, sin(4*pi*t), 0)",
              "Variable names": "x, y, t"},
        "DGDT": {"Function expression":
                 "if(y < 0.0001 && x < 0.34, 4*pi*cos(4*pi*t), 0)",
                 "Variable names": "x, y, t"},
    }
    eng = make_fast_solver(load_params(case), "theta", solver="2term",
                           precond="mg", dtype=torch.float64, device=CPU)
    ts = dt * (1.0 + np.arange(steps))
    out, _ = eng.run_steps(eng.initial_state(), ts)
    u_ref = np.asarray(eng.disc.vertex_values(out.u)).reshape(n + 1, n + 1)

    s32 = FastWaveSolver((n, n), GEOM, dt, scheme="theta", theta=0.5,
                         lumped=False, dtype=torch.float32, device=CPU)

    def g_strip(xs, ys, t):
        return torch.where((ys <= 0.0) & (xs <= 1.0 / 3.0),
                           torch.sin(4.0 * torch.pi * t), 0.0)

    cs = s32.implicit_2term_init_comp(
        s32.initial_state(lambda x, y: torch.zeros_like(x)))
    got = s32.run_implicit_mg_2term_comp_driven(cs, ts, g_strip)
    rel = np.max(np.abs(_full(got) - u_ref)) / max(np.max(np.abs(u_ref)),
                                                   1e-30)
    assert rel < 3e-6, rel


def test_compensated_2term_refusals():
    """tpuwave's messages: f64 and explicit Newmark refused by both
    compensated 2-term paths."""
    s64 = FastWaveSolver((16, 16), GEOM, 0.02, scheme="newmark", beta=0.25,
                         lumped=False, dtype=torch.float64, device=CPU)
    s0 = FastWaveSolver((16, 16), GEOM, 0.02, scheme="newmark", beta=0.0,
                        dtype=torch.float32, device=CPU)
    for s, msg in ((s64, "f32 accuracy mode"), (s0, "beta > 0")):
        z = torch.zeros((17, 17), dtype=s.dtype)
        cs = convert.to_torch((z, z, z, z), CPU, s.dtype,
                              kind="CompensatedState")
        with pytest.raises(ValueError, match=msg):
            s.run_implicit_mg_2term_comp(cs, 1)
        with pytest.raises(ValueError, match=msg):
            s.run_implicit_mg_2term_comp_driven(
                cs, [0.02], lambda x, y, t: torch.zeros_like(x))
