"""The port's P2 bench solvers (tpuwave_torch/models/fast_p2.py) against
tpuwave's, on the CPU in f64.

``P2FastSolver`` (flat DoF vector) and ``P2CanvasSolver`` (plane canvases,
its applies on B11's plain version, its mg V-cycle on B12 / B13 and B4 /
B3's) from the same states, made from a numpy seed, at Nel 12 x 10, 3
steps: per-step CG counts equal to tpuwave's (read from inside its jitted
steps by a debug callback around its ``pcg``), states within 1e-10
relative. The canvas solver once more against tpuwave's Pallas route in
interpret mode (block rows 8: Nel 12 x 21, whose canvas rows are 24), the
time-dependent-C methods with ``P2PlaneStencil.axpy_varcoef``, and the
refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (one torch thread)
from tpuwave.models import fast_p2 as jp
from tpuwave.ops import stencil_p2 as jsp
from tpuwave_torch.models import convert
from tpuwave_torch.models import fast_p2 as tp

CPU = torch.device("cpu")
GEOM = ((0.0, 0.0), (1.0, 1.0))
NEL = (12, 10)
DT = 0.05
SCHEMES = {"newmark": dict(scheme="newmark", beta=0.25),
           "theta": dict(scheme="theta", theta=0.5)}


@pytest.fixture
def counted(monkeypatch):
    """The CG iterations of every tpuwave pcg call in fast_p2, in order
    (jitted or not)."""
    rec = []
    orig = jp.pcg

    def pcg(*args, **kwargs):
        res = orig(*args, **kwargs)
        jax.debug.callback(lambda it: rec.append(int(it)), res.iterations)
        return res
    monkeypatch.setattr(jp, "pcg", pcg)
    return rec


def _flat_state(nel, seed):
    """(u, v, a) flat P2 vectors: a smooth mode plus seeded noise, zero on
    the Dirichlet DoFs."""
    rng = np.random.default_rng(seed)
    sp = jp.P2FastSolver(nel, GEOM, DT, scheme="theta", dtype=jnp.float64)
    interior = np.asarray(sp.interior_mask())
    u = np.asarray(sp.initial_state(
        lambda x, y: jnp.sin(jnp.pi * x) * jnp.sin(jnp.pi * y)).u)
    out = []
    for scale in (1.0, 0.5, 2.0):
        w = scale * (u + 0.1 * rng.standard_normal(u.shape))
        out.append(np.where(interior, w, 0.0))
    return out


def _canvases(js, flat):
    """tpuwave's canvas stack of a flat vector, as numpy."""
    planes = jsp.flat_to_planes(jnp.asarray(flat), js.nx, js.ny)
    return np.asarray(jsp.planes_to_canvases(planes, js.cshape))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)


def _close_state(ts_state, js_state, rtol=1e-10):
    for f in ts_state._fields:
        assert _rel(getattr(ts_state, f).numpy(),
                    getattr(js_state, f)) <= rtol, f


def _flat_its(its):
    out = []
    for i in its:
        out.extend(i if isinstance(i, tuple) else (i,))
    return out


def _steps(js, ts, sj, st, n, counted):
    """n steps of both; tpuwave's through one jitted step."""
    step = jax.jit(js.step)
    counted.clear()
    for _ in range(n):
        sj = step(sj)
    jax.block_until_ready(sj)
    st = ts.run_scan(st, n)
    assert _flat_its(ts.last_iterations) == counted
    return sj, st


@pytest.mark.parametrize("scheme", ["newmark", "theta"])
def test_p2_fast_solver_matches_tpuwave(scheme, counted):
    """P2FastSolver, Jacobi and mg, from the same seeded state (its
    consistent a0: initial_state_tdep below, which shares the code)."""
    u, v, a = _flat_state(NEL, 0)
    for precond in ("jacobi", "mg"):
        js = jp.P2FastSolver(NEL, GEOM, DT, dtype=jnp.float64,
                             precond=precond, **SCHEMES[scheme])
        ts = tp.P2FastSolver(NEL, GEOM, DT, dtype=torch.float64,
                             precond=precond, device=CPU, **SCHEMES[scheme])
        sj = jp.P2State(*(jnp.asarray(x) for x in (u, v, a)))
        st = convert.to_torch({"u": u, "v": v, "a": a}, CPU, torch.float64,
                              kind="P2State")
        sj, st = _steps(js, ts, sj, st, 3, counted)
        _close_state(st, sj)


@pytest.mark.parametrize("scheme", ["newmark", "theta"])
def test_p2_canvas_solver_mg_and_2term_match_tpuwave(scheme, counted):
    """P2CanvasSolver with mg: 3 steps, then the 2-term recurrence (u-form
    first step, 3 recurrence steps, the exact finish)."""
    js = jp.P2CanvasSolver(NEL, GEOM, DT, dtype=jnp.float64, precond="mg",
                           **SCHEMES[scheme])
    ts = tp.P2CanvasSolver(NEL, GEOM, DT, dtype=torch.float64,
                           precond="mg", device=CPU, **SCHEMES[scheme])
    assert ts.cshape == js.cshape == (NEL[1] + 3, NEL[0] + 3)
    flat = _flat_state(NEL, 1)
    sj = jp.P2CanvasState(*(jnp.asarray(_canvases(js, x)) for x in flat))
    st = convert.to_torch(sj, CPU, torch.float64)
    sj, st = _steps(js, ts, sj, st, 3, counted)
    _close_state(st, sj)
    np.testing.assert_allclose(ts.to_flat(st.u).numpy(),
                               np.asarray(js.to_flat(sj.u)), rtol=1e-10,
                               atol=1e-14)
    counted.clear()

    @jax.jit
    def chain(s):
        pair = js.run_implicit_2term(js.implicit_2term_init(s), 3)
        return pair, js.implicit_2term_finish(pair)
    pj, fj = chain(sj)
    jax.block_until_ready(fj)
    pt = ts.implicit_2term_init(st)
    its = list(ts.last_iterations)
    pt = ts.run_implicit_2term(pt, 3)
    its_run = list(ts.last_iterations)
    ft = ts.implicit_2term_finish(pt)
    # tpuwave's list goes on with the finish's mass solves
    assert its + its_run == counted[:len(its) + len(its_run)]
    _close_state(pt, pj)
    _close_state(ft, fj)
    if scheme == "newmark":
        counted.clear()
        sj = js.initial_state(lambda x, y: jnp.sin(jnp.pi * x) * y)
        st = ts.initial_state(lambda x, y: torch.sin(torch.pi * x) * y)
        assert ts.last_iterations == counted
        _close_state(st, sj)


def test_p2_canvas_solver_matches_tpuwave_pallas_route(counted):
    """tpuwave's fused route (B11 in interpret mode, block rows 8): its
    canvases, converted and cropped to the port's, 2 Newmark steps."""
    nel = (12, 21)
    js = jp.P2CanvasSolver(nel, GEOM, DT, dtype=jnp.float64,
                           use_pallas=True, pallas_block_rows=8,
                           pallas_interpret=True)
    ts = tp.P2CanvasSolver(nel, GEOM, DT, dtype=torch.float64, device=CPU,
                           use_pallas=True, pallas_block_rows=8,
                           pallas_interpret=True)
    assert ts.cshape == (24, 15)
    flat = _flat_state(nel, 2)
    sj = jp.P2CanvasState(*(jnp.asarray(_canvases(js, x)) for x in flat))
    st = convert.to_torch({k: np.asarray(x) for k, x in sj._asdict().items()},
                          CPU, torch.float64, kind="P2CanvasState",
                          canvas=ts.cshape)
    sj, st = _steps(js, ts, sj, st, 2, counted)
    for f in st._fields:
        got = getattr(st, f).numpy()
        assert _rel(got, np.asarray(getattr(sj, f))[:, :24, :15]) <= 1e-10


def test_p2_fast_solver_tdep_matches_tpuwave(counted):
    """A time-dependent c: M.axpy_varcoef(coef, K(t)) against tpuwave's,
    Newmark's initial_state_tdep and step_tdep, theta's run_scan_tdep (3
    steps, K^n carried); CG counts equal, states within 1e-10."""
    def c_j(x, y, t):
        return 1.0 + 0.4 * x * jnp.sin(t) + 0.2 * y

    def c_t(x, y, t):
        return 1.0 + 0.4 * x * torch.sin(t) + 0.2 * y

    u, v, a = _flat_state(NEL, 3)
    times = DT * (1.0 + np.arange(3))
    for scheme in ("newmark", "theta"):
        js = jp.P2FastSolver(NEL, GEOM, DT, dtype=jnp.float64,
                             **SCHEMES[scheme])
        ts = tp.P2FastSolver(NEL, GEOM, DT, dtype=torch.float64,
                             device=CPU, **SCHEMES[scheme])
        if scheme == "newmark":
            kj = js._stiff_at(c_j, 0.7)
            kt = ts._stiff_at(c_t, 0.7)
            sj_op = js.mass.axpy_varcoef(0.25 * DT * DT, kj)
            st_op = ts.mass.axpy_varcoef(0.25 * DT * DT, kt)
            np.testing.assert_allclose(st_op.diagonal().numpy(),
                                       np.asarray(sj_op.diagonal()),
                                       rtol=1e-12)
            np.testing.assert_allclose(st_op(torch.tensor(u)).numpy(),
                                       np.asarray(sj_op(jnp.asarray(u))),
                                       rtol=1e-12, atol=1e-12)
            cs = (NEL[1] + 3, NEL[0] + 3)
            np.testing.assert_allclose(
                st_op.diagonal_canvases(cs).numpy(),
                np.asarray(sj_op.diagonal_canvases(cs)), rtol=1e-12)
            counted.clear()
            sj0 = js.initial_state_tdep(lambda x, y: jnp.sin(jnp.pi * x) * y,
                                        c_j)
            st0 = ts.initial_state_tdep(
                lambda x, y: torch.sin(torch.pi * x) * y, c_t)
            assert ts.last_iterations == counted
            _close_state(st0, sj0)
            counted.clear()
            sj1 = js.step_tdep(sj0, 0.3, c_j)
            st1 = ts.step_tdep(st0, 0.3, c_t)
            assert ts.last_iterations == counted
            _close_state(st1, sj1)
            continue
        # theta: K^n carried from the last step's K^{n+1}
        sj = jp.P2State(*(jnp.asarray(x) for x in (u, v, a)))
        st = convert.to_torch({"u": u, "v": v, "a": a}, CPU, torch.float64,
                              kind="P2State")
        counted.clear()
        sj = js.run_scan_tdep(sj, jnp.asarray(times), c_j)
        jax.block_until_ready(sj)
        st = ts.run_scan_tdep(st, times, c_t)
        assert _flat_its(ts.last_iterations) == counted
        _close_state(st, sj)


def test_p2_solver_refusals():
    """sharding= and row_multiple= name A11; an unknown preconditioner or
    scheme, and the 2-term recurrence at beta = 0, raise as in tpuwave;
    both solvers default to the card."""
    for kw, msg in ((dict(sharding=object()), "A11"),
                    (dict(row_multiple=8), "A11"),
                    (dict(precond="amg"), "Unknown preconditioner"),
                    (dict(scheme="bdf2"), "unknown scheme")):
        with pytest.raises(ValueError, match=msg):
            tp.P2CanvasSolver(NEL, GEOM, DT, device=CPU, **kw)
    for kw, msg in ((dict(precond="amg"), "Unknown preconditioner"),
                    (dict(scheme="bdf2"), "unknown scheme")):
        with pytest.raises(ValueError, match=msg):
            tp.P2FastSolver(NEL, GEOM, DT, device=CPU, **kw)
    s = tp.P2CanvasSolver(NEL, GEOM, DT, beta=0.0, device=CPU)
    z = torch.zeros((4, *s.cshape))
    with pytest.raises(ValueError, match="beta > 0"):
        s.run_implicit_2term(tp.P2CanvasPair(z, z), 1)
    assert tp.P2CanvasSolver(NEL, GEOM, DT, precond="auto",
                             device=CPU).precond == jp.P2CanvasSolver(
        NEL, GEOM, DT, precond="auto").precond
    if not torch.cuda.is_available():
        for cls in (tp.P2FastSolver, tp.P2CanvasSolver):
            with pytest.raises(RuntimeError, match="cuda"):
                cls(NEL, GEOM, DT)
