"""The port's FwiProblem (tpuwave_torch/models/inverse.py) against
tpuwave's (tpuwave/models/inverse.py), on the CPU, in f64.

Both engines of the port run on the CPU: "kernel" through the plain
versions of B14-B17 (ops/kernels_varcoef.py), "stencil" through the plane
recurrence. They are held against tpuwave's ``engine="stencil",
adjoint="reversal"`` on (12, 10) elements, 20 steps (two 8-step kernel
passes and three single steps in each direction), with hard walls,
interpolated receivers and a sponge in ring mode. The same c2 models come
from a numpy seed. Tolerances: traces and misfits rtol 1e-12, gradients
rtol 1e-9 (tpuwave's own bound between its engines, test_pallas_fwi.py),
each with an absolute floor of the same factor times the array's peak,
as traces and gradients pass through zero. One case holds the kernel
engine against tpuwave's ``engine="pallas"`` in interpret mode, through
``models/convert.fwi_to_torch``.

The test marked ``cuda`` runs the kernel engine on the card against the
CPU and skips where there is none.
"""

import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (one torch thread)
from tpuwave_torch.models import inverse as ti
from tpuwave_torch.models.convert import fwi_to_torch

NEL, GEOM, DT, STEPS = (12, 10), ((0.0, 0.0), (1.0, 1.0)), 8e-3, 20
SRC, RECS = (0.45, 0.55), [(0.25, 0.3), (0.7, 0.65)]
RING = dict(sponge_width=0.22, sponge_strength=25.0, boundary_save="ring")
CONFIGS = {"walls": {}, "interp": dict(interp_receivers=True), "ring": RING}
RTOL, RTOL_GRAD = 1e-12, 1e-9


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _port(engine="kernel", **kw):
    return ti.FwiProblem(NEL, GEOM, DT, STEPS, source=SRC, receivers=RECS,
                         dtype=torch.float64, device="cpu", engine=engine,
                         **kw)


@pytest.fixture(scope="module")
def jx():
    """(jax, jax.numpy, tpuwave.models.inverse)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from tpuwave.models import inverse
    return jax, jnp, inverse


def _tpuwave(jx, engine="stencil", **kw):
    _, jnp, inverse = jx
    return inverse.FwiProblem(NEL, GEOM, DT, STEPS, source=SRC,
                              receivers=RECS, dtype=jnp.float64,
                              engine=engine, adjoint="reversal", **kw)


def _models(n_cells, seed=1):
    """(c2_true, c2_init): a random model and the homogeneous start."""
    rng = np.random.default_rng(seed)
    return 1.0 + 0.3 * rng.random(n_cells), np.ones(n_cells)


@pytest.fixture(scope="module")
def ref(jx):
    """Per configuration: tpuwave's observed traces at c2_true, and its
    misfit, c2 gradient and wavelet gradient at c2_init."""
    jax, jnp, _ = jx
    cache = {}

    def get(name):
        if name not in cache:
            p = _tpuwave(jx, **CONFIGS[name])
            c2t, c2i = _models(p.n_cells)
            obs = np.asarray(p.simulate(jnp.asarray(c2t)))
            v, g = jax.value_and_grad(p.misfit)(jnp.asarray(c2i), obs)
            wg = jax.grad(lambda w: p.misfit(jnp.asarray(c2i), obs,
                                             wavelet=w))(p.wavelet)
            cache[name] = dict(c2t=c2t, c2i=c2i, obs=obs, v=float(v),
                               g=np.asarray(g), wg=np.asarray(wg))
        return cache[name]
    return get


def _wavelet_grad(p, c2, obs):
    w = p.wavelet.clone().requires_grad_(True)
    with torch.enable_grad():
        (wg,) = torch.autograd.grad(p.misfit(c2, obs, wavelet=w), w)
    return wg


# ---------------------------------------------------------------------------
# the differentiable propagator
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("engine", ["kernel", "stencil"])
def test_traces_misfit_and_gradients_match_tpuwave(ref, engine, config):
    r = ref(config)
    p = _port(engine, **CONFIGS[config])
    c2t, c2i, obs = (torch.tensor(r[k]) for k in ("c2t", "c2i", "obs"))
    _close(p.simulate(c2t), r["obs"], RTOL)
    v, g = p.misfit_and_grad(c2i, obs)
    _close(float(v), r["v"], RTOL)
    _close(g, r["g"], RTOL_GRAD)
    _close(_wavelet_grad(p, c2i, obs), r["wg"], RTOL_GRAD)


def test_stencil_engine_strip_saving_matches_tpuwave(jx):
    """The sponge with every damped vertex saved (stencil engine only):
    gradients exact inside the sponge too."""
    jax, jnp, _ = jx
    strip = dict(RING, boundary_save="strip")
    p, q = _port("stencil", **strip), _tpuwave(jx, **strip)
    c2t, c2i = _models(p.n_cells, seed=13)
    obs = np.asarray(q.simulate(jnp.asarray(c2t)))
    v, g = jax.value_and_grad(q.misfit)(jnp.asarray(c2i), obs)
    vp, gp = p.misfit_and_grad(torch.tensor(c2i), torch.tensor(obs))
    _close(p.simulate(torch.tensor(c2t)), obs, RTOL)
    _close(float(vp), float(v), RTOL)
    _close(gp, g, RTOL_GRAD)


@pytest.mark.parametrize("k", [1, 3])
def test_steps_per_call_does_not_change_results(ref, k):
    """k = 1 (B14 / B16 only) and k = 3 against the default k = 8."""
    r = ref("ring")
    c2t, c2i, obs = (torch.tensor(r[x]) for x in ("c2t", "c2i", "obs"))
    base, other = _port(**RING), _port(steps_per_call=k, **RING)
    _close(other.simulate(c2t), base.simulate(c2t), RTOL)
    v0, g0 = base.misfit_and_grad(c2i, obs)
    v1, g1 = other.misfit_and_grad(c2i, obs)
    _close(float(v1), float(v0), RTOL)
    _close(g1, g0, RTOL_GRAD)


@pytest.mark.parametrize("engine", ["kernel", "stencil"])
def test_forward_only_u0_matches_tpuwave(jx, engine):
    """simulate(u0=...): a non-zero start, forward only."""
    _, jnp, _ = jx
    p, q = _port(engine), _tpuwave(jx)
    c2, _ = _models(p.n_cells, seed=2)
    u0 = np.random.default_rng(3).uniform(-1.0, 1.0, p.n_vertices)
    u0[np.asarray(q.mesh.boundary_vertex_mask)] = 0.0
    want = q.simulate(jnp.asarray(c2), u0=jnp.asarray(u0))
    got = p.simulate(torch.tensor(c2), u0=torch.tensor(u0))
    assert not got.requires_grad
    _close(got, want, RTOL)


@pytest.mark.parametrize("engine", ["kernel", "stencil"])
def test_shots_match_tpuwave(jx, engine):
    """simulate_shots (a loop over shots) and the gradient of
    misfit_shots against tpuwave's vmap, two shots with their own
    wavelets."""
    jax, jnp, _ = jx
    p, q = _port(engine), _tpuwave(jx)
    c2t, c2i = _models(p.n_cells, seed=4)
    pts = [(0.45, 0.55), (0.6, 0.4)]
    assert p.snap_vertices(pts).tolist() == np.asarray(
        q.snap_vertices(pts)).tolist()
    wav = np.stack([np.asarray(q.wavelet), -0.5 * np.asarray(q.wavelet)])
    want = q.simulate_shots(jnp.asarray(c2t), q.snap_vertices(pts),
                            jnp.asarray(wav))
    got = p.simulate_shots(torch.tensor(c2t), p.snap_vertices(pts),
                           torch.tensor(wav))
    _close(got, want, RTOL)
    obs = np.asarray(want)
    g_want = jax.grad(lambda c: q.misfit_shots(
        c, q.snap_vertices(pts), obs, jnp.asarray(wav)))(jnp.asarray(c2i))
    c2 = torch.tensor(c2i, requires_grad=True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(p.misfit_shots(
            c2, p.snap_vertices(pts), torch.tensor(obs), torch.tensor(wav)),
            c2)
    _close(g, g_want, RTOL_GRAD)


def test_kernel_engine_matches_pallas_interpret(jx):
    """The kernel engine against tpuwave's fused Pallas engine (interpret
    mode, 8-row blocks, k = 8): planes, end state and ring saves cropped
    from tpuwave's padded layout, traces, misfit and gradients."""
    jax, jnp, _ = jx
    q = _tpuwave(jx, engine="pallas", pallas_block_rows=8,
                 pallas_interpret=True, **RING)
    p = _port(**RING)
    c2t, c2i = _models(p.n_cells, seed=5)
    grid, f64 = p._grid, torch.float64
    _close(p._stacked_planes(torch.tensor(c2t)),
           fwi_to_torch(q._padded_planes(jnp.asarray(c2t)), grid, "cpu", f64),
           RTOL)
    src = p.source_vertex
    tr_q, (uq, upq, (rows_q, cols_q)) = q._propagate_pallas(
        jnp.asarray(c2t), jnp.asarray(src, jnp.int32), q.wavelet,
        return_final=True)
    tr_p, (up_, upp, (rows_p, cols_p)) = p._propagate_kernel(
        torch.tensor(c2t), src, p.wavelet, return_final=True)
    _close(tr_p, tr_q, RTOL)
    for got, want, kind in ((up_, uq, "grid"), (upp, upq, "grid"),
                            (rows_p, rows_q, "ring_rows"),
                            (cols_p, cols_q, "ring_cols")):
        _close(got, fwi_to_torch(want, grid, "cpu", f64, kind), RTOL)
    obs = np.asarray(tr_q)
    v, g = jax.value_and_grad(q.misfit)(jnp.asarray(c2i), obs)
    vp, gp = p.misfit_and_grad(torch.tensor(c2i), torch.tensor(obs))
    _close(float(vp), float(v), RTOL)
    _close(gp, fwi_to_torch(g, grid, "cpu", f64, "cells"), RTOL_GRAD)


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["walls", "interp", "ring"])
def test_cuda_kernel_engine_matches_cpu(config):
    """The kernel engine on the card (B14-B17) against the CPU's plain
    run, f64: traces rtol 1e-12, gradients rtol 1e-9."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    runs = {}
    for dev in ("cuda", "cpu"):
        p = ti.FwiProblem((48, 40), GEOM, 2e-3, 96, source=SRC,
                          receivers=[(0.4, 0.45), (0.55, 0.62)],
                          dtype=torch.float64, device=dev,
                          **CONFIGS[config])
        c2t, c2i = (torch.tensor(c, device=dev) for c in _models(p.n_cells))
        obs = p.simulate(c2t)
        v, g = p.misfit_and_grad(c2i, obs)
        runs[dev] = [x.cpu() for x in (obs, v, g, _wavelet_grad(p, c2i,
                                                                obs))]
    (oc, vc, gc, wc), (oh, vh, gh, wh) = runs["cuda"], runs["cpu"]
    _close(oc, oh, RTOL)
    _close(float(vc), float(vh), RTOL)
    _close(gc, gh, RTOL_GRAD)
    _close(wc, wh, RTOL_GRAD)


# ---------------------------------------------------------------------------
# misfits, filters and the model functionals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["l2", "huber", "envelope"])
def test_trace_misfit_matches_tpuwave(jx, kind):
    jax, jnp, inverse = jx
    rng = np.random.default_rng(6)
    sim, obs = rng.standard_normal((2, 2, 24, 3))
    want, g_want = jax.value_and_grad(lambda s: inverse.trace_misfit(
        s, jnp.asarray(obs), kind, huber_delta=0.7))(jnp.asarray(sim))
    s = torch.tensor(sim, requires_grad=True)
    with torch.enable_grad():
        got = ti.trace_misfit(s, torch.tensor(obs), kind, huber_delta=0.7)
        (g,) = torch.autograd.grad(got, s)
    _close(float(got.detach()), float(want), RTOL)
    _close(g, g_want, RTOL_GRAD)


def test_filters_and_wavelet_match_tpuwave(jx):
    _, jnp, inverse = jx
    rng = np.random.default_rng(7)
    x = rng.standard_normal((33, 4))
    times = 2e-3 * np.arange(1, 41)
    _close(ti.ricker_wavelet(times, 25.0), inverse.ricker_wavelet(times, 25.0),
           RTOL)
    _close(ti.lowpass_time(x, 2e-3, 60.0),
           inverse.lowpass_time(x, 2e-3, 60.0), RTOL)
    _close(ti.envelope_time(torch.tensor(x), axis=0),
           inverse.envelope_time(jnp.asarray(x), axis=0), RTOL)


def test_model_functionals_match_tpuwave(jx):
    """roughness (value and gradient), stiffness_apply, the sponge's
    interior-cell mask, the receivers and the default wavelet."""
    jax, jnp, _ = jx
    p, q = _port(**RING), _tpuwave(jx, **RING)
    c2, _ = _models(p.n_cells, seed=8)
    u = np.random.default_rng(9).standard_normal(p.n_vertices)
    rw, gw = jax.value_and_grad(q.roughness)(jnp.asarray(c2))
    c = torch.tensor(c2, requires_grad=True)
    with torch.enable_grad():
        rg = p.roughness(c)
        (gg,) = torch.autograd.grad(rg, c)
    _close(float(rg.detach()), float(rw), RTOL)
    _close(gg, gw, RTOL)
    _close(p.stiffness_apply(torch.tensor(c2), torch.tensor(u)),
           q.stiffness_apply(jnp.asarray(c2), jnp.asarray(u)), RTOL)
    assert np.array_equal(p.sponge_interior_cell_mask,
                          q.sponge_interior_cell_mask)
    assert p.source_vertex == q.source_vertex
    assert p.receiver_vertices.tolist() == np.asarray(
        q.receiver_vertices).tolist()
    _close(p.wavelet, q.wavelet, RTOL)


# ---------------------------------------------------------------------------
# the inversion loop (Adam)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("config", ["walls", "ring"])
def test_invert_adam_matches_tpuwave(jx, config):
    """Three Adam iterations with box bounds and Tikhonov smoothing."""
    _, jnp, _ = jx
    p, q = _port(**CONFIGS[config]), _tpuwave(jx, **CONFIGS[config])
    c2t, c2i = _models(p.n_cells, seed=10)
    obs = np.asarray(q.simulate(jnp.asarray(c2t)))
    kw = dict(n_iter=3, learning_rate=0.05, bounds=(0.9, 1.25),
              reg_lambda=1e-3)
    want = q.invert(obs, jnp.asarray(c2i), **kw)
    got = p.invert(torch.tensor(obs), torch.tensor(c2i), **kw)
    _close(got.misfits, want.misfits, RTOL_GRAD)
    _close(got.c2, want.c2, RTOL_GRAD)
    assert got.wavelet is None
    assert float(got.c2.max()) <= 1.25


def test_invert_estimate_wavelet_matches_tpuwave(jx):
    _, jnp, _ = jx
    p, q = _port(), _tpuwave(jx)
    c2t, c2i = _models(p.n_cells, seed=11)
    obs = np.asarray(q.simulate(jnp.asarray(c2t)))
    w0 = 0.8 * np.asarray(q.wavelet)
    kw = dict(n_iter=3, learning_rate=0.02, estimate_wavelet=True)
    want = q.invert(obs, jnp.asarray(c2i), wavelet_init=jnp.asarray(w0),
                    **kw)
    got = p.invert(torch.tensor(obs), torch.tensor(c2i),
                   wavelet_init=torch.tensor(w0), **kw)
    _close(got.misfits, want.misfits, RTOL_GRAD)
    _close(got.c2, want.c2, RTOL_GRAD)
    _close(got.wavelet, want.wavelet, RTOL_GRAD)


def test_invert_multishot_huber_matches_tpuwave(jx):
    _, jnp, _ = jx
    p, q = _port(), _tpuwave(jx)
    c2t, c2i = _models(p.n_cells, seed=12)
    pts = [(0.3, 0.5), (0.7, 0.45)]
    obs = np.asarray(q.simulate_shots(jnp.asarray(c2t),
                                      q.snap_vertices(pts)))
    kw = dict(n_iter=3, learning_rate=0.05, misfit_kind="huber",
              huber_delta=1e-4)
    want = q.invert(obs, jnp.asarray(c2i), sources=q.snap_vertices(pts),
                    **kw)
    got = p.invert(torch.tensor(obs), torch.tensor(c2i),
                   sources=p.snap_vertices(pts), **kw)
    _close(got.misfits, want.misfits, RTOL_GRAD)
    _close(got.c2, want.c2, RTOL_GRAD)


# ---------------------------------------------------------------------------
# construction and invert guards
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw, exc, match", [
    (dict(sponge_width=0.22), ValueError, "boundary_save='ring'"),
    (dict(engine="pallas"), ValueError, "unknown engine"),
    (dict(engine="scatter"), ValueError, "adjoint='reversal' needs"),
    (dict(engine="grid"), ValueError, "adjoint='reversal' needs"),
    (dict(adjoint="remat"), ValueError, "requires adjoint='reversal'"),
    (dict(boundary_save="all"), ValueError, "boundary_save"),
    (dict(sponge_width=0.6, engine="stencil"), ValueError, "whole domain"),
    (dict(sponge_width=0.5, boundary_save="ring", source=(0.05, 0.5)),
     ValueError, "source outside the sponge"),
])
def test_construction_guards(kw, exc, match):
    kw = {"source": SRC, **kw}
    with pytest.raises(exc, match=match):
        ti.FwiProblem(NEL, GEOM, DT, STEPS, receivers=RECS,
                      dtype=torch.float64, device="cpu", **kw)


@pytest.mark.parametrize("kw, exc", [
    (dict(optimizer="lbfgs", precondition="illumination"), ValueError),
    (dict(precondition="diagonal"), ValueError),
    (dict(optimizer="sgd", precondition="illumination"), ValueError),
    (dict(optimizer="sgd"), ValueError),
    (dict(estimate_wavelet=True, wavelet=np.zeros(STEPS)), ValueError),
])
def test_invert_guards(kw, exc):
    p = _port()
    with pytest.raises(exc):
        p.invert(np.zeros((STEPS, 2)), np.ones(p.n_cells), n_iter=1, **kw)


def test_device_defaults_to_cuda():
    """Without a card the default device raises instead of moving to the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ti.FwiProblem(NEL, GEOM, DT, STEPS, source=SRC, receivers=RECS)
