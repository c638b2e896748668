"""Linearized imaging and encoded sources of the port's FwiProblem
(tpuwave_torch/models/inverse.py) against tpuwave's, on the CPU, in f64.

One tpuwave problem serves the file: ``engine="stencil",
adjoint="reversal"`` with a sponge in ring mode, (12, 10) elements, 20
steps, three shots (Born, the Gauss-Newton inversion and the encoded
sources; migration, RTM and LSRTM use the first). The port's stencil
engine and kernel engine (the plain versions of B14-B17) are built with
the same arguments through ``models/convert.fwi_problem_kwargs``. The
models come from a numpy seed, the data gather from the port's stencil
engine at a second model.
Tolerances: Born traces rtol 1e-10; migrate, rtm_image, lsrtm and the
Gauss-Newton product rtol 1e-9; invert_gauss_newton rtol 1e-8;
supershot traces and the encoded misfit rtol 1e-12, its gradients 1e-9;
invert_encoded (key 0, two iterations) rtol 1e-10; each with an absolute
floor of the same factor times the array's peak.

The test marked ``cuda`` runs born, a remat gradient and lsrtm on the
card against the CPU and skips where there is none.
"""

import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (one torch thread)
from tpuwave_torch.models import inverse as ti
from tpuwave_torch.models.convert import fwi_problem_kwargs

NEL, GEOM, DT, STEPS = (12, 10), ((0.0, 0.0), (1.0, 1.0)), 8e-3, 20
SRC, RECS = (0.45, 0.55), [(0.25, 0.3), (0.7, 0.65)]
SHOTS = [(0.3, 0.5), (0.7, 0.45), (0.5, 0.6)]
KW = dict(source=SRC, receivers=RECS, engine="stencil", adjoint="reversal",
          sponge_width=0.22, sponge_strength=25.0, boundary_save="ring")
CODES = np.array([1.0, -1.0, 0.5])


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _port(**over):
    return ti.FwiProblem(NEL, GEOM, DT, STEPS, **fwi_problem_kwargs(
        dtype=np.float64, **{**KW, **over}))


@pytest.fixture(scope="module")
def port():
    return {"stencil": _port(), "kernel": _port(engine="kernel")}


@pytest.fixture(scope="module")
def ref(port):
    """tpuwave's problem, its shot ids, the models, a data gather (the
    port's traces at a second model) and tpuwave's three-shot Born
    gather."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from tpuwave.models import inverse
    q = inverse.FwiProblem(NEL, GEOM, DT, STEPS, dtype=jnp.float64, **KW)
    rng = np.random.default_rng(3)
    c2 = 1.0 + 0.2 * rng.random(q.n_cells)
    c2t = 1.0 + 0.3 * rng.random(q.n_cells)
    dm = rng.standard_normal(q.n_cells)
    srcs = q.snap_vertices(SHOTS)
    p = port["stencil"]
    obs = p.simulate_shots(_t(c2t), p.snap_vertices(SHOTS)).detach().numpy()
    born = np.asarray(q.born(jnp.asarray(c2), jnp.asarray(dm), sources=srcs))
    return dict(jax=jax, jnp=jnp, q=q, srcs=srcs, c2=c2, dm=dm, obs=obs,
                born=born)


def _t(a):
    return torch.tensor(np.asarray(a))


def test_born_matches_tpuwave(ref, port):
    """Born traces (the linearized step loop), one shot and three."""
    q, jnp, p = ref["q"], ref["jnp"], port["stencil"]
    c2, dm = jnp.asarray(ref["c2"]), jnp.asarray(ref["dm"])
    sp = p.snap_vertices(SHOTS)
    assert sp.tolist() == np.asarray(ref["srcs"]).tolist()
    _close(p.born(_t(c2), _t(dm)), q.born(c2, dm), 1e-10)
    _close(p.born(_t(c2), _t(dm), sources=sp), ref["born"], 1e-10)


def test_migrate_and_rtm_image_match_tpuwave(ref, port):
    """migrate (the VJP of the data map) on the stencil engine and on
    the kernel engine (B14-B17's plain versions), and the
    illumination-normalised rtm_image, of the first shot's data."""
    q, jnp = ref["q"], ref["jnp"]
    c2, d = jnp.asarray(ref["c2"]), jnp.asarray(ref["obs"][0])
    want = q.migrate(c2, d)
    for engine in ("stencil", "kernel"):
        _close(port[engine].migrate(_t(c2), _t(d)), want, 1e-9)
    _close(port["stencil"].rtm_image(_t(c2), _t(d)), q.rtm_image(c2, d),
           1e-9)


def test_lsrtm_and_gauss_newton_hvp_match_tpuwave(ref, port):
    """Two CGLS iterations of lsrtm on the first shot's Born data (image
    and residual norms) and the damped Gauss-Newton product."""
    q, jnp, p = ref["q"], ref["jnp"], port["stencil"]
    c2, dm = jnp.asarray(ref["c2"]), jnp.asarray(ref["dm"])
    d = ref["born"][0]
    m, norms = q.lsrtm(c2, d, n_iter=2)
    m_p, norms_p = p.lsrtm(_t(c2), _t(d), n_iter=2)
    _close(m_p, m, 1e-9)
    _close(norms_p, norms, 1e-9)
    _close(p.gauss_newton_hvp(_t(c2), _t(dm), damping=0.1),
           q.gauss_newton_hvp(c2, dm, damping=0.1), 1e-9)


def test_invert_gauss_newton_matches_tpuwave(ref, port):
    """Two outer iterations of two CG steps each, with box bounds."""
    q, jnp, p = ref["q"], ref["jnp"], port["stencil"]
    kw = dict(n_outer=2, n_cg=2, damping=1e-3, bounds=(0.5, 2.0))
    want = q.invert_gauss_newton(ref["obs"], jnp.ones(q.n_cells),
                                 sources=ref["srcs"], **kw)
    got = p.invert_gauss_newton(_t(ref["obs"]), torch.ones(
        p.n_cells, dtype=torch.float64), sources=p.snap_vertices(SHOTS),
        **kw)
    _close(got.misfits, want.misfits, 1e-8)
    _close(got.c2, want.c2, 1e-8)


def test_encoded_sources_match_tpuwave(ref, port):
    """The supershot's traces, misfit_encoded with its c2 and wavelet
    gradients (tpuwave's: 0.5 ||r||^2 of its supershot's residual r and
    the supershot's VJP of r), and two iterations of invert_encoded from
    key 0 (the port takes the seed and the raw key's two words alike)."""
    jax, q, jnp, p = ref["jax"], ref["q"], ref["jnp"], port["stencil"]
    c2, obs, srcs = jnp.asarray(ref["c2"]), ref["obs"], ref["srcs"]
    sp = p.snap_vertices(SHOTS)
    ws = jnp.broadcast_to(q.wavelet, (len(SHOTS), STEPS))
    sup, vjp = jax.vjp(lambda c, w: q.simulate_supershot(
        c, srcs, jnp.asarray(CODES), w), c2, ws)
    _close(p.simulate_supershot(_t(c2), sp, _t(CODES)), sup, 1e-12)
    r = np.asarray(sup) - np.einsum("s,snr->nr", CODES, obs)
    v = 0.5 * float(np.sum(r * r))
    gc, gw = vjp(jnp.asarray(r))
    c = _t(c2).requires_grad_(True)
    w = _t(ws).requires_grad_(True)
    with torch.enable_grad():
        vp = p.misfit_encoded(c, sp, _t(CODES), _t(obs), w)
        gcp, gwp = torch.autograd.grad(vp, (c, w))
    _close(float(vp.detach()), v, 1e-12)
    _close(gcp, gc, 1e-9)
    _close(gwp, gw, 1e-9)
    kw = dict(n_iter=2, learning_rate=0.05, bounds=(0.5, 2.0))
    want = q.invert_encoded(obs, jnp.ones(q.n_cells), sources=srcs,
                            key=jax.random.PRNGKey(0), **kw)
    for key in (0, np.asarray(jax.random.PRNGKey(0))):
        got = p.invert_encoded(_t(obs), torch.ones(p.n_cells,
                                                   dtype=torch.float64),
                               sources=sp, key=key, **kw)
        _close(got.misfits, want.misfits, 1e-10)
        _close(got.c2, want.c2, 1e-10)


def test_kernel_engine_refusals(port):
    """The fused kernels inject one source and have no JVP rule:
    the kernel engine refuses the supershot, Born modelling and what is
    built on it with tpuwave's errors, naming 'kernel'."""
    p = port["kernel"]
    c2 = torch.ones(p.n_cells, dtype=torch.float64)
    obs = torch.zeros(STEPS, len(RECS), dtype=torch.float64)
    for call, what in (
            (lambda: p.simulate_supershot(c2, [1, 2], [1.0, -1.0]),
             "simulate_supershot"),
            (lambda: p.born(c2, c2), "born"),
            (lambda: p.lsrtm(c2, obs, n_iter=1), "lsrtm"),
            (lambda: p.invert_gauss_newton(obs, c2, n_outer=1),
             "invert_gauss_newton")):
        with pytest.raises(ValueError, match=f"{what} needs engine in .*"
                           "'kernel'"):
            call()


@pytest.mark.cuda
def test_cuda_born_remat_and_lsrtm_match_cpu():
    """born, a remat gradient (scatter engine) and two lsrtm iterations
    on the card against the CPU, f64, (48, 40) elements, 96 steps: rtol
    1e-10, 1e-9, 1e-9."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    runs = {}
    for dev in ("cuda", "cpu"):
        kw = dict(source=SRC, receivers=[(0.4, 0.45), (0.55, 0.62)],
                  dtype=torch.float64, device=dev)
        p = ti.FwiProblem((48, 40), GEOM, 2e-3, 96, engine="stencil", **kw)
        r = ti.FwiProblem((48, 40), GEOM, 2e-3, 96, engine="scatter",
                          adjoint="remat", **kw)
        rng = np.random.default_rng(0)
        c2 = torch.tensor(1.0 + 0.3 * rng.random(p.n_cells), device=dev)
        dm = torch.tensor(rng.standard_normal(p.n_cells), device=dev)
        d = p.born(c2, dm)
        _, g = r.misfit_and_grad(torch.ones_like(c2), r.simulate(c2))
        m, norms = p.lsrtm(c2, d, n_iter=2)
        runs[dev] = [x.cpu() for x in (d, g, m)] + [norms]
    (dc, gc, mc, nc), (dh, gh, mh, nh) = runs["cuda"], runs["cpu"]
    _close(dc, dh, 1e-10)
    _close(gc, gh, 1e-9)
    _close(mc, mh, 1e-9)
    _close(nc, nh, 1e-9)
