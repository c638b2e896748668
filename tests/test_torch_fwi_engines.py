"""The port's FwiProblem engines, adjoints and optimizers
(tpuwave_torch/models/inverse.py, solve/lbfgs.py, utils/prng.py) against
tpuwave's, on the CPU, in f64.

tpuwave's default construction (``engine="scatter", adjoint="remat"``)
and its grid and stencil engines with the remat adjoint are built in
both packages from one set of arguments
(``models/convert.fwi_problem_kwargs``), on (12, 10) elements, 20 steps,
with hard walls and with a sponge (the strip default: remat saves no
boundary). The models come from a numpy seed, the observed traces from
the port. Tolerances: stiffness_apply rtol 1e-12; traces and misfits
rtol 1e-12, gradients rtol 1e-9; illumination, the
illumination-preconditioned Adam and the two-stage multiscale inversion
rtol 1e-9; three L-BFGS iterations with bounds, and their optimizer
state, rtol 1e-6; each with an absolute floor of the same factor times
the array's peak. ``prng.split`` / ``rademacher`` are bit-equal to
``jax.random``.

The L-BFGS cases give the source a Ricker wavelet of peak frequency
1 / (6 dt) and amplitude 1e4. Under the default wavelet (peak 1 / (20 dt),
delayed past the 20th step, amplitude 1) the 20 steps record only the
wavelet's onset and the misfit is ~1e-13: the first line search doubles
its step 20 times, and the next ones interpolate values that differ in
their last digits, where rounding alone moves the iterates by 1e-5 (both
packages take the same branches).
"""

import shutil

import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (one torch thread)
from tpuwave_torch.models import inverse as ti
from tpuwave_torch.models.convert import fwi_problem_kwargs, lbfgs_leaf_names
from tpuwave_torch.utils import checkpoint as ck
from tpuwave_torch.utils import prng

NEL, GEOM, DT, STEPS = (12, 10), ((0.0, 0.0), (1.0, 1.0)), 8e-3, 20
SRC, RECS = (0.45, 0.55), [(0.25, 0.3), (0.7, 0.65)]
SPONGE = dict(sponge_width=0.22, sponge_strength=25.0)
SHOTS = [(0.3, 0.5), (0.7, 0.45)]
LBFGS_WAVELET = 1e4 * ti.ricker_wavelet(DT * np.arange(1, STEPS + 1),
                                        1.0 / (6 * DT))
LBFGS_KW = dict(n_iter=3, optimizer="lbfgs", bounds=(0.5, 2.0))


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def jx():
    """(jax, jax.numpy, tpuwave.models.inverse)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from tpuwave.models import inverse
    return jax, jnp, inverse


def _pair(jx, **kw):
    """tpuwave's FwiProblem and the port's from the same arguments."""
    _, jnp, inverse = jx
    kw = dict(source=SRC, receivers=RECS, dtype=jnp.float64, **kw)
    return (inverse.FwiProblem(NEL, GEOM, DT, STEPS, **kw),
            ti.FwiProblem(NEL, GEOM, DT, STEPS, **fwi_problem_kwargs(**kw)))


def _models(n, seed):
    rng = np.random.default_rng(seed)
    return 1.0 + 0.3 * rng.random(n), np.ones(n)


@pytest.fixture(scope="module")
def walls(jx):
    """tpuwave's default-engine problem with hard walls and the port's
    (and its stencil engine with the reversal adjoint), observed traces
    and the start model."""
    q, p = _pair(jx)
    c2t, c2i = _models(q.n_cells, 21)
    obs = p.simulate(_t(c2t)).detach().numpy()
    stencil = ti.FwiProblem(NEL, GEOM, DT, STEPS, source=SRC, receivers=RECS,
                            dtype=torch.float64, device="cpu",
                            engine="stencil")
    return dict(q=q, p=p, stencil=stencil, c2t=c2t, c2i=c2i, obs=obs)


@pytest.fixture(scope="module")
def lbfgs(jx, tmp_path_factory):
    """tpuwave's and the port's stencil/reversal problems with the L-BFGS
    cases' wavelet, observed traces; two iterations of each package, each
    with its checkpoint (whose states agree), then tpuwave's third
    iteration resumed from the port's checkpoint: tpuwave's three
    iterations, with its checkpoint at the end."""
    _, jnp, _ = jx
    q, p = _pair(jx, engine="stencil", adjoint="reversal",
                 wavelet=LBFGS_WAVELET)
    c2t, c2i = _models(q.n_cells, 22)
    obs = p.simulate(_t(c2t)).detach().numpy()
    folder = tmp_path_factory.mktemp("lbfgs")
    two = dict(LBFGS_KW, n_iter=2)
    q.invert(obs, jnp.asarray(c2i), checkpoint=str(folder / "tpuwave2.npz"),
             **two)
    p.invert(_t(obs), _t(c2i), checkpoint=str(folder / "port2.npz"), **two)
    shutil.copy(folder / "port2.npz", folder / "tpuwave3.npz")
    want = q.invert(obs, jnp.asarray(c2i),
                    checkpoint=str(folder / "tpuwave3.npz"), **LBFGS_KW)
    return dict(q=q, p=p, c2i=c2i, obs=obs, want=want, folder=folder)


def _same_leaves(a, b):
    """Two L-BFGS checkpoints hold the same history, model and optimizer
    state, leaf by leaf (convert.lbfgs_leaf_names), within rtol 1e-6."""
    (na, ha, pa, oa), (nb, hb, pb, ob) = (ck.load_inversion(a),
                                          ck.load_inversion(b))
    names = lbfgs_leaf_names(1)
    assert na == nb and len(oa) == len(ob) == len(names)
    _close(hb, ha, 1e-6)
    _close(pb[0], pa[0], 1e-6)
    for name, x, y in zip(names, oa, ob):
        assert x.shape == y.shape and x.dtype == y.dtype, name
        _close(y, x, 1e-6)


def test_remat_engines_match_tpuwave(jx, walls):
    """scatter (tpuwave's default), grid and stencil with adjoint="remat",
    hard walls and a sponge: stiffness_apply (once an engine), traces,
    misfit and the c2 and wavelet gradients (tpuwave's by jax.vjp of
    simulate)."""
    jax, jnp, _ = jx
    u = np.random.default_rng(23).standard_normal(walls["p"].n_vertices)
    for engine in ("scatter", "grid", "stencil"):
        for sponge in ({}, SPONGE):
            if engine == "scatter" and not sponge:
                q, p = walls["q"], walls["p"]
            else:
                q, p = _pair(jx, engine=engine, **sponge)
            assert (p.engine, p.adjoint, p.remat) == (engine, "remat", True)
            c2t, c2i = _models(q.n_cells, 24)
            if not sponge:
                _close(p.stiffness_apply(_t(c2t), _t(u)),
                       q.stiffness_apply(jnp.asarray(c2t), jnp.asarray(u)),
                       1e-12)
            obs = p.simulate(_t(c2t)).detach().numpy()
            tr, vjp = jax.vjp(lambda c, w: q.simulate(c, wavelet=w),
                              jnp.asarray(c2i), q.wavelet)
            r = np.asarray(tr) - obs
            g, wg = vjp(jnp.asarray(r))
            c, w = _t(c2i).requires_grad_(True), _t(q.wavelet)
            w.requires_grad_(True)
            with torch.enable_grad():
                trp = p.simulate(c, wavelet=w)
                vp = p.misfit(c, _t(obs), wavelet=w)
                gp, wgp = torch.autograd.grad(vp, (c, w))
            _close(trp.detach(), tr, 1e-12)
            _close(float(vp.detach()), 0.5 * float(np.sum(r * r)), 1e-12)
            _close(gp, g, 1e-9)
            _close(wgp, wg, 1e-9)


def test_illumination_and_preconditioned_adam_match_tpuwave(jx, walls):
    """illumination, one shot and two, and three Adam iterations with
    precondition="illumination" (the port's stencil engine against
    tpuwave's default engine: both compute the same gradients)."""
    _, jnp, _ = jx
    q, p = walls["q"], walls["stencil"]
    c2 = jnp.asarray(walls["c2t"])
    _close(p.illumination(_t(c2)), q.illumination(c2), 1e-9)
    _close(p.illumination(_t(c2), sources=p.snap_vertices(SHOTS)),
           q.illumination(c2, sources=q.snap_vertices(SHOTS)), 1e-9)
    kw = dict(n_iter=3, learning_rate=0.05, bounds=(0.5, 2.0),
              precondition="illumination", precond_eps=1e-2)
    want = q.invert(walls["obs"], jnp.asarray(walls["c2i"]), **kw)
    got = p.invert(_t(walls["obs"]), _t(walls["c2i"]), **kw)
    _close(got.misfits, want.misfits, 1e-9)
    _close(got.c2, want.c2, 1e-9)


def test_invert_multiscale_matches_tpuwave(jx, walls):
    """Two stages (a 4 Hz low-pass, then the full band), two Adam
    iterations each."""
    _, jnp, _ = jx
    q, p = walls["q"], walls["stencil"]
    kw = dict(cutoffs=[4.0, None], n_iter=[2, 2], learning_rate=0.05,
              bounds=(0.5, 2.0))
    want = q.invert_multiscale(walls["obs"], jnp.asarray(walls["c2i"]), **kw)
    got = p.invert_multiscale(_t(walls["obs"]), _t(walls["c2i"]), **kw)
    assert got.misfits.shape == (4,)
    _close(got.misfits, want.misfits, 1e-9)
    _close(got.c2, want.c2, 1e-9)


def test_lbfgs_matches_tpuwave(lbfgs):
    """Three L-BFGS iterations with box bounds: misfits, c2, and the
    optimizer state each package's checkpoint holds at the end."""
    p, want, folder = lbfgs["p"], lbfgs["want"], lbfgs["folder"]
    got = p.invert(_t(lbfgs["obs"]), _t(lbfgs["c2i"]),
                   checkpoint=str(folder / "port3.npz"), **LBFGS_KW)
    _close(got.misfits, want.misfits, 1e-6)
    _close(got.c2, want.c2, 1e-6)
    _same_leaves(folder / "tpuwave3.npz", folder / "port3.npz")


def test_lbfgs_checkpoint_crosses_packages(lbfgs):
    """After two iterations both packages' checkpoints hold the same
    state, leaf by leaf; tpuwave resumed from the port's (the fixture's
    third iteration), and the port resumes from tpuwave's and ends where
    tpuwave does."""
    p, want, folder = lbfgs["p"], lbfgs["want"], lbfgs["folder"]
    _same_leaves(folder / "tpuwave2.npz", folder / "port2.npz")
    got = p.invert(_t(lbfgs["obs"]), _t(lbfgs["c2i"]),
                   checkpoint=str(folder / "tpuwave2.npz"), **LBFGS_KW)
    _close(got.misfits, want.misfits, 1e-6)
    _close(got.c2, want.c2, 1e-6)


def test_prng_split_and_rademacher_equal_jax(jx):
    """split (jax's partitionable fold) and rademacher for three keys,
    given as seeds and as raw key words: float64 draws as jax does with
    x64 on, float32 as it does with x64 off (a float32 uniform)."""
    jax, jnp, _ = jx
    for seed in (0, 7, 2 ** 33 + 5):
        key = jax.random.PRNGKey(seed)
        want = [tuple(int(w) for w in k)
                for k in np.asarray(jax.random.split(key, 3))]
        assert prng.split(seed, 3) == want
        assert prng.split(np.asarray(key), 3) == want
        sub = jax.random.split(key)[1]
        for dtype in ("float32", "float64"):
            if dtype == "float64":
                ref = jax.random.rademacher(sub, (257,), dtype=jnp.float64)
            else:
                ref = 2.0 * jax.random.bernoulli(sub, np.float32(0.5),
                                                 (257,)) - 1.0
            got = prng.rademacher(np.asarray(sub), 257,
                                  getattr(torch, dtype))
            assert got.dtype == getattr(torch, dtype)
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_constructor_and_invert_guards(walls):
    """tpuwave's guards: the reversal adjoint on the stencil-plane engines
    only, the kernel engine with it alone, the kernel engine's ring;
    a remat problem needs no sigma == 0 interior; invert's precondition
    and optimizer."""
    kw = dict(source=SRC, receivers=RECS, dtype=torch.float64,
              device="cpu")
    for over, match in (
            (dict(engine="scatter"), "adjoint='reversal' needs"),
            (dict(engine="grid"), "adjoint='reversal' needs"),
            (dict(engine="kernel", adjoint="remat"),
             "engine='kernel' requires adjoint='reversal'"),
            (dict(engine="kernel", sponge_width=0.22),
             "boundary_save='ring'"),
            (dict(engine="pallas"), "unknown engine"),
            (dict(adjoint="checkpoint"), "unknown adjoint"),
            (dict(engine="stencil", sponge_width=0.6), "whole domain")):
        with pytest.raises(ValueError, match=match):
            ti.FwiProblem(NEL, GEOM, DT, STEPS, **kw, **over)
    p = ti.FwiProblem(NEL, GEOM, DT, STEPS, engine="grid", adjoint="remat",
                      sponge_width=0.6, **kw)
    assert p._sponge_rects is None
    p = walls["stencil"]
    obs, c2 = np.zeros((STEPS, 2)), np.ones(p.n_cells)
    for over, match in (
            (dict(precondition="diagonal"), "unknown precondition"),
            (dict(precondition="illumination", optimizer="lbfgs"),
             "needs optimizer='adam'"),
            (dict(optimizer="sgd"), "unknown optimizer")):
        with pytest.raises(ValueError, match=match):
            p.invert(obs, c2, n_iter=1, **over)
