"""The port's implicit FastWaveSolver steps against tpuwave's: ``step`` /
``run_scan``, ``run_implicit_kernel`` (tpuwave: run_implicit_pallas) and
``run_implicit_cheby``.

Standing mode on the unit square at 40^2 elements, dt 0.01, 4 steps, f64
on the CPU unless said; the start state crosses from tpuwave through
tpuwave_torch.models.convert, so both step from the same numbers.
tpuwave's Pallas kernels run in interpret mode with 16-row blocks. On the
CPU the port's kernel wrappers run their plain versions. Tolerances: the
two sides run the same CG / Chebyshev recurrences, so f64 trajectories
agree far below the solver tolerance (rtol 1e-9 on u, v, a for run_scan,
rel L2 1e-8 for the kernel paths); in f32 tpuwave's own bound against its
roll path, rtol 1e-3 / atol 1e-5. Also the kernel paths' V-cycle
routing by hierarchy depth (test_torch_fast_mg.py's solvers).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (one torch thread)
from tests.test_torch_fast_mg import _pair as _mg_pair
from tpuwave.models.fast import FastWaveSolver as JSolver
from tpuwave_torch.models import convert
from tpuwave_torch.models.fast import FastWaveSolver as TSolver
from tpuwave_torch.ops import kernels
from tpuwave_torch.solve.multigrid import (GmgPreconditioner,
                                          KernelGmgPreconditioner)

NEL, GEOM, DT, STEPS = (40, 40), ((0.0, 0.0), (1.0, 1.0)), 0.01, 4
PALLAS = dict(block_rows=16, interpret=True)

SCHEMES = {
    "newmark": dict(scheme="newmark", beta=0.25, gamma=0.5, lumped=False),
    "newmark-g0.6": dict(scheme="newmark", beta=0.25, gamma=0.6,
                         lumped=False),
    "theta-0.5": dict(scheme="theta", theta=0.5),
    "theta-1": dict(scheme="theta", theta=1.0),
}


def _u0(xs, ys):
    return jnp.sin(jnp.pi * xs) * jnp.sin(jnp.pi * ys)


def _pair(name, f32=False):
    """(tpuwave solver, port solver, tpuwave start state, port start
    state) for a scheme."""
    jd, td = ((jnp.float32, torch.float32) if f32
              else (jnp.float64, torch.float64))
    j = JSolver(NEL, GEOM, DT, dtype=jd, **SCHEMES[name])
    t = TSolver(NEL, GEOM, DT, dtype=td, device="cpu", **SCHEMES[name])
    sj = j.initial_state(_u0)
    return j, t, sj, convert.to_torch(sj, "cpu", td)


def _rel(got, want):
    want = np.asarray(want, dtype=np.float64)
    return (np.linalg.norm(got.double().numpy() - want)
            / (np.linalg.norm(want) or 1.0))


@pytest.mark.parametrize("name", list(SCHEMES))
def test_run_scan_matches_tpuwave(name):
    j, t, sj, st = _pair(name)
    want = j.run_scan(sj, STEPS)
    kernels.reset_launches()
    got = t.run_scan(st, STEPS)
    assert all(n == 0 for n in kernels.LAUNCHES.values())
    assert len(t.last_iterations) == STEPS
    for f in ("u", "v", "a"):
        w = np.asarray(getattr(want, f))
        np.testing.assert_allclose(getattr(got, f).numpy(), w, rtol=1e-9,
                                   atol=1e-9 * float(np.abs(w).max()))
    # deterministic: a rerun is bitwise equal, and so is stepping by hand
    again = t.run_scan(st, STEPS)
    by_hand = st
    for _ in range(STEPS):
        by_hand = t.step(by_hand)
    for f in ("u", "v", "a"):
        assert torch.equal(getattr(got, f), getattr(again, f))
        assert torch.equal(getattr(got, f), getattr(by_hand, f))


@pytest.mark.parametrize("name", ["newmark", "theta-0.5"])
def test_run_implicit_kernel_matches_tpuwave(name):
    j, t, sj, st = _pair(name)
    want = j.run_implicit_pallas(sj, STEPS, **PALLAS)
    got = t.run_implicit_kernel(st, STEPS)
    for f in ("u", "v", "a"):
        assert _rel(getattr(got, f), getattr(want, f)) < 1e-8, f
    # the same CG on the same operator as run_scan: equal counts
    counts = list(t.last_iterations)
    t.run_scan(st, STEPS)
    assert counts == t.last_iterations and all(counts)


@pytest.mark.parametrize("name", ["newmark", "theta-0.5"])
def test_run_implicit_cheby_matches_tpuwave(name):
    j, t, sj, st = _pair(name)
    kw = dict(degree=6) if name == "newmark" else dict(degree=6, degree_v=10)
    want = j.run_implicit_cheby(sj, STEPS, **kw, **PALLAS)
    got = t.run_implicit_cheby(st, STEPS, **kw)
    for f in ("u", "v", "a"):
        assert _rel(getattr(got, f), getattr(want, f)) < 1e-8, f
    # whole blocks: counts are multiples of the block degrees
    for its in t.last_iterations:
        if name == "newmark":
            assert its > 0 and its % 6 == 0
        else:
            assert its[0] > 0 and its[0] % 6 == 0
            assert its[1] > 0 and its[1] % 10 == 0
    # and the fixed 1e-6 reduction lands on run_scan's trajectory
    ref = t.run_scan(st, STEPS)
    assert _rel(got.u, ref.u.numpy()) < 1e-6


@pytest.mark.parametrize("runner", ["kernel", "cheby"])
@pytest.mark.parametrize("name", ["newmark", "theta-0.5"])
def test_f32_kernel_paths_match_tpuwave(name, runner):
    j, t, sj, st = _pair(name, f32=True)
    if runner == "kernel":
        want = j.run_implicit_pallas(sj, STEPS, **PALLAS)
        got = t.run_implicit_kernel(st, STEPS)
    else:
        want = j.run_implicit_cheby(sj, STEPS, degree=6, **PALLAS)
        got = t.run_implicit_cheby(st, STEPS, degree=6)
    assert got.u.dtype == torch.float32
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u), rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), rtol=1e-3,
                               atol=1e-4)


def test_implicit_runs_refuse_the_explicit_scheme():
    t = TSolver(NEL, GEOM, DT, beta=0.0, dtype=torch.float64, device="cpu")
    st = t.initial_state(lambda xs, ys: torch.sin(torch.pi * xs)
                         * torch.sin(torch.pi * ys))
    for run in (t.run_implicit_mg, t.run_implicit_kernel,
                t.run_implicit_mg_kernel, t.run_implicit_cheby):
        with pytest.raises(ValueError, match="beta > 0"):
            run(st, 1)
    with pytest.raises(ValueError, match="beta > 0"):
        t.run_implicit_mg_2term(t.initial_leapfrog_state(
            lambda xs, ys: xs * ys), 1)
    # the lumped scheme still steps through run_scan
    assert t.run_scan(st, 2).u.shape == t.shape
    assert t.last_iterations == [0, 0]


def test_constructor_needs_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        TSolver(NEL, GEOM, DT, scheme="theta", theta=0.5)


def test_kernel_path_routes_the_vcycle_by_depth():
    _, t, _, _ = _mg_pair(32, "newmark", beta=0.25, lumped=False)
    assert isinstance(t._kernel_gmg(), KernelGmgPreconditioner)
    _, t8, _, _ = _mg_pair(8, "theta", theta=1.0)
    one_level = t8._kernel_gmg()
    assert len(one_level.levels) == 1
    assert type(one_level) is GmgPreconditioner
    assert t.gmg_preconditioner().levels[0].sm_coeffs == ()   # degree 1
