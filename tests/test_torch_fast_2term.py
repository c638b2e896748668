"""The port's 2-term chain of FastWaveSolver against tpuwave's:
``implicit_2term_init`` -> ``run_implicit_mg_2term`` ->
``implicit_2term_finish``, with ``initial_state_consistent``.

Standing mode on the unit square at 32^2 elements, dt 0.02 (beyond the CFL
limit), ``cg_reduction=1e-11``, 12 steps in all, f64 on the CPU; the start
state crosses from tpuwave through tpuwave_torch.models.convert.
``kernel=True`` is held against tpuwave's ``pallas=True`` (interpret mode,
16-row blocks), ``kernel=False`` against its XLA path; on the CPU the
port's kernel wrappers run their plain versions. Bounds are tpuwave's own
between the chain and its 3-array path
(tests/test_multigrid.py::test_implicit_2term_matches_3array): rel L2 1e-8
on u and v, 1e-5 on a for Newmark (CG-tolerance residuals amplified by
M^-1 in the consistent-a solves).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (one torch thread)
from tpuwave.models.fast import FastWaveSolver as JSolver
from tpuwave_torch.models import convert
from tpuwave_torch.models.fast import FastWaveSolver as TSolver

GEOM, DT, NEL = ((0.0, 0.0), (1.0, 1.0)), 0.02, 32
PALLAS = dict(block_rows=16, interpret=True)


def _u0(xs, ys):
    return jnp.sin(jnp.pi * xs) * jnp.sin(jnp.pi * ys)


def _pair(scheme, **kw):
    j = JSolver((NEL, NEL), GEOM, DT, scheme=scheme, dtype=jnp.float64, **kw)
    t = TSolver((NEL, NEL), GEOM, DT, scheme=scheme, dtype=torch.float64,
                device="cpu", **kw)
    sj = (j.initial_state_consistent(_u0) if scheme == "newmark"
          else j.initial_state(_u0))
    return j, t, sj, convert.to_torch(sj, "cpu", torch.float64)


def _rel(got, want):
    want = np.asarray(want)
    return (np.linalg.norm(got.numpy() - want)
            / (np.linalg.norm(want) or 1.0))


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("scheme,kw,check_a", [
    ("newmark", dict(beta=0.25, gamma=0.5, lumped=False), True),
    ("newmark", dict(beta=0.25, gamma=0.6, lumped=False), True),
    ("theta", dict(theta=0.5), False),
    ("theta", dict(theta=1.0), False),
])
def test_2term_chain_matches_tpuwave(scheme, kw, check_a, kernel):
    n = 12
    j, t, sj, st = _pair(scheme, cg_reduction=1e-11, **kw)
    # the consistent start is the same solve on both sides
    assert _rel(st.a, sj.a) == 0.0
    if scheme == "newmark":
        mine = t.initial_state_consistent(
            lambda xs, ys: torch.sin(torch.pi * xs) * torch.sin(torch.pi * ys))
        assert _rel(mine.a, sj.a) < 1e-9
    lj0 = j.implicit_2term_init(sj)
    lt0 = t.implicit_2term_init(st)
    assert _rel(lt0.u, lj0.u) < 1e-10
    pallas = dict(pallas=True, **PALLAS) if kernel else dict(pallas=False)
    want = j.implicit_2term_finish(j.run_implicit_mg_2term(lj0, n - 1,
                                                           **pallas))
    got = t.implicit_2term_finish(t.run_implicit_mg_2term(lt0, n - 1,
                                                          kernel=kernel))
    names = (("u", 1e-8), ("v", 1e-8)) + ((("a", 1e-5),) if check_a else ())
    for f, tol in names:
        assert _rel(getattr(got, f), getattr(want, f)) < tol, f
    # the chain reproduces the 3-array trajectory (tpuwave's own check)
    ref = t.run_implicit_mg(st, n)
    for f, tol in names:
        assert _rel(getattr(got, f), getattr(ref, f).numpy()) < tol, f
