"""The port's MG-PCG FastWaveSolver paths against tpuwave's:
``run_implicit_mg`` and ``run_implicit_mg_kernel`` (tpuwave:
run_implicit_mg_pallas). The 2-term chain is in test_torch_fast_2term.py.

Standing mode on the unit square at 32^2 elements, dt 0.02 (beyond the CFL
limit), ``cg_reduction=1e-11``, f64 on the CPU; the start state crosses
from tpuwave through tpuwave_torch.models.convert. tpuwave's Pallas
kernels run in interpret mode with 16-row blocks; on the CPU the port's
kernel wrappers run their plain versions. Bounds are tpuwave's own between
its fused and unfused paths (tests/test_multigrid.py): rel L2 1e-9 on u
and v.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (one torch thread)
from tpuwave.models.fast import FastWaveSolver as JSolver
from tpuwave_torch.models import convert
from tpuwave_torch.models.fast import FastWaveSolver as TSolver

GEOM, DT = ((0.0, 0.0), (1.0, 1.0)), 0.02
PALLAS = dict(block_rows=16, interpret=True)


def _u0(xs, ys):
    return jnp.sin(jnp.pi * xs) * jnp.sin(jnp.pi * ys)


def _pair(nel, scheme, **kw):
    j = JSolver((nel, nel), GEOM, DT, scheme=scheme, dtype=jnp.float64, **kw)
    t = TSolver((nel, nel), GEOM, DT, scheme=scheme, dtype=torch.float64,
                device="cpu", **kw)
    sj = j.initial_state(_u0)
    return j, t, sj, convert.to_torch(sj, "cpu", torch.float64)


def _rel(got, want):
    want = np.asarray(want)
    return (np.linalg.norm(got.numpy() - want)
            / (np.linalg.norm(want) or 1.0))


STEPPERS = [
    ("theta", dict(theta=1.0)),
    ("theta", dict(theta=0.5)),
    ("newmark", dict(beta=0.25, lumped=False)),
]


@pytest.mark.parametrize("scheme,kw", STEPPERS)
def test_run_implicit_mg_matches_tpuwave(scheme, kw):
    j, t, sj, st = _pair(32, scheme, cg_reduction=1e-11, **kw)
    want = j.run_implicit_mg(sj, 8)
    got = t.run_implicit_mg(st, 8)
    for f in ("u", "v"):
        assert _rel(getattr(got, f), getattr(want, f)) < 1e-9, f
    assert len(t.last_iterations) == 8


@pytest.mark.parametrize("scheme,kw", STEPPERS)
def test_run_implicit_mg_kernel_matches_tpuwave(scheme, kw):
    j, t, sj, st = _pair(32, scheme, cg_reduction=1e-11, **kw)
    want = j.run_implicit_mg_pallas(sj, 8, **PALLAS)
    got = t.run_implicit_mg_kernel(st, 8)
    for f in ("u", "v"):
        assert _rel(getattr(got, f), getattr(want, f)) < 1e-9, f
    fused_counts = list(t.last_iterations)
    # and against the port's own unfused path, with the same CG counts
    ref = t.run_implicit_mg(st, 8)
    for f in ("u", "v"):
        assert _rel(getattr(got, f), getattr(ref, f).numpy()) < 1e-9, f
    assert fused_counts == t.last_iterations


@pytest.mark.parametrize("scheme,kw", [("theta", dict(theta=1.0)),
                                       ("newmark", dict(beta=0.25,
                                                        lumped=False))])
def test_small_grid_runs_the_kernel_path(scheme, kw):
    """8^2: tpuwave's fused entry point falls back to run_implicit_mg
    (fewer than two row blocks, a one-level hierarchy); the port's runs
    its setup and update kernels at any size and agrees."""
    j, t, sj, st = _pair(8, scheme, **kw)
    want = j.run_implicit_mg_pallas(sj, 5, block_rows=128)
    got = t.run_implicit_mg_kernel(st, 5)
    for f in ("u", "v"):
        assert _rel(getattr(got, f), getattr(want, f)) < 1e-9, f
