"""The port's R = 2 engines (tpuwave_torch/models/fast_engine_p2.py,
``--solver 3term``) against tpuwave's, on the CPU in f64.

Every case runs a driven and forced problem (Dirichlet g(t) on the vertex
and edge-midpoint boundary planes, forcing f(x, y, t)) at Nel 16 (two P1
levels under the P2 V-cycle) with dt 0.4 (q = 10: ``--precond auto``
resolves to mg), the consistent a0 and 3 steps, through both packages with
the same arguments. Per-step CG counts must be identical, and u, v (and a)
agree within 1e-10 relative: the CG stopping rule is 1e-6 relative, and
the two sides differ in summation order only (~1e-16 per operation).

``lambda_max`` of the P2 smoother: both packages run their own power
iteration from the same start vector (the port reproduces tpuwave's
jax.random draw, tpuwave_torch/utils/prng.py), so the mg cases are held
digit for digit with no patch; test_torch_p2_multigrid.py holds the two
estimates to rtol 1e-10.

test_torch_p2_pallas.py holds the same engines against tpuwave's Pallas
route, test_torch_p2_solvers.py the ``--solver cheby|2term`` engines.
"""

import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (one torch thread)
from tpuwave.models import fast_engine as jfe
from tpuwave.utils.params import load_params as jload
from tpuwave_torch.models import fast_engine as tfe
from tpuwave_torch.utils.params import load_params as tload

CPU = torch.device("cpu")

DRIVEN = {
    "F": {"Function expression": "sin(3*pi*x)*cos(2*pi*y)*cos(5*t)",
          "Variable names": "x, y, t"},
    "G": {"Function expression": "0.1*sin(2*t)*(1+x*y)",
          "Variable names": "x, y, t"},
    "DGDT": {"Function expression": "0.2*cos(2*t)*(1+x*y)",
             "Variable names": "x, y, t"},
}


def driven_case(**over):
    case = {
        "Nel": "16", "R": "2", "T": "1.2", "Dt": "0.4", "Theta": "0.5",
        "Beta": "0.25", "Gamma": "0.5", "Save Solution": "false",
        "Log Every": "0",
        "C": {"Function expression": "1.0", "Variable names": "x, y, t"},
        "U0": {"Function expression": "sin(pi*x)*sin(pi*y)",
               "Variable names": "x, y"},
        "V0": {"Function expression": "0.0", "Variable names": "x, y"},
        **DRIVEN,
    }
    case.update(over)
    return case


def _close(got, want, rtol=1e-10):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _run_both(js, ts, case, n_steps):
    """Step both engines; per-step counts equal, states close."""
    sj, st = js.initial_state(), ts.initial_state()
    if hasattr(js, "initial_iterations"):
        assert ts.initial_iterations == js.initial_iterations
    dt, t = float(case["Dt"]), 0.0
    for _ in range(n_steps):
        t += dt
        sj, ij = js.step(sj, t)
        st, it = ts.step(st, t)
        assert it["iterations_1"] == int(ij["iterations_1"])
        assert it["iterations_2"] == int(ij["iterations_2"])
        _close(float(it["norm_u"]), float(ij["norm_u"]))
        for name in ("u", "v", "a"):
            if hasattr(st, name):
                _close(ts.to_flat(getattr(st, name)).numpy(),
                       js.to_flat(getattr(sj, name)))
    return sj, st, t


@pytest.fixture(scope="module")
def jengines():
    """tpuwave's engines of this file by (family, resolved preconditioner):
    an "auto" case, which resolves to mg, steps the mg case's engine, so
    that its step is compiled once (16-17 s at Nel 16)."""
    return {}


@pytest.mark.parametrize("precond", ["jacobi", "chebyshev", "mg", "auto"])
@pytest.mark.parametrize("family", ["newmark", "theta"])
def test_engine_matches_tpuwave_step_for_step(jengines, family, precond):
    case = driven_case()
    js = jfe.make_fast_solver(jload(case), family, precond=precond)
    ts = tfe.make_fast_solver(tload(case), family, precond=precond,
                              dtype=torch.float64, device=CPU)
    assert ts.precond == js.precond
    assert ts.precond == ("mg" if precond == "auto" else precond)
    _run_both(jengines.setdefault((family, js.precond), js), ts, case, 3)
