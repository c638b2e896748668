"""The port's parity engine (models/theta.py, models/newmark.py on the
gather-path ``Discretization``) against tpuwave's, on the CPU in f64.

Each case builds both packages' solver on the same driven and forced
problem (Dirichlet g(t), forcing f(x, y, t); ``tests/test_torch_engine.py``'s
case), then 4 steps: the per-step CG counts (and Newmark's a0 solve) are
equal and u, v (and a) agree within rtol 1e-10 (the CG stopping tolerance
is 1e-6 relative; the two sides differ only in summation order). Cases:
theta 1/2 jacobi; theta 1 mg at Nel 16 (a two-level hierarchy: the fine
level on the kernel cycle, B4 / B3's plain versions here); Newmark 1/4
chebyshev; Newmark 0 ``lumped_explicit``; theta 1/2 chebyshev with a
time-dependent C (the per-step Gershgorin bound); R = 2 mg (the flat
(p+h) cycle).
"""

import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (one torch thread)
from tpuwave.models.discretization import Discretization as JDisc
from tpuwave.models.newmark import NewmarkSolver as JNewmark
from tpuwave.models.theta import ThetaSolver as JTheta
from tpuwave.utils.params import load_params as jload
from tpuwave_torch.models.discretization import Discretization
from tpuwave_torch.models.newmark import NewmarkSolver
from tpuwave_torch.models.theta import ThetaSolver
from tpuwave_torch.solve.multigrid import KernelGmgPreconditioner
from tpuwave_torch.utils.params import load_params as tload

CPU = torch.device("cpu")
TDEP_C = {"Time Dependent C": "true",
          "C": {"Function expression": "1 + 0.4*x*sin(3*t) + 0.2*y",
                "Variable names": "x, y, t"}}


def _driven_case(**over):
    case = {
        "Nel": "8,6", "T": "0.05", "Dt": "0.01",
        "C": {"Function expression": "1.0"},
        "F": {"Function expression": "sin(3*pi*x)*cos(2*pi*y)*cos(5*t)",
              "Variable names": "x, y, t"},
        "U0": {"Function expression": "sin(pi*x)*sin(pi*y)",
               "Variable names": "x, y"},
        "V0": {"Function expression": "0.0"},
        "G": {"Function expression": "0.1*sin(2*t)*(1+x*y)",
              "Variable names": "x, y, t"},
        "DGDT": {"Function expression": "0.2*cos(2*t)*(1+x*y)",
                 "Variable names": "x, y, t"},
    }
    case.update(over)
    return case


CASES = {
    "theta-0.5-jacobi": ("theta", {"Theta": "0.5"}, {}),
    "theta-1-mg": ("theta", {"Theta": "1.0", "Nel": "16", "Dt": "0.05"},
                   {"precond": "mg"}),
    "newmark-0.25-chebyshev": ("newmark", {"Beta": "0.25"},
                               {"precond": "chebyshev"}),
    "newmark-0-lumped": ("newmark", {"Beta": "0.0"},
                         {"lumped_explicit": True}),
    "theta-0.5-tdep-chebyshev": ("theta", {"Theta": "0.5", **TDEP_C},
                                 {"precond": "chebyshev"}),
    "theta-0.5-r2-mg": ("theta", {"Theta": "0.5", "R": "2", "Nel": "4",
                                  "Dt": "0.05"}, {"precond": "mg"}),
}


def _close(got, want, rtol=1e-10):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("name", list(CASES))
def test_parity_engine_matches_tpuwave(name):
    family, over, kw = CASES[name]
    case = _driven_case(**over)
    jcls, tcls = ((JTheta, ThetaSolver) if family == "theta"
                  else (JNewmark, NewmarkSolver))
    js = jcls(JDisc(jload(case)), **kw)
    ts = tcls(Discretization(tload(case), device=CPU), **kw)
    if name == "theta-1-mg":
        assert isinstance(ts.prec_u.cycle, KernelGmgPreconditioner)
    sj, st = js.initial_state(), ts.initial_state()
    fields = ("u", "v", "a") if family == "newmark" else ("u", "v")
    if family == "newmark":
        assert ts.initial_iterations == js.initial_iterations
    for f in fields:
        _close(getattr(st, f), getattr(sj, f))
    t = 0.0
    for _ in range(4):
        t += float(case["Dt"])
        sj, ij = js.step(sj, t)
        st, it = ts.step(st, t)
        assert (it["iterations_1"], it["iterations_2"]) == \
            (int(ij["iterations_1"]), int(ij["iterations_2"]))
        for f in fields:
            _close(getattr(st, f), getattr(sj, f))
    if "Time Dependent C" in over:
        _close(st.k_payload, sj.k_payload)
