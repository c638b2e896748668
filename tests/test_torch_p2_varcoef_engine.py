"""The port's R = 2 engines with a spatially varying and with a
time-dependent wave speed against tpuwave's, on the CPU in f64.

The cases are test_torch_p2_cli.py's R = 2 files: the driven and forced
problem of tests/test_torch_p2_engine.py with c = 1 + 0.5 x + 0.25 y^2,
and the time-dependent MMS of tests/test_tdep_c.py (c^2 = 1 + 0.5 sin
2t), at Nel (6, 5), dt 0.1, 3 steps, through both packages with the same
arguments (the same ``mg_pre_degree``): per-step CG counts identical, u, v
(and a) within rtol 1e-10 (CG stops at 1e-6 relative; the two sides differ
in summation order only), theta's carried K(t^n) scale planes within
1e-13. Each tpuwave engine costs one XLA compile of its step (~20-40 s on
one core), so there are four, and the CLI cases run tpuwave's CLI on the
engine of the same file:

* here: theta, varying c, ``--precond mg`` (the frozen constant-c
  V-cycle); newmark, time-dependent c, ``--precond jacobi``;
* test_torch_p2_varcoef_theta.py: theta, time-dependent c,
  ``--precond chebyshev``, a ``convert.to_torch`` hand-over of its state
  after one step, and its CLI run (with the VTU contents);
* test_torch_p2_varcoef_2term.py: newmark ``--solver 2term``, varying c,
  ``--precond mg``, and its CLI run.

The cases without tpuwave (the K operator built once per step, a varying
c that is constant against the constant-c engine, the card default) are
here too.
"""

import pytest
import torch

from tests import torch_threads  # noqa: F401  (one torch thread)
from tests.test_tdep_c import tdep_case
from tests.test_torch_p2_cli import cli_case
from tests.test_torch_p2_engine import CPU, _close, _run_both, driven_case
from tpuwave_torch.models import fast_engine as tfe
from tpuwave_torch.utils.params import load_params as tload

VAR_C = {"Function expression": "1.0 + 0.5*x + 0.25*y*y",
         "Variable names": "x, y, t"}
MG_PRE_DEGREE = 4
PRESET = "standing-mode-wsol"


def case_over(cmode, **over):
    """The overrides of ``cli_case(PRESET, ...)`` for a varying ("var") or
    time-dependent ("tdep") c: Nel (6, 5), dt 0.1, 3 steps, VTU output."""
    base = (driven_case(C=VAR_C) if cmode == "var"
            else tdep_case(R="2"))
    base.update({"Nel": "6,5", "Dt": "0.1", "T": "0.3",
                 "Save Solution": "true", "Log Every": "1"}, **over)
    return base


def make_pair(cmode, family, precond, **kw):
    """tpuwave's and the port's engine (CPU, f64) on the same case."""
    from tpuwave.models import fast_engine as jfe
    from tpuwave.utils.params import load_params as jload
    case = cli_case(PRESET, **case_over(cmode))
    js = jfe.make_fast_solver(jload(case), family, precond=precond,
                              mg_pre_degree=MG_PRE_DEGREE, **kw)
    ts = tfe.make_fast_solver(tload(case), family, precond=precond,
                              mg_pre_degree=MG_PRE_DEGREE,
                              dtype=torch.float64, device=CPU, **kw)
    return js, ts, case


@pytest.mark.parametrize("family,cmode,precond", [
    ("theta", "var", "mg"),
    ("newmark", "tdep", "jacobi"),
])
def test_p2_engine_varying_c_matches_tpuwave(family, cmode, precond):
    js, ts, case = make_pair(cmode, family, precond)
    assert ts._c_mode == js._c_mode == ("varcoef" if cmode == "var"
                                        else "tdep")
    assert ts.precond == js.precond == precond
    sj, st, _ = _run_both(js, ts, case, 3)
    assert st.k_payload is None and sj.k_payload is None


@pytest.mark.parametrize("family", ["theta", "newmark"])
def test_p2_varcoef_of_a_constant_matches_constant_engine(family):
    """c written as an expression of x that is 1.0 everywhere takes the
    varcoef route (scale planes, torch-op K) and steps as the constant-c
    engine (merged stencils) does, to round-off."""
    over = case_over("var", C={"Function expression": "1.0 + 0.0*x",
                               "Variable names": "x, y, t"})
    kw = dict(precond="jacobi", dtype=torch.float64, device=CPU)
    tv = tfe.make_fast_solver(tload(cli_case(PRESET, **over)), family, **kw)
    over["C"] = {"Function expression": "1.0", "Variable names": "x, y, t"}
    tc = tfe.make_fast_solver(tload(cli_case(PRESET, **over)), family, **kw)
    assert (tv._c_mode, tc._c_mode) == ("varcoef", "const")
    sv, sc = tv.initial_state(), tc.initial_state()
    for t in (0.1, 0.2):
        sv, iv = tv.step(sv, t)
        sc, ic = tc.step(sc, t)
        assert iv["iterations_1"] == ic["iterations_1"]
    for name in ("u", "v", "a"):
        _close(getattr(sv, name).numpy(), getattr(sc, name).numpy(),
               rtol=1e-12)


def test_p2_tdep_theta_builds_k_once_per_step():
    """theta with a time-dependent c builds K(t^{n+1}) once a step and
    takes K(t^n) from the operator kept beside the carried payload."""
    from tpuwave_torch.models import fast_engine_p2 as fe2
    ts = tfe.make_fast_solver(tload(cli_case(PRESET, **case_over("tdep"))),
                              "theta", dtype=torch.float64, device=CPU)
    builds = []
    real = fe2.P2VarcoefStencil

    def counted(*a, **k):
        builds.append(1)
        return real(*a, **k)
    fe2.P2VarcoefStencil = counted
    try:
        st = ts.initial_state()
        for t in (0.1, 0.2, 0.3):
            st, _ = ts.step(st, t)
    finally:
        fe2.P2VarcoefStencil = real
    # step 1 builds K(t^0) from the initial payload and K(t^1); each later
    # step only K(t^{n+1})
    assert len(builds) == 4
    assert ts._k_last[0] is st.k_payload


@pytest.mark.parametrize("cmode", ["var", "tdep"])
def test_p2_varying_c_engines_default_to_the_card(cmode):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = tload(cli_case(PRESET, **case_over(cmode)))
    with pytest.raises(RuntimeError, match="cuda"):
        tfe.make_fast_solver(p, "theta", precond="mg")
