"""The port's R = 1 engines with a spatially varying and with a
time-dependent wave speed against tpuwave's fast engine, on the CPU in
f64.

* FastNewmarkSolver (beta 1/4, and beta 0 once) and FastThetaSolver
  (theta 1/2) with ``--precond jacobi``, ``mg`` (the frozen constant-c
  V-cycle) and once ``chebyshev``, on tpuwave's own models:
  c = 1 + 0.5 x + 0.25 y^2 on the driven, forced problem of
  tests/test_fast_engine.py:187 and the time-dependent MMS of
  tests/test_tdep_c.py (tests/test_fast_engine.py:206), Nel 16: per-step
  CG counts identical, states within rtol 1e-10 (CG stops at 1e-6
  relative; the two sides differ in summation order only), theta's
  carried K(t^n) payload within 1e-13;
* GridDiagnostics' varcoef energy and the frozen-c reference constant.

* the refusals: 2term with a time-dependent C and cheby with a varying C
  print tpuwave's own messages, at R = 1 and at R = 2.

test_torch_varcoef_cli.py holds the 2-term engine and the CLIs.
"""

import json

import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (one torch thread)
from tests.test_fast_engine import driven_case
from tests.test_tdep_c import tdep_case
from tests.test_torch_engine import _close
from tpuwave.models import fast_engine as jfe
from tpuwave.utils.params import load_params as jload
from tpuwave_torch.models import fast_engine as tfe
from tpuwave_torch.utils.params import load_params as tload

CPU = torch.device("cpu")
VAR_C = {"Function expression": "1.0 + 0.5*x + 0.25*y*y",
         "Variable names": "x, y, t"}


def _case(cmode, **over):
    if cmode == "var":
        return driven_case(C=VAR_C, Dt="0.02", T="0.08", **over)
    return tdep_case(Dt="0.02", T="0.08", **over)


def _step_both(js, ts, case, n_steps=4):
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
    return sj, st, t


@pytest.mark.parametrize("family,cmode,precond,over", [
    ("newmark", "var", "jacobi", {}),
    ("newmark", "var", "mg", {}),
    ("newmark", "var", "chebyshev", {}),
    ("newmark", "var", "jacobi", {"Beta": "0.0"}),
    ("newmark", "tdep", "jacobi", {}),
    ("newmark", "tdep", "mg", {}),
    ("theta", "var", "jacobi", {}),
    ("theta", "var", "mg", {}),
    ("theta", "tdep", "jacobi", {}),
    ("theta", "tdep", "mg", {}),
    ("theta", "tdep", "chebyshev", {}),
])
def test_engine_matches_tpuwave_fast_engine(family, cmode, precond, over):
    case = _case(cmode, **over)
    js = jfe.make_fast_solver(jload(case), family, precond=precond)
    ts = tfe.make_fast_solver(tload(case), family, precond=precond,
                              dtype=torch.float64, device=CPU)
    assert ts._c_mode == js._c_mode == ("varcoef" if cmode == "var"
                                        else "tdep")
    sj, st, _ = _step_both(js, ts, case)
    for name in ("u", "v", "a"):
        _close(getattr(st, name).numpy(), getattr(sj, name))
    if family == "theta" and cmode == "tdep":
        np.testing.assert_allclose(st.k_payload.numpy(),
                                   np.asarray(sj.k_payload), rtol=1e-13)
    else:
        assert st.k_payload is None and sj.k_payload is None


def test_varcoef_diagnostics_and_frozen_c_match_tpuwave():
    from tpuwave.models.grid_diag import GridDiagnostics as JDiag
    from tpuwave.models.theta import _frozen_c_ref
    from tpuwave_torch.models.grid_diag import GridDiagnostics as TDiag
    case = _case("var")
    dj = JDiag(jload(case))
    dt_ = TDiag(tload(case), dtype=torch.float64, device=CPU)
    rng = np.random.default_rng(9)
    u, v = rng.standard_normal((2, dt_.n_dofs))
    _close(float(dt_.energy(torch.tensor(u), torch.tensor(v))),
           float(dj.energy(u, v)), rtol=1e-13)
    _close(tfe._frozen_c_ref(dt_), _frozen_c_ref(dj), rtol=1e-14)


def _write(tmp_path, case, name):
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(case))
    return path


def _cli(module, path, tmp_path, tag, extra=()):
    return module.main([str(path), "--results-root", str(tmp_path / tag),
                        "--mesh-root", str(tmp_path / "mesh"), *extra])


@pytest.mark.parametrize("r", ["1", "2"])
@pytest.mark.parametrize("cmode,flags", [("tdep", ("--solver", "2term")),
                                         ("var", ("--solver", "cheby"))])
def test_cli_refusals_match_tpuwave(tmp_path, capsys, cmode, flags, r):
    from tpuwave.cli import newmark as jcli
    from tpuwave_torch.cli import newmark as tcli
    path = _write(tmp_path, _case(cmode, R=r), "case")
    assert _cli(jcli, path, tmp_path, "jax", flags) == 1
    err_j = capsys.readouterr().err
    assert _cli(tcli, path, tmp_path, "torch",
                ("--device", "cpu", *flags)) == 1
    err_t = capsys.readouterr().err
    assert err_t == err_j and err_t.startswith(f"--solver {flags[1]} ")
    assert "Traceback" not in err_t
