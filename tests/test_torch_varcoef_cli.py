"""The port's R = 1 varying-C surfaces beyond the 3-term engines, against
tpuwave on the CPU in f64 (models and tolerances as in
test_torch_varcoef_engine.py):

* the 2-term engine with a varying c (mg and chebyshev): per-step CG
  counts identical, (u, u_prev) and the reconstructed velocity within
  rtol 1e-10;
* one CLI run per family whose CSVs equal tpuwave's CLI's.
"""

import pytest
import torch

from tests import torch_threads  # noqa: F401  (one torch thread)
from tests.test_torch_engine import _close, _csv_close, _files
from tests.test_torch_varcoef_engine import (CPU, _case, _cli, _step_both,
                                              _write)
from tpuwave.models import fast_engine as jfe
from tpuwave.utils.params import load_params as jload
from tpuwave_torch.models import fast_engine as tfe
from tpuwave_torch.utils.params import load_params as tload


@pytest.mark.parametrize("precond", ["mg", "chebyshev"])
@pytest.mark.parametrize("family", ["newmark", "theta"])
def test_2term_engine_varying_c_matches_tpuwave(family, precond):
    case = _case("var")
    js = jfe.make_fast_solver(jload(case), family, precond=precond,
                              solver="2term")
    ts = tfe.make_fast_solver(tload(case), family, precond=precond,
                              solver="2term", dtype=torch.float64,
                              device=CPU)
    assert not ts._fused_ok     # B5 needs a constant stencil
    sj, st, t = _step_both(js, ts, case)
    _close(st.u.numpy(), sj.u)
    _close(st.u_prev.numpy(), sj.u_prev)
    _close(ts.state_velocity(st, t).numpy(), js.state_velocity(sj, t))


@pytest.mark.parametrize("family,cmode,flags", [
    ("newmark", "var", ("--precond", "mg")),
    ("theta", "tdep", ()),
])
def test_cli_csvs_equal_tpuwave(tmp_path, capsys, family, cmode, flags):
    import importlib
    jcli = importlib.import_module(f"tpuwave.cli.{family}")
    tcli = importlib.import_module(f"tpuwave_torch.cli.{family}")
    path = _write(tmp_path, _case(cmode, **{"Log Every": "1"}), "case")
    assert _cli(jcli, path, tmp_path, "jax", flags) == 0
    assert _cli(tcli, path, tmp_path, "torch",
                ("--device", "cpu", *flags)) == 0
    capsys.readouterr()
    rj, rt = tmp_path / "jax", tmp_path / "torch"
    assert _files(rj) == _files(rt)
    csvs = [rel for rel in _files(rj) if rel.endswith(".csv")]
    assert any(rel.endswith("energy.csv") for rel in csvs)
    for rel in csvs:
        if rel.endswith("iterations.csv"):
            assert (rj / rel).read_text() == (rt / rel).read_text()
        else:
            skip = (12,) if rel.endswith("convergence.csv") else ()
            _csv_close(rj / rel, rt / rel, skip)
