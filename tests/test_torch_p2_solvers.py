"""The port's R = 2 ``--solver cheby`` engines against tpuwave's, on the
CPU in f64.

The driven and forced problem of test_torch_p2_engine.py (Nel 8, dt 0.1,
2 steps), both packages with the same arguments; per-step iteration
counts identical, states within 1e-10 relative. ``--solver cheby`` takes
its spectrum bounds from the 4x4 block symbol and overrides the
preconditioner with jacobi, in both packages: every precond flag is run,
as a user may pass any.
"""

import pytest
import torch

from tests import torch_threads  # noqa: F401  (one torch thread)
from tests.test_torch_p2_engine import _run_both, driven_case
from tpuwave.models import fast_engine as jfe
from tpuwave.utils.params import load_params as jload
from tpuwave_torch.models import fast_engine as tfe
from tpuwave_torch.utils.params import load_params as tload

CPU = torch.device("cpu")


@pytest.mark.parametrize("precond", ["jacobi", "chebyshev", "mg", "auto"])
@pytest.mark.parametrize("family", ["newmark", "theta"])
def test_cheby_engine_matches_tpuwave(family, precond):
    case = driven_case(Nel="8", Dt="0.1", T="0.2")
    js = jfe.make_fast_solver(jload(case), family, precond=precond,
                              solver="cheby")
    ts = tfe.make_fast_solver(tload(case), family, precond=precond,
                              solver="cheby", dtype=torch.float64,
                              device=CPU)
    assert ts.precond == js.precond == "jacobi"
    assert ts._cheby_bounds == pytest.approx(js._cheby_bounds, rel=1e-14)
    _run_both(js, ts, case, 2)
