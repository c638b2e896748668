"""The port's R = 2 engines against tpuwave's fused Pallas route, on the
CPU in f64.

tpuwave runs its kernels B11-B13 in interpret mode (block rows 8, its
canvases padded to (24, 128) at Nel 12 x 21); the port runs the plain
versions of its kernels on the true (24, 15) canvases. The same driven
and forced problem as test_torch_p2_engine.py; per-step CG counts
identical, states within 1e-10 relative (summation order only).
"""

import pytest
import torch

from tests import torch_threads  # noqa: F401  (one torch thread)
from tests.test_torch_p2_engine import _close, _run_both, driven_case
from tpuwave.models import fast_engine as jfe
from tpuwave.utils.params import load_params as jload
from tpuwave_torch.models import fast_engine as tfe
from tpuwave_torch.utils.params import load_params as tload

CPU = torch.device("cpu")
PALLAS = dict(use_pallas=True, pallas_block_rows=8, pallas_interpret=True)


def _case():
    return driven_case(Nel="12,21", Dt="0.1", T="0.2")


@pytest.mark.parametrize("family,solver,precond", [
    ("newmark", "3term", "mg"),
    ("theta", "3term", "jacobi"),
    ("newmark", "2term", "mg"),
])
def test_engine_matches_tpuwave_pallas_route(family, solver, precond):
    check_pallas_route(family, solver, precond)


def check_pallas_route(family, solver, precond):
    """Both engines on the same case, tpuwave on its Pallas route."""
    case = _case()
    js = jfe.make_fast_solver(jload(case), family, precond=precond,
                              solver=solver, **PALLAS)
    assert js._use_pallas and js._cshape == (24, 128)
    ts = tfe.make_fast_solver(tload(case), family, precond=precond,
                              solver=solver, dtype=torch.float64, device=CPU)
    assert ts._cshape == (24, 15)
    sj, st, t = _run_both(js, ts, case, 2)
    if solver == "2term":
        _close(ts.to_flat(ts.state_velocity(st, t)).numpy(),
               js.to_flat(js.state_velocity(sj, t)))
