"""The port's R = 2 ``--solver 2term`` engines
(tpuwave_torch/models/fast_engine_p2_2term.py) against tpuwave's, on the
CPU in f64.

The driven and forced problem of test_torch_p2_engine.py (Nel 16, dt 0.4,
3 steps: the u-form first step and two recurrence steps with the driven
boundary lift and, for Newmark, the derived-BC strips), both packages
with the same arguments; per-step CG counts identical, states and the
reconstructed velocity within 1e-10 relative. Each package sizes its
P2 smoother by its own power iteration (the same start vector).
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


@pytest.mark.parametrize("precond", ["mg", "chebyshev"])
@pytest.mark.parametrize("family", ["newmark", "theta"])
def test_2term_engine_matches_tpuwave(family, precond):
    case = driven_case()
    js = jfe.make_fast_solver(jload(case), family, precond=precond,
                              solver="2term")
    ts = tfe.make_fast_solver(tload(case), family, precond=precond,
                              solver="2term", dtype=torch.float64,
                              device=CPU)
    assert type(ts).__name__ == type(js).__name__
    sj, st, t = _run_both(js, ts, case, 3)
    assert st.n == 3
    _close(ts.to_flat(st.u_prev).numpy(), js.to_flat(sj.u_prev))
    _close(st.vb.numpy(), sj.vb)
    _close(ts.to_flat(ts.state_velocity(st, t)).numpy(),
           js.to_flat(js.state_velocity(sj, t)))
