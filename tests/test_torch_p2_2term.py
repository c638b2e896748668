"""The port's R = 2 ``--solver 2term`` engines
(tpuwave_torch/models/fast_engine_p2_2term.py) against tpuwave's, on the
CPU in f64.

The driven and forced problem of test_torch_p2_engine.py (Nel 16, dt 0.4,
3 steps: the u-form first step and two recurrence steps with the driven
boundary lift and, for Newmark, the derived-BC strips), both packages
with the same arguments; per-step CG counts identical, states and the
reconstructed velocity within 1e-10 relative. Each package sizes its
P2 smoother by its own power iteration (the same start vector).

Also the P2 engines' entry points: they default to the card (and raise
where there is none), and the factory routes R = 2 and checks its
keyword arguments.
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


def test_p2_entry_points_default_to_the_card():
    """Engines, the factory and p2_gmg_for_system default to
    device='cuda' and raise where there is none (never a silent CPU
    run)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from tpuwave_torch.models.fast_engine_p2 import FastP2ThetaSolver
    from tpuwave_torch.models.fast_engine_p2_2term import (
        FastP22TermNewmarkSolver)
    from tpuwave_torch.solve.multigrid import p2_gmg_for_system
    p = tload(driven_case())
    for make in (lambda: FastP2ThetaSolver(p),
                 lambda: FastP22TermNewmarkSolver(p),
                 lambda: tfe.make_fast_solver(p, "newmark"),
                 lambda: tfe.make_fast_solver(p, "theta", solver="2term"),
                 lambda: p2_gmg_for_system((8, 8), ((0, 0), (1, 1)), 1.0,
                                           0.1)):
        with pytest.raises(RuntimeError, match="cuda"):
            make()


def test_p2_factory_routes_and_checks_kwargs():
    from tpuwave_torch.models.fast_engine_p2 import (FastP2NewmarkSolver,
                                                     FastP2ThetaSolver)
    p = tload(driven_case(Nel="6"))
    assert isinstance(tfe.make_fast_solver(p, "theta", device=CPU),
                      FastP2ThetaSolver)
    assert isinstance(tfe.make_fast_solver(p, "newmark", solver="cheby",
                                           device=CPU), FastP2NewmarkSolver)
    with pytest.raises(TypeError, match="use_pallas"):
        tfe.make_fast_solver(p, "theta", device=CPU, use_pallas=True)
    with pytest.raises(ValueError, match="family"):
        tfe.make_fast_solver(p, "leapfrog", device=CPU)
