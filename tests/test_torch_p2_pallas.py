"""The port's R = 2 engines against tpuwave's fused Pallas route, on the
CPU in f64, and R = 2 states carried between the packages
(tpuwave_torch/models/convert.py).

tpuwave runs its kernels B11-B13 in interpret mode (block rows 8, its
canvases padded to (24, 128) at Nel 12 x 21); the port runs the plain
versions of its kernels on the true (24, 15) canvases. The same driven
and forced problem as test_torch_p2_engine.py; per-step CG counts
identical, states within 1e-10 relative (summation order only).

A tpuwave state, carried across, steps to tpuwave's next state (per-step
CG counts identical, states within 1e-10 relative): the 3-term
``FastGridState`` from tpuwave's XLA route, whose canvases are the port's
(ny+3, nx+3), and the 2-term ``P22TermState`` from its Pallas route
(interpret mode), whose canvases ``convert.to_torch(..., canvas=...)``
crops from (24, 128) to (24, 15). The way back zero-pads. The Pallas-route
case steps the tpuwave engine of the newmark 2-term mg route check
(``jengines``), so that its steps are compiled once.
"""

import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (one torch thread)
from tests.test_torch_p2_engine import _close, _run_both, driven_case
from tpuwave.models import fast_engine as jfe
from tpuwave.utils.params import load_params as jload
from tpuwave_torch.models import convert
from tpuwave_torch.models import fast_engine as tfe
from tpuwave_torch.utils.params import load_params as tload

CPU = torch.device("cpu")
PALLAS = dict(use_pallas=True, pallas_block_rows=8, pallas_interpret=True)


def _case():
    return driven_case(Nel="12,21", Dt="0.1", T="0.2")


@pytest.fixture(scope="module")
def jengines():
    """tpuwave's Pallas-route engines of this file by (family, solver,
    preconditioner)."""
    return {}


@pytest.mark.parametrize("family,solver,precond", [
    ("newmark", "3term", "mg"),
    ("theta", "3term", "jacobi"),
    ("newmark", "2term", "mg"),
])
def test_engine_matches_tpuwave_pallas_route(jengines, family, solver,
                                             precond):
    check_pallas_route(family, solver, precond, jengines)


def _pallas_engine(family, solver, precond, engines=None):
    """tpuwave's engine of ``_case()`` on its Pallas route, from
    ``engines`` when it holds one."""
    key = (family, solver, precond)
    if engines is not None and key in engines:
        return engines[key]
    js = jfe.make_fast_solver(jload(_case()), family, precond=precond,
                              solver=solver, **PALLAS)
    if engines is not None:
        engines[key] = js
    return js


def check_pallas_route(family, solver, precond, engines=None):
    """Both engines on the same case, tpuwave on its Pallas route."""
    case = _case()
    js = _pallas_engine(family, solver, precond, engines)
    assert js._use_pallas and js._cshape == (24, 128)
    ts = tfe.make_fast_solver(tload(case), family, precond=precond,
                              solver=solver, dtype=torch.float64, device=CPU)
    assert ts._cshape == (24, 15)
    sj, st, t = _run_both(js, ts, case, 2)
    if solver == "2term":
        _close(ts.to_flat(ts.state_velocity(st, t)).numpy(),
               js.to_flat(js.state_velocity(sj, t)))


@pytest.mark.parametrize("solver,nel,pallas", [("3term", "8,6", False),
                                               ("2term", "12,21", True)])
def test_state_carried_across_steps_to_tpuwaves_next_state(
        jengines, solver, nel, pallas):
    case = driven_case(Nel=nel, Dt="0.1", T="0.2")
    if pallas:
        assert case == _case()
        js = _pallas_engine("newmark", solver, "mg", jengines)
    else:
        js = jfe.make_fast_solver(jload(case), "newmark", solver=solver,
                                  precond="mg")
    ts = tfe.make_fast_solver(tload(case), "newmark", solver=solver,
                              precond="mg", dtype=torch.float64, device=CPU)
    sj, _ = js.step(js.initial_state(), 0.1)
    st = convert.to_torch(sj, CPU, torch.float64, canvas=ts._cshape)
    assert type(st).__name__ == type(sj).__name__
    assert st.u.shape == (4, *ts._cshape)
    if solver == "2term":
        assert st.n == 1 and st.vb.shape == tuple(sj.vb.shape)
    sj2, ij = js.step(sj, 0.2)
    st2, it = ts.step(st, 0.2)
    assert it["iterations_1"] == int(ij["iterations_1"])
    for name in st2._fields:
        got = getattr(st2, name)
        if isinstance(got, torch.Tensor) and got.dim() == 3:
            _close(ts.to_flat(got).numpy(), js.to_flat(getattr(sj2, name)))
    back = convert.to_numpy(st2)
    hc, wc = sj2.u.shape[1:]
    padded = convert.to_torch(back, CPU, torch.float64, type(st2).__name__,
                              canvas=(hc, wc))
    h, w = ts._cshape
    np.testing.assert_array_equal(padded.u.numpy()[:, :h, :w], back["u"])
    assert not padded.u.numpy()[:, h:].any()
    assert not padded.u.numpy()[:, :, w:].any()
