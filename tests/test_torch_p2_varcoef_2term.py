"""The port's R = 2 ``--solver 2term`` Newmark engine and CLI with a
spatially varying wave speed against tpuwave's, on the CPU in f64, on one
tpuwave engine (one XLA compile; see test_torch_p2_varcoef_engine.py for
the cases and tolerances): beta 1/4, ``--precond mg``, c = 1 + 0.5 x +
0.25 y^2 on the driven and forced problem, Nel (6, 5), 3 steps.

* the engines step for step, (u, u_prev) and the reconstructed velocity;
* both CLIs on the same file (tpuwave's CLI runs that engine): equal
  CSVs.
"""

import pytest

from tests import torch_threads  # noqa: F401  (one torch thread)
from tests.test_torch_p2_cli import check_cli_against_tpuwave, jit_velocity
from tests.test_torch_p2_engine import _close, _run_both
from tests.test_torch_p2_varcoef_engine import PRESET, case_over, make_pair


@pytest.fixture(scope="module")
def pair():
    """tpuwave's and the port's engines (and their case), built once for
    the two tests; tpuwave's velocity under jit (``jit_velocity``)."""
    js, ts, case = make_pair("var", "newmark", "mg", solver="2term")
    return jit_velocity(js), ts, case


def test_p2_2term_varying_c_matches_tpuwave(pair):
    js, ts, case = pair
    assert ts._c_mode == js._c_mode == "varcoef"
    sj, st, t = _run_both(js, ts, case, 3)
    _close(ts.to_flat(st.u_prev).numpy(), js.to_flat(sj.u_prev))
    _close(ts.to_flat(ts.state_velocity(st, t)).numpy(),
           js.to_flat(js.state_velocity(sj, t)))


def test_p2_cli_varying_c_newmark_2term_matches_tpuwave(tmp_path, capsys,
                                                       pair):
    js = pair[0]
    check_cli_against_tpuwave(tmp_path, capsys, "newmark", PRESET,
                              ("--solver", "2term", "--precond", "mg"),
                              case_over("var"), engine=js)
