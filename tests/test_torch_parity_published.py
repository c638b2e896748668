"""The port's parity engine against the reference's PUBLISHED results.

The five rows of the reference's convergence sweep that
tests/test_reference_parity.py holds tpuwave's parity solvers to
(convergence-results.csv: standing mode, Nel 10, R 1, T 1), rerun through
the port's ``Discretization`` and ``ThetaSolver`` / ``NewmarkSolver`` on
the CPU in f64: the final relative L2 and H1 errors within that file's
tolerances, rtol 1e-5, and 1e-3 for theta = 0 (Forward Euler is
unconditionally unstable for the wave equation, so solver-tolerance
differences grow).
"""

import pytest
import torch

from tpuwave_torch.models.discretization import Discretization
from tpuwave_torch.models.newmark import NewmarkSolver
from tpuwave_torch.models.theta import ThetaSolver
from tpuwave_torch.utils.params import load_params

# (scheme, overrides, ref_rel_L2, ref_rel_H1): tests/test_reference_parity.py
PUBLISHED = [
    ("theta", {"Theta": "0.5", "Dt": "0.01"}, 2.099419e-01, 2.437143e-01),
    ("theta", {"Theta": "1.0", "Dt": "0.01"}, 2.783985e-01, 3.000436e-01),
    ("newmark", {"Beta": "0.0", "Dt": "0.01"}, 2.140415e-01, 2.469485e-01),
    ("newmark", {"Beta": "0.25", "Dt": "0.01"}, 2.099419e-01, 2.437144e-01),
    ("theta", {"Theta": "0.0", "Dt": "0.005"}, 1.691465e-01, 2.152858e-01),
]


def standing_mode(**over):
    """tests/test_schemes.py's standing-mode problem."""
    base = {
        "Nel": "16", "R": "1", "T": "0.1", "Theta": "0.5", "Beta": "0.25",
        "Gamma": "0.5", "Dt": "0.01",
        "Save Solution": "false", "Log Every": "0",
        "C": {"Function expression": "1.0", "Variable names": "x, y, t"},
        "F": {"Function expression": "0.0", "Variable names": "x, y, t"},
        "U0": {"Function expression": "sin(pi*x)*sin(pi*y)",
               "Variable names": "x, y"},
        "V0": {"Function expression": "0.0", "Variable names": "x, y"},
        "G": {"Function expression": "0.0", "Variable names": "x, y, t"},
        "DGDT": {"Function expression": "0.0", "Variable names": "x, y, t"},
        "Solution": {"Function expression":
                     "cos(sqrt(2)*pi*t)*sin(pi*x)*sin(pi*y)",
                     "Variable names": "x, y, t"},
    }
    base.update(over)
    return base


@pytest.mark.parametrize("scheme,over,ref_l2,ref_h1", PUBLISHED)
def test_published_convergence_rows(scheme, over, ref_l2, ref_h1):
    ov = {"Nel": "10", "T": "1", "R": "1",
          "Save Solution": "false", "Log Every": "0"}
    ov.update(over)
    p = load_params(standing_mode(**ov))
    d = Discretization(p, device=torch.device("cpu"))
    s = ThetaSolver(d) if scheme == "theta" else NewmarkSolver(d)
    st = s.initial_state()
    t = 0.0
    while t < p.t_final:
        t += p.dt
        st, _ = s.step(st, t)
    _, _, rel_l2, rel_h1 = (float(x) for x in d.errors(st.u, t))
    tol = 1e-3 if over.get("Theta") == "0.0" else 1e-5
    assert rel_l2 == pytest.approx(ref_l2, rel=tol)
    assert rel_h1 == pytest.approx(ref_h1, rel=tol)
