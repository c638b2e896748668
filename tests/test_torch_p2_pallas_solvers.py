"""The port's R = 2 engines against tpuwave's fused Pallas route for the
solver and preconditioner combinations test_torch_p2_pallas.py leaves
out, on the CPU in f64: ``--solver cheby``, ``--precond chebyshev|auto``
and the 2-term recurrence with the Chebyshev preconditioner (tpuwave's
kernels in interpret mode, Nel 12 x 21, block rows 8; per-step counts
identical, states within 1e-10 relative).
"""

import pytest

from tests import torch_threads  # noqa: F401  (one torch thread)
from tests.test_torch_p2_pallas import check_pallas_route


@pytest.mark.parametrize("family,solver,precond", [
    ("theta", "cheby", "jacobi"),
    ("newmark", "3term", "chebyshev"),
    ("theta", "3term", "auto"),
    ("theta", "2term", "chebyshev"),
])
def test_solvers_match_tpuwave_pallas_route(family, solver, precond):
    check_pallas_route(family, solver, precond)
