"""The port's geometric multigrid (tpuwave_torch/solve/multigrid.py) and
Chebyshev pieces against tpuwave's, on the CPU in f64.

* The P1 transfers on ragged planes: rtol 1e-14 (the same two-term sums).
* The level hierarchy: the same stencils, smoother schedules and coarse
  schedule (host-side numpy on both sides: equal to rounding).
* One V-cycle on a random interior residual: the port's
  GmgPreconditioner and KernelGmgPreconditioner (B3 / B4 plain versions
  on the CPU) against tpuwave's GmgPreconditioner and
  PallasGmgPreconditioner (interpret mode), rtol 1e-11.
* ``precond='auto'`` resolves as tpuwave's engines resolve it.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (one torch thread)
from tpuwave.solve import multigrid as jmg
from tpuwave.utils.params import load_params as jload
from tpuwave_torch.models import fast_engine as tfe
from tpuwave_torch.solve import multigrid as tmg
from tpuwave_torch.utils.params import load_params as tload

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
GEOM = ((0.0, 0.0), (1.0, 1.3))


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.mark.parametrize("shape", [(9, 7), (17, 13), (33, 5)])
def test_transfers_match_tpuwave(shape):
    import jax.numpy as jnp
    rng = np.random.default_rng(21)
    c = rng.normal(size=shape)
    np.testing.assert_allclose(tmg.prolong_p1(_t(c)).numpy(),
                               np.asarray(jmg.prolong_p1(jnp.asarray(c))),
                               rtol=1e-14, atol=1e-15)
    f = rng.normal(size=(2 * shape[0] - 1, 2 * shape[1] - 1))
    np.testing.assert_allclose(tmg.restrict_p1(_t(f)).numpy(),
                               np.asarray(jmg.restrict_p1(jnp.asarray(f))),
                               rtol=1e-14, atol=1e-15)


def test_restrict_is_the_transpose_of_prolong():
    rng = np.random.default_rng(22)
    c, f = _t(rng.normal(size=(9, 6))), _t(rng.normal(size=(17, 11)))
    lhs = torch.dot(tmg.prolong_p1(c).reshape(-1), f.reshape(-1))
    rhs = torch.dot(c.reshape(-1), tmg.restrict_p1(f).reshape(-1))
    assert abs(float(lhs - rhs)) <= 1e-13 * abs(float(lhs))


@pytest.mark.parametrize("nel,coef", [((64, 48), 1e-4), ((32, 32), 2.5e-3),
                                      ((20, 14), 0.0)])
def test_levels_match_tpuwave(nel, coef):
    tg = tmg.gmg_for_system(nel, GEOM, 1.3, coef)
    jg = jmg.gmg_for_system(nel, GEOM, 1.3, coef)
    assert len(tg.levels) == len(jg.levels)
    for a, b in zip(tg.levels, jg.levels):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.stencil, b.stencil, rtol=1e-15)
        np.testing.assert_allclose(a.sm_theta, b.sm_theta, rtol=1e-15)
        np.testing.assert_allclose(a.sm_coeffs, b.sm_coeffs, rtol=1e-15)
    np.testing.assert_allclose(tg.coarse_theta, jg.coarse_theta, rtol=1e-15)
    np.testing.assert_allclose(tg.coarse_coeffs, jg.coarse_coeffs,
                               rtol=1e-15)


def _interior_residual(shape, seed):
    h, w = shape
    b = np.zeros((h, w))
    b[1:-1, 1:-1] = np.random.default_rng(seed).normal(size=(h - 2, w - 2))
    return b


def _port_cycles(nel, coef):
    tg = tmg.gmg_for_system(nel, GEOM, 1.0, coef)
    return tg, tmg.KernelGmgPreconditioner(tg.levels, tg.coarse_theta,
                                           tg.coarse_coeffs)


@pytest.mark.parametrize("nel,coef", [((32, 48), 2e-2), ((64, 16), 4e-4)])
def test_vcycle_matches_tpuwave(nel, coef):
    """The plain and kernel cycles against tpuwave's cycle on the same
    random interior residual (3 and 2 levels)."""
    import jax.numpy as jnp
    jg = jmg.gmg_for_system(nel, GEOM, 1.0, coef)
    assert len(jg.levels) >= 2
    b = _interior_residual(jg.levels[0].shape, 23)
    want = np.asarray(jg(jnp.asarray(b)))
    scale = float(np.abs(want).max())
    for got in _port_cycles(nel, coef):
        np.testing.assert_allclose(got(_t(b)).numpy(), want, rtol=1e-11,
                                   atol=1e-11 * scale)


def test_kernel_vcycle_matches_pallas_vcycle():
    """KernelGmgPreconditioner against PallasGmgPreconditioner (interpret
    mode, zero-padded to its block layout and sliced back)."""
    import jax.numpy as jnp
    nel, coef = (32, 32), 1e-3
    jg = jmg.gmg_for_system(nel, GEOM, 1.0, coef)
    h, w = jg.levels[0].shape
    b = _interior_residual((h, w), 24)
    bp = np.zeros((-(-h // 8) * 8, -(-w // 128) * 128))
    bp[:h, :w] = b
    jp = jmg.PallasGmgPreconditioner(jg.levels, jg.coarse_theta,
                                     jg.coarse_coeffs, block_rows=8,
                                     interpret=True)
    want = np.asarray(jp(jnp.asarray(bp)))[:h, :w]
    got = _port_cycles(nel, coef)[1](_t(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-11,
                               atol=1e-11 * float(np.abs(want).max()))


def test_kernel_cycle_needs_two_levels():
    g = tmg.gmg_for_system((12, 12), GEOM, 1.0, 1e-3)
    assert len(g.levels) == 1
    with pytest.raises(ValueError, match="2 levels"):
        tmg.KernelGmgPreconditioner(g.levels, g.coarse_theta,
                                    g.coarse_coeffs)


def _standing(**over):
    case = json.loads((ROOT / "parameters" /
                       "standing-mode-wsol.json").read_text())
    case.update({"Nel": "32", "Dt": "0.01", "T": "0.05", "Beta": "0.25",
                 "Theta": "0.5"})
    case.update(over)
    return case


@pytest.mark.parametrize("family,over,want", [
    # CFL-breaking dt: q = 0.25 * 0.5^2 * 32^2 = 64 -> mg
    ("theta", {"Dt": "0.5"}, "mg"),
    ("newmark", {"Dt": "0.5"}, "mg"),
    # CFL-scale dt: q = 0.0256 -> jacobi
    ("theta", {}, "jacobi"),
    ("newmark", {}, "jacobi"),
    # the explicit schemes' systems are the bare mass -> jacobi
    ("newmark", {"Dt": "0.5", "Beta": "0"}, "jacobi"),
    ("theta", {"Dt": "0.5", "Theta": "0"}, "jacobi"),
    # q = 0.25 * 0.2^2 * 32^2 = 10.24, just over the threshold
    ("theta", {"Dt": "0.2"}, "mg"),
])
def test_auto_precond_resolves_as_tpuwave(family, over, want):
    from tpuwave.models import fast_engine as jfe
    case = _standing(**over)
    js = jfe.make_fast_solver(jload(case), family, precond="auto")
    ts = tfe.make_fast_solver(tload(case), family, precond="auto",
                              dtype=torch.float64, device=CPU)
    assert ts.precond == js.precond == want


def test_auto_precond_stays_jacobi_for_time_dependent_c():
    case = _standing(Dt="0.5", **{
        "Time Dependent C": "true",
        "C": {"Function expression": "1.0 + 0.1*t",
              "Variable names": "x, y, t"}})
    p = tload(case)
    mesh = tfe.FastWaveSolver(p.nel, p.geometry, p.dt, device=CPU).mesh
    assert tmg.auto_precond(p, mesh, 0.25 * 0.25) == "jacobi"
    assert tmg.auto_precond(tload(_standing(Dt="0.5")), mesh,
                            0.25 * 0.25) == "mg"
