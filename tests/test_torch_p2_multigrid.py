"""The port's P2 operators, transfers, (p+h)-multigrid V-cycle and
diagnostics against tpuwave's, on the CPU in f64.

* P2PlaneStencil (flat and canvas applies, diagonal), the flat <-> planes
  <-> canvases plumbing and the p <-> h transfers on random data over a
  ragged mesh (Nel 17 x 11);
* one V-cycle of P2GmgPreconditioner (flat) and of
  P2CanvasGmgPreconditioner (canvases; its smoothing blocks are B12 / B13,
  whose CPU form is the kernels' plain versions) on the same random
  residual, with tpuwave's lambda_max handed to both;
* estimate_lambda_max on the same operator against tpuwave's at rtol
  1e-10 (the port reproduces tpuwave's jax.random start vector);
* P2GridDiagnostics: energy, probe, errors and interpolation;
* p2_varcoef_data (test_torch_p2_varcoef.py's case) at 1e-14;

all at 1e-12 relative (the two sides add the same terms in different
orders; f64 roundoff is ~1e-16 per operation, a V-cycle is ~40 applies).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tests import torch_threads  # noqa: F401  (one torch thread)
from tests.test_torch_p2_varcoef import _case as _vc_case
from tests.test_torch_p2_varcoef import _close as _vc_close
from tests.test_torch_p2_varcoef import _spaces as _vc_spaces
from tpuwave.core.mesh import FeSpace as JFeSpace
from tpuwave.core.mesh import StructuredTriMesh as JMesh
from tpuwave.core.quadrature import gauss_simplex as jgauss
from tpuwave.ops import assembly as jasm
from tpuwave.ops import stencil_p2 as js2
from tpuwave.solve import multigrid as jmg
from tpuwave.utils.params import load_params as jload
from tpuwave_torch.core.mesh import FeSpace, StructuredTriMesh
from tpuwave_torch.core.quadrature import gauss_simplex
from tpuwave_torch.ops import assembly as tasm
from tpuwave_torch.ops import stencil_p2 as ts2
from tpuwave_torch.solve import multigrid as tmg
from tpuwave_torch.utils.params import load_params as tload

NX, NY = 17, 11
GEOM = ((0.0, 0.0), (1.0, 1.3))
CPU = torch.device("cpu")
REL = 1e-12


def _close(got, want, rel=REL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rel,
                               atol=rel * float(np.abs(want).max()))


def _pair(which, coef=0.0):
    """The same stencil built by both packages."""
    jsp = JFeSpace(JMesh((NX, NY), GEOM), 2)
    tsp = FeSpace(StructuredTriMesh((NX, NY), GEOM), 2)
    jq, tq = jgauss(3), gauss_simplex(3)
    jm = js2.P2PlaneStencil(jsp, jasm.element_mass_class(jsp, jq),
                            jnp.float64)
    tm = ts2.P2PlaneStencil(tsp, tasm.element_mass_class(tsp, tq),
                            torch.float64, CPU)
    if which == "mass":
        return jm, tm
    jk = js2.P2PlaneStencil(jsp, jasm.element_stiffness_class(jsp, jq, 2.0),
                            jnp.float64)
    tk = ts2.P2PlaneStencil(tsp, tasm.element_stiffness_class(tsp, tq, 2.0),
                            torch.float64, CPU)
    if which == "stiff":
        return jk, tk
    return jm.axpy(coef, jk), tm.axpy(coef, tk)


def _n_dofs():
    return FeSpace(StructuredTriMesh((NX, NY), GEOM), 2).n_dofs


@pytest.mark.parametrize("which", ["mass", "stiff", "system"])
def test_plane_stencil_matches_tpuwave(which):
    jst, tst = _pair(which, coef=0.01)
    assert tst.coeffs == jst.coeffs
    assert tst.plane_diag == jst.plane_diag
    x = np.random.default_rng(1).standard_normal(_n_dofs())
    _close(tst(torch.tensor(x)).numpy(), jst(jnp.asarray(x)))
    _close(tst.diagonal().numpy(), jst.diagonal())
    cs = ts2.canvas_shape(NX, NY)
    assert cs == js2.canvas_shape(NX, NY)
    xc_t = ts2.planes_to_canvases(
        ts2.flat_to_planes(torch.tensor(x), NX, NY), cs)
    xc_j = js2.planes_to_canvases(js2.flat_to_planes(jnp.asarray(x), NX, NY),
                                  cs)
    np.testing.assert_array_equal(xc_t.numpy(), np.asarray(xc_j))
    _close(tst.apply_canvases(xc_t).numpy(), jst.apply_canvases(xc_j))
    back = ts2.planes_to_flat(ts2.canvases_to_planes(xc_t, NX, NY))
    np.testing.assert_array_equal(back.numpy(), x)


def test_transfers_match_tpuwave():
    rng = np.random.default_rng(2)
    c = rng.standard_normal((NY + 1, NX + 1))
    pj = jmg.prolong_p1_to_p2(jnp.asarray(c))
    pt = tmg.prolong_p1_to_p2(torch.tensor(c))
    for q in "VHWD":
        _close(pt[q].numpy(), pj[q])
    planes = {q: rng.standard_normal(s)
              for q, s in ts2.p2_plane_shapes(NX, NY).items()}
    _close(tmg.restrict_p2_to_p1({q: torch.tensor(v)
                                  for q, v in planes.items()}).numpy(),
           jmg.restrict_p2_to_p1({q: jnp.asarray(v)
                                  for q, v in planes.items()}))
    np.testing.assert_array_equal(
        tmg._p2_interior_flat(NX, NY, CPU).numpy(),
        np.asarray(jmg._p2_interior_flat(NX, NY)))


@pytest.fixture(scope="module")
def vcycles():
    """tpuwave's and the port's (p+h) hierarchy for M + 0.03 K at
    pre-degree 4 (the engine's), with tpuwave's lambda_max in both."""
    nel = (NX + 7, NY + 5)     # 24 x 16: two P1 levels
    kw = dict(pre_degree=4, smooth_range=8.0)
    jpre = jmg.p2_gmg_for_system(nel, GEOM, 1.5, 0.03, dtype=jnp.float64,
                                 **kw)
    # the estimate tpuwave's hierarchy was sized with (a fixed PRNG key)
    from tpuwave.solve import chebyshev as jch
    system = jpre.system
    interior = jmg._p2_interior_flat(*nel)
    diag = system.diagonal()

    def apply_c(x):
        xi = jnp.where(interior, x, 0.0)
        return jnp.where(interior, system(xi), diag * x)
    lam = jch.estimate_lambda_max(apply_c, 1.0 / diag,
                                  int(system.n_dofs))
    tpre = tmg.p2_gmg_for_system(nel, GEOM, 1.5, 0.03, dtype=torch.float64,
                                 device=CPU, lambda_max=lam, **kw)
    return nel, jpre, tpre, lam


def test_flat_vcycle_matches_tpuwave(vcycles):
    nel, jpre, tpre, _ = vcycles
    assert len(tpre.p1_cycle.levels) == len(jpre.p1_cycle.levels) == 2
    assert tpre.sm_theta == pytest.approx(jpre.sm_theta, rel=1e-15)
    b = np.random.default_rng(3).standard_normal(tpre.system.n_dofs)
    _close(tpre(torch.tensor(b)).numpy(), jpre(jnp.asarray(b)))


def test_canvas_vcycle_matches_tpuwave(vcycles):
    """The canvas V-cycle, whose smoothing blocks are B12 / B13 (their
    plain versions here), against tpuwave's XLA canvas V-cycle."""
    nel, jpre, tpre, _ = vcycles
    nx, ny = nel
    cs = ts2.canvas_shape(nx, ny)
    st_j = jpre.system
    interior_j = jmg._p2_canvas_interior(nx, ny, cs)
    dg_j = jnp.asarray([st_j.plane_diag[q] for q in "VHWD"]).reshape(4, 1,
                                                                      1)

    def apply_j(w):
        return jnp.where(interior_j, st_j.apply_canvases(
            jnp.where(interior_j, w, 0.0)), dg_j * w)
    vj = jmg.P2CanvasGmgPreconditioner(
        apply_j, None, 1.0 / dg_j, jpre.sm_theta, jpre.sm_coeffs,
        jpre.p1_cycle, nx, ny, cs)
    p1 = tmg.KernelGmgPreconditioner(tpre.p1_cycle.levels,
                                     tpre.p1_cycle.coarse_theta,
                                     tpre.p1_cycle.coarse_coeffs)
    vt = tmg.P2CanvasGmgPreconditioner(tpre.system, tpre.sm_theta,
                                       tpre.sm_coeffs, p1, cs)
    b = np.where(np.asarray(interior_j),
                 np.random.default_rng(4).standard_normal((4, *cs)), 0.0)
    _close(vt(torch.tensor(b)).numpy(), vj(jnp.asarray(b)))


def test_lambda_max_estimate_within_2_percent(vcycles):
    """No patch: the port's power iteration on the operator of the
    fixture, from tpuwave's start vector, gives tpuwave's estimate to
    rtol 1e-10 (f64; the name is older than the port's threefry)."""
    from tpuwave.solve import chebyshev as jch
    from tpuwave_torch.solve.chebyshev import estimate_lambda_max
    nel, jpre, tpre, lam_j = vcycles
    system = tpre.system
    interior = tpre.interior
    diag = system.diagonal()

    def apply_c(x):
        xi = torch.where(interior, x, 0.0)
        return torch.where(interior, system(xi), diag * x)
    lam_t = estimate_lambda_max(apply_c, 1.0 / diag, system.n_dofs)
    assert abs(lam_t - lam_j) <= 1e-10 * lam_j
    # in f32 both draw tpuwave's f32 start vector (another vector than the
    # f64 one) and iterate in f32: held to f32 rounding over 25 iterations
    interior_j = jmg._p2_interior_flat(*nel)
    diag_j = jpre.system.diagonal()

    def apply_j(x):
        x = x.astype(jnp.float64)
        xi = jnp.where(interior_j, x, 0.0)
        return jnp.where(interior_j, jpre.system(xi),
                         diag_j * x).astype(jnp.float32)
    lam_j32 = jch.estimate_lambda_max(apply_j, (1.0 / diag_j).astype(
        jnp.float32), int(jpre.system.n_dofs))
    lam_32 = estimate_lambda_max(
        lambda x: apply_c(x.double()).float(), (1.0 / diag).float(),
        system.n_dofs)
    assert abs(lam_32 - lam_j32) <= 1e-5 * lam_j32


# ---------------------------------------------------------------------------
# P2GridDiagnostics
# ---------------------------------------------------------------------------
def _case():
    return {"Geometry": "[0.0, 1.0] x [0.0, 1.3]", "Nel": f"{NX},{NY}",
            "R": "2", "T": "0.1", "Dt": "0.01",
            "C": {"Function expression": "1.5"},
            "U0": {"Function expression": "sin(pi*x)*cos(2*y)",
                   "Variable names": "x, y"},
            "V0": {"Function expression": "0.0"},
            "F": {"Function expression": "0.0"},
            "G": {"Function expression": "0.0"},
            "DGDT": {"Function expression": "0.0"},
            "Solution": {"Function expression":
                         "cos(3*t)*sin(pi*x)*sin(pi*y)*exp(x)",
                         "Variable names": "x, y, t"}}


@pytest.mark.parametrize("quantity", ["energy", "probe", "errors",
                                      "interpolate"])
def test_p2_diagnostics_match_tpuwave(quantity):
    from tpuwave.models.p2_diag import P2GridDiagnostics as JDiag
    from tpuwave_torch.models.p2_diag import P2GridDiagnostics as TDiag
    jd = JDiag(jload(_case()))
    td = TDiag(tload(_case()), dtype=torch.float64, device=CPU)
    rng = np.random.default_rng(5)
    u, v = rng.standard_normal((2, td.n_dofs))
    ut, vt = torch.tensor(u), torch.tensor(v)
    if quantity == "energy":
        _close(float(td.energy(ut, vt)), float(jd.energy(u, v)))
    elif quantity == "probe":
        _close(float(td.probe(ut)), float(jd.probe(jnp.asarray(u))))
    elif quantity == "errors":
        for a, b in zip(td.errors(ut, 0.3), jd.errors(jnp.asarray(u), 0.3)):
            _close(float(a), float(b))
    else:
        _close(td.interpolate(tload(_case()).u0).numpy(),
               jd.interpolate(jload(_case()).u0))
        np.testing.assert_array_equal(td.vertex_values(ut),
                                      u[:(NX + 1) * (NY + 1)])


def test_p2_varcoef_data_matches_tpuwave():
    from tpuwave.core.quadrature import gauss_simplex as jquad
    from tpuwave.ops.stencil_p2 import p2_varcoef_data as jdata
    from tpuwave_torch.core.quadrature import gauss_simplex as tquad
    from tpuwave_torch.ops.stencil_p2 import p2_varcoef_data as tdata
    js, ts, _, _ = _vc_spaces(_vc_case("static"))
    for a, b in zip(tdata(ts, tquad(3)), jdata(js, jquad(3))):
        _vc_close(a, b, rtol=1e-14, atol=1e-15)
