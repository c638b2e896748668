"""The port's variable-coefficient P2 operator and diagnostics against
tpuwave's, on the CPU in f64 (tpuwave eager, no engine):

* ``p2_varcoef_data`` (G, frac, w, det);
* ``p2_varcoef_scales`` against tpuwave's diagnostics' ``_scales_at``;
* ``P2VarcoefStencil``'s ``__call__``, ``apply_canvases``, ``diagonal`` and
  ``diagonal_canvases``, for a static c and for a time-dependent c at t =
  0.7, on each package's own scale planes, Nel (5, 4), random inputs from
  a numpy seed: rtol 1e-12 / atol 1e-13 (as tests/test_tdep_c.py:383
  holds tpuwave's operator against the parity assembly);
* ``P2GridDiagnostics`` with a varying c: energy (K frozen at t = 0),
  errors and probe;
* on the card (``cuda``): the R = 2 engines with a varying and with a
  time-dependent c at Nel 16, ``--precond mg``, on device="cuda" against
  device="cpu": per-step CG counts equal, states within rtol 1e-10, B11,
  B12 and B13 launched.
"""

import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (one torch thread)
from tpuwave_torch.utils.params import load_params as tload

CPU = torch.device("cpu")
C_EXPR = {"static": "1.0 + 0.5*x + 0.25*y*y",
          "tdep": "1 + 0.4*x*sin(t) + 0.2*y"}


def _case(cmode, nel="5,4", **over):
    """tests/test_schemes.py's standing mode at R = 2 with a static or a
    time-dependent c (built here: the card's tests import no jax)."""
    case = {
        "Nel": nel, "R": "2", "T": "0.1", "Theta": "0.5", "Beta": "0.25",
        "Gamma": "0.5", "Dt": "0.01", "Save Solution": "false",
        "Log Every": "0",
        "C": {"Function expression": C_EXPR[cmode],
              "Variable names": "x, y, t"},
        "Time Dependent C": "true" if cmode == "tdep" else "false",
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
    case.update(over)
    return case


def _close(got, want, rtol=1e-12, atol=1e-13):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _spaces(case):
    from tpuwave.core.mesh import FeSpace as JSpace
    from tpuwave.core.mesh import StructuredTriMesh as JMesh
    from tpuwave.utils.params import load_params as jload
    from tpuwave_torch.core.mesh import FeSpace as TSpace
    from tpuwave_torch.core.mesh import StructuredTriMesh as TMesh
    pj, pt = jload(case), tload(case)
    return (JSpace(JMesh(pj.nel, pj.geometry), 2),
            TSpace(TMesh(pt.nel, pt.geometry), 2), pj, pt)


def _scales(cmode, t):
    """tpuwave's and the port's (2, Q, ny, nx) scale planes at ``t``."""
    from tpuwave.models.p2_diag import P2GridDiagnostics as JDiag
    from tpuwave_torch.core.quadrature import gauss_simplex as tquad
    from tpuwave_torch.ops.stencil_p2 import p2_varcoef_data as tdata
    from tpuwave_torch.ops.stencil_p2 import p2_varcoef_scales
    js, ts, pj, pt = _spaces(_case(cmode))
    _, frac, w, det = tdata(ts, tquad(3))
    s_t = p2_varcoef_scales(ts.mesh, pt.c, t, frac, w, det, torch.float64,
                            CPU)
    return js, ts, JDiag(pj)._scales_at(t), s_t


@pytest.mark.parametrize("cmode,t", [("static", 0.0), ("tdep", 0.0),
                                     ("tdep", 0.7)])
def test_p2_varcoef_scales_match_tpuwave(cmode, t):
    _, ts, s_j, s_t = _scales(cmode, t)
    assert s_t.shape == (2, 7, ts.mesh.ny, ts.mesh.nx)    # Q = 7 (Radon)
    _close(s_t.numpy(), s_j, rtol=1e-14, atol=0.0)


@pytest.mark.parametrize("cmode", ["static", "tdep"])
def test_p2_varcoef_stencil_matches_tpuwave(cmode):
    import jax.numpy as jnp
    from tpuwave.core.quadrature import gauss_simplex as jquad
    from tpuwave.ops import stencil_p2 as jst
    from tpuwave_torch.core.quadrature import gauss_simplex as tquad
    from tpuwave_torch.ops import stencil_p2 as tst

    js, ts, s_j, s_t = _scales(cmode, 0.7 if cmode == "tdep" else 0.0)
    G_j = jst.p2_varcoef_data(js, jquad(3))[0]
    G_t = tst.p2_varcoef_data(ts, tquad(3))[0]
    op_j = jst.P2VarcoefStencil(js, s_j, G_j, jnp.float64)
    op_t = tst.P2VarcoefStencil(ts, s_t, G_t, torch.float64)

    nx, ny = ts.mesh.nx, ts.mesh.ny
    cshape = tst.canvas_shape(nx, ny)
    rng = np.random.default_rng(14)
    x = rng.standard_normal(ts.n_dofs)
    _close(op_t(torch.tensor(x)).numpy(), op_j(jnp.asarray(x)))
    xc = tst.planes_to_canvases(tst.flat_to_planes(torch.tensor(x), nx, ny),
                                cshape)
    xc_j = jst.planes_to_canvases(jst.flat_to_planes(jnp.asarray(x), nx, ny),
                                  cshape)
    _close(op_t.apply_canvases(xc).numpy(), op_j.apply_canvases(xc_j))
    _close(op_t.diagonal().numpy(), op_j.diagonal())
    _close(op_t.diagonal_canvases(cshape).numpy(),
           op_j.diagonal_canvases(cshape))


def test_p2_diagnostics_varying_c_match_tpuwave():
    import jax.numpy as jnp
    from tpuwave.models.p2_diag import P2GridDiagnostics as JDiag
    from tpuwave.utils.params import load_params as jload
    from tpuwave_torch.models.p2_diag import P2GridDiagnostics as TDiag
    case = _case("static")
    dj = JDiag(jload(case))
    dt_ = TDiag(tload(case), dtype=torch.float64, device=CPU)
    rng = np.random.default_rng(15)
    u, v = rng.standard_normal((2, dt_.n_dofs))
    ut, uj = torch.tensor(u), jnp.asarray(u)
    for _ in range(2):      # the second call reuses the frozen K(0)
        _close(float(dt_.energy(ut, torch.tensor(v))),
               float(dj.energy(uj, jnp.asarray(v))), rtol=1e-13)
    _close(float(dt_.probe(ut)), float(dj.probe(uj)), rtol=1e-13)
    for a, b in zip(dt_.errors(ut, 0.3), dj.errors(uj, 0.3)):
        _close(float(a), float(b), rtol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("family,cmode", [("theta", "tdep"),
                                          ("newmark", "static")])
def test_cuda_varying_c_engine_matches_cpu(family, cmode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from tpuwave_torch.models.fast_engine import make_fast_solver
    from tpuwave_torch.ops import kernels as tk
    case = _case(cmode, nel="16", Dt="0.04", T="0.12")
    solvers = [make_fast_solver(tload(case), family, precond="mg",
                                dtype=torch.float64, device=dev)
               for dev in ("cuda", CPU)]
    tk.reset_launches()
    states = [s.initial_state() for s in solvers]
    for t in (0.04, 0.08, 0.12):
        out = [s.step(st, t) for s, st in zip(solvers, states)]
        states = [o[0] for o in out]
        assert out[0][1]["iterations_1"] == out[1][1]["iterations_1"]
        assert out[0][1]["iterations_2"] == out[1][1]["iterations_2"]
    for name in ("u", "v", "a"):
        want = getattr(states[1], name).numpy()
        _close(getattr(states[0], name).cpu().numpy(), want, rtol=1e-10,
               atol=1e-10 * float(np.abs(want).max()))
    for k in ("p2_constrained_apply", "p2_presmooth", "p2_postsmooth"):
        assert tk.LAUNCHES[k] > 0, k
