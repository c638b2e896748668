"""The parity engine's ``Discretization`` against tpuwave's, on the CPU in
f64 (tpuwave eager, no solver), at R = 1 and R = 2 on a (5, 4) mesh with
a forcing and a spatially varying and a time-dependent wave speed:

* the mass, the stiffness K(c(x, y, 0)), the lumped mass and the mass
  diagonal;
* the K(t) payload and the operator rebuilt from it at t = 0.37;
* the load vector at t = 0.37, interpolation and boundary values;
* energy, probe and the four errors (L2, H1, relative L2, relative H1;
  the exact gradient by forward-mode derivatives where tpuwave takes
  jax.grad) of a random state;

all at rtol 1e-12, states made from a numpy seed.
"""

import numpy as np
import pytest
import torch

from tpuwave.models.discretization import Discretization as JDisc
from tpuwave.utils.params import load_params as jload
from tpuwave_torch.models.discretization import Discretization
from tpuwave_torch.utils.params import load_params as tload

CPU = torch.device("cpu")
T = 0.37


def _case(r, cmode):
    c = {"varying": "1.0 + 0.5*x + 0.25*y*y",
         "tdep": "1 + 0.4*x*sin(t) + 0.2*y"}[cmode]
    return {
        "Nel": "5,4", "R": str(r), "T": "0.1", "Dt": "0.01",
        "Geometry": "[0.0, 1.0] x [0.0, 0.8]",
        "Save Solution": "false", "Log Every": "0",
        "C": {"Function expression": c, "Variable names": "x, y, t"},
        "Time Dependent C": "true" if cmode == "tdep" else "false",
        "F": {"Function expression": "sin(3*x)*cos(2*y)*cos(5*t)",
              "Variable names": "x, y, t"},
        "U0": {"Function expression": "sin(pi*x)*sin(pi*y)",
               "Variable names": "x, y"},
        "V0": {"Function expression": "x*y", "Variable names": "x, y"},
        "G": {"Function expression": "0.1*sin(2*t)*(1+x*y)",
              "Variable names": "x, y, t"},
        "DGDT": {"Function expression": "0.2*cos(2*t)*(1+x*y)",
                 "Variable names": "x, y, t"},
        "Solution": {"Function expression":
                     "cos(sqrt(2)*pi*t)*sin(pi*x)*sin(pi*y)*(1+0.1*x)",
                     "Variable names": "x, y, t"},
    }


def _close(got, want, rtol=1e-12):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("r,cmode", [(1, "varying"), (1, "tdep"),
                                     (2, "varying"), (2, "tdep")])
def test_discretization_matches_tpuwave(r, cmode):
    case = _case(r, cmode)
    jp, tp = jload(case), tload(case)
    jd, td = JDisc(jp), Discretization(tp, device=CPU)
    assert td.n_dofs == jd.n_dofs
    rng = np.random.default_rng(11 * r + len(cmode))
    u, v = rng.standard_normal(td.n_dofs), rng.standard_normal(td.n_dofs)
    ut, vt = torch.as_tensor(u), torch.as_tensor(v)

    for name in ("mass", "stiffness"):
        _close(getattr(td, name)(ut), getattr(jd, name)(u))
    _close(td.mass_diag, jd.mass_diag)
    _close(td.lumped_mass, jd.lumped_mass)
    pay_t, pay_j = td.stiffness_payload_at(T), jd.stiffness_payload_at(T)
    _close(pay_t, pay_j)
    _close(td.stiffness_from_payload(pay_t)(ut),
           jd.stiffness_from_payload(pay_j)(u))
    _close(td.stiffness_at(0.0)(ut), jd.stiffness_at(0.0)(u))

    _close(td.load_vector(T), jd.load_vector(T))
    _close(td.interpolate(tp.u0), jd.interpolate(jp.u0))
    _close(td.boundary_values(tp.g, T), jd.boundary_values(jp.g, T))
    np.testing.assert_array_equal(td.boundary_mask.numpy(),
                                  np.asarray(jd.boundary_mask))

    _close(td.energy(ut, vt), jd.energy(u, v))
    _close(td.probe(ut), jd.probe(u))
    np.testing.assert_array_equal(td.vertex_values(ut),
                                  u[:td.mesh.n_vertices])
    got, want = td.errors(ut, T), jd.errors(u, T)
    assert all(g.dim() == 0 for g in got)
    for a, b in zip(got, want):
        _close(a, b)
