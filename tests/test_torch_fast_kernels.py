"""The plain versions of kernels B7-B10 (tpuwave_torch/ops/kernels.py:
newmark_rhs_r0, newmark_update, theta_r0u, theta_r0v) against the JAX
Pallas kernels they replace (tpuwave/ops/pallas_kernels.py).

On the CPU the wrappers run their plain PyTorch versions; those are held
against the Pallas kernels in interpret mode, in f64, at (30, 38) elements:
the true (39, 31) grid is zero-padded for Pallas to (48, 64) (three row
blocks of 16) and the results are cropped back. Grids: rtol 1e-12, atol
1e-12 (the two sides sum the stencil terms in the same order; f64
roundoff). Norms: against the f64 dot product of the result at rtol 1e-12,
and against the Pallas value at rtol 1e-5, because tpuwave accumulates its
partials in f32. ``pinned="random"`` puts non-zero values on the Dirichlet
nodes, which every kernel must mask.
"""

import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (one torch thread)
from tpuwave_torch.models.fast import FastWaveSolver
from tpuwave_torch.ops import kernels as tk

NEL, DT = (30, 38), 0.01
HP, WP, BR = 48, 64, 16
RTOL = ATOL = 1e-12


def _solver(scheme, **kw):
    return FastWaveSolver(NEL, ((0.0, 0.0), (1.0, 1.0)), DT, scheme=scheme,
                          lumped=False, dtype=torch.float64, device="cpu",
                          **kw)


NM = _solver("newmark", beta=0.25, gamma=0.6)
TH = _solver("theta", theta=0.5)
H, W = NM.shape
KW = dict(block_rows=BR, true_rows=H, true_cols=W, interpret=True)


@pytest.fixture(scope="module")
def pk():
    """tpuwave's Pallas kernels (interpret mode on the CPU)."""
    pytest.importorskip("jax")
    from tpuwave.ops import pallas_kernels
    return pallas_kernels


def _fields(seed, n, pinned):
    """n random (H, W) fields; zero on the Dirichlet nodes unless
    ``pinned == "random"``."""
    rng = np.random.default_rng(seed)
    out = rng.standard_normal((n, H, W))
    if pinned == "zero":
        out[:, [0, -1], :] = 0.0
        out[:, :, [0, -1]] = 0.0
    return list(out)


def _pad(a):
    import jax.numpy as jnp
    out = np.zeros((HP, WP))
    out[:H, :W] = a
    return jnp.asarray(out)


def _t(a):
    return torch.tensor(a, dtype=torch.float64)


def _grid(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:H, :W],
                               rtol=RTOL, atol=ATOL)


def _norm(got, field, pallas):
    f = field.numpy()
    np.testing.assert_allclose(float(got), float(np.vdot(f, f)), rtol=1e-12)
    np.testing.assert_allclose(float(got), float(pallas[0, 0]), rtol=1e-5)


@pytest.mark.parametrize("pinned", ["zero", "random"])
def test_newmark_rhs_r0_matches_pallas(pk, pinned):
    u, v, a = _fields(21, 3, pinned)
    k_st, a_st = NM.stiff.stencil, NM.system.stencil
    c_zv, c_za = DT, DT * DT * (0.5 - NM.beta)
    want = pk.newmark_rhs_r0_pallas(_pad(u), _pad(v), _pad(a), k_stencil=k_st,
                                    a_stencil=a_st, c_zv=c_zv, c_za=c_za,
                                    **KW)
    r0, z, rn2, bn2, xn2 = tk.newmark_rhs_r0(_t(u), _t(v), _t(a), k_st, a_st,
                                             c_zv, c_za)
    _grid(r0, want[0])
    _grid(z, want[1])
    pin = tk.pinned_mask((H, W), "cpu")
    assert float(z[pin].abs().max()) == 0.0
    x0 = torch.where(pin, 0.0, _t(a))
    rhs = torch.where(pin, 0.0, -NM.stiff(z))
    _norm(rn2, r0, want[2])
    _norm(bn2, rhs, want[3])
    _norm(xn2, x0, want[4])


@pytest.mark.parametrize("pinned", ["zero", "random"])
def test_newmark_update_matches_pallas(pk, pinned):
    z, v, a, e = _fields(22, 4, pinned)
    cf = dict(c_ua=NM.beta * DT * DT, c_va=DT * (1.0 - NM.gamma),
              c_van=DT * NM.gamma)
    want = pk.newmark_update_pallas(_pad(z), _pad(v), _pad(a), _pad(e), **cf,
                                    **KW)
    got = tk.newmark_update(_t(z), _t(v), _t(a), _t(e), **cf)
    for g, w in zip(got, want):
        _grid(g, w)
    if pinned == "random":
        # v' takes the RAW a on pinned nodes, a' the masked one
        pin = tk.pinned_mask((H, W), "cpu")
        raw = _t(v) + cf["c_va"] * _t(a) + cf["c_van"] * _t(e)
        np.testing.assert_allclose(got[1][pin].numpy(), raw[pin].numpy(),
                                   rtol=1e-14)
        np.testing.assert_array_equal(got[2][pin].numpy(), _t(e)[pin].numpy())


@pytest.mark.parametrize("pinned", ["zero", "random"])
def test_theta_r0u_matches_pallas(pk, pinned):
    u, v = _fields(23, 2, pinned)
    th = TH.theta
    cf = dict(c_comb=-DT * DT * th * (1 - th), c_r0k=-DT * DT * th, c_mv=DT)
    m_st, k_st = TH.mass.stencil, TH.stiff.stencil
    want = pk.theta_r0u_pallas(_pad(u), _pad(v), m_stencil=m_st,
                               k_stencil=k_st, **cf, **KW)
    r0, rn2, bn2, xn2 = tk.theta_r0u(_t(u), _t(v), m_st, k_st, **cf)
    _grid(r0, want[0])
    pin = tk.pinned_mask((H, W), "cpu")
    um, vm = torch.where(pin, 0.0, _t(u)), torch.where(pin, 0.0, _t(v))
    # r0 is the residual of the warm-started system: rhs - A masked(u)
    rhs = torch.where(pin, 0.0, TH.mass(um) + cf["c_comb"] * TH.stiff(um)
                      + DT * TH.mass(vm))
    np.testing.assert_allclose(
        r0.numpy(), (rhs - torch.where(pin, 0.0, TH.system(um))).numpy(),
        rtol=1e-10, atol=1e-12)
    _norm(rn2, r0, want[1])
    _norm(bn2, rhs, want[2])
    _norm(xn2, um, want[3])


@pytest.mark.parametrize("pinned", ["zero", "random"])
def test_theta_r0v_matches_pallas(pk, pinned):
    u, e, v = _fields(24, 3, pinned)
    th = TH.theta
    cf = dict(c_ku=-DT * (1 - th), c_kun=-DT * th)
    m_st, k_st = TH.mass.stencil, TH.stiff.stencil
    want = pk.theta_r0v_pallas(_pad(u), _pad(e), _pad(v), m_stencil=m_st,
                               k_stencil=k_st, **cf, **KW)
    un, r0, rn2, bn2, xn2 = tk.theta_r0v(_t(u), _t(e), _t(v), m_st, k_st,
                                         **cf)
    _grid(un, want[0])
    _grid(r0, want[1])
    pin = tk.pinned_mask((H, W), "cpu")
    assert float(un[pin].abs().max()) == 0.0
    vm = torch.where(pin, 0.0, _t(v))
    rhs = torch.where(pin, 0.0, TH.mass(vm) + r0)
    _norm(rn2, r0, want[2])
    _norm(bn2, rhs, want[3])
    _norm(xn2, vm, want[4])


def test_cpu_tensors_never_count_launches():
    tk.reset_launches()
    z, v, a, e = (_t(f) for f in _fields(25, 4, "random"))
    st = NM.stiff.stencil
    tk.newmark_rhs_r0(z, v, a, st, NM.system.stencil, 0.1, 0.2)
    tk.newmark_update(z, v, a, e, 0.1, 0.2, 0.3)
    tk.theta_r0u(z, v, NM.mass.stencil, st, 0.1, 0.2, 0.3)
    tk.theta_r0v(z, e, v, NM.mass.stencil, st, 0.1, 0.2)
    assert all(n == 0 for n in tk.LAUNCHES.values())
    assert {"newmark_rhs_r0", "newmark_update", "theta_r0u",
            "theta_r0v"} <= set(tk.LAUNCHES)


def test_wrappers_reject_bad_inputs():
    x = torch.zeros((8, 8), dtype=torch.float64)
    st = NM.stiff.stencil
    with pytest.raises(ValueError, match="differ"):
        tk.newmark_rhs_r0(x, x, x.to(torch.float32), st, st, 0.1, 0.2)
    with pytest.raises(ValueError, match="differ"):
        tk.newmark_update(x, x, x, x[:4].contiguous(), 0.1, 0.2, 0.3)
    with pytest.raises(ValueError, match="contiguous"):
        tk.theta_r0u(x.t()[:, :4], x[:, :4], st, st, 0.1, 0.2, 0.3)
    with pytest.raises(TypeError):
        tk.theta_r0v(x, x, x.to(torch.int64), st, st, 0.1, 0.2)
