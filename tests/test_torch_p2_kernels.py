"""The port's P2 canvas kernels (tpuwave_torch/ops/kernels_p2.py) against
the JAX Pallas kernels they replace (tpuwave/ops/pallas_p2.py).

On the CPU the wrappers run their plain PyTorch versions; those are held
against the Pallas kernels in interpret mode, in f64, on random canvases
over a ragged mesh (Nel 20 x 13; canvases (16, 23)) supported on each
plane (B11) or on the interior (B12 / B13, the V-cycle's invariant). The
Pallas side takes the canvas zero-padded to 24 rows (a multiple of its
8-row blocks, >= 2 blocks); the padding lies outside every plane's
support, and the two outputs are compared on the port's (16, 23) canvas.
Tolerance: 1e-12 relative to the largest output (both sides sum the same
46 terms, in different orders: f64 roundoff is ~1e-16 relative).

The tests marked ``cuda`` hold each CUDA kernel against its plain version
on the card, in f64 and f32, with bitwise-equal reruns (the kernels do not
reduce), and skip where there is none. They need neither jax nor tpuwave:
``python -m pytest --noconftest -m cuda tests/test_torch_p2_kernels.py``.
"""

import numpy as np
import pytest
import torch

from tpuwave_torch.core.mesh import FeSpace, StructuredTriMesh
from tpuwave_torch.core.quadrature import gauss_simplex
from tpuwave_torch.ops import kernels as tk
from tpuwave_torch.ops import kernels_p2 as kp
from tpuwave_torch.ops.assembly import (element_mass_class,
                                        element_stiffness_class)
from tpuwave_torch.ops.stencil_p2 import P2PlaneStencil
from tpuwave_torch.solve.cheby_iter import chebyshev_coefficients

NX, NY = 20, 13
HC, WC = NY + 3, NX + 3
HP = 24          # Pallas rows: a multiple of 8, >= 2 blocks and br + 16
REL = 1e-12


def _stencils():
    space = FeSpace(StructuredTriMesh((NX, NY), ((0.0, 0.0), (1.0, 1.3))),
                    2)
    quad = gauss_simplex(3)
    mass = P2PlaneStencil(space, element_mass_class(space, quad),
                          torch.float64, "cpu")
    stiff = P2PlaneStencil(space, element_stiffness_class(space, quad, 1.0),
                           torch.float64, "cpu")
    # the Newmark system M + beta dt^2 K at a large dt (q ~ 4)
    return {"mass": mass, "stiff": stiff,
            "system": mass.axpy(0.25 * 0.1 ** 2, stiff)}


STENCILS = _stencils()


def _terms(which):
    st = STENCILS[which]
    return (st.terms, tuple(float(st.plane_diag[q]) for q in "VHWD"))


def _support():
    out = np.zeros((4, HC, WC), bool)
    for i, (r, c) in enumerate(((NY + 1, NX + 1), (NY + 1, NX),
                                (NY, NX + 1), (NY, NX))):
        out[i, 1:1 + r, 1:1 + c] = True
    return out


INTERIOR = kp.p2_canvas_interior(NX, NY, (HC, WC), "cpu").numpy()


def _field(seed, mask):
    rng = np.random.default_rng(seed)
    return np.where(mask, rng.uniform(-1.0, 1.0, (4, HC, WC)), 0.0)


def _schedule(degree):
    th, cf = chebyshev_coefficients(0.3, 2.4, degree)
    return th, tuple((float(a), float(b)) for a, b in cf)


@pytest.fixture(scope="module")
def pp():
    """tpuwave's Pallas P2 kernels (interpret mode on the CPU)."""
    pytest.importorskip("jax")
    from tpuwave.ops import pallas_p2
    return pallas_p2


def _pad(a):
    import jax.numpy as jnp
    out = np.zeros((4, HP, WC))
    out[:, :HC] = a
    return jnp.asarray(out)


def _crop(a):
    return np.asarray(a)[:, :HC]


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=REL,
                               atol=REL * float(np.abs(want).max()))


def test_coeffs_to_static_matches_tpuwave(pp):
    for st in STENCILS.values():
        assert st.terms == pp.coeffs_to_static(st.coeffs)
        assert len(st.coeffs) <= kp.MAX_TERMS


def test_interior_mask_matches_tpuwave():
    from tpuwave.solve.multigrid import _p2_canvas_interior
    want = np.asarray(_p2_canvas_interior(NX, NY, (HC, WC)))
    np.testing.assert_array_equal(INTERIOR, want)


@pytest.mark.parametrize("mask_input", [True, False])
@pytest.mark.parametrize("which", ["mass", "stiff", "system"])
def test_constrained_apply_matches_pallas(pp, which, mask_input):
    """Random values on every plane's support, boundary DoFs included
    (mask_input=False must read them; mask_input=True must not)."""
    coeffs, diags = _terms(which)
    if not mask_input:
        diags = (0.0, 0.0, 0.0, 0.0)
    x = _field(1, _support())
    want = pp.p2_constrained_apply_pallas(
        _pad(x), coeffs=coeffs, diags=diags, nx=NX, ny=NY, block_rows=8,
        interpret=True, mask_input=mask_input)
    got = kp.p2_constrained_apply(torch.tensor(x), coeffs, diags, NX, NY,
                                  mask_input=mask_input)
    _close(got.numpy(), _crop(want))


@pytest.mark.parametrize("degree", [2, 4])
def test_presmooth_matches_pallas(pp, degree):
    coeffs, diags = _terms("system")
    inv = tuple(1.0 / d for d in diags)
    th, cf = _schedule(degree)
    b = _field(2, INTERIOR)
    wx, wr = pp.p2_presmooth_pallas(
        _pad(b), coeffs=coeffs, inv_diags=inv, theta=th, sm_coeffs=cf,
        nx=NX, ny=NY, block_rows=8, interpret=True)
    gx, gr = kp.p2_presmooth(torch.tensor(b), coeffs, inv, th, cf, NX, NY)
    _close(gx.numpy(), _crop(wx))
    _close(gr.numpy(), _crop(wr))


@pytest.mark.parametrize("degree", [2, 4])
def test_postsmooth_matches_pallas(pp, degree):
    """x and corr random on the support (corr is masked in the kernel),
    r on the interior."""
    coeffs, diags = _terms("system")
    inv = tuple(1.0 / d for d in diags)
    th, cf = _schedule(degree)
    x, corr = _field(3, _support()), _field(4, _support())
    r = _field(5, INTERIOR)
    want = pp.p2_postsmooth_pallas(
        _pad(x), _pad(r), _pad(corr), coeffs=coeffs, inv_diags=inv,
        theta=th, sm_coeffs=cf, nx=NX, ny=NY, block_rows=8, interpret=True)
    got = kp.p2_postsmooth(torch.tensor(x), torch.tensor(r),
                           torch.tensor(corr), coeffs, inv, th, cf, NX, NY)
    _close(got.numpy(), _crop(want))


def test_padded_canvas_gives_the_same_support_values():
    """The kernels take any Hc >= ny + 3, Wc >= nx + 3: zero padding
    outside the support changes nothing inside it."""
    coeffs, diags = _terms("system")
    x = _field(6, _support())
    xp = np.zeros((4, HC + 5, WC + 2))
    xp[:, :HC, :WC] = x
    a = kp.p2_constrained_apply(torch.tensor(x), coeffs, diags, NX, NY)
    b = kp.p2_constrained_apply(torch.tensor(xp), coeffs, diags, NX, NY)
    np.testing.assert_array_equal(b.numpy()[:, :HC, :WC], a.numpy())
    assert not b.numpy()[:, HC:].any() and not b.numpy()[:, :, WC:].any()


def test_plain_apply_is_the_stencils_canvas_apply():
    """B11's plain version equals the constrained form of
    P2PlaneStencil.apply_canvases (tpuwave's XLA route)."""
    st = STENCILS["system"]
    coeffs, diags = _terms("system")
    x = torch.tensor(_field(7, _support()))
    interior = torch.tensor(INTERIOR)
    d = torch.tensor(diags, dtype=torch.float64).reshape(4, 1, 1)
    want = torch.where(interior, st.apply_canvases(
        torch.where(interior, x, 0.0)), d * x)
    got = kp.p2_constrained_apply(x, coeffs, diags, NX, NY)
    _close(got.numpy(), want.numpy())


def test_wrappers_reject_bad_inputs():
    coeffs, diags = _terms("mass")
    x = torch.zeros((4, HC, WC), dtype=torch.float64)
    with pytest.raises(TypeError):
        kp.p2_constrained_apply(x.to(torch.int32), coeffs, diags, NX, NY)
    with pytest.raises(ValueError, match="canvas stack"):
        kp.p2_constrained_apply(x[0], coeffs, diags, NX, NY)
    with pytest.raises(ValueError, match="smaller"):
        kp.p2_constrained_apply(x[:, :-1].contiguous(), coeffs, diags,
                                NX, NY)
    with pytest.raises(ValueError, match="contiguous"):
        kp.p2_presmooth(x.transpose(1, 2), coeffs, diags, 1.0, (), NY, NX)
    with pytest.raises(ValueError, match="differ"):
        kp.p2_postsmooth(x, x, x.to(torch.float32), coeffs, diags, 1.0, (),
                         NX, NY)
    with pytest.raises(ValueError, match="limit of 64"):
        kp.p2_constrained_apply(x, coeffs * 2, diags, NX, NY)
    with pytest.raises(ValueError, match="degree"):
        kp.p2_presmooth(x, coeffs, diags, 1.0, [(0.1, 0.1)] * 32, NX, NY)


def test_smooth_tile_fits_and_refuses():
    # the four planes' r and d slabs and x tiles in the H100's 227 KB
    # opt-in limit: degree 4 (halo 4) fits tile 32 in f64, 64 in f32
    assert kp.p2_smooth_tile(4, torch.float64, 232448) == 32
    assert kp.p2_smooth_tile(4, torch.float32, 232448) == 64
    assert kp.p2_smooth_tile(2, torch.float64, 232448) == 32
    with pytest.raises(ValueError, match="shared memory"):
        kp.p2_smooth_tile(32, torch.float64, 232448)


def test_cpu_tensors_never_count_launches():
    tk.reset_launches()
    coeffs, diags = _terms("system")
    th, cf = _schedule(4)
    x = torch.tensor(_field(8, INTERIOR))
    kp.p2_constrained_apply(x, coeffs, diags, NX, NY)
    kp.p2_presmooth(x, coeffs, diags, th, cf, NX, NY)
    kp.p2_postsmooth(x, x, x, coeffs, diags, th, cf, NX, NY)
    assert all(v == 0 for v in tk.LAUNCHES.values())


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _bound(dtype, scale, n=1):
    """f64: 1e-12 relative. f32: ~46 rounded terms per site on either
    side, over n chained applies of a contractive smoother."""
    if dtype == torch.float64:
        return 1e-12 * scale
    return 100 * n * float(torch.finfo(dtype).eps) * scale


def _on(dev, dtype, *arrays):
    return [torch.tensor(a, dtype=dtype, device=dev) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mask_input", [True, False])
def test_cuda_constrained_apply(cuda_device, dtype, mask_input):
    coeffs, diags = _terms("system")
    if not mask_input:
        diags = (0.0, 0.0, 0.0, 0.0)
    (x,) = _on(cuda_device, dtype, _field(9, _support()))
    before = tk.LAUNCHES["p2_constrained_apply"]
    got = kp.p2_constrained_apply(x, coeffs, diags, NX, NY, mask_input)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["p2_constrained_apply"] == before + 1
    want = kp.p2_constrained_apply_reference(x, coeffs, diags, NX, NY,
                                             mask_input)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= _bound(dtype, scale)
    again = kp.p2_constrained_apply(x, coeffs, diags, NX, NY, mask_input)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("degree", [2, 4])
def test_cuda_presmooth(cuda_device, dtype, degree):
    coeffs, diags = _terms("system")
    inv = tuple(1.0 / d for d in diags)
    th, cf = _schedule(degree)
    (b,) = _on(cuda_device, dtype, _field(10, INTERIOR))
    before = tk.LAUNCHES["p2_presmooth"]
    got = kp.p2_presmooth(b, coeffs, inv, th, cf, NX, NY)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["p2_presmooth"] == before + 1
    want = kp.p2_presmooth_reference(b, coeffs, inv, th, cf, NX, NY)
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= _bound(dtype, scale, degree)
    again = kp.p2_presmooth(b, coeffs, inv, th, cf, NX, NY)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("degree", [2, 4])
def test_cuda_postsmooth(cuda_device, dtype, degree):
    coeffs, diags = _terms("system")
    inv = tuple(1.0 / d for d in diags)
    th, cf = _schedule(degree)
    x, r, corr = _on(cuda_device, dtype, _field(11, _support()),
                     _field(12, INTERIOR), _field(13, _support()))
    before = tk.LAUNCHES["p2_postsmooth"]
    got = kp.p2_postsmooth(x, r, corr, coeffs, inv, th, cf, NX, NY)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["p2_postsmooth"] == before + 1
    want = kp.p2_postsmooth_reference(x, r, corr, coeffs, inv, th, cf, NX,
                                      NY)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= _bound(dtype, scale,
                                                     degree + 1)
    again = kp.p2_postsmooth(x, r, corr, coeffs, inv, th, cf, NX, NY)
    assert torch.equal(got, again)
