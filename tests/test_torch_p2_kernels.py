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

from tests import torch_threads  # noqa: F401  (one torch thread)
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


# a mesh whose canvas sides (40, 73) are multiples of none of B11's tiles
# (32 or 64 columns, 16 or 32 rows)
NX3, NY3 = 70, 37


@pytest.mark.parametrize("mask_input", [True, False])
def test_constrained_apply_on_a_ragged_canvas_matches_pallas(pp,
                                                             mask_input):
    space = FeSpace(StructuredTriMesh((NX3, NY3), ((0.0, 0.0), (1.0, 0.6))),
                    2)
    st = P2PlaneStencil(space, element_mass_class(space, gauss_simplex(3)),
                        torch.float64, "cpu").axpy(
        0.25 * 0.05 ** 2, P2PlaneStencil(space, element_stiffness_class(
            space, gauss_simplex(3), 1.0), torch.float64, "cpu"))
    diags = (tuple(float(st.plane_diag[q]) for q in "VHWD") if mask_input
             else (0.0,) * 4)
    hc, wc = NY3 + 3, NX3 + 3
    x = np.random.default_rng(21).uniform(-1.0, 1.0, (4, hc, wc))
    import jax.numpy as jnp
    xp = np.zeros((4, 48, wc))
    xp[:, :hc] = x
    want = pp.p2_constrained_apply_pallas(
        jnp.asarray(xp), coeffs=st.terms, diags=diags, nx=NX3, ny=NY3,
        block_rows=8, interpret=True, mask_input=mask_input)
    got = kp.p2_constrained_apply(torch.tensor(x), st.terms, diags, NX3, NY3,
                                  mask_input=mask_input)
    _close(got.numpy(), np.asarray(want)[:, :hc])


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
    # up to degree 8 the register kernel: its double-buffered d slabs of
    # the four planes fit the H100's 227 KB opt-in limit, the tile is the
    # slab less a degree halo; above it the shared-slab kernel's square
    # tiles, whose r and d slabs grow with the degree
    lim = 232448
    for dtype in (torch.float32, torch.float64):
        for degree in range(1, kp.SMOOTH_REG_MAX_DEGREE + 1):
            g = kp.p2_smooth_geometry(degree, dtype, lim)
            assert g.threads_y > 0 and g.smem_bytes <= lim
            assert g.tile_rows > 0 and g.tile_cols > 0
            assert (g.tile_rows + 2 * degree
                    == g.threads_y * g.rows_per_thread)
    assert kp.p2_smooth_geometry(4, torch.float32, lim)[:3] == (24, 56, 4)
    assert kp.p2_smooth_geometry(4, torch.float64, lim)[:3] == (24, 24, 8)
    g = kp.p2_smooth_geometry(10, torch.float64, lim)
    assert g[:3] == (32, 32, 0) and g.smem_bytes <= lim
    with pytest.raises(ValueError, match="shared memory"):
        kp.p2_smooth_geometry(32, torch.float64, lim)
    with pytest.raises(ValueError, match="shared memory"):
        kp.p2_smooth_geometry(4, torch.float32, 60000)


def _square_stiffness():
    """The stiffness on square cells, whose two exact zeros
    coeffs_to_static drops (44 terms)."""
    space = FeSpace(StructuredTriMesh((8, 8), ((0.0, 0.0), (1.0, 1.0))), 2)
    return P2PlaneStencil(space, element_stiffness_class(
        space, gauss_simplex(3), 1.0), torch.float64, "cpu")


@pytest.mark.parametrize("which", ["mass", "stiff", "system", "square"])
def test_smooth_slots_order_the_stencils(which):
    """Each stencil's terms land on their slots of the fixed pattern, in
    order; absent terms leave 0.0. The system stencil is the pattern."""
    st = _square_stiffness() if which == "square" else STENCILS[which]
    slots = kp.smooth_slots(st.terms)
    want = {t[:4]: t[4] for t in st.terms}
    assert len(want) == (44 if which == "square" else 46)
    assert slots == tuple(want.get(key, 0.0) for key in kp.SMOOTH_PATTERN)
    assert tuple(t[:4] for t in STENCILS["system"].terms) == \
        kp.SMOOTH_PATTERN


@pytest.mark.parametrize("change", ["foreign", "reversed", "repeated"])
def test_smooth_slots_refuse_other_patterns(change):
    bad = _refused(change)
    with pytest.raises(ValueError, match="pattern|order"):
        kp.smooth_slots(bad)
    x = torch.zeros((4, HC, WC), dtype=torch.float64)
    with pytest.raises(ValueError, match="pattern|order"):
        kp.p2_presmooth(x, bad, (1.0,) * 4, 1.0, (), NX, NY)


def _refused(change):
    terms = STENCILS["system"].terms
    return {"foreign": terms[:-1] + ((3, 3, -1, 1, 0.5),),
            "reversed": terms[::-1],
            "repeated": terms[:5] + terms[4:]}[change]


@pytest.mark.parametrize("which", ["mass", "stiff", "system", "square",
                                   "foreign", "reversed", "repeated"])
def test_apply_route_follows_the_pattern(which):
    """B11's kernel is chosen by the terms alone: the engines' stencils
    (the square cells' stiffness with two slots left at 0 included) take
    the pattern kernel, a foreign, reordered or repeated term the general
    one; the pattern kernel's tiles (a tile and its one-site halo of the
    four planes in static shared memory) fit 48 KB."""
    if which in ("foreign", "reversed", "repeated"):
        terms, want = _refused(which), "general"
    else:
        st = _square_stiffness() if which == "square" else STENCILS[which]
        terms, want = st.terms, "pattern"
    assert kp.p2_apply_route(tuple(terms)) == want
    if want == "pattern":
        assert kp.smooth_slots(tuple(terms))
    for dtype in (torch.float32, torch.float64):
        isz = torch.empty((), dtype=dtype).element_size()
        small = kp.p2_apply_geometry(dtype, HC, WC)
        large = kp.p2_apply_geometry(dtype, 4099, 4099)
        assert small != large
        for g in (small, large):
            assert g.tile_cols * g.threads_y <= 1024
            assert 4 * (g.tile_cols + 2) * (g.threads_y * g.rows_per_thread
                                            + 2) * isz <= 48 * 1024


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


# a ragged mesh over several tiles in both directions, with partial edge
# tiles: canvases (100, 153)
NX2, NY2 = 150, 97


@pytest.fixture(scope="module")
def wide():
    space = FeSpace(StructuredTriMesh((NX2, NY2), ((0.0, 0.0), (1.0, 1.0))),
                    2)
    quad = gauss_simplex(3)
    mass = P2PlaneStencil(space, element_mass_class(space, quad),
                          torch.float64, "cpu")
    stiff = P2PlaneStencil(space, element_stiffness_class(space, quad, 1.0),
                           torch.float64, "cpu")
    return {"mass": mass, "stiff": stiff,
            "system": mass.axpy(0.25 * 0.02 ** 2, stiff)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("which", ["mass", "stiff", "system"])
@pytest.mark.parametrize("degree", [1, 2, 4, 8, 10])
def test_cuda_smoothing_across_tiles(cuda_device, wide, dtype, which,
                                     degree):
    """B12 and B13 on 150 x 97 (degree 10 takes the shared-slab kernel),
    the schedule on [lam / 8, lam], lam the Gershgorin bound of D^-1 A:
    one launch each, bitwise-equal reruns. Tolerance: f64 1e-12 of the
    largest value; f32 100 n eps of it times 1 + lam / theta (each of n
    applies rounds ~46 terms, each at most lam / theta times |r|)."""
    st = wide[which]
    coeffs = st.terms
    diags = [float(st.plane_diag[q]) for q in "VHWD"]
    inv = tuple(1.0 / d for d in diags)
    lam = max(sum(abs(t[4]) for t in coeffs if t[0] == p) / diags[p]
              for p in range(4))
    th, cf = chebyshev_coefficients(lam / 8.0, lam, degree)
    cf = tuple((float(a), float(b)) for a, b in cf)
    hc, wc = NY2 + 3, NX2 + 3
    interior = kp.p2_canvas_interior(NX2, NY2, (hc, wc), "cpu").numpy()
    rng = np.random.default_rng(degree)
    b, x, corr = (np.where(m, rng.uniform(-1.0, 1.0, (4, hc, wc)), 0.0)
                  for m in (interior, True, True))
    b, x, corr = _on(cuda_device, dtype, b, x, corr)
    n_before = (tk.LAUNCHES["p2_presmooth"], tk.LAUNCHES["p2_postsmooth"])
    calls = (lambda: kp.p2_presmooth(b, coeffs, inv, th, cf, NX2, NY2),
             lambda: kp.p2_postsmooth(x, b, corr, coeffs, inv, th, cf, NX2,
                                      NY2))
    got = [calls[0](), (calls[1](),)]
    torch.cuda.synchronize()
    assert (tk.LAUNCHES["p2_presmooth"], tk.LAUNCHES["p2_postsmooth"]) == \
        (n_before[0] + 1, n_before[1] + 1)
    want = [kp.p2_presmooth_reference(b, coeffs, inv, th, cf, NX2, NY2),
            (kp.p2_postsmooth_reference(x, b, corr, coeffs, inv, th, cf,
                                        NX2, NY2),)]
    for outs, refs in zip(got, want):
        for g, w in zip(outs, refs):
            scale = max(float(w.abs().max()), 1.0)
            if dtype == torch.float64:
                bound = 1e-12 * scale
            else:
                bound = (100 * degree * float(torch.finfo(dtype).eps)
                         * (1.0 + lam / th) * scale)
            assert float((g - w).abs().max()) <= bound
    again = [calls[0](), (calls[1](),)]
    assert all(torch.equal(g, a) for outs, rep in zip(got, again)
               for g, a in zip(outs, rep))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_smoothing_on_padded_canvases(cuda_device, wide, dtype):
    """B12 and B13 take any Hc >= ny + 3, Wc >= nx + 3: zero padding
    leaves the engine's canvas bitwise the same (the same blocks cover it)
    and gives zeros beyond it."""
    st = wide["system"]
    inv = tuple(1.0 / float(st.plane_diag[q]) for q in "VHWD")
    th, cf = _schedule(4)
    hc, wc = NY2 + 3, NX2 + 3
    interior = kp.p2_canvas_interior(NX2, NY2, (hc, wc), "cpu").numpy()
    rng = np.random.default_rng(7)
    fields = [np.where(m, rng.uniform(-1.0, 1.0, (4, hc, wc)), 0.0)
              for m in (interior, True, True)]
    padded = []
    for f in fields:
        p = np.zeros((4, hc + 37, wc + 5))
        p[:, :hc, :wc] = f
        padded.append(p)
    outs = []
    for b, x, corr in (_on(cuda_device, dtype, *fields),
                       _on(cuda_device, dtype, *padded)):
        outs.append((*kp.p2_presmooth(b, st.terms, inv, th, cf, NX2, NY2),
                     kp.p2_postsmooth(x, b, corr, st.terms, inv, th, cf,
                                      NX2, NY2)))
    for a, p in zip(*outs):
        assert torch.equal(p[:, :hc, :wc], a)
        assert not p[:, hc:].any() and not p[:, :, wc:].any()


def _apply_stencils(nx, ny):
    """The mass, stiffness, system and square-cell stiffness (44 terms:
    two slots left at 0) on an nx x ny mesh."""
    quad = gauss_simplex(3)
    space = FeSpace(StructuredTriMesh((nx, ny), ((0.0, 0.0), (1.0, 1.0))), 2)
    sq = FeSpace(StructuredTriMesh((nx, ny), ((0.0, 0.0),
                                              (0.01 * nx, 0.01 * ny))), 2)
    mass = P2PlaneStencil(space, element_mass_class(space, quad),
                          torch.float64, "cpu")
    stiff = P2PlaneStencil(space, element_stiffness_class(space, quad, 1.0),
                           torch.float64, "cpu")
    return {"mass": mass, "stiff": stiff,
            "system": mass.axpy(0.25 * 0.02 ** 2, stiff),
            "square": P2PlaneStencil(sq, element_stiffness_class(
                sq, quad, 1.0), torch.float64, "cpu")}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mask_input", [True, False])
@pytest.mark.parametrize("which", ["mass", "stiff", "system", "square"])
@pytest.mark.parametrize("mesh", [(NX2, NY2), (600, 451)])
def test_cuda_apply_across_tiles(cuda_device, dtype, mask_input, which,
                                 mesh):
    """B11's pattern kernel on canvases of several tiles with partial
    edge tiles, random values on every canvas site (the rhs form must read
    the boundary values, the masked form must not): (100, 153) takes the
    small tile, (454, 603) the large one; one launch, a bitwise rerun."""
    nx, ny = mesh
    st = _apply_stencils(nx, ny)[which]
    assert kp.p2_apply_route(st.terms) == "pattern"
    diags = (tuple(float(st.plane_diag[q]) for q in "VHWD") if mask_input
             else (0.0,) * 4)
    rng = np.random.default_rng(nx + ny)
    (x,) = _on(cuda_device, dtype, rng.uniform(-1.0, 1.0,
                                               (4, ny + 3, nx + 3)))
    before = tk.LAUNCHES["p2_constrained_apply"]
    got = kp.p2_constrained_apply(x, st.terms, diags, nx, ny, mask_input)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["p2_constrained_apply"] == before + 1
    want = kp.p2_constrained_apply_reference(x, st.terms, diags, nx, ny,
                                             mask_input)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= _bound(dtype, scale)
    again = kp.p2_constrained_apply(x, st.terms, diags, nx, ny, mask_input)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mask_input", [True, False])
def test_cuda_apply_on_padded_canvases(cuda_device, dtype, mask_input):
    """B11 takes any Hc >= ny + 3, Wc >= nx + 3: zero padding leaves the
    engine's canvas bitwise the same (the same tiles cover it) and gives
    zeros beyond it."""
    st = _apply_stencils(NX2, NY2)["system"]
    diags = (tuple(float(st.plane_diag[q]) for q in "VHWD") if mask_input
             else (0.0,) * 4)
    hc, wc = NY2 + 3, NX2 + 3
    x = np.random.default_rng(5).uniform(-1.0, 1.0, (4, hc, wc))
    xp = np.zeros((4, hc + 37, wc + 5))
    xp[:, :hc, :wc] = x
    a, p = (kp.p2_constrained_apply(t, st.terms, diags, NX2, NY2, mask_input)
            for t in _on(cuda_device, dtype, x, xp))
    assert torch.equal(p[:, :hc, :wc], a)
    assert not p[:, hc:].any() and not p[:, :, wc:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mask_input", [True, False])
def test_cuda_general_apply_on_a_foreign_term_list(cuda_device, dtype,
                                                   mask_input):
    """A term off the pattern takes B11's general kernel."""
    terms = _refused("foreign")
    assert kp.p2_apply_route(terms) == "general"
    diags = (1.5, 0.5, 0.75, 2.0) if mask_input else (0.0,) * 4
    (x,) = _on(cuda_device, dtype, _field(15, _support()))
    before = tk.LAUNCHES["p2_constrained_apply"]
    got = kp.p2_constrained_apply(x, terms, diags, NX, NY, mask_input)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["p2_constrained_apply"] == before + 1
    want = kp.p2_constrained_apply_reference(x, terms, diags, NX, NY,
                                             mask_input)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= _bound(dtype, scale)
    again = kp.p2_constrained_apply(x, terms, diags, NX, NY, mask_input)
    assert torch.equal(got, again)
