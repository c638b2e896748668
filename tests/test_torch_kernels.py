"""The port's stencil and solver kernels (tpuwave_torch/ops/kernels.py)
against the JAX Pallas kernels they replace (tpuwave/ops/pallas_kernels.py).

On the CPU the wrappers run their plain PyTorch versions; those are held
against the Pallas kernels in interpret mode, in f64, on a random
asymmetric field over a ragged true grid (41 x 37) that is zero-padded for
Pallas to its block layout and sliced back. Tolerance: rtol 1e-12,
atol 1e-14 (the two sides sum the 9 stencil terms in different orders;
f64 roundoff is ~1e-16 relative per step).

The tests marked ``cuda`` hold each CUDA kernel against its plain version
on the card and skip where there is none. They need neither jax nor
tpuwave, so on a machine without them they run with
``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (one torch thread)
from tpuwave_torch.models.fast import FastWaveSolver
from tpuwave_torch.ops import kernels as tk

H, W = 41, 37
RTOL, ATOL = 1e-12, 1e-14


def _stencils():
    s = FastWaveSolver((W - 1, H - 1), ((0.0, 0.0), (1.0, 1.2)), 1e-3,
                       beta=0.0, dtype=torch.float64, device="cpu")
    # the Newmark system M + beta dt^2 K at a CFL-breaking dt (SPD)
    system = tuple(tuple(m + 0.25 * 0.02 ** 2 * k for m, k in zip(mr, kr))
                   for mr, kr in zip(s.mass.stencil, s.stiff.stencil))
    return s.stiff.stencil, s.mass.stencil, system


STIFF, MASS, SYSTEM = _stencils()
RAND = tuple(tuple(float(c) for c in row) for row in
             np.random.default_rng(7).uniform(-1.0, 1.0, (3, 3)))


def _fields(seed=0, n=2):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1.0, 1.0, (H, W)) for _ in range(n)]


@pytest.fixture(scope="module")
def pk():
    """tpuwave's Pallas kernels (interpret mode on the CPU)."""
    pytest.importorskip("jax")
    from tpuwave.ops import pallas_kernels
    return pallas_kernels


def _pad(a, br):
    import jax.numpy as jnp
    hp = -(-a.shape[0] // br) * br
    hp = max(hp, 2 * br)
    out = np.zeros((hp, W + 3))
    out[:a.shape[0], :a.shape[1]] = a
    return jnp.asarray(out)


def _t(a):
    return torch.tensor(a, dtype=torch.float64)


def test_stencil_orientation_is_not_symmetric():
    # the mass stencil couples (+1,+1)/(-1,-1) but not the anti-diagonal,
    # and the anisotropic stiffness couples x and y differently: a
    # transposed or flipped stencil gives a wrong answer
    assert MASS[0][0] != 0.0 and MASS[2][2] != 0.0
    assert MASS[0][2] == 0.0 and MASS[2][0] == 0.0
    assert abs(STIFF[0][1] - STIFF[1][0]) > 0.1 * abs(STIFF[0][1])


@pytest.mark.parametrize("br", [8, 16])
@pytest.mark.parametrize("diff", [False, True])
@pytest.mark.parametrize("which", ["stiff", "mass", "rand"])
def test_constrained_apply_matches_pallas(pk, br, diff, which):
    st = {"stiff": STIFF, "mass": MASS, "rand": RAND}[which]
    diag = st[1][1] if which != "rand" else 1.7
    (x,) = _fields(1, 1)
    want = pk.constrained_stencil_apply_pallas(
        _pad(x, br), stencil=st, diag=diag, block_rows=br, true_rows=H,
        true_cols=W, interpret=True, diff=diff)
    want = np.asarray(want)[:H, :W]
    got = tk.constrained_stencil_apply(_t(x), st, diag, diff=diff).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("br", [8, 16])
@pytest.mark.parametrize("which", ["stiff", "rand"])
def test_leapfrog_step_matches_pallas(pk, br, which):
    st = STIFF if which == "stiff" else RAND
    coef = 0.3 if which == "stiff" else 0.05
    u, up = _fields(2)
    want = pk.leapfrog_step_pallas(
        _pad(u, br), _pad(up, br), stencil=st, coef=coef, block_rows=br,
        true_rows=H, true_cols=W, interpret=True)
    want = np.asarray(want)[:H, :W]
    got = tk.leapfrog_step(_t(u), _t(up), st, coef).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("offset", [None, (5, 44), (-3, 60)])
def test_leapfrog_multistep_matches_pallas(pk, k, offset):
    u, up = _fields(3)
    coef = 0.3
    br = 16
    kw = dict(stencil=STIFF, coef=coef, n_steps=k, block_rows=br,
              true_cols=W, interpret=True)
    if offset is None:
        wu, wup = pk.leapfrog_multistep_pallas(_pad(u, br), _pad(up, br),
                                               true_rows=H, **kw)
        gu, gup = tk.leapfrog_multistep(_t(u), _t(up), STIFF, coef, k)
    else:
        row_offset, n_rows = offset
        wu, wup = pk.leapfrog_multistep_pallas(
            _pad(u, br), _pad(up, br), row_offset, true_rows=n_rows, **kw)
        gu, gup = tk.leapfrog_multistep(_t(u), _t(up), STIFF, coef, k,
                                        row_offset=row_offset, n_rows=n_rows)
    np.testing.assert_allclose(gu.numpy(), np.asarray(wu)[:H, :W],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gup.numpy(), np.asarray(wup)[:H, :W],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k,br,offset", [(16, 32, None), (16, 32, (5, 44)),
                                         (32, 64, None)])
def test_leapfrog_multistep_deep_matches_pallas(pk, k, br, offset):
    """Passes as deep as one B2 launch (16 steps in f32) and deeper (32,
    two launches in f32, four in f64), against the Pallas kernel at the
    smallest block_rows its halo of k rows allows."""
    u, up = _fields(16)
    kw = dict(stencil=STIFF, coef=0.3, n_steps=k, block_rows=br,
              true_cols=W, interpret=True)
    row_offset, n_rows = offset if offset is not None else (0, H)
    wu, wup = pk.leapfrog_multistep_pallas(
        _pad(u, br), _pad(up, br), *(() if offset is None else (row_offset,)),
        true_rows=n_rows, **kw)
    gu, gup = tk.leapfrog_multistep(_t(u), _t(up), STIFF, 0.3, k,
                                    row_offset=row_offset, n_rows=n_rows)
    np.testing.assert_allclose(gu.numpy(), np.asarray(wu)[:H, :W],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gup.numpy(), np.asarray(wup)[:H, :W],
                               rtol=RTOL, atol=ATOL)


def _chunked_pass(u, up, k, depths, row_offset, n_rows):
    """The plain version run launch by launch as the B2 kernel splits a
    pass: each launch's output keeps the rows the later launches still
    step (the remaining steps' rows beyond the array on each side), and
    the next launch reads them."""
    rest = k - depths[0]
    pad = (0, 0, rest, rest)
    cur = (torch.nn.functional.pad(u, pad), torch.nn.functional.pad(up, pad))
    cur = tk.leapfrog_multistep_reference(*cur, STIFF, 0.3, depths[0],
                                          row_offset - rest, n_rows)
    for d in depths[1:]:
        nxt = tk.leapfrog_multistep_reference(*cur, STIFF, 0.3, d,
                                              row_offset - rest, n_rows)
        rest -= d
        cur = tuple(t[d:t.shape[0] - d] for t in nxt)
    return cur


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("offset", [None, (5, 44)])
def test_split_pass_equals_one_pass(dtype, offset):
    """k = 32 split as the wrapper splits it on the card (16 + 16 in f32,
    4 x 8 in f64) gives one pass's result bitwise, also for a row block
    whose rows beyond the array are stepped (row offset 5 of 44 rows)."""
    k = 32
    depths = tk.multistep_geometry(k, dtype, 232448).depths
    assert len(depths) > 1
    u, up = (torch.tensor(a, dtype=dtype) for a in _fields(17))
    row_offset, n_rows = offset if offset is not None else (0, H)
    got = _chunked_pass(u, up, k, depths, row_offset, n_rows)
    want = tk.leapfrog_multistep_reference(u, up, STIFF, 0.3, k, row_offset,
                                           n_rows)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)
    # the kept rows matter: a split that drops them differs
    if offset is not None:
        cut = (u, up)
        for d in depths:
            cut = tk.leapfrog_multistep_reference(*cut, STIFF, 0.3, d,
                                                  row_offset, n_rows)
        assert not torch.equal(cut[0], want[0])


def test_multistep_equals_repeated_single_steps():
    u, up = _fields(4)
    a, b = _t(u), _t(up)
    for _ in range(6):
        a, b = tk.leapfrog_step(a, b, STIFF, 0.3), a
    gu, gup = tk.leapfrog_multistep(_t(u), _t(up), STIFF, 0.3, 6)
    np.testing.assert_allclose(gu.numpy(), a.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gup.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)


def test_wrappers_reject_bad_inputs():
    x = torch.zeros((8, 8), dtype=torch.float64)
    with pytest.raises(TypeError):
        tk.constrained_stencil_apply(x.to(torch.int32), STIFF, 1.0)
    with pytest.raises(ValueError, match="2-D"):
        tk.constrained_stencil_apply(x.reshape(-1), STIFF, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        tk.leapfrog_step(x.t()[:, :4], x[:, :4], STIFF, 1.0)
    with pytest.raises(ValueError, match="differ"):
        tk.leapfrog_step(x, x.to(torch.float32), STIFF, 1.0)
    with pytest.raises(ValueError, match="n_steps"):
        tk.leapfrog_multistep(x, x, STIFF, 1.0, 0)


def test_multistep_tile_fits_and_refuses():
    # the H100's 227 KB opt-in limit. B6 runs on B2's wavefront: k = 32 is
    # two launches in f32, from steps 0 and 16; k = 200, which no square
    # slab held, is 13 launches
    g = tk.multistep_geometry(32, torch.float32, 232448)
    assert g.starts == (0, 16)
    assert len(tk.multistep_geometry(200, torch.float32, 232448).depths) \
        == 13
    # B2's streaming slabs: k = 32 is two launches of 16 in f32 and four
    # of 8 in f64, within the limit; a smaller limit takes shallower
    # launches; none where not even one step's rings fit
    g = tk.multistep_geometry(32, torch.float32, 232448)
    assert g.depths == (16, 16) and g.smem_bytes <= 232448
    g = tk.multistep_geometry(32, torch.float64, 232448)
    assert g.depths == (8, 8, 8, 8) and g.smem_bytes <= 232448
    g = tk.multistep_geometry(32, torch.float32, 12000)
    assert max(g.depths) < 16 and g.smem_bytes <= 12000
    with pytest.raises(ValueError, match="shared memory"):
        tk.multistep_geometry(4, torch.float32, 500)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 7, 8, 9, 16, 17, 33, 64])
def test_multistep_geometry_splits_the_pass(dtype, k):
    """ceil(k / K) launches, K = MULTISTEP_MAX_DEPTH[dtype], of depths
    within one of each other, the first the shallowest (the scratch
    between launches is sized by it); every launch's slab is a multiple of
    the 16-byte vector, holds its items (512 threads, 3 items each in f32,
    2 in f64) and a tile of at least 2 depth columns, and its depth + 2
    rings of 8 rows fit the limit (one block per SM)."""
    lim = 232448
    g = tk.multistep_geometry(k, dtype, lim)
    deepest = tk.MULTISTEP_MAX_DEPTH[dtype]
    assert len(g.depths) == -(-k // deepest)
    assert sum(g.depths) == k and max(g.depths) - min(g.depths) <= 1
    assert g.depths[0] == min(g.depths)
    isz = torch.empty((), dtype=dtype).element_size()
    v = 16 // isz
    items = 512 * (3 if dtype == torch.float32 else 2)
    for d in set(g.depths):
        sw = tk.multistep_slab(d, dtype, lim)
        assert sw % v == 0 and sw <= 512 and d * sw // v <= items
        assert sw - 2 * d >= 2 * d
        assert (d + 2) * 8 * (sw + 2 * v) * isz <= lim


#: B6's launches of a pass of k steps (first step, depth), as the wrapper
#: and csrc/stencil_kernels.cu launch_multistep split it on the card: at
#: most 16 steps a launch in f32, 8 in f64, as even as they can be, the
#: first the shallowest
DRIVEN_SPLITS = {
    (torch.float32, 1): ((0, 1),),
    (torch.float32, 16): ((0, 16),),
    (torch.float32, 17): ((0, 8), (8, 9)),
    (torch.float32, 32): ((0, 16), (16, 16)),
    (torch.float32, 33): ((0, 11), (11, 11), (22, 11)),
    (torch.float64, 1): ((0, 1),),
    (torch.float64, 16): ((0, 8), (8, 8)),
    (torch.float64, 17): ((0, 5), (5, 6), (11, 6)),
    (torch.float64, 32): ((0, 8), (8, 8), (16, 8), (24, 8)),
    (torch.float64, 33): ((0, 6), (6, 7), (13, 6), (19, 7), (26, 7)),
}


@pytest.mark.parametrize("dtype,k", DRIVEN_SPLITS)
def test_driven_geometry_launches(dtype, k):
    """B6's launch split: the number of launches, their depths and each
    launch's first step, from which it reads its edge tables."""
    g = tk.multistep_geometry(k, dtype, 232448)
    assert tuple(zip(g.starts, g.depths)) == DRIVEN_SPLITS[dtype, k]


@pytest.mark.parametrize("dtype,k", DRIVEN_SPLITS)
def test_driven_split_pass_equals_one_pass(dtype, k):
    """B6's pass split as the wrapper splits it on the card, each launch
    run through the plain version on H x W pairs with its slice of the
    edge tables, gives one pass's result bitwise."""
    rng = np.random.default_rng(50 + k)
    u, up = (torch.tensor(a, dtype=dtype) for a in _fields(18))
    gtb = torch.tensor(rng.uniform(-2.0, 2.0, (k, 2, W)), dtype=dtype)
    glr = torch.tensor(rng.uniform(-2.0, 2.0, (k, H, 2)), dtype=dtype)
    g = tk.multistep_geometry(k, dtype, 232448)
    got = (u, up)
    for s0, d in zip(g.starts, g.depths):
        got = tk.leapfrog_multistep_driven(*got, gtb[s0:s0 + d],
                                           glr[s0:s0 + d], STIFF, 0.3, d)
    want = tk.leapfrog_multistep_driven_reference(u, up, gtb, glr, STIFF,
                                                  0.3, k)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)


def test_cpu_tensors_never_count_launches():
    tk.reset_launches()
    (x,) = _fields(5, 1)
    tk.constrained_stencil_apply(_t(x), STIFF, 1.0)
    tk.leapfrog_step(_t(x), _t(x), STIFF, 0.1)
    tk.leapfrog_multistep(_t(x), _t(x), STIFF, 0.1, 2)
    tk.cheby_block(_t(x), _t(x), SYSTEM, *_cheby_schedule(2))
    tk.recurrence_r0(_t(x), _t(x), STIFF, 1.1, -0.1)
    assert all(v == 0 for v in tk.LAUNCHES.values())


# ---------------------------------------------------------------------------
# B4 cheby_block and B5 recurrence_r0
# ---------------------------------------------------------------------------
def _cheby_schedule(degree):
    from tpuwave_torch.solve.cheby_iter import (chebyshev_coefficients,
                                                stencil_symbol_bounds)
    lo, hi = stencil_symbol_bounds(SYSTEM)
    theta, coeffs = chebyshev_coefficients(lo, hi, degree)
    return theta, tuple(coeffs)


@pytest.mark.parametrize("br", [8, 16])
@pytest.mark.parametrize("which", ["system", "rand"])
def test_cheby_block_matches_pallas(pk, br, which):
    """Degree 6 on the ragged grid; r is random on pinned nodes too (both
    sides mask it). rr is held against the f64 dot product of the result
    and against the Pallas kernel's f32 sum."""
    # "rand": an asymmetric stencil at the system's scale
    st = SYSTEM if which == "system" else tuple(
        tuple(0.25 * SYSTEM[1][1] * c for c in row) for row in RAND)
    theta, coeffs = _cheby_schedule(6)
    x, r = _fields(11)
    wx, wr, wrr = pk.cheby_block_pallas(
        _pad(x, br), _pad(r, br), stencil=st, theta=theta, coeffs=coeffs,
        block_rows=br, true_rows=H, true_cols=W, interpret=True)
    wx, wr = np.asarray(wx)[:H, :W], np.asarray(wr)[:H, :W]
    gx, gr, grr = tk.cheby_block(_t(x), _t(r), st, theta, coeffs)
    np.testing.assert_allclose(gx.numpy(), wx, rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(gr.numpy(), wr, rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(float(grr), float(np.vdot(wr, wr)),
                               rtol=1e-12)
    np.testing.assert_allclose(float(grr), float(wrr[0, 0]), rtol=1e-5)


@pytest.mark.parametrize("br", [8, 16])
@pytest.mark.parametrize("mask_combo", [True, False])
def test_recurrence_r0_matches_pallas(pk, br, mask_combo):
    """Asymmetric random u, u_prev (nonzero on pinned nodes, which
    mask_combo=False lets the stencil read) with gamma = 0.6."""
    dt, gamma = 0.01, 0.6
    c_u, c_up = gamma + 0.5, 0.5 - gamma
    kneg = tuple(tuple(-dt * dt * c for c in row) for row in STIFF)
    u, up = _fields(12)
    want = pk.recurrence_r0_pallas(
        _pad(u, br), _pad(up, br), k_stencil=kneg, c_u=c_u, c_up=c_up,
        block_rows=br, true_rows=H, true_cols=W, interpret=True,
        mask_combo=mask_combo)
    r0, x0, rr0, xx0 = tk.recurrence_r0(_t(u), _t(up), kneg, c_u, c_up,
                                        mask_combo=mask_combo)
    wr0, wx0 = np.asarray(want[0])[:H, :W], np.asarray(want[1])[:H, :W]
    np.testing.assert_allclose(r0.numpy(), wr0, rtol=RTOL,
                               atol=RTOL * np.abs(wr0).max())
    np.testing.assert_allclose(x0.numpy(), wx0, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(rr0), float(np.vdot(wr0, wr0)),
                               rtol=1e-12)
    np.testing.assert_allclose(float(xx0), float(np.vdot(wx0, wx0)),
                               rtol=1e-12)
    np.testing.assert_allclose(float(rr0), float(want[2][0, 0]), rtol=1e-5)
    np.testing.assert_allclose(float(xx0), float(want[3][0, 0]), rtol=1e-5)


@pytest.mark.parametrize("mask_combo", [True, False])
def test_recurrence_r0_matches_pallas_odd_grid(pk, mask_combo):
    """On an odd grid (37 x 53) with c_up != 0 (gamma = 0.7) and random
    values on the pinned nodes, which mask_combo=False lets the stencil
    read; the grid is zero-padded to Pallas's 8-row blocks and 64
    columns."""
    import jax.numpy as jnp
    h, w = 37, 53
    dt, gamma = 0.01, 0.7
    c_u, c_up = gamma + 0.5, 0.5 - gamma
    kneg = tuple(tuple(-dt * dt * c for c in row) for row in STIFF)
    rng = np.random.default_rng(19)
    u, up = (rng.uniform(-1.0, 1.0, (h, w)) for _ in range(2))
    assert np.abs(u[0]).min() > 0.0 and np.abs(up[:, -1]).min() > 0.0

    def pad(a):
        out = np.zeros((40, 64))
        out[:h, :w] = a
        return jnp.asarray(out)
    want = pk.recurrence_r0_pallas(
        pad(u), pad(up), k_stencil=kneg, c_u=c_u, c_up=c_up, block_rows=8,
        true_rows=h, true_cols=w, interpret=True, mask_combo=mask_combo)
    r0, x0, rr0, xx0 = tk.recurrence_r0(_t(u), _t(up), kneg, c_u, c_up,
                                        mask_combo=mask_combo)
    wr0, wx0 = np.asarray(want[0])[:h, :w], np.asarray(want[1])[:h, :w]
    np.testing.assert_allclose(r0.numpy(), wr0, rtol=RTOL,
                               atol=RTOL * np.abs(wr0).max())
    np.testing.assert_allclose(x0.numpy(), wx0, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(rr0), float(np.vdot(wr0, wr0)),
                               rtol=1e-12)
    np.testing.assert_allclose(float(xx0), float(np.vdot(wx0, wx0)),
                               rtol=1e-12)
    np.testing.assert_allclose(float(rr0), float(want[2][0, 0]), rtol=1e-5)
    np.testing.assert_allclose(float(xx0), float(want[3][0, 0]), rtol=1e-5)


def test_cheby_block_equals_generic_block():
    """The kernel's plain version is solve/cheby_iter.py's chebyshev_block
    on the constrained apply (B3) when r is zero on pinned nodes."""
    from tpuwave_torch.solve.cheby_iter import chebyshev_block
    theta, coeffs = _cheby_schedule(5)
    x, r = _fields(13)
    r = np.where(tk.pinned_mask((H, W), "cpu").numpy(), 0.0, r)
    gx, gr, _ = tk.cheby_block(_t(x), _t(r), SYSTEM, theta, coeffs)
    wx, wr = chebyshev_block(
        lambda v: tk.constrained_stencil_apply(v, SYSTEM, SYSTEM[1][1]),
        _t(x), _t(r), theta, coeffs)
    np.testing.assert_allclose(gx.numpy(), wx.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gr.numpy(), wr.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("degree", [4, 8])
def test_chebyshev_solve_stencil_block_equals_generic(degree):
    """chebyshev_solve with stencil_chebyshev's B4 block takes the same
    blocks, to the same solution, as with the generic block on the same
    B3 apply and symbol bounds."""
    from tpuwave_torch.solve.cheby_iter import (chebyshev_solve,
                                                stencil_chebyshev)
    kw = stencil_chebyshev(SYSTEM)
    pinned = tk.pinned_mask((H, W), "cpu").numpy()
    b, x0 = (np.where(pinned, 0.0, f) for f in _fields(14))
    fused = chebyshev_solve(b=_t(b), x0=_t(x0), degree=degree,
                            reduction=1e-8, **kw)
    generic = chebyshev_solve(kw["apply_a"], _t(b), _t(x0),
                              lam_min=kw["lam_min"], lam_max=kw["lam_max"],
                              degree=degree, reduction=1e-8)
    assert fused.converged and generic.converged
    assert fused.iterations == generic.iterations > 0
    np.testing.assert_allclose(fused.x.numpy(), generic.x.numpy(),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(float(fused.residual_norm),
                               float(generic.residual_norm), rtol=1e-8)


def test_cheby_block_zero_guess_is_zeros():
    """x = None (the V-cycle's pre-smoothing) is the block from x = 0."""
    theta, coeffs = _cheby_schedule(3)
    (r,) = _fields(16, 1)
    got = tk.cheby_block(None, _t(r), SYSTEM, theta, coeffs)
    want = tk.cheby_block(torch.zeros((H, W), dtype=torch.float64), _t(r),
                          SYSTEM, theta, coeffs)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_cheby_tile_fits_and_refuses():
    # the register kernel's 64-column slabs, 64 rows (f64: 32 up to degree
    # 2) up to degree 16, less a degree halo; above, square tiles whose r
    # and d slabs plus the x tile fit the H100's 227 KB opt-in limit
    assert tk.cheby_tile(1, torch.float32, 232448) == (62, 62)
    assert tk.cheby_tile(2, torch.float64, 232448) == (28, 60)
    assert tk.cheby_tile(8, torch.float64, 232448) == (48, 48)
    assert tk.cheby_tile(16, torch.float64, 232448) == (32, 32)
    assert tk.cheby_tile(32, torch.float64, 232448) == (32, 32)
    with pytest.raises(ValueError, match="shared memory"):
        tk.cheby_tile(8, torch.float64, 16 * 1024)
    x = torch.zeros((8, 8), dtype=torch.float64)
    with pytest.raises(ValueError, match="degree"):
        tk.cheby_block(x, x, SYSTEM, 1.0, [(0.1, 0.1)] * 32)


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _on(dev, *arrays, dtype=torch.float64):
    return [torch.tensor(a, dtype=dtype, device=dev) for a in arrays]


def _bound(dtype, scale, n=1):
    """f64: 1e-12 relative. f32: 22 rounded terms per point on each side,
    propagated over n steps of a stable recurrence (<= n^2 / 2 growth)."""
    if dtype == torch.float64:
        return 1e-12 * scale
    return 22 * max(1.0, n * n / 2) * float(torch.finfo(dtype).eps) * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("diff", [False, True])
@pytest.mark.parametrize("shape", [(3, 3), (H, W), (130, 197), (17, 1000),
                                   (300, 257), (1457, 1459)])
def test_cuda_constrained_apply(cuda_device, dtype, diff, shape):
    # one block, and several with ragged last blocks in both directions, on
    # each of the kernel's three paths: the direct one (under 2^16 nodes),
    # 64 x 8 tiles (300 x 257) and 64 x 32 tiles (over 2^21 nodes)
    (x,) = _on(cuda_device, np.random.default_rng(6).uniform(-1.0, 1.0,
                                                              shape),
               dtype=dtype)
    before = tk.LAUNCHES["constrained_stencil_apply"]
    got = tk.constrained_stencil_apply(x, RAND, 1.7, diff=diff)
    again = tk.constrained_stencil_apply(x, RAND, 1.7, diff=diff)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["constrained_stencil_apply"] == before + 2
    assert torch.equal(got, again)
    want = tk.constrained_stencil_apply_reference(x, RAND, 1.7, diff)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= _bound(dtype, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("diff", [False, True])
@pytest.mark.parametrize("shape,place", [
    ((40, 37), (-1, -1, 78, 37)),          # a rank's padded block, direct
    ((163, 643), (159, -1, 641, 641)),     # 64 x 8 tiles, an inner slab
    ((1459, 1462), (-1, 700, 1457, 2160)),  # 64 x 32 tiles, a corner block
])
def test_cuda_constrained_apply_at_offsets(cuda_device, dtype, diff, shape,
                                           place):
    # the block of a larger grid whose node (ro, co) is the block's (0, 0):
    # pinned by the larger grid's walls; the outputs whose neighbourhood
    # lies in the block are exact
    ro, co, nh, nw = place
    (x,) = _on(cuda_device, np.random.default_rng(8).uniform(-1.0, 1.0,
                                                              shape),
               dtype=dtype)
    kw = dict(row_offset=ro, col_offset=co, n_rows=nh, n_cols=nw)
    got = tk.constrained_stencil_apply(x, RAND, 1.7, diff=diff, **kw)
    again = tk.constrained_stencil_apply(x, RAND, 1.7, diff=diff, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = tk.constrained_stencil_apply_reference(x, RAND, 1.7, diff, **kw)
    got, want = got[1:-1, 1:-1], want[1:-1, 1:-1]
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= _bound(dtype, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_leapfrog_step(cuda_device, dtype):
    u, up = _on(cuda_device, *_fields(7), dtype=dtype)
    got = tk.leapfrog_step(u, up, RAND, 0.05)
    torch.cuda.synchronize()
    want = tk.leapfrog_step_reference(u, up, RAND, 0.05)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= _bound(dtype, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("degree", [1, 2, 8, 32])
@pytest.mark.parametrize("shape", [(H, W), (300, 257)])
@pytest.mark.parametrize("zero_guess", [False, True])
def test_cuda_cheby_block(cuda_device, dtype, degree, shape, zero_guess):
    # (300, 257): blocks whose slab touches no wall, beside ones that do
    theta, coeffs = _cheby_schedule(degree)
    rng = np.random.default_rng(14)
    x, r = _on(cuda_device, *(rng.uniform(-1.0, 1.0, shape)
                              for _ in range(2)), dtype=dtype)
    x0 = None if zero_guess else x
    before = tk.LAUNCHES["cheby_block"]
    got = tk.cheby_block(x0, r, SYSTEM, theta, coeffs)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["cheby_block"] == before + 1
    want = tk.cheby_block_reference(x0, r, SYSTEM, theta, coeffs)
    for g, w in zip(got[:2], want[:2]):
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= _bound(dtype, scale, degree)
    # the in-kernel norm against a dot product of the returned r, in its
    # dtype (at degree 32 the f32 squares of the 41 x 37 grid's r underflow)
    dot = float(torch.dot(got[1].reshape(-1), got[1].reshape(-1)))
    rel = 1e-12 if dtype == torch.float64 else 1e-5
    assert abs(float(got[2]) - dot) <= rel * dot
    # deterministic: a rerun is bitwise equal
    again = tk.cheby_block(x0, r, SYSTEM, theta, coeffs)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mask_combo", [True, False])
@pytest.mark.parametrize("shape", [(3, 3), (H, W), (37, 53), (17, 1000),
                                   (1500, 1457)])
def test_cuda_recurrence_r0(cuda_device, dtype, mask_combo, shape):
    # one block, and several 64 x 32 tiles with ragged last ones in both
    # directions; random values on the pinned nodes too
    rng = np.random.default_rng(15)
    u, up = _on(cuda_device, *(rng.uniform(-1.0, 1.0, shape)
                               for _ in range(2)), dtype=dtype)
    kneg = tuple(tuple(-1e-4 * c for c in row) for row in STIFF)
    before = tk.LAUNCHES["recurrence_r0"]
    got = tk.recurrence_r0(u, up, kneg, 1.1, -0.1, mask_combo)
    # back to back: the first call's last block set the ticket to 0 again
    again = tk.recurrence_r0(u, up, kneg, 1.1, -0.1, mask_combo)
    torch.cuda.synchronize()
    # one launch per call, the norms included
    assert tk.LAUNCHES["recurrence_r0"] == before + 2
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    assert int(tk._ticket(cuda_device, stream)) == 0
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = tk.recurrence_r0_reference(u, up, kneg, 1.1, -0.1, mask_combo)
    for g, w in zip(got[:2], want[:2]):
        assert float((g - w).abs().max()) <= _bound(
            dtype, float(w.abs().max()))
    # the norms at a relative error that grows with sqrt(n), not n, so a
    # norm of 0 or of the wrong terms fails at every shape
    rel = (1e-12 if dtype == torch.float64 else
           22 * float(torch.finfo(dtype).eps)) * (shape[0] * shape[1]) ** 0.5
    for g, w in zip(got[2:], want[2:]):
        assert abs(float(g) - float(w)) <= rel * abs(float(w))


# B2 on a grid of several strips (columns) and bands (rows) whose sides
# are not multiples of the tile: 1100 columns are 3 strips at k = 1 (the
# 512-column slab) and 4 at k = 16 (312 columns); a row block whose first
# rows are pinned (row offset -3 of 260 rows: its bands near the top and
# bottom hold pinned rows), one whose rows beyond the array are stepped and
# whose bands hold no pinned row (offset 100 of 2000)
MULTI = (300, 1100)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 2, 7, 8, 9, 16, 31, 32, 33, 64])
@pytest.mark.parametrize("offset", [None, (-3, 260), (100, 2000)])
def test_cuda_leapfrog_multistep(cuda_device, dtype, k, offset):
    rng = np.random.default_rng(8 + k)
    u, up = _on(cuda_device, *(rng.uniform(-1.0, 1.0, MULTI)
                               for _ in range(2)), dtype=dtype)
    ro, nr = offset if offset is not None else (0, None)
    before = tk.LAUNCHES["leapfrog_multistep"]
    got = tk.leapfrog_multistep(u, up, STIFF, 0.3, k, row_offset=ro,
                                n_rows=nr)
    torch.cuda.synchronize()
    # one launch per depth of multistep_geometry
    lim = tk._max_smem(tk._lib(), "test", cuda_device)
    assert tk.LAUNCHES["leapfrog_multistep"] == before + len(
        tk.multistep_geometry(k, dtype, lim).depths)
    want = tk.leapfrog_multistep_reference(u, up, STIFF, 0.3, k, ro, nr)
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= _bound(dtype, scale, k)
    again = tk.leapfrog_multistep(u, up, STIFF, 0.3, k, row_offset=ro,
                                  n_rows=nr)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("which", ["cross", "mass", "rand"])
@pytest.mark.parametrize("k", [8, 17])
def test_cuda_leapfrog_multistep_zero_patterns(cuda_device, dtype, which, k):
    """B2 compiles the stencil's exact zeros in: the stiffness on square
    cells has zero corners (5 terms), the mass zero anti-diagonal corners
    (7), a random stencil none (9); each instance against the plain
    version, which skips the same zeros."""
    st = {"cross": FastWaveSolver((64, 64), ((0.0, 0.0), (1.0, 1.0)), 1e-3,
                                  beta=0.0, dtype=torch.float64,
                                  device="cpu").stiff.stencil,
          "mass": tuple(tuple(1e4 * c for c in row) for row in MASS),
          "rand": RAND}[which]
    coef = 0.3 if which == "cross" else 0.05
    rng = np.random.default_rng(40 + k)
    u, up = _on(cuda_device, *(rng.uniform(-1.0, 1.0, MULTI)
                               for _ in range(2)), dtype=dtype)
    got = tk.leapfrog_multistep(u, up, st, coef, k)
    torch.cuda.synchronize()
    want = tk.leapfrog_multistep_reference(u, up, st, coef, k)
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= _bound(dtype, scale, k)


# B6 on B2's wavefront: one block (3 x 3), a wide grid of one band and
# several strips at small depths (17 x 1000), a tall one of one strip and
# many bands (1000 x 17), and sides that are not multiples of 4 (131 x
# 133); k = 17 and 33 split into launches of uneven depths in both dtypes
DRIVEN = (131, 133)


def _driven_tables(dev, dtype, k, shape=DRIVEN):
    rng = np.random.default_rng(20 + k)
    h, w = shape
    u, up = (torch.tensor(rng.uniform(-1.0, 1.0, shape), dtype=dtype,
                          device=dev) for _ in range(2))
    gtb = torch.tensor(rng.uniform(-2.0, 2.0, (k, 2, w)), dtype=dtype,
                       device=dev)
    glr = torch.tensor(rng.uniform(-2.0, 2.0, (k, h, 2)), dtype=dtype,
                       device=dev)
    return u, up, gtb, glr


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 2, 8, 16, 17, 32, 33])
@pytest.mark.parametrize("shape", [(3, 3), (17, 1000), (1000, 17), DRIVEN])
def test_cuda_leapfrog_multistep_driven(cuda_device, dtype, k, shape):
    u, up, gtb, glr = _driven_tables(cuda_device, dtype, k, shape)
    before = tk.LAUNCHES["leapfrog_multistep_driven"]
    got = tk.leapfrog_multistep_driven(u, up, gtb, glr, STIFF, 0.3, k)
    torch.cuda.synchronize()
    # one launch per depth of multistep_geometry
    lim = tk._max_smem(tk._lib(), "test", cuda_device)
    assert tk.LAUNCHES["leapfrog_multistep_driven"] == before + len(
        tk.multistep_geometry(k, dtype, lim).depths)
    want = tk.leapfrog_multistep_driven_reference(u, up, gtb, glr, STIFF,
                                                  0.3, k)
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= _bound(dtype, scale, k)
    # the driven nodes carry the last substep's data exactly (the rows win
    # at the corners), u_prev the one before
    assert torch.equal(got[0][-1], gtb[-1, 1])
    assert torch.equal(got[0][0], gtb[-1, 0])
    assert torch.equal(got[0][1:-1, -1], glr[-1, 1:-1, 1])
    assert torch.equal(got[0][1:-1, 0], glr[-1, 1:-1, 0])
    if k > 1:
        assert torch.equal(got[1][-1], gtb[-2, 1])
        assert torch.equal(got[1][1:-1, 0], glr[-2, 1:-1, 0])
    again = tk.leapfrog_multistep_driven(u, up, gtb, glr, STIFF, 0.3, k)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [8, 16])
def test_cuda_leapfrog_multistep_driven_halo_injection(cuda_device, dtype,
                                                       k):
    """Data only on the last row and column, on a grid of several strips
    and bands (MULTI): every band within k rows of row H - 1 holds it in
    its rows' halo, and every strip's slab holds its halo columns of that
    row, so each must inject the data there; a block that skipped it
    would leave its tile wrong after a few substeps."""
    rng = np.random.default_rng(30 + k)
    h, w = MULTI
    u = torch.zeros(MULTI, dtype=dtype, device=cuda_device)
    up = torch.zeros_like(u)
    gtb, glr = _on(cuda_device, rng.uniform(-2.0, 2.0, (k, 2, w)),
                   rng.uniform(-2.0, 2.0, (k, h, 2)), dtype=dtype)
    gtb[:, 0] = 0.0
    glr[:, :, 0] = 0.0
    got = tk.leapfrog_multistep_driven(u, up, gtb, glr, STIFF, 0.3, k)
    torch.cuda.synchronize()
    want = tk.leapfrog_multistep_driven_reference(u, up, gtb, glr, STIFF,
                                                  0.3, k)
    # the data reached k - 1 rows above the last row, along the whole of
    # it, and no further
    assert float(want[0][h - k].abs().max()) > 0.0
    assert bool((want[0][h - 2, 1:-1] != 0.0).all())
    assert float(want[0][:h - k, :w - k].abs().max()) == 0.0
    for g, w_ in zip(got, want):
        assert float((g - w_).abs().max()) <= _bound(
            dtype, float(w_.abs().max()), k)


# B7-B10 on an odd-sized grid, with non-zero values on the pinned nodes
ODD = (37, 53)


def _odd_fields(dev, dtype, seed, n):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.uniform(-1.0, 1.0, ODD), dtype=dtype,
                         device=dev) for _ in range(n)]


def _held(got, want, dtype, again):
    """Grids within _bound of the output scale, the three squared norms
    within 1e-12 / 1e-5 relative; a rerun is bitwise equal."""
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if g.dim():
            assert float((g - w).abs().max()) <= _bound(
                dtype, float(w.abs().max()))
        else:
            rel = 1e-12 if dtype == torch.float64 else 1e-5
            assert abs(float(g) - float(w)) <= rel * float(w)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_newmark_rhs_r0(cuda_device, dtype):
    u, v, a = _odd_fields(cuda_device, dtype, 31, 3)
    args = (u, v, a, STIFF, SYSTEM, 0.02, 1e-4)
    before = tk.LAUNCHES["newmark_rhs_r0"]
    got = tk.newmark_rhs_r0(*args)
    assert tk.LAUNCHES["newmark_rhs_r0"] == before + 1
    _held(got, tk.newmark_rhs_r0_reference(*args), dtype,
          tk.newmark_rhs_r0(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_newmark_update(cuda_device, dtype):
    args = (*_odd_fields(cuda_device, dtype, 32, 4), 1e-4, 0.008, 0.012)
    before = tk.LAUNCHES["newmark_update"]
    got = tk.newmark_update(*args)
    assert tk.LAUNCHES["newmark_update"] == before + 1
    _held(got, tk.newmark_update_reference(*args), dtype,
          tk.newmark_update(*args))


def _device_kernels(fn):
    """Names of the device kernels that one call of fn launches, as
    torch.profiler records them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()
            for _ in range(e.count) if e.device_type == DeviceType.CUDA]


# B9's blocks take tiles of 64 x 16 nodes in turn, one wave of resident
# blocks: ODD is one column of tiles, (67, 129) and (65, 130) cut the last
# column and row of tiles mid-way, (1500, 1457) has over 2^21 nodes, tiles
# whose slab touches no wall, and more tiles than resident blocks, so a
# block computes a second tile (in f64 it loads that tile when its turn
# comes, in f32 while it computes the one before)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype, shape", [
    (torch.float32, ODD), (torch.float64, ODD), (torch.float64, (3, 3)),
    (torch.float32, (67, 129)), (torch.float64, (67, 129)),
    (torch.float32, (65, 130)), (torch.float64, (65, 130)),
    (torch.float32, (1500, 1457)), (torch.float64, (1500, 1457))])
def test_cuda_theta_r0u(cuda_device, dtype, shape):
    rng = np.random.default_rng(33)
    u, v = _on(cuda_device, *(rng.uniform(-1.0, 1.0, shape)
                              for _ in range(2)), dtype=dtype)
    args = (u, v, MASS, STIFF, -1e-4, -2e-4, 0.02)
    before = tk.LAUNCHES["theta_r0u"]
    got = tk.theta_r0u(*args)
    # back to back: the first call's last block set the ticket to 0 again
    again = tk.theta_r0u(*args)
    torch.cuda.synchronize()
    # one launch per call, the three norms included
    assert tk.LAUNCHES["theta_r0u"] == before + 2
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    assert int(tk._ticket(cuda_device, stream)) == 0
    launched = _device_kernels(lambda: tk.theta_r0u(*args))
    assert len(launched) == 1 and "theta_r0u" in launched[0], launched
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = tk.theta_r0u_reference(*args)
    assert float((got[0] - want[0]).abs().max()) <= _bound(
        dtype, float(want[0].abs().max()))
    # the norms within 1e-12 / 1e-5 relative (phase 3's bound), and in f32
    # within 22 eps sqrt(n) where that is tighter (a few nodes)
    eps = float(torch.finfo(dtype).eps)
    rel = 1e-12 if dtype == torch.float64 else min(
        1e-5, 22 * eps * (shape[0] * shape[1]) ** 0.5)
    for g, w in zip(got[1:], want[1:]):
        assert abs(float(g) - float(w)) <= rel * abs(float(w))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_theta_r0v(cuda_device, dtype):
    u, e, v = _odd_fields(cuda_device, dtype, 34, 3)
    args = (u, e, v, MASS, STIFF, -0.01, -0.01)
    before = tk.LAUNCHES["theta_r0v"]
    got = tk.theta_r0v(*args)
    assert tk.LAUNCHES["theta_r0v"] == before + 1
    _held(got, tk.theta_r0v_reference(*args), dtype, tk.theta_r0v(*args))
