"""The port's FWI kernels (tpuwave_torch/ops/kernels_varcoef.py, B14-B17)
against the JAX Pallas kernels they replace (tpuwave/ops/pallas_varcoef.py).

On the CPU the wrappers run their plain PyTorch versions; those are held
against the Pallas kernels in interpret mode, in f64, on tpuwave's own
test grid ((12, 10) elements: an 11 x 13 vertex grid, zero-padded for
Pallas to 24 x 16 with 8-row blocks and cropped back), with random values
on every node, the pinned ones included. The planes are a real problem's
(random c2, with and without a sponge), so the steps are stable.
Tolerance: rtol 1e-12, atol 1e-13.

The tests marked ``cuda`` hold each CUDA kernel against its plain version
on the card, on grids of several tiles with the source one row and one
column outside a tile and receivers across tile edges, and skip where
there is none. They need neither jax nor tpuwave:
``python -m pytest --noconftest -m cuda tests/test_torch_fwi_kernels.py``.
"""

import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (one torch thread)
from tpuwave_torch.models.inverse import FwiProblem
from tpuwave_torch.ops import kernels as tk
from tpuwave_torch.ops import kernels_varcoef as kv

RTOL, ATOL = 1e-12, 1e-13
BR, HP, WP = 8, 24, 16          # Pallas block rows and padded grid


def _problem(nel=(12, 10), sponge=False, dtype=torch.float64,
             device="cpu"):
    kw = (dict(sponge_width=0.22, sponge_strength=25.0, boundary_save="ring")
          if sponge else {})
    return FwiProblem(nel, ((0.0, 0.0), (1.0, 1.0)), 8e-3, 8,
                      source=(0.45, 0.55), receivers=[(0.3, 0.3)],
                      dtype=dtype, device=device, engine="kernel", **kw)


def _setup(seed=0, sponge=False, nel=(12, 10)):
    """(problem, coef, planes (7, H, W), rng) on the CPU in f64."""
    prob = _problem(nel, sponge)
    rng = np.random.default_rng(seed)
    planes = prob._stacked_planes(torch.tensor(
        1.0 + 0.3 * rng.random(prob.n_cells)))
    return prob, prob.dt ** 2 / prob._det_j, planes, rng


def _fields(rng, shape, n):
    return [torch.tensor(rng.uniform(-1.0, 1.0, shape)) for _ in range(n)]


@pytest.fixture(scope="module")
def pv():
    """tpuwave's Pallas FWI kernels (interpret mode on the CPU)."""
    pytest.importorskip("jax")
    from tpuwave.ops import pallas_varcoef
    return pallas_varcoef


def _pad(a, fill=0.0):
    """(..., rows, cols) -> (..., HP, WP) jnp array, ``fill`` outside."""
    import jax.numpy as jnp
    a = np.asarray(a)
    out = np.full(a.shape[:-2] + (HP, WP), fill)
    out[..., :a.shape[-2], :a.shape[-1]] = a
    return jnp.asarray(out)


def _crop(a, rows, cols):
    return np.asarray(a)[..., :rows, :cols]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# CPU: the plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("damped", [False, True])
def test_step_reference_matches_pallas(pv, damped):
    prob, coef, planes, rng = _setup(1, sponge=damped)
    rows, cols = prob._grid
    u, up = _fields(rng, prob._grid, 2)
    damp = prob._kernel_damp[:2] if damped else None
    got = kv.varcoef_leapfrog_step(u, up, planes, coef, damp)
    want = pv.varcoef_leapfrog_step_pallas(
        _pad(u), _pad(up), _pad(planes), coef=coef,
        damp=None if damp is None else (_pad(damp[0], 1.0),
                                        _pad(damp[1], 1.0)),
        block_rows=BR, true_rows=rows, true_cols=cols, interpret=True)
    _close(got, _crop(want, rows, cols))


def _pallas_multistep(pv, prob, coef, planes_ms, u, up, w, src, ring):
    """tpuwave's B15 on the padded grid -> (u, u_prev, traces, rings)."""
    import jax.numpy as jnp
    rows, cols = prob._grid
    rec = prob._receivers
    rr, rc = rec.rows.numpy(), rec.cols.numpy()
    rec_rows = tuple(sorted(set(int(r) for r in rr)))
    slot = np.asarray([rec_rows.index(int(r)) for r in rr])
    fill = np.ones(planes_ms.shape[0])
    fill[:7] = 0.0
    pl = jnp.stack([_pad(p, f) for p, f in zip(planes_ms, fill)])
    outs = pv.varcoef_leapfrog_multistep_pallas(
        _pad(u), _pad(up), pl, jnp.asarray(w.numpy()),
        jnp.asarray(src, jnp.int32), coef=coef, n_steps=w.numel(),
        rec_rows=rec_rows, block_rows=BR, true_rows=rows, true_cols=cols,
        interpret=True, ring=ring)
    strip = np.asarray(outs[2])
    vals = strip[:, slot, rc] * rec.weights.numpy()
    traces = vals.reshape(w.numel(), -1, rec.per).sum(-1)
    res = (_crop(outs[0], rows, cols), _crop(outs[1], rows, cols), traces)
    if ring is not None:
        res += (np.asarray(outs[3])[:, :, :cols],
                np.asarray(outs[4])[:, :rows, :2])
    return res


@pytest.mark.parametrize("k, damped, src", [
    (1, False, (5, 6)), (3, False, (8, 6)), (8, False, (7, 4)),
    (8, True, (8, 7))])
def test_multistep_reference_matches_pallas(pv, k, damped, src):
    """Sources on both sides of the Pallas row-block edge (rows 7 and 8);
    the damped case with the ring saves."""
    prob, coef, planes, rng = _setup(2, sponge=damped)
    u, up = _fields(rng, prob._grid, 2)
    w = torch.tensor(rng.uniform(-1.0, 1.0, k))
    planes_ms = prob._planes9_forward(planes) if damped else planes
    ring = prob._ring if damped else None
    got = kv.varcoef_leapfrog_multistep(u, up, planes_ms, w, src, coef,
                                        prob._receivers, ring)
    want = _pallas_multistep(pv, prob, coef, planes_ms, u, up, w, src, ring)
    assert len(got) == len(want)
    for g, wt in zip(got, want):
        _close(g, wt)


def test_adjoint_step_reference_matches_pallas(pv):
    prob, coef, planes, rng = _setup(3)
    rows, cols = prob._grid
    un, uc, lam, lp = _fields(rng, prob._grid, 4)
    wbar = torch.tensor(rng.uniform(-1.0, 1.0, (7, rows, cols)))
    want = pv.varcoef_adjoint_step_pallas(
        _pad(un), _pad(uc), _pad(lam), _pad(lp), _pad(planes), _pad(wbar),
        coef=coef, block_rows=BR, true_rows=rows, true_cols=cols,
        interpret=True)
    got = kv.varcoef_adjoint_step(un, uc, lam, lp, planes, wbar.clone(),
                                  coef)
    for g, wt in zip(got, want):
        _close(g, _crop(wt, rows, cols))


@pytest.mark.parametrize("k, damped, src", [
    (1, False, (6, 5)), (3, False, (8, 6)), (8, False, (7, 8)),
    (8, True, (8, 5))])
def test_adjoint_multistep_reference_matches_pallas(pv, k, damped, src):
    import jax.numpy as jnp
    prob, coef, planes, rng = _setup(4, sponge=damped)
    rows, cols = prob._grid
    un, uc, lam, lp = _fields(rng, prob._grid, 4)
    wbar = torch.tensor(rng.uniform(-1.0, 1.0, (7, rows, cols)))
    # two receiver points on one node, one on a pinned row
    pr = torch.tensor([3, 3, 0, 7], dtype=torch.int32)
    pc = torch.tensor([4, 4, 6, 9], dtype=torch.int32)
    inj = torch.tensor(rng.uniform(-1.0, 1.0, (k, 4)))
    w = torch.tensor(rng.uniform(-1.0, 1.0, k))
    planes_ms = prob._planes9_adjoint(planes) if damped else planes
    ring, rsave = None, (None, None)
    if damped:
        ring = prob._ring
        rsave = (torch.tensor(rng.uniform(-1.0, 1.0, (k, 2, cols))),
                 torch.tensor(rng.uniform(-1.0, 1.0, (k, rows, 2))))
    got = kv.varcoef_adjoint_multistep(un, uc, lam, lp, planes_ms,
                                       wbar.clone(), w, inj, src, coef,
                                       (pr, pc), ring, *rsave)
    groups = {}
    for p, (r, c) in enumerate(zip(pr.tolist(), pc.tolist())):
        groups.setdefault(r, []).append((c, p))
    fill = np.ones(planes_ms.shape[0])
    fill[:7] = 0.0
    ring_args = (None, None)
    if damped:
        cols128 = np.zeros((k, HP, 128))
        cols128[:, :rows, :2] = rsave[1].numpy()
        ring_args = (jnp.asarray(np.pad(rsave[0].numpy(),
                                        ((0, 0), (0, 0), (0, WP - cols)))),
                     jnp.asarray(cols128))
    want = pv.varcoef_adjoint_multistep_pallas(
        _pad(un), _pad(uc), _pad(lam), _pad(lp),
        jnp.stack([_pad(p, f) for p, f in zip(planes_ms, fill)]),
        _pad(wbar), jnp.asarray(w.numpy()), jnp.asarray(inj.numpy()),
        jnp.asarray(src, jnp.int32), *ring_args, coef=coef, n_steps=k,
        rec_groups=tuple(sorted((r, tuple(p)) for r, p in groups.items())),
        block_rows=BR, true_rows=rows, true_cols=cols, interpret=True,
        ring=ring)
    for g, wt in zip(got[:5], want[:5]):
        _close(g, _crop(wt, rows, cols))
    _close(got[5], np.asarray(want[5])[0])


# ---------------------------------------------------------------------------
# CPU: the plain versions' own algebra (no jax)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("damped", [False, True])
def test_multistep_equals_single_steps(damped):
    """B15's k fused steps are k B14 steps plus the source after the mask
    and the receiver samples of every step."""
    prob, coef, planes, rng = _setup(5, sponge=damped)
    u, up = _fields(rng, prob._grid, 2)
    w = torch.tensor(rng.uniform(-1.0, 1.0, 5))
    src = (6, 7)
    damp = prob._kernel_damp[:2] if damped else None
    ms = prob._planes9_forward(planes) if damped else planes
    got = kv.varcoef_leapfrog_multistep(u, up, ms, w, src, coef,
                                        prob._receivers, prob._ring)
    fac = damp[1][src] if damped else 1.0
    cur, prev, traces = u, up, []
    for s in range(5):
        nxt = kv.varcoef_leapfrog_step(cur, prev, planes, coef, damp)
        nxt[src] += coef * w[s] * fac
        cur, prev = nxt, cur
        traces.append(prob._sample(cur.reshape(-1)))
    torch.testing.assert_close(got[0], cur, rtol=1e-13, atol=1e-14)
    torch.testing.assert_close(got[1], prev, rtol=1e-13, atol=1e-14)
    torch.testing.assert_close(got[2], torch.stack(traces), rtol=1e-13,
                               atol=1e-14)


def test_adjoint_multistep_equals_single_steps():
    """B17's k fused steps are k B16 steps with the injections, the
    source term and the wavelet cotangent read before each update."""
    prob, coef, planes, rng = _setup(6)
    un, uc, lam, lp = _fields(rng, prob._grid, 4)
    wbar = torch.tensor(rng.uniform(-1.0, 1.0, (7,) + prob._grid))
    pts = (torch.tensor([4, 2], dtype=torch.int32),
           torch.tensor([5, 9], dtype=torch.int32))
    inj = torch.tensor(rng.uniform(-1.0, 1.0, (4, 2)))
    w = torch.tensor(rng.uniform(-1.0, 1.0, 4))
    src = (5, 6)
    got = kv.varcoef_adjoint_multistep(un, uc, lam, lp, planes, wbar.clone(),
                                       w, inj, src, coef, pts)
    a, b, wb, wav = un, uc, wbar.clone(), []
    for s in range(4):
        wav.append(coef * lam[src])
        up, lc, lp, wb = kv.varcoef_adjoint_step(a, b, lam, lp, planes, wb,
                                                 coef)
        up[src] += coef * w[s]
        lam = lc.index_put((pts[0].long(), pts[1].long()), inj[s],
                           accumulate=True)
        a, b = b, up
    for g, want in zip(got, (a, b, lam, lp, wb, torch.stack(wav))):
        torch.testing.assert_close(g, want, rtol=1e-13, atol=1e-14)


def test_pinned_nodes_come_out_zero():
    prob, coef, planes, rng = _setup(7)
    u, up, lam, lp = _fields(rng, prob._grid, 4)
    pinned = tk.pinned_mask(prob._grid, "cpu")
    outs = (kv.varcoef_leapfrog_step(u, up, planes, coef),
            *kv.varcoef_adjoint_step(u, up, lam, lp, planes,
                                     torch.zeros((7,) + prob._grid,
                                                 dtype=torch.float64),
                                     coef)[:3])
    for o in outs:
        assert torch.all(o[pinned] == 0.0)


def test_wrapper_checks():
    prob, coef, planes, rng = _setup(8)
    u, up = _fields(rng, prob._grid, 2)
    w = torch.zeros(3, dtype=torch.float64)
    with pytest.raises(ValueError, match="planes"):
        kv.varcoef_leapfrog_step(u, up, planes[:6].contiguous(), coef)
    with pytest.raises(ValueError, match="source"):
        kv.varcoef_leapfrog_multistep(u, up, planes, w, (99, 1), coef,
                                      prob._receivers)
    with pytest.raises(ValueError, match="device or dtype"):
        kv.varcoef_leapfrog_step(u, up.float(), planes, coef)
    with pytest.raises(ValueError, match="int32"):
        kv.varcoef_adjoint_multistep(
            u, up, u, up, planes, torch.zeros_like(planes), w,
            torch.zeros(3, 1, dtype=torch.float64), (1, 1), coef,
            (torch.tensor([1]), torch.tensor([1])))


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


NEL_CUDA = (88, 80)              # 89 x 81 vertex grid: several tiles


def _bound(dtype, scale, n=1):
    """f64: 1e-12 relative. f32: 22 rounded terms per point on each side,
    propagated over n steps of a stable recurrence (<= n^2 / 2 growth)."""
    if dtype == torch.float64:
        return 1e-12 * scale
    return 22 * max(1.0, n * n / 2) * float(torch.finfo(dtype).eps) * scale


def _card_setup(dev, dtype, sponge, interp=False, seed=11):
    kw = (dict(sponge_width=0.15, sponge_strength=25.0, boundary_save="ring")
          if sponge else {})
    # receivers at tile edges (columns / rows 32 and 64 of the grid)
    recs = [(32 / 88, 0.5), (0.5, 32 / 80), (64.5 / 88, 31.5 / 80)]
    prob = FwiProblem(NEL_CUDA, ((0.0, 0.0), (1.0, 1.0)), 2e-3, 8,
                      source=(0.5, 0.5), receivers=recs, dtype=dtype,
                      device=dev, interp_receivers=interp, **kw)
    rng = np.random.default_rng(seed)
    planes = prob._stacked_planes(torch.tensor(
        1.0 + 0.3 * rng.random(prob.n_cells), dtype=dtype, device=dev))
    return prob, prob.dt ** 2 / prob._det_j, planes, rng


def _close_card(got, want, dtype, n=1):
    scale = max(1.0, float(want.abs().max()))
    err = float((got.double() - want.double()).abs().max())
    assert err <= _bound(dtype, scale, n), err


def _on(dev, dtype, rng, shape, n):
    return [torch.tensor(rng.uniform(-1.0, 1.0, shape), dtype=dtype,
                         device=dev) for _ in range(n)]


# B14 runs a thread per node in 32 x 8 blocks: NEL_CUDA's grid with a real
# problem's planes (and sponge), and random planes on grids that cut the
# last block column and row mid-way, one of them over 2^21 nodes;
# ``alias``: u_prev is u, as in the half start
@pytest.mark.cuda
@pytest.mark.parametrize("damped", [False, True])
@pytest.mark.parametrize("dtype, shape, alias", [
    (torch.float32, None, False), (torch.float64, None, False),
    (torch.float32, None, True), (torch.float32, (3, 3), False),
    (torch.float64, (3, 3), True), (torch.float32, (67, 129), False),
    (torch.float64, (67, 129), False), (torch.float64, (130, 97), False),
    (torch.float32, (130, 97), True), (torch.float32, (1500, 1457), False),
    (torch.float64, (1500, 1457), False)])
def test_cuda_varcoef_step(cuda_device, dtype, shape, alias, damped):
    if shape is None:
        prob, coef, planes, rng = _card_setup(cuda_device, dtype, damped)
        shape = prob._grid
        damp = prob._kernel_damp[:2] if damped else None
    else:
        rng = np.random.default_rng(13)
        # coef sum|planes| < 0.4, as on a stable problem
        (planes,) = _on(cuda_device, dtype, rng, (7,) + shape, 1)
        planes = 1.0 + 0.3 * planes
        coef = 0.04
        damp = None
        if damped:
            dnum, dden = _on(cuda_device, dtype, rng, shape, 2)
            damp = (1.0 + 0.1 * dnum, 1.0 - 0.1 * dden.abs())
    u, up = _on(cuda_device, dtype, rng, shape, 2)
    if alias:
        up = u
    before = tk.LAUNCHES["varcoef_leapfrog_step"]
    got = kv.varcoef_leapfrog_step(u, up, planes, coef, damp)
    again = kv.varcoef_leapfrog_step(u, up, planes, coef, damp)
    torch.cuda.synchronize()
    # one launch a call, and a rerun on the same inputs is bitwise equal
    assert tk.LAUNCHES["varcoef_leapfrog_step"] == before + 2
    assert torch.equal(got, again)
    _close_card(got, kv.varcoef_leapfrog_step_reference(u, up, planes, coef,
                                                        damp), dtype)


@pytest.mark.parametrize("dtype, k, tile", [
    (torch.float32, 1, 56), (torch.float32, 4, 50), (torch.float32, 8, 42),
    (torch.float64, 1, 44), (torch.float64, 4, 38), (torch.float64, 8, 30)])
def test_multistep_tile_is_the_slab_less_its_halo(dtype, k, tile):
    assert kv.multistep_tile(k, dtype) == tile
    for bad in (0, kv.MAX_FUSED_STEPS + 1):
        with pytest.raises(ValueError, match="one launch fuses"):
            kv.multistep_tile(bad, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k, damped, interp", [
    (1, False, False), (3, False, True), (8, False, False),
    (8, True, True), (12, False, True), (20, True, False)])
def test_cuda_varcoef_multistep(cuda_device, dtype, k, damped, interp):
    prob, coef, planes, rng = _card_setup(cuda_device, dtype, damped,
                                          interp)
    u, up = _on(cuda_device, dtype, rng, prob._grid, 2)
    w = torch.tensor(rng.uniform(-1.0, 1.0, k), dtype=dtype,
                     device=cuda_device)
    ms = prob._planes9_forward(planes) if damped else planes
    ring = prob._ring if damped else None
    # k > 8 runs in several launches: the source sits on the first one's
    # tiles
    tile = kv.multistep_tile(kv.fused_chunks(k)[0], dtype)
    src = (tile - 1, tile)        # one row above / one column right of a tile
    before = tk.LAUNCHES["varcoef_leapfrog_multistep"]
    got = kv.varcoef_leapfrog_multistep(u, up, ms, w, src, coef,
                                        prob._receivers, ring)
    again = kv.varcoef_leapfrog_multistep(u, up, ms, w, src, coef,
                                          prob._receivers, ring)
    torch.cuda.synchronize()
    assert (tk.LAUNCHES["varcoef_leapfrog_multistep"] - before
            == 2 * len(kv.fused_chunks(k)))
    want = kv.varcoef_leapfrog_multistep_reference(u, up, ms, w, src, coef,
                                                   prob._receivers, ring)
    for g, a, wt in zip(got, again, want):
        assert torch.equal(g, a)
        _close_card(g, wt, dtype, k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("damped", [False, True])
@pytest.mark.parametrize("where", ["corner", "pinned"])
def test_cuda_varcoef_multistep_points(cuda_device, dtype, damped, where):
    """The source on a tile corner or on the pinned row 0; receivers
    (nearest-vertex and three-point) on tile corners, on row 0 and on the
    last corner; 8 steps."""
    k = 8
    prob, coef, planes, rng = _card_setup(cuda_device, dtype, damped)
    rows, cols = prob._grid
    u, up = _on(cuda_device, dtype, rng, prob._grid, 2)
    (w,) = _on(cuda_device, dtype, rng, (k,), 1)
    ms = prob._planes9_forward(planes) if damped else planes
    tile = kv.multistep_tile(k, dtype)
    src = (tile, tile) if where == "corner" else (0, tile)
    i32 = dict(dtype=torch.int32, device=cuda_device)
    for per, pr, pc in (
            (1, [tile, tile - 1, 0, rows - 1], [tile, tile - 1, 5, cols - 1]),
            (3, [tile, tile, tile - 1, 0, 1, 0],
             [tile - 1, tile, tile - 1, 3, 3, 4])):
        (wt,) = _on(cuda_device, dtype, rng, (len(pr),), 1)
        rec = kv.Receivers(torch.tensor(pr, **i32), torch.tensor(pc, **i32),
                           wt, per)
        ring = prob._ring if damped else None
        got = kv.varcoef_leapfrog_multistep(u, up, ms, w, src, coef, rec,
                                            ring)
        again = kv.varcoef_leapfrog_multistep(u, up, ms, w, src, coef, rec,
                                              ring)
        torch.cuda.synchronize()
        want = kv.varcoef_leapfrog_multistep_reference(u, up, ms, w, src,
                                                       coef, rec, ring)
        for g, a, wnt in zip(got, again, want):
            assert torch.equal(g, a)
            _close_card(g, wnt, dtype, k)


# B16 marches strips of 32 columns over bands of rows: NEL_CUDA's grid
# with a real problem's planes, and random planes on grids that cut the
# last strip and the last band mid-way, one of them over 2^21 nodes
@pytest.mark.cuda
@pytest.mark.parametrize("dtype, shape", [
    (torch.float32, None), (torch.float64, None),
    (torch.float32, (3, 3)), (torch.float32, (67, 129)),
    (torch.float64, (67, 129)), (torch.float64, (130, 97)),
    (torch.float32, (1500, 1457))])
def test_cuda_varcoef_adjoint_step(cuda_device, dtype, shape):
    if shape is None:
        prob, coef, planes, rng = _card_setup(cuda_device, dtype, False)
        shape = prob._grid
    else:
        rng = np.random.default_rng(12)
        # coef sum|planes| < 0.4, as on a stable problem
        (planes,) = _on(cuda_device, dtype, rng, (7,) + shape, 1)
        planes = 1.0 + 0.3 * planes
        coef = 0.04
    un, uc, lam, lp = _on(cuda_device, dtype, rng, shape, 4)
    (wbar,) = _on(cuda_device, dtype, rng, (7,) + shape, 1)
    w_in = wbar.clone()
    before = tk.LAUNCHES["varcoef_adjoint_step"]
    got = kv.varcoef_adjoint_step(un, uc, lam, lp, planes, w_in, coef)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["varcoef_adjoint_step"] == before + 1
    # wbar is updated in place and returned
    assert got[3] is w_in
    want = kv.varcoef_adjoint_step_reference(un, uc, lam, lp, planes,
                                             wbar.clone(), coef)
    for g, wt in zip(got, want):
        _close_card(g, wt, dtype)
    # a rerun on the same inputs is bitwise equal
    again = kv.varcoef_adjoint_step(un, uc, lam, lp, planes, wbar.clone(),
                                    coef)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype, k, tile", [
    (torch.float32, 1, 46), (torch.float32, 8, 32), (torch.float32, 20, 8),
    (torch.float64, 1, 30), (torch.float64, 8, 16), (torch.float64, 12, 8)])
def test_adjoint_tile_is_the_slab_less_its_halo(dtype, k, tile):
    for n_planes in (7, 9):
        assert kv.adjoint_tile(k, n_planes, dtype, 232448) == tile
    with pytest.raises(ValueError, match="tile"):
        kv.adjoint_tile(k + 1 if tile == 8 else 40, 7, dtype, 232448)
    with pytest.raises(ValueError, match="shared memory"):
        kv.adjoint_tile(k, 7, dtype, 1024)


@pytest.mark.parametrize("k", [1, 2, 7, 8, 9, 12, 16, 17, 20, 24, 31, 40,
                               64])
def test_adjoint_chunks_split_evenly(k):
    """fused_chunks, the split of a pass into B15 and B17 launches."""
    chunks = kv.fused_chunks(k)
    assert sum(chunks) == k
    assert len(chunks) == -(-k // 8)
    assert max(chunks) <= 8 and max(chunks) - min(chunks) <= 1
    # the smallest B15 tile of a pass is the one of its largest launch
    assert kv.multistep_tile(max(chunks), torch.float64) >= 30


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k, damped", [(1, False), (3, False), (8, False),
                                       (8, True), (12, False), (20, True)])
def test_cuda_varcoef_adjoint_multistep(cuda_device, dtype, k, damped):
    prob, coef, planes, rng = _card_setup(cuda_device, dtype, damped)
    rows, cols = prob._grid
    un, uc, lam, lp = _on(cuda_device, dtype, rng, prob._grid, 4)
    (wbar,) = _on(cuda_device, dtype, rng, (7,) + prob._grid, 1)
    ms = prob._planes9_adjoint(planes) if damped else planes
    # k > 8 runs in several launches: the points sit on the first one's tiles
    tile = kv.adjoint_tile(kv.fused_chunks(k)[0], ms.shape[0], dtype,
                           tk._max_smem(tk._lib(), "t", cuda_device))
    src = (tile, tile - 1)      # first row / last column of two tiles
    i32 = dict(dtype=torch.int32, device=cuda_device)
    # receivers: twice on a tile's first row, on a tile corner, on a tile's
    # first column, and on pinned nodes (row 0 and the last corner: lam'
    # keeps the cotangent there, the next step's blam masks it)
    pts = (torch.tensor([tile, tile, tile - 1, 40, 0, rows - 1], **i32),
           torch.tensor([3, 3, min(2 * tile, cols - 1), tile, 5, cols - 1],
                        **i32))
    (inj,) = _on(cuda_device, dtype, rng, (k, 6), 1)
    (w,) = _on(cuda_device, dtype, rng, (k,), 1)
    ring, rs = None, (None, None)
    if damped:
        ring = prob._ring
        rs = tuple(_on(cuda_device, dtype, rng, s, 1)[0]
                   for s in ((k, 2, cols), (k, rows, 2)))
    args = (un, uc, lam, lp, ms)
    tail = (w, inj, src, coef, pts, ring, *rs)
    before = tk.LAUNCHES["varcoef_adjoint_multistep"]
    got = kv.varcoef_adjoint_multistep(*args, wbar.clone(), *tail)
    again = kv.varcoef_adjoint_multistep(*args, wbar.clone(), *tail)
    torch.cuda.synchronize()
    assert (tk.LAUNCHES["varcoef_adjoint_multistep"] - before
            == 2 * len(kv.fused_chunks(k)))
    want = kv.varcoef_adjoint_multistep_reference(*args, wbar.clone(), *tail)
    for g, a, wt in zip(got, again, want):
        assert torch.equal(g, a)
        _close_card(g, wt, dtype, k)
