"""The port's stencil kernels (tpuwave_torch/ops/kernels.py) against the
JAX Pallas kernels they replace (tpuwave/ops/pallas_kernels.py).

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

from tpuwave_torch.models.fast import FastWaveSolver
from tpuwave_torch.ops import kernels as tk

H, W = 41, 37
RTOL, ATOL = 1e-12, 1e-14


def _stencils():
    s = FastWaveSolver((W - 1, H - 1), ((0.0, 0.0), (1.0, 1.2)), 1e-3,
                       beta=0.0, dtype=torch.float64)
    return s.stiff.stencil, s.mass.stencil


STIFF, MASS = _stencils()
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
    # the H100's 227 KB opt-in limit: k = 32 fits in f32 at tile 64
    assert tk.multistep_tile(32, torch.float32, 232448) == 64
    assert tk.multistep_tile(32, torch.float64, 232448) == 32
    with pytest.raises(ValueError, match="shared memory"):
        tk.multistep_tile(200, torch.float32, 232448)


def test_cpu_tensors_never_count_launches():
    tk.reset_launches()
    (x,) = _fields(5, 1)
    tk.constrained_stencil_apply(_t(x), STIFF, 1.0)
    tk.leapfrog_step(_t(x), _t(x), STIFF, 0.1)
    tk.leapfrog_multistep(_t(x), _t(x), STIFF, 0.1, 2)
    assert all(v == 0 for v in tk.LAUNCHES.values())


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
def test_cuda_constrained_apply(cuda_device, dtype, diff):
    (x,) = _on(cuda_device, *_fields(6, 1), dtype=dtype)
    before = tk.LAUNCHES["constrained_stencil_apply"]
    got = tk.constrained_stencil_apply(x, RAND, 1.7, diff=diff)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["constrained_stencil_apply"] == before + 1
    want = tk.constrained_stencil_apply_reference(x, RAND, 1.7, diff)
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
@pytest.mark.parametrize("k,offset", [(1, None), (8, None), (32, None),
                                      (8, (5, 44)), (8, (-3, 60))])
def test_cuda_leapfrog_multistep(cuda_device, dtype, k, offset):
    u, up = _on(cuda_device, *_fields(8), dtype=dtype)
    ro, nr = offset if offset is not None else (0, None)
    got = tk.leapfrog_multistep(u, up, STIFF, 0.3, k, row_offset=ro,
                                n_rows=nr)
    torch.cuda.synchronize()
    want = tk.leapfrog_multistep_reference(u, up, STIFF, 0.3, k, ro, nr)
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= _bound(dtype, scale, k)
