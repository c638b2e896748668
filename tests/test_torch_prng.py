"""tpuwave's start vector without jax (tpuwave_torch/utils/prng.py) and the
power iteration it seeds (solve/chebyshev.py::estimate_lambda_max),
against jax 0.9 and tpuwave on the CPU.

* the threefry2x32 words equal ``jax.random.bits`` bit for bit (32-bit:
  ``hi ^ lo``; 64-bit: ``hi << 32 | lo``);
* ``threefry_normal`` against ``jax.random.normal(PRNGKey(seed), (n,))``
  at n in {1000, 4097}, seeds 0 and 7: f64 within 1e-14 and f32 within
  1e-6 absolute (the uniforms are bitwise equal; the port evaluates XLA's
  erfinv polynomials in torch ops, and torch's log1p differs from XLA's
  in the last bits: measured 3.3e-15 / 4.8e-7, two f32 ulps at |z| ~ 4;
  ``torch.special.erfinv`` would differ by 1.1e-5 in f32);
* ``estimate_lambda_max`` against tpuwave's at rtol 1e-10 (f64) on a P1
  constrained stencil operator and on a P2 canvas operator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (one torch thread)
from tpuwave_torch.utils.prng import threefry_bits, threefry_normal

CPU = torch.device("cpu")
GEOM = ((0.0, 0.0), (1.0, 1.3))


@pytest.mark.parametrize("seed", [0, 7, 2 ** 40 + 3])
def test_threefry_words_equal_jax_random_bits(seed):
    key = jax.random.PRNGKey(seed)
    hi, lo = (w.numpy().astype(np.uint64) for w in threefry_bits(
        seed, 0, 4097, CPU))
    b32 = np.asarray(jax.random.bits(key, (4097,), jnp.uint32))
    np.testing.assert_array_equal((hi ^ lo).astype(np.uint32), b32)
    b64 = np.asarray(jax.random.bits(key, (4097,), jnp.uint64))
    np.testing.assert_array_equal((hi << np.uint64(32)) | lo, b64)


@pytest.mark.parametrize("n", [1000, 4097])
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("dtype,atol", [("float64", 1e-14),
                                        ("float32", 1e-6)])
def test_threefry_normal_matches_jax(n, seed, dtype, atol):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (n,),
                                        getattr(jnp, dtype)))
    got = threefry_normal(seed, n, getattr(torch, dtype), CPU)
    assert got.dtype == getattr(torch, dtype) and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


def test_threefry_normal_chunks_and_refuses():
    """A draw longer than one chunk continues jax's sequence across the
    chunk boundary; bad seeds and dtypes raise."""
    from tpuwave_torch.utils import prng
    n = prng._CHUNK + 5
    got = threefry_normal(3, n, torch.float32, CPU)[-10:]
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (n,),
                                        jnp.float32))[-10:]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="seed"):
        threefry_normal(-1, 4)
    with pytest.raises(TypeError, match="dtype"):
        threefry_normal(0, 4, torch.float16)


def test_lambda_max_matches_tpuwave_on_a_p1_stencil():
    from tpuwave.models.fast import FastWaveSolver as JFast
    from tpuwave.solve import chebyshev as jch
    from tpuwave_torch.models.fast import FastWaveSolver as TFast
    from tpuwave_torch.ops import kernels as tk
    from tpuwave_torch.solve import chebyshev as tch
    kw = dict(beta=0.25, lumped=False)
    js = JFast((30, 22), GEOM, 0.05, dtype=jnp.float64, **kw)
    ts = TFast((30, 22), GEOM, 0.05, dtype=torch.float64, device=CPU, **kw)
    st = ts.system.stencil
    diag = st[1][1]
    shape = ts.shape
    interior_j = js.interior

    def apply_j(v):
        w = v.reshape(shape)
        return jnp.where(interior_j, js.system(jnp.where(interior_j, w, 0.0)),
                         diag * w).reshape(-1)

    def apply_t(v):
        return tk.constrained_stencil_apply(v.reshape(shape), st,
                                            diag).reshape(-1)
    n = shape[0] * shape[1]
    lam_j = jch.estimate_lambda_max(apply_j, jnp.full(n, 1.0 / diag), n)
    lam_t = tch.estimate_lambda_max(
        apply_t, torch.full((n,), 1.0 / diag, dtype=torch.float64), n)
    assert abs(lam_t - lam_j) <= 1e-10 * lam_j


def test_lambda_max_matches_tpuwave_on_a_p2_canvas_operator():
    from tpuwave.core.mesh import FeSpace as JSpace
    from tpuwave.core.mesh import StructuredTriMesh as JMesh
    from tpuwave.core.quadrature import gauss_simplex as jquad
    from tpuwave.ops.assembly import element_mass_class as jm
    from tpuwave.ops.assembly import element_stiffness_class as jk
    from tpuwave.ops.stencil_p2 import P2PlaneStencil as JP2
    from tpuwave.solve import chebyshev as jch
    from tpuwave.solve import multigrid as jmg
    from tpuwave_torch.core.mesh import FeSpace, StructuredTriMesh
    from tpuwave_torch.core.quadrature import gauss_simplex
    from tpuwave_torch.ops import kernels_p2 as kp
    from tpuwave_torch.ops.assembly import (element_mass_class,
                                            element_stiffness_class)
    from tpuwave_torch.ops.stencil_p2 import P2PlaneStencil
    from tpuwave_torch.solve import chebyshev as tch
    nx, ny, coef = 14, 9, 0.25 * 0.1 ** 2
    cs = (ny + 3, nx + 3)
    jspace = JSpace(JMesh((nx, ny), GEOM), 2)
    jsys = JP2(jspace, jm(jspace, jquad(3)), jnp.float64).axpy(
        coef, JP2(jspace, jk(jspace, jquad(3), 1.0), jnp.float64))
    space = FeSpace(StructuredTriMesh((nx, ny), GEOM), 2)
    tsys = P2PlaneStencil(space, element_mass_class(space, gauss_simplex(3)),
                          torch.float64, CPU).axpy(
        coef, P2PlaneStencil(space, element_stiffness_class(
            space, gauss_simplex(3), 1.0), torch.float64, CPU))
    interior_j = jmg._p2_canvas_interior(nx, ny, cs)
    dg_j = jnp.asarray([jsys.plane_diag[q] for q in "VHWD"]).reshape(4, 1, 1)
    diags = tuple(float(tsys.plane_diag[q]) for q in "VHWD")
    n = 4 * cs[0] * cs[1]

    def apply_j(v):
        w = v.reshape(4, *cs)
        return jnp.where(interior_j, jsys.apply_canvases(
            jnp.where(interior_j, w, 0.0)), dg_j * w).reshape(-1)

    def apply_t(v):
        return kp.p2_constrained_apply(v.reshape(4, *cs), tsys.terms, diags,
                                       nx, ny, True).reshape(-1)
    inv_j = jnp.broadcast_to(1.0 / dg_j, (4, *cs)).reshape(-1)
    inv_t = torch.tensor(np.asarray(inv_j))
    lam_j = jch.estimate_lambda_max(apply_j, inv_j, n)
    lam_t = tch.estimate_lambda_max(apply_t, inv_t, n)
    assert abs(lam_t - lam_j) <= 1e-10 * lam_j
