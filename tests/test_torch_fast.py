"""The port's FastWaveSolver (explicit leapfrog path) against tpuwave's.

f64 on the CPU; states cross between the packages through
tpuwave_torch.models.convert so both step from the same numbers.
Tolerance rtol 1e-12 (roll-stencil summation orders agree; the kernel
runners sum coef * S(u) where tpuwave sums dt^2 * (S(u) / M_L), a
last-bit difference per step).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (one torch thread)
from tpuwave.models.fast import FastWaveSolver as JSolver
from tpuwave_torch.models import convert
from tpuwave_torch.models.fast import FastWaveSolver as TSolver
from tpuwave_torch.ops import kernels

NEL, GEOM, DT = (24, 20), ((0.0, 0.0), (1.0, 1.2)), 5e-3
RTOL = 1e-12


def _pair(**kw):
    j = JSolver(NEL, GEOM, DT, beta=0.0, dtype=jnp.float64, **kw)
    t = TSolver(NEL, GEOM, DT, beta=0.0, dtype=torch.float64, device="cpu",
                **kw)
    return j, t


def _u0_j(xs, ys):
    return jnp.sin(jnp.pi * xs) * jnp.sin(jnp.pi * ys / 1.2) + 0.3 * xs * ys


def _u0_t(xs, ys):
    return torch.sin(torch.pi * xs) * torch.sin(torch.pi * ys / 1.2) \
        + 0.3 * xs * ys


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().cpu().numpy(), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def test_operators_and_masks_equal_tpuwave():
    j, t = _pair(c=1.3)
    assert j.shape == t.shape
    for name in ("mass", "stiff", "system"):
        assert getattr(j, name).stencil == getattr(t, name).stencil, name
    np.testing.assert_array_equal(t.inv_lumped.numpy(),
                                  np.asarray(j.inv_lumped))
    np.testing.assert_array_equal(t.boundary.numpy(), np.asarray(j.boundary))
    np.testing.assert_array_equal(t.interior.numpy(), np.asarray(j.interior))
    for a, b in zip(t.grid_coords(), j.grid_coords()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert t.n_dofs == j.n_dofs


@pytest.mark.parametrize("kind", ["plain", "diff"])
def test_stencil_apply_equals_tpuwave(kind):
    from tpuwave.ops import stencil as js
    from tpuwave_torch.ops import stencil as ts
    j, _ = _pair()
    u = np.random.default_rng(0).standard_normal(j.shape)
    for st in (j.mass.stencil, j.stiff.stencil):
        fj = js.apply_stencil if kind == "plain" else js.apply_stencil_diff
        ft = ts.apply_stencil if kind == "plain" else ts.apply_stencil_diff
        _close(ft(torch.tensor(u), st), fj(jnp.asarray(u), st), rtol=1e-14)


def test_initial_leapfrog_state_equals_tpuwave():
    j, t = _pair()
    lj = j.initial_leapfrog_state(_u0_j)
    lt = t.initial_leapfrog_state(_u0_t)
    _close(lt.u, lj.u)
    _close(lt.u_prev, lj.u_prev)


@pytest.mark.parametrize("runner", ["scan", "kernel", "multistep"])
def test_twenty_steps_match_tpuwave_scan(runner):
    j, t = _pair()
    lj = j.initial_leapfrog_state(_u0_j)
    want = j.run_leapfrog_scan(lj, 20)
    start = convert.to_torch(lj, torch.device("cpu"), torch.float64)
    kernels.reset_launches()
    if runner == "scan":
        got = t.run_leapfrog_scan(start, 20)
    elif runner == "kernel":
        got = t.run_leapfrog_kernel(start, 20)
    else:
        got = t.run_leapfrog_multistep(start, 20, steps_per_call=4)
    # CPU tensors run the kernels' plain versions: nothing is launched
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    _close(got.u, want.u)
    _close(got.u_prev, want.u_prev)


def test_multistep_rejects_bad_counts():
    _, t = _pair()
    lt = t.initial_leapfrog_state(_u0_t)
    with pytest.raises(ValueError, match="multiple"):
        t.run_leapfrog_multistep(lt, 6, steps_per_call=4)


def test_forced_driven_start_and_grid_load_equal_tpuwave():
    j, t = _pair()

    def f_j(x, y, tt):
        return jnp.sin(3 * x) * jnp.cos(2 * y) * jnp.cos(5 * tt)

    def f_t(x, y, tt):
        return torch.sin(3 * x) * torch.cos(2 * y) * np.cos(5 * tt)

    def g_j(x, y, tt):
        return 0.1 * np.sin(2 * tt) * (1 + x * y)

    def g_t(x, y, tt):
        return 0.1 * np.sin(2 * tt) * (1 + x * y)

    _close(t.grid_load(f_t, 0.3), j.grid_load(f_j, 0.3), rtol=1e-14)
    lj = j.initial_leapfrog_state(_u0_j, f_fn=f_j, g_fn=g_j)
    lt = t.initial_leapfrog_state(_u0_t, f_fn=f_t, g_fn=g_t)
    _close(lt.u, lj.u)
    _close(lt.u_prev, lj.u_prev)


def test_explicit_newmark_step_equals_tpuwave():
    j, t = _pair()
    sj = j.initial_state(_u0_j)
    st = t.initial_state(_u0_t)
    for name in ("u", "v", "a"):
        _close(getattr(st, name), getattr(sj, name))
    for _ in range(5):
        sj, st = j.step(sj), t.step(st)
    for name in ("u", "v", "a"):
        _close(getattr(st, name), getattr(sj, name))


@pytest.mark.parametrize("f32", [False, True])
def test_solve_abs_tol_equals_tpuwave(f32):
    jd, td = (jnp.float32, torch.float32) if f32 else (jnp.float64,
                                                      torch.float64)
    j = JSolver(NEL, GEOM, DT, beta=0.25, lumped=False, dtype=jd)
    t = TSolver(NEL, GEOM, DT, beta=0.25, lumped=False, dtype=td,
                device="cpu")
    rng = np.random.default_rng(3)
    rhs, x0 = rng.standard_normal((2,) + j.shape)
    want = j._solve_abs_tol(jnp.asarray(rhs, jd), jnp.asarray(x0, jd),
                            j.system)
    got = t._solve_abs_tol(torch.tensor(rhs, dtype=td),
                           torch.tensor(x0, dtype=td), t.system)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_convert_round_trip():
    j, _ = _pair()
    sj = j.initial_state(_u0_j)
    st = convert.to_torch(sj, torch.device("cpu"), torch.float32)
    assert type(st).__name__ == "FastState" and st.u.dtype == torch.float32
    back = convert.to_numpy(convert.to_torch(sj, "cpu", torch.float64))
    for name in ("u", "v", "a"):
        np.testing.assert_array_equal(back[name], np.asarray(getattr(sj,
                                                                     name)))
    lf = convert.to_torch([np.zeros((2, 2)), np.ones((2, 2))], "cpu",
                          torch.float64, kind="LeapfrogState")
    assert float(lf.u_prev.sum()) == 4.0
    with pytest.raises(TypeError):
        convert.to_torch(object(), "cpu", torch.float64)
