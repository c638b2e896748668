"""The port's sharded fast engines against tpuwave's, on CPU ranks.

The rank program (tests/torch_shard_ranks.py, 'engines') runs
``make_fast_solver(..., sharding=)`` over 2 and 4 gloo ranks, row slabs
and (4 ranks) 2 x 2 blocks, on the driven and forced problem of
tests/test_fast_engine.py; tpuwave runs one sharded engine a
configuration here on the conftest's virtual devices, f64:

* --precond mg, Newmark 1/4 and theta 1/2 at Nel 32, 3 steps: relative L2
  of u within 1e-13, per-step iterations_1 equal, energy within 1e-12, as
  tests/test_fast_engine.py:470-501 holds tpuwave's own sharded engine;
* --solver 2term (Newmark 1/4, mg) and --solver cheby (theta 1) once each
  over 2 and 4 row slabs, against tpuwave's sharded engines: u within
  1e-12 relative, per-step counts equal;
* a sharded rerun is bitwise equal on every rank (the twin of
  tests/test_determinism.py:38).
"""

import numpy as np
import pytest

from tests import torch_threads  # noqa: F401  (one torch thread)
from tests import torch_shard_ranks as ranks

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shard_engines")
    procs = {n: ranks.launch(n, ["engines", tmp / f"r{n}.npz"])
             for n in WORLDS}
    yield {n: (lambda n=n: _load(procs[n], tmp / f"r{n}.npz"))
           for n in WORLDS}
    for p in procs.values():
        if p.poll() is None:
            p.kill()


def _load(proc, path):
    if not hasattr(proc, "result"):
        ranks.finish(proc)
        with np.load(path) as data:
            proc.result = {k: data[k] for k in data.files}
    return proc.result


def _tpuwave_run(fam, over, n, **kw):
    """tpuwave's engine over ``n`` virtual devices (row slabs): final u,
    per-step iterations, energy."""
    import jax.numpy as jnp
    from tpuwave.models.fast_engine import make_fast_solver
    from tpuwave.parallel.sharding import device_mesh, grid_sharding
    from tpuwave.utils.params import load_params
    p = load_params(ranks.standing_case(**over))
    eng = make_fast_solver(p, fam, sharding=grid_sharding(device_mesh(n)),
                           **kw)
    st, its, t = eng.initial_state(), [], 0.0
    while t < p.t_final - 1e-12:
        t += p.dt
        st, info = eng.step(st, t)
        its.append((int(info["iterations_1"]), int(info["iterations_2"])))
    v = eng.state_velocity(st, t) if hasattr(eng, "state_velocity") \
        else st.v
    return (np.asarray(jnp.asarray(st.u)), np.asarray(its),
            float(eng.disc.energy(st.u, v)))


@pytest.fixture(scope="module")
def tw_mg():
    return {fam: _tpuwave_run(fam, dict(ranks.ENGINE_MG_OVER, **over), 4,
                              precond="mg")
            for fam, over in ranks.ENGINE_MG}


@pytest.mark.parametrize("n", WORLDS)
def test_engine_mg_matches_tpuwave(port, tw_mg, n):
    got = port[n]()
    grids = ["rows"] + (["blocks"] if n == 4 else [])
    for fam, _ in ranks.ENGINE_MG:
        u, its, energy = tw_mg[fam]
        for g in grids:
            key = f"mg {g} {fam}"
            gu = got[f"{key} u"]
            assert np.linalg.norm(gu - u) <= 1e-13 * np.linalg.norm(u), key
            assert got[f"{key} its"][:, 0].tolist() == its[:, 0].tolist()
            assert abs(float(got[f"{key} energy"]) - energy) \
                <= 1e-12 * abs(energy), key


def test_engine_2term_and_cheby_match_tpuwave(port):
    for fam, over, kw in ranks.ENGINE_OTHER:
        u, its, _ = _tpuwave_run(fam, dict(ranks.ENGINE_OTHER_OVER, **over),
                                 2, **kw)
        for n in WORLDS:
            got = port[n]()
            key = f"{kw['solver']} {fam}"
            gu = got[f"{key} u"]
            assert np.linalg.norm(gu - u) <= 1e-12 * np.linalg.norm(u), \
                (key, n)
            assert got[f"{key} its"].tolist() == its.tolist(), (key, n)


def test_sharded_rerun_is_bitwise_equal(port):
    for n in WORLDS:
        assert int(port[n]()["rerun equal ranks"]) == n
