"""The port's domain decomposition against tpuwave's, on CPU ranks.

The port's ranks are processes over gloo (tests/torch_shard_ranks.py,
started once per world size, 2 and 4, while tpuwave runs here on the
conftest's virtual devices through ``device_mesh(2|4)``), f64:

* parallel/halo.py, the one-step exchange and k = 4, 8 (kernel B2's plain
  version on the padded slab, and the torch-ops engine at k = 4) against
  tpuwave's halo.py (its XLA engine, and at k = 4 over 2 shards its Pallas
  engine in interpret mode): within 1e-12 of max |u|;
* FastWaveSolver over 17 row slabs (uneven over 2 and 4) and over 2 x 2
  blocks: explicit, implicit Newmark CG and theta CG against tpuwave's
  sharded runs (tests/test_fast.py's tolerances: explicit rtol 1e-11 /
  atol 1e-12, implicit rtol 1e-9 / atol 1e-11), the CG counts equal to
  the port's one-rank run's, the energy within 1e-12; the sharded
  leapfrog (B2 on slabs, B3 on blocks) against tpuwave's (unsharded:
  its sharded leapfrog takes only row counts that divide);
* the sharded V-cycle on a partition whose coarse levels leave a rank
  fewer than 2 rows (agglomerated) against the whole-grid cycle, within
  1e-14 of max |z|;
* B3's plain version at global offsets on a padded block equals the
  whole-grid apply on the block's interior (here; on the card:
  tests/test_torch_kernels.py::test_cuda_constrained_apply_at_offsets).
"""

import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (one torch thread)
from tests import torch_shard_ranks as ranks

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The rank program's 'solvers' results per world size."""
    tmp = tmp_path_factory.mktemp("shard_solvers")
    procs = {n: ranks.launch(n, ["solvers", tmp / f"r{n}.npz"])
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


def _jax_u0(jnp):
    def u0(x, y):
        return jnp.sin(jnp.pi * x) * jnp.sin(jnp.pi * y)
    return u0


def _tw_mesh(n, shape=None):
    from tpuwave.parallel.sharding import device_mesh
    return device_mesh(n, shape=shape)


@pytest.mark.parametrize("n", WORLDS)
def test_halo_matches_tpuwave(port, n):
    import jax
    import jax.numpy as jnp
    from tpuwave.models.fast import FastWaveSolver
    from tpuwave.parallel.halo import (make_halo_leapfrog_step,
                                       make_multistep_halo_leapfrog)
    fs = FastWaveSolver(ranks.HALO_NEL, ranks.UNIT, ranks.HALO_DT,
                        dtype=jnp.float64)
    st0 = fs.initial_leapfrog_state(_jax_u0(jnp))
    mesh = _tw_mesh(n)
    want = {}
    engines = [("xla", 1), ("xla", 4), ("xla", 8)]
    if n == 2:
        engines.append(("pallas", 4))
    for eng, k in engines:
        if k == 1:
            adv, sh = make_halo_leapfrog_step(mesh, fs)
        else:
            adv, sh = make_multistep_halo_leapfrog(
                mesh, fs, k, engine=eng, block_rows=8,
                interpret=eng == "pallas")
        st = type(st0)(jax.device_put(st0.u, sh),
                       jax.device_put(st0.u_prev, sh))
        for _ in range(ranks.HALO_STEPS // k):
            st = adv(st)
        want[(eng, k)] = (np.asarray(st.u), np.asarray(st.u_prev))
    got = port[n]()
    scale = float(np.abs(want[("xla", 1)][0]).max())
    for k in ranks.HALO_KS:
        refs = [v for (e, kk), v in want.items() if kk == k]
        for ref in refs:
            for i, tag in ((0, ""), (1, " prev")):
                err = float(np.abs(got[f"halo {k}{tag}"] - ref[i]).max())
                assert err <= 1e-12 * scale, (k, tag, err)


@pytest.mark.parametrize("n", WORLDS)
def test_fast_solver_matches_tpuwave(port, n):
    import jax.numpy as jnp
    from tpuwave.models.fast import FastWaveSolver
    from tpuwave.parallel.sharding import grid_sharding
    from tpuwave_torch.models.fast import FastWaveSolver as TFast
    got = port[n]()
    grids = [("rows", None)] + ([("blocks", (2, 2))] if n == 4 else [])
    for gname, shape in grids:
        sh = grid_sharding(_tw_mesh(n, shape))
        for name, (kw, dt, steps) in ranks.FAST_CASES.items():
            s = FastWaveSolver(ranks.FAST_NEL, ranks.UNIT, dt,
                               dtype=jnp.float64, sharding=sh, **kw)
            want = np.asarray(s.run_scan(
                s.initial_state(_jax_u0(jnp)), steps).u)
            tol = (dict(rtol=1e-11, atol=1e-12) if name == "explicit"
                   else dict(rtol=1e-9, atol=1e-11))
            key = f"fast {gname} {name}"
            np.testing.assert_allclose(got[f"{key} u"], want, **tol)
            # CG counts and energy: the port's one-rank run
            one = TFast(ranks.FAST_NEL, ranks.UNIT, dt, dtype=torch.float64,
                        device="cpu", **kw)
            st1 = one.run_scan(one.initial_state(ranks._u0(torch)), steps)
            assert got[f"{key} its"].tolist() == \
                np.asarray(one.last_iterations).tolist(), key
            e1 = float(one.energy(st1))
            assert abs(float(got[f"{key} energy"]) - e1) <= 1e-12 * abs(e1)
        # (tpuwave's sharded leapfrog takes only row counts that divide:
        # its unsharded run)
        s = FastWaveSolver(ranks.FAST_NEL, ranks.UNIT, 0.005,
                           dtype=jnp.float64)
        want = np.asarray(s.run_leapfrog_scan(
            s.initial_leapfrog_state(_jax_u0(jnp)), 10).u)
        np.testing.assert_allclose(got[f"fast {gname} leapfrog u"], want,
                                   rtol=1e-11, atol=1e-12)


@pytest.mark.parametrize("n", WORLDS)
def test_vcycle_agglomerates_thin_levels(port, n):
    from tpuwave_torch.solve.multigrid import (GmgPreconditioner,
                                               gmg_for_system)
    got = port[n]()
    gmg = gmg_for_system((32, 32), ranks.UNIT, 1.0, 0.25 * 0.05 ** 2)
    plain = GmgPreconditioner(gmg.levels, gmg.coarse_theta,
                              gmg.coarse_coeffs)
    want = plain(torch.tensor(got["vcycle b"])).numpy()
    # the thin partition agglomerates below the fine level (2 ranks: the
    # third level; 4 ranks: the second)
    assert int(got["vcycle levels"]) == 3
    assert int(got["vcycle sharded levels"]) == {2: 2, 4: 1}[n]
    scale = float(np.abs(want).max())
    assert float(np.abs(got["vcycle z"] - want).max()) <= 1e-14 * scale


@pytest.mark.parametrize("diff", [False, True])
def test_constrained_apply_offsets_match_the_whole_grid(diff):
    from tpuwave_torch.ops import kernels as tk
    x = torch.tensor(np.random.default_rng(4).uniform(-1, 1, (29, 33)))
    st = ((-0.11, -0.23, -0.07), (-0.19, 1.31, -0.17), (-0.05, -0.29, -0.13))
    whole = tk.constrained_stencil_apply(x, st, 1.7, diff)
    for r0, r1, c0, c1 in ((0, 10, 0, 33), (10, 21, 5, 19), (21, 29, 19, 33)):
        pad = torch.nn.functional.pad(x, (1, 1, 1, 1))[r0:r1 + 2,
                                                       c0:c1 + 2].contiguous()
        got = tk.constrained_stencil_apply(
            pad, st, 1.7, diff, row_offset=r0 - 1, col_offset=c0 - 1,
            n_rows=29, n_cols=33)
        assert torch.equal(got[1:-1, 1:-1], whole[r0:r1, c0:c1])
        mask = tk.pinned_mask((r1 - r0, c1 - c0), "cpu", row_offset=r0,
                              col_offset=c0, n_rows=29, n_cols=33)
        assert torch.equal(mask, tk.pinned_mask((29, 33), "cpu")[r0:r1,
                                                                  c0:c1])
