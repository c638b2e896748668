"""The port's sweep harness (tpuwave_torch/harness.py) and FWI inversion
checkpoints (FwiProblem.invert(checkpoint=)) against tpuwave's, on the
CPU, in f64.

The scheme table, the CFL filter and the run-folder names equal tpuwave's
over a grid of (scheme, Nel, R, dt); ``run_case`` gives the same return
code and a convergence row within rtol 1e-10 on an explicit and an
implicit scheme at Nel 4, and code -1 on both packages under a zero
wall-clock limit. An inversion resumed from a two-iteration checkpoint
equals the port's four-iteration run, and a tpuwave checkpoint (optax's
Adam state) resumed by the port matches tpuwave's four iterations within
test_torch_fwi.py's gradient tolerance.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (one torch thread)
from tests.test_torch_fwi import RTOL_GRAD, _close, _models, _port, _tpuwave
from tpuwave import harness as jh
from tpuwave_torch import harness as th

BASE = Path(__file__).resolve().parent.parent / "parameters" / \
    "standing-mode-wsol.json"
#: the convergence sweep's overrides at Nel 4 (4 steps)
SMALL = {"Nel": "4", "R": "1", "Dt": "0.05", "T": "0.2",
         "Save Solution": False, "Enable Logging": False, "Log Every": 0}


def test_harness_definitions_match_tpuwave():
    assert th.SCHEME_DEFS == jh.SCHEME_DEFS
    assert th.PARAM_STEM == jh.PARAM_STEM
    for scheme in jh.SCHEME_DEFS:
        for nel in (10, 20, 60, 320):
            for r in (1, 2):
                assert th.cfl_limit(nel, r) == jh.cfl_limit(nel, r)
                assert th.cfl_limit(nel, r, 2.0, 0.5) == \
                    jh.cfl_limit(nel, r, 2.0, 0.5)
                for dt in (0.1, 0.01, 0.005, 0.002, 0.0005, 1e-4, 5e-5):
                    assert th.is_cfl_safe(scheme, nel, r, dt) == \
                        jh.is_cfl_safe(scheme, nel, r, dt)
                    assert th.predict_run_folder(nel, r, dt, 1.0, scheme) \
                        == jh.predict_run_folder(nel, r, dt, 1.0, scheme)


def _conv_row(root: Path, scheme: str) -> list:
    family = jh.SCHEME_DEFS[scheme]["family"]
    path = root / f"{family}-{jh.PARAM_STEM}" / "convergence.csv"
    return path.read_text().splitlines()[-1].split(",")


@pytest.mark.parametrize("timeout_s", [None, 0.0])
def test_run_case_matches_tpuwave(tmp_path, timeout_s):
    """theta 0 (explicit) and Newmark 1/4 (implicit) at Nel 4; with a
    zero wall-clock limit both packages stop before the first step."""
    for scheme in ("theta-0.0", "newmark-0.25"):
        jcode, _, jres = jh.run_case(scheme, BASE, SMALL,
                                     results_root=str(tmp_path / "j"),
                                     timeout_s=timeout_s)
        tcode, _, tres = th.run_case(scheme, BASE, SMALL,
                                     results_root=str(tmp_path / "t"),
                                     timeout_s=timeout_s, device="cpu")
        if timeout_s == 0.0:
            assert jcode == tcode == -1
            assert jres.timed_out and tres.timed_out
            assert tres.timestep_number == jres.timestep_number == 0
            assert tres.rel_l2 is None
            assert not list((tmp_path / "t").rglob("convergence.csv"))
            continue
        assert jcode == tcode == 0 and not tres.timed_out
        assert tres.timestep_number == jres.timestep_number == 4
        jrow, trow = (_conv_row(tmp_path / d, scheme) for d in "jt")
        assert jrow[:10] == trow[:10]
        for a, b in zip(jrow[10:12], trow[10:12]):
            assert abs(float(a) - float(b)) <= 1e-10 * abs(float(a))


def test_run_case_needs_a_card_unless_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        th.run_case("theta-0.5", BASE, SMALL,
                    results_root=str(tmp_path / "t"))
    assert not (tmp_path / "t").exists()


def test_invert_checkpoint_resumes_across_packages(tmp_path):
    import jax.numpy as jnp
    from tpuwave.models import inverse
    jx = (None, jnp, inverse)
    p, q = _port(), _tpuwave(jx)
    c2t, c2i = _models(p.n_cells, seed=10)
    obs = np.asarray(q.simulate(jnp.asarray(c2t)))
    kw = dict(learning_rate=0.05, bounds=(0.9, 1.25), reg_lambda=1e-3)
    tobs, tc2i = torch.tensor(obs), torch.tensor(c2i)

    # the port alone: 2 iterations, then a resume to 4, equal 4 in one go
    whole = p.invert(tobs, tc2i, n_iter=4, **kw)
    ck = tmp_path / "t.npz"
    p.invert(tobs, tc2i, n_iter=2, checkpoint=str(ck), **kw)
    resumed = p.invert(tobs, tc2i, n_iter=4, checkpoint=str(ck), **kw)
    _close(resumed.misfits, whole.misfits, 1e-12)
    _close(resumed.c2, whole.c2, 1e-12)
    with pytest.raises(ValueError, match="does not match"):
        p.invert(tobs, tc2i, n_iter=5, checkpoint=str(ck),
                 estimate_wavelet=True, **kw)

    # tpuwave's 2-iteration checkpoint (optax Adam's leaves), resumed by
    # the port, against tpuwave's own resume to 4 iterations
    jck = tmp_path / "j.npz"
    q.invert(obs, jnp.asarray(c2i), n_iter=2, checkpoint=str(jck), **kw)
    shutil.copy(jck, tmp_path / "jt.npz")
    want = q.invert(obs, jnp.asarray(c2i), n_iter=4, checkpoint=str(jck),
                    **kw)
    got = p.invert(tobs, tc2i, n_iter=4, checkpoint=str(tmp_path / "jt.npz"),
                   **kw)
    _close(got.misfits, want.misfits, RTOL_GRAD)
    _close(got.c2, want.c2, RTOL_GRAD)
    _close(got.misfits, whole.misfits, RTOL_GRAD)
    # and the port's checkpoint has tpuwave's leaf layout
    with np.load(ck) as a, np.load(jck) as b:
        assert sorted(a.files) == sorted(b.files)
        assert a["o0"].dtype == b["o0"].dtype == np.int32
        for k in b.files:
            assert a[k].shape == b[k].shape, k
