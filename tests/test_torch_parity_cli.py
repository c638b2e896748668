"""The port's parity engine through its entry points, on the CPU in f64.

* Both CLIs with ``--engine parity`` against tpuwave's
  (``check_cli_against_tpuwave`` of test_torch_p2_cli.py: the same files,
  CSVs within rtol 1e-9, iterations.csv bytes and console step lines):
  theta 1/2 on a driven preset with a varying C and VTU output (the
  per-step loop), and Newmark 1/4 ``--precond mg`` at Nel 16 (the fine
  level on the kernel cycle) with diagnostics every step (the chunked
  loop over ``run_steps_diag``), both at R = 1. R = 2 runs in the next
  case and in test_torch_parity_engine.py (tpuwave compiles an R = 2
  step in ~10 s).
* ``--engine auto`` at Nel 1 falls back to the parity engine, as
  tpuwave's does (R = 2: theta runs 1 + 1 CG iterations a step).
* ``api.solve(engine="parity")`` agrees with ``engine="auto"`` (the fast
  engine) on CG totals and errors, with diagnostics every step (the
  runner's chunked loop over ``run_steps_diag``), and ``api.build_solver`` routes a
  parity-only keyword (``lumped_explicit``) to the parity engine.
* ``FastWaveSolver.energy`` equals tpuwave's.
* Refusals: an empty ``Mesh File Name`` file (tpuwave's reader raises
  its ValueError; the port prints its text on one line and exits 1) and
  ``--solver 2term`` on the parity engine (tpuwave's text).
"""

import importlib
import json

import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (one torch thread)
from tests.test_torch_p2_cli import check_cli_against_tpuwave, cli_case

CPU = torch.device("cpu")
VARYING_C = {"C": {"Function expression": "1 + 0.5*x + 0.25*y*y",
                   "Variable names": "x, y, t"}}


@pytest.mark.parametrize("family,preset,flags,over", [
    ("theta", "oscillating-boundary", ("--engine", "parity"),
     {"R": "1", "Theta": "0.5", "T": "0.05", "Save Solution": "true",
      **VARYING_C}),
    ("newmark", "standing-mode-wsol",
     ("--engine", "parity", "--precond", "mg"),
     {"R": "1", "Nel": "16", "T": "0.05"}),
])
def test_parity_cli_reproduces_tpuwave(tmp_path, capsys, family, preset,
                                       flags, over):
    check_cli_against_tpuwave(tmp_path, capsys, family, preset, flags, over)


def test_auto_falls_back_to_parity_at_nel_1(tmp_path, capsys):
    check_cli_against_tpuwave(tmp_path, capsys, "theta",
                              "standing-mode-wsol", (),
                              {"Nel": "1", "Theta": "0.5", "T": "0.03"})
    rows = next((tmp_path / "torch" / "res").rglob(
        "iterations.csv")).read_text().splitlines()[1:]
    assert len(rows) == 3 and all(ln.endswith(",1,1") for ln in rows)


def test_api_solve_parity(tmp_path):
    from tpuwave_torch import api
    from tpuwave_torch.models.newmark import NewmarkSolver
    from tpuwave_torch.models.runner import RunConfig
    from tpuwave_torch.utils.params import load_params
    case = cli_case("standing-mode-wsol", R="1", T="0.05")
    runs = {engine: api.solve(case, "newmark", engine=engine, device=CPU,
                              config=RunConfig(
                                  results_root=str(tmp_path / engine),
                                  quiet=True, write_mesh=False))
            for engine in ("parity", "auto")}
    par, fast = runs["parity"], runs["auto"]
    assert par.total_iterations_1 == fast.total_iterations_1
    assert par.rel_l2 == pytest.approx(fast.rel_l2, rel=1e-9)
    assert par.rel_h1 == pytest.approx(fast.rel_h1, rel=1e-9)
    energy = [next((tmp_path / e).rglob("energy.csv")).read_text()
              for e in runs]
    assert energy[0] == energy[1] and len(energy[0].splitlines()) == 6
    s = api.build_solver(load_params(dict(case, Beta="0.0")), "newmark",
                         device=CPU, lumped_explicit=True)
    assert isinstance(s, NewmarkSolver) and s.lumped_explicit


def test_fast_solver_energy_matches_tpuwave():
    import jax.numpy as jnp
    from tpuwave.models.fast import FastState as JState
    from tpuwave.models.fast import FastWaveSolver as JFast
    from tpuwave_torch.models.fast import FastState, FastWaveSolver
    geom = ((0.0, 0.0), (1.0, 0.8))
    rng = np.random.default_rng(5)
    u, v = rng.standard_normal((2, 7, 9))
    js = JFast((8, 6), geom, 1e-2, c=1.3, dtype=jnp.float64)
    ts = FastWaveSolver((8, 6), geom, 1e-2, c=1.3, dtype=torch.float64,
                        device=CPU)
    want = float(js.energy(JState(u=jnp.asarray(u), v=jnp.asarray(v),
                                  a=jnp.zeros_like(u))))
    got = ts.energy(FastState(u=torch.as_tensor(u), v=torch.as_tensor(v),
                              a=torch.zeros(7, 9, dtype=torch.float64)))
    assert got.dim() == 0 and got.dtype == torch.float64
    assert float(got) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("what", ["mesh file", "2term"])
def test_parity_refusals(tmp_path, capsys, what):
    from tpuwave_torch.cli import newmark
    case = cli_case("standing-mode-wsol", R="1")
    flags = []
    if what == "mesh file":
        mesh_file = tmp_path / "rectangle.msh"
        mesh_file.write_text("")
        case["Mesh File Name"] = str(mesh_file)
    else:
        flags = ["--engine", "parity", "--solver", "2term"]
    path = tmp_path / "case.json"
    path.write_text(json.dumps(case))
    argv = [str(path), "--results-root", str(tmp_path / "r"),
            "--mesh-root", str(tmp_path / "m")] + flags
    capsys.readouterr()
    rc = newmark.main(argv + ["--device", "cpu"])
    err = capsys.readouterr().err.strip().splitlines()
    assert rc == 1 and len(err) == 1
    jcli = importlib.import_module("tpuwave.cli.newmark")
    if what == "mesh file":
        with pytest.raises(ValueError) as want:
            jcli.main(argv)
        assert err == [str(want.value)]
        assert err[0].startswith("Unrecognised mesh format in ")
    else:
        assert jcli.main(argv) == 1
        assert capsys.readouterr().err.strip().splitlines() == err
    assert not (tmp_path / "r").exists()
