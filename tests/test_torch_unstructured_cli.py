"""Both CLIs of the port on imported perturbed meshes against tpuwave's,
on the CPU in f64 (``check_cli_against_tpuwave`` of test_torch_p2_cli.py:
the same files, CSVs within rtol 1e-9, iterations.csv bytes and console
step lines; each tpuwave run compiles its parity step once, 3-10 s):

* theta 1/2 ``--precond chebyshev`` at R = 2;
* Newmark 1/4 jacobi at R = 1 with a time-dependent C and ``Save
  Solution``: the u, v, u_exact, points and cells of every VTU piece (the
  imported triangulation) within 1e-12;
* ``--precond mg`` raises tpuwave's ValueError, ``--engine fast`` exits 1
  with tpuwave's message, ``--unstructured-sharding dofs`` exits 1 with
  the one-line ROADMAP A11 refusal.
"""

import importlib

import numpy as np
import pytest

from tests import torch_threads  # noqa: F401  (one torch thread)
from tests.test_torch_p2_cli import check_cli_against_tpuwave, cli_case
from tests.test_torch_p2_varcoef_theta import read_vtu
from tests.test_torch_unstructured import perturbed_points
from tpuwave_torch.core.unstructured import write_msh

TDEP_C = {"Time Dependent C": "true",
          "C": {"Function expression": "sqrt(1 + 0.5*sin(2*t) + 0.3*x*y)",
                "Variable names": "x, y, t"}}


def _mesh_over(tmp_path, nel, seed, **over):
    pts, cells = perturbed_points(nel, seed=seed)
    msh = write_msh(tmp_path / f"p{nel}.msh", pts, cells)
    return {"Mesh File Name": str(msh), "T": "0.03", **over}


@pytest.mark.parametrize("family,flags,over", [
    ("theta", ("--precond", "chebyshev"),
     {"R": "2", "Theta": "0.5", "Save Solution": "false"}),
    ("newmark", (), {"R": "1", "Save Solution": "true", **TDEP_C}),
], ids=["theta-r2-chebyshev", "newmark-r1-tdep-vtu"])
def test_unstructured_cli_reproduces_tpuwave(tmp_path, capsys, family, flags,
                                             over):
    over = _mesh_over(tmp_path, 6, seed=11, **over)
    check_cli_against_tpuwave(tmp_path, capsys, family, "standing-mode-wsol",
                              flags, over)
    rj, rt = tmp_path / "jax" / "res", tmp_path / "torch" / "res"
    pieces = sorted(p.relative_to(rj) for p in rj.rglob("*.vtu"))
    assert len(pieces) == (4 if over.get("Save Solution") == "true" else 0)
    for rel in pieces:
        vj, vt = read_vtu(rj / rel), read_vtu(rt / rel)
        for name in ("u", "v", "u_exact", "Points", "connectivity"):
            want = vj[name].astype(np.float64)
            got = vt[name].astype(np.float64)
            assert got.shape == want.shape, (rel, name)
            err = np.abs(got - want).max()
            assert err <= 1e-12 * max(1.0, np.abs(want).max()), \
                (rel, name, err)
    assert not (tmp_path / "torch" / "mesh").exists()


@pytest.mark.parametrize("what", ["mg", "engine fast", "sharding"])
def test_unstructured_cli_refusals(tmp_path, capsys, what):
    import json
    case = cli_case("standing-mode-wsol", R="1",
                    **_mesh_over(tmp_path, 5, seed=3))
    path = tmp_path / "case.json"
    path.write_text(json.dumps(case))
    flags = {"mg": ["--precond", "mg"], "engine fast": ["--engine", "fast"],
             "sharding": ["--unstructured-sharding", "dofs"]}[what]
    argv = [str(path), "--results-root", str(tmp_path / "r"),
            "--mesh-root", str(tmp_path / "m"), *flags]
    tcli = importlib.import_module("tpuwave_torch.cli.newmark")
    jcli = importlib.import_module("tpuwave.cli.newmark")
    if what == "mg":
        with pytest.raises(ValueError) as want:
            jcli.main(argv)
        with pytest.raises(ValueError) as got:
            tcli.main(argv + ["--device", "cpu"])
        assert str(got.value) == str(want.value) == \
            "mg preconditioner needs the structured mesh"
        return
    capsys.readouterr()
    rc = tcli.main(argv + ["--device", "cpu"])
    err = capsys.readouterr().err.strip().splitlines()
    assert rc == 1
    if what == "sharding":
        assert err == ["--unstructured-sharding dofs is not ported yet "
                       "(ROADMAP A11(b))"]
        return
    assert jcli.main(argv) == 1
    assert capsys.readouterr().err.strip().splitlines() == err
    assert err[0].endswith("mesh is not a generated structured rectangle")
    assert not (tmp_path / "r").exists()
