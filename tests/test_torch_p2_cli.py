"""The port's two CLIs at R = 2 against tpuwave's, on the CPU in f64.

``python -m tpuwave_torch.cli.newmark|theta --device cpu`` on R = 2
parameter files at Nel 8 (in-process ``main``): exit code 0, the same
run folder and file set as ``tpuwave.cli``, energy.csv, error.csv and
probe.csv within rtol 1e-9 (the convergence.csv wall-clock column
aside), iterations.csv identical, the same console step lines. With
``--precond mg`` each package sizes its P2 smoother by its own power
iteration (the same start vector). Varying or time-dependent C at R = 2 still exits
1 with one line naming ROADMAP A5. The ``--solver 2term`` case is in
test_torch_p2_cli_2term.py (tpuwave's compile of it takes ~45 s).
"""

import csv
import importlib
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _write_case(tmp_path, preset, **over):
    case = json.loads((ROOT / "parameters" / f"{preset}.json").read_text())
    case.update({"Nel": "8", "R": "2", "T": "0.1", "Dt": "0.01",
                 "Log Every": "1"})
    case.update(over)
    path = tmp_path / f"{preset}.json"
    path.write_text(json.dumps(case))
    return path


def _files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


def _csv_close(a, b, skip_cols=()):
    ra, rb = list(csv.reader(a.open())), list(csv.reader(b.open()))
    assert len(ra) == len(rb) and ra[0] == rb[0], a.name
    for x, y in zip(ra[1:], rb[1:]):
        assert len(x) == len(y)
        for k, (u, v) in enumerate(zip(x, y)):
            if k in skip_cols or u == v:
                continue
            fu, fv = float(u), float(v)
            assert abs(fu - fv) <= 1e-9 * max(abs(fu), abs(fv)), \
                (a.name, k, u, v)


@pytest.mark.parametrize("family,preset,flags,over", [
    ("newmark", "standing-mode-wsol", (), {"Save Solution": "true"}),
    ("newmark", "standing-mode-wsol", ("--solver", "cheby"), {}),
    ("theta", "oscillating-boundary", ("--precond", "mg"),
     {"Log Every": "3"}),
    ("theta", "standing-mode-wsol", ("--precond", "chebyshev"), {}),
])
def test_cli_r2_reproduces_tpuwave(tmp_path, capsys, family, preset, flags,
                                   over):
    check_cli_against_tpuwave(tmp_path, capsys, family, preset, flags, over)


def check_cli_against_tpuwave(tmp_path, capsys, family, preset, flags,
                              over):
    """Both packages' CLI on the same R = 2 file: same exit code, files,
    CSVs (rtol 1e-9), iterations.csv bytes and console step lines."""
    jcli = importlib.import_module(f"tpuwave.cli.{family}")
    tcli = importlib.import_module(f"tpuwave_torch.cli.{family}")
    path = _write_case(tmp_path, preset, **over)

    def args(tag):
        return [str(path), "--results-root", str(tmp_path / tag / "res"),
                "--mesh-root", str(tmp_path / tag / "mesh"), *flags]

    rc_j = jcli.main(args("jax"))
    out_j = capsys.readouterr().out
    rc_t = tcli.main(args("torch") + ["--device", "cpu"])
    out_t = capsys.readouterr().out
    assert rc_j == rc_t == 0
    rj, rt = tmp_path / "jax" / "res", tmp_path / "torch" / "res"
    assert _files(rj) == _files(rt)
    seen = set()
    for rel in _files(rj):
        if not rel.endswith(".csv"):
            continue
        seen.add(Path(rel).name)
        if rel.endswith("iterations.csv"):
            assert (rj / rel).read_text() == (rt / rel).read_text()
        else:
            skip = (12,) if rel.endswith("convergence.csv") else ()
            _csv_close(rj / rel, rt / rel, skip)
    assert {"energy.csv", "probe.csv", "iterations.csv"} <= seen
    if preset == "standing-mode-wsol":
        assert "error.csv" in seen
    pick = ("Step ", "Simulation completed", "Total CG", "  Relative",
            "Output folder", "  Number of DoFs")

    def lines(out, root):
        return [ln.replace(str(root), "ROOT") for ln in out.splitlines()
                if ln.startswith(pick)]
    assert lines(out_t, tmp_path / "torch") == lines(out_j, tmp_path / "jax")


@pytest.mark.parametrize("which", ["C=x", "C=t"])
def test_cli_r2_still_refuses_varying_c(tmp_path, capsys, which):
    from tpuwave_torch.cli import newmark
    c = {"C=x": {"C": {"Function expression": "1 + 0.5*x",
                       "Variable names": "x, y, t"}},
         "C=t": {"Time Dependent C": "true",
                 "C": {"Function expression": "1 + 0.1*t",
                       "Variable names": "x, y, t"}}}[which]
    path = _write_case(tmp_path, "standing-mode-wsol", **c)
    rc = newmark.main([str(path), "--device", "cpu", "--results-root",
                       str(tmp_path / "r"), "--mesh-root",
                       str(tmp_path / "m")])
    err = capsys.readouterr().err.strip().splitlines()
    assert rc == 1
    assert len(err) == 1 and "ROADMAP A5" in err[0]
    assert not (tmp_path / "r").exists()
