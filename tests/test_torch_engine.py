"""The port's product engines and CLIs against tpuwave's, on the CPU.

* FastNewmarkSolver (beta 0 and 1/4) and FastThetaSolver (theta 0, 1/2, 1)
  on a driven and forced problem (Dirichlet g(t), forcing f(x, y, t)):
  the consistent a0 and 5 steps give identical CG iteration counts and
  states within rtol 1e-10 (the CG stopping tolerance is 1e-6 relative;
  the two sides differ only in summation order, ~1e-16 per operation).
* Both CLIs, in-process, on two presets shrunk to Nel 16, T 0.1: equal
  exit codes, the same file set, CSVs equal within rtol 1e-10 (the
  convergence.csv wall-clock column aside) and identical iterations.csv.
* Flags whose paths are not ported exit 1 with a one-line message (the
  solver flags only together with a problem that is not ported; --shard
  at R = 2 or with a varying or time-dependent C).
* The run-surface flags through both CLIs at Nel 4: --checkpoint-every
  writes the same checkpoint files, --resume from the same checkpoint ends
  in the same rows, --profile-dir leaves the CSVs as they are and writes a
  trace.
"""

import contextlib
import csv
import io
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (one torch thread)
from tpuwave.models import fast_engine as jfe
from tpuwave.utils.params import load_params as jload
from tpuwave_torch.models import convert
from tpuwave_torch.models import fast_engine as tfe
from tpuwave_torch.utils.params import load_params as tload

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def _driven_case(**over):
    case = {
        "Nel": "16,12", "T": "0.05", "Dt": "0.01",
        "C": {"Function expression": "1.0"},
        "F": {"Function expression": "sin(3*pi*x)*cos(2*pi*y)*cos(5*t)",
              "Variable names": "x, y, t"},
        "U0": {"Function expression": "sin(pi*x)*sin(pi*y)",
               "Variable names": "x, y"},
        "V0": {"Function expression": "0.0"},
        "G": {"Function expression": "0.1*sin(2*t)*(1+x*y)",
              "Variable names": "x, y, t"},
        "DGDT": {"Function expression": "0.2*cos(2*t)*(1+x*y)",
                 "Variable names": "x, y, t"},
    }
    case.update(over)
    return case


def _close(got, want, rtol=1e-10):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("family,over", [
    ("newmark", {"Beta": "0.0"}),
    ("newmark", {"Beta": "0.25"}),
    ("theta", {"Theta": "0.0"}),
    ("theta", {"Theta": "0.5"}),
    ("theta", {"Theta": "1.0"}),
])
def test_engine_matches_tpuwave_step_for_step(family, over):
    case = _driven_case(**over)
    js = jfe.make_fast_solver(jload(case), family)
    ts = tfe.make_fast_solver(tload(case), family, dtype=torch.float64,
                              device=CPU)
    sj, st = js.initial_state(), ts.initial_state()
    if family == "newmark":
        assert ts.initial_iterations == js.initial_iterations
    for name in ("u", "v", "a"):
        _close(convert.to_numpy(st)[name], getattr(sj, name))
    t = 0.0
    for _ in range(5):
        t += case_dt(case)
        sj, ij = js.step(sj, t)
        st, it = ts.step(st, t)
        assert it["iterations_1"] == int(ij["iterations_1"])
        assert it["iterations_2"] == int(ij["iterations_2"])
        _close(float(it["norm_u"]), float(ij["norm_u"]))
        got = convert.to_numpy(st)
        for name in ("u", "v", "a"):
            _close(got[name], getattr(sj, name))
    # stepping from tpuwave's numbers lands on tpuwave's next state
    st_j = convert.to_torch(sj, CPU, torch.float64)
    sj2, _ = js.step(sj, t + case_dt(case))
    st2, _ = ts.step(st_j, t + case_dt(case))
    _close(convert.to_numpy(st2)["u"], sj2.u)


def case_dt(case):
    return float(case["Dt"])


def test_engine_diagnostics_equal_tpuwave():
    case = _driven_case(**{"Beta": "0.25", "Solution": {
        "Function expression": "cos(sqrt(2)*pi*t)*sin(pi*x)*sin(pi*y)",
        "Variable names": "x, y, t"}})
    js = jfe.make_fast_solver(jload(case), "newmark")
    ts = tfe.make_fast_solver(tload(case), "newmark", dtype=torch.float64,
                              device=CPU)
    sj = js.initial_state()
    st = convert.to_torch(sj, CPU, torch.float64)
    dj, dt_ = js.disc, ts.disc
    _close(float(dt_.energy(st.u, st.v)), float(dj.energy(sj.u, sj.v)),
           rtol=1e-13)
    _close(float(dt_.probe(st.u)), float(dj.probe(sj.u)), rtol=1e-13)
    for a, b in zip(dt_.errors(st.u, 0.02), dj.errors(sj.u, 0.02)):
        _close(float(a), float(b), rtol=1e-12)
    _close(dt_.interpolate(tload(case).u0).numpy(),
           dj.interpolate(jload(case).u0), rtol=1e-14)


def test_engine_refuses_unported_configurations():
    varc = _driven_case(C={"Function expression": "1 + 0.5*x",
                           "Variable names": "x, y, t"})
    tdep = _driven_case(**{"Time Dependent C": "true",
                           "C": {"Function expression": "1 + 0.1*t",
                                 "Variable names": "x, y, t"}})
    # at R = 1 varying and time-dependent C are ported; refused, as in
    # tpuwave, are --solver cheby with a varying C and --solver 2term with
    # a time-dependent one
    with pytest.raises(ValueError, match="constant wave speed"):
        tfe.make_fast_solver(tload(varc), "newmark", solver="cheby",
                             dtype=torch.float64, device=CPU)
    with pytest.raises(ValueError, match="time-static wave speed"):
        tfe.make_fast_solver(tload(tdep), "theta", solver="2term",
                             dtype=torch.float64, device=CPU)
    # and so at R = 2, where varying and time-dependent C are ported too
    with pytest.raises(ValueError, match="constant wave speed"):
        tfe.make_fast_solver(tload(dict(varc, R="2")), "newmark",
                             solver="cheby", dtype=torch.float64,
                             device=CPU)
    with pytest.raises(ValueError, match="time-static wave speed"):
        tfe.make_fast_solver(tload(dict(tdep, R="2")), "theta",
                             precond="mg", solver="2term",
                             dtype=torch.float64, device=CPU)


# ---------------------------------------------------------------------------
# the two CLIs end to end
# ---------------------------------------------------------------------------
def _write_case(tmp_path, preset, **over):
    case = json.loads((ROOT / "parameters" / f"{preset}.json").read_text())
    case.update({"Nel": "16", "T": "0.1", "Save Solution": "true"})
    case.update(over)
    path = tmp_path / f"{preset}.json"
    path.write_text(json.dumps(case))
    return path


def _files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


def _rows(path):
    with open(path) as fh:
        return list(csv.reader(fh))


def _csv_close(a, b, skip_cols=()):
    ra, rb = _rows(a), _rows(b)
    assert len(ra) == len(rb) and ra[0] == rb[0], a.name
    for x, y in zip(ra[1:], rb[1:]):
        assert len(x) == len(y)
        for k, (u, v) in enumerate(zip(x, y)):
            if k in skip_cols or u == v:
                continue
            fu, fv = float(u), float(v)
            assert abs(fu - fv) <= 1e-10 * max(abs(fu), abs(fv)), \
                (a.name, k, u, v)


@pytest.mark.parametrize("family,preset,over", [
    ("newmark", "standing-mode-wsol", {}),
    ("newmark", "oscillating-boundary", {}),
    ("theta", "standing-mode-wsol", {}),
    ("theta", "oscillating-boundary", {}),
    # no VTU output: the runner's chunked branch, diagnostics per step
    ("newmark", "oscillating-boundary",
     {"Save Solution": "false", "Log Every": "1"}),
    # chunked branch ending at log points
    ("theta", "standing-mode-wsol",
     {"Save Solution": "false", "Log Every": "3", "Theta": "0.5"}),
])
def test_cli_reproduces_tpuwave(tmp_path, capsys, family, preset, over):
    import importlib
    jcli = importlib.import_module(f"tpuwave.cli.{family}")
    tcli = importlib.import_module(f"tpuwave_torch.cli.{family}")
    path = _write_case(tmp_path, preset, **over)

    def args(tag):
        return [str(path), "--results-root", str(tmp_path / tag / "res"),
                "--mesh-root", str(tmp_path / tag / "mesh")]

    rc_j = jcli.main(args("jax"))
    out_j = capsys.readouterr().out
    rc_t = tcli.main(args("torch") + ["--device", "cpu"])
    out_t = capsys.readouterr().out
    assert rc_j == rc_t == 0
    rj, rt = tmp_path / "jax" / "res", tmp_path / "torch" / "res"
    assert _files(rj) == _files(rt)
    n_csv = 0
    for rel in _files(rj):
        if not rel.endswith(".csv"):
            continue
        n_csv += 1
        if rel.endswith("iterations.csv"):
            assert (rj / rel).read_text() == (rt / rel).read_text()
        else:
            skip = (12,) if rel.endswith("convergence.csv") else ()
            _csv_close(rj / rel, rt / rel, skip)
    assert n_csv >= 2
    # console: the same step lines and iteration totals
    pick = ("Step ", "Simulation completed", "Total CG", "  Relative",
            "Output folder")

    def lines(out, root):
        return [ln.replace(str(root), "ROOT") for ln in out.splitlines()
                if ln.startswith(pick)]
    assert lines(out_t, tmp_path / "torch") == lines(out_j, tmp_path / "jax")


@pytest.mark.parametrize("flag,item", [
    (["--unstructured-sharding", "cells"], "A11(b)"),
    (["--unstructured-sharding", "dofs"], "A11(b)"),
    (["--unstructured-sharding", "dofs2d"], "A11(b)"),
])
def test_cli_refuses_unported_flags(tmp_path, capsys, flag, item):
    from tpuwave_torch.cli import theta
    path = _write_case(tmp_path, "standing-mode-wsol")
    rc = theta.main([str(path), "--device", "cpu", "--results-root",
                     str(tmp_path / "r"), "--mesh-root",
                     str(tmp_path / "m")] + flag)
    err = capsys.readouterr().err.strip().splitlines()
    assert rc == 1
    assert len(err) == 1 and f"ROADMAP {item}" in err[0]
    assert not (tmp_path / "r").exists()


@pytest.mark.parametrize("shard,over", [
    ("rows", {"R": "2"}),
    ("rows", {"C": {"Function expression": "1.0 + 0.5*x",
                    "Variable names": "x, y, t"}}),
    ("blocks", {"Time Dependent C": "true",
                "C": {"Function expression": "1.0 + 0.1*t",
                      "Variable names": "x, y, t"}}),
])
def test_cli_refuses_unported_sharding(tmp_path, capsys, shard, over):
    """--shard on a problem whose sharded engine is not ported (R = 2, a
    varying or a time-dependent C) exits 1 with one line naming A11(b),
    before any output."""
    from tpuwave_torch.cli import newmark
    path = _write_case(tmp_path, "standing-mode-wsol", **over)
    rc = newmark.main([str(path), "--device", "cpu", "--results-root",
                       str(tmp_path / "r"), "--mesh-root",
                       str(tmp_path / "m"), "--shard", shard])
    err = capsys.readouterr().err.strip().splitlines()
    assert rc == 1
    assert len(err) == 1 and "ROADMAP A11(b)" in err[0]
    assert not (tmp_path / "r").exists()


def _surface_run(cli, path, root, *flags):
    """One theta CLI run of the run-surface case into ``root``; its run
    folder."""
    extra = ["--device", "cpu"] if cli.__name__.startswith("tpuwave_torch") \
        else []
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main([str(path), "--results-root", str(root / "res"),
                       "--mesh-root", str(root / "mesh"), "--quiet", *flags,
                       *extra])
    assert rc == 0, out.getvalue()[-2000:]
    return next((root / "res").glob("*/run-*"))


@pytest.fixture(scope="module")
def surface(tmp_path_factory):
    """tpuwave's theta CLI run of the run-surface case (the fast engine, Nel
    4, 5 steps, Log Every 1) with ``--checkpoint-every 2 --profile-dir``,
    shared by the three cases below: (case file, its run folder, its trace
    folder)."""
    from tpuwave.cli import theta as jcli
    tmp = tmp_path_factory.mktemp("surface")
    path = _write_case(tmp, "standing-mode-wsol", Nel="4", T="0.05",
                       Dt="0.01", **{"Save Solution": "false",
                                     "Log Every": "1"})
    run = _surface_run(jcli, path, tmp / "j", "--checkpoint-every", "2",
                       "--profile-dir", str(tmp / "j" / "trace"))
    return path, run, tmp / "j" / "trace"


@pytest.mark.parametrize("flag", ["--checkpoint-every", "--resume",
                                  "--profile-dir"])
def test_cli_run_surface_flags_match_tpuwave(tmp_path, surface, flag):
    """Each flag through the port's theta CLI and tpuwave's (one tpuwave
    run with --checkpoint-every 2 --profile-dir, shared):
    --checkpoint-every 2 writes the same checkpoint files (steps 2 and 4:
    names, steps, times, fields within rtol 1e-10); --resume from
    tpuwave's checkpoint of step 4, copied into a fresh run folder of each
    package, ends in the same step-5 rows; with --profile-dir the port's
    CSVs equal tpuwave's (rtol 1e-10) and each package writes its trace
    (the port's a Chrome trace)."""
    from tpuwave.cli import theta as jcli
    from tpuwave_torch.cli import theta as tcli
    path, jd, jtrace = surface

    if flag == "--checkpoint-every":
        td = _surface_run(tcli, path, tmp_path / "t", flag, "2")
        names = sorted(q.name for q in jd.glob("checkpoint_*"))
        assert names == ["checkpoint_000002.npz", "checkpoint_000004.npz"]
        assert names == sorted(q.name for q in td.glob("checkpoint_*"))
        for name in names:
            with np.load(jd / name) as a, np.load(td / name) as b:
                assert sorted(a.files) == sorted(b.files)
                for k in ("__timestep", "__time"):
                    assert a[k] == b[k]
                for k in a.files:
                    _close(b[k], a[k])
    elif flag == "--resume":
        rows = {}
        for tag, cli in (("j", jcli), ("t", tcli)):
            fresh = tmp_path / tag / "res" / jd.parent.name / jd.name
            fresh.mkdir(parents=True)
            shutil.copy(jd / "checkpoint_000004.npz", fresh)
            assert _surface_run(cli, path, tmp_path / tag, flag) == fresh
            rows[tag] = {name: _rows(fresh / name) for name in
                         ("energy.csv", "error.csv", "probe.csv",
                          "iterations.csv")}
        for name, jrows in rows["j"].items():
            trows = rows["t"][name]
            assert len(jrows) == len(trows) == 2 and jrows[1][0] == "5"
            assert trows[0] == _rows(jd / name)[0]
            for u, v in zip(jrows[1], trows[1]):
                assert u == v or abs(float(u) - float(v)) <= \
                    1e-10 * abs(float(u)), (name, u, v)
    else:
        td = _surface_run(tcli, path, tmp_path / "t", flag,
                          str(tmp_path / "trace"))
        csvs = sorted(q.name for q in td.glob("*.csv"))
        assert csvs == sorted(q.name for q in jd.glob("*.csv"))
        assert len(csvs) == 4
        for name in csvs:
            _csv_close(jd / name, td / name)
        trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
        assert trace["traceEvents"]
        assert any(q.is_file() for q in jtrace.rglob("*"))


_C_CASES = {"C=x": {"C": {"Function expression": "1 + 0.5*x",
                          "Variable names": "x, y, t"}},
            "C=t": {"Time Dependent C": "true",
                    "C": {"Function expression": "1 + 0.1*t",
                          "Variable names": "x, y, t"}}}


@pytest.mark.parametrize("flags,cmode", [
    (["--precond", "chebyshev"], "C=x"),
    (["--precond", "mg"], "C=t"),
    (["--precond", "auto"], "C=x"),
    ([], "C=t"),
])
def test_cli_r2_runs_varying_c(tmp_path, capsys, flags, cmode):
    """The R = 2 CLI with a varying or time-dependent C and these flags
    runs (Nel 4, 2 steps) and writes its CSVs; test_torch_p2_varcoef_*.py
    hold such runs against tpuwave."""
    from tpuwave_torch.cli import theta
    path = _write_case(tmp_path, "standing-mode-wsol", Nel="4", R="2",
                       T="0.02", Dt="0.01", **{"Save Solution": "false",
                                               "Log Every": "1"},
                       **_C_CASES[cmode])
    rc = theta.main([str(path), "--device", "cpu", "--results-root",
                     str(tmp_path / "r"), "--mesh-root",
                     str(tmp_path / "m")] + flags)
    capsys.readouterr()
    assert rc == 0
    names = {q.name for q in (tmp_path / "r").rglob("*.csv")}
    assert {"energy.csv", "error.csv", "probe.csv",
            "iterations.csv"} <= names
    its = (tmp_path / "r").rglob("iterations.csv")
    assert len(next(its).read_text().splitlines()) == 3


def test_cli_cuda_without_card_exits_1(tmp_path, capsys):
    from tpuwave_torch.cli import newmark
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path = _write_case(tmp_path, "standing-mode-wsol")
    assert newmark.main([str(path), "--results-root",
                         str(tmp_path / "r")]) == 1
    assert "cuda" in capsys.readouterr().err


def test_import_tpuwave_torch_leaves_jax_out():
    code = ("import sys, tpuwave_torch, tpuwave_torch.cli.newmark, "
            "tpuwave_torch.cli.theta, tpuwave_torch.models.convert, "
            "tpuwave_torch.ops.kernels, tpuwave_torch.ops.kernels_p2, "
            "tpuwave_torch.models.fast_engine_p2, "
            "tpuwave_torch.models.fast_engine_p2_2term, tpuwave_torch.api, "
            "tpuwave_torch.models.theta, tpuwave_torch.models.newmark, "
            "tpuwave_torch.core.unstructured, tpuwave_torch.models.general, "
            "tpuwave_torch.harness, tpuwave_torch.utils.checkpoint; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'tpuwave')))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "[]", \
        proc.stdout + proc.stderr
