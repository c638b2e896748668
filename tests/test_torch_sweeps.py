"""The port's sweep entry points (scripts/torch_*.py) against tpuwave's
(scripts/{convergence,dissipation_dispersion}_sweep.py), on the CPU, in
f64.

A two-run convergence plan and a one-run dissipation plan write the twin's
files (run log, merged / summary CSV, time-series folders) with equal rows
in every column but the wall-clock ones (numbers within rtol 1e-10);
``extract_metrics`` equals tpuwave's on one run folder; the scalability
sweep writes the twin's schema (binary ``tpuwave_torch-fast``) and a
profiler trace per scheme (its ranks: tests/test_torch_shard_cli.py); the
acceptance sweep runs a preset through both CLIs.
"""

import contextlib
import importlib.util
import json
import sys
from pathlib import Path

import pytest

from tests import torch_threads  # noqa: F401  (one torch thread)

ROOT = Path(__file__).resolve().parent.parent
BASE = str(ROOT / "parameters" / "standing-mode-wsol.json")


def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tpuwave_main(mod, argv, monkeypatch):
    """A tpuwave sweep script's main (it reads sys.argv)."""
    monkeypatch.setattr(sys, "argv", [mod.__name__] + argv)
    mod.main()


def _rows_close(a: Path, b: Path, skip=("elapsed_s", "elapsed_time_s")):
    ra = a.read_text().splitlines()
    rb = b.read_text().splitlines()
    assert len(ra) == len(rb) > 1 and ra[0] == rb[0], a.name
    head = ra[0].split(",")
    for x, y in zip(ra[1:], rb[1:]):
        for col, u, v in zip(head, x.split(","), y.split(",")):
            if u == v or col in skip:
                continue
            assert abs(float(u) - float(v)) <= 1e-10 * abs(float(u)), \
                (a.name, col, u, v)


def test_convergence_plan_matches_tpuwave(tmp_path, monkeypatch):
    argv = ["--nel", "4", "--r", "1", "--dt", "0.1", "0.05", "--T", "0.2",
            "--schemes", "theta-0.5", "--base-params", BASE,
            "--results-root", "res", "--job-id", ""]
    for tag in "jt":
        (tmp_path / tag).mkdir()
    with contextlib.chdir(tmp_path / "j"):
        _tpuwave_main(_script("convergence_sweep"), argv, monkeypatch)
    with contextlib.chdir(tmp_path / "t"):
        _script("torch_convergence_sweep").main(argv + ["--device", "cpu"])
    for name in ("convergence-runlog.csv", "convergence-results.csv"):
        _rows_close(tmp_path / "j" / name, tmp_path / "t" / name)
    assert len((tmp_path / "t" / "convergence-results.csv").read_text()
               .splitlines()) == 3


def test_dissipation_plan_and_metrics_match_tpuwave(tmp_path, monkeypatch):
    argv = ["--nel", "4", "--nel-explicit", "4", "--dt", "0.05", "--T",
            "0.2", "--schemes", "newmark-0.25", "--base-params", BASE,
            "--results-root", "res", "--job-id", ""]
    jmod = _script("dissipation_dispersion_sweep")
    tmod = _script("torch_dissipation_dispersion_sweep")
    for tag in "jt":
        (tmp_path / tag).mkdir()
    with contextlib.chdir(tmp_path / "j"):
        _tpuwave_main(jmod, argv, monkeypatch)
    with contextlib.chdir(tmp_path / "t"):
        tmod.main(argv + ["--device", "cpu"])
    for name in ("dissdisp-runlog.csv", "dissdisp-results.csv"):
        _rows_close(tmp_path / "j" / name, tmp_path / "t" / name)
    for series in ("energy", "error", "probe"):
        sub = f"dissdisp-{series}-series/newmark-0.25_dt0.05.csv"
        _rows_close(tmp_path / "j" / sub, tmp_path / "t" / sub)

    # extract_metrics (copied, not imported) on one run folder
    run_dir = next((tmp_path / "t" / "res").rglob("energy.csv")).parent
    assert tmod.extract_metrics(run_dir) == jmod.extract_metrics(run_dir)
    assert "energy_ratio" in tmod.extract_metrics(run_dir)


def test_scalability_sweep_writes_the_schema(tmp_path, capsys):
    with contextlib.chdir(tmp_path):
        rc = _script("torch_scalability_sweep").main(
            ["--nel", "8", "--dt", "0.01", "--T", "0.03", "--repeats", "2",
             "--dtype", "f64", "--schemes", "theta-0.5", "newmark-0.00",
             "--profile-dir", "prof", "--device", "cpu"])
    assert rc == 0
    rows = (tmp_path / "scalability-results-1.csv").read_text().splitlines()
    assert rows[0] == ("scheme,binary,nprocs,repeat,Nel,R,Dt,T,Theta,Beta,"
                       "Gamma,returncode,seconds")
    assert [r.split(",")[:4] for r in rows[1:]] == [
        [s, "tpuwave_torch-fast", "1", k] for s in ("theta-0.5",
                                                    "newmark-0.00")
        for k in "12"]
    for s in ("theta-0.5", "newmark-0.00"):
        events = json.loads((tmp_path / "prof" / f"{s}-p1" / "trace.json")
                            .read_text())["traceEvents"]
        assert events
    assert "DoF*steps/s" in capsys.readouterr().out


def test_acceptance_runs_a_preset_through_both_clis(tmp_path, capsys):
    out = tmp_path / "summary.csv"
    rc = _script("torch_acceptance").main(
        ["--presets", "gaussian-pulse", "--t-max", "0.01", "--device",
         "cpu", "--out", str(out)])
    capsys.readouterr()
    assert rc == 0
    rows = [r.split(",") for r in out.read_text().splitlines()]
    assert rows[0] == ["preset", "family", "T", "Dt", "status", "returncode",
                       "elapsed_s", "final_rel_L2", "final_rel_H1"]
    assert [(r[0], r[1], r[4]) for r in rows[1:]] == [
        ("gaussian-pulse", "theta", "OK"), ("gaussian-pulse", "newmark", "OK")]
