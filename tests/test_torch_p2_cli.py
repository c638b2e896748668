"""The port's two CLIs at R = 2 against tpuwave's, on the CPU in f64.

``python -m tpuwave_torch.cli.newmark|theta --device cpu`` on R = 2
parameter files at Nel 8 (in-process ``main``): exit code 0, the same
run folder and file set as ``tpuwave.cli``, energy.csv, error.csv and
probe.csv within rtol 1e-9 (the convergence.csv wall-clock column
aside), iterations.csv identical, the same console step lines. With
``--precond mg`` each package sizes its P2 smoother by its own power
iteration (the same start vector). The ``--solver 2term`` case is in
test_torch_p2_cli_2term.py (tpuwave's compile of it takes ~45 s); the
runs with a varying or time-dependent C are in
test_torch_p2_varcoef_theta.py and test_torch_p2_varcoef_2term.py.
"""

import csv
import importlib
import json
from pathlib import Path

import pytest

from tests import torch_threads  # noqa: F401  (one torch thread)

ROOT = Path(__file__).resolve().parent.parent


def cli_case(preset, **over):
    """The parameter dict ``_write_case`` writes: ``preset`` at R = 2, Nel
    8, 10 steps, Log Every 1, then ``over``."""
    case = json.loads((ROOT / "parameters" / f"{preset}.json").read_text())
    case.update({"Nel": "8", "R": "2", "T": "0.1", "Dt": "0.01",
                 "Log Every": "1"})
    case.update(over)
    return case


def _write_case(tmp_path, preset, **over):
    path = tmp_path / f"{preset}.json"
    path.write_text(json.dumps(cli_case(preset, **over)))
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


def jit_velocity(engine):
    """``engine`` (a tpuwave engine) with its ``state_velocity`` under
    ``jax.jit``. tpuwave's 2-term engines reconstruct v through a
    ``lax.cond`` outside jit whose branches close over the state, so each
    call (the CLI makes two a log point) compiles anew; the same function
    under jit compiles once."""
    sv = getattr(engine, "state_velocity", None)
    if sv is not None and not hasattr(sv, "lower"):
        import jax
        engine.state_velocity = jax.jit(sv)
    return engine


def check_cli_against_tpuwave(tmp_path, capsys, family, preset, flags,
                              over, engine=None):
    """Both packages' CLI on the same R = 2 file: same exit code, files,
    CSVs (rtol 1e-9), iterations.csv bytes and console step lines.

    ``engine``: a tpuwave engine built from ``cli_case(preset, **over)``
    with the factory arguments the CLI passes for ``flags``; tpuwave's CLI
    then runs it in place of building its own (one XLA compile of the
    step instead of two). tpuwave's CLI runs its engine's
    ``state_velocity`` under ``jax.jit`` (``jit_velocity``)."""
    from tpuwave.models import fast_engine as jfe
    jcli = importlib.import_module(f"tpuwave.cli.{family}")
    tcli = importlib.import_module(f"tpuwave_torch.cli.{family}")
    path = _write_case(tmp_path, preset, **over)

    def args(tag):
        return [str(path), "--results-root", str(tmp_path / tag / "res"),
                "--mesh-root", str(tmp_path / tag / "mesh"), *flags]

    real = jfe.make_fast_solver

    def built(problem, fam, **kw):
        if engine is None:
            return jit_velocity(real(problem, fam, **kw))
        assert fam == family and problem.r == 2
        assert kw.get("precond") == engine.precond
        return jit_velocity(engine)
    jfe.make_fast_solver = built
    try:
        rc_j = jcli.main(args("jax"))
    finally:
        jfe.make_fast_solver = real
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
