"""The port's implicit solver family against tpuwave's, on the CPU in f64.

* 3-term engines with ``precond`` = mg / chebyshev / auto and
  ``solver="cheby"``, and the 2-term engines (theta and Newmark) with mg
  and chebyshev, on the driven and forced case of
  tests/test_solver_modes.py ("base", "be", "unforced", "homog") at Nel
  16x12 for 6 steps: identical per-step iteration counts, u (and the
  reconstructed v of the 2-term engines) within rtol 1e-10. The stopping
  tests are the same on both sides; the states differ only in summation
  order (~1e-16 per operation), well inside the 1e-6 CG reduction.
* Without forcing the port's 2-term step is tpuwave's fused one (B5 +
  ring lift, B4 Chebyshev blocks): held against tpuwave's Pallas path in
  interpret mode for 3 steps, at a size its block layout takes.
* The rejections (time-dependent C; Newmark beta = 0) and the device
  default (the card, raising where there is none).
* Both CLIs end to end on two presets at Nel 16 with --solver 2term
  --precond mg, --precond auto and --solver cheby: equal exit codes, the
  same file set, CSVs within rtol 1e-10 and identical iterations.csv.
"""

import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (one torch thread)
from tpuwave.models import fast_engine as jfe
from tpuwave.utils.params import load_params as jload
from tpuwave_torch.models import convert
from tpuwave_torch.models import fast_engine as tfe
from tpuwave_torch.models.fast import FastWaveSolver
from tpuwave_torch.models.fast_engine_2term import Fast2TermState
from tpuwave_torch.utils.params import load_params as tload

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def _driven_case(**over):
    case = {
        "Nel": "16,12", "T": "0.06", "Dt": "0.01", "Beta": "0.25",
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


_ZERO_T = {"Function expression": "0.0", "Variable names": "x, y, t"}
CASES = {
    "base": {},
    "be": {"Theta": "1.0"},
    "unforced": {"F": {"Function expression": "0.0"}},
    "homog": {"G": _ZERO_T, "DGDT": _ZERO_T},
}
# "be" sets Theta, which Newmark ignores: the same run as "base"
FAMILY_CASES = [("theta", c) for c in CASES] + \
    [("newmark", c) for c in CASES if c != "be"]


def _close(got, want, rtol=1e-10):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _step_both(case, family, n_steps, jkw, tkw):
    """Step tpuwave's and the port's engines side by side; assert equal
    iteration counts and close states at every step."""
    js = jfe.make_fast_solver(jload(case), family, **jkw)
    ts = tfe.make_fast_solver(tload(case), family, dtype=torch.float64,
                              device=CPU, **tkw)
    sj, st = js.initial_state(), ts.initial_state()
    t = 0.0
    for _ in range(n_steps):
        t += float(case["Dt"])
        sj, ij = js.step(sj, t)
        st, it = ts.step(st, t)
        assert (it["iterations_1"], it["iterations_2"]) == \
            (int(ij["iterations_1"]), int(ij["iterations_2"]))
        _close(convert.to_numpy(st)["u"], sj.u)
    if hasattr(ts, "state_velocity"):
        _close(ts.state_velocity(st, t).numpy(), js.state_velocity(sj, t))
    return js, ts, st


@pytest.mark.parametrize("family,name,mode", [
    (f, c, m) for m in ("mg", "chebyshev", "cheby") for f, c in FAMILY_CASES
] + [("theta", "base", "auto"), ("newmark", "homog", "auto")])
def test_3term_matches_tpuwave(family, name, mode):
    kw = dict(solver="cheby") if mode == "cheby" else dict(precond=mode)
    _, ts, _ = _step_both(_driven_case(**CASES[name]), family, 6, kw, kw)
    assert ts.precond == ("jacobi" if mode in ("cheby", "auto") else mode)


@pytest.mark.parametrize("family,name,precond", [
    (f, c, p) for p in ("mg", "chebyshev") for f, c in FAMILY_CASES
    if not (p == "chebyshev" and c == "unforced")])
def test_2term_matches_tpuwave(family, name, precond):
    """Nel 16x12 has a one-level mg hierarchy, so mg takes the unfused
    setup on both sides, as do forced runs; chebyshev without forcing is
    the fused step, held against tpuwave's fused path below."""
    case = _driven_case(**CASES[name])
    kw = dict(solver="2term", precond=precond)
    _, ts, st = _step_both(case, family, 6, kw, kw)
    assert not ts._fused_ok
    assert isinstance(st, Fast2TermState) and st.n == 6


@pytest.mark.parametrize("precond", ["mg", "chebyshev"])
@pytest.mark.parametrize("family", ["theta", "newmark"])
def test_2term_fused_matches_pallas_path(family, precond):
    """The unforced 2-term step through B5's plain version, _ring_lift and
    (chebyshev) B4's plain version, against tpuwave's Pallas path: Nel
    24x20, where mg has two levels and the Pallas kernels take the 8-row
    blocks."""
    case = _driven_case(Nel="24,20", **CASES["unforced"])
    kw = dict(solver="2term", precond=precond)
    pallas = dict(use_pallas=True, pallas_interpret=True,
                  pallas_block_rows=8)
    js, ts, _ = _step_both(case, family, 3, {**kw, **pallas}, kw)
    assert ts._fused_ok and js._fused_ok


def test_2term_state_round_trips_through_convert():
    case = _driven_case(**CASES["unforced"])
    kw = dict(solver="2term", precond="mg")
    js = jfe.make_fast_solver(jload(case), "newmark", **kw)
    ts = tfe.make_fast_solver(tload(case), "newmark", dtype=torch.float64,
                              device=CPU, **kw)
    sj = js.initial_state()
    for t in (0.01, 0.02):
        sj, _ = js.step(sj, t)
    st = convert.to_torch(sj, CPU, torch.float64)
    assert isinstance(st, Fast2TermState) and st.n == 2
    back = convert.to_numpy(st)
    for name in ("u", "u_prev", "vb", "ab", "ab_prev"):
        np.testing.assert_array_equal(back[name], np.asarray(getattr(sj,
                                                                     name)))
    # stepping from tpuwave's state lands on tpuwave's next state
    sj3, ij = js.step(sj, 0.03)
    st3, it = ts.step(st, 0.03)
    assert it["iterations_1"] == int(ij["iterations_1"])
    _close(st3.u.numpy(), sj3.u)


def test_2term_rejections():
    td = _driven_case(**{"Time Dependent C": "true",
                         "C": {"Function expression":
                               "sqrt(1 + 0.5*sin(2*t))",
                               "Variable names": "x, y, t"}})
    with pytest.raises(ValueError, match="time-static"):
        tfe.make_fast_solver(tload(td), "theta", solver="2term",
                             dtype=torch.float64, device=CPU)
    with pytest.raises(ValueError, match="Beta > 0"):
        tfe.make_fast_solver(tload(_driven_case(Beta="0.0")), "newmark",
                             solver="2term", dtype=torch.float64,
                             device=CPU)
    with pytest.raises(ValueError, match="Unknown preconditioner"):
        tfe.make_fast_solver(tload(_driven_case()), "theta",
                             precond="amg", dtype=torch.float64, device=CPU)


def test_constructors_default_to_the_card():
    """No device argument means the card: without one they raise and
    never move to the CPU on their own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tfe.make_fast_solver(tload(_driven_case()), "newmark")
    with pytest.raises(RuntimeError, match="cuda"):
        tfe.make_fast_solver(tload(_driven_case()), "theta",
                             solver="2term", precond="mg")
    with pytest.raises(RuntimeError, match="cuda"):
        FastWaveSolver((8, 8), ((0.0, 0.0), (1.0, 1.0)), 1e-3)


# ---------------------------------------------------------------------------
# the CLIs end to end
# ---------------------------------------------------------------------------
def _write_case(tmp_path, preset, **over):
    case = json.loads((ROOT / "parameters" / f"{preset}.json").read_text())
    case.update({"Nel": "16", "T": "0.08", "Save Solution": "false",
                 "Log Every": "1"})
    case.update(over)
    path = tmp_path / f"{preset}.json"
    path.write_text(json.dumps(case))
    return path


def _files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


def _csv_close(a, b, skip_col=None):
    import csv
    ra, rb = (list(csv.reader(open(p))) for p in (a, b))
    assert len(ra) == len(rb) and ra[0] == rb[0], a.name
    for x, y in zip(ra[1:], rb[1:]):
        for col, u, v in zip(ra[0], x, y):
            if col == skip_col or u == v:
                continue
            fu, fv = float(u), float(v)
            assert abs(fu - fv) <= 1e-10 * max(abs(fu), abs(fv)), \
                (a.name, col, u, v)


@pytest.mark.parametrize("family,preset,flags,over", [
    ("newmark", "standing-mode-wsol", ["--solver", "2term", "--precond",
                                       "mg"], {}),
    # q = 0.25 * 0.2^2 * 16^2 = 2.56 at Dt 0.2 is below the threshold;
    # Dt 0.4 gives q = 10.24 >= 8: auto resolves to mg
    ("theta", "standing-mode-wsol", ["--precond", "auto"],
     {"Dt": "0.4", "T": "1.2", "Theta": "0.5"}),
    ("newmark", "oscillating-boundary", ["--solver", "cheby"], {}),
    ("newmark", "oscillating-boundary", ["--solver", "2term", "--precond",
                                         "mg"], {"Log Every": "3"}),
])
def test_cli_solver_flags_reproduce_tpuwave(tmp_path, capsys, family,
                                            preset, flags, over):
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
    n_csv = 0
    for rel in _files(rj):
        if not rel.endswith(".csv"):
            continue
        n_csv += 1
        if rel.endswith("iterations.csv"):
            assert (rj / rel).read_text() == (rt / rel).read_text()
        else:
            _csv_close(rj / rel, rt / rel, skip_col="elapsed_time_s")
    assert n_csv >= 3
    banner = [ln for ln in out_t.splitlines() if "Engine:" in ln]
    assert banner == [ln for ln in out_j.splitlines() if "Engine:" in ln]


def test_cli_2term_beta0_exits_1_as_tpuwave(tmp_path, capsys):
    from tpuwave.cli import newmark as jcli
    from tpuwave_torch.cli import newmark as tcli
    path = _write_case(tmp_path, "standing-mode-wsol", Beta="0.0")
    flags = ["--solver", "2term", "--results-root", str(tmp_path / "r"),
             "--mesh-root", str(tmp_path / "m")]
    assert jcli.main([str(path), *flags]) == 1
    err_j = capsys.readouterr().err
    assert tcli.main([str(path), *flags, "--device", "cpu"]) == 1
    err_t = capsys.readouterr().err
    assert "Beta > 0" in err_t
    assert err_t.splitlines()[0] == err_j.splitlines()[0]
