"""Checkpoint / resume of the port (tpuwave_torch/utils/checkpoint.py,
models/runner.py, models/convert.py::like_state) against tpuwave's
(tpuwave/utils/checkpoint.py, tpuwave/models/runner.py), on the CPU, in
f64.

A checkpoint file written by either package is read by the other; pruning
and log truncation leave the same files. A resumed port run, from a middle
checkpoint copied into a fresh run folder, equals the port's uninterrupted
run on the parity engine (theta and Newmark), the fast engine, the 2-term
engine and the parity theta engine with a time-dependent C (its
``k_payload``): the final state within rtol 1e-12, the CSV rows after the
checkpoint byte-equal (CG counts included). A checkpoint written by
tpuwave's runner resumes in the port and ends within rtol 1e-10 of
tpuwave's uninterrupted run, with equal CG counts.
"""

import json
import shutil
from collections import namedtuple
from pathlib import Path

import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (one torch thread)
from tpuwave.utils import checkpoint as jck
from tpuwave_torch.models.convert import like_state
from tpuwave_torch.models.runner import RunConfig, run_solver
from tpuwave_torch.utils import checkpoint as tck
from tpuwave_torch.utils.params import load_params

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
LOGS = ("energy.csv", "error.csv", "probe.csv", "iterations.csv")
TDEP_C = {"Time Dependent C": "true",
          "C": {"Function expression": "1 + 0.1*t",
                "Variable names": "x, y, t"}}


def _case(**over) -> dict:
    case = json.loads((ROOT / "parameters" /
                       "standing-mode-wsol.json").read_text())
    case.update({"Nel": "10", "Dt": "0.01", "T": "0.06",
                 "Save Solution": "false", "Log Every": "1"})
    case.update(over)
    return case


def test_checkpoint_files_read_across_packages(tmp_path):
    from tpuwave_torch.models.fast_engine_2term import Fast2TermState
    rng = np.random.default_rng(0)
    arrays = {k: rng.random(12) for k in ("u", "u_prev", "v0", "a0")}
    strips = {k: rng.random((4, 3)) for k in ("vb", "ab", "ab_prev")}
    port = Fast2TermState(n=7, **{k: torch.tensor(v)
                                  for k, v in {**arrays, **strips}.items()})

    # the port's file, read by tpuwave: every field, step and time
    tck.save_checkpoint(tmp_path / "t", 7, 0.07, port)
    step, t, fields = jck.load_latest(tmp_path / "t")
    assert (step, t) == (7, 0.07) and set(fields) == set(port._fields)
    assert int(fields["n"]) == 7 and fields["n"].ndim == 0
    for k, v in {**arrays, **strips}.items():
        np.testing.assert_array_equal(fields[k], v)

    # tpuwave's file (its step counter an int32 device scalar, an unused
    # slot None), read by the port onto its own state
    J = namedtuple("J", list(port._fields) + ["k_payload"])
    jst = J(n=np.asarray(5, np.int32), k_payload=None,
            **{k: 2 * v for k, v in {**arrays, **strips}.items()})
    jck.save_checkpoint(tmp_path / "j", 5, 0.05, jst)
    step, t, fields = tck.load_latest(tmp_path / "j")
    assert (step, t) == (5, 0.05) and "k_payload" not in fields
    got = like_state(port, fields)
    assert got.n == 5 and isinstance(got.n, int)
    for k, v in {**arrays, **strips}.items():
        assert getattr(got, k).dtype == torch.float64
        np.testing.assert_array_equal(getattr(got, k).numpy(), 2 * v)

    # tpuwave pads its R = 2 canvases: cropped (and padded) to the port's
    canvas = torch.zeros(4, 5, 6, dtype=torch.float32)
    padded = np.arange(4 * 8 * 4, dtype=np.float64).reshape(4, 8, 4)
    K = namedtuple("K", ["u"])
    got = like_state(K(u=canvas), {"u": padded}).u
    assert got.shape == canvas.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got[:, :5, :4].numpy(), padded[:, :5, :])
    assert not got[:, :, 4:].any()

    # pruning: the same writes leave the same files in both packages
    S = namedtuple("S", ["u"])
    for pkg, name in ((jck, "pj"), (tck, "pt")):
        for k in range(1, 6):
            pkg.save_checkpoint(tmp_path / name, k, 0.1 * k,
                                S(u=np.full(3, float(k))), keep=2)
    names = [sorted(p.name for p in (tmp_path / d).iterdir())
             for d in ("pj", "pt")]
    assert names[0] == names[1] == ["checkpoint_000004.npz",
                                    "checkpoint_000005.npz"]

    # log truncation: the same rows survive in both packages
    text = {"energy.csv": "timestep,time,energy\n1,0.01,2\n2,0.02,3\n"
                          "3,0.03,4\n",
            "iterations.csv": "timestep,time,iterations_1,iterations_2\n"
                              "1,0.01,5,0\n2,0.02,6,0\n3,0.03,7,0\nbad\n",
            "probe.csv": "timestep,time,u_probe\n"}
    for pkg, name in ((jck, "lj"), (tck, "lt")):
        (tmp_path / name).mkdir()
        for f, body in text.items():
            (tmp_path / name / f).write_text(body)
        pkg.truncate_logs_after(tmp_path / name, 2)
    for f in text:
        assert ((tmp_path / "lj" / f).read_text()
                == (tmp_path / "lt" / f).read_text())
    assert (tmp_path / "lt" / "energy.csv").read_text().endswith("2,0.02,3\n")


def _port_solver(kind: str):
    from tpuwave_torch.models.fast_engine import make_fast_solver
    from tpuwave_torch.models.general import make_discretization
    from tpuwave_torch.models.newmark import NewmarkSolver
    from tpuwave_torch.models.theta import ThetaSolver
    p = load_params(_case(**(TDEP_C if kind == "parity-theta-tdep" else {}),
                          Theta="0.5"))
    if kind == "fast":
        return make_fast_solver(p, "newmark", device=CPU)
    if kind == "2term":
        return make_fast_solver(p, "newmark", precond="mg", solver="2term",
                                device=CPU)
    disc = make_discretization(p, device=CPU)
    if kind == "parity-newmark":
        return NewmarkSolver(disc)
    return ThetaSolver(disc)


def _assert_states_close(got, want, rtol):
    assert type(got) is type(want)
    for k in want._fields:
        a, b = getattr(got, k), getattr(want, k)
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype, k
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol,
                                       atol=rtol * float(b.abs().max()),
                                       err_msg=k)
        else:
            assert a == b, k


@pytest.mark.parametrize("kind", ["parity-theta", "parity-newmark", "fast",
                                  "2term", "parity-theta-tdep"])
def test_resume_equals_uninterrupted(tmp_path, kind):
    """6 steps, checkpoints every 2 (4 and 6 kept); step 4's copied into a
    fresh run folder and resumed; the uninterrupted run without
    checkpoints (the runner's chunked branch) ends in the same state."""
    def cfg(root, **kw):
        return RunConfig(results_root=str(tmp_path / root), quiet=True,
                         write_mesh=False, **kw)
    plain = run_solver(_port_solver(kind), "p", cfg("plain"))
    full = run_solver(_port_solver(kind), "p", cfg("full",
                                                   checkpoint_every=2))
    ckpts = sorted(full.output_folder.glob("checkpoint_*.npz"))
    assert [c.name for c in ckpts] == ["checkpoint_000004.npz",
                                       "checkpoint_000006.npz"]
    if kind == "parity-theta-tdep":
        assert full.state.k_payload is not None
    folder = tmp_path / "resumed" / full.output_folder.relative_to(
        tmp_path / "full")
    folder.mkdir(parents=True)
    shutil.copy(ckpts[0], folder)
    res = run_solver(_port_solver(kind), "p", cfg("resumed", resume=True))

    assert res.timestep_number == full.timestep_number == 6
    assert res.final_time == full.final_time
    _assert_states_close(res.state, full.state, 1e-12)
    _assert_states_close(full.state, plain.state, 1e-12)
    for name in LOGS:
        rows = (full.output_folder / name).read_text().splitlines()
        assert rows == (plain.output_folder / name).read_text().splitlines()
        assert (folder / name).read_text().splitlines() == \
            [rows[0]] + rows[5:], name
    conv = [(tmp_path / r / "p" / "convergence.csv").read_text()
            .splitlines()[-1].rsplit(",", 1)[0] for r in ("full", "resumed")]
    assert conv[0] == conv[1]


def test_tpuwave_checkpoint_resumes_in_port(tmp_path):
    """tpuwave's runner (parity theta 1/2, Nel 8, checkpoint_every 2)
    writes checkpoints at steps 2 and 4 of 5; step 2's, copied into a
    fresh folder, is resumed by the port."""
    from tpuwave.models.discretization import Discretization as JDisc
    from tpuwave.models.runner import RunConfig as JConfig
    from tpuwave.models.runner import run_solver as jrun
    from tpuwave.models.theta import ThetaSolver as JTheta
    from tpuwave.utils.params import load_params as jload
    from tpuwave_torch.models.general import make_discretization
    from tpuwave_torch.models.theta import ThetaSolver

    case = _case(Nel="8", T="0.05", Theta="0.5")
    want = jrun(JTheta(JDisc(jload(case))), "p",
                JConfig(results_root=str(tmp_path / "j"), quiet=True,
                        write_mesh=False, checkpoint_every=2))
    ckpts = sorted(want.output_folder.glob("checkpoint_*.npz"))
    assert [c.name for c in ckpts] == ["checkpoint_000002.npz",
                                       "checkpoint_000004.npz"]
    folder = tmp_path / "t" / want.output_folder.relative_to(tmp_path / "j")
    folder.mkdir(parents=True)
    shutil.copy(ckpts[0], folder)
    got = run_solver(
        ThetaSolver(make_discretization(load_params(case), device=CPU)),
        "p", RunConfig(results_root=str(tmp_path / "t"), quiet=True,
                       write_mesh=False, resume=True))

    assert got.timestep_number == want.timestep_number == 5
    for k in ("u", "v"):
        b = np.asarray(getattr(want.state, k))
        np.testing.assert_allclose(getattr(got.state, k).numpy(), b,
                                   rtol=1e-10, atol=1e-10 * np.abs(b).max())
    jrows = (want.output_folder / "iterations.csv").read_text().splitlines()
    trows = (folder / "iterations.csv").read_text().splitlines()
    assert trows == [jrows[0]] + jrows[3:]
    for name in ("energy.csv", "error.csv", "probe.csv"):
        jrows = (want.output_folder / name).read_text().splitlines()[3:]
        trows = (folder / name).read_text().splitlines()[1:]
        assert len(jrows) == len(trows) == 3, name
        for a, b in zip(jrows, trows):
            for x, y in zip(a.split(","), b.split(",")):
                assert x == y or abs(float(x) - float(y)) <= \
                    1e-10 * abs(float(x)), (name, x, y)
