"""The torch twins of tpuwave's bench scripts
(scripts/torch_bench_{p2_mg,precision,implicit_mg,driven}.py), each run
in-process at a tiny size on the CPU (``--nel 16``, a few steps): every
row the original prints, in its form, and the end-state figures the
twins print (the mg and Jacobi trajectories agree; the kernel route and
the torch-op route agree; every rate is positive).

On the card (``cuda``): the solvers those twins drive, device="cuda"
against device="cpu" (the kernels against their plain versions inside
the whole step): P2CanvasSolver with mg and its 2-term recurrence at Nel
24 in f64 (B11, B12, B13, B4, B3), and the compensated f32 2-term paths
at 48^2 (B3, B4), with per-step CG counts equal (within one in f32).
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (one torch thread)

ROOT = Path(__file__).resolve().parent.parent
RATE = r"\s+[0-9.]+ us/step\s+[0-9.]+e[+-]\d+ DoF\*steps/s"


def _run(name, argv, capsys):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(argv + ["--device", "cpu"]) == 0
    return capsys.readouterr().out


def _floats(pattern, out):
    return [float(m) for m in re.findall(pattern, out)]


@pytest.mark.parametrize("twin", ["p2_mg", "precision", "implicit_mg",
                                  "driven"])
def test_bench_twin_rows(twin, capsys):
    if twin == "p2_mg":
        out = _run("torch_bench_p2_mg",
                   ["--nel", "16", "--steps", "3", "--repeats", "1",
                    "--dt", "0.02", "--dtype", "f64", "--no-pallas"], capsys)
        for pc in ("mg", "jacobi"):
            assert re.search(rf"newmark P2 nel=16 dt=0.02 precond={pc}: "
                             r"[0-9.]+ ms/step \([0-9.]+e\+\d+ DoF\*steps/s"
                             r"\)", out)
            assert re.search(rf"precond={pc} 2term: [0-9.]+ ms/step", out)
        # the two preconditioners solve the same systems to the CG
        # tolerance; the 2-term recurrence tracks the 3-term trajectory
        (diff,) = _floats(r"end-state rel diff mg vs jacobi: (\S+)", out)
        assert diff < 1e-6
        assert all(d < 1e-3 for d in _floats(r"rel diff (\S+)\)", out))
        its = re.search(r"\[mg\] CG iterations per step: \[(.*)\]", out)
        assert len(its.group(1).split(",")) == 3
    elif twin == "precision":
        out = _run("torch_bench_precision",
                   ["--nel", "16", "--steps", "2"], capsys)
        for label in ("f32  roll scan   ", "f32c compensated ",
                      "f64  roll scan   ",
                      "f32  implicit CN driven (2term mg)",
                      "f32c implicit CN compensated 2term driven",
                      "f32c implicit CN compensated 2term standing",
                      "f64  implicit CN driven (2term mg)"):
            assert re.search(re.escape(label) + ":" + RATE, out), label
        assert "# platform=cpu nel=16 steps=2" in out
    elif twin == "implicit_mg":
        out = _run("torch_bench_implicit_mg",
                   ["--nel", "16", "--steps", "3", "--repeats", "1",
                    "--dtype", "f64", "--interpret"], capsys)
        for name in ("theta-1.0", "theta-0.5", "newmark-0.25"):
            m = re.search(rf"{name} nel=16 dt=0.001: torch MG [0-9.]+ "
                          r"ms/step, kernel MG [0-9.]+ ms/step \([0-9.]+x\),"
                          r" rel diff (\S+)", out)
            # the same steps on two routes: round-off apart in f64
            assert m and float(m.group(1)) < 1e-10, name
            m = re.search(rf"{name} nel=16 dt=0.001: 2term MG [0-9.]+ "
                          r"ms/step \([0-9.]+x vs kernel-mg\), rel diff "
                          r"(\S+)", out)
            assert m and float(m.group(1)) < 1e-4, name
    else:
        out = _run("torch_bench_driven",
                   ["--nel", "16", "--steps", "8"], capsys)
        for label in ("explicit driven g(t)          ",
                      "explicit driven g(t), pallas  ",
                      "explicit driven, k= 8 blocked ",
                      "explicit driven + forcing load",
                      "implicit CN driven (fast engine, mg, dt=1e-3)",
                      "implicit CN driven (2term, mg, dt=1e-3)",
                      "implicit CN driven (cheby,    dt=1e-3)"):
            assert re.search(re.escape(label) + ":" + RATE, out), label
        assert "k=16 blocked: skipped" in out


@pytest.mark.cuda
def test_cuda_p2_canvas_solver_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from tpuwave_torch.models.fast_p2 import P2CanvasSolver
    from tpuwave_torch.ops import kernels as tk

    def u0(x, y):
        return torch.sin(torch.pi * x) * torch.sin(torch.pi * y) * (1 + x)

    out = {}
    tk.reset_launches()
    for dev in ("cuda", "cpu"):
        s = P2CanvasSolver((24, 20), ((0.0, 0.0), (1.0, 1.0)), 0.02,
                           precond="mg", dtype=torch.float64, device=dev)
        st = s.run_scan(s.initial_state(u0), 3)
        its = list(s.last_iterations)
        pair = s.run_implicit_2term(s.implicit_2term_init(st), 3)
        out[dev] = (st, pair, its + s.last_iterations)
    assert out["cuda"][2] == out["cpu"][2]
    for got, want in zip(out["cuda"][:2], out["cpu"][:2]):
        for f in got._fields:
            w = getattr(want, f).numpy()
            np.testing.assert_allclose(getattr(got, f).cpu().numpy(), w,
                                       rtol=1e-10,
                                       atol=1e-10 * np.abs(w).max())
    for k in ("p2_constrained_apply", "p2_presmooth", "p2_postsmooth",
              "cheby_block", "constrained_stencil_apply"):
        assert tk.LAUNCHES[k] > 0, k


@pytest.mark.cuda
def test_cuda_compensated_2term_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from tpuwave_torch.models.fast import FastWaveSolver
    from tpuwave_torch.ops import kernels as tk

    def u0(x, y):
        v = torch.sin(torch.pi * x.double()) * torch.sin(
            torch.pi * y.double())
        return v.to(x.dtype)

    def g(x, y, t):
        return torch.where((y <= 0.0) & (x <= 1.0 / 3.0),
                           torch.sin(4.0 * torch.pi * t), 0.0)

    out = {}
    tk.reset_launches()
    for dev in ("cuda", "cpu"):
        s = FastWaveSolver((48, 48), ((0.0, 0.0), (1.0, 1.0)), 4e-3,
                           scheme="theta", theta=0.5, lumped=False,
                           dtype=torch.float32, device=dev)
        cs = s.implicit_2term_init_comp(s.initial_state(u0))
        a = s.run_implicit_mg_2term_comp(cs, 6, tol_factor=1e-3)
        its = list(s.last_iterations)
        b = s.run_implicit_mg_2term_comp_driven(cs, [4e-3 * (1 + k)
                                                     for k in range(6)], g)
        out[dev] = (a, b, its + s.last_iterations)
    # f32 CG: a count may move by one with the summation order
    its = [out[d][2] for d in ("cuda", "cpu")]
    assert len(its[0]) == len(its[1])
    assert all(abs(a - b) <= 1 for a, b in zip(*its))
    for got, want in zip(out["cuda"][:2], out["cpu"][:2]):
        full = [(x.u.double() + x.u_lo.double()).cpu().numpy()
                for x in (got, want)]
        assert (np.linalg.norm(full[0] - full[1])
                / np.linalg.norm(full[1])) <= 1e-6
    for k in ("cheby_block", "constrained_stencil_apply"):
        assert tk.LAUNCHES[k] > 0, k
