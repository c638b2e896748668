#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (tpuwave_torch).

Run from the repository root, with one NVIDIA GPU (Hopper, sm_90a) and the
CUDA toolkit's nvcc:

    python3 chip_smoke.py

It builds the port's hand-written kernels from tpuwave_torch/csrc, checks
each against its plain PyTorch version, then drives the port's main path
through the entry points a user calls: the explicit leapfrog of
FastWaveSolver at bench.py's configuration (4096^2 elements, f32) and both
CLIs on the reference's scalability configuration (standing mode, 640^2
elements, dt 8e-5). Phases:

  1. the card: nvidia-smi name and power limit; a CUDA device is required
  2. build the kernels, print the build time and nvcc's register report
  3. each kernel against its plain version at the main path's shapes
  4. the leapfrog: 320 steps through kernel B1 and through kernel B2
     (k = 32), each against the plain loop; DoF*steps/s
  5. both CLIs (newmark beta 1/4, theta 1/2), 50 steps on --device cuda and
     on --device cpu: CSVs and per-step CG counts must agree
  6. the full-length newmark run (T = 0.05) on cuda: wall time, and its
     final relative L2 error against tpuwave's value for the same run

Any failed check raises and the exit code is non-zero. The line before the
last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import csv
import io
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: tpuwave's final relative L2 error for the phase-6 run (standing-mode-wsol
#: with Nel 640, Dt 8e-5, T 0.05, Beta 0.25, Gamma 0.5, Save Solution and
#: Enable Logging false; f64; 626 steps by the reference's float time
#: accumulation; 3546 CG iterations), computed on the CPU with the JAX
#: package, those overrides written into standing-mode-wsol.json:
#:   JAX_PLATFORMS=cpu python -c "from tpuwave import config;
#:     config.use_x64();
#:     from tpuwave.models.fast_engine import make_fast_solver;
#:     from tpuwave.models.runner import RunConfig, run_solver;
#:     from tpuwave.utils.params import load_params;
#:     p = load_params('standing-mode-wsol.json');
#:     print(repr(run_solver(make_fast_solver(p, 'newmark'),
#:       'newmark-standing-mode-wsol',
#:       RunConfig(quiet=True, write_mesh=False)).rel_l2))"
TPUWAVE_REL_L2 = 5.078370338852986e-06

KERNEL_SOURCE = "tpuwave_torch/csrc/stencil_kernels.cu"
REPLACES = {
    "constrained_stencil_apply": "tpuwave/ops/pallas_kernels.py:1081",
    "leapfrog_step": "tpuwave/ops/pallas_kernels.py:1230",
    "leapfrog_multistep": "tpuwave/ops/pallas_kernels.py:1136",
}


def say(*args):
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing and comparison helpers
# ---------------------------------------------------------------------------
def cuda_ms(fn, n: int, warm: int = 2) -> float:
    """Mean device time of ``fn`` over ``n`` back-to-back calls (ms)."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def f32_bound(scale: float, n_steps: int = 1) -> float:
    """f32 bound: each output is a sum of <= 11 rounded terms on either
    side (22 roundings of at most eps * scale, scale = an a-priori bound
    of the sum of |terms|); over n steps of the neutrally stable leapfrog a
    perturbation grows at most linearly, so the n per-step errors add up to
    at most n^2 / 2 of them."""
    return 22 * max(1.0, n_steps * n_steps / 2) * 1.1920929e-07 * scale


def check(name: str, got, want, bound: float, extra: str = "") -> float:
    err = float((got.double() - want.double()).abs().max())
    ref = float(want.double().abs().max())
    rel = err / ref if ref else err
    ok = err <= bound
    say(f"  {name:<44} max_abs={err:.3e} max_rel={rel:.3e} "
        f"bound={bound:.3e} {extra}{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: max abs difference {err:.3e} > "
                             f"bound {bound:.3e}")
    return err


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------
def phase_kernels(torch, dev, kn) -> dict:
    """Check and time each kernel; returns, per kernel, the numbers of its
    main-path shape (max abs error, kernel and plain ms)."""
    from tpuwave_torch.models.fast import FastWaveSolver

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)

    def rnd(shape, dtype):
        return (2 * torch.rand(shape, generator=gen, device=dev,
                               dtype=torch.float64) - 1).to(dtype)

    # the stencils the main path uses: the CLI's Newmark system at 640^2,
    # the stiffness stencil of bench.py's leapfrog at 4096^2
    cli = FastWaveSolver((640, 640), ((0.0, 0.0), (1.0, 1.0)), 8e-5,
                         beta=0.25, lumped=False, dtype=torch.float64,
                         device=dev)
    sys_st, stiff_640 = cli.system.stencil, cli.stiff.stencil
    lf = FastWaveSolver((4096, 4096), ((0.0, 0.0), (1.0, 1.0)), 8e-5,
                        beta=0.0, dtype=torch.float32, device=dev)
    stiff, coef = lf.stiff.stencil, lf.dt * lf.dt / lf.mesh.det_j
    ssum = lambda st: sum(abs(c) for row in st for c in row)  # noqa: E731

    say("phase 3: kernels against their plain PyTorch versions "
        "(f64 bound: 1e-12 x max|plain|; f32 bound: see f32_bound)")
    rows, results = {}, {}

    # B3 constrained_stencil_apply
    for shape, dtype, n_k, n_p in (((641, 641), torch.float64, 200, 50),
                                   ((4097, 4097), torch.float32, 50, 10)):
        x = rnd(shape, dtype)
        for diff in (False, True):
            st = stiff_640 if diff else sys_st
            diag = st[1][1]
            got = kn.constrained_stencil_apply(x, st, diag, diff=diff)
            want = kn.constrained_stencil_apply_reference(x, st, diag, diff)
            scale = ssum(st) * float(x.abs().max()) * (2 if diff else 1)
            bound = (1e-12 * float(want.abs().max())
                     if dtype == torch.float64 else f32_bound(scale))
            ms = cuda_ms(lambda: kn.constrained_stencil_apply(
                x, st, diag, diff=diff), n_k)
            pms = cuda_ms(lambda: kn.constrained_stencil_apply_reference(
                x, st, diag, diff), n_p)
            tag = (f"B3 constrained_apply {shape[0]}^2 "
                   f"{str(dtype)[6:]} diff={diff}")
            err = check(tag, got, want, bound,
                        f"kernel={ms * 1e3:.1f}us plain={pms * 1e3:.1f}us ")
            rows[tag] = dict(err=err, ms=ms, plain_ms=pms)
    main = rows["B3 constrained_apply 641^2 float64 diff=False"]
    results["constrained_stencil_apply"] = main

    # B1 leapfrog_step
    for dtype in (torch.float32, torch.float64):
        u, up = rnd((4097, 4097), dtype), rnd((4097, 4097), dtype)
        got = kn.leapfrog_step(u, up, stiff, coef)
        want = kn.leapfrog_step_reference(u, up, stiff, coef)
        scale = 3.0 + coef * ssum(stiff)
        bound = (1e-12 * float(want.abs().max())
                 if dtype == torch.float64 else f32_bound(scale))
        ms = cuda_ms(lambda: kn.leapfrog_step(u, up, stiff, coef), 50)
        pms = cuda_ms(lambda: kn.leapfrog_step_reference(u, up, stiff,
                                                         coef), 10)
        tag = f"B1 leapfrog_step 4097^2 {str(dtype)[6:]}"
        err = check(tag, got, want, bound,
                    f"kernel={ms * 1e3:.1f}us plain={pms * 1e3:.1f}us ")
        rows[tag] = dict(err=err, ms=ms, plain_ms=pms)
    results["leapfrog_step"] = rows["B1 leapfrog_step 4097^2 float32"]

    # B2 leapfrog_multistep
    u, up = rnd((4097, 4097), torch.float32), rnd((4097, 4097),
                                                  torch.float32)
    for k in (1, 8, 32):
        got = kn.leapfrog_multistep(u, up, stiff, coef, k)
        want = kn.leapfrog_multistep_reference(u, up, stiff, coef, k)
        peak = max(1.0, float(want[0].abs().max()),
                   float(want[1].abs().max()))
        bound = f32_bound((3.0 + coef * ssum(stiff)) * peak, k)
        ms = cuda_ms(lambda: kn.leapfrog_multistep(u, up, stiff, coef, k),
                     20)
        pms = cuda_ms(lambda: kn.leapfrog_multistep_reference(
            u, up, stiff, coef, k), 3, warm=1)
        tag = f"B2 leapfrog_multistep k={k} 4097^2 float32"
        e1 = check(tag + " u", got[0], want[0], bound)
        e2 = check(tag + " u_prev", got[1], want[1], bound,
                   f"kernel={ms * 1e3:.1f}us ({ms * 1e3 / k:.1f}us/step) "
                   f"plain={pms * 1e3:.1f}us ")
        rows[tag] = dict(err=max(e1, e2), ms=ms, plain_ms=pms)
    results["leapfrog_multistep"] = rows[
        "B2 leapfrog_multistep k=32 4097^2 float32"]
    return results


# ---------------------------------------------------------------------------
# phase 4: the explicit leapfrog at bench.py's configuration
# ---------------------------------------------------------------------------
def phase_leapfrog(torch, dev):
    from tpuwave_torch.models.fast import FastWaveSolver

    n_steps = 320
    say(f"phase 4: leapfrog, 4096^2 elements (4097^2 nodes), dt 8e-5, "
        f"sin*sin, f32, {n_steps} steps")
    fs = FastWaveSolver((4096, 4096), ((0.0, 0.0), (1.0, 1.0)), 8e-5,
                        beta=0.0, dtype=torch.float32, device=dev)
    st0 = fs.initial_leapfrog_state(
        lambda xs, ys: torch.sin(torch.pi * xs) * torch.sin(torch.pi * ys))
    runs = {
        "plain (run_leapfrog_scan)": lambda: fs.run_leapfrog_scan(
            st0, n_steps),
        "B1 (run_leapfrog_kernel)": lambda: fs.run_leapfrog_kernel(
            st0, n_steps),
        "B2 k=32 (run_leapfrog_multistep)": lambda: fs.run_leapfrog_multistep(
            st0, n_steps, steps_per_call=32),
    }
    finals = {}
    for name, fn in runs.items():
        finals[name] = fn()                     # warm-up and the result
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        del out
        say(f"  {name:<34} {best * 1e6 / n_steps:9.1f} us/step  "
            f"{fs.n_dofs * n_steps / best:.4e} DoF*steps/s")
    # f32: two roundings of differently ordered sums per step (~1e-7 of
    # |u|), carried by a neutrally stable recurrence for 320 steps; a mask
    # or indexing fault is O(|u|)
    ref = finals["plain (run_leapfrog_scan)"]
    scale = float(ref.u.abs().max())
    for name in list(runs)[1:]:
        for field in ("u", "u_prev"):
            check(f"{name} {field} vs plain", getattr(finals[name], field),
                  getattr(ref, field), 1e-3 * scale)


# ---------------------------------------------------------------------------
# phases 5 and 6: the CLIs
# ---------------------------------------------------------------------------
def _case(work: Path, **over) -> Path:
    case = json.loads((ROOT / "parameters" /
                       "standing-mode-wsol.json").read_text())
    case.update({"Nel": "640", "Dt": "8e-5", "Save Solution": "false"})
    case.update(over)
    path = work / "standing-mode-wsol.json"
    path.write_text(json.dumps(case, indent=2))
    return path


def _cli(family: str, case: Path, out: Path, device: str, quiet=True):
    import importlib
    mod = importlib.import_module(f"tpuwave_torch.cli.{family}")
    argv = [str(case), "--device", device, "--results-root",
            str(out / "res"), "--mesh-root", str(out / "mesh")]
    if quiet:
        argv.append("--quiet")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{family} --device {device} exited {rc}:\n"
                             f"{buf.getvalue()[-2000:]}")
    return wall, buf.getvalue()


def _quantum(s: str) -> float:
    """One unit in the last printed digit of a CSV number."""
    mant = s.lower().split("e")[0]
    exp = int(s.lower().split("e")[1]) if "e" in s.lower() else 0
    dec = len(mant.split(".")[1]) if "." in mant else 0
    return 10.0 ** (exp - dec)


def _compare_csvs(a: Path, b: Path) -> int:
    """CSV rows of two runs: numbers within rtol 1e-9 plus one unit in
    the last printed digit (the files print 7 or 11 significant digits);
    iteration counts within +-1; the wall-clock column skipped."""
    n = 0
    for fa in sorted(a.rglob("*.csv")):
        fb = b / fa.relative_to(a)
        ra = list(csv.reader(fa.open()))
        rb = list(csv.reader(fb.open()))
        if ra[0] != rb[0] or len(ra) != len(rb):
            raise AssertionError(f"{fa.name}: header or row count differ")
        head = ra[0]
        for x, y in zip(ra[1:], rb[1:]):
            for col, u, v in zip(head, x, y):
                if u == v or col == "elapsed_time_s":
                    continue
                if col.startswith("iterations"):
                    if abs(int(u) - int(v)) > 1:
                        raise AssertionError(f"{fa.name} {col}: {u} vs {v}")
                    continue
                fu, fv = float(u), float(v)
                tol = 1e-9 * max(abs(fu), abs(fv)) + max(_quantum(u),
                                                         _quantum(v))
                if abs(fu - fv) > tol:
                    raise AssertionError(f"{fa.name} {col}: {u} vs {v}")
            n += 1
    return n


def phase_cli(torch, kn, work: Path):
    say("phase 5: both CLIs, standing mode, 640^2 elements, dt 8e-5, "
        "50 steps, f64, Log Every 1: --device cuda against --device cpu")
    for family, over in (("newmark", {"Beta": "0.25"}),
                         ("theta", {"Theta": "0.5"})):
        case = _case(work, T=str(50 * 8e-5), **{"Log Every": "1"}, **over)
        before = kn.LAUNCHES["constrained_stencil_apply"]
        w_cuda, _ = _cli(family, case, work / family / "cuda", "cuda")
        n_launch = kn.LAUNCHES["constrained_stencil_apply"] - before
        w_cpu, _ = _cli(family, case, work / family / "cpu", "cpu")
        rows = _compare_csvs(work / family / "cuda" / "res",
                             work / family / "cpu" / "res")
        say(f"  {family:<8} cuda {w_cuda:7.2f} s  cpu {w_cpu:7.2f} s  "
            f"{rows} CSV rows agree  B3 launches {n_launch}")
        if n_launch <= 0:
            raise AssertionError(f"{family}: the cuda run launched no "
                                 "constrained_stencil_apply kernel")

    say("phase 6: newmark beta 1/4, standing mode, 640^2 elements, "
        "dt 8e-5, T 0.05, f64, logging off, on cuda")
    case = _case(work, T="0.05", Beta="0.25", Gamma="0.5",
                 **{"Enable Logging": "false"})
    out = work / "full"
    wall, text = _cli("newmark", case, out, "cuda", quiet=False)
    conv = list(csv.DictReader(
        (out / "res" / "newmark-standing-mode-wsol" /
         "convergence.csv").open()))[-1]
    rel_l2 = float(conv["rel_L2_error_final"])
    elapsed = float(conv["elapsed_time_s"])
    steps = [ln for ln in text.splitlines()
             if ln.startswith(("Simulation completed", "Total CG"))]
    for ln in steps:
        say(f"  {ln}")
    n_steps = int(steps[0].split(":")[1].split()[0])
    dofs = 641 * 641
    say(f"  CLI wall {wall:.2f} s (time loop {elapsed:.3f} s, "
        f"{dofs * n_steps / elapsed:.4e} DoF*steps/s)")
    rel = abs(rel_l2 - TPUWAVE_REL_L2) / TPUWAVE_REL_L2
    say(f"  final rel L2 {rel_l2:.6e}, tpuwave {TPUWAVE_REL_L2:.10e}, "
        f"rel diff {rel:.2e} (bound 1e-6) {'ok' if rel <= 1e-6 else 'FAIL'}")
    if rel > 1e-6:
        raise AssertionError("final rel L2 differs from tpuwave's")


def main() -> int:
    import torch

    # phase 1
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke "
                           "test runs only on a CUDA device")
    smi = nvidia_smi_line()
    say(f"phase 1: {smi}")
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    say(f"  torch {torch.__version__} cuda {torch.version.cuda} on {kind}, "
        f"{torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2
    sys.path.insert(0, str(ROOT))
    from tpuwave_torch.ops import _build
    from tpuwave_torch.ops import kernels as kn
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    lib_path, nvcc_s, log = _build.build_library()
    _build.load_library()
    say(f"phase 2: built {lib_path.name} in {time.perf_counter() - t0:.2f} s"
        f" (nvcc {nvcc_s:.2f} s)")
    for ln in log.splitlines():
        if "registers" in ln or "spill" in ln:
            say(f"  {ln.strip()}")

    results = phase_kernels(torch, dev, kn)

    # the main path: counts start at 0 here and are read after phase 6
    kn.reset_launches()
    phase_leapfrog(torch, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        phase_cli(torch, kn, Path(tmp))
    launches = dict(kn.LAUNCHES)
    say(f"main-path launches: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 "main path")

    kernels = [dict(name=name, route="cuda", source=KERNEL_SOURCE,
                    replaces=REPLACES[name], launches=launches[name],
                    max_abs_err=results[name]["err"],
                    ms=results[name]["ms"],
                    plain_ms=results[name]["plain_ms"])
               for name in ("leapfrog_step", "leapfrog_multistep",
                            "constrained_stencil_apply")]
    say(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
