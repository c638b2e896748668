"""Rank program of the sharding tests (tests/test_torch_shard_*.py).

Started on N CPU ranks over gloo by :func:`launch` (torch.distributed.run
--standalone, one torch thread a rank), it runs one group of jobs of the
port's sharded paths (parallel/sharding.py, parallel/halo.py) and rank 0
writes what they gathered to an .npz; the tests hold it against tpuwave
and against the port's one-rank runs. It imports torch and tpuwave_torch
only.

    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        tests/torch_shard_ranks.py solvers OUT.npz
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

UNIT = ((0.0, 0.0), (1.0, 1.0))
#: halo.py's grid: 128 rows (64 / 32 a rank over 2 / 4), 24 columns
HALO_NEL, HALO_DT, HALO_STEPS = (23, 127), 0.002, 16
HALO_KS = (1, 4, 8)
#: FastWaveSolver's grid: 17 rows (uneven over 2 and 4), 23 columns
FAST_NEL = (22, 16)
FAST_CASES = {"explicit": (dict(), 0.005, 10),
              "newmark": (dict(beta=0.25, lumped=False), 0.01, 5),
              "theta": (dict(scheme="theta", theta=0.5, lumped=False),
                        0.01, 5)}
#: the engines' driven and forced problem (tests/test_fast_engine.py's)
DRIVEN = {
    "F": {"Function expression": "sin(3*pi*x)*cos(2*pi*y)*cos(5*t)",
          "Variable names": "x, y, t"},
    "G": {"Function expression": "0.1*sin(2*t)*(1+x*y)",
          "Variable names": "x, y, t"},
    "DGDT": {"Function expression": "0.2*cos(2*t)*(1+x*y)",
             "Variable names": "x, y, t"},
}
ENGINE_MG = (("newmark", {"Beta": "0.25"}), ("theta", {"Theta": "0.5"}))
ENGINE_MG_OVER = {"Nel": "32,32", "T": "0.03"}
ENGINE_OTHER = (("newmark", {"Beta": "0.25"}, dict(solver="2term",
                                                   precond="mg")),
                ("theta", {"Theta": "1.0"}, dict(solver="cheby")))
ENGINE_OTHER_OVER = {"Nel": "16,15", "T": "0.05"}
#: row bounds of the V-cycle test's 33-row fine grid: a level of them
#: leaves a rank fewer than 2 rows (agglomerated there)
THIN_BOUNDS = {2: [(0, 3), (3, 33)],
               4: [(0, 2), (2, 5), (5, 29), (29, 33)]}


def standing_case(**over) -> dict:
    """tests/test_schemes.py's standing mode with the driven data."""
    case = {
        "Nel": "16", "R": "1", "T": "0.1", "Theta": "0.5", "Beta": "0.25",
        "Gamma": "0.5", "Dt": "0.01",
        "Save Solution": "false", "Log Every": "0",
        "C": {"Function expression": "1.0", "Variable names": "x, y, t"},
        "F": {"Function expression": "0.0", "Variable names": "x, y, t"},
        "U0": {"Function expression": "sin(pi*x)*sin(pi*y)",
               "Variable names": "x, y"},
        "V0": {"Function expression": "0.0", "Variable names": "x, y"},
        "G": {"Function expression": "0.0", "Variable names": "x, y, t"},
        "DGDT": {"Function expression": "0.0", "Variable names": "x, y, t"},
    }
    case.update(DRIVEN)
    case.update(over)
    return case


def launch(n: int, args, *, timeout: float = 240.0) -> subprocess.Popen:
    """Start this program (or ``args[0] == "-m"``: a module) on ``n`` CPU
    ranks; the caller waits with :func:`finish`."""
    prog = list(args) if args[0] == "-m" else [str(Path(__file__)),
                                                *map(str, args)]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={n}", *prog]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.deadline = timeout
    return proc


def finish(proc: subprocess.Popen) -> str:
    """Wait for a launch (killing it at its deadline); its output, or an
    AssertionError with the output's tail where it failed."""
    try:
        out, _ = proc.communicate(timeout=proc.deadline)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        raise AssertionError(f"ranks timed out:\n{out[-3000:]}")
    if proc.returncode != 0:
        raise AssertionError(f"ranks exited {proc.returncode}:\n"
                             f"{out[-3000:]}")
    return out


# ---------------------------------------------------------------------------
# the jobs (run on every rank)
# ---------------------------------------------------------------------------
def _u0(torch):
    def u0(x, y):
        return torch.sin(torch.pi * x) * torch.sin(torch.pi * y)
    return u0


def _grids(shd):
    """(name, rank-grid shape) of this world: row slabs, and 2 x 2 blocks
    on four ranks."""
    out = [("rows", None)]
    if shd.world_size() == 4:
        out.append(("blocks", (2, 2)))
    return out


def job_halo(torch, shd, res):
    from tpuwave_torch.models.fast import FastWaveSolver, LeapfrogState
    from tpuwave_torch.parallel.halo import (make_halo_leapfrog_step,
                                             make_multistep_halo_leapfrog)
    fs = FastWaveSolver(HALO_NEL, UNIT, HALO_DT, dtype=torch.float64,
                        device="cpu")
    st = fs.initial_leapfrog_state(_u0(torch))
    mesh = shd.device_mesh()
    for k in HALO_KS:
        if k == 1:
            adv, lay = make_halo_leapfrog_step(mesh, fs)
        else:
            adv, lay = make_multistep_halo_leapfrog(mesh, fs, k)
        # the start from rank 0's whole grid
        root = shd.world_rank() == 0
        s = LeapfrogState(lay.scatter(st.u if root else None),
                          lay.scatter(st.u_prev if root else None))
        for _ in range(HALO_STEPS // k):
            s = adv(s)
        res[f"halo {k}"] = lay.gather_all(s.u).numpy()
        res[f"halo {k} prev"] = lay.gather_all(s.u_prev).numpy()


def job_fast(torch, shd, res):
    import numpy as np
    from tpuwave_torch.models.fast import FastWaveSolver
    for gname, shape in _grids(shd):
        sh = shd.grid_sharding(shd.device_mesh(shape=shape))
        for name, (kw, dt, steps) in FAST_CASES.items():
            s = FastWaveSolver(FAST_NEL, UNIT, dt, dtype=torch.float64,
                               device="cpu", sharding=sh, **kw)
            st = s.run_scan(s.initial_state(_u0(torch)), steps)
            key = f"fast {gname} {name}"
            res[f"{key} u"] = s.layout.gather_all(st.u).numpy()
            res[f"{key} its"] = np.asarray(s.last_iterations)
            res[f"{key} energy"] = np.asarray(float(s.energy(st)))
        s = FastWaveSolver(FAST_NEL, UNIT, 0.005, dtype=torch.float64,
                           device="cpu", sharding=sh)
        lf = s.run_leapfrog_scan(s.initial_leapfrog_state(_u0(torch)), 10)
        res[f"fast {gname} leapfrog u"] = s.layout.gather_all(lf.u).numpy()


def _engine_run(torch, make, params, fam, sharding, kw):
    """Steps of a fast engine to T; (gathered u, per-step iterations,
    energy, probe, errors)."""
    import numpy as np
    eng = make(params, fam, dtype=torch.float64, device="cpu",
               sharding=sharding, **kw)
    st, its, t = eng.initial_state(), [], 0.0
    while t < params.t_final - 1e-12:
        t += params.dt
        st, info = eng.step(st, t)
        its.append((info["iterations_1"], info["iterations_2"]))
    v = eng.state_velocity(st, t) if hasattr(eng, "state_velocity") \
        else st.v
    d = eng.disc
    u = d.vertex_values(st.u)
    return dict(u=u, its=np.asarray(its),
                energy=np.asarray(float(d.energy(st.u, v))),
                probe=np.asarray(float(d.probe(st.u))))


def job_engines(torch, shd, res):
    import numpy as np
    from tpuwave_torch.models.fast_engine import make_fast_solver
    from tpuwave_torch.utils.params import load_params
    for gname, shape in _grids(shd):
        sh = shd.grid_sharding(shd.device_mesh(shape=shape))
        for fam, over in ENGINE_MG:
            p = load_params(standing_case(**ENGINE_MG_OVER, **over))
            out = _engine_run(torch, make_fast_solver, p, fam, sh,
                              dict(precond="mg"))
            for k, v in out.items():
                res[f"mg {gname} {fam} {k}"] = v
    sh = shd.grid_sharding(shd.device_mesh())
    for fam, over, kw in ENGINE_OTHER:
        p = load_params(standing_case(**ENGINE_OTHER_OVER, **over))
        out = _engine_run(torch, make_fast_solver, p, fam, sh, kw)
        for k, v in out.items():
            res[f"{kw['solver']} {fam} {k}"] = v
    # a sharded rerun is bitwise equal (every rank checks its block)
    fam, over = ENGINE_MG[0]
    p = load_params(standing_case(**ENGINE_MG_OVER, **over))
    again = _engine_run(torch, make_fast_solver, p, fam, sh,
                        dict(precond="mg"))
    same = torch.tensor(float(
        np.array_equal(again["u"], res[f"mg rows {fam} u"])
        and np.array_equal(again["its"], res[f"mg rows {fam} its"])))
    torch.distributed.all_reduce(same)
    res["rerun equal ranks"] = np.asarray(int(same))


def job_vcycle(torch, shd, res):
    """The sharded V-cycle on a partition whose coarse levels leave a rank
    fewer than 2 rows (agglomerated), on a seeded residual."""
    import numpy as np
    from tpuwave_torch.parallel.sharding import GridLayout
    from tpuwave_torch.solve.multigrid import (ShardedGmgPreconditioner,
                                               gmg_for_system)
    gmg = gmg_for_system((32, 32), UNIT, 1.0, 0.25 * 0.05 ** 2)
    lay = GridLayout((33, 33), shd.device_mesh(), "cpu",
                     row_bounds=THIN_BOUNDS[shd.world_size()])
    pre = ShardedGmgPreconditioner(gmg.levels, gmg.coarse_theta,
                                   gmg.coarse_coeffs, lay)
    b = np.random.default_rng(7).standard_normal((33, 33))
    b[0, :] = b[-1, :] = b[:, 0] = b[:, -1] = 0.0
    z = pre(lay.local(torch.tensor(b)).contiguous())
    res["vcycle z"] = lay.gather_all(z).numpy()
    res["vcycle b"] = b
    res["vcycle sharded levels"] = np.asarray(
        sum(x is not None for x in pre.layouts))
    res["vcycle levels"] = np.asarray(len(pre.layouts))


#: the CLI runs of each world: (name, case file, flags)
CLI_RUNS = {2: (("rows", "case.json", ["--shard", "rows"]),
                ("vtu", "vtu.json", ["--shard", "rows", "--distributed",
                                     "--vtu-pieces", "0",
                                     "--checkpoint-every", "2"])),
            4: (("rows", "case.json", ["--shard", "rows"]),
                ("blocks", "case.json", ["--shard", "blocks"]))}


def job_cli(torch, shd, res, out_dir: Path):
    """The newmark CLI's runs of this world (in this process, the process
    group already joined) into out_dir/<name>/, with each rank's console
    output."""
    import contextlib
    import io
    from tpuwave_torch.cli import newmark
    for name, case, flags in CLI_RUNS[shd.world_size()]:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = newmark.main([str(out_dir / case), "--device", "cpu",
                               "--results-root", str(out_dir / name),
                               "--mesh-root", str(out_dir / "mesh"),
                               "--precond", "mg", *flags])
        res[f"cli {name} rc {shd.world_rank()}"] = rc
        res[f"cli {name} out {shd.world_rank()}"] = buf.getvalue()


JOBS = {"solvers": (job_halo, job_fast, job_vcycle),
        "engines": (job_engines,),
        "cli": (job_cli,)}


def main(argv) -> int:
    import numpy as np
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT))
    from tpuwave_torch.parallel import sharding as shd
    group, out = argv[0], Path(argv[1])
    shd.init_distributed(device="cpu")
    res = {}
    for job in JOBS[group]:
        if job is job_cli:
            job(torch, shd, res, out.parent)
        else:
            job(torch, shd, res)
    if group == "cli":
        # every rank's console, gathered on rank 0
        got = [None] * shd.world_size()
        torch.distributed.all_gather_object(got, res)
        if shd.world_rank() == 0:
            merged = {}
            for r in got:
                merged.update(r)
            out.write_text(json.dumps(merged))
    elif shd.world_rank() == 0:
        np.savez(out, **res)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
