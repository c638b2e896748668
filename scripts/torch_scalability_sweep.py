#!/usr/bin/env python3
"""Scalability sweep on the PyTorch / CUDA port: the fixed problem of
scripts/scalability_sweep.py on one card.

The same flags (plus --device), problem (standing mode, Nel 640, r 1,
dt 8e-5, T 0.05 => 625 steps, IO off) and output schema
(scalability-results-<max devices>.csv: scheme,binary,nprocs,repeat,...,
seconds; binary ``tpuwave_torch-fast``) as the twin. Each scheme runs
tpuwave_torch's FastWaveSolver.run_scan once to warm up (kernel loads,
first-use costs), then --repeats timed runs (host clock around a
synchronize). --profile-dir writes one torch.profiler trace of a warm run
per (scheme, device count) next to the CSVs.

Ranks (parallel/sharding.py): ``--devices 1 2 4`` runs each count over the
first n ranks of the launched world (``torchrun --nproc-per-node 4``), its
grid in row slabs, ``nprocs`` in the CSV being the rank count; counts
above the world are skipped. ``--distributed`` joins the launcher's
process group and runs only the whole world, in tpuwave's hosts x local
ranks grid. ``--virtual-devices N`` starts N CPU ranks over gloo itself
(``torch.distributed.run --standalone``), the counterpart of XLA's virtual
CPU devices. Only rank 0 prints and writes. ``--dist-timeout`` bounds
every collective of the ranks that run a count; the ranks left out of a
count wait for it in a gloo group of the whole world whose timeout is
sized to the count's whole run (STEP_ALLOWANCE_S a step), so a count that
runs longer than the process group's timeout does not end them.

Usage:
    python scripts/torch_scalability_sweep.py [--dtype f64] [--repeats 3]
    python scripts/torch_scalability_sweep.py --virtual-devices 2 \
        --devices 1 2 --device cpu
"""

from __future__ import annotations

import argparse
import datetime
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tpuwave_torch import config  # noqa: E402

#: seconds a rank left out of a device count allows each of the count's
#: steps before its wait raises
STEP_ALLOWANCE_S = 2.0


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Scalability sweep (tpuwave_torch)")
    p.add_argument("--devices", type=int, nargs="+", default=[1],
                   help="Device counts to test (like the reference's p sweep)")
    p.add_argument("--virtual-devices", type=int, default=0,
                   help="Start N CPU ranks over gloo (the counterpart of "
                        "N virtual CPU devices)")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--nel", type=int, default=640)
    p.add_argument("--r", type=int, default=1)
    p.add_argument("--dt", type=float, default=0.00008)
    p.add_argument("--T", type=float, default=0.05)
    p.add_argument("--schemes", nargs="+",
                   default=["theta-0.0", "theta-0.5", "theta-1.0",
                            "newmark-0.00", "newmark-0.25"])
    p.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    p.add_argument("--job-id", default=os.environ.get("PBS_JOBID", ""))
    p.add_argument("--distributed", action="store_true",
                   help="multi-host run: join the launcher's process group "
                        "and run the whole world only")
    p.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                   help="process-group backend (default: nccl on cuda, "
                        "gloo on cpu; gloo for several ranks on one card)")
    p.add_argument("--dist-timeout", type=float, default=None,
                   help="seconds a collective of the running ranks may wait "
                        "for a peer (default: the process group's 120)")
    p.add_argument("--profile-dir", default=None,
                   help="archive a torch.profiler trace per "
                        "(scheme, device-count) next to the CSVs")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p.parse_args(argv)


def _spawn_virtual(args, argv) -> int:
    """Run this script on ``--virtual-devices`` CPU ranks over gloo."""
    if args.device != "cpu":
        print("--virtual-devices runs CPU ranks: pass --device cpu",
              file=sys.stderr)
        return 1
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={args.virtual_devices}",
           str(Path(__file__).resolve())] + list(argv)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run(cmd, env=env).returncode


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if args.virtual_devices and "RANK" not in os.environ:
        return _spawn_virtual(args, argv)
    device = config.resolve_device(args.device)

    import torch

    from tpuwave_torch.parallel import sharding as shd

    joined = False
    if args.distributed or "RANK" in os.environ:
        joined = shd.init_distributed(
            backend=args.dist_backend, device=device,
            timeout_s=args.dist_timeout or shd.DEFAULT_TIMEOUT_S)
    try:
        return _sweep(args, device)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def _sweep(args, device) -> int:
    import torch

    from tpuwave_torch.harness import SCHEME_DEFS
    from tpuwave_torch.models.fast import FastWaveSolver
    from tpuwave_torch.models.runner import time_steps
    from tpuwave_torch.parallel import sharding as shd
    from tpuwave_torch.utils.profiling import trace

    primary = shd.world_rank() == 0
    many = shd.world_size() > 1

    def say(*a):
        if primary:
            print(*a, flush=True)

    def sync(group=None):
        """The card's queue drained, then (several ranks) a barrier."""
        if device.type == "cuda":
            torch.cuda.synchronize()
        if many:
            torch.distributed.barrier(group=group)

    dtype = torch.float32 if args.dtype == "f32" else torch.float64
    n_steps = len(time_steps(args.T, args.dt))
    # where a device count leaves ranks out, they wait here for its runs
    # (warm, profiled and timed, every scheme)
    idle = None
    if many and not args.distributed and min(args.devices) < shd.world_size():
        runs = len(args.schemes) * (args.repeats + 1 + bool(args.profile_dir))
        idle = torch.distributed.new_group(
            backend="gloo", timeout=datetime.timedelta(
                seconds=(args.dist_timeout or shd.DEFAULT_TIMEOUT_S)
                + STEP_ALLOWANCE_S * n_steps * runs))
    n_avail = shd.world_size()
    name = (torch.cuda.get_device_name(0) if device.type == "cuda"
            else "cpu")
    say(f"devices available: {n_avail} ({device.type}: {name}), "
        f"{n_steps} steps per run")

    def u0(xs, ys):
        return torch.sin(torch.pi * xs) * torch.sin(torch.pi * ys)

    job_suffix = f"-{args.job_id}" if args.job_id else ""
    out_path = Path(f"scalability-results-{max(args.devices)}{job_suffix}.csv")
    f = out_path.open("w") if primary else open(os.devnull, "w")
    with f:
        f.write("scheme,binary,nprocs,repeat,Nel,R,Dt,T,Theta,Beta,Gamma,"
                "returncode,seconds\n")
        for n_dev in args.devices:
            if n_dev > n_avail:
                say(f"[SKIP] {n_dev} devices requested, {n_avail} available")
                continue
            if args.distributed:
                # every rank takes part in every collective: only the
                # whole world (tpuwave's rule)
                if n_dev != n_avail:
                    say(f"[SKIP] --distributed: n={n_dev} != all "
                        f"{n_avail} devices (partial meshes cannot span "
                        "all hosts)")
                    continue
                mesh = shd.dcn_device_mesh()
            else:
                # (a collective of the whole world, member or not)
                mesh = shd.device_mesh(n_dev)
            if not mesh.member:
                sync(idle)
                continue
            sharding = shd.grid_sharding(mesh) if n_dev > 1 else None
            group = mesh.group
            for scheme_name in args.schemes:
                sdef = SCHEME_DEFS[scheme_name]
                ov = sdef["overrides"]
                theta = ov.get("Theta", "")
                beta = ov.get("Beta", "")
                gamma = ov.get("Gamma", "")
                if sdef["family"] == "theta":
                    solver = FastWaveSolver(
                        (args.nel, args.nel), ((0.0, 0.0), (1.0, 1.0)),
                        args.dt, scheme="theta", theta=float(theta),
                        lumped=False, dtype=dtype, device=device,
                        sharding=sharding)
                else:
                    solver = FastWaveSolver(
                        (args.nel, args.nel), ((0.0, 0.0), (1.0, 1.0)),
                        args.dt, scheme="newmark", beta=float(beta),
                        gamma=float(gamma), lumped=float(beta) == 0.0,
                        dtype=dtype, device=device, sharding=sharding)
                state0 = solver.initial_state(u0)
                # the warm run stays outside the timed repeats, as the
                # twin keeps its compile outside them
                solver.run_scan(state0, n_steps)
                sync(group)
                if args.profile_dir:
                    tdir = Path(args.profile_dir) / f"{scheme_name}-p{n_dev}"
                    if n_dev > 1:
                        tdir = tdir / f"rank{shd.world_rank()}"
                    with trace(str(tdir)):
                        solver.run_scan(state0, n_steps)
                        sync(group)
                for rep in range(1, args.repeats + 1):
                    sync(group)
                    t0 = time.perf_counter()
                    solver.run_scan(state0, n_steps)
                    sync(group)
                    secs = time.perf_counter() - t0
                    dof_steps = solver.n_dofs * n_steps
                    say(f"p={n_dev} {scheme_name} rep{rep}: {secs:.3f}s "
                        f"({dof_steps / secs:.3e} DoF*steps/s)")
                    f.write(f"{scheme_name},tpuwave_torch-fast,{n_dev},"
                            f"{rep},{args.nel},{args.r},{args.dt},{args.T},"
                            f"{theta},{beta},{gamma},0,{secs:.6f}\n")
                    f.flush()
            sync(idle)

    say(f"Done. Results: {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
