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
per (scheme, device count) next to the CSVs. One device only: --devices
above 1, --distributed and --virtual-devices are refused (ROADMAP A11).

Usage:
    python scripts/torch_scalability_sweep.py [--dtype f64] [--repeats 3]
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tpuwave_torch import config  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Scalability sweep (tpuwave_torch)")
    p.add_argument("--devices", type=int, nargs="+", default=[1],
                   help="Device counts to test (like the reference's p sweep)")
    p.add_argument("--virtual-devices", type=int, default=0,
                   help="Force N virtual CPU devices (not ported)")
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
                   help="multi-host run (not ported)")
    p.add_argument("--profile-dir", default=None,
                   help="archive a torch.profiler trace per "
                        "(scheme, device-count) next to the CSVs")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p.parse_args(argv)


def _refused(args):
    """The one-line refusal of a multi-device option, or None."""
    if max(args.devices) > 1:
        return (f"--devices {max(args.devices)} is not ported yet: one "
                "device only (ROADMAP A11)")
    if args.distributed:
        return "--distributed is not ported yet (ROADMAP A11)"
    if args.virtual_devices:
        return "--virtual-devices is not ported yet (ROADMAP A11)"
    return None


def main(argv=None) -> int:
    args = parse_args(argv)
    refusal = _refused(args)
    if refusal is not None:
        print(refusal, file=sys.stderr)
        return 1
    device = config.resolve_device(args.device)

    import torch

    from tpuwave_torch.harness import SCHEME_DEFS
    from tpuwave_torch.models.fast import FastWaveSolver
    from tpuwave_torch.models.runner import time_steps
    from tpuwave_torch.utils.profiling import trace

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    dtype = torch.float32 if args.dtype == "f32" else torch.float64
    n_steps = len(time_steps(args.T, args.dt))
    name = (torch.cuda.get_device_name(0) if device.type == "cuda"
            else "cpu")
    print(f"devices available: 1 ({device.type}: {name}), "
          f"{n_steps} steps per run")

    def u0(xs, ys):
        return torch.sin(torch.pi * xs) * torch.sin(torch.pi * ys)

    job_suffix = f"-{args.job_id}" if args.job_id else ""
    out_path = Path(f"scalability-results-{max(args.devices)}{job_suffix}.csv")
    with out_path.open("w") as f:
        f.write("scheme,binary,nprocs,repeat,Nel,R,Dt,T,Theta,Beta,Gamma,"
                "returncode,seconds\n")
        n_dev = 1
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
                    lumped=False, dtype=dtype, device=device)
            else:
                solver = FastWaveSolver(
                    (args.nel, args.nel), ((0.0, 0.0), (1.0, 1.0)),
                    args.dt, scheme="newmark", beta=float(beta),
                    gamma=float(gamma), lumped=float(beta) == 0.0,
                    dtype=dtype, device=device)
            state0 = solver.initial_state(u0)
            # the warm run stays outside the timed repeats, as the twin
            # keeps its compile outside them
            solver.run_scan(state0, n_steps)
            sync()
            if args.profile_dir:
                tdir = Path(args.profile_dir) / f"{scheme_name}-p{n_dev}"
                with trace(str(tdir)):
                    solver.run_scan(state0, n_steps)
                    sync()
            for rep in range(1, args.repeats + 1):
                t0 = time.perf_counter()
                solver.run_scan(state0, n_steps)
                sync()
                secs = time.perf_counter() - t0
                dof_steps = solver.n_dofs * n_steps
                print(f"p={n_dev} {scheme_name} rep{rep}: {secs:.3f}s "
                      f"({dof_steps / secs:.3e} DoF*steps/s)")
                f.write(f"{scheme_name},tpuwave_torch-fast,{n_dev},{rep},"
                        f"{args.nel},{args.r},{args.dt},{args.T},"
                        f"{theta},{beta},{gamma},0,{secs:.6f}\n")
                f.flush()

    print(f"Done. Results: {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
