#!/usr/bin/env python3
"""Convergence sweep on the PyTorch / CUDA port: all (scheme, Nel, R, dt)
combinations with CFL-safe filtering, merged into convergence-results.csv.

The port's twin of scripts/convergence_sweep.py: the same flags (plus
--device), default grid (Nel 10..320, r 1..2, 10 dt values, five schemes),
CFL filter, and runlog and merged-CSV schemas, written into the working
directory, so analysis/ and scripts/compare_with_reference.py read the
output unchanged. Runs are tpuwave_torch.harness.run_case calls on the
parity engine, on --device (default cuda; no card is an error).

Usage:
    python scripts/torch_convergence_sweep.py --nel 10 20 40 --dt 0.01 0.005
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tpuwave_torch import config  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Convergence sweep (tpuwave_torch)")
    p.add_argument("--nel", type=int, nargs="+",
                   default=[10, 20, 40, 80, 160, 320])
    p.add_argument("--r", type=int, nargs="+", default=[1, 2], dest="r_values")
    p.add_argument("--dt", type=float, nargs="+",
                   default=[0.1, 0.05, 0.02, 0.01, 0.005, 0.002, 0.001,
                            0.0005, 0.0002, 0.0001])
    p.add_argument("--T", type=float, default=1.0)
    p.add_argument("--schemes", nargs="+",
                   default=["theta-0.0", "theta-0.5", "theta-1.0",
                            "newmark-0.00", "newmark-0.25"])
    p.add_argument("--timeout", type=int, default=600,
                   help="Per-run wall-clock limit in seconds")
    p.add_argument("--cfl-safety", type=float, default=0.9)
    p.add_argument("--results-root", default="results")
    p.add_argument("--base-params",
                   default=str(Path(__file__).resolve().parent.parent /
                               "parameters" / "standing-mode-wsol.json"))
    p.add_argument("--job-id", default=os.environ.get("PBS_JOBID", ""))
    p.add_argument("--f32", action="store_true")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = config.resolve_device(args.device)
    dtype = config.default_float(args.f32)

    from tpuwave_torch.harness import (PARAM_STEM, SCHEME_DEFS, cfl_limit,
                                       is_cfl_safe, run_case)

    for s in args.schemes:
        if s not in SCHEME_DEFS:
            print(f"Unknown scheme: {s}. Available: {list(SCHEME_DEFS)}")
            sys.exit(1)

    results_base = Path(args.results_root)
    for prefix in ("theta", "newmark"):
        csv_path = results_base / f"{prefix}-{PARAM_STEM}" / "convergence.csv"
        if csv_path.exists():
            csv_path.unlink()
            print(f"Removed old {csv_path}")

    plan = []
    for scheme_name in args.schemes:
        for nel in sorted(args.nel):
            for r in sorted(args.r_values):
                for dt in sorted(args.dt, reverse=True):
                    if is_cfl_safe(scheme_name, nel, r, dt, args.cfl_safety):
                        plan.append((scheme_name, nel, r, dt))

    total = len(plan)
    print("=" * 60)
    print(f"Convergence sweep: {total} runs on {device.type}")
    print(f"  Schemes: {args.schemes}")
    print(f"  Nel:     {args.nel}")
    print(f"  R:       {args.r_values}")
    print(f"  dt:      {args.dt}")
    print(f"  T:       {args.T}")
    print("=" * 60)

    job_suffix = f"-{args.job_id}" if args.job_id else ""
    runlog_path = Path(f"convergence-runlog{job_suffix}.csv")
    with runlog_path.open("w") as logf:
        logf.write("scheme,Nel,R,dt,T,returncode,elapsed_s,cfl_limit\n")
        for i, (scheme_name, nel, r, dt) in enumerate(plan, 1):
            sdef = SCHEME_DEFS[scheme_name]
            cfl = (cfl_limit(nel, r, cfl_safety=args.cfl_safety)
                   if sdef["explicit"] else float("inf"))
            tag = f"{scheme_name}_Nel{nel}_R{r}_dt{dt}"
            print(f"[{i}/{total}] {tag}"
                  + (f"  (CFL={cfl:.6f})" if sdef["explicit"] else ""))

            overrides = {"Nel": str(nel), "R": str(r), "Dt": str(dt),
                         "T": str(args.T), "Save Solution": False,
                         "Enable Logging": False, "Log Every": 0}
            code, elapsed, _ = run_case(
                scheme_name, args.base_params, overrides,
                results_root=args.results_root, timeout_s=args.timeout,
                device=device, dtype=dtype)
            status = ("OK" if code == 0
                      else ("TIMEOUT" if code == -1 else f"FAIL({code})"))
            print(f"  -> {status} in {elapsed:.1f}s")
            logf.write(f"{scheme_name},{nel},{r},{dt},{args.T},{code},"
                       f"{elapsed:.3f},{cfl:.8f}\n")
            logf.flush()

    # merge the per-family convergence CSVs (reference :323-337)
    merged_path = Path(f"convergence-results{job_suffix}.csv")
    header_written = False
    with merged_path.open("w") as out:
        for prefix in ("theta", "newmark"):
            csv_path = results_base / f"{prefix}-{PARAM_STEM}" / "convergence.csv"
            if csv_path.exists():
                with csv_path.open() as fh:
                    for line_no, line in enumerate(fh):
                        if line_no == 0:
                            if not header_written:
                                out.write(line)
                                header_written = True
                        else:
                            out.write(line)

    print("=" * 60)
    print(f"Done. Merged convergence results: {merged_path}")
    print(f"Run log: {runlog_path}")


if __name__ == "__main__":
    main()
