#!/usr/bin/env python3
"""Dissipation/dispersion sweep on the PyTorch / CUDA port: fixed mesh, dt
sweep per scheme, Log Every = 1.

The port's twin of scripts/dissipation_dispersion_sweep.py: the same flags
(plus --device), dt ladder, CFL filter and outputs in the working directory
(dissdisp-runlog.csv, dissdisp-results.csv and the per-run time-series
folders dissdisp-{energy,error,probe}-series/), so analysis/ and
scripts/compare_with_reference.py read them unchanged. Runs are
tpuwave_torch.harness.run_case calls on the parity engine, on --device
(default cuda; no card is an error).
"""

from __future__ import annotations

import argparse
import csv as _csv
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tpuwave_torch import config  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Dissipation/dispersion sweep (tpuwave_torch)")
    p.add_argument("--nel", type=int, default=60)
    p.add_argument("--nel-explicit", type=int, default=60)
    p.add_argument("--r", type=int, default=1)
    p.add_argument("--dt", type=float, nargs="+",
                   default=[0.15, 0.1, 0.05, 0.02, 0.01, 0.005, 0.002,
                            0.001, 0.0005, 0.0001, 0.00005])
    p.add_argument("--T", type=float, default=5.0)
    p.add_argument("--schemes", nargs="+",
                   default=["theta-0.0", "theta-0.5", "theta-1.0",
                            "newmark-0.00", "newmark-0.25"])
    p.add_argument("--timeout", type=int, default=600)
    p.add_argument("--cfl-safety", type=float, default=0.9)
    p.add_argument("--results-root", default="results")
    p.add_argument("--base-params",
                   default=str(Path(__file__).resolve().parent.parent /
                               "parameters" / "standing-mode-wsol.json"))
    p.add_argument("--job-id", default=os.environ.get("PBS_JOBID", ""))
    p.add_argument("--f32", action="store_true")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p.parse_args(argv)


def extract_metrics(run_dir: Path) -> dict:
    """Energy/error/probe post-processing
    (reference dissipation_dispersion_sweep.py:249-330)."""
    metrics: dict = {}
    energy_path = run_dir / "energy.csv"
    if energy_path.exists():
        with energy_path.open() as fh:
            rows = list(_csv.DictReader(fh))
        energies = [(float(r["time"]), float(r["energy"])) for r in rows]
        if len(energies) >= 2:
            e0, e_t = energies[0][1], energies[-1][1]
            t_actual = energies[-1][0]
            metrics["E0"], metrics["ET"] = e0, e_t
            metrics["energy_ratio"] = e_t / e0 if e0 > 0 else float("nan")
            metrics["energy_decay_rate"] = ((e0 - e_t) / (e0 * t_actual)
                                            if e0 > 0 and t_actual > 0
                                            else float("nan"))
            metrics["energy_times"] = [e[0] for e in energies]
            metrics["energy_values"] = [e[1] for e in energies]

    error_path = run_dir / "error.csv"
    if error_path.exists():
        with error_path.open() as fh:
            rows = list(_csv.DictReader(fh))
        errs = [{"time": float(r["time"]),
                 "rel_L2": float(r["rel_L2_error"]),
                 "rel_H1": float(r["rel_H1_error"])} for r in rows]
        if errs:
            metrics["max_rel_L2_error"] = max(e["rel_L2"] for e in errs)
            metrics["final_rel_L2_error"] = errs[-1]["rel_L2"]
            metrics["final_rel_H1_error"] = errs[-1]["rel_H1"]
            metrics["error_times"] = [e["time"] for e in errs]
            metrics["error_L2_values"] = [e["rel_L2"] for e in errs]

    probe_path = run_dir / "probe.csv"
    if probe_path.exists():
        with probe_path.open() as fh:
            rows = list(_csv.DictReader(fh))
        if rows:
            metrics["probe_times"] = [float(r["time"]) for r in rows]
            metrics["probe_values"] = [float(r["u_probe"]) for r in rows]
    return metrics


def main(argv=None):
    args = parse_args(argv)
    device = config.resolve_device(args.device)
    dtype = config.default_float(args.f32)

    from tpuwave_torch.harness import (PARAM_STEM, SCHEME_DEFS, cfl_limit,
                                       is_cfl_safe, predict_run_folder,
                                       run_case)

    for s in args.schemes:
        if s not in SCHEME_DEFS:
            print(f"Unknown scheme: {s}. Available: {list(SCHEME_DEFS)}")
            sys.exit(1)

    plan = []
    for scheme_name in args.schemes:
        nel = (args.nel_explicit if SCHEME_DEFS[scheme_name]["explicit"]
               else args.nel)
        for dt in sorted(args.dt, reverse=True):
            if is_cfl_safe(scheme_name, nel, args.r, dt, args.cfl_safety):
                plan.append((scheme_name, dt, nel))
            else:
                print(f"  [SKIP] {scheme_name} dt={dt} exceeds CFL limit "
                      f"{cfl_limit(nel, args.r, cfl_safety=args.cfl_safety):.6f}")

    total = len(plan)
    print("=" * 60)
    print(f"Dissipation/Dispersion sweep: {total} runs on {device.type}")
    print("=" * 60)

    all_metrics = []
    job_suffix = f"-{args.job_id}" if args.job_id else ""
    runlog_path = Path(f"dissdisp-runlog{job_suffix}.csv")
    with runlog_path.open("w") as logf:
        logf.write("scheme,Nel,R,dt,T,returncode,elapsed_s,cfl_limit,"
                   "energy_ratio,energy_decay_rate,max_rel_L2,"
                   "final_rel_L2,final_rel_H1\n")
        for i, (scheme_name, dt, nel) in enumerate(plan, 1):
            sdef = SCHEME_DEFS[scheme_name]
            cfl = (cfl_limit(nel, args.r, cfl_safety=args.cfl_safety)
                   if sdef["explicit"] else float("inf"))
            tag = f"{scheme_name}_Nel{nel}_R{args.r}_dt{dt}"
            print(f"[{i}/{total}] {tag}")

            overrides = {"Nel": str(nel), "R": str(args.r), "Dt": str(dt),
                         "T": str(args.T), "Save Solution": False,
                         "Enable Logging": True, "Log Every": 1,
                         "Print Every": max(1, int(1.0 / dt))}
            code, elapsed, _ = run_case(
                scheme_name, args.base_params, overrides,
                results_root=args.results_root, timeout_s=args.timeout,
                device=device, dtype=dtype)
            print(f"  -> {'OK' if code == 0 else code} in {elapsed:.1f}s")

            metrics = {}
            if code == 0:
                problem = f"{sdef['family']}-{PARAM_STEM}"
                run_dir = (Path(args.results_root) / problem /
                           predict_run_folder(nel, args.r, dt, args.T,
                                              scheme_name))
                metrics = extract_metrics(run_dir)
                if "energy_ratio" in metrics:
                    print(f"     Energy ratio E(T)/E(0) = "
                          f"{metrics['energy_ratio']:.8f}")

            logf.write(
                f"{scheme_name},{nel},{args.r},{dt},{args.T},{code},"
                f"{elapsed:.3f},{cfl:.8f},"
                f"{metrics.get('energy_ratio', '')},"
                f"{metrics.get('energy_decay_rate', '')},"
                f"{metrics.get('max_rel_L2_error', '')},"
                f"{metrics.get('final_rel_L2_error', '')},"
                f"{metrics.get('final_rel_H1_error', '')}\n")
            logf.flush()
            all_metrics.append({"scheme": scheme_name, "nel": nel,
                                "r": args.r, "dt": dt, "T": args.T, **metrics})

    summary_path = Path(f"dissdisp-results{job_suffix}.csv")
    with summary_path.open("w") as f:
        f.write("scheme,Nel,R,dt,T,energy_ratio,energy_decay_rate,"
                "max_rel_L2,final_rel_L2,final_rel_H1\n")
        for m in all_metrics:
            f.write(f"{m['scheme']},{m['nel']},{m['r']},{m['dt']},{m['T']},"
                    f"{m.get('energy_ratio', '')},"
                    f"{m.get('energy_decay_rate', '')},"
                    f"{m.get('max_rel_L2_error', '')},"
                    f"{m.get('final_rel_L2_error', '')},"
                    f"{m.get('final_rel_H1_error', '')}\n")

    # per-run time series (consumed by the analysis notebook)
    for series, xkey, ykey, header in (
            ("dissdisp-energy-series", "energy_times", "energy_values",
             "time,energy"),
            ("dissdisp-error-series", "error_times", "error_L2_values",
             "time,rel_L2_error"),
            ("dissdisp-probe-series", "probe_times", "probe_values",
             "time,u_probe")):
        out_dir = Path(f"{series}{job_suffix}")
        out_dir.mkdir(parents=True, exist_ok=True)
        for m in all_metrics:
            if xkey in m:
                fpath = out_dir / f"{m['scheme']}_dt{m['dt']}.csv"
                with fpath.open("w") as f:
                    f.write(header + "\n")
                    for x, y in zip(m[xkey], m[ykey]):
                        f.write(f"{x},{y}\n")

    print("=" * 60)
    print(f"Done. Summary results: {summary_path}")
    print(f"Run log: {runlog_path}")


if __name__ == "__main__":
    main()
