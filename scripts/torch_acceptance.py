#!/usr/bin/env python3
"""Acceptance sweep on the PyTorch / CUDA port: every shipped preset
through both CLI families.

The port's twin of scripts/acceptance.py: all 12 parameter presets (T
capped at --t-max, at least 3 steps, Log Every 1, everything else
untouched) through tpuwave_torch-theta and tpuwave_torch-newmark on
--device (default cuda; no card is an error), checking exit codes and that
the expected artifacts appear (energy / probe / iterations CSVs, error.csv
where the preset has an exact Solution, VTU records). Writes the twin's
summary schema (preset,family,T,Dt,status,returncode,elapsed_s,
final_rel_L2,final_rel_H1) to --out, which defaults to a file of its own
beside the twin's analysis/data/acceptance-summary.csv.

Usage: python scripts/torch_acceptance.py [--t-max 0.05] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--t-max", type=float, default=0.05,
                    help="cap T at this value (0 = keep preset T)")
    ap.add_argument("--presets", nargs="*", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=str(REPO / "analysis" / "data" /
                                         "acceptance-summary-torch.csv"))
    args = ap.parse_args(argv)

    from tpuwave_torch import config
    from tpuwave_torch.cli import newmark as cli_newmark
    from tpuwave_torch.cli import theta as cli_theta

    config.resolve_device(args.device)
    presets = sorted((REPO / "parameters").glob("*.json"))
    if args.presets:
        presets = [p for p in presets if p.stem in args.presets]

    failures = []
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for preset in presets:
            data = json.loads(preset.read_text())
            if args.t_max > 0:
                # keep at least 3 steps so the lazy per-step CSVs trigger
                t_cap = max(args.t_max, 3 * float(data["Dt"]))
                data["T"] = str(min(float(data["T"]), t_cap))
            data["Log Every"] = 1
            data["Print Every"] = 1000000
            case = tmp / preset.name
            case.write_text(json.dumps(data))

            for family, main_fn in (("theta", cli_theta.main),
                                    ("newmark", cli_newmark.main)):
                tag = f"{family}-{preset.stem}"
                t0 = time.perf_counter()
                code = main_fn([str(case), "--results-root",
                                str(tmp / "results"), "--mesh-root",
                                str(tmp / "mesh"), "--quiet",
                                "--device", args.device])
                elapsed = time.perf_counter() - t0
                run_dirs = list((tmp / "results" / tag).glob("run-*"))
                ok = code == 0 and len(run_dirs) == 1
                if ok:
                    d = run_dirs[0]
                    artifacts = {"energy.csv", "probe.csv", "iterations.csv"}
                    missing = [a for a in artifacts if not (d / a).exists()]
                    vtus = list(d.glob("solution_*.pvtu"))
                    has_sol = "Solution" in data
                    if missing:
                        ok = False
                    if has_sol and not (d / "error.csv").exists():
                        ok = False
                    if not vtus:
                        ok = False
                status = "OK" if ok else f"FAIL(code={code})"
                rel_l2 = rel_h1 = ""
                if ok:
                    err_csv = run_dirs[0] / "error.csv"
                    if err_csv.exists():
                        last = err_csv.read_text().strip().splitlines()[-1]
                        parts = last.split(",")
                        if len(parts) >= 6:
                            # timestep,time,L2,H1,relL2,relH1
                            rel_l2, rel_h1 = parts[4], parts[5]
                rows.append((preset.stem, family,
                             float(data["T"]), data["Dt"], status, code,
                             f"{elapsed:.2f}", rel_l2, rel_h1))
                print(f"{tag:<40} {status:<12} {elapsed:6.1f}s")
                if not ok:
                    failures.append(tag)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("w") as f:
        f.write("preset,family,T,Dt,status,returncode,elapsed_s,"
                "final_rel_L2,final_rel_H1\n")
        for r in rows:
            f.write(",".join(str(x) for x in r) + "\n")
    print(f"\nwrote {out}")

    if failures:
        print(f"{len(failures)} failures: {failures}")
        return 1
    print(f"All {2 * len(presets)} acceptance runs passed.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
