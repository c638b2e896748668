#!/usr/bin/env python3
"""Full-length preset runs on the PyTorch / CUDA port's CLIs.

The port's twin of scripts/full_length_runs.py: EVERY preset at its real
T through the CLI code path (``--engine auto``: the fast grid-stencil
engine on structured presets; VTU off, as in the reference sweeps' Save
Solution = false copies), on --device (default cuda; no card is an error).
The driven presets (sine-membrane, oscillating-boundary, square-pulsing)
run under both families, the rest under Newmark. Each run's CSV artifacts
are copied to ``<out>/<family>-<preset>/``, and summary.csv lists each
run's exit code, wall time, energy ratio and final error, with the twin's
schema.
--out defaults to a folder of its own beside the twin's
analysis/data/full-runs.

Usage:  python -u scripts/torch_full_length_runs.py [--out DIR] [--only a,b]
"""

from __future__ import annotations

import argparse
import csv
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

DRIVEN = {"sine-membrane", "oscillating-boundary", "square-pulsing"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="analysis/data/full-runs-torch")
    ap.add_argument("--only", help="comma-separated preset stems")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    from tpuwave_torch import config
    from tpuwave_torch.cli import newmark as cli_newmark
    from tpuwave_torch.cli import theta as cli_theta

    config.resolve_device(args.device)
    out_root = REPO / args.out
    out_root.mkdir(parents=True, exist_ok=True)
    presets = sorted((REPO / "parameters").glob("*.json"))
    if args.only:
        names = set(args.only.split(","))
        presets = [p for p in presets if p.stem in names]

    rows = []
    for preset in presets:
        case = json.loads(preset.read_text())
        case["Save Solution"] = "false"     # sweep-style IO-off copy
        fams = (("newmark", cli_newmark.main), ("theta", cli_theta.main)) \
            if preset.stem in DRIVEN else (("newmark", cli_newmark.main),)
        for fam, entry in fams:
            with tempfile.TemporaryDirectory() as td:
                tmp = Path(td) / preset.name
                tmp.write_text(json.dumps(case, indent=2))
                res_root = Path(td) / "results"
                t0 = time.perf_counter()
                rc = entry([str(tmp), "--results-root", str(res_root),
                            "--mesh-root", str(Path(td) / "mesh"),
                            "--quiet", "--device", args.device])
                elapsed = time.perf_counter() - t0
                prob = f"{fam}-{preset.stem}"
                runs = sorted((res_root / prob).glob("run-*"))
                dest = out_root / prob
                if dest.exists():
                    shutil.rmtree(dest)
                dest.mkdir(parents=True)
                summary = {"preset": preset.stem, "family": fam, "rc": rc,
                           "elapsed_s": round(elapsed, 1)}
                if runs:
                    for f in runs[0].iterdir():
                        if f.suffix in (".csv", ".json"):
                            shutil.copyfile(f, dest / f.name)
                    e_csv = dest / "energy.csv"
                    if e_csv.exists():
                        lines = e_csv.read_text().splitlines()[1:]
                        if len(lines) >= 2:
                            e0 = float(lines[0].split(",")[2])
                            eT = float(lines[-1].split(",")[2])
                            summary["energy_ratio"] = (eT / e0 if e0
                                                       else float("nan"))
                    err_csv = dest / "error.csv"
                    if err_csv.exists():
                        last = err_csv.read_text().splitlines()[-1].split(",")
                        summary["final_rel_l2"] = float(last[4])
                conv = res_root / prob / "convergence.csv"
                if conv.exists():
                    shutil.copyfile(conv, dest / "convergence.csv")
                rows.append(summary)
                print(f"{prob}: rc={rc} {elapsed:.1f} s "
                      f"{summary.get('energy_ratio', '')} "
                      f"{summary.get('final_rel_l2', '')}", flush=True)

    keys = ["preset", "family", "rc", "elapsed_s", "energy_ratio",
            "final_rel_l2"]
    with open(out_root / "summary.csv", "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=keys)
        w.writeheader()
        for r in rows:
            w.writerow({k: r.get(k, "") for k in keys})
    print(f"wrote {out_root}/summary.csv ({len(rows)} runs)")
    return 0 if all(r["rc"] == 0 for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
