"""Shared CLI plumbing for the two entry points of the port.

Contract mirrors tpuwave's CLIs and the reference executables
(src/main-theta.cpp:23-152, src/main-newmark.cpp): one optional positional
argument = parameter file (default ``parameters/sine-membrane.json``);
problem name = ``<family>-<param-file-stem>``; env flags
``NMPDE_SAVE_SOLUTION`` / ``NMPDE_LOG_EVERY`` / ``NMPDE_PARAM_FILE``
exported for the run, and friendly parse-error hints with exit(1).

The flags are tpuwave's plus ``--device {cuda,cpu}`` (default cuda).
Flags whose code paths are not ported yet exit with code 1 and a one-line
message naming the ROADMAP item; nothing falls back to another path.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

from tpuwave_torch import config
from tpuwave_torch.models.general import (IMPORTED_MESH_REFUSAL,
                                          make_discretization)
from tpuwave_torch.models.runner import RunConfig, run_solver
from tpuwave_torch.utils.params import ParamError, load_params

DEFAULT_PARAM_FILE = "parameters/sine-membrane.json"


def _build_parser(family: str) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog=f"tpuwave_torch-{family}",
        description=f"{family}-method solver for the 2D wave equation "
                    "(PyTorch / CUDA port)")
    parser.add_argument("parameters", nargs="?", default=None,
                        help="path to a JSON/PRM parameter file")
    parser.add_argument("--results-root", default="results")
    parser.add_argument("--mesh-root", default="mesh")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--f32", action="store_true",
                        help="run single precision (default: f64 parity mode)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the run's tensors live; cuda is never "
                             "replaced by cpu silently")
    parser.add_argument("--checkpoint-every", type=int, default=0,
                        help="snapshot state every N steps (0 = off; not "
                             "ported yet)")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the newest checkpoint (not ported "
                             "yet)")
    parser.add_argument("--profile-dir", default=None,
                        help="capture a profiler trace (not ported yet)")
    parser.add_argument("--phase-timing", action="store_true",
                        help="print per-phase wall-clock breakdown")
    parser.add_argument("--engine", choices=("auto", "fast", "parity"),
                        default="auto",
                        help="solver engine: fast = grid-stencil engine on "
                             "structured rectangles; parity = the general "
                             "gather-path engine; auto = fast when "
                             "eligible, else parity")
    parser.add_argument("--precond",
                        choices=["jacobi", "chebyshev", "mg", "auto"],
                        default="jacobi",
                        help="CG preconditioner of the implicit system "
                             "(mg = geometric multigrid, dt-independent "
                             "iteration counts at CFL-breaking dt; auto = "
                             "mg when the system is stiffness-dominated, "
                             "else jacobi)")
    parser.add_argument("--solver", choices=("3term", "2term", "cheby"),
                        default="3term",
                        help="implicit-solve strategy: 3term = the parity "
                             "CG contract (default); 2term = displacement-"
                             "form recurrence, ~1 MG-PCG iteration per "
                             "step, pair with --precond mg (Beta > 0 for "
                             "newmark; velocity reconstructed at log "
                             "points); cheby = dot-product-free restarted "
                             "Chebyshev solve blocks")
    parser.add_argument("--shard", choices=("none", "rows", "blocks"),
                        default="none",
                        help="partition the run across devices (not "
                             "ported yet)")
    parser.add_argument("--unstructured-sharding",
                        choices=("none", "cells", "dofs", "dofs2d"),
                        default="none",
                        help="parallel engine for imported unstructured "
                             "meshes (not ported yet)")
    parser.add_argument("--vtu-pieces", type=int, default=1,
                        help="VTU pieces per output record (0 = one per "
                             "device)")
    parser.add_argument("--distributed", action="store_true",
                        help="multi-host run (not ported yet)")
    return parser


def _refused(args):
    """The one-line refusal for a flag whose path is not ported, or None."""
    if args.shard != "none":
        return f"--shard {args.shard} is not ported yet (ROADMAP A11)"
    if args.distributed:
        return "--distributed is not ported yet (ROADMAP A11)"
    if args.unstructured_sharding != "none":
        return (f"--unstructured-sharding {args.unstructured_sharding} is "
                "not ported yet (ROADMAP A11)")
    if args.checkpoint_every or args.resume:
        return ("--checkpoint-every / --resume are not ported yet "
                "(ROADMAP A1, utils/checkpoint.py)")
    if args.profile_dir:
        return "--profile-dir is not ported yet (ROADMAP A13)"
    return None


def run_main(family: str, argv=None) -> int:
    args = _build_parser(family).parse_args(argv)

    refusal = _refused(args)
    if refusal is not None:
        print(refusal, file=sys.stderr)
        return 1
    try:
        device = config.resolve_device(args.device)
    except RuntimeError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    dtype = config.default_float(args.f32)

    parameters_file = args.parameters
    if parameters_file is None:
        parameters_file = DEFAULT_PARAM_FILE
        print(f"Usage: tpuwave_torch-{family} <path-to-parameters-file>")
        print(f"Using default parameter file: {parameters_file}")
    else:
        print(f"Using parameter file from argument: {parameters_file}")
    print("===============================================")

    try:
        params = load_params(parameters_file)
    except (ParamError, FileNotFoundError, OSError) as e:
        print(f"Error while reading the parameter file:\n  {e}", file=sys.stderr)
        print("Hint: check that the file exists and matches the documented "
              "JSON schema (see parameters/*.json).", file=sys.stderr)
        return 1
    if params.mesh_file is not None:
        print(IMPORTED_MESH_REFUSAL, file=sys.stderr)
        return 1

    # export the reference's env channels for the duration of the run only
    env_save = {k: os.environ.get(k) for k in
                ("NMPDE_PARAM_FILE", "NMPDE_SAVE_SOLUTION", "NMPDE_LOG_EVERY")}
    os.environ["NMPDE_PARAM_FILE"] = str(parameters_file)
    os.environ["NMPDE_SAVE_SOLUTION"] = "1" if params.save_solution else "0"
    os.environ["NMPDE_LOG_EVERY"] = str(params.effective_log_every)

    problem_name = f"{family}-{Path(parameters_file).stem}"
    print(f"  Problem name: {problem_name}")
    print(f"  Backend: {device.type}, 1 device(s), 1 process(es)")

    try:
        from tpuwave_torch.models.fast_engine import resolve_engine
        try:
            solver, disc, reason = resolve_engine(
                params, family, args.engine,
                make_disc=lambda: make_discretization(params, dtype=dtype,
                                                      device=device),
                precond=args.precond, solver=args.solver, dtype=dtype,
                device=device)
        except ValueError as e:
            if args.solver == "3term":
                raise
            print(f"--solver {args.solver} unavailable for this problem: "
                  f"{e}\nHint: use the default --solver 3term.",
                  file=sys.stderr)
            return 1
        if solver is None and args.solver != "3term":
            print(f"--solver {args.solver} requires the fast engine "
                  f"(ineligible here: {reason}); the parity engine runs "
                  "the 3term form only.", file=sys.stderr)
            return 1
        if solver is not None:
            banner = "  Engine: fast (grid-stencil)"
            if args.solver != "3term":
                banner += f" [{args.solver}]"
            print(banner)
        elif reason is not None:
            if args.engine == "fast":
                print("--engine fast unavailable for this problem: "
                      f"{reason}\nHint: use --engine auto (falls back "
                      "to the parity engine) or --engine parity.",
                      file=sys.stderr)
                return 1
            print(f"  Engine: parity (fast engine ineligible: {reason})")
        if solver is None:
            from tpuwave_torch.models.newmark import NewmarkSolver
            from tpuwave_torch.models.theta import ThetaSolver
            cls = ThetaSolver if family == "theta" else NewmarkSolver
            solver = cls(disc, precond=args.precond)
        cfg = RunConfig(results_root=args.results_root,
                        mesh_root=args.mesh_root, quiet=args.quiet,
                        phase_timing=args.phase_timing,
                        vtu_pieces=args.vtu_pieces)
        result = run_solver(solver, problem_name, cfg)
    finally:
        for k, v in env_save.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return 2 if result.diverged else 0
