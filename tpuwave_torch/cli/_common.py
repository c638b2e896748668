"""Shared CLI plumbing for the two entry points of the port.

Contract mirrors tpuwave's CLIs and the reference executables
(src/main-theta.cpp:23-152, src/main-newmark.cpp): one optional positional
argument = parameter file (default ``parameters/sine-membrane.json``);
problem name = ``<family>-<param-file-stem>``; env flags
``NMPDE_SAVE_SOLUTION`` / ``NMPDE_LOG_EVERY`` / ``NMPDE_PARAM_FILE``
exported for the run, and friendly parse-error hints with exit(1).

The flags are tpuwave's plus ``--device {cuda,cpu}`` (default cuda) and
``--dist-backend {nccl,gloo}``. Flags whose code paths are not ported yet
exit with code 1 and a one-line message naming the ROADMAP item; nothing
falls back to another path.

Ranks: ``--shard rows|blocks`` partitions a structured R = 1 fast run
with a constant c over the ranks the launcher's environment gives
(``torchrun --nproc-per-node N``: ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``; parallel/sharding.py::init_distributed); started alone it
is a world of one, as tpuwave on a one-chip host. ``--distributed`` is
tpuwave's multi-host switch: without a launcher environment it prints
tpuwave's notice and runs single-host. The backend is NCCL for ``cuda``
and gloo for ``cpu`` unless ``--dist-backend`` says otherwise (gloo for
several ranks on one card). Only rank 0 prints and writes.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

from tpuwave_torch import config
from tpuwave_torch.core.unstructured import read_mesh_file
from tpuwave_torch.models.general import make_discretization
from tpuwave_torch.models.runner import RunConfig, run_solver
from tpuwave_torch.parallel import sharding as shd
from tpuwave_torch.utils.params import ParamError, load_params
from tpuwave_torch.utils.profiling import trace

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
                        help="snapshot state every N steps (0 = off)")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the newest checkpoint in the run "
                             "folder")
    parser.add_argument("--profile-dir", default=None,
                        help="capture a torch.profiler trace (trace.json) "
                             "into this directory")
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
                        help="partition the fast-engine run over the "
                             "launched ranks (the reference's mpirun -np N "
                             "domain decomposition): rows = row slabs, "
                             "blocks = 2-D row x column blocks. Structured "
                             "R=1 runs with a constant C (the parity "
                             "engine runs unsharded)")
    parser.add_argument("--unstructured-sharding",
                        choices=("none", "cells", "dofs", "dofs2d"),
                        default="none",
                        help="parallel engine for imported unstructured "
                             "meshes (none = single device; cells / dofs "
                             "/ dofs2d not ported yet)")
    parser.add_argument("--vtu-pieces", type=int, default=1,
                        help="VTU pieces per output record (0 = one per "
                             "rank, each written by its rank)")
    parser.add_argument("--distributed", action="store_true",
                        help="multi-host run: join the process group the "
                             "launcher's environment describes (torchrun)")
    parser.add_argument("--dist-backend", choices=("nccl", "gloo"),
                        default=None,
                        help="process-group backend of a multi-rank run "
                             "(default: nccl on cuda, gloo on cpu; gloo "
                             "for several ranks on one card)")
    return parser


def _refused(args):
    """The one-line refusal for a flag whose path is not ported, or None."""
    if args.unstructured_sharding != "none":
        return (f"--unstructured-sharding {args.unstructured_sharding} is "
                "not ported yet (ROADMAP A11(b))")
    return None


def _shard_refusal(args, params):
    """The one-line refusal of ``--shard`` on a problem whose sharded
    engine is not ported, or None."""
    if args.shard == "none" or params.mesh_file is not None:
        return None
    if params.r != 1:
        return (f"--shard {args.shard} at R = {params.r} is not ported yet "
                "(ROADMAP A11(b))")
    if params.c.constant_value is None:
        return (f"--shard {args.shard} with a varying or time-dependent C "
                "is not ported yet (ROADMAP A11(b))")
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

    joined = False
    if args.distributed or args.shard != "none":
        joined = not shd.world_size() > 1 and shd.init_distributed(
            backend=args.dist_backend, device=device)
        if args.distributed and shd.world_size() == 1:
            print("--distributed: no coordination env configured "
                  "(MASTER_ADDR unset); continuing single-host",
                  file=sys.stderr)
    try:
        return _run(family, args, device, dtype)
    finally:
        if joined:
            import torch.distributed as dist
            dist.destroy_process_group()


def _run(family: str, args, device, dtype) -> int:
    primary = shd.world_rank() == 0
    if not primary:
        args.quiet = True

    def say(*a):
        if primary:
            print(*a)

    parameters_file = args.parameters
    if parameters_file is None:
        parameters_file = DEFAULT_PARAM_FILE
        say(f"Usage: tpuwave_torch-{family} <path-to-parameters-file>")
        say(f"Using default parameter file: {parameters_file}")
    else:
        say(f"Using parameter file from argument: {parameters_file}")
    say("===============================================")

    try:
        params = load_params(parameters_file)
    except (ParamError, FileNotFoundError, OSError) as e:
        print(f"Error while reading the parameter file:\n  {e}", file=sys.stderr)
        print("Hint: check that the file exists and matches the documented "
              "JSON schema (see parameters/*.json).", file=sys.stderr)
        return 1

    refusal = _shard_refusal(args, params)
    if refusal is not None:
        print(refusal, file=sys.stderr)
        return 1

    problem_name = f"{family}-{Path(parameters_file).stem}"
    n_ranks = shd.world_size()
    say(f"  Problem name: {problem_name}")
    say(f"  Backend: {device.type}, {n_ranks} device(s), "
        f"{n_ranks} process(es)")

    # an imported mesh is read here, so that a missing or malformed file
    # ends the run with the reader's one-line message (tpuwave's text)
    mesh = None
    if params.mesh_file is not None:
        try:
            mesh = read_mesh_file(params.mesh_file)
        except (ValueError, OSError) as e:
            print(e, file=sys.stderr)
            return 1

    solver_kwargs = {}
    if args.shard != "none":
        if params.mesh_file is None:
            mesh_ = (shd.device_mesh(shape=shd.blocks_shape(n_ranks))
                     if args.shard == "blocks" else shd.device_mesh())
            solver_kwargs["sharding"] = shd.grid_sharding(mesh_)
            say(f"  Sharding: {args.shard} over {n_ranks} device(s)")
        else:
            say(f"  (--shard {args.shard} ignored: only structured "
                "fast runs shard)")

    # export the reference's env channels for the duration of the run only
    env_save = {k: os.environ.get(k) for k in
                ("NMPDE_PARAM_FILE", "NMPDE_SAVE_SOLUTION", "NMPDE_LOG_EVERY")}
    os.environ["NMPDE_PARAM_FILE"] = str(parameters_file)
    os.environ["NMPDE_SAVE_SOLUTION"] = "1" if params.save_solution else "0"
    os.environ["NMPDE_LOG_EVERY"] = str(params.effective_log_every)

    try:
        from tpuwave_torch.models.fast_engine import resolve_engine
        try:
            solver, disc, reason = resolve_engine(
                params, family, args.engine,
                make_disc=lambda: make_discretization(params, dtype=dtype,
                                                      device=device,
                                                      mesh=mesh),
                mesh=mesh, precond=args.precond, solver=args.solver, dtype=dtype,
                device=device, **solver_kwargs)
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
            say(banner)
        elif reason is not None:
            if args.engine == "fast":
                print("--engine fast unavailable for this problem: "
                      f"{reason}\nHint: use --engine auto (falls back "
                      "to the parity engine) or --engine parity.",
                      file=sys.stderr)
                return 1
            say(f"  Engine: parity (fast engine ineligible: {reason})")
        if solver is None:
            from tpuwave_torch.models.newmark import NewmarkSolver
            from tpuwave_torch.models.theta import ThetaSolver
            cls = ThetaSolver if family == "theta" else NewmarkSolver
            solver = cls(disc, precond=args.precond)
        cfg = RunConfig(results_root=args.results_root,
                        mesh_root=args.mesh_root, quiet=args.quiet,
                        checkpoint_every=args.checkpoint_every,
                        resume=args.resume, phase_timing=args.phase_timing,
                        vtu_pieces=args.vtu_pieces)
        with trace(args.profile_dir):
            result = run_solver(solver, problem_name, cfg)
    finally:
        for k, v in env_save.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return 2 if result.diverged else 0
