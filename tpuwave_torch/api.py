"""One-call convenience API of the port.

    from tpuwave_torch import api
    result = api.solve("parameters/standing-mode-wsol.json",
                       family="newmark", device="cuda")

wraps params -> discretisation -> solver -> runner, the same pipeline
as the CLI entry points (tpuwave's api.py). ``device`` defaults to "cuda",
which raises where there is no card; ``device="cpu"`` runs the same code.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpuwave_torch.models.runner import RunConfig, RunResult, run_solver
from tpuwave_torch.utils.params import Params, load_params

__all__ = ["solve", "build_solver"]

#: the keyword arguments the fast engines take; any other routes
#: ``engine='auto'`` to the parity engine (tpuwave's build_solver contract)
_FAST_KWARGS = {"precond", "cheby_degree", "solver", "cheby_solver_degree",
                "mg_pre_degree", "mg_smooth_range"}


def build_solver(params: Params, family: str = "theta",
                 engine: str = "auto", *, dtype: torch.dtype = torch.float64,
                 device="cuda", **solver_kwargs):
    """Discretise and construct a stepper ('theta' or 'newmark').

    ``engine``: 'auto' (the fast grid-stencil engine whenever the problem
    is a structured P1/P2 rectangle it takes, else the parity engine),
    'fast' (require it; ValueError when ineligible) or 'parity' (the
    gather-path engine). Parity-only keyword arguments (e.g.
    ``lumped_explicit``) route 'auto' to the parity engine.
    """
    from tpuwave_torch.models.fast_engine import resolve_engine
    from tpuwave_torch.models.general import make_discretization
    from tpuwave_torch.models.newmark import NewmarkSolver
    from tpuwave_torch.models.theta import ThetaSolver

    if family not in ("theta", "newmark"):
        raise ValueError(f"Unknown solver family {family!r}")
    if engine == "auto" and set(solver_kwargs) - _FAST_KWARGS:
        engine = "parity"
    solver, disc, reason = resolve_engine(
        params, family, engine,
        make_disc=lambda: make_discretization(params, dtype=dtype,
                                              device=device),
        dtype=dtype, device=device, **solver_kwargs)
    if solver is not None:
        return solver
    if reason is not None and engine == "fast":
        raise ValueError(f"engine='fast' unavailable: {reason}")
    if family == "theta":
        return ThetaSolver(disc, **solver_kwargs)
    return NewmarkSolver(disc, **solver_kwargs)


def solve(parameters, family: str = "theta", *,
          problem_name: Optional[str] = None, overrides=None,
          config: Optional[RunConfig] = None, **solver_kwargs) -> RunResult:
    """Load parameters (path or dict), run the full simulation, return the
    RunResult (final state, errors, timings, output folder)."""
    params = load_params(parameters, overrides=overrides)
    solver = build_solver(params, family, **solver_kwargs)
    if problem_name is None:
        from pathlib import Path
        stem = (Path(params.source_path).stem if params.source_path
                else "case")
        problem_name = f"{family}-{stem}"
    return run_solver(solver, problem_name, config or RunConfig(quiet=True))
