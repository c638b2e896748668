"""Shared experiment-harness infrastructure for the sweep scripts.

tpuwave's harness (tpuwave/harness.py), the in-process equivalent of the
reference's subprocess+mpirun plumbing (scripts/convergence_sweep.py,
dissipation_dispersion_sweep.py, scalability_sweep.py): the same scheme
definitions, CFL filter, run-folder prediction and CSV schemas, with runs
as direct library calls on the port's parity engine
(``make_discretization`` + ``ThetaSolver`` / ``NewmarkSolver``). A run's
tensors live on ``device`` (default "cuda", which raises where there is no
card) in ``dtype``.
"""

from __future__ import annotations

import math
import time
import traceback
from typing import Dict, Optional, Tuple

import torch

from tpuwave_torch.config import resolve_device
from tpuwave_torch.models.general import make_discretization
from tpuwave_torch.models.newmark import NewmarkSolver
from tpuwave_torch.models.runner import RunConfig, RunResult, run_solver
from tpuwave_torch.models.theta import ThetaSolver
from tpuwave_torch.utils.naming import clean_double, run_folder_name
from tpuwave_torch.utils.params import load_params

__all__ = ["SCHEME_DEFS", "cfl_limit", "is_cfl_safe", "predict_run_folder",
           "run_case", "PARAM_STEM"]

#: the five benchmark schemes (reference convergence_sweep.py:104-133)
SCHEME_DEFS: Dict[str, Dict] = {
    "theta-0.0": {"family": "theta", "overrides": {"Theta": "0.0"}, "explicit": True},
    "theta-0.5": {"family": "theta", "overrides": {"Theta": "0.5"}, "explicit": False},
    "theta-1.0": {"family": "theta", "overrides": {"Theta": "1.0"}, "explicit": False},
    "newmark-0.00": {"family": "newmark",
                     "overrides": {"Beta": "0.0", "Gamma": "0.5"}, "explicit": True},
    "newmark-0.25": {"family": "newmark",
                     "overrides": {"Beta": "0.25", "Gamma": "0.5"}, "explicit": False},
}

#: fixed parameter stem so results land in {theta,newmark}-conv-params/
#: exactly like the reference (convergence_sweep.py:99-103)
PARAM_STEM = "conv-params"


def cfl_limit(nel: int, r: int, c: float = 1.0, cfl_safety: float = 0.9) -> float:
    """Conservative explicit-CFL limit (reference convergence_sweep.py:139-147):
    0.9 * h / (c sqrt(2) p_factor), p_factor = 4 for r = 2."""
    h = 1.0 / nel
    p_factor = 1.0 if r == 1 else 4.0
    return cfl_safety * h / (c * math.sqrt(2.0) * p_factor)


def is_cfl_safe(scheme_name: str, nel: int, r: int, dt: float,
                cfl_safety: float = 0.9) -> bool:
    if not SCHEME_DEFS[scheme_name]["explicit"]:
        return True
    return dt <= cfl_limit(nel, r, cfl_safety=cfl_safety)


def predict_run_folder(nel: int, r: int, dt: float, t_final: float,
                       scheme_name: str) -> str:
    """Run-subfolder name for a sweep case (the naming contract the
    reference scripts replicate, dissipation_dispersion_sweep.py:333-357)."""
    sdef = SCHEME_DEFS[scheme_name]
    if sdef["family"] == "theta":
        method = "-theta" + clean_double(float(sdef["overrides"]["Theta"]))
    else:
        method = ("-gamma" + clean_double(float(sdef["overrides"]["Gamma"])) +
                  "-beta" + clean_double(float(sdef["overrides"]["Beta"])))
    return run_folder_name("", "", r, (nel, nel), dt, t_final, method).name


def run_case(scheme_name: str, base_param_path, overrides: Dict, *,
             results_root: str, timeout_s: Optional[float] = None,
             quiet: bool = True, device="cuda",
             dtype: torch.dtype = torch.float64,
             ) -> Tuple[int, float, Optional[RunResult]]:
    """Run one sweep case in-process.

    Returns (code, elapsed_s, result): code 0 = OK (including divergence,
    which the reference binary also exits 0 on after its early break),
    -1 = wall-clock timeout, 1 = exception (its traceback printed). The
    device is resolved first: a missing card raises instead of counting
    as a failed case.
    """
    device = resolve_device(device)
    sdef = SCHEME_DEFS[scheme_name]
    overrides = {**sdef["overrides"], **overrides}
    t0 = time.perf_counter()
    try:
        params = load_params(base_param_path, overrides=overrides)
        disc = make_discretization(params, dtype=dtype, device=device)
        solver = (ThetaSolver(disc) if sdef["family"] == "theta"
                  else NewmarkSolver(disc))
        cfg = RunConfig(results_root=results_root, quiet=quiet,
                        write_mesh=False, max_wall_s=timeout_s)
        result = run_solver(solver, f"{sdef['family']}-{PARAM_STEM}", cfg)
        elapsed = time.perf_counter() - t0
        if result.timed_out:
            return -1, elapsed, result
        return 0, elapsed, result
    except Exception:  # noqa: BLE001 — sweep robustness
        traceback.print_exc()
        return 1, time.perf_counter() - t0, None
