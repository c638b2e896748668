"""Run-folder naming — API-compatible with the reference.

The sweep scripts *predict* the C++ run-folder names (reference
scripts/dissipation_dispersion_sweep.py:333-357), so the naming scheme is a
public contract:

    results/<problem>/run-R{r}-N{x}x{y}-dt{dt}-T{T}{method}/

with ``clean_double`` sanitising floats (fixed precision 6, trailing zeros
trimmed, '.' -> '_'; reference src/WaveEquationBase.cpp:433-452).
"""

from __future__ import annotations

from pathlib import Path

__all__ = ["clean_double", "run_folder_name", "mesh_file_name"]


def clean_double(x: float, precision: int = 6) -> str:
    """Format a float like the reference's clean_double
    (WaveEquationBase.cpp:433-452)."""
    s = f"{x:.{precision}f}"
    if "." in s:
        s = s.rstrip("0").rstrip(".")
    s = s.replace(".", "_")
    return s if s else "0"


def run_folder_name(results_root, problem_name: str, r: int,
                    nel, dt: float, t_final: float, method_params: str) -> Path:
    """Output folder path (reference WaveEquationBase.cpp:96-100).

    ``method_params`` is "-theta{θ}" for the theta family (WaveTheta.cpp:347)
    or "-gamma{γ}-beta{β}" for Newmark (WaveNewmark.cpp:286-288).
    """
    return Path(results_root) / problem_name / (
        f"run-R{r}-N{nel[0]}x{nel[1]}-dt{clean_double(dt)}"
        f"-T{clean_double(t_final)}{method_params}"
    )


def mesh_file_name(mesh_root, nel, geometry) -> Path:
    """Serial mesh snapshot filename (reference WaveEquationBase.cpp:53-57)."""
    (x0, y0), (x1, y1) = geometry
    return Path(mesh_root) / (
        f"rectangle-simplices-{nel[0]}x{nel[1]}-"
        f"{clean_double(x0, 2)}_{clean_double(x1, 2)}x"
        f"{clean_double(y0, 2)}_{clean_double(y1, 2)}.vtk"
    )
