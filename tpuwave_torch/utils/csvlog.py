"""CSV logging with reference-identical schemas and formatting.

All files are opened LAZILY on first write (reference
WaveEquationBase.cpp:133-134, 158-167), so log_every = 0 produces no files.

Formatting quirks of the C++ streams are reproduced byte-for-byte:

* default ostream double formatting == printf %.6g;
* ``error.csv``/``probe.csv`` set ``std::scientific << setprecision(p)``
  once while writing the first row, and stream flags PERSIST — so the
  ``time`` column is %.6g on the first data row and scientific afterwards;
* ``convergence.csv`` prints theta/beta/gamma via std::to_string
  (fixed 6 decimals) or "N/A".
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

__all__ = ["LazyCsv", "RunLogs", "fmt_g", "fmt_e", "to_string"]


def fmt_g(x: float) -> str:
    """C++ default ostream double formatting (6 significant digits)."""
    return f"{float(x):.6g}"


def fmt_e(x: float, precision: int = 6) -> str:
    """std::scientific << std::setprecision(precision)."""
    return f"{float(x):.{precision}e}"


def to_string(x: float) -> str:
    """C++ std::to_string(double): fixed, 6 decimals."""
    return f"{float(x):.6f}"


class LazyCsv:
    """A CSV file that is created on first append."""

    def __init__(self, path, header: str, append: bool = False,
                 enabled: bool = True):
        self.path = Path(path)
        self.header = header
        self.append = append
        self.enabled = enabled
        self._fh = None

    @property
    def is_open(self) -> bool:
        return self._fh is not None

    def _ensure_open(self):
        if self._fh is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            existed = self.path.exists()
            mode = "a" if self.append else "w"
            self._fh = open(self.path, mode)
            if not (self.append and existed):
                self._fh.write(self.header + "\n")

    def write_row(self, *fields):
        if not self.enabled:   # non-primary host: rank-0 file semantics
            return
        self._ensure_open()
        self._fh.write(",".join(str(f) for f in fields) + "\n")
        self._fh.flush()

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class RunLogs:
    """The per-run CSV set (energy/error/probe/iterations) plus the shared
    per-problem convergence.csv, with reference schemas
    (WaveEquationBase.cpp:143, 162, 214-220, 232, 259)."""

    def __init__(self, output_folder, convergence_path: Optional[Path] = None,
                 append: bool = False, enabled: bool = True):
        out = Path(output_folder)
        self.energy = LazyCsv(out / "energy.csv", "timestep,time,energy",
                              append=append, enabled=enabled)
        self.error = LazyCsv(
            out / "error.csv",
            "timestep,time,L2_error,H1_error,rel_L2_error,rel_H1_error",
            append=append, enabled=enabled)
        self.probe = LazyCsv(out / "probe.csv", "timestep,time,u_probe",
                             append=append, enabled=enabled)
        self.iterations = LazyCsv(out / "iterations.csv",
                                  "timestep,time,iterations_1,iterations_2",
                                  append=append, enabled=enabled)
        self.convergence = None
        if convergence_path is not None:
            self.convergence = LazyCsv(
                Path(convergence_path),
                "h,N_el_x,N_el_y,r,dt,T,method,theta,beta,gamma,"
                "rel_L2_error_final,rel_H1_error_final,elapsed_time_s",
                append=True, enabled=enabled)
        # stream-state emulation: time column switches to scientific after
        # the first row in files that set persistent manipulators (a resumed
        # run starts in the already-scientific state)
        self._error_sci = append
        self._probe_sci = append

    def log_energy(self, timestep: int, time: float, energy: float):
        self.energy.write_row(timestep, fmt_g(time), fmt_g(energy))

    def log_error(self, timestep: int, time: float,
                  l2: float, h1: float, rel_l2: float, rel_h1: float):
        tfmt = fmt_e(time, 6) if self._error_sci else fmt_g(time)
        self.error.write_row(timestep, tfmt, fmt_e(l2), fmt_e(h1),
                             fmt_e(rel_l2), fmt_e(rel_h1))
        self._error_sci = True

    def log_probe(self, timestep: int, time: float, u_probe: float):
        tfmt = fmt_e(time, 10) if self._probe_sci else fmt_g(time)
        self.probe.write_row(timestep, tfmt, fmt_e(u_probe, 10))
        self._probe_sci = True

    def log_iterations(self, timestep: int, time: float, it1: int, it2: int):
        self.iterations.write_row(timestep, fmt_g(time), int(it1), int(it2))

    def log_convergence(self, *, h: float, nel, r: int, dt: float, t_final: float,
                        problem_name: str, theta: Optional[float],
                        beta: Optional[float], gamma: Optional[float],
                        rel_l2: float, rel_h1: float, elapsed_s: float):
        """One row in the cross-run convergence.csv
        (WaveEquationBase.cpp:294-306)."""
        if self.convergence is None:
            return
        self.convergence.write_row(
            fmt_g(h), nel[0], nel[1], r, fmt_g(dt), fmt_g(t_final),
            problem_name,
            to_string(theta) if theta is not None else "N/A",
            to_string(beta) if beta is not None else "N/A",
            to_string(gamma) if gamma is not None else "N/A",
            fmt_e(rel_l2), fmt_e(rel_h1), f"{float(elapsed_s):.3f}")

    def close(self):
        for log in (self.energy, self.error, self.probe, self.iterations,
                    self.convergence):
            if log is not None:
                log.close()
