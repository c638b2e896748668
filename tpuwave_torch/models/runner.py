"""Run driver: the time loop + diagnostics/IO orchestration.

Host-side equivalent of the reference ``run()`` methods
(WaveTheta.cpp:341-447, WaveNewmark.cpp:280-491) and of tpuwave's
models/runner.py: time accumulation (``time += dt`` while ``time < T`` —
reproduced with the same float accumulation so step counts and time
stamps match bit-for-bit), divergence early-break at 1e130,
log_every/print_every cadence, per-step VTU output, and the final
convergence.csv row with wall-clock time. Folder names, CSV schemas and
console lines are tpuwave's; an imported mesh is reported (and, as in
tpuwave, gets no mesh VTK snapshot: its VTU pieces carry its own
triangulation).

Long runs: ``max_wall_s`` ends the time loop once that many wall-clock
seconds have passed (checked before each chunk and before each step;
``RunResult.timed_out``, no final errors and no convergence row), and
``checkpoint_every`` / ``resume`` snapshot the state every N steps and
continue from the newest snapshot in the run folder (utils/checkpoint.py,
tpuwave's file schema: a run checkpointed by either package resumes in the
other). A checkpointing or resumed run takes the per-step loop, as in
tpuwave: the chunked branch's chunk ends (256 steps, or the log points)
do not fall on the checkpoint cadence.

Ranks (parallel/sharding.py): a sharded engine (``solver.layout``) holds
one block of the state on each rank. Every rank runs the same loop and
makes the same collective calls (norms, energy, errors, probe, the
wall-clock check); only world rank 0 prints, writes the CSVs, the mesh
snapshot and the checkpoints (the state gathered to it), as only
tpuwave's process 0 does. With ``vtu_pieces=0`` each rank writes the
VTU piece of its own cells and rank 0 the ``.pvtu`` record (tpuwave's
``local_pieces``); a resumed rank keeps its block of the checkpoint.
"""

from __future__ import annotations

import math
import os
import shutil
import time as _time
from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from tpuwave_torch.config import env_flag_enabled
from tpuwave_torch.core.mesh import StructuredTriMesh
from tpuwave_torch.models.convert import like_state
from tpuwave_torch.parallel.sharding import world_rank
from tpuwave_torch.utils.checkpoint import (load_latest, save_checkpoint,
                                            truncate_logs_after)
from tpuwave_torch.utils.csvlog import RunLogs, fmt_e
from tpuwave_torch.utils.naming import mesh_file_name, run_folder_name
from tpuwave_torch.utils.profiling import PhaseTimer
from tpuwave_torch.utils.vtu import write_mesh_vtk, write_vtu_record

__all__ = ["RunConfig", "RunResult", "run_solver", "time_steps"]

DIVERGENCE_THRESHOLD = 1e130


@dataclass
class RunConfig:
    results_root: str = "results"
    mesh_root: str = "mesh"
    quiet: bool = False
    write_mesh: bool = True
    #: abort the time loop after this many wall-clock seconds (the sweeps'
    #: per-run timeout, harness.py). None = no limit.
    max_wall_s: Optional[float] = None
    #: snapshot the stepper state every N steps (0 = off)
    checkpoint_every: int = 0
    #: resume from the newest checkpoint in the run folder, if any
    resume: bool = False
    #: print a host-side per-phase wall-clock breakdown at the end
    phase_timing: bool = False
    #: number of VTU pieces per output record (row blocks of the mesh, the
    #: ``partitioning`` cell field = piece id); 0 = one per rank of a
    #: sharded run, each written by its rank (1 unsharded)
    vtu_pieces: int = 1


class RunResult(NamedTuple):
    state: object
    timestep_number: int
    final_time: float
    elapsed_s: float
    total_iterations_1: int
    total_iterations_2: int
    diverged: bool
    rel_l2: Optional[float]
    rel_h1: Optional[float]
    output_folder: Path
    timed_out: bool = False


def time_steps(t_final: float, dt: float):
    """The exact time stamps the reference's ``while (time < T)`` loop
    visits, including its float accumulation (WaveTheta.cpp:372-375)."""
    times = []
    t = 0.0
    while t < t_final:
        t += dt
        times.append(t)
    return times


class _Ranks:
    """What the run loop needs of a sharded engine's layout: global
    norms, the gathered state (checkpoints) and this rank's block of a
    restored one."""

    def __init__(self, solver):
        lay = getattr(solver, "layout", None)
        self.layout = lay if lay is not None and lay.sharded else None

    def norm(self, x) -> torch.Tensor:
        if self.layout is None:
            return torch.linalg.vector_norm(x)
        return self.layout.norm(x)

    def any(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is True on any."""
        if self.layout is None:
            return flag
        return float(self.layout.all_sum(
            torch.tensor(float(flag), dtype=torch.float64,
                         device=self.layout.device))) > 0.0

    def _grid_fields(self, state, fn):
        if self.layout is None or not hasattr(state, "_asdict"):
            return state
        n = self.layout.block_shape[0] * self.layout.block_shape[1]
        out = {}
        for k, v in state._asdict().items():
            if isinstance(v, torch.Tensor) and v.dim() == 1 \
                    and v.numel() == n:
                v = fn(v)
            out[k] = v
        return type(state)(**out)

    def gathered(self, state):
        """The state with every grid field gathered whole on rank 0 (None
        on the others)."""
        lay = self.layout

        def whole(v):
            full = lay.gather(v.reshape(lay.block_shape))
            return None if full is None else full.reshape(-1)
        return self._grid_fields(state, whole)

    def local_fields(self, fields: dict) -> dict:
        """A restored checkpoint's grid fields cut to this rank's block."""
        if self.layout is None:
            return fields
        lay = self.layout
        n = lay.shape[0] * lay.shape[1]
        return {k: (np.ascontiguousarray(lay.local(
                    np.asarray(v).reshape(lay.shape))).reshape(-1)
                    if np.ndim(v) == 1 and np.size(v) == n else v)
                for k, v in fields.items()}

    def cell_owner(self, nx: int, n_cells: int) -> np.ndarray:
        """Rank slot per cell of the structured mesh (cell 2 (j nx + i)
        + k is anchored at node (j, i))."""
        lay = self.layout
        anchor = np.arange(n_cells) // 2
        cj, ci = anchor // nx, anchor % nx
        iy = np.searchsorted([a for a, _ in lay.row_bounds], cj,
                             side="right") - 1
        ix = np.searchsorted([c for c, _ in lay.col_bounds], ci,
                             side="right") - 1
        return iy * len(lay.col_bounds) + ix


def run_solver(solver, problem_name: str,
               config: Optional[RunConfig] = None) -> RunResult:
    cfg = config or RunConfig()
    d = solver.disc
    p = d.params
    ranks = _Ranks(solver)
    primary = world_rank() == 0

    def pcout(*args):
        if not cfg.quiet and primary:
            print(*args)

    pcout("===============================================")
    pcout(f"Initializing the mesh\n  Number of elements = {d.mesh.n_cells}")
    pcout(f"Initializing the finite element space\n  Degree                     = {p.r}")
    pcout(f"Initializing the DoF handler\n  Number of DoFs = {d.n_dofs}")

    imported_mesh = p.mesh_file is not None
    if imported_mesh:
        pcout(f"  Mesh imported from {p.mesh_file}")
        if isinstance(d.mesh, StructuredTriMesh):
            pcout(f"  Recognised as a structured {p.nel[0]}x{p.nel[1]} "
                  "rectangle -> structured engines")
    if cfg.write_mesh and not imported_mesh and primary:
        if d.mesh.n_cells > 2_000_000:
            # bench-scale meshes: the serial VTK snapshot alone would be
            # ~100s of MB of host IO
            pcout("  (mesh VTK snapshot skipped: > 2M cells)")
        else:
            try:
                write_mesh_vtk(
                    mesh_file_name(cfg.mesh_root, p.nel, p.geometry),
                    d.mesh.vertex_coords, d.mesh.cells)
            except OSError:
                pass

    folder = run_folder_name(cfg.results_root, problem_name, p.r, p.nel,
                             p.dt, p.t_final, solver.method_params_suffix())
    folder.mkdir(parents=True, exist_ok=True)
    pcout(f"Output folder: {folder}/")

    # copy the parameter file for reproducibility
    # (reference WaveEquationBase.cpp:110-131 via NMPDE_PARAM_FILE)
    param_src = os.environ.get("NMPDE_PARAM_FILE") or p.source_path
    if primary and param_src and Path(param_src).exists():
        shutil.copyfile(param_src, folder / "parameters.json")

    restored = None
    if cfg.resume:
        restored = load_latest(folder)
        if restored is not None:
            pcout(f"Resuming from checkpoint at step {restored[0]}, "
                  f"t = {restored[1]}")
            # drop rows logged after the checkpoint so the resumed run
            # does not duplicate timesteps
            if primary:
                truncate_logs_after(folder, restored[0])
            restored = (restored[0], restored[1],
                        ranks.local_fields(restored[2]))

    convergence_path = None
    if p.has_exact_solution:
        convergence_path = Path(cfg.results_root) / problem_name / "convergence.csv"
    logs = (RunLogs(folder, convergence_path, append=restored is not None)
            if primary else _NoLogs())

    # env-variable overrides (reference main-theta.cpp:104-114)
    save_solution = env_flag_enabled("NMPDE_SAVE_SOLUTION", p.save_solution)
    log_every = p.effective_log_every
    env_log = os.environ.get("NMPDE_LOG_EVERY")
    if env_log is not None:
        try:
            log_every = int(env_log)
        except ValueError:
            pass

    # velocity accessor: displacement-form (2-term) solvers carry v
    # implicitly in the state pair and reconstruct it on demand
    # (models/fast_engine_2term.py::state_velocity); 3-array solvers
    # store it directly
    _sv = getattr(solver, "state_velocity", None)

    def state_v(st, t):
        return st.v if _sv is None else _sv(st, t)

    pcout("Setting initial conditions...")
    state = solver.initial_state()
    if restored is not None:
        state = like_state(state, restored[2])
    norm_u0 = float(ranks.norm(state.u))
    norm_v0 = float(ranks.norm(state_v(state, 0.0)))
    pcout(f"||u0|| = {norm_u0}")
    pcout(f"||v0|| = {norm_v0}")
    pcout("-----------------------------------------------")

    # sharded with vtu_pieces 0: one piece per rank, of its own cells
    rank_pieces = ranks.layout is not None and cfg.vtu_pieces <= 0
    n_pieces = (ranks.layout.size if rank_pieces
                else cfg.vtu_pieces if cfg.vtu_pieces > 0 else 1)

    # piece id per cell: contiguous row blocks of the structured mesh by
    # centroid y (or the cell's rank). Built lazily: only when VTU output
    # is written.
    _shard_cache = []

    def cell_shard():
        if not _shard_cache:
            if rank_pieces:
                _shard_cache.append(ranks.cell_owner(d.mesh.nx,
                                                     d.mesh.n_cells))
                return _shard_cache[0]
            coords = np.asarray(d.mesh.vertex_coords)
            cy = coords[np.asarray(d.mesh.cells), 1].mean(axis=1)
            y0, y1 = coords[:, 1].min(), coords[:, 1].max()
            _shard_cache.append(np.minimum(
                (np.maximum(cy - y0, 0.0) / max(y1 - y0, 1e-300)
                 * n_pieces).astype(np.int64), n_pieces - 1))
        return _shard_cache[0]

    def output(timestep: int, t: float):
        if not save_solution:
            return
        # (sharded: vertex_values gathers, a call every rank makes)
        point_data = {"u": d.vertex_values(state.u),
                      "v": d.vertex_values(state_v(state, t))}
        if p.has_exact_solution:
            point_data["u_exact"] = d.vertex_values(
                d.interpolate(p.solution, t))
        if not (primary or rank_pieces):
            return
        write_vtu_record(folder, "solution", timestep, d.mesh.vertex_coords,
                         d.mesh.cells, point_data, cell_shard=cell_shard(),
                         only_pieces=({ranks.layout.index} if rank_pieces
                                      else None),
                         write_record=primary)

    timestep_number = 0
    current_time = 0.0
    if restored is None:
        output(0, 0.0)

    total_it1 = total_it2 = 0
    current_energy = 0.0
    diverged = False
    timed_out = False
    times = time_steps(p.t_final, p.dt)
    if restored is not None:
        timestep_number, current_time = restored[0], restored[1]
        times = times[timestep_number:]

    phases = PhaseTimer(enabled=cfg.phase_timing)

    start = _time.perf_counter()

    def out_of_time() -> bool:
        nonlocal timed_out
        # (sharded: every rank takes the same decision)
        if cfg.max_wall_s is not None and ranks.any(
                _time.perf_counter() - start > cfg.max_wall_s):
            pcout(f"Wall-clock limit {cfg.max_wall_s}s exceeded at step "
                  f"{timestep_number}; aborting run.")
            timed_out = True
        return timed_out

    # Chunked branch: when the host needs nothing per step beyond CSV rows
    # (no VTU output, no checkpoints), steps run in chunks through
    # solver.run_steps / run_steps_diag, whose per-step norms (and, at
    # log_every == 1, the diagnostics) come back to the host once per
    # chunk — the same trajectory, CG counts, console cadence and CSV
    # bytes as the per-step loop. The wall-clock limit is checked between
    # chunks, so it can overshoot by one chunk.
    scan_ok = (not save_solution and cfg.checkpoint_every == 0
               and restored is None and not cfg.phase_timing)
    if scan_ok and log_every >= 0 and hasattr(solver, "run_steps"):
        with_diag = log_every == 1
        #: log_every > 1: chunks end exactly at log points, where
        #: energy/errors/probe run once on the host side
        host_diag = log_every > 1
        has_sol = p.has_exact_solution

        def diag_fn(st, t):
            out = {"energy": d.energy(st.u, state_v(st, t)),
                   "probe": d.probe(st.u)}
            if has_sol:
                out["err"] = torch.stack(d.errors(st.u, t))
            return out

        chunk_len = 256
        i = 0
        while i < len(times):
            if out_of_time():
                break
            if host_diag:
                until_log = log_every - (timestep_number % log_every)
                chunk = times[i:i + min(until_log, chunk_len)]
            else:
                chunk = times[i:i + chunk_len]
            if with_diag:
                state, infos = solver.run_steps_diag(state, chunk, diag_fn)
            else:
                state, infos = solver.run_steps(state, chunk)
            it1 = infos["iterations_1"]
            it2 = infos["iterations_2"]
            nu = infos["norm_u"]
            nv = infos["norm_v"]
            if with_diag:
                en = infos["energy"]
                pr = infos["probe"]
                err = infos["err"] if has_sol else None
            n_ok = len(chunk)
            bad = False
            for j in range(len(chunk)):
                if d.check_divergence(float(nu[j]), float(nv[j]),
                                      DIVERGENCE_THRESHOLD):
                    n_ok, bad = j + 1, True
                    break
            total_it1 += int(it1[:n_ok].sum())
            total_it2 += int(it2[:n_ok].sum())
            # the host loop breaks BEFORE logging/printing the diverged step
            for j in range(n_ok - 1 if bad else n_ok):
                ts_no = timestep_number + j + 1
                tj = float(chunk[j])
                if with_diag:
                    current_energy = float(en[j])
                    logs.log_energy(ts_no, tj, current_energy)
                    if has_sol:
                        logs.log_error(ts_no, tj,
                                       *(float(x) for x in err[j]))
                    logs.log_probe(ts_no, tj, float(pr[j]))
                    logs.log_iterations(ts_no, tj, int(it1[j]),
                                        int(it2[j]))
                elif host_diag and j == n_ok - 1 and not bad \
                        and ts_no % log_every == 0:
                    # full aligned chunk: its final state IS the log-point
                    # state (the partial last chunk of a non-divisible run
                    # ends off-cadence and logs nothing, like the per-step
                    # loop)
                    current_energy = float(d.energy(state.u,
                                                    state_v(state, tj)))
                    logs.log_energy(ts_no, tj, current_energy)
                    if has_sol:
                        logs.log_error(ts_no, tj,
                                       *(float(x) for x in
                                         d.errors(state.u, tj)))
                    logs.log_probe(ts_no, tj, float(d.probe(state.u)))
                    logs.log_iterations(ts_no, tj, int(it1[j]),
                                        int(it2[j]))
                if ts_no % p.print_every == 0:
                    line = (f"Step {ts_no:6d},  t={tj:9.3e}"
                            f",  ||u||={float(nu[j]):9.3e}"
                            f",  ||v||={float(nv[j]):9.3e}")
                    if log_every > 0:
                        line += f",  E={current_energy:9.3e}"
                    pcout(line)
            timestep_number += n_ok
            current_time = float(chunk[n_ok - 1])
            if bad:
                # NB: state is end-of-chunk, not at the diverged step; a
                # diverged run's final errors are garbage either way, as in
                # the reference.
                pcout(f"Divergence detected at step {timestep_number}, "
                      f"t = {current_time}; stopping simulation.")
                diverged = True
                break
            i += n_ok
        times = []   # the per-step loop below is skipped

    for t in times:
        if out_of_time():
            break
        current_time = t
        timestep_number += 1
        with phases.phase("step"):
            state, info = solver.step(state, t)
            it1 = int(info["iterations_1"])
            it2 = int(info["iterations_2"])
            norm_u = float(info["norm_u"])
            norm_v = float(info["norm_v"])
        total_it1 += it1
        total_it2 += it2

        if d.check_divergence(norm_u, norm_v, DIVERGENCE_THRESHOLD):
            pcout(f"Divergence detected at step {timestep_number}, "
                  f"t = {current_time}; stopping simulation.")
            diverged = True
            break

        if log_every > 0 and timestep_number % log_every == 0:
            with phases.phase("diagnostics"):
                current_energy = float(d.energy(
                    state.u, state_v(state, current_time)))
                logs.log_energy(timestep_number, current_time, current_energy)
                if p.has_exact_solution:
                    l2, h1, rl2, rh1 = (float(x) for x in
                                        d.errors(state.u, current_time))
                    logs.log_error(timestep_number, current_time,
                                   l2, h1, rl2, rh1)
                logs.log_probe(timestep_number, current_time,
                               float(d.probe(state.u)))
                logs.log_iterations(timestep_number, current_time, it1, it2)

        if timestep_number % p.print_every == 0:
            line = (f"Step {timestep_number:6d},  t={current_time:9.3e}"
                    f",  ||u||={norm_u:9.3e},  ||v||={norm_v:9.3e}")
            if log_every > 0:
                line += f",  E={current_energy:9.3e}"
            pcout(line)

        if cfg.checkpoint_every > 0 and \
                timestep_number % cfg.checkpoint_every == 0:
            whole = ranks.gathered(state)
            if primary:
                save_checkpoint(folder, timestep_number, current_time, whole)

        with phases.phase("output"):
            output(timestep_number, current_time)

    elapsed = _time.perf_counter() - start
    if cfg.phase_timing:
        pcout(phases.report())

    pcout(f"\nSimulation completed: {timestep_number} steps, "
          f"final time t = {current_time}")
    pcout(f"Elapsed time: {elapsed:.3f} seconds")
    avg1 = total_it1 / timestep_number if timestep_number else 0.0
    pcout(f"Total CG iterations (1): {total_it1}, avg per step: {avg1:.1f}")
    if total_it2:
        avg2 = total_it2 / timestep_number if timestep_number else 0.0
        pcout(f"Total CG iterations (2): {total_it2}, avg per step: {avg2:.1f}")

    rel_l2 = rel_h1 = None
    if p.has_exact_solution and not timed_out:
        _, _, rl2, rh1 = (float(x) for x in d.errors(state.u, current_time))
        rel_l2, rel_h1 = rl2, rh1
        is_theta = solver.method_name == "theta"
        h = 1.0 / math.sqrt(p.nel[0] * p.nel[1])
        logs.log_convergence(
            h=h, nel=p.nel, r=p.r, dt=p.dt, t_final=p.t_final,
            problem_name=problem_name,
            theta=p.theta if is_theta else None,
            beta=None if is_theta else p.beta,
            gamma=None if is_theta else p.gamma,
            rel_l2=rl2, rel_h1=rh1, elapsed_s=elapsed)
        pcout("Final (last-iteration) errors:")
        pcout(f"  Relative L2 error  = {fmt_e(rl2)}")
        pcout(f"  Relative H1 error  = {fmt_e(rh1)}")

    logs.close()
    return RunResult(state=state, timestep_number=timestep_number,
                     final_time=current_time, elapsed_s=elapsed,
                     total_iterations_1=total_it1, total_iterations_2=total_it2,
                     diverged=diverged, rel_l2=rel_l2, rel_h1=rel_h1,
                     output_folder=folder, timed_out=timed_out)


class _NoLogs:
    """The CSV logs of a rank other than 0: every call does nothing."""

    def __getattr__(self, name):
        return lambda *args, **kwargs: None
