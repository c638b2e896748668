#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (tpuwave_torch).

Run from the repository root, with one NVIDIA GPU (Hopper, sm_90a) and the
CUDA toolkit's nvcc:

    python3 chip_smoke.py

(``--only kernels,fwi_kernels`` runs phases 1, 2 and the named phase
functions alone; with ``--kernels-from DIR`` they time the kernels of
another checkout, e.g. an unpacked earlier commit.)

It builds the port's hand-written kernels from tpuwave_torch/csrc, checks
each against its plain PyTorch version, then drives the port's main
paths through the entry points a user calls. Path A: the explicit leapfrog
of FastWaveSolver at bench.py's configuration (4096^2 elements, f32) and
both CLIs on the reference's scalability configuration (standing mode,
640^2 elements, dt 8e-5). Path B: the implicit solver family of the CLIs
(--solver 2term|cheby, --precond mg|auto|chebyshev), up to the 2-term
MG run at 2048^2 elements. Path C: the R = 2 (P2) engine of the CLIs on
plane canvases, up to the 2-term MG run at 1024^2 elements (4.2 M DoF,
the DoF count of phase 8) and an f32 run at 4096^2 (67 M DoF). Path D:
FastWaveSolver's implicit family (run_scan, run_implicit_mg,
run_implicit_kernel, run_implicit_mg_kernel, run_implicit_cheby and the
2-term chain) at scripts/bench_implicit_mg.py's size, 4096^2 elements
(16.8 M DoF), f32, dt 1e-3, 20 steps. Path E: the differentiable FWI
propagator (FwiProblem's kernel engine with the time-reversal adjoint:
simulate, misfit_and_grad and invert) at scripts/bench_fwi_adjoint.py's
configuration, 1024^2 elements, f32. Path F: the driven explicit leapfrog
(run_leapfrog_driven, run_leapfrog_driven_kernel on B1,
run_leapfrog_driven_multistep on B6) at scripts/bench_driven.py's
configuration, 4096^2 elements, f32, and both CLIs with a spatially
varying and with a time-dependent wave speed at R = 1. Path G: the R = 2
engines of the CLIs with a spatially varying and with a time-dependent
wave speed (the varcoef K in torch ops, the mass part and every mass solve
on B11, the frozen mg V-cycle on B12 / B13 and B4 / B3), up to 1024^2
elements (4.2 M DoF) against tpuwave. Path H: the parity (gather-path)
engine of the CLIs (--engine parity: ops/operators.py's matvecs in torch
ops, the mg V-cycle's P1 levels on B4 / B3) at Nel 24 and at BASELINE.md's
640^2. Path I: imported meshes (Mesh File Name): the reference's default
mesh (recognised as the 40 x 40 rectangle: the fast engine, B4 / B3 with
--precond mg) and perturbed meshes on the parity engine up to 640^2.
Path J: the run surface (checkpoint / resume, --profile-dir and the
wall-clock limit of the runner and both CLIs, harness.run_case) at
640^2 and the sweep scripts (scripts/torch_*.py) at the reference's own
sizes (``--only run_surface,sweeps`` runs it alone). Path K: the rest of
FWI (FwiProblem's imaging, encoded supershots and optimizers) at
scripts/bench_imaging.py's configuration (512^2 elements, 1000 steps, 8
shots, f32) and at the defaults of the FWI and imaging scripts in f64
against tpuwave's values (``--only imaging,fwi_optim`` runs it alone).
Path L: the paths only tpuwave's bench scripts reach, at their 4096^2
sizes: models/fast_p2.py's P2CanvasSolver (B11-B13, B4 / B3) and its
2-term recurrence, the P2 solvers in f64 against tpuwave's values, and
scripts/bench_precision.py's rows: the compensated f32 leapfrog and
2-term paths (B3, B4) held to tpuwave's accuracy gates, and the f64
implicit CN 2-term MG run (``--only p2_bench,precision`` runs it alone).
Path M: domain decomposition (parallel/sharding.py, parallel/halo.py):
2 and 4 ranks over gloo sharing the one card, and over NCCL at one card a
rank where there are two cards or more, started by torch.distributed.run
(``--only shard`` runs it alone).
Phases:

  1. the card: nvidia-smi name and power limit; a CUDA device is required
  2. build the kernels (one nvcc per source, in parallel), print the build
     time and ptxas's registers, shared memory and spills per kernel
  3. each kernel against its plain version at the main paths' shapes, with
     its time, its bound (the least time the card could take: bytes over
     3.35 TB/s or operations over the dtype's peak) and the share reached;
     the launch-and-event floor (an empty kernel), against which the small
     grids' rows read
  4. the leapfrog: 320 steps through kernel B1 and through kernel B2
     (k = 8 and k = 32), each against the plain loop; DoF*steps/s
  5. both CLIs (newmark beta 1/4, theta 1/2), 10 steps on --device cuda and
     on --device cpu: CSVs and per-step CG counts must agree
  6. the full-length newmark run (T = 0.05) on cuda: wall time, and its
     final relative L2 error against tpuwave's value for the same run
  7. the solver family, 3 steps at 640^2 on --device cuda and on --device
     cpu: CSVs and per-step counts must agree, and the cuda runs must
     launch B3, B4 and (2-term) B5
  8. newmark beta 1/4 --solver 2term --precond mg at 2048^2 elements
     (4.2 M DoF), dt 4e-3, T 0.2 on cuda: wall time, DoF*steps/s, CG
     iterations, and the final relative L2 error against tpuwave's
  9. where the time of path B goes (torch.profiler): launches and device
     time of one V-cycle at 2049^2, and the device's idle share over a
     2-term MG CLI run
 10. the R = 2 solver family, standing mode, 160^2 elements, 3 steps, on
     --device cuda and on --device cpu: CSVs agree and per-step CG counts
     are equal; the cuda runs launch B11 (and B12, B13, B4, B3 with mg)
 11. newmark beta 1/4 --solver 2term --precond mg at R = 2, 1024^2
     elements (4.2 M DoF), dt 4e-3, T 0.2 on cuda: wall time, ms/step,
     DoF*steps/s, CG iterations, and the final relative L2 error against
     tpuwave's
 11b. newmark --f32 --precond mg at R = 2, 4096^2 elements (67 M DoF),
     dt 4e-3, 10 steps on cuda: ms/step, CG iterations, peak device memory
 12. where the time of path C goes (torch.profiler): launches and device
     time of one P2 V-cycle at 1024^2, and the device's idle share over
     phase 10's 2-term MG run
 13. FastWaveSolver's implicit family at 640^2, f64, dt 4e-3, 3 steps,
     schemes theta 1, theta 1/2, newmark beta 1/4, every run_* path on
     device="cuda" against device="cpu": u agrees to rel 1e-9, v to 1e-9
     (Newmark) or 1e-5 (theta), and the per-solve iteration counts are
     equal (within 1 on theta's Jacobi-CG paths)
 14. the same family at 4096^2 elements, f32, dt 1e-3, 20 steps (the
     defaults of scripts/bench_implicit_mg.py): run_implicit_mg (torch
     ops), run_implicit_mg_kernel (B7-B10, B3, B4) and the 2-term path
     (B5, B3, B4), each timed once after a warm run: ms/step, iterations
     per step, peak device memory, the difference of u between the paths,
     the error against the analytic standing mode
 15. run_implicit_mg_kernel at 1024^2, f64, dt 4e-3, 20 steps,
     cg_reduction 1e-12: ||u|| and the relative L2 error against the
     analytic solution equal tpuwave's run_implicit_mg values
 16. FwiProblem at (48, 40) elements, dt 2e-3, 96 steps, f64, hard walls
     and sponge ring, nearest and interpolated receivers: the kernel
     engine on cuda against the CPU's plain run (traces and misfit rtol
     1e-12, c2 and wavelet gradients rtol 1e-9)
 17. FwiProblem at 1024^2 elements, dt 2e-4, 2000 steps, f32, hard
     walls and sponge ring: simulate and misfit_and_grad on the kernel
     engine (B14-B17) and on the stencil engine (torch ops), the kernel
     engine's gradient against the f64 stencil engine's, 3 Adam
     iterations of invert, peak device memory, one torch.profiler trace of
     misfit_and_grad (device-busy share, each FWI kernel's share of the
     device time); a 256^2 f64 run against tpuwave's misfit and gradient
     norm
 18. the driven leapfrog at scripts/bench_driven.py's defaults (4096^2
     elements, f32, dt 8e-5, 64 steps, its strip drive g = sin(4 pi t) on
     y = 0, x <= 1/3, and its forcing): run_leapfrog_driven (torch ops),
     run_leapfrog_driven_kernel with and without forcing (B1) and
     run_leapfrog_driven_multistep at k = 8, 16, 32 (B6): us/step,
     DoF*steps/s, launches per run, B6's edge tables' share of its legs,
     each kernel leg's end state within rel L2 1e-5 of the torch-ops
     leg's; then 64 steps at 1024^2 f64 on B6 (k = 8): ||u||
     equal to tpuwave's at rtol 1e-10
 19. both CLIs (newmark beta 1/4, theta 1/2) at 160^2 elements, 3 steps,
     with a spatially varying C and with a time-dependent C, --precond
     jacobi and mg, on --device cuda and on --device cpu: CSVs agree,
     per-step CG counts are equal, the mg runs launch B4 and B3
 20. both CLIs (newmark beta 1/4, theta 1/2) at R = 2, 160^2 elements, 5
     steps, f64, with a spatially varying and with a time-dependent C,
     --precond jacobi and mg, and newmark --solver 2term --precond mg with
     the varying C, on --device cuda and on --device cpu: CSVs agree,
     per-step CG counts are equal, every run launches B11 and the mg runs
     B12, B13, B4 and B3
 21. R = 2 at 1024^2 elements (4.2 M DoF), f64, dt 4e-3, 10 steps, Log
     Every 1, on cuda: (a) newmark beta 1/4 --solver 2term --precond mg
     with the varying C, (b) theta 1/2 --precond mg with the
     time-dependent C: wall time, ms/step, CG iterations per step, peak
     device memory, B11-B13 launches per step; per-step CG counts equal
     tpuwave's and the last CSV rows within rtol 1e-8 of tpuwave's (its
     CPU run; error norms within 1e-11 of the solution's norm); then one step of (b) under torch.profiler: the device-busy
     share, the varcoef apply's share (torch ops) and B11-B13's

 22. both CLIs on the parity engine at Nel 24, 3 steps, f64, Log Every 1:
     theta 1/2 jacobi, theta 1 mg, newmark 1/4 chebyshev, newmark 1/4
     jacobi with a time-dependent C, theta 1/2 on a forcing preset, and at
     R = 2 theta 1/2 mg and newmark 1/4 chebyshev with a varying C, on
     --device cuda and on --device cpu: CSVs agree, per-step CG counts are
     equal, the mg runs launch B4 and B3, and a second cuda run of each mg
     case (through api.build_solver) is bitwise equal to the first
 23. the parity engine at 640^2 (410,881 DoF), f64, on cuda: (a) phase
     6's file (newmark beta 1/4, dt 8e-5, T 0.05, logging off): the final
     relative L2 error within 1e-6 of tpuwave's and the CG total equal to
     phase 6's; (b) theta 1/2 --precond mg, (c) R = 2 at Nel 320 (the same
     DoF) newmark beta 1/4 --precond mg, dt 1e-2, 10 steps, Log Every 1,
     each against the fast engine on the same file: per-step CG counts
     equal, last CSV rows within rtol 1e-10 plus one unit in the last
     printed digit, B4 and B3 launched; ms/step, peak device memory and
     launches per step of each run; then one step of (a) and one of (b)
     under torch.profiler: the device-busy share, the top device ops, and
     the shares of the gather and the gather-sum
 24. imported meshes (Mesh File Name), f64, Log Every 1: (a) the
     reference's default mesh/mesh-square-40.msh through newmark --precond
     mg on cuda: recognised as the 40 x 40 rectangle (the fast engine),
     CSVs byte-equal to the Nel 40 run's, B4 and B3 launched; (b) a
     perturbed Nel 24 mesh at R = 1 and 2 (theta 1/2 chebyshev, newmark
     1/4 jacobi, one with a time-dependent C), 3 steps on the parity
     engine, --device cuda against --device cpu: CSVs agree, per-step CG
     counts equal, run_steps states within 1e-12, a second cuda run
     bitwise equal; (c) api.solve on perturbed meshes (newmark 1/4 jacobi
     at Nel 64, theta 1/2 chebyshev at R = 2 Nel 32): the final relative
     L2 error within 1e-6 of tpuwave's and the CG totals equal to its
 25. a perturbed 640^2 mesh (410,881 vertices, 819,200 triangles) written
     by write_msh: the write and parse times and the setup; (a) phase 6's
     file on it (newmark beta 1/4 jacobi, dt 8e-5, T 0.05, --engine
     parity): ms/step, peak device memory, the final relative L2 error
     within 1e-6 of tpuwave's and the CG total equal to its, and the
     first 2 steps against the cpu (CG counts equal, states within 1e-9);
     (a') the same with a time-dependent C, 10 steps; (b) R = 2 at Nel
     320, theta 1/2 chebyshev, 3 steps: per-step CG counts equal to
     tpuwave's, the final relative L2 error within 1e-6 of its, and cuda
     against cpu; then one step of (a) under torch.profiler: the
     device-busy share and the top device ops
 26. the run surface at 640^2, f64, dt 8e-5, 50 steps, Log Every 5, on
     cuda: (a) three CLI runs (--engine auto newmark beta 1/4; newmark
     --solver 2term --precond mg; --engine parity theta 1/2 with a
     time-dependent C, whose state carries k_payload), each with
     --checkpoint-every 25 and resumed (--resume) from its middle
     checkpoint copied into a fresh folder: the CSV rows after the
     checkpoint byte-equal (the convergence row but its wall time), the
     last checkpoints bitwise equal; the first also without checkpoints
     (the chunked branch): its rows byte-equal to the checkpointing
     run's; ms/step of each; (b) the first resume
     again with --profile-dir: the trace parses, names a port kernel and
     leaves the CSVs unchanged; (c) harness.run_case with timeout_s 1 on
     a 12500-step run: code -1, timed_out, the CSVs ending at the step
     where the run stopped
 27. the sweeps through scripts/torch_*.py on cuda: (a) convergence at
     Nel 320, R = 1 and 2, T 1, five schemes (dt 0.02 and 0.01 implicit,
     0.001 explicit; the CFL filter drops explicit R = 2): each row's
     final rel L2 / H1 within rtol 1e-6 (plus one unit in the last printed
     digit) of tpuwave's or a blowup on both sides, tpuwave's pinned from
     CPU runs of the JAX package; compare_with_reference.py's summary
     against analysis/data/convergence-results.csv, reported; (b)
     dissipation at its defaults (Nel 60, T 5, Log Every 1) with dt >=
     0.005 (every scheme at 0.15, 0.1 and 0.05, where the CFL filter drops
     the explicit ones, and Newmark beta 0 at 0.005):
     dissdisp-results.csv rows against tpuwave's pinned rows, the
     same way; the compare tool against analysis/data/dissdisp-results.csv,
     reported; (c) scalability at its defaults (640^2, dt 8e-5, f32, five
     schemes) but 250 steps (--T 0.02) and --repeats 1: seconds and
     DoF*steps/s per scheme,
     the CSV schema; (d) acceptance, --t-max 0.05, 12 presets x 2
     families: every run exits 0 with its artifacts; final errors printed
     beside analysis/data/acceptance-summary.csv's
 28. imaging at scripts/bench_imaging.py's defaults (512^2 elements, dt
     4e-4, 1000 steps, 8 shots at y = 0.1, 9 receivers at y = 0.9, f32,
     stencil engine, reversal adjoint), each timed once after a warm run:
     the sequential gradient per shot x 8, the encoded gradient (one
     supershot), one LSRTM iteration (born + migrate per shot x 8) and
     migrate of shot 0 on the kernel engine (B14-B17); gates: (a) the f64
     dot-product test <born dm, d> = <dm, migrate d> of shot 0, migrate on
     the stencil and on the kernel engine, rel 1e-9; (b) the f32
     supershot against the coded sum of the f32 single shots, within 2x
     its rel L2 gap to the f64 supershot; both with the receivers at y =
     0.3 (no wave reaches y = 0.9 by t = 0.4)
 29. f64 against tpuwave's values (pinned from CPU runs of the JAX
     package), rtol 1e-6: imaging_showcase.py's defaults (||born||,
     ||rtm_image||, lsrtm's 11 residual norms); at fwi_demo.py's defaults
     invert_gauss_newton (3 x 3) and invert_encoded (4 shots, key 0, 5
     iterations) on its stencil engine with the remat adjoint, and 5
     L-BFGS iterations with bounds on the kernel engine; fwi_showcase.py's
     multiscale inversion with the illumination preconditioner, 3 + 3
     iterations, on the kernel engine; then the grid engine with the
     remat adjoint at 256^2 against the kernel engine's reversal
     gradient, rel 1e-9
 30. the P2 bench solvers (models/fast_p2.py): (a) P2CanvasSolver at
     scripts/bench_p2_mg.py's defaults (4096^2 elements, 67 M DoF, f32,
     Newmark 1/4, dt 1e-3, 10 steps, mg and jacobi, then the 2-term
     recurrence, 9 steps; B11 every canvas apply, B12 / B13 and B4 / B3
     the mg V-cycle): ms/step, DoF*steps/s, CG iterations, the mg against
     jacobi and 2-term against 3-term end-state differences; (b) f64
     against tpuwave's pinned CPU runs: P2FastSolver 200^2 theta 1/2 mg,
     P2CanvasSolver 256^2 Newmark 1/4 mg and its 2-term recurrence,
     per-step CG counts equal and norms within rtol 1e-10
 31. scripts/bench_precision.py's rows at 4096^2 (explicit at its 64
     steps, implicit cut to 16): the f32, compensated f32 and f64
     leapfrogs; driven CN through the 2-term MG engine in f32 and in f64
     (B5, B3, B4; the f64 row the TPU could not run); the compensated f32
     2-term recurrence, driven and standing (B3, B4 / B3); gates from one
     f32 start: compensated leapfrog ec < ep / 10 and head < 2 ep, the
     compensated 2-term ec < ep / 8; the compensated driven 2-term
     within 3e-6 of the f64 engine at tpuwave's gate size (24^2, 20
     steps; the 4096^2 difference reported)
 32. sharding: B3 at global offsets on a rank's padded block against its
     plain version; (a) 2 and 4 gloo ranks on the one card: the
     scalability configuration (640^2, dt 8e-5, f64, 10 steps) for theta
     0, 1/2, 1 and Newmark 0, 1/4 over row slabs and Newmark 1/4 over 2 x
     2 blocks, each within rel L2 1e-12 of the one-rank run with equal CG
     counts, ms/step beside the one-rank run's; the newmark CLI --shard
     rows --precond mg over 2 ranks, 5 steps at 640^2, CSVs byte-equal
     to the one-rank run's; halo.py's B2 k-step (4096^2 nodes, f32, k =
     8, 32 steps) over 2 ranks against one-rank B2; (b) with two cards or more,
     the scalability runs over NCCL at world 2 and min(cards, 4). The
     one-rank runs and the B3 check come before path M's counts start;
     the counts are the ranks' own, per job: the scalability runs must
     launch B3, the halo.py run B2, and no rank may run a kernels.py
     plain version

Counts of kernel launches are set to 0 before each path and read after
it; every kernel of a path must have launched. After the paths, the
launches of B4, B9, B11-B13, B15 and B16 are printed per shape (grid,
dtype, degree or fused steps), summed over the paths. Any failed check
raises and the exit code is non-zero. The line before the last is
``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import csv
import io
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: tpuwave's final relative L2 error for the phase-6 run (standing-mode-wsol
#: with Nel 640, Dt 8e-5, T 0.05, Beta 0.25, Gamma 0.5, Save Solution and
#: Enable Logging false; f64; 626 steps by the reference's float time
#: accumulation; 3546 CG iterations), computed on the CPU with the JAX
#: package, those overrides written into standing-mode-wsol.json:
#:   JAX_PLATFORMS=cpu python -c "from tpuwave import config;
#:     config.use_x64();
#:     from tpuwave.models.fast_engine import make_fast_solver;
#:     from tpuwave.models.runner import RunConfig, run_solver;
#:     from tpuwave.utils.params import load_params;
#:     p = load_params('standing-mode-wsol.json');
#:     print(repr(run_solver(make_fast_solver(p, 'newmark'),
#:       'newmark-standing-mode-wsol',
#:       RunConfig(quiet=True, write_mesh=False)).rel_l2))"
TPUWAVE_REL_L2 = 5.078370338852986e-06

#: tpuwave's final relative L2 error for the phase-8 run (standing-mode-wsol
#: with Nel 2048, Dt 4e-3, T 0.2, Beta 0.25, Gamma 0.5, Save Solution and
#: Enable Logging false; f64; 50 steps; --solver 2term --precond mg, 96 CG
#: iterations), computed on the CPU with the JAX package, those overrides
#: written into standing-mode-wsol.json:
#:   JAX_PLATFORMS=cpu python -c "from tpuwave import config;
#:     config.use_x64();
#:     from tpuwave.models.fast_engine import make_fast_solver;
#:     from tpuwave.models.runner import RunConfig, run_solver;
#:     from tpuwave.utils.params import load_params;
#:     p = load_params('standing-mode-wsol.json');
#:     print(repr(run_solver(make_fast_solver(p, 'newmark', solver='2term',
#:       precond='mg'), 'newmark-standing-mode-wsol',
#:       RunConfig(quiet=True, write_mesh=False)).rel_l2))"
TPUWAVE_REL_L2_2TERM_2048 = 2.807588013360131e-05

#: tpuwave's final relative L2 error for the phase-11 run (standing-mode-wsol
#: with R 2, Nel 1024, Dt 4e-3, T 0.2, Beta 0.25, Gamma 0.5, Save Solution
#: and Enable Logging false; f64; 50 steps; --solver 2term --precond mg, 150
#: CG iterations, smoother lambda_max 2.5687343127455877), computed on the
#: CPU with the JAX package, those overrides written into
#: standing-mode-wsol.json, by the command of TPUWAVE_REL_L2_2TERM_2048
TPUWAVE_REL_L2_P2_2TERM_1024 = 2.8787273449426318e-05
TPUWAVE_ITERS_P2_2TERM_1024 = 150

#: tpuwave's end state of the phase-15 runs: FastWaveSolver at 1024^2
#: elements on the unit square, dt 4e-3, f64, cg_reduction 1e-12 (so every
#: path converges to the discrete solution far below the 1e-6 gate), from
#: initial_state of sin(pi x) sin(pi y), 20 steps of run_implicit_mg;
#: (||u||_2, ||u - u_exact||_2 / ||u_exact||_2) with u_exact =
#: cos(sqrt(2) pi t) sin(pi x) sin(pi y) at t = 0.08, computed on the CPU
#: with the JAX package:
#:   JAX_PLATFORMS=cpu python -c "from tpuwave import config;
#:     config.use_x64(); import jax.numpy as jnp, numpy as np;
#:     from tpuwave.models.fast import FastWaveSolver;
#:     kw = dict(scheme='newmark', beta=0.25, lumped=False);
#:     # or: kw = dict(scheme='theta', theta=0.5)
#:     s = FastWaveSolver((1024, 1024), ((0., 0.), (1., 1.)), 4e-3,
#:       dtype=jnp.float64, cg_reduction=1e-12, **kw);
#:     st = s.run_implicit_mg(s.initial_state(lambda x, y:
#:       jnp.sin(jnp.pi * x) * jnp.sin(jnp.pi * y)), 20);
#:     xs, ys = s.grid_coords();
#:     ex = np.cos(np.sqrt(2.0) * np.pi * 20 * 4e-3) * jnp.sin(jnp.pi * xs)
#:       * jnp.sin(jnp.pi * ys);
#:     print(repr(float(jnp.linalg.norm(st.u))), repr(float(
#:       jnp.linalg.norm(st.u - ex) / jnp.linalg.norm(ex))))"
TPUWAVE_FAST_1024 = {
    "newmark-0.25": (479.99991622767885, 3.3281066101900306e-06),
    "theta-0.5": (479.99991137986063, 3.3181115383041807e-06),
}

#: scripts/bench_fwi_adjoint.py's acquisition: the source and six receivers
FWI_SOURCE = (0.25, 0.5)
FWI_RECEIVERS = [(x, y) for x in (0.15, 0.5, 0.85) for y in (0.15, 0.85)]
#: phase 17's size, time step and step count: bench_fwi_adjoint.py's
#: 1024^2 elements and dt 2e-4 with its second step count (its first, 500
#: steps, ends at t = 0.1, before the wavefront reaches the nearest
#: receiver 0.36 from the source: the traces would be Ricker tails of
#: ~1e-38, which f32 flushes to zero, and the gradients would compare
#: nothing)
FWI_NEL, FWI_DT, FWI_STEPS = 1024, 2e-4, 2000
#: phase 17's start model: c2 = 0.9 everywhere. Within t = 0.4 no wave
#: scattered by the disk can reach a receiver (the shortest such path is
#: 0.6 long), so at c2 = 1 the residual would be rounding; at 0.9 the
#: direct arrivals (t = 0.39 at c = 0.95) differ from the observed ones
FWI_C2_INIT = 0.9
#: phase 3's FWI kernel cases: (elements per side, dt, dtype, timed kernel
#: calls, timed plain calls); the first is phase 17's shape
FWI_KERNEL_CASES = ((1024, 2e-4, "float32", 30, 3),
                    (512, 4e-4, "float64", 30, 3))
#: tpuwave's ||u||_2 at the end of phase 18's 1024^2 check: FastWaveSolver
#: at 1024^2 elements on the unit square, dt 2e-4, f64, lumped leapfrog,
#: initial_leapfrog_state of sin(pi x) sin(pi y) with bench_driven.py's
#: strip drive g (u^1 at t = dt), then 64 driven steps to t = 2 dt ..
#: 65 dt, computed on the CPU with the JAX package:
#:   JAX_PLATFORMS=cpu python -c "from tpuwave import config;
#:     config.use_x64(); import jax.numpy as jnp, numpy as np;
#:     from tpuwave.models.fast import FastWaveSolver;
#:     g = lambda x, y, t: jnp.where((y <= 0.0) & (x <= 1.0 / 3.0),
#:       jnp.sin(4.0 * jnp.pi * t), 0.0);
#:     s = FastWaveSolver((1024, 1024), ((0., 0.), (1., 1.)), 2e-4,
#:       beta=0.0, dtype=jnp.float64);
#:     st = s.initial_leapfrog_state(lambda x, y: jnp.sin(jnp.pi * x)
#:       * jnp.sin(jnp.pi * y), g_fn=g);
#:     st = s.run_leapfrog_driven(st, 2e-4 * (2.0 + np.arange(64)), g);
#:     print(repr(float(jnp.linalg.norm(st.u))))"
TPUWAVE_DRIVEN_1024 = 511.1941755012166
#: phase 18's configuration: scripts/bench_driven.py's defaults
DRIVEN_NEL, DRIVEN_DT, DRIVEN_STEPS = 4096, 8e-5, 64

#: tpuwave's (misfit, ||dmisfit/dc2||_2) of phase 17's 256^2 check: FwiProblem
#: at 256^2 elements, dt 2.5e-3, 200 steps, f64, engine "stencil", adjoint
#: "reversal", bench_fwi_adjoint.py's acquisition and disk model, observed
#: traces simulated at the disk model, misfit at c2 = 0.9 everywhere,
#: computed on the CPU with the JAX package:
#:   JAX_PLATFORMS=cpu python -c "from tpuwave import config;
#:     config.use_x64(); import jax, jax.numpy as jnp, numpy as np;
#:     from tpuwave.models.inverse import FwiProblem;
#:     recs = [(x, y) for x in (0.15, 0.5, 0.85) for y in (0.15, 0.85)];
#:     p = FwiProblem((256, 256), ((0., 0.), (1., 1.)), 2.5e-3, 200,
#:       source=(0.25, 0.5), receivers=recs, engine='stencil',
#:       adjoint='reversal');
#:     cent = p.mesh.vertex_coords[np.asarray(p.mesh.cells)].mean(1);
#:     c2t = jnp.asarray(np.where(np.sum((cent - [0.6, 0.5]) ** 2, 1)
#:       < 0.18 ** 2, 0.65, 1.0));
#:     v, g = jax.value_and_grad(p.misfit)(jnp.full(p.n_cells, 0.9),
#:       p.simulate(c2t));
#:     print(repr(float(v)), repr(float(jnp.linalg.norm(g))))"
TPUWAVE_FWI_256 = (0.02762155692337092, 0.00580166159438514)

SOURCES = {
    "constrained_stencil_apply": "tpuwave_torch/csrc/stencil_kernels.cu",
    "leapfrog_step": "tpuwave_torch/csrc/stencil_kernels.cu",
    "leapfrog_multistep": "tpuwave_torch/csrc/stencil_kernels.cu",
    "leapfrog_multistep_driven": "tpuwave_torch/csrc/stencil_kernels.cu",
    "cheby_block": "tpuwave_torch/csrc/solver_kernels.cu",
    "recurrence_r0": "tpuwave_torch/csrc/solver_kernels.cu",
    "newmark_rhs_r0": "tpuwave_torch/csrc/fast_kernels.cu",
    "newmark_update": "tpuwave_torch/csrc/fast_kernels.cu",
    "theta_r0u": "tpuwave_torch/csrc/fast_kernels.cu",
    "theta_r0v": "tpuwave_torch/csrc/fast_kernels.cu",
    "p2_constrained_apply": "tpuwave_torch/csrc/p2_kernels.cu",
    "p2_presmooth": "tpuwave_torch/csrc/p2_kernels.cu",
    "p2_postsmooth": "tpuwave_torch/csrc/p2_kernels.cu",
    "varcoef_leapfrog_step": "tpuwave_torch/csrc/varcoef_kernels.cu",
    "varcoef_leapfrog_multistep": "tpuwave_torch/csrc/varcoef_kernels.cu",
    "varcoef_adjoint_step": "tpuwave_torch/csrc/varcoef_kernels.cu",
    "varcoef_adjoint_multistep": "tpuwave_torch/csrc/varcoef_kernels.cu",
}
REPLACES = {
    "constrained_stencil_apply": "tpuwave/ops/pallas_kernels.py:1081",
    "leapfrog_step": "tpuwave/ops/pallas_kernels.py:1230",
    "leapfrog_multistep": "tpuwave/ops/pallas_kernels.py:1136",
    "leapfrog_multistep_driven": "tpuwave/ops/pallas_kernels.py:357",
    "cheby_block": "tpuwave/ops/pallas_kernels.py:1013",
    "recurrence_r0": "tpuwave/ops/pallas_kernels.py:605",
    "newmark_rhs_r0": "tpuwave/ops/pallas_kernels.py:486",
    "newmark_update": "tpuwave/ops/pallas_kernels.py:907",
    "theta_r0u": "tpuwave/ops/pallas_kernels.py:721",
    "theta_r0v": "tpuwave/ops/pallas_kernels.py:834",
    "p2_constrained_apply": "tpuwave/ops/pallas_p2.py:170",
    "p2_presmooth": "tpuwave/ops/pallas_p2.py:394",
    "p2_postsmooth": "tpuwave/ops/pallas_p2.py:429",
    "varcoef_leapfrog_step": "tpuwave/ops/pallas_varcoef.py:124",
    "varcoef_leapfrog_multistep": "tpuwave/ops/pallas_varcoef.py:365",
    "varcoef_adjoint_step": "tpuwave/ops/pallas_varcoef.py:523",
    "varcoef_adjoint_multistep": "tpuwave/ops/pallas_varcoef.py:712",
}
#: the kernels of each main path
PATH_A = ("leapfrog_step", "leapfrog_multistep", "constrained_stencil_apply")
PATH_B = ("constrained_stencil_apply", "cheby_block", "recurrence_r0")
PATH_C = ("p2_constrained_apply", "p2_presmooth", "p2_postsmooth",
          "cheby_block", "constrained_stencil_apply")
PATH_D = ("newmark_rhs_r0", "newmark_update", "theta_r0u", "theta_r0v",
          "constrained_stencil_apply", "cheby_block", "recurrence_r0")
PATH_E = ("varcoef_leapfrog_step", "varcoef_leapfrog_multistep",
          "varcoef_adjoint_step", "varcoef_adjoint_multistep")
PATH_F = ("leapfrog_step", "leapfrog_multistep_driven", "cheby_block",
          "constrained_stencil_apply")
PATH_G = ("p2_constrained_apply", "p2_presmooth", "p2_postsmooth",
          "cheby_block", "constrained_stencil_apply")
PATH_H = ("cheby_block", "constrained_stencil_apply")
PATH_I = ("cheby_block", "constrained_stencil_apply")
PATH_J = ("constrained_stencil_apply", "cheby_block", "recurrence_r0")
PATH_K = ("varcoef_leapfrog_step", "varcoef_leapfrog_multistep",
          "varcoef_adjoint_step", "varcoef_adjoint_multistep")
PATH_L = ("p2_constrained_apply", "p2_presmooth", "p2_postsmooth",
          "constrained_stencil_apply", "cheby_block", "recurrence_r0")
PATH_M = ("leapfrog_multistep", "constrained_stencil_apply")

#: the card's published rates (NVIDIA H100 SXM data sheet, 700 W): device
#: memory, and the peak without tensor cores per dtype
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
#: steps of the cuda-against-cpu runs (phases 7, 10, 13, 19, 20, 22, 24)
FAMILY_STEPS = 3
#: phase 5's steps (cuda against cpu at 640^2)
CLI_AGREE_STEPS = 10
#: bytes written before each timed call to evict the card's L2 (50 MB)
L2_FLUSH_BYTES = 256 << 20
#: calls under torch.profiler for a kernel's device time in phase 3
DEVICE_CALLS = 10


T_START = time.perf_counter()


def say(*args):
    print(*args, flush=True)


def ptxas_report(log: str) -> list:
    """One line per compiled kernel from nvcc's ``-Xptxas -v`` output: its
    (demangled, where c++filt is found) name, registers, shared memory and
    spills."""
    names, lines, spill = [], [], ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            names.append(m.group(1))
            spill = ""
        elif "spill" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln and len(names) > len(lines):
            lines.append(f"{ln.split(':', 1)[1].strip()}; {spill}")
    if shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(names):
            names = [n.replace("(anonymous namespace)::", "")
                     .removeprefix("void ").split("(")[0]
                     for n in out.stdout.splitlines()]
    return [f"{n}: {ln}" for n, ln in zip(names, lines)]


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing and comparison helpers
# ---------------------------------------------------------------------------
def cuda_ms(fn, n: int, warm: int = 2) -> float:
    """Median device time of ``fn`` over ``n`` calls (ms), each timed alone
    by CUDA events after L2_FLUSH_BYTES were written: every call reads its
    inputs from device memory, as the bound assumes, whatever the call
    before it left in the L2. The median, not the mean: a call whose
    launch the host delays is timed with the delay, and a few such calls
    move the mean of a small kernel by more than its own time."""
    import torch
    for _ in range(warm):
        fn()
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    events = []
    for _ in range(n):
        flush.fill_(0)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def kernel_ms(fn, n: int) -> tuple:
    """(cuda_ms of ``fn`` over ``n`` calls, the mean device time of a call
    under torch.profiler) in ms: the first also counts a wrapper's host
    time where it outlasts the L2 flush before the call, the second only
    the call's kernels."""
    import torch
    return cuda_ms(fn, n), _call_kernels(torch, fn)[1]


def f32_bound(scale: float, n_steps: int = 1) -> float:
    """f32 bound: each output is a sum of <= 11 rounded terms on either
    side (22 roundings of at most eps * scale, scale = an a-priori bound
    of the sum of |terms|); over n steps of the neutrally stable leapfrog a
    perturbation grows at most linearly, so the n per-step errors add up to
    at most n^2 / 2 of them."""
    return 22 * max(1.0, n_steps * n_steps / 2) * 1.1920929e-07 * scale


def bound_ms(n_bytes: float, n_flops: float, dtype) -> tuple:
    """The least time the card could take for a kernel's work: the larger
    of its bytes (each input read once, each output written once) over
    the memory rate and its operations over the dtype's peak. Returns
    (ms, "bytes" | "operations")."""
    t_mem = n_bytes / HBM_BYTES_PER_S
    t_ops = n_flops / PEAK_FLOPS[str(dtype)[6:]]
    return (max(t_mem, t_ops) * 1e3,
            "bytes" if t_mem >= t_ops else "operations")


def row(err, ms, pms, n_bytes, n_flops, dtype, device_ms) -> dict:
    """One measured kernel row, with its bound and the share reached."""
    b_ms, by = bound_ms(n_bytes, n_flops, dtype)
    return dict(err=err, ms=ms, device_ms=device_ms, plain_ms=pms,
                bound_ms=b_ms, bound_by=by)


def timing(r) -> str:
    return (f"kernel={r['ms'] * 1e3:.1f}us "
            f"device={r['device_ms'] * 1e3:.1f}us "
            f"plain={r['plain_ms'] * 1e3:.1f}us "
            f"bound={r['bound_ms'] * 1e3:.1f}us ({r['bound_by']}, "
            f"{100 * r['bound_ms'] / r['ms']:.0f}% of bound) ")


def check(name: str, got, want, bound: float, extra: str = "") -> float:
    err = float((got.double() - want.double()).abs().max())
    ref = float(want.double().abs().max())
    rel = err / ref if ref else err
    ok = err <= bound
    say(f"  {name:<44} max_abs={err:.3e} max_rel={rel:.3e} "
        f"bound={bound:.3e} {extra}{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: max abs difference {err:.3e} > "
                             f"bound {bound:.3e}")
    return err


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------
def phase_kernels(torch, dev, kn, foreign: bool = False) -> dict:
    """Check and time each kernel; returns, per kernel, the numbers of its
    main-path shape (max abs error, kernel and plain ms, bound).
    ``foreign``: tpuwave_torch comes from another checkout
    (--kernels-from), whose B4 wrapper may take no zero guess."""
    from tpuwave_torch.models.fast import FastWaveSolver
    from tpuwave_torch.solve.cheby_iter import (chebyshev_coefficients,
                                                stencil_symbol_bounds)

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)

    def rnd(shape, dtype):
        return (2 * torch.rand(shape, generator=gen, device=dev,
                               dtype=torch.float64) - 1).to(dtype)

    # the stencils the main paths use: the CLI's Newmark system at 640^2,
    # the stiffness stencil of bench.py's leapfrog at 4096^2, the Newmark
    # system of phase 8 (2048^2, dt 4e-3) and its stiffness
    cli = FastWaveSolver((640, 640), ((0.0, 0.0), (1.0, 1.0)), 8e-5,
                         beta=0.25, lumped=False, dtype=torch.float64,
                         device=dev)
    sys_st, stiff_640 = cli.system.stencil, cli.stiff.stencil
    lf = FastWaveSolver((4096, 4096), ((0.0, 0.0), (1.0, 1.0)), 8e-5,
                        beta=0.0, dtype=torch.float32, device=dev)
    stiff, coef = lf.stiff.stencil, lf.dt * lf.dt / lf.mesh.det_j
    big = FastWaveSolver((2048, 2048), ((0.0, 0.0), (1.0, 1.0)), 4e-3,
                         beta=0.25, lumped=False, dtype=torch.float64,
                         device=dev)
    ssum = lambda st: sum(abs(c) for row in st for c in row)  # noqa: E731

    say("phase 3: kernels against their plain PyTorch versions "
        "(f64 bound: 1e-12 x max|plain|; f32 bound: see f32_bound); "
        "operations counted per node: B1 21, B2 and B6 21 per step, B3 17 "
        "(23 diff), B4 22 per degree, B5 33; times: median of calls each "
        "timed alone after an L2 flush; B2-B6: a rerun bitwise equal")
    rows, results = {}, {}

    # the launch-and-event floor: an empty kernel through the same ctypes
    # path, timed like every row (absent from a library built before it)
    noop = getattr(kn._lib(), "tw_noop", None)
    if noop is None:
        say("  launch-and-event floor: this library has no empty kernel")
    else:
        stream = torch.cuda.current_stream().cuda_stream

        def empty():
            if noop(stream) != 0:
                raise AssertionError("the empty kernel did not launch")
        say(f"  launch-and-event floor (empty kernel, 1 block of 32 "
            f"threads): {cuda_ms(empty, 1000) * 1e3:.1f}us")

    # B3 constrained_stencil_apply: the CLI cells' 641^2 f64, phase 8's
    # 2049^2 f64, phase 19's and the V-cycle's coarse levels' 161^2 f64,
    # and 4097^2 f32; both forms, on the Newmark system of each size (the
    # difference form on its stiffness); a rerun bitwise equal
    small = FastWaveSolver((160, 160), ((0.0, 0.0), (1.0, 1.0)), 4e-3,
                           beta=0.25, lumped=False, dtype=torch.float64,
                           device=dev)
    for shape, dtype, n_k, n_p, sys_s, stiff_s in (
            ((161, 161), torch.float64, 1000, 50, small.system.stencil,
             small.stiff.stencil),
            ((641, 641), torch.float64, 1000, 50, sys_st, stiff_640),
            ((2049, 2049), torch.float64, 50, 10, big.system.stencil,
             big.stiff.stencil),
            ((4097, 4097), torch.float32, 50, 10, sys_st, stiff_640)):
        x = rnd(shape, dtype)
        n = x.numel() * x.element_size()
        for diff in (False, True):
            st = stiff_s if diff else sys_s
            diag = st[1][1]
            got = kn.constrained_stencil_apply(x, st, diag, diff=diff)
            again = kn.constrained_stencil_apply(x, st, diag, diff=diff)
            want = kn.constrained_stencil_apply_reference(x, st, diag, diff)
            torch.cuda.synchronize()
            tag = (f"B3 constrained_apply {shape[0]}^2 "
                   f"{str(dtype)[6:]} diff={diff}")
            if not torch.equal(got, again):
                raise AssertionError(f"{tag}: a rerun is not bitwise equal")
            scale = ssum(st) * float(x.abs().max()) * (2 if diff else 1)
            bound = (1e-12 * float(want.abs().max())
                     if dtype == torch.float64 else f32_bound(scale))
            ms, dms = kernel_ms(lambda: kn.constrained_stencil_apply(
                x, st, diag, diff=diff), n_k)
            pms = cuda_ms(lambda: kn.constrained_stencil_apply_reference(
                x, st, diag, diff), n_p)
            r = row(0.0, ms, pms, 2 * n, (23 if diff else 17) * x.numel(),
                    dtype, dms)
            r["err"] = check(tag, got, want, bound, timing(r))
            rows[tag] = r
    results["constrained_stencil_apply"] = rows[
        "B3 constrained_apply 641^2 float64 diff=False"]

    # B1 leapfrog_step
    for dtype in (torch.float32, torch.float64):
        u, up = rnd((4097, 4097), dtype), rnd((4097, 4097), dtype)
        got = kn.leapfrog_step(u, up, stiff, coef)
        want = kn.leapfrog_step_reference(u, up, stiff, coef)
        scale = 3.0 + coef * ssum(stiff)
        bound = (1e-12 * float(want.abs().max())
                 if dtype == torch.float64 else f32_bound(scale))
        ms, dms = kernel_ms(lambda: kn.leapfrog_step(u, up, stiff, coef),
                            50)
        pms = cuda_ms(lambda: kn.leapfrog_step_reference(u, up, stiff,
                                                         coef), 10)
        tag = f"B1 leapfrog_step 4097^2 {str(dtype)[6:]}"
        r = row(0.0, ms, pms, 3 * u.numel() * u.element_size(),
                21 * u.numel(), dtype, dms)
        r["err"] = check(tag, got, want, bound, timing(r))
        rows[tag] = r
    results["leapfrog_step"] = rows["B1 leapfrog_step 4097^2 float32"]

    # B2 leapfrog_multistep: bench.py's shape at k = 1, 8 (phase 4) and 32
    # (phase 4, bench.py's pallas-k32) in f32, and k = 8 in f64; a call's
    # launches (a pass deeper than the dtype's launch depth is split), a
    # rerun bitwise equal
    for dtype, k in ((torch.float32, 1), (torch.float32, 8),
                     (torch.float32, 32), (torch.float64, 8)):
        u, up = rnd((4097, 4097), dtype), rnd((4097, 4097), dtype)
        before = kn.LAUNCHES["leapfrog_multistep"]
        got = kn.leapfrog_multistep(u, up, stiff, coef, k)
        again = kn.leapfrog_multistep(u, up, stiff, coef, k)
        per_call = (kn.LAUNCHES["leapfrog_multistep"] - before) // 2
        want = kn.leapfrog_multistep_reference(u, up, stiff, coef, k)
        torch.cuda.synchronize()
        tag = f"B2 leapfrog_multistep k={k} 4097^2 {str(dtype)[6:]}"
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{tag}: a rerun is not bitwise equal")
        peak = max(1.0, float(want[0].abs().max()),
                   float(want[1].abs().max()))
        bound = (1e-12 * peak if dtype == torch.float64 else
                 f32_bound((3.0 + coef * ssum(stiff)) * peak, k))
        ms, dms = kernel_ms(lambda: kn.leapfrog_multistep(u, up, stiff,
                                                          coef, k), 20)
        pms = cuda_ms(lambda: kn.leapfrog_multistep_reference(
            u, up, stiff, coef, k), 3, warm=1)
        r = row(0.0, ms, pms, 4 * u.numel() * u.element_size(),
                21 * k * u.numel(), dtype, dms)
        e1 = check(tag + " u", got[0], want[0], bound)
        e2 = check(tag + " u_prev", got[1], want[1], bound,
                   f"({ms * 1e3 / k:.1f}us/step, {per_call} launches a "
                   f"call) " + timing(r))
        r["err"] = max(e1, e2)
        rows[tag] = r
        del u, up, got, again, want
    results["leapfrog_multistep"] = rows[
        "B2 leapfrog_multistep k=32 4097^2 float32"]

    # B6 leapfrog_multistep_driven: phase 18's shape and coefficient at
    # k = 1, 8, 16 (phase 18's best), 32, and its 1024^2 f64 check's at
    # k = 8; random fields and random edge tables (every substep's g
    # differs); a call's launches, a rerun bitwise equal
    lf1024 = FastWaveSolver((1024, 1024), ((0.0, 0.0), (1.0, 1.0)), 2e-4,
                            beta=0.0, dtype=torch.float64, device=dev)
    for size, dtype, k, c, n_k, n_p in (
            (4097, torch.float32, 1, coef, 20, 3),
            (4097, torch.float32, 8, coef, 20, 3),
            (4097, torch.float32, 16, coef, 20, 2),
            (4097, torch.float32, 32, coef, 10, 2),
            (1025, torch.float64, 8,
             lf1024.dt * lf1024.dt / lf1024.mesh.det_j, 30, 3)):
        u, up = rnd((size, size), dtype), rnd((size, size), dtype)
        gtb, glr = rnd((k, 2, size), dtype), rnd((k, size, 2), dtype)
        args = (u, up, gtb, glr, stiff, c, k)
        before = kn.LAUNCHES["leapfrog_multistep_driven"]
        got = kn.leapfrog_multistep_driven(*args)
        again = kn.leapfrog_multistep_driven(*args)
        per_call = (kn.LAUNCHES["leapfrog_multistep_driven"] - before) // 2
        want = kn.leapfrog_multistep_driven_reference(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError("B6: a rerun is not bitwise equal")
        peak = max(1.0, float(want[0].abs().max()),
                   float(want[1].abs().max()))
        bound = (1e-12 * peak if dtype == torch.float64
                 else f32_bound((3.0 + c * ssum(stiff)) * peak, k))
        ms, dms = kernel_ms(lambda: kn.leapfrog_multistep_driven(*args), n_k)
        pms = cuda_ms(lambda: kn.leapfrog_multistep_driven_reference(*args),
                      n_p, warm=1)
        tag = f"B6 leapfrog_multistep_driven k={k} {size}^2 {str(dtype)[6:]}"
        r = row(0.0, ms, pms,
                (4 * u.numel() + gtb.numel() + glr.numel())
                * u.element_size(), 21 * k * u.numel(), dtype, dms)
        e1 = check(tag + " u", got[0], want[0], bound)
        e2 = check(tag + " u_prev", got[1], want[1], bound,
                   f"({ms * 1e3 / k:.1f}us/step, {per_call} launches a "
                   f"call) " + timing(r))
        r["err"] = max(e1, e2)
        rows[tag] = r
        del u, up, gtb, glr, args, got, again, want
    results["leapfrog_multistep_driven"] = rows[
        "B6 leapfrog_multistep_driven k=8 4097^2 float32"]

    # B4 cheby_block: the MG fine-level smoother of phase 14 (degree 1,
    # 4097^2 f32, its Newmark system; also from the V-cycle's zero guess,
    # where the wrapper takes one), of the CLI (degree 2, phase 8's 2049^2
    # and phases 5 and 7's 641^2, f64) and the --solver cheby block
    # (degree 8, 2049^2 f64 and 4097^2 f32)
    fast_sys = FastWaveSolver((4096, 4096), ((0.0, 0.0), (1.0, 1.0)), 1e-3,
                              beta=0.25, lumped=False, dtype=torch.float32,
                              device=dev).system.stencil
    sys_2048 = big.system.stencil
    for size, dtype, degree, n_k, st, zero in (
            (4097, torch.float32, 1, 20, fast_sys, False),
            (4097, torch.float32, 1, 20, fast_sys, True),
            (641, torch.float64, 2, 200, sys_st, False),
            (2049, torch.float64, 2, 20, sys_2048, False),
            (2049, torch.float64, 8, 10, sys_2048, False),
            (4097, torch.float32, 8, 10, sys_2048, False)):
        lo, hi = stencil_symbol_bounds(st)
        theta, coeffs = chebyshev_coefficients(lo, hi, degree)
        x, r = rnd((size, size), dtype), rnd((size, size), dtype)
        tag = (f"B4 cheby_block degree {degree} {size}^2 {str(dtype)[6:]}"
               + (" zero guess" if zero else ""))
        x0 = None if zero else x
        if zero and foreign:
            # an earlier checkout's wrapper (--kernels-from) may read x
            try:
                kn.cheby_block(x0, r, st, theta, coeffs)
            except TypeError as e:
                say(f"  {tag}: this checkout's wrapper takes no zero guess "
                    f"({e})")
                continue
        got = kn.cheby_block(x0, r, st, theta, coeffs)
        again = kn.cheby_block(x0, r, st, theta, coeffs)
        want = kn.cheby_block_reference(x0, r, st, theta, coeffs)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{tag}: a rerun is not bitwise equal")
        ms, dms = kernel_ms(lambda: kn.cheby_block(x0, r, st, theta,
                                                   coeffs), n_k)
        pms = cuda_ms(lambda: kn.cheby_block_reference(
            x0, r, st, theta, coeffs), 3, warm=1)
        rw = row(0.0, ms, pms, (3 if zero else 4) * x.numel()
                 * x.element_size(), 22 * degree * x.numel(), dtype, dms)
        errs = []
        for name, g, w in (("x", got[0], want[0]), ("r", got[1], want[1])):
            peak = float(w.abs().max())
            # each step sums ~22 rounded terms of magnitude <= (1 +
            # ssum / theta) * peak; the restarted block is a fixed
            # polynomial of degree `degree`
            bound = (1e-12 * peak if dtype == torch.float64 else
                     f32_bound((1 + ssum(st) / theta) * peak, degree))
            errs.append(check(f"{tag} {name}", g, w, bound,
                              timing(rw) if name == "r" else ""))
        # the in-kernel reduction against a dot product of the kernel's r
        rr_dot = float(torch.dot(got[1].reshape(-1), got[1].reshape(-1)))
        rel = 1e-12 if dtype == torch.float64 else 1e-5
        check(f"{tag} rr", got[2].reshape(1), torch.tensor(
            [rr_dot], device=dev, dtype=torch.float64), rel * rr_dot)
        rw["err"] = max(errs)
        rows[tag] = rw
        del x, r, got, again, want
    results["cheby_block"] = rows["B4 cheby_block degree 2 2049^2 float64"]

    # B5 recurrence_r0: phase 8's -dt^2 K stencil, Newmark gamma 1/2, at
    # the 640^2 paths', phase 8's and phase 14's grids
    dt = 4e-3
    kneg = tuple(tuple(-dt * dt * c for c in row)
                 for row in big.stiff.stencil)
    for size, dtype, mask_combo in ((641, torch.float64, False),
                                    (2049, torch.float64, False),
                                    (2049, torch.float64, True),
                                    (4097, torch.float32, False)):
        u, up = rnd((size, size), dtype), rnd((size, size), dtype)
        got = kn.recurrence_r0(u, up, kneg, 1.0, 0.0, mask_combo)
        again = kn.recurrence_r0(u, up, kneg, 1.0, 0.0, mask_combo)
        want = kn.recurrence_r0_reference(u, up, kneg, 1.0, 0.0,
                                          mask_combo)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"B5 {size}^2 mask_combo={mask_combo}: a "
                                 "rerun is not bitwise equal")
        ms, dms = kernel_ms(lambda: kn.recurrence_r0(u, up, kneg, 1.0, 0.0,
                                                     mask_combo), 50)
        pms = cuda_ms(lambda: kn.recurrence_r0_reference(
            u, up, kneg, 1.0, 0.0, mask_combo), 5, warm=1)
        tag = (f"B5 recurrence_r0 {size}^2 {str(dtype)[6:]} "
               f"mask_combo={mask_combo}")
        rw = row(0.0, ms, pms, 4 * u.numel() * u.element_size(),
                 33 * u.numel(), dtype, dms)
        errs = []
        for name, g, w, sc in (("r0", got[0], want[0], 2 * ssum(kneg)),
                               ("x0", got[1], want[1], 3.0)):
            bound = (1e-12 * float(w.abs().max())
                     if dtype == torch.float64 else f32_bound(sc))
            errs.append(check(f"{tag} {name}", g, w, bound,
                              timing(rw) if name == "x0" else ""))
        rel = 1e-12 if dtype == torch.float64 else 1e-5
        for name, nrm, v in (("rr0", got[2], got[0]), ("xx0", got[3],
                                                       got[1])):
            dot = float(torch.dot(v.reshape(-1), v.reshape(-1)))
            check(f"{tag} {name}", nrm.reshape(1), torch.tensor(
                [dot], device=dev, dtype=torch.float64), rel * dot)
        rw["err"] = max(errs)
        rows[tag] = rw
    results["recurrence_r0"] = rows[
        "B5 recurrence_r0 2049^2 float64 mask_combo=False"]
    return results


def phase_fast_kernels(torch, dev, kn, foreign: bool = False) -> dict:
    """Phase 3, kernels B7-B10 at phase 14's shape (4097^2 f32, its
    stencils) and at 2049^2 f64 (phase 8's dt), on fields that are random
    everywhere, the pinned nodes included; the device kernels of one call
    under torch.profiler (B9 must be one launch, unless ``foreign``: an
    earlier checkout's kernels, --kernels-from)."""
    from tpuwave_torch.models.fast import FastWaveSolver

    gen = torch.Generator(device=dev)
    gen.manual_seed(2468)
    say("phase 3 (implicit steps): B7-B10 against their plain versions on "
        "fields that are non-zero on the pinned nodes (grids: 1e-12 (f64) "
        "/ 1e-5 (f32) x max|plain|; norms: rtol 1e-12 / 1e-5; a rerun "
        "bitwise equal); operations counted per node: B7 47, B8 7, B9 62, "
        "B10 63")
    rows = {}
    for nel, dt, dtype, n_k, n_p in ((4096, 1e-3, torch.float32, 30, 5),
                                     (2048, 4e-3, torch.float64, 30, 5)):
        geom = ((0.0, 0.0), (1.0, 1.0))
        nm = FastWaveSolver((nel, nel), geom, dt, beta=0.25, lumped=False,
                            dtype=dtype, device=dev)
        th = FastWaveSolver((nel, nel), geom, dt, scheme="theta", theta=0.5,
                            dtype=dtype, device=dev)
        cn, ct = nm.setup_coefficients(), th.setup_coefficients()
        m_st, k_st, a_st = nm.mass.stencil, nm.stiff.stencil, nm.system.stencil
        shape = nm.shape
        del nm, th

        def rnd():
            return (2 * torch.rand(shape, generator=gen, device=dev,
                                   dtype=torch.float64) - 1).to(dtype)

        f = [rnd() for _ in range(4)]
        cases = (
            ("B7 newmark_rhs_r0", kn.newmark_rhs_r0,
             kn.newmark_rhs_r0_reference,
             (f[0], f[1], f[2], k_st, a_st, *cn["rhs_r0"].values()),
             3, 2, 47),
            ("B8 newmark_update", kn.newmark_update,
             kn.newmark_update_reference,
             (f[0], f[1], f[2], f[3], *cn["update"].values()), 4, 3, 7),
            ("B9 theta_r0u", kn.theta_r0u, kn.theta_r0u_reference,
             (f[0], f[1], m_st, k_st, *ct["r0u"].values()), 2, 1, 62),
            ("B10 theta_r0v", kn.theta_r0v, kn.theta_r0v_reference,
             (f[0], f[3], f[1], m_st, k_st, *ct["r0v"].values()), 3, 2, 63),
        )
        rel = 1e-12 if dtype == torch.float64 else 1e-5
        for kname, fn, ref_fn, args, n_in, n_out, ops in cases:
            got, want = fn(*args), ref_fn(*args)
            again = fn(*args)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{kname}: a rerun is not bitwise equal")
            tag = f"{kname} {shape[0]}^2 {str(dtype)[6:]}"
            launched, dms = _call_kernels(torch, lambda: fn(*args))
            say(f"  {tag:<44} device kernels of one call: {launched}")
            if kname.startswith("B9") and not foreign and len(launched) != 1:
                raise AssertionError(f"{tag}: {len(launched)} device "
                                     "kernels a call, not one")
            ms = cuda_ms(lambda: fn(*args), n_k)
            pms = cuda_ms(lambda: ref_fn(*args), n_p, warm=1)
            n = f[0].numel()
            r = row(0.0, ms, pms, (n_in + n_out) * n * f[0].element_size(),
                    ops * n, dtype, dms)
            errs, k = [], 0
            for g, w in zip(got, want):
                if g.dim():
                    errs.append(check(f"{tag} out{k}", g, w,
                                      rel * float(w.abs().max())))
                else:
                    check(f"{tag} norm{k - n_out}", g.reshape(1),
                          w.reshape(1), rel * float(w),
                          timing(r) if k == len(got) - 1 else "")
                k += 1
            if got[-1].dim():       # B8 returns no norms
                say(f"  {tag:<44} {timing(r)}")
            r["err"] = max(errs)
            rows[tag] = r
        del f
    return {"newmark_rhs_r0": rows["B7 newmark_rhs_r0 4097^2 float32"],
            "newmark_update": rows["B8 newmark_update 4097^2 float32"],
            "theta_r0u": rows["B9 theta_r0u 4097^2 float32"],
            "theta_r0v": rows["B10 theta_r0v 4097^2 float32"]}


# ---------------------------------------------------------------------------
# phases 13 to 15: path D, FastWaveSolver's implicit family
# ---------------------------------------------------------------------------
FAST_SCHEMES = {
    "theta-1.0": dict(scheme="theta", theta=1.0),
    "theta-0.5": dict(scheme="theta", theta=0.5),
    "newmark-0.25": dict(scheme="newmark", beta=0.25, lumped=False),
}
UNIT_SQUARE = ((0.0, 0.0), (1.0, 1.0))


def _standing(torch):
    def u0(xs, ys):
        return torch.sin(torch.pi * xs) * torch.sin(torch.pi * ys)
    return u0


def _rel_l2(torch, a, b) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def _rel_exact(torch, solver, u, t: float) -> float:
    """Relative L2 error of ``u`` against the standing mode
    cos(sqrt(2) pi t) sin(pi x) sin(pi y), evaluated in f64."""
    xs, ys = (c.double() for c in solver.grid_coords())
    exact = (float(torch.cos(torch.tensor(2.0 ** 0.5 * torch.pi * t,
                                          dtype=torch.float64)))
             * torch.sin(torch.pi * xs) * torch.sin(torch.pi * ys))
    return _rel_l2(torch, u, exact)


def _two_term(solver, state, n_steps: int):
    """The 2-term chain over ``n_steps`` steps in all: init (one step),
    n_steps - 1 recurrence steps, finish. Returns (state, per-step
    iteration counts)."""
    lf = solver.implicit_2term_init(state)
    its = list(solver.last_iterations)
    lf = solver.run_implicit_mg_2term(lf, n_steps - 1)
    its += solver.last_iterations
    return solver.implicit_2term_finish(lf), its


def _flat(its) -> list:
    """Per-solve iteration counts of a run's ``last_iterations``."""
    return [k for i in its for k in (i if isinstance(i, tuple) else (i,))]


def phase_fast_agree(torch):
    from tpuwave_torch.models.fast import FastWaveSolver

    n = FAMILY_STEPS
    say(f"phase 13: FastWaveSolver's implicit family, standing mode, 640^2 "
        f"elements, f64, dt 4e-3, {n} steps: device=cuda against device=cpu "
        f"(u within rel 1e-9; v within 1e-9 (Newmark) / 1e-5 (theta); "
        f"per-solve iteration counts equal, within 1 on theta's Jacobi-CG "
        f"paths)")
    paths = ("run_scan", "run_implicit_kernel", "run_implicit_mg",
             "run_implicit_mg_kernel", "run_implicit_cheby", "2term")
    failed = []
    for name, kw in FAST_SCHEMES.items():
        ends = {}
        # theta: v' = M^-1 (M v - dt K(...u')) applies K to the u-solve's
        # error, which is rough (CG stops at the absolute floor 1e-12 on a
        # system with entries ~h^2) and differs between the devices in the
        # last bits: v agrees to ~1e-6 on the Jacobi-CG paths, and a solve
        # whose residual straddles the floor may take one iteration more
        # on one device
        v_tol = 1e-9 if kw["scheme"] == "newmark" else 1e-5
        for device in ("cuda", "cpu"):
            fs = FastWaveSolver((640, 640), UNIT_SQUARE, 4e-3,
                                dtype=torch.float64, device=device, **kw)
            st = (fs.initial_state_consistent(_standing(torch))
                  if kw["scheme"] == "newmark"
                  else fs.initial_state(_standing(torch)))
            for path in paths:
                t0 = time.perf_counter()
                if path == "2term":
                    out, its = _two_term(fs, st, n)
                else:
                    out = getattr(fs, path)(st, n)
                    its = list(fs.last_iterations)
                if device == "cuda":
                    torch.cuda.synchronize()
                ends[path, device] = (out.u.cpu(), out.v.cpu(), its,
                                      time.perf_counter() - t0)
        for path in paths:
            (uc, vc, ic, tc), (uh, vh, ih, t_h) = (ends[path, "cuda"],
                                                   ends[path, "cpu"])
            du, dv = _rel_l2(torch, uc, uh), _rel_l2(torch, vc, vh)
            flat_c, flat_h = _flat(ic), _flat(ih)
            jacobi_theta = (kw["scheme"] == "theta"
                            and path in ("run_scan", "run_implicit_kernel"))
            slack = 1 if jacobi_theta else 0
            same = (len(flat_c) == len(flat_h) and all(
                abs(a - b) <= slack for a, b in zip(flat_c, flat_h)))
            ok = du <= 1e-9 and dv <= v_tol and same
            say(f"  {name:<13} {path:<23} cuda {tc:6.2f} s  cpu {t_h:6.2f} s"
                f"  rel du {du:.1e} dv {dv:.1e} (bound {v_tol:.0e})  "
                f"iterations {sum(flat_c)} "
                f"{'equal' if ic == ih else f'{ic} vs {ih}'} "
                f"(slack {slack}) {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(f"{name} {path}")
    if failed:
        raise AssertionError(f"phase 13: cuda and cpu runs disagree: "
                             f"{failed}")


def _best_of(torch, fn, repeats: int = 3):
    """(best wall seconds over ``repeats`` runs after a warm run, the last
    result)."""
    out = fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best, out


def phase_fast_4096(torch):
    from tpuwave_torch.models.fast import FastWaveSolver

    nel, dt, n = 4096, 1e-3, 20
    say(f"phase 14: FastWaveSolver's implicit family, standing mode, "
        f"{nel}^2 elements ({(nel + 1) ** 2:,} DoF), f32, dt {dt}, {n} "
        f"steps, on cuda: ms/step (one run after a warm run, host clock "
        f"around a synchronize), solver iterations per step, peak device "
        f"memory; gates: rel diff of u against run_implicit_mg < 1e-3, "
        f"error against the analytic mode finite and, for "
        f"run_implicit_mg_kernel, within 2x of run_implicit_mg's")
    for name, kw in FAST_SCHEMES.items():
        fs = FastWaveSolver((nel, nel), UNIT_SQUARE, dt, dtype=torch.float32,
                            device="cuda", **kw)
        st = fs.initial_state(_standing(torch))
        runs = (("run_implicit_mg", lambda: fs.run_implicit_mg(st, n)),
                ("run_implicit_mg_kernel",
                 lambda: fs.run_implicit_mg_kernel(st, n)),
                ("2term (init + 19 + finish)", None))
        ref = err_ref = None
        for path, fn in runs:
            torch.cuda.reset_peak_memory_stats()
            if fn is not None:
                best, out = _best_of(torch, fn, repeats=1)
                its, steps = list(fs.last_iterations), n
            else:
                lf0 = fs.implicit_2term_init(st)
                best, lf = _best_of(
                    torch, lambda: fs.run_implicit_mg_2term(lf0, n - 1),
                    repeats=1)
                its, steps = list(fs.last_iterations), n - 1
                out = fs.implicit_2term_finish(lf)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            err = _rel_exact(torch, fs, out.u, n * dt)
            if ref is None:
                ref, err_ref, diff = out.u, err, 0.0
            else:
                diff = _rel_l2(torch, out.u, ref)
            per = ([sum(i) / steps for i in zip(*its)]
                   if isinstance(its[0], tuple) else [sum(its) / steps])
            # the 2-term recurrence carries v implicitly and has its own
            # f32 noise floor (models/fast.py): it is held to the 1e-3
            # difference only
            ok = (diff < 1e-3 and err == err
                  and (fn is None or err <= 2 * err_ref))
            say(f"  {name:<13} {path:<27} {best / steps * 1e3:8.2f} ms/step "
                f" iterations/step "
                f"{' + '.join(f'{p:.2f}' for p in per)}  peak {peak:.2f} "
                f"GiB  rel diff {diff:.2e}  rel L2 error {err:.3e} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"phase 14 {name} {path}: gate failed")
        del fs, st, ref, out


def phase_fast_1024(torch):
    from tpuwave_torch.models.fast import FastWaveSolver

    n, dt = 20, 4e-3
    say(f"phase 15: run_implicit_mg_kernel, standing mode, 1024^2 elements, "
        f"f64, dt {dt}, {n} steps, cg_reduction 1e-12, on cuda, against "
        f"tpuwave's run_implicit_mg (its CPU run): ||u|| and the rel L2 "
        f"error within rtol 1e-6")
    for name, (want_norm, want_err) in TPUWAVE_FAST_1024.items():
        fs = FastWaveSolver((1024, 1024), UNIT_SQUARE, dt,
                            dtype=torch.float64, device="cuda",
                            cg_reduction=1e-12, **FAST_SCHEMES[name])
        t0 = time.perf_counter()
        out = fs.run_implicit_mg_kernel(
            fs.initial_state(_standing(torch)), n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        norm = float(torch.linalg.vector_norm(out.u))
        err = _rel_exact(torch, fs, out.u, n * dt)
        d_norm = abs(norm - want_norm) / want_norm
        d_err = abs(err - want_err) / want_err
        ok = d_norm <= 1e-6 and d_err <= 1e-6
        say(f"  {name:<13} {wall / n * 1e3:7.2f} ms/step, "
            f"{sum(_flat(fs.last_iterations))} "
            f"iterations; ||u|| {norm!r} (tpuwave {want_norm!r}, rel diff "
            f"{d_norm:.1e}); rel L2 error {err!r} (tpuwave {want_err!r}, "
            f"rel diff {d_err:.1e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"phase 15 {name}: differs from tpuwave's")


def p2_system(nel: int, dt: float, beta: float, dtype, dev):
    """The P2 Newmark system M + beta dt^2 K (c = 1) on the unit square at
    Nel x Nel, as the engine builds it."""
    from tpuwave_torch.core.mesh import FeSpace, StructuredTriMesh
    from tpuwave_torch.core.quadrature import gauss_simplex
    from tpuwave_torch.ops.assembly import (element_mass_class,
                                            element_stiffness_class)
    from tpuwave_torch.ops.stencil_p2 import P2PlaneStencil
    space = FeSpace(StructuredTriMesh((nel, nel), ((0.0, 0.0), (1.0, 1.0))),
                    2)
    quad = gauss_simplex(3)
    mass = P2PlaneStencil(space, element_mass_class(space, quad), dtype, dev)
    stiff = P2PlaneStencil(space, element_stiffness_class(space, quad, 1.0),
                           dtype, dev)
    return mass.axpy(beta * dt * dt, stiff)


def phase_p2_kernels(torch, dev, kn) -> dict:
    """Phase 3, the P2 kernels B11-B13 at phase 11's shape (Nel 1024 f64),
    phase 11b's (Nel 4096 f32), on phase 11's system stencil, and phase
    10's (Nel 160 f64, its system at dt 4e-2); B12 and B13 at smoothing
    degree 4 (the engine's) and 2."""
    from tpuwave_torch.ops import kernels_p2 as kp
    from tpuwave_torch.solve.cheby_iter import chebyshev_coefficients

    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    say("phase 3 (P2): B11-B13 on the Newmark system M + dt^2/4 K (f64 "
        "bound: 1e-12 x max|plain|; f32: see f32_bound); operations "
        "counted per canvas site: B11 92 (46 multiply-adds; a rerun "
        "bitwise equal), B12 116 per apply, B13 116 per apply + 8; "
        "smoothing on [lambda/8, lambda], "
        "lambda = 2.5687 (tpuwave's estimate at Nel 1024) at Nel 1024 and "
        "4096, the Gershgorin bound of D^-1 A at Nel 160")
    rows, results = {}, {}
    for nel, dt, dtype, degrees, lam, n_k, n_p in (
            (1024, 4e-3, torch.float64, (4, 2), 2.5687343127455877, 50, 5),
            (4096, 4e-3, torch.float32, (4, 2), 2.5687343127455877, 10, 2),
            (160, 4e-2, torch.float64, (4,), None, 200, 20)):
        st = p2_system(nel, dt, 0.25, dtype, dev)
        coeffs = st.terms
        diags = tuple(float(st.plane_diag[q]) for q in "VHWD")
        inv = tuple(1.0 / d for d in diags)
        rows_abs = [sum(abs(c) for ia, _, _, _, c in coeffs if ia == p)
                    for p in range(4)]
        gersh = max(rows_abs)
        lam = lam or max(a / d for a, d in zip(rows_abs, diags))
        cshape = (nel + 3, nel + 3)
        interior = kp.p2_canvas_interior(nel, nel, cshape, dev)
        ri = torch.arange(cshape[0], device=dev)[:, None]
        support = torch.stack([(ri >= 1) & (ri <= nel + 1 - a)
                               & (ri.T >= 1) & (ri.T <= nel + 1 - b)
                               for a, b in ((0, 0), (0, 1), (1, 0),
                                            (1, 1))])
        n_site = cshape[0] * cshape[1]
        stack = 4 * n_site * torch.empty((), dtype=dtype).element_size()
        name = f"{nel + 3}^2 x 4 {str(dtype)[6:]}"

        def rnd(mask):
            x = 2 * torch.rand((4, *cshape), generator=gen, device=dev,
                               dtype=torch.float64) - 1
            return torch.where(mask, x, 0.0).to(dtype)

        def bound(want, scale, n=1):
            return (1e-12 * float(want.abs().max()) if dtype == torch.float64
                    else f32_bound(scale, n))

        # B11, both forms (the pattern kernel: the engines' terms), and at
        # Nel 1024 once on a foreign term list (the general kernel: the
        # system's last term replaced by one off the pattern); a rerun
        # bitwise equal
        x = rnd(support)
        foreign = coeffs[:-1] + ((3, 3, -1, 1, coeffs[-1][4]),)
        cases = [(coeffs, True, ""), (coeffs, False, "")]
        if nel == 1024:
            cases.append((foreign, True, " (general kernel)"))
        for terms, mask_input, kind in cases:
            dg = diags if mask_input else (0.0,) * 4
            got = kp.p2_constrained_apply(x, terms, dg, nel, nel,
                                          mask_input)
            again = kp.p2_constrained_apply(x, terms, dg, nel, nel,
                                            mask_input)
            want = kp.p2_constrained_apply_reference(x, terms, dg, nel,
                                                     nel, mask_input)
            torch.cuda.synchronize()
            tag = (f"B11 p2_constrained_apply{kind} {name} "
                   f"mask_input={mask_input}")
            if not torch.equal(got, again):
                raise AssertionError(f"{tag}: a rerun is not bitwise equal")
            ms, dms = kernel_ms(lambda: kp.p2_constrained_apply(
                x, terms, dg, nel, nel, mask_input), n_k)
            pms = cuda_ms(lambda: kp.p2_constrained_apply_reference(
                x, terms, dg, nel, nel, mask_input), n_p, warm=1)
            r = row(0.0, ms, pms, 2 * stack, 92 * n_site, dtype, dms)
            route = getattr(kp, "p2_apply_route", None)
            r["err"] = check(tag, got, want,
                             bound(want, gersh * float(x.abs().max())),
                             timing(r) + ("" if route is None else
                                          f"({route(tuple(terms))}) "))
            rows[tag] = r
        # B12 and B13
        b, r_in = rnd(interior), rnd(interior)
        x, corr = rnd(support), rnd(support)
        for degree in degrees:
            theta, cf = chebyshev_coefficients(lam / 8.0, lam, degree)
            sm = tuple((float(a), float(c)) for a, c in cf)
            sm_scale = (1.0 + gersh * max(inv) / theta)
            for kname, fn, ref_fn, n_in, n_out, ops in (
                    ("B12 p2_presmooth", lambda: kp.p2_presmooth(
                        b, coeffs, inv, theta, sm, nel, nel),
                     lambda: kp.p2_presmooth_reference(
                         b, coeffs, inv, theta, sm, nel, nel), 1, 2,
                     degree * 116),
                    ("B13 p2_postsmooth", lambda: kp.p2_postsmooth(
                        x, r_in, corr, coeffs, inv, theta, sm, nel, nel),
                     lambda: kp.p2_postsmooth_reference(
                         x, r_in, corr, coeffs, inv, theta, sm, nel, nel),
                     3, 1, degree * 116 + 8)):
                got, want = fn(), ref_fn()
                if not isinstance(got, tuple):
                    got, want = (got,), (want,)
                ms, dms = kernel_ms(fn, n_k)
                pms = cuda_ms(ref_fn, n_p, warm=1)
                tag = f"{kname} {name} degree {degree}"
                r = row(0.0, ms, pms, (n_in + n_out) * stack, ops * n_site,
                        dtype, dms)
                errs = []
                for i, (g, w) in enumerate(zip(got, want)):
                    peak = max(1.0, float(w.abs().max()))
                    errs.append(check(
                        f"{tag} out{i}", g, w,
                        bound(w, sm_scale * peak, degree + 1),
                        timing(r) if i == len(got) - 1 else ""))
                r["err"] = max(errs)
                rows[tag] = r
    results["p2_constrained_apply"] = rows[
        "B11 p2_constrained_apply 1027^2 x 4 float64 mask_input=True"]
    results["p2_presmooth"] = rows[
        "B12 p2_presmooth 1027^2 x 4 float64 degree 4"]
    results["p2_postsmooth"] = rows[
        "B13 p2_postsmooth 1027^2 x 4 float64 degree 4"]
    return results


# ---------------------------------------------------------------------------
# phase 4: the explicit leapfrog at bench.py's configuration
# ---------------------------------------------------------------------------
def phase_leapfrog(torch, dev):
    from tpuwave_torch.models.fast import FastWaveSolver

    n_steps = 320
    say(f"phase 4: leapfrog, 4096^2 elements (4097^2 nodes), dt 8e-5, "
        f"sin*sin, f32, {n_steps} steps")
    fs = FastWaveSolver((4096, 4096), ((0.0, 0.0), (1.0, 1.0)), 8e-5,
                        beta=0.0, dtype=torch.float32, device=dev)
    st0 = fs.initial_leapfrog_state(
        lambda xs, ys: torch.sin(torch.pi * xs) * torch.sin(torch.pi * ys))
    runs = {
        "plain (run_leapfrog_scan)": lambda: fs.run_leapfrog_scan(
            st0, n_steps),
        "B1 (run_leapfrog_kernel)": lambda: fs.run_leapfrog_kernel(
            st0, n_steps),
        "B2 k=8 (run_leapfrog_multistep)": lambda: fs.run_leapfrog_multistep(
            st0, n_steps, steps_per_call=8),
        "B2 k=32 (run_leapfrog_multistep)": lambda: fs.run_leapfrog_multistep(
            st0, n_steps, steps_per_call=32),
    }
    finals = {}
    for name, fn in runs.items():
        finals[name] = fn()                     # warm-up and the result
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        del out
        say(f"  {name:<34} {best * 1e6 / n_steps:9.1f} us/step  "
            f"{fs.n_dofs * n_steps / best:.4e} DoF*steps/s")
    # f32: two roundings of differently ordered sums per step (~1e-7 of
    # |u|), carried by a neutrally stable recurrence for 320 steps; a mask
    # or indexing fault is O(|u|)
    ref = finals["plain (run_leapfrog_scan)"]
    scale = float(ref.u.abs().max())
    for name in list(runs)[1:]:
        for field in ("u", "u_prev"):
            check(f"{name} {field} vs plain", getattr(finals[name], field),
                  getattr(ref, field), 1e-3 * scale)


# ---------------------------------------------------------------------------
# phases 5 and 6: the CLIs
# ---------------------------------------------------------------------------
def _case(work: Path, preset: str = "standing-mode-wsol", **over) -> Path:
    case = json.loads((ROOT / "parameters" / f"{preset}.json").read_text())
    case.update({"Nel": "640", "Dt": "8e-5", "Save Solution": "false"})
    case.update(over)
    path = work / f"{preset}.json"
    path.write_text(json.dumps(case, indent=2))
    return path


def _cli(family: str, case: Path, out: Path, device: str, quiet=True,
         flags=()):
    import importlib
    mod = importlib.import_module(f"tpuwave_torch.cli.{family}")
    argv = [str(case), "--device", device, "--results-root",
            str(out / "res"), "--mesh-root", str(out / "mesh"), *flags]
    if quiet:
        argv.append("--quiet")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{family} --device {device} exited {rc}:\n"
                             f"{buf.getvalue()[-2000:]}")
    return wall, buf.getvalue()


def _quantum(s: str) -> float:
    """One unit in the last printed digit of a CSV number."""
    mant = s.lower().split("e")[0]
    exp = int(s.lower().split("e")[1]) if "e" in s.lower() else 0
    dec = len(mant.split(".")[1]) if "." in mant else 0
    return 10.0 ** (exp - dec)


def _compare_csvs(a: Path, b: Path, its_tol: int = 1) -> int:
    """CSV rows of two runs: numbers within rtol 1e-9 plus one unit in
    the last printed digit (the files print 7 or 11 significant digits);
    iteration counts within +-its_tol; the wall-clock column skipped."""
    n = 0
    for fa in sorted(a.rglob("*.csv")):
        fb = b / fa.relative_to(a)
        ra = list(csv.reader(fa.open()))
        rb = list(csv.reader(fb.open()))
        if ra[0] != rb[0] or len(ra) != len(rb):
            raise AssertionError(f"{fa.name}: header or row count differ")
        head = ra[0]
        for x, y in zip(ra[1:], rb[1:]):
            for col, u, v in zip(head, x, y):
                if u == v or col == "elapsed_time_s":
                    continue
                if col.startswith("iterations"):
                    if abs(int(u) - int(v)) > its_tol:
                        raise AssertionError(f"{fa.name} {col}: {u} vs {v}")
                    continue
                fu, fv = float(u), float(v)
                tol = 1e-9 * max(abs(fu), abs(fv)) + max(_quantum(u),
                                                         _quantum(v))
                if abs(fu - fv) > tol:
                    raise AssertionError(f"{fa.name} {col}: {u} vs {v}")
            n += 1
    return n


def phase_cli(torch, kn, work: Path):
    say(f"phase 5: both CLIs, standing mode, 640^2 elements, dt 8e-5, "
        f"{CLI_AGREE_STEPS} steps, f64, Log Every 1: --device cuda against "
        f"--device cpu")
    for family, over in (("newmark", {"Beta": "0.25"}),
                         ("theta", {"Theta": "0.5"})):
        case = _case(work, T=str(CLI_AGREE_STEPS * 8e-5),
                     **{"Log Every": "1"}, **over)
        before = kn.LAUNCHES["constrained_stencil_apply"]
        w_cuda, _ = _cli(family, case, work / family / "cuda", "cuda")
        n_launch = kn.LAUNCHES["constrained_stencil_apply"] - before
        w_cpu, _ = _cli(family, case, work / family / "cpu", "cpu")
        rows = _compare_csvs(work / family / "cuda" / "res",
                             work / family / "cpu" / "res")
        say(f"  {family:<8} cuda {w_cuda:7.2f} s  cpu {w_cpu:7.2f} s  "
            f"{rows} CSV rows agree  B3 launches {n_launch}")
        if n_launch <= 0:
            raise AssertionError(f"{family}: the cuda run launched no "
                                 "constrained_stencil_apply kernel")

    say("phase 6: newmark beta 1/4, standing mode, 640^2 elements, "
        "dt 8e-5, T 0.05, f64, logging off, on cuda")
    case = _case(work, T="0.05", Beta="0.25", Gamma="0.5",
                 **{"Enable Logging": "false"})
    out = work / "full"
    wall, text = _cli("newmark", case, out, "cuda", quiet=False)
    conv = list(csv.DictReader(
        (out / "res" / "newmark-standing-mode-wsol" /
         "convergence.csv").open()))[-1]
    rel_l2 = float(conv["rel_L2_error_final"])
    elapsed = float(conv["elapsed_time_s"])
    steps = [ln for ln in text.splitlines()
             if ln.startswith(("Simulation completed", "Total CG"))]
    for ln in steps:
        say(f"  {ln}")
    n_steps = int(steps[0].split(":")[1].split()[0])
    dofs = 641 * 641
    say(f"  CLI wall {wall:.2f} s (time loop {elapsed:.3f} s, "
        f"{dofs * n_steps / elapsed:.4e} DoF*steps/s)")
    rel = abs(rel_l2 - TPUWAVE_REL_L2) / TPUWAVE_REL_L2
    say(f"  final rel L2 {rel_l2:.6e}, tpuwave {TPUWAVE_REL_L2:.10e}, "
        f"rel diff {rel:.2e} (bound 1e-6) {'ok' if rel <= 1e-6 else 'FAIL'}")
    if rel > 1e-6:
        raise AssertionError("final rel L2 differs from tpuwave's")
    # phase 23 (a) runs the same file on the parity engine
    return int(steps[1].split(":")[1].split(",")[0])


# ---------------------------------------------------------------------------
# phases 7 to 9: path B, the implicit solver family
# ---------------------------------------------------------------------------
SOLVER_RUNS = (
    # family, flags, overrides (standing mode, 640^2, FAMILY_STEPS, f64)
    ("newmark", ("--solver", "2term", "--precond", "mg"),
     {"Beta": "0.25", "Dt": "1e-2"}),
    ("theta", ("--precond", "auto"), {"Theta": "0.5", "Dt": "1e-2"}),
    ("newmark", ("--solver", "cheby"), {"Beta": "0.25", "Dt": "8e-5"}),
    ("theta", ("--precond", "chebyshev"), {"Theta": "0.5", "Dt": "8e-5"}),
)


def phase_solvers(torch, kn, work: Path):
    from tpuwave_torch.models.fast_engine import make_fast_solver
    from tpuwave_torch.utils.params import load_params

    say(f"phase 7: the solver family, standing mode, 640^2 elements, "
        f"{FAMILY_STEPS} steps, f64, Log Every 1: --device cuda against "
        f"--device cpu (q = beta dt^2 / h^2 = 10.2 at dt 1e-2)")
    for family, flags, over in SOLVER_RUNS:
        case = _case(work, T=str(FAMILY_STEPS * float(over["Dt"])),
                     **{"Log Every": "1"}, **over)
        if "auto" in flags:
            resolved = make_fast_solver(load_params(str(case)), family,
                                        precond="auto",
                                        device="cpu").precond
            say(f"  {family} --precond auto resolves to {resolved}")
            if resolved != "mg":
                raise AssertionError("--precond auto did not resolve to mg")
        tag = f"{family} {' '.join(flags)}"
        out = work / "solvers" / tag.replace(" ", "_")
        before = dict(kn.LAUNCHES)
        w_cuda, _ = _cli(family, case, out / "cuda", "cuda", flags=flags)
        n = {k: kn.LAUNCHES[k] - before[k] for k in PATH_B}
        w_cpu, _ = _cli(family, case, out / "cpu", "cpu", flags=flags)
        rows = _compare_csvs(out / "cuda" / "res", out / "cpu" / "res")
        say(f"  {tag:<36} cuda {w_cuda:6.2f} s  cpu {w_cpu:6.2f} s  "
            f"{rows} CSV rows agree  launches {n}")
        # B4 smooths the MG fine level and runs the cheby solver's blocks;
        # the Chebyshev preconditioner is B3 applies
        need = ["constrained_stencil_apply"]
        if "chebyshev" not in flags:
            need.append("cheby_block")
        if "2term" in flags:
            need.append("recurrence_r0")
        for k in need:
            if n[k] <= 0:
                raise AssertionError(f"{tag}: the cuda run launched no {k}")


def phase_2term_2048(torch, kn, work: Path):
    say("phase 8: newmark beta 1/4 --solver 2term --precond mg, standing "
        "mode, 2048^2 elements (4.2 M DoF), dt 4e-3 (q = 16.8), T 0.2, "
        "f64, logging off, on cuda")
    case = _case(work, Nel="2048", Dt="4e-3", T="0.2", Beta="0.25",
                 Gamma="0.5", **{"Enable Logging": "false"})
    out = work / "full2048"
    wall, text = _cli("newmark", case, out, "cuda", quiet=False,
                      flags=("--solver", "2term", "--precond", "mg"))
    conv = list(csv.DictReader(
        (out / "res" / "newmark-standing-mode-wsol" /
         "convergence.csv").open()))[-1]
    rel_l2 = float(conv["rel_L2_error_final"])
    elapsed = float(conv["elapsed_time_s"])
    lines = [ln for ln in text.splitlines()
             if ln.startswith(("Simulation completed", "Total CG"))]
    for ln in lines:
        say(f"  {ln}")
    n_steps = int(lines[0].split(":")[1].split()[0])
    dofs = 2049 * 2049
    say(f"  CLI wall {wall:.2f} s (time loop {elapsed:.3f} s, "
        f"{elapsed / n_steps * 1e3:.2f} ms/step, "
        f"{dofs * n_steps / elapsed:.4e} DoF*steps/s)")
    want = TPUWAVE_REL_L2_2TERM_2048
    rel = abs(rel_l2 - want) / want
    say(f"  final rel L2 {rel_l2:.10e}, tpuwave {want:.10e}, rel diff "
        f"{rel:.2e} (bound 1e-6) {'ok' if rel <= 1e-6 else 'FAIL'}")
    if rel > 1e-6:
        raise AssertionError("final rel L2 differs from tpuwave's")


def _device_events(prof):
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def _call_kernels(torch, fn, n: int = DEVICE_CALLS) -> tuple:
    """(the device kernels one call of ``fn`` launches, by torch.profiler's
    names; the mean device time of a call in ms, from the kernels' own
    times, which no host delay moves) over ``n`` profiled calls after a
    warm one, each after an L2 flush as in cuda_ms; the flush's own
    kernels are left out."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    with profile(activities=acts) as prof:
        flush.fill_(0)
        torch.cuda.synchronize()
    skip = {e.key for e in _device_events(prof)}
    fn()
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for _ in range(n):
            flush.fill_(0)
            fn()
        torch.cuda.synchronize()
    events = [e for e in _device_events(prof) if e.key not in skip]
    names = [e.key[:40] for e in events for _ in range(e.count // n)]
    return names, sum(e.self_device_time_total for e in events) / n / 1e3


def _device_time(prof):
    """(device events: kernels and copies, device-busy ms) of a profiler
    window, or None when the profiler saw no device activity."""
    events = _device_events(prof)
    n = sum(e.count for e in events)
    us = sum(e.self_device_time_total for e in events)
    return (n, us / 1e3) if n else None


def phase_profile(torch, kn, work: Path):
    """Where path B's time goes: one V-cycle at 2049^2 and one 2-term
    MG CLI run at 640^2, each under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    from tpuwave_torch.models.fast_engine import make_fast_solver
    from tpuwave_torch.utils.params import load_params

    say("phase 9: torch.profiler over path B")
    case = _case(work, Nel="2048", Dt="4e-3", T="0.2", Beta="0.25",
                 **{"Enable Logging": "false"})
    solver = make_fast_solver(load_params(str(case)), "newmark",
                              solver="2term", precond="mg", device="cuda")
    prec = solver._prec_sys
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    b = torch.rand(prec.levels[0].shape, generator=gen, device="cuda",
                   dtype=torch.float64)
    b = torch.where(~kn.pinned_mask(b.shape, b.device), b, 0.0)
    prec(b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        prec(b)
    torch.cuda.synchronize()
    host_plain = (time.perf_counter() - t0) / 10
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        prec(b)
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
    dev_t = _device_time(prof)
    if dev_t is None:
        say("  profiler saw no device time: not measured")
        return
    say(f"  one V-cycle, {len(prec.levels)} levels, fine 2049^2 f64: "
        f"{dev_t[0]} device events, device busy {dev_t[1]:.3f} ms; wall "
        f"{host_plain * 1e3:.3f} ms (mean of 10, host clock), "
        f"{host * 1e3:.3f} ms under the profiler")
    for e in sorted(_device_events(prof),
                    key=lambda e: -e.self_device_time_total)[:6]:
        us = e.self_device_time_total
        say(f"    {us / 1e3:7.3f} ms {e.count:5d}x = "
            f"{us / 1e3 / dev_t[1]:.3f} of device time  {e.key[:60]}")
    case = _case(work, T=str(20 * 1e-2), Dt="1e-2", Beta="0.25",
                 **{"Enable Logging": "false"})
    with profile(activities=acts) as prof:
        wall, text = _cli("newmark", case, work / "prof", "cuda",
                          quiet=False, flags=("--solver", "2term",
                                              "--precond", "mg"))
        torch.cuda.synchronize()
    dev_t = _device_time(prof)
    its = [ln for ln in text.splitlines() if ln.startswith("Total CG")]
    say(f"  2-term MG CLI run, 640^2, 20 steps (logging off): wall "
        f"{wall:.3f} s, {dev_t[0]} device events, device busy "
        f"{dev_t[1]:.1f} ms, idle share {1 - dev_t[1] / 1e3 / wall:.3f} "
        f"(under the profiler); {its[0] if its else ''}")
    top = sorted(_device_events(prof),
                 key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        say(f"    {e.self_device_time_total / 1e3:9.2f} ms {e.count:7d}x "
            f"{e.key[:70]}")


# ---------------------------------------------------------------------------
# phases 10 to 12: path C, the R = 2 (P2) engine
# ---------------------------------------------------------------------------
P2_RUNS = (
    # family, flags, overrides (standing mode, R 2, 160^2, FAMILY_STEPS,
    # f64);
    # q = beta dt^2 / h^2 = (theta dt / h)^2 = 10.2 at dt 4e-2
    ("newmark", ("--solver", "2term", "--precond", "mg"),
     {"Beta": "0.25", "Dt": "4e-2"}),
    ("newmark", ("--precond", "mg"), {"Beta": "0.25", "Dt": "4e-2"}),
    ("newmark", ("--solver", "cheby"), {"Beta": "0.25", "Dt": "2e-3"}),
    ("theta", ("--precond", "auto"), {"Theta": "0.5", "Dt": "4e-2"}),
    ("theta", ("--precond", "chebyshev"), {"Theta": "0.5", "Dt": "2e-3"}),
    ("theta", ("--precond", "jacobi"), {"Theta": "0.5", "Dt": "2e-3"}),
)


def _p2_case(work: Path, family_over: dict, **over) -> Path:
    """Phase 10's R = 2 case: standing mode, 160^2, FAMILY_STEPS steps."""
    return _case(work, Nel="160", R="2",
                 T=str(FAMILY_STEPS * float(family_over["Dt"])),
                 **{"Log Every": "1"}, **family_over, **over)


def phase_p2_cli(torch, kn, work: Path):
    from tpuwave_torch.models.fast_engine import make_fast_solver
    from tpuwave_torch.utils.params import load_params

    say("phase 10: the R = 2 solver family, standing mode, 160^2 elements "
        f"(103,041 DoF), {FAMILY_STEPS} steps, f64, Log Every 1: --device "
        "cuda against --device cpu (CSVs within rtol 1e-9, per-step CG "
        "counts equal)")
    for family, flags, over in P2_RUNS:
        case = _p2_case(work, over)
        if "auto" in flags:
            resolved = make_fast_solver(load_params(str(case)), family,
                                        precond="auto",
                                        device="cpu").precond
            say(f"  {family} --precond auto resolves to {resolved}")
            if resolved != "mg":
                raise AssertionError("--precond auto did not resolve to mg")
        tag = f"{family} {' '.join(flags)}"
        out = work / "p2" / tag.replace(" ", "_")
        before = dict(kn.LAUNCHES)
        w_cuda, _ = _cli(family, case, out / "cuda", "cuda", flags=flags)
        n = {k: kn.LAUNCHES[k] - before[k] for k in PATH_C}
        w_cpu, _ = _cli(family, case, out / "cpu", "cpu", flags=flags)
        rows = _compare_csvs(out / "cuda" / "res", out / "cpu" / "res",
                             its_tol=0)
        say(f"  {tag:<36} cuda {w_cuda:6.2f} s  cpu {w_cpu:6.2f} s  "
            f"{rows} CSV rows agree  launches {n}")
        need = ["p2_constrained_apply"]
        if "mg" in flags or "auto" in flags:
            need += ["p2_presmooth", "p2_postsmooth", "cheby_block",
                     "constrained_stencil_apply"]
        for k in need:
            if n[k] <= 0:
                raise AssertionError(f"{tag}: the cuda run launched no {k}")


def _cli_summary(out: Path, text: str):
    """(final rel L2, time loop s, steps, CG iterations) of a CLI run."""
    conv = list(csv.DictReader(
        (out / "res" / "newmark-standing-mode-wsol" /
         "convergence.csv").open()))[-1]
    lines = [ln for ln in text.splitlines()
             if ln.startswith(("Simulation completed", "Total CG"))]
    for ln in lines:
        say(f"  {ln}")
    n_steps = int(lines[0].split(":")[1].split()[0])
    its = int(lines[1].split(":")[1].split(",")[0])
    return (float(conv["rel_L2_error_final"]),
            float(conv["elapsed_time_s"]), n_steps, its)


def phase_p2_1024(torch, kn, work: Path):
    say("phase 11: newmark beta 1/4 --solver 2term --precond mg, R = 2, "
        "standing mode, 1024^2 elements (4,198,401 DoF), dt 4e-3, T 0.2, "
        "f64, logging off, on cuda")
    case = _case(work, Nel="1024", R="2", Dt="4e-3", T="0.2", Beta="0.25",
                 Gamma="0.5", **{"Enable Logging": "false"})
    out = work / "p2_1024"
    wall, text = _cli("newmark", case, out, "cuda", quiet=False,
                      flags=("--solver", "2term", "--precond", "mg"))
    rel_l2, elapsed, n_steps, its = _cli_summary(out, text)
    say(f"  CLI wall {wall:.2f} s (time loop {elapsed:.3f} s, "
        f"{elapsed / n_steps * 1e3:.2f} ms/step, "
        f"{4198401 * n_steps / elapsed:.4e} DoF*steps/s); CG iterations "
        f"{its}, tpuwave {TPUWAVE_ITERS_P2_2TERM_1024} (the smoother's "
        f"lambda_max starts from tpuwave's vector: equal counts expected)")
    want = TPUWAVE_REL_L2_P2_2TERM_1024
    rel = abs(rel_l2 - want) / want
    ok = rel <= 1e-6 and its == TPUWAVE_ITERS_P2_2TERM_1024
    say(f"  final rel L2 {rel_l2:.10e}, tpuwave {want:.10e}, rel diff "
        f"{rel:.2e} (bound 1e-6) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("final rel L2 or CG count differs from "
                             "tpuwave's")


def phase_p2_4096(torch, kn, work: Path):
    say("phase 11b: newmark beta 1/4 --f32 --precond mg (3term), R = 2, "
        "standing mode, 4096^2 elements (67,125,249 DoF), dt 4e-3, 10 "
        "steps, logging off, on cuda")
    case = _case(work, Nel="4096", R="2", Dt="4e-3", T=str(10 * 4e-3),
                 Beta="0.25", Gamma="0.5", **{"Enable Logging": "false"})
    out = work / "p2_4096"
    torch.cuda.reset_peak_memory_stats()
    wall, text = _cli("newmark", case, out, "cuda", quiet=False,
                      flags=("--f32", "--precond", "mg"))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rel_l2, elapsed, n_steps, its = _cli_summary(out, text)
    say(f"  CLI wall {wall:.2f} s (time loop {elapsed:.3f} s, "
        f"{elapsed / n_steps * 1e3:.2f} ms/step, "
        f"{67125249 * n_steps / elapsed:.4e} DoF*steps/s); CG iterations "
        f"{its}; peak device memory {peak:.2f} GiB; final rel L2 "
        f"{rel_l2:.6e} (bound: finite and < 1e-3)")
    if not (rel_l2 == rel_l2 and rel_l2 < 1e-3):
        raise AssertionError("phase 11b: final rel L2 is not finite "
                             "and < 1e-3")


def phase_p2_profile(torch, kn, work: Path):
    """Where path C's time goes: one P2 V-cycle at 1024^2 and phase 10's
    2-term MG run, each under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    from tpuwave_torch.models.fast_engine import make_fast_solver
    from tpuwave_torch.utils.params import load_params

    say("phase 12: torch.profiler over path C")
    case = _case(work, Nel="1024", R="2", Dt="4e-3", T="0.2", Beta="0.25",
                 **{"Enable Logging": "false"})
    solver = make_fast_solver(load_params(str(case)), "newmark",
                              solver="2term", precond="mg", device="cuda")
    prec = solver._prec_sys
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    b = torch.rand((4, *solver._cshape), generator=gen, device="cuda",
                   dtype=torch.float64)
    b = torch.where(solver.interior, b, 0.0)
    prec(b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        prec(b)
    torch.cuda.synchronize()
    host_plain = (time.perf_counter() - t0) / 10
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        prec(b)
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
    dev_t = _device_time(prof)
    if dev_t is None:
        say("  profiler saw no device time: not measured")
        return
    say(f"  one P2 V-cycle, P1 tail of {len(prec.p1_cycle.levels)} levels, "
        f"canvases 4 x 1027^2 f64: {dev_t[0]} device events, device busy "
        f"{dev_t[1]:.3f} ms; wall {host_plain * 1e3:.3f} ms (mean of 10, "
        f"host clock), {host * 1e3:.3f} ms under the profiler")
    top = sorted(_device_events(prof),
                 key=lambda e: -e.self_device_time_total)[:6]
    for e in top:
        say(f"    {e.self_device_time_total / 1e3:9.3f} ms {e.count:7d}x "
            f"{e.key[:70]}")
    family, flags, over = P2_RUNS[0]
    # device activity only: the host events of a whole run (~10^6) make
    # the profiler's own accounting take minutes
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall, text = _cli(family, _p2_case(work, over), work / "p2prof",
                          "cuda", quiet=False, flags=flags)
        torch.cuda.synchronize()
    dev_t = _device_time(prof)
    its = [ln for ln in text.splitlines() if ln.startswith("Total CG")]
    say(f"  phase 10's {family} {' '.join(flags)} run, 160^2, "
        f"{FAMILY_STEPS} steps, Log Every 1: wall {wall:.3f} s, "
        f"{dev_t[0]} device events, device busy {dev_t[1]:.1f} ms, idle share "
        f"{1 - dev_t[1] / 1e3 / wall:.3f} (under the profiler); "
        f"{its[0] if its else ''}")
    top = sorted(_device_events(prof),
                 key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        say(f"    {e.self_device_time_total / 1e3:9.2f} ms {e.count:7d}x "
            f"{e.key[:70]}")


# ---------------------------------------------------------------------------
# phase 3 (FWI), phases 16 and 17: path E, the FWI propagator
# ---------------------------------------------------------------------------
def _fwi_disk(np, prob):
    """bench_fwi_adjoint.py's true model: c2 0.65 on the cells whose
    centroid lies in the disk of radius 0.18 at (0.6, 0.5), 1 elsewhere."""
    cent = prob.mesh.vertex_coords[np.asarray(prob.mesh.cells)].mean(1)
    inside = np.sum((cent - [0.6, 0.5]) ** 2, 1) < 0.18 ** 2
    return np.where(inside, 0.65, 1.0)


def _fwi_bound(torch, dtype, want, n_steps: int = 1) -> float:
    """f64: 1e-12 x max(1, max|plain|). f32: f32_bound with a term scale
    of 4 x max(1, max|plain|) (|2u| + |u_prev| + coef sum|planes| |u| with
    coef sum|planes| = 8 (dt / h)^2 c2 < 0.4 here), over n_steps steps."""
    peak = max(1.0, float(want.double().abs().max()))
    if dtype == torch.float64:
        return 1e-12 * peak
    return f32_bound(4.0 * peak, n_steps)


def phase_fwi_kernels(torch, dev, kn) -> dict:
    """Phase 3, the FWI kernels B14-B17 at phase 17's shape (1025^2 f32,
    k = 8) and at 513^2 f64, undamped and damped (sponge ring), on random
    fields that are non-zero on the pinned nodes, the planes of
    bench_fwi_adjoint.py's disk model, a source one row above and one
    column left of a tile's interior, and receivers on and across tile
    edges (interpolated: three points each)."""
    import numpy as np
    from tpuwave_torch.models.inverse import FwiProblem
    from tpuwave_torch.ops import kernels_varcoef as kv

    gen = torch.Generator(device=dev)
    gen.manual_seed(1357)
    max_smem = kn._max_smem(kn._lib(), "phase 3", dev)
    k = 8
    say(f"phase 3 (FWI): B14-B17 against their plain versions, k = {k} "
        "fused steps (bounds: see _fwi_bound; a rerun bitwise equal); "
        "bytes: every input grid read once, every output grid written "
        "once; operations counted per node and step: B14 17 (19 damped), "
        "B15 17 (19), B16 49, B17 49 (53); the card allows "
        f"{max_smem} B of shared memory per block")
    rows, main = {}, None
    for nel, dt, dtype_name, n_k, n_p in FWI_KERNEL_CASES:
        dtype = getattr(torch, dtype_name)
        recs = [(0.25, 0.5), (0.5, 0.25), (64.5 / nel, 31.5 / nel),
                *FWI_RECEIVERS]
        prob = FwiProblem((nel, nel), UNIT_SQUARE, dt, k, source=FWI_SOURCE,
                          receivers=recs, interp_receivers=True,
                          sponge_width=0.1, boundary_save="ring",
                          dtype=dtype, device=dev)
        planes = prob._stacked_planes(torch.tensor(
            _fwi_disk(np, prob), dtype=dtype, device=dev))
        coef = prob.dt ** 2 / prob._det_j
        dnum, dden, _ = prob._kernel_damp
        ring, rec = prob._ring, prob._receivers
        shape = prob._grid
        item = planes.element_size()
        grid_b = shape[0] * shape[1] * item
        n_node = shape[0] * shape[1]
        name = f"{shape[0]}^2 {dtype_name}"
        if main is None:
            main = name

        def src_near(tile, flip):
            """A node one row above (or, ``flip``, below) and one column
            left (right) of the interior of a tile."""
            t = max(1, min(7, (shape[0] - 1) // tile - 1))
            return (t * tile, t * tile - 1) if flip else (t * tile - 1,
                                                          t * tile)

        def rnd(*lead):
            return (2 * torch.rand((*lead, *shape), generator=gen,
                                   device=dev, dtype=torch.float64)
                    - 1).to(dtype)

        def vec(*s):
            return (2 * torch.rand(s, generator=gen, device=dev,
                                   dtype=torch.float64) - 1).to(dtype)

        def measure(tag, fn, ref_fn, n_bytes, n_ops, n_steps, outs,
                    timed=None):
            """Check fn against ref_fn and time both (``timed`` = the
            (kernel, plain) calls to time where fn copies an in-place
            operand)."""
            got, again, want = fn(), fn(), ref_fn()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{tag}: a rerun is not bitwise equal")
            t_fn, t_ref = timed or (fn, ref_fn)
            ms, dms = kernel_ms(t_fn, n_k)
            pms = cuda_ms(t_ref, n_p, warm=1)
            r = row(0.0, ms, pms, n_bytes, n_ops, dtype, dms)
            errs = [check(f"{tag} {o}", g, w, _fwi_bound(torch, dtype, w,
                                                         n_steps),
                          timing(r) if i == len(got) - 1 else "")
                    for i, (o, g, w) in enumerate(zip(outs, got, want))]
            r["err"] = max(errs)
            rows[tag] = r

        # B14: the half start and single steps
        u, up = rnd(), rnd()
        for damped in (False, True):
            damp = (dnum, dden) if damped else None
            measure(f"B14 varcoef_step {name} "
                    f"{'damped' if damped else 'undamped'}",
                    lambda: (kv.varcoef_leapfrog_step(u, up, planes, coef,
                                                      damp),),
                    lambda: (kv.varcoef_leapfrog_step_reference(
                        u, up, planes, coef, damp),),
                    (10 + 2 * damped) * grid_b, (17 + 2 * damped) * n_node,
                    1, ["u'"])
        # B15: k fused steps
        w = vec(k)
        for damped in (False, True):
            ms_planes = prob._planes9_forward(planes) if damped else planes
            n_pl = ms_planes.shape[0]
            tile = kv.multistep_tile(k, dtype)
            src = src_near(tile, False)
            rg = ring if damped else None
            side = tile + 2 * (k + 1)
            say(f"  B15 {name} {n_pl} planes: tile {tile}, slab {side}^2, "
                f"source {src}")
            ring_b = 2 * k * (shape[0] + shape[1]) * item if damped else 0
            measure(f"B15 varcoef_multistep k={k} {name} "
                    f"{'damped ring' if damped else 'undamped'}",
                    lambda: kv.varcoef_leapfrog_multistep(
                        u, up, ms_planes, w, src, coef, rec, rg),
                    lambda: kv.varcoef_leapfrog_multistep_reference(
                        u, up, ms_planes, w, src, coef, rec, rg),
                    (4 + n_pl) * grid_b + ring_b,
                    (17 + 2 * damped) * k * n_node, k,
                    ["u", "u_prev", "traces", "ring_rows", "ring_cols"])
        # B16: one backward step (wbar in place: each checked call gets a
        # copy; the timed calls update one buffer again and again)
        un, uc, lam, lp = rnd(), rnd(), rnd(), rnd()
        wbar0 = rnd(7)
        wt, wp = wbar0.clone(), wbar0.clone()
        measure(f"B16 varcoef_adjoint_step {name}",
                lambda: kv.varcoef_adjoint_step(
                    un, uc, lam, lp, planes, wbar0.clone(), coef),
                lambda: kv.varcoef_adjoint_step_reference(
                    un, uc, lam, lp, planes, wbar0.clone(), coef),
                28 * grid_b, 49 * n_node, 1,
                ["u_prev", "lam", "lam_partial", "wbar"],
                (lambda: kv.varcoef_adjoint_step(un, uc, lam, lp, planes,
                                                 wt, coef),
                 lambda: kv.varcoef_adjoint_step_reference(
                     un, uc, lam, lp, planes, wp, coef)))
        # B17: k fused backward steps
        pts = (rec.rows, rec.cols)
        inj = vec(k, rec.rows.numel())
        for damped in (False, True):
            ms_planes = prob._planes9_adjoint(planes) if damped else planes
            n_pl = ms_planes.shape[0]
            tile = kv.adjoint_tile(k, n_pl, dtype, max_smem)
            src = src_near(tile, True)
            side = tile + 2 * k
            say(f"  B17 {name} {n_pl} planes: tile {tile}, slab {side}^2, "
                f"source {src}")
            ring_args, ring_b = (), 0
            if damped:
                ring_args = (ring, vec(k, 2, shape[1]), vec(k, shape[0], 2))
                ring_b = 2 * k * (shape[0] + shape[1]) * item
            measure(f"B17 varcoef_adjoint_multistep k={k} {name} "
                    f"{'damped ring' if damped else 'undamped'}",
                    lambda: kv.varcoef_adjoint_multistep(
                        un, uc, lam, lp, ms_planes, wbar0.clone(), w, inj,
                        src, coef, pts, *ring_args),
                    lambda: kv.varcoef_adjoint_multistep_reference(
                        un, uc, lam, lp, ms_planes, wbar0.clone(), w, inj,
                        src, coef, pts, *ring_args),
                    (22 + n_pl) * grid_b + ring_b,
                    (49 + 4 * damped) * k * n_node, k,
                    ["u_next", "u_cur", "lam", "lam_partial", "wbar",
                     "wavbar"],
                    (lambda: kv.varcoef_adjoint_multistep(
                        un, uc, lam, lp, ms_planes, wt, w, inj, src, coef,
                        pts, *ring_args),
                     lambda: kv.varcoef_adjoint_multistep_reference(
                         un, uc, lam, lp, ms_planes, wp, w, inj, src, coef,
                         pts, *ring_args)))
        # B17 at k = 1, B16's step as one launch of the k-step kernel
        w1, inj1 = w[:1].contiguous(), inj[:1].contiguous()
        src = src_near(kv.adjoint_tile(1, 7, dtype, max_smem), True)
        measure(f"B17 varcoef_adjoint_multistep k=1 {name} undamped",
                lambda: kv.varcoef_adjoint_multistep(
                    un, uc, lam, lp, planes, wbar0.clone(), w1, inj1, src,
                    coef, pts),
                lambda: kv.varcoef_adjoint_multistep_reference(
                    un, uc, lam, lp, planes, wbar0.clone(), w1, inj1, src,
                    coef, pts),
                29 * grid_b, 49 * n_node, 1,
                ["u_next", "u_cur", "lam", "lam_partial", "wbar", "wavbar"],
                (lambda: kv.varcoef_adjoint_multistep(
                    un, uc, lam, lp, planes, wt, w1, inj1, src, coef, pts),
                 lambda: kv.varcoef_adjoint_multistep_reference(
                     un, uc, lam, lp, planes, wp, w1, inj1, src, coef,
                     pts)))
        del prob, planes, u, up, un, uc, lam, lp, wbar0, wt, wp
    return {
        "varcoef_leapfrog_step": rows[f"B14 varcoef_step {main} undamped"],
        "varcoef_leapfrog_multistep": rows[
            f"B15 varcoef_multistep k={k} {main} undamped"],
        "varcoef_adjoint_step": rows[f"B16 varcoef_adjoint_step {main}"],
        "varcoef_adjoint_multistep": rows[
            f"B17 varcoef_adjoint_multistep k={k} {main} undamped"]}


def _fwi_run(torch, prob, c2_true, c2_init):
    """(traces at c2_true, misfit and c2 gradient at c2_init, wavelet
    gradient), all on the host."""
    obs = prob.simulate(c2_true)
    v, g = prob.misfit_and_grad(c2_init, obs)
    w = prob.wavelet.clone().requires_grad_(True)
    with torch.enable_grad():
        (wg,) = torch.autograd.grad(prob.misfit(c2_init, obs, wavelet=w), w)
    return [x.detach().double().cpu() for x in (obs, v, g, wg)]


def phase_fwi_agree(torch):
    import numpy as np
    from tpuwave_torch.models.inverse import FwiProblem

    say("phase 16: FwiProblem, (48, 40) elements, dt 2e-3, 96 steps, f64 "
        "(scripts/tpu_smoke.py's FWI problem): the kernel engine on cuda "
        "(k = 8: B14-B17) against the same engine on the CPU (the plain "
        "versions); traces and misfit within rtol 1e-12, c2 and wavelet "
        "gradients within rtol 1e-9 (of each array's peak)")
    ring = dict(sponge_width=0.15, boundary_save="ring")
    for label, kw in (("walls, nearest", {}),
                      ("walls, interpolated", dict(interp_receivers=True)),
                      ("sponge ring, nearest", ring),
                      ("sponge ring, interpolated",
                       dict(interp_receivers=True, **ring))):
        runs = {}
        for dev in ("cuda", "cpu"):
            p = FwiProblem((48, 40), UNIT_SQUARE, 2e-3, 96,
                           source=(0.45, 0.55),
                           receivers=[(0.4, 0.45), (0.55, 0.62)],
                           dtype=torch.float64, device=dev, **kw)
            rng = np.random.default_rng(0)
            c2t = torch.tensor(1.0 + 0.3 * rng.random(p.n_cells),
                               dtype=torch.float64, device=p.device)
            runs[dev] = _fwi_run(torch, p, c2t, torch.ones_like(c2t))
        rel = [float((a - b).abs().max() / max(b.abs().max(), 1e-300))
               for a, b in zip(runs["cuda"], runs["cpu"])]
        ok = rel[0] <= 1e-12 and rel[1] <= 1e-12 and max(rel[2:]) <= 1e-9
        say(f"  {label:<26} rel diff: traces {rel[0]:.1e} misfit "
            f"{rel[1]:.1e} grad c2 {rel[2]:.1e} grad wavelet {rel[3]:.1e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"phase 16 {label}: cuda and cpu disagree")


def _profile_fwi(torch, fn):
    """One torch.profiler trace of ``fn`` (a misfit_and_grad): the
    device-busy share of its wall and each FWI kernel's share of the
    device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_t = _device_time(prof)
    if dev_t is None:
        say("  profile of misfit_and_grad: the profiler saw no device time "
            "(not measured)")
        return
    events = _device_events(prof)
    say(f"  profile of one misfit_and_grad (hard walls, kernel engine): "
        f"wall {wall * 1e3:.1f} ms under the profiler, {dev_t[0]} device "
        f"events, device busy {dev_t[1]:.1f} ms = "
        f"{dev_t[1] / 1e3 / wall:.3f} of the wall")
    for tag, part in (("B17", "varcoef_adjoint_multistep_kernel"),
                      ("B15", "varcoef_multistep_kernel"),
                      ("B16", "varcoef_adjoint_step_kernel"),
                      ("B14", "varcoef_step_kernel")):
        hit = [e for e in events if part in e.key]
        us = sum(e.self_device_time_total for e in hit)
        say(f"    {tag}: {us / 1e3:8.2f} ms in {sum(e.count for e in hit)} "
            f"launches = {us / 1e3 / dev_t[1]:.3f} of device time")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    for e in top:
        say(f"    {e.self_device_time_total / 1e3:8.2f} ms {e.count:6d}x "
            f"{e.key[:70]}")


def phase_fwi_1024(torch, dev):
    import numpy as np
    from tpuwave_torch.models.inverse import FwiProblem

    nel, dt, n = FWI_NEL, FWI_DT, FWI_STEPS
    f32, f64 = torch.float32, torch.float64
    say(f"phase 17: FwiProblem at scripts/bench_fwi_adjoint.py's "
        f"configuration: {nel}^2 elements, dt {dt}, {n} steps, source "
        f"{FWI_SOURCE}, six receivers, steps_per_call 8, observed traces "
        f"of the 0.65 disk (f64 stencil engine), misfit at c2 = "
        f"{FWI_C2_INIT}, f32, on {dev}; simulate and misfit_and_grad: best of 3 after a warm run "
        f"(host clock around a synchronize); gate: the kernel engine's c2 "
        f"gradient within 2x the stencil engine's rel L2 error against the "
        f"f64 stencil engine's")

    def prob(engine, dtype, **kw):
        return FwiProblem((nel, nel), UNIT_SQUARE, dt, n, source=FWI_SOURCE,
                          receivers=FWI_RECEIVERS, dtype=dtype, device=dev,
                          engine=engine, steps_per_call=8, **kw)

    for label, kw in (("hard walls", {}),
                      ("sponge ring 0.1", dict(sponge_width=0.1,
                                               boundary_save="ring"))):
        ref = prob("stencil", f64, **kw)
        c2_np = _fwi_disk(np, ref)
        obs64 = ref.simulate(torch.tensor(c2_np, dtype=f64, device=dev))
        t0 = time.perf_counter()
        _, g64 = ref.misfit_and_grad(torch.full(
            (ref.n_cells,), FWI_C2_INIT, dtype=f64, device=dev), obs64)
        torch.cuda.synchronize()
        say(f"  {label:<16} stencil  f64 misfit_and_grad "
            f"{(time.perf_counter() - t0) * 1e3:9.1f} ms (one run)")
        del ref
        errs = {}
        for engine in ("kernel", "stencil"):
            p = prob(engine, f32, **kw)
            c2t = torch.tensor(c2_np, dtype=f32, device=dev)
            c2i = torch.full_like(c2t, FWI_C2_INIT)
            obs = obs64.float()
            t_sim, _ = _best_of(torch, lambda: p.simulate(c2t))
            torch.cuda.reset_peak_memory_stats()
            t_vg, (v, g) = _best_of(torch, lambda: p.misfit_and_grad(c2i,
                                                                     obs))
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            errs[engine] = _rel_l2(torch, g, g64)
            extra = f", k {p._k}" if engine == "kernel" else ""
            say(f"  {label:<16} {engine:<8} f32 simulate {t_sim * 1e3:9.1f} "
                f"ms, misfit_and_grad {t_vg * 1e3:9.1f} ms, misfit "
                f"{float(v):.6e}, grad rel L2 error {errs[engine]:.3e}, "
                f"peak device memory {peak:.3f} GiB{extra}")
            if engine == "kernel" and not kw:
                _profile_fwi(torch, lambda: p.misfit_and_grad(c2i, obs))
                res = p.invert(obs, c2i, n_iter=3, learning_rate=0.01,
                               bounds=(0.4, 1.5))
                # Adam moves every cell by ~lr per step, so a step may
                # overshoot: the gate is the misfit after the last update
                # below the start's
                after = float(p.misfit(res.c2, obs))
                falls = after < res.misfits[0]
                say(f"  {label:<16} invert (Adam, lr 0.01, bounds (0.4, "
                    f"1.5)): misfits {', '.join(f'{m:.6e}' for m in res.misfits)}"
                    f", after the last update {after:.6e} "
                    f"{'falls' if falls else 'does NOT fall'}")
                if not falls:
                    raise AssertionError("phase 17: invert's misfit does "
                                         "not fall")
            del p
        ok = errs["kernel"] <= 2.0 * errs["stencil"]
        say(f"  {label:<16} gate: kernel {errs['kernel']:.3e} <= 2 x stencil "
            f"{errs['stencil']:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"phase 17 {label}: the kernel engine's "
                                 "f32 gradient fails the gate")
        del obs64, g64

    p = FwiProblem((256, 256), UNIT_SQUARE, 2.5e-3, 200, source=FWI_SOURCE,
                   receivers=FWI_RECEIVERS, dtype=f64, device=dev)
    c2t = torch.tensor(_fwi_disk(np, p), dtype=f64, device=dev)
    v, g = p.misfit_and_grad(torch.full_like(c2t, 0.9), p.simulate(c2t))
    got = (float(v), float(torch.linalg.vector_norm(g)))
    rel = [abs(a - b) / b for a, b in zip(got, TPUWAVE_FWI_256)]
    ok = max(rel) <= 1e-9
    say(f"  256^2, 200 steps, f64, kernel engine (k {p._k}): misfit "
        f"{got[0]!r} (tpuwave {TPUWAVE_FWI_256[0]!r}), ||grad|| {got[1]!r} "
        f"(tpuwave {TPUWAVE_FWI_256[1]!r}), rel diff {max(rel):.1e} (bound "
        f"1e-9) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase 17: the 256^2 run differs from "
                             "tpuwave's")


# ---------------------------------------------------------------------------
# phases 18 and 19: path F, the driven explicit leapfrog and varying C
# ---------------------------------------------------------------------------
def _strip_drive(torch):
    """scripts/bench_driven.py's g (sin(4 pi t) on the y = 0, x <= 1/3
    strip) and f, as torch callables (t: a 0-d or a (k, 1) tensor)."""
    def g_fn(x, y, t):
        return torch.where((y <= 0.0) & (x <= 1.0 / 3.0),
                           torch.sin(4.0 * torch.pi * t), 0.0)

    def f_fn(x, y, t):
        return (torch.sin(2.0 * torch.pi * x) * torch.sin(torch.pi * y)
                * torch.cos(3.0 * t))
    return g_fn, f_fn


def _range_share(torch, fn, name: str):
    """(host seconds inside the profiler range ``name``, wall seconds) of
    one run of ``fn`` under torch.profiler (host activity only)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    inside = sum(e.cpu_time_total for e in prof.key_averages()
                 if e.key == name)
    return inside * 1e-6, wall


def phase_driven_4096(torch, kn):
    from tpuwave_torch.models.fast import EDGE_TABLES_RANGE, FastWaveSolver

    nel, dt, n = DRIVEN_NEL, DRIVEN_DT, DRIVEN_STEPS
    say(f"phase 18: the driven leapfrog at scripts/bench_driven.py's "
        f"defaults: {nel}^2 elements ({(nel + 1) ** 2:,} DoF), f32, dt {dt}, "
        f"{n} steps from rest, its strip drive and forcing, on cuda: "
        f"us/step and DoF*steps/s (best of 3 after a warm run, host clock "
        f"around a synchronize; for B6 also the host's time in its edge "
        f"tables, the four g_fn calls a chunk, against one run's wall, both "
        f"under torch.profiler); gate: each kernel leg's end state "
        f"within rel L2 1e-5 of its torch-ops leg's")
    fs = FastWaveSolver((nel, nel), UNIT_SQUARE, dt, beta=0.0,
                        dtype=torch.float32, device="cuda")
    g_fn, f_fn = _strip_drive(torch)

    def rest(xs, ys):
        return torch.zeros_like(xs)

    lf = fs.initial_leapfrog_state(rest, g_fn=g_fn)
    lf_f = fs.initial_leapfrog_state(rest, f_fn=f_fn, g_fn=g_fn)
    # the stamps stepped TO after u^1 (at t = dt)
    times = dt * (2.0 + torch.arange(n, dtype=torch.float64))
    legs = [("torch ops (run_leapfrog_driven)", None,
             lambda: fs.run_leapfrog_driven(lf, times, g_fn)),
            ("B1 (run_leapfrog_driven_kernel)", "torch ops",
             lambda: fs.run_leapfrog_driven_kernel(lf, times, g_fn)),
            ("torch ops + forcing", None,
             lambda: fs.run_leapfrog_driven(lf_f, times, g_fn, f_fn)),
            ("B1 + forcing", "torch ops + forcing",
             lambda: fs.run_leapfrog_driven_kernel(lf_f, times, g_fn, f_fn))]
    legs += [(f"B6 k={k} (run_leapfrog_driven_multistep)", "torch ops",
              lambda k=k: fs.run_leapfrog_driven_multistep(
                  lf, times, g_fn, steps_per_call=k)) for k in (8, 16, 32)]

    ends = {}
    for name, ref, fn in legs:
        before = dict(kn.LAUNCHES)
        best, out = _best_of(torch, fn)
        runs = {k: (kn.LAUNCHES[k] - before[k]) // 4
                for k in ("leapfrog_step", "leapfrog_multistep_driven")}
        key = name.split(" (")[0]
        ends[key] = out
        line = (f"  {name:<41} {best * 1e6 / n:9.1f} us/step  "
                f"{fs.n_dofs * n / best:.4e} DoF*steps/s  launches per run "
                f"B1 {runs['leapfrog_step']} B6 "
                f"{runs['leapfrog_multistep_driven']}")
        if key.startswith("B6 k="):
            g_s, wall = _range_share(torch, fn, EDGE_TABLES_RANGE)
            line += (f"  edge tables {g_s * 1e6 / n:.1f} us/step of "
                     f"{wall * 1e6 / n:.1f} under the profiler "
                     f"({100 * g_s / wall:.0f}%)")
        if ref is None:
            say(line)
            continue
        d = max(_rel_l2(torch, out.u, ends[ref].u),
                _rel_l2(torch, out.u_prev, ends[ref].u_prev))
        ok = d <= 1e-5
        say(f"{line}  rel diff {d:.2e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"phase 18 {name}: differs from {ref}")
    del fs, lf, lf_f, ends


def phase_driven_1024(torch):
    import numpy as np
    from tpuwave_torch.models.fast import FastWaveSolver

    n, dt = 64, 2e-4
    say(f"phase 18 (f64): run_leapfrog_driven_multistep (B6, k = 8), 1024^2 "
        f"elements, f64, dt {dt}, sin(pi x) sin(pi y) and the strip drive, "
        f"{n} steps, on cuda, against tpuwave's run_leapfrog_driven (its "
        f"CPU run): ||u|| within rtol 1e-10")
    g_fn, _ = _strip_drive(torch)
    fs = FastWaveSolver((1024, 1024), UNIT_SQUARE, dt, beta=0.0,
                        dtype=torch.float64, device="cuda")
    st = fs.initial_leapfrog_state(_standing(torch), g_fn=g_fn)
    t0 = time.perf_counter()
    out = fs.run_leapfrog_driven_multistep(
        st, dt * (2.0 + np.arange(n)), g_fn, steps_per_call=8)
    norm = float(torch.linalg.vector_norm(out.u))
    wall = time.perf_counter() - t0
    rel = abs(norm - TPUWAVE_DRIVEN_1024) / TPUWAVE_DRIVEN_1024
    ok = rel <= 1e-10
    say(f"  {wall / n * 1e6:.1f} us/step (one run, host clock); ||u|| "
        f"{norm!r} (tpuwave {TPUWAVE_DRIVEN_1024!r}), rel diff {rel:.1e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase 18: the 1024^2 f64 run differs from "
                             "tpuwave's")


#: phase 19's wave speeds: tests/test_fast_engine.py:187's varying C and
#: tests/test_tdep_c.py's time-dependent MMS (c^2 = 1 + 0.5 sin 2t)
VARYING_C = {"C": {"Function expression": "1.0 + 0.5*x + 0.25*y*y",
                   "Variable names": "x, y, t"}}
TDEP_C = {"Time Dependent C": "true",
          "C": {"Function expression": "sqrt(1 + 0.5*sin(2*t))",
                "Variable names": "x, y, t"},
          "F": {"Function expression":
                "(2*pi^2*(1 + 0.5*sin(2*t)) - 1)*cos(t)*sin(pi*x)*sin(pi*y)",
                "Variable names": "x, y, t"},
          "Solution": {"Function expression": "cos(t)*sin(pi*x)*sin(pi*y)",
                       "Variable names": "x, y, t"}}


def phase_cli_varcoef(torch, kn, work: Path):
    say(f"phase 19: both CLIs with a varying and with a time-dependent C, "
        f"R = 1, standing mode, 160^2 elements, dt 4e-2, {FAMILY_STEPS} "
        f"steps, f64, Log Every 1: --device cuda against --device cpu (CSVs "
        f"within rtol 1e-9, per-step CG counts equal; the mg runs launch B4 "
        f"and B3)")
    for cname, cover in (("varying C", VARYING_C), ("time-dep. C", TDEP_C)):
        for family, over in (("newmark", {"Beta": "0.25"}),
                             ("theta", {"Theta": "0.5"})):
            for precond in ("jacobi", "mg"):
                case = _case(work, Nel="160", Dt="4e-2",
                             T=str(FAMILY_STEPS * 4e-2),
                             **{"Log Every": "1"}, **over, **cover)
                flags = ("--precond", precond)
                tag = f"{cname} {family} --precond {precond}"
                out = work / "varcoef" / tag.replace(" ", "_")
                before = dict(kn.LAUNCHES)
                w_cuda, _ = _cli(family, case, out / "cuda", "cuda",
                                 flags=flags)
                n = {k: kn.LAUNCHES[k] - before[k]
                     for k in ("cheby_block", "constrained_stencil_apply")}
                w_cpu, _ = _cli(family, case, out / "cpu", "cpu",
                                flags=flags)
                rows = _compare_csvs(out / "cuda" / "res",
                                     out / "cpu" / "res", its_tol=0)
                say(f"  {tag:<40} cuda {w_cuda:6.2f} s  cpu {w_cpu:6.2f} s"
                    f"  {rows} CSV rows agree  launches {n}")
                if precond == "mg" and min(n.values()) <= 0:
                    raise AssertionError(f"{tag}: the cuda run launched no "
                                         f"B4 or no B3")


# ---------------------------------------------------------------------------
# phases 20 and 21: path G, the R = 2 engines with a varying C
# ---------------------------------------------------------------------------
#: phase 20's runs: (C, family, flags, overrides of _p2_case); dt 4e-2 for
#: mg (q = 10, as phase 10), 2e-3 for Jacobi-CG
P2_VARCOEF_RUNS = tuple(
    (cname, family, ("--precond", precond),
     {**over, "Dt": "4e-2" if precond == "mg" else "2e-3"})
    for cname in ("varying C", "time-dep. C")
    for family, over in (("newmark", {"Beta": "0.25"}),
                         ("theta", {"Theta": "0.5"}))
    for precond in ("jacobi", "mg")) + (
    ("varying C", "newmark", ("--solver", "2term", "--precond", "mg"),
     {"Beta": "0.25", "Dt": "4e-2"}),)
P2_VARCOEF_C = {"varying C": VARYING_C, "time-dep. C": TDEP_C}


def phase_p2_cli_varcoef(torch, kn, work: Path):
    say(f"phase 20: both CLIs with a varying and with a time-dependent C, "
        f"R = 2, standing mode, 160^2 elements (103,041 DoF), "
        f"{FAMILY_STEPS} steps, f64, Log Every 1: --device cuda against "
        f"--device cpu (CSVs within rtol 1e-9, per-step CG counts equal; "
        f"every run launches B11, the mg runs B12, B13, B4 and B3 too)")
    for cname, family, flags, over in P2_VARCOEF_RUNS:
        case = _p2_case(work, over, **P2_VARCOEF_C[cname])
        tag = f"{cname} {family} {' '.join(flags)}"
        out = work / "p2var" / re.sub(r"[ .]+", "_", tag)
        before = dict(kn.LAUNCHES)
        w_cuda, _ = _cli(family, case, out / "cuda", "cuda", flags=flags)
        n = {k: kn.LAUNCHES[k] - before[k] for k in PATH_G}
        w_cpu, _ = _cli(family, case, out / "cpu", "cpu", flags=flags)
        rows = _compare_csvs(out / "cuda" / "res", out / "cpu" / "res",
                             its_tol=0)
        say(f"  {tag:<46} cuda {w_cuda:6.2f} s  cpu {w_cpu:6.2f} s  "
            f"{rows} CSV rows agree  launches {n}")
        need = PATH_G if "mg" in flags else ("p2_constrained_apply",)
        for k in need:
            if n[k] <= 0:
                raise AssertionError(f"{tag}: the cuda run launched no {k}")


#: phase 21's runs: (tag, family, flags, overrides of _case, C)
P2_VARCOEF_1024 = (
    ("a", "newmark", ("--solver", "2term", "--precond", "mg"),
     {"Beta": "0.25", "Gamma": "0.5"}, VARYING_C),
    ("b", "theta", ("--precond", "mg"), {"Theta": "0.5"}, TDEP_C),
)
P2_VARCOEF_1024_STEPS = 10
#: tpuwave's last CSV rows and per-step CG counts (iterations_1,
#: iterations_2) of phase 21's runs: standing-mode-wsol.json with R 2, Nel
#: 1024, Dt 4e-3, T 0.04, Log Every 1, Save Solution false and the C,
#: family and flags of P2_VARCOEF_1024 (the file _case writes); f64, on
#: the CPU with the JAX package (smoother lambda_max from tpuwave's own
#: power iteration; 168 s and 88 s of time loop):
#:   JAX_PLATFORMS=cpu python -m tpuwave.cli.newmark standing-mode-wsol.json
#:     --solver 2term --precond mg      (run a)
#:   JAX_PLATFORMS=cpu python -m tpuwave.cli.theta standing-mode-wsol.json
#:     --precond mg                     (run b)
TPUWAVE_P2_VARCOEF_1024 = {
    "a": {"energy.csv": "10,0.04,4.4516",
          "error.csv": "10,4.000000e-02,7.380140e-03,4.410102e-02,"
                       "1.499647e-02,1.967782e-02",
          "probe.csv": "10,4.0000000000e-02,9.7290139136e-01",
          "iterations": [(8, 0)] + [(7, 0)] * 9},
    "b": {"energy.csv": "10,0.04,2.46366",
          "error.csv": "10,4.000000e-02,1.097491e-09,2.132904e-06,"
                       "2.196739e-09,9.374599e-07",
          "probe.csv": "10,4.0000000000e-02,9.9920010830e-01",
          "iterations": [(2, 4)] * 2 + [(3, 4)] * 6 + [(3, 3)] * 2},
}


def _last_row_gate(name: str, head: list, got: list, want: list) -> list:
    """The columns of a CSV's last row that differ from tpuwave's by more
    than their limit plus one unit in the last printed digit: rtol 1e-8
    for energy, time and probe; 1e-11 of the exact solution's norm for an
    error norm (err / rel_err of the same row), and 1e-11 for a relative
    error. A difference of error norms is at most the norm of the state
    difference, so the error columns are held to that scale: the cuda run
    of (b) differs from tpuwave's by 2.6e-13 of the solution's norm
    (rel_L2_error 2.196484e-09 against 2.196739e-09, H100 80GB HBM3 at
    700 W), ~40 times below the limit; an f32 state or a wrong K is far
    above it."""
    bad = []
    vals = dict(zip(head, (float(v) for v in want)))
    for col, u, v in zip(head, got, want):
        fu, fv = float(u), float(v)
        lim = 1e-8 * max(abs(fu), abs(fv))
        if col in ("L2_error", "H1_error"):
            rel = vals["rel_" + col]
            lim = 1e-11 * (fv / rel if rel > 0.0 else max(abs(fu), abs(fv)))
        elif col.startswith("rel_"):
            lim = 1e-11
        if abs(fu - fv) > lim + max(_quantum(u), _quantum(v)):
            bad.append(f"{name} {col}: {u} vs tpuwave {v}")
    return bad


def phase_p2_varcoef_1024(torch, kn, work: Path):
    n_steps = P2_VARCOEF_1024_STEPS
    say(f"phase 21: R = 2 with a varying C, 1024^2 elements (4,198,401 "
        f"DoF), dt 4e-3, {n_steps} steps, f64, Log Every 1, on cuda: (a) "
        f"newmark beta 1/4 --solver 2term --precond mg, varying C; (b) "
        f"theta 1/2 --precond mg, time-dependent C. Gates: per-step CG "
        f"counts equal tpuwave's; the last CSV rows within rtol 1e-8 of "
        f"tpuwave's (error norms within 1e-11 of the solution's norm) plus "
        f"one unit in the last printed digit")
    dofs = 4198401
    failed = []
    for tag, family, flags, over, cover in P2_VARCOEF_1024:
        case = _case(work, Nel="1024", R="2", Dt="4e-3",
                     T=str(n_steps * 4e-3), **{"Log Every": "1"}, **over,
                     **cover)
        out = work / f"p2var_1024_{tag}"
        before = dict(kn.LAUNCHES)
        torch.cuda.reset_peak_memory_stats()
        wall, text = _cli(family, case, out, "cuda", quiet=False,
                          flags=flags)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        n = {k: kn.LAUNCHES[k] - before[k] for k in PATH_G}
        run = next((out / "res").glob(f"{family}-*/run-*"))
        conv = list(csv.DictReader(next(
            (out / "res").glob(f"{family}-*/convergence.csv")).open()))[-1]
        elapsed = float(conv["elapsed_time_s"])
        its = [(int(r["iterations_1"]), int(r["iterations_2"]))
               for r in csv.DictReader((run / "iterations.csv").open())]
        want = TPUWAVE_P2_VARCOEF_1024[tag]
        say(f"  ({tag}) {family} {' '.join(flags)}: CLI wall {wall:.2f} s, "
            f"time loop {elapsed:.3f} s = {elapsed / n_steps * 1e3:.1f} "
            f"ms/step ({dofs * n_steps / elapsed:.4e} DoF*steps/s, "
            f"diagnostics every step included); peak device memory "
            f"{peak:.2f} GiB")
        say(f"      CG iterations per step {its} (tpuwave "
            f"{want['iterations']})")
        say("      launches per step (initial state and diagnostics "
            "included): " + ", ".join(
                f"{k} {n[k] / n_steps:.1f}" for k in PATH_G))
        if its != want["iterations"]:
            failed.append(f"({tag}) per-step CG counts differ")
        for name in ("energy.csv", "error.csv", "probe.csv"):
            rows = list(csv.reader((run / name).open()))
            got, ref = rows[-1], want[name].split(",")
            say(f"      {name} last row {','.join(got)} (tpuwave "
                f"{want[name]})")
            failed += [f"({tag}) {b}" for b in
                       _last_row_gate(name, rows[0], got, ref)]
        for k in PATH_G:
            if n[k] <= 0:
                failed.append(f"({tag}) launched no {k}")
    say(f"  {'ok' if not failed else 'FAIL: ' + '; '.join(failed)}")
    if failed:
        raise AssertionError("phase 21: " + "; ".join(failed))


def phase_p2_varcoef_profile(torch, kn, work: Path):
    """Where a step of phase 21's run (b) goes: one theta step under
    torch.profiler after a warm one."""
    from torch.profiler import ProfilerActivity, profile
    from tpuwave_torch.models.fast_engine import make_fast_solver
    from tpuwave_torch.utils.params import load_params

    tag, family, flags, over, cover = P2_VARCOEF_1024[1]
    say(f"phase 21 (profile): one step of run ({tag}), theta 1/2 "
        f"--precond mg, time-dependent C, 1024^2, f64, under "
        f"torch.profiler")
    case = _case(work, Nel="1024", R="2", Dt="4e-3", T="0.04", **over,
                 **cover)
    solver = make_fast_solver(load_params(str(case)), family,
                              precond="mg", device="cuda")
    st, _ = solver.step(solver.initial_state(), 4e-3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st, info = solver.step(st, 8e-3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_t = _device_time(prof)
    if dev_t is None:
        say("  the profiler saw no device time (not measured)")
        return
    events = _device_events(prof)
    say(f"  step 2 (CG {info['iterations_1']} + {info['iterations_2']}): "
        f"wall {wall * 1e3:.1f} ms under the profiler, {dev_t[0]} device "
        f"events, device busy {dev_t[1]:.2f} ms = "
        f"{dev_t[1] / 1e3 / wall:.3f} of the wall")
    for what, part in (("varcoef slice-adds (addcmul, torch ops)",
                        "addcmul"),
                       ("B11 p2_constrained_apply", "p2_apply"),
                       ("B12 + B13 p2_presmooth / p2_postsmooth",
                        "p2_smooth")):
        hit = [e for e in events if part in e.key]
        us = sum(e.self_device_time_total for e in hit)
        say(f"    {what}: {us / 1e3:8.3f} ms in "
            f"{sum(e.count for e in hit)} launches = "
            f"{us / 1e3 / dev_t[1]:.3f} of device time")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        say(f"    {e.self_device_time_total / 1e3:8.3f} ms {e.count:6d}x "
            f"{e.key[:70]}")


# ---------------------------------------------------------------------------
# phases 22 and 23: path H, the parity (gather-path) engine
# ---------------------------------------------------------------------------
#: phase 22's runs: (tag, family, flags, preset, overrides); each at Nel
#: 24, FAMILY_STEPS steps, f64, Log Every 1, --engine parity
PARITY_RUNS = (
    ("theta 1/2 jacobi", "theta", (), "standing-mode-wsol",
     {"Theta": "0.5", "Dt": "1e-2"}),
    ("theta 1 mg", "theta", ("--precond", "mg"), "standing-mode-wsol",
     {"Theta": "1.0", "Dt": "4e-2"}),
    ("newmark 1/4 chebyshev", "newmark", ("--precond", "chebyshev"),
     "standing-mode-wsol", {"Beta": "0.25", "Dt": "1e-2"}),
    ("newmark 1/4 jacobi, time-dep. C", "newmark", (), "standing-mode-wsol",
     {"Beta": "0.25", "Dt": "1e-2", **TDEP_C}),
    ("theta 1/2 jacobi, forcing", "theta", (), "dumping-wave",
     {"Theta": "0.5", "Dt": "1e-2"}),
    ("R=2 theta 1/2 mg", "theta", ("--precond", "mg"), "standing-mode-wsol",
     {"R": "2", "Theta": "0.5", "Dt": "4e-2"}),
    ("R=2 newmark 1/4 chebyshev, varying C", "newmark",
     ("--precond", "chebyshev"), "standing-mode-wsol",
     {"R": "2", "Beta": "0.25", "Dt": "1e-2", **VARYING_C}),
)
#: tpuwave's total CG iterations of phase 6's run (TPUWAVE_REL_L2's
#: comment); phase 23 (a) is held to phase 6's own total, and to this one
#: when phase 6 did not run (--only)
TPUWAVE_CG_640 = 3546
#: phase 23 (b) and (c): (tag, family, overrides of _case, keyword
#: arguments of the fast engine), each run with --precond mg on the
#: parity engine (the CLI) and on the fast engine (make_fast_solver and
#: run_solver, the CLI's pipeline), dt 1e-2, PARITY_640_STEPS steps,
#: Log Every 1. The parity engine's flat (p+h) cycle smooths with
#: degree 2 (p2_gmg_for_system's default), the fast P2 engine's canvas
#: cycle with 4 (its mg_pre_degree, as tpuwave's): (c) sets it to 2, the
#: same polynomial, where the CLI's counts would differ by design
PARITY_640_RUNS = (
    ("b", "theta", {"Theta": "0.5"}, {}),
    ("c", "newmark", {"R": "2", "Nel": "320", "Beta": "0.25", "Gamma": "0.5"},
     {"mg_pre_degree": 2}),
)
PARITY_640_STEPS = 10


def _parity_bitwise(torch, case: Path, family: str, precond: str) -> bool:
    """Two cuda runs of ``case`` on fresh parity solvers (api.build_solver,
    run_steps over the run's time stamps): states, per-step CG counts and
    norms bitwise equal."""
    import numpy as np
    from tpuwave_torch import api
    from tpuwave_torch.models.runner import time_steps
    from tpuwave_torch.utils.params import load_params

    p = load_params(str(case))
    runs = []
    for _ in range(2):
        s = api.build_solver(p, family, engine="parity", device="cuda",
                             precond=precond)
        runs.append(s.run_steps(s.initial_state(),
                                time_steps(p.t_final, p.dt)))
    (a, ia), (b, ib) = runs
    return (torch.equal(a.u, b.u) and torch.equal(a.v, b.v)
            and all(np.array_equal(ia[k], ib[k]) for k in ia))


def phase_parity_cli(torch, kn, work: Path):
    say(f"phase 22: both CLIs on the parity engine (--engine parity), Nel "
        f"24, {FAMILY_STEPS} steps, f64, Log Every 1: --device cuda against "
        f"--device cpu (CSVs within rtol 1e-9, per-step CG counts equal; "
        f"the mg runs launch B4 and B3, and a second cuda run of each is "
        f"bitwise equal to the first)")
    for tag, family, flags, preset, over in PARITY_RUNS:
        case = _case(work, preset, Nel="24",
                     T=str(FAMILY_STEPS * float(over["Dt"])),
                     **{"Log Every": "1"}, **over)
        flags = ("--engine", "parity") + flags
        out = work / "parity" / re.sub(r"[ .,/=]+", "_", tag)
        before = dict(kn.LAUNCHES)
        w_cuda, _ = _cli(family, case, out / "cuda", "cuda", flags=flags)
        n = {k: kn.LAUNCHES[k] - before[k] for k in PATH_H}
        w_cpu, _ = _cli(family, case, out / "cpu", "cpu", flags=flags)
        rows = _compare_csvs(out / "cuda" / "res", out / "cpu" / "res",
                             its_tol=0)
        say(f"  {tag:<38} cuda {w_cuda:6.2f} s  cpu {w_cpu:6.2f} s  "
            f"{rows} CSV rows agree  launches {n}")
        if "mg" in flags:
            for k in PATH_H:
                if n[k] <= 0:
                    raise AssertionError(f"{tag}: the cuda run launched no "
                                         f"{k}")
            same = _parity_bitwise(torch, case, family, "mg")
            say(f"    a second cuda run: bitwise "
                f"{'equal' if same else 'DIFFERENT'}")
            if not same:
                raise AssertionError(f"{tag}: two cuda runs differ")


def _run_record(out: Path, family: str, text: str) -> dict:
    """A CLI run's folder, per-step CG counts, steps and time loop."""
    run = next((out / "res").glob(f"{family}-*/run-*"))
    conv = list(csv.DictReader(next(
        (out / "res").glob(f"{family}-*/convergence.csv")).open()))[-1]
    its = [(int(r["iterations_1"]), int(r["iterations_2"]))
           for r in csv.DictReader((run / "iterations.csv").open())]
    done = next(ln for ln in text.splitlines()
                if ln.startswith("Simulation completed"))
    return dict(run=run, its=its, steps=int(done.split(":")[1].split()[0]),
                elapsed=float(conv["elapsed_time_s"]),
                rel_l2=float(conv["rel_L2_error_final"]))


def _run_fast(case: Path, family: str, out: Path, **kw):
    """(wall s, console text) of the CLI's pipeline on the fast engine
    built with ``kw`` (make_fast_solver, then run_solver)."""
    from tpuwave_torch.models.fast_engine import make_fast_solver
    from tpuwave_torch.models.runner import RunConfig, run_solver
    from tpuwave_torch.utils.params import load_params
    buf = io.StringIO()
    t0 = time.perf_counter()
    solver = make_fast_solver(load_params(str(case)), family, device="cuda",
                              **kw)
    with contextlib.redirect_stdout(buf):
        run_solver(solver, f"{family}-{case.stem}",
                   RunConfig(results_root=str(out / "res"),
                             mesh_root=str(out / "mesh")))
    return time.perf_counter() - t0, buf.getvalue()


def _rows_gate(name: str, head: list, got: list, want: list,
               rtol: float) -> list:
    """The columns of two CSV rows that differ by more than rtol of the
    larger plus one unit in the last printed digit."""
    bad = []
    for col, u, v in zip(head, got, want):
        fu, fv = float(u), float(v)
        lim = rtol * max(abs(fu), abs(fv)) + max(_quantum(u), _quantum(v))
        if abs(fu - fv) > lim:
            bad.append(f"{name} {col}: {u} vs {v}")
    return bad


def phase_parity_640(torch, kn, work: Path, phase6_its=None):
    dofs = 641 * 641
    say("phase 23: the parity engine at BASELINE.md's 640^2 elements "
        "(410,881 DoF), f64, on cuda")
    failed = []
    # (a) phase 6's file on the parity engine
    case = _case(work, T="0.05", Beta="0.25", Gamma="0.5",
                 **{"Enable Logging": "false"})
    out = work / "parity640a"
    before = dict(kn.LAUNCHES)
    torch.cuda.reset_peak_memory_stats()
    wall, text = _cli("newmark", case, out, "cuda", quiet=False,
                      flags=("--engine", "parity"))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n = {k: kn.LAUNCHES[k] - before[k] for k in PATH_H}
    rel_l2, elapsed, n_steps, its = _cli_summary(out, text)
    want_its = TPUWAVE_CG_640 if phase6_its is None else phase6_its
    rel = abs(rel_l2 - TPUWAVE_REL_L2) / TPUWAVE_REL_L2
    say(f"  (a) newmark beta 1/4 jacobi, dt 8e-5, T 0.05, logging off: CLI "
        f"wall {wall:.2f} s, time loop {elapsed:.3f} s = "
        f"{elapsed / n_steps * 1e3:.3f} ms/step ({dofs * n_steps / elapsed:.4e}"
        f" DoF*steps/s); peak device memory {peak:.3f} GiB; launches per "
        f"step {', '.join(f'{k} {n[k] / n_steps:.1f}' for k in PATH_H)}")
    say(f"      final rel L2 {rel_l2:.10e}, tpuwave {TPUWAVE_REL_L2:.10e}, "
        f"rel diff {rel:.2e} (bound 1e-6); CG iterations {its}, phase 6's "
        f"{want_its}{' (tpuwave, phase 6 not run)' if phase6_its is None else ''}")
    if rel > 1e-6:
        failed.append("(a) final rel L2 differs from tpuwave's")
    if its != want_its:
        failed.append(f"(a) CG iterations {its} != {want_its}")

    # (b), (c): the parity engine against the fast engine, same file
    for tag, family, over, fast_kw in PARITY_640_RUNS:
        case = _case(work, Dt="1e-2", T=str(PARITY_640_STEPS * 1e-2),
                     **{"Log Every": "1"}, **over)
        rec = {}
        for engine in ("parity", "fast"):
            out = work / f"parity640{tag}_{engine}"
            before = dict(kn.LAUNCHES)
            torch.cuda.reset_peak_memory_stats()
            if engine == "parity":
                wall, text = _cli(family, case, out, "cuda", quiet=False,
                                  flags=("--engine", "parity", "--precond",
                                         "mg"))
            else:
                wall, text = _run_fast(case, family, out, precond="mg",
                                       **fast_kw)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            n = {k: kn.LAUNCHES[k] - before[k] for k in PATH_H}
            r = rec[engine] = _run_record(out, family, text)
            say(f"  ({tag}) {family} R {over.get('R', '1')} --precond mg "
                f"{engine:<6}{fast_kw if engine == 'fast' else ''}: wall "
                f"{wall:.2f} s, time loop {r['elapsed']:.3f} s = "
                f"{r['elapsed'] / r['steps'] * 1e3:.2f} ms/step "
                f"(diagnostics every step included); peak device memory "
                f"{peak:.3f} GiB; launches per step "
                + ", ".join(f"{k} {n[k] / r['steps']:.1f}" for k in PATH_H))
            say(f"      CG iterations per step {r['its']}")
            if engine == "parity":
                failed += [f"({tag}) the parity run launched no {k}"
                           for k in PATH_H if n[k] <= 0]
        par, fast = rec["parity"], rec["fast"]
        if par["its"] != fast["its"]:
            failed.append(f"({tag}) per-step CG counts differ")
        for name in ("energy.csv", "error.csv", "probe.csv"):
            ra = list(csv.reader((par["run"] / name).open()))
            rb = list(csv.reader((fast["run"] / name).open()))
            say(f"      {name} last row parity {','.join(ra[-1])}, fast "
                f"{','.join(rb[-1])}")
            failed += [f"({tag}) {b}" for b in
                       _rows_gate(name, ra[0], ra[-1], rb[-1], 1e-10)]
    say(f"  {'ok' if not failed else 'FAIL: ' + '; '.join(failed)}")
    if failed:
        raise AssertionError("phase 23: " + "; ".join(failed))


#: the profiler range of each CellConnectivity method phase 23's profile
#: reads
GATHER_RANGES = {"gather": "parity gather", "assemble": "parity gather-sum"}


@contextlib.contextmanager
def _gather_ranges(torch):
    """CellConnectivity.gather and .assemble (the matvec's gather and the
    gather-sum) inside torch.profiler ranges of their names, for the
    duration of the block (a range costs ~15 us of host time, so the busy
    share is read in a window without them)."""
    from tpuwave_torch.ops.operators import CellConnectivity as conn
    orig = {name: getattr(conn, name) for name in GATHER_RANGES}

    def ranged(label, fn):
        def call(self, *args):
            with torch.profiler.record_function(label):
                return fn(self, *args)
        return call
    try:
        for name, fn in orig.items():
            setattr(conn, name, ranged(GATHER_RANGES[name], fn))
        yield
    finally:
        for name, fn in orig.items():
            setattr(conn, name, fn)


def phase_parity_profile(torch, kn, work: Path):
    """Where a step of phase 23's (a) and (b) goes: one step under
    torch.profiler after a warm one (device-busy share, top device ops),
    then one more with the gather and the gather-sum in profiler ranges
    (their shares of device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from tpuwave_torch import api
    from tpuwave_torch.utils.params import load_params

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for tag, family, precond, dt, over in (
            ("a", "newmark", "jacobi", 8e-5, {"Beta": "0.25"}),
            ("b", "theta", "mg", 1e-2, {"Theta": "0.5"})):
        say(f"phase 23 (profile): one step of run ({tag}), {family} "
            f"--precond {precond}, 640^2, f64, dt {dt}, under torch.profiler")
        case = _case(work, Dt=str(dt), T=str(10 * dt), **over)
        s = api.build_solver(load_params(str(case)), family, engine="parity",
                             device="cuda", precond=precond)
        st, _ = s.step(s.initial_state(), dt)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            st, info = s.step(st, 2 * dt)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dev_t = _device_time(prof)
        if dev_t is None:
            say("  the profiler saw no device time (not measured)")
            continue
        say(f"  step 2 (CG {info['iterations_1']} + {info['iterations_2']}):"
            f" wall {wall * 1e3:.2f} ms under the profiler, {dev_t[0]} device"
            f" events, device busy {dev_t[1]:.3f} ms = "
            f"{dev_t[1] / 1e3 / wall:.3f} of the wall")
        events = _device_events(prof)
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
            say(f"    {e.self_device_time_total / 1e3:8.3f} ms {e.count:6d}x "
                f"{e.key[:70]}")
        with _gather_ranges(torch), profile(activities=acts) as prof:
            st, info = s.step(st, 3 * dt)
            torch.cuda.synchronize()
        # the ranges' own device-side annotations are not device work
        dev_ms = sum(e.self_device_time_total for e in _device_events(prof)
                     if e.key not in GATHER_RANGES.values()) / 1e3
        for label in GATHER_RANGES.values():
            # the kernels of the ops inside the range (the range's own
            # device-side annotation spans the gaps between them too)
            calls = [e for e in prof.events() if e.name == label
                     and e.device_type == DeviceType.CPU]
            us = sum(c.device_time_total for e in calls
                     for c in e.cpu_children)
            if not us:
                say(f"    {label}: no device time under its range (not "
                    f"measured)")
                continue
            say(f"    {label} ({len(calls)} calls in step 3, CG "
                f"{info['iterations_1']} + {info['iterations_2']}): "
                f"{us / 1e3:.3f} ms = {us / 1e3 / dev_ms:.3f} of the "
                f"step's {dev_ms:.3f} ms of device time, "
                f"{us / len(calls):.1f} us a call")


# ---------------------------------------------------------------------------
# phases 24 and 25: path I, imported meshes (Mesh File Name)
# ---------------------------------------------------------------------------
#: the reference's default mesh (tpuwave/utils/params.py:103-108): the
#: 40 x 40 unit square, Gmsh 2.2
DEFAULT_MESH = ROOT / "mesh" / "mesh-square-40.msh"
#: phase 24's runs on a perturbed Nel 24 mesh: (tag, family, flags,
#: overrides); FAMILY_STEPS steps, f64, Log Every 1, --engine auto (which
#: routes an imported mesh to the parity engine)
UNSTRUCTURED_RUNS = (
    ("R=1 theta 1/2 chebyshev", "theta", ("--precond", "chebyshev"),
     {"R": "1", "Theta": "0.5"}),
    ("R=1 newmark 1/4 jacobi, time-dep. C", "newmark", (),
     {"R": "1", "Beta": "0.25", **TDEP_C}),
    ("R=2 theta 1/2 chebyshev", "theta", ("--precond", "chebyshev"),
     {"R": "2", "Theta": "0.5"}),
    ("R=2 newmark 1/4 jacobi", "newmark", (), {"R": "2", "Beta": "0.25"}),
)
#: tpuwave's results on perturbed meshes (phase 24 (c)): (family, Nel,
#: overrides of standing-mode-wsol.json, solver keywords, final relative
#: L2 error, total CG iterations of the first and second solves). Each
#: mesh is perturbed_mesh_file(path, Nel) (seed 0, amp 0.25), written by
#: the port's write_msh (tpuwave's write_msh writes the same bytes);
#: Save Solution and Enable Logging false; f64; computed on the CPU with
#: the JAX package:
#:   JAX_PLATFORMS=cpu python -c "import json; from tpuwave import config;
#:     config.use_x64(); from tpuwave import api;
#:     from tpuwave.models.runner import RunConfig;
#:     case = json.load(open('parameters/standing-mode-wsol.json'));
#:     case.update(OVERRIDES, **{'Save Solution': 'false',
#:       'Enable Logging': 'false', 'Mesh File Name': 'perturbed-NEL.msh'});
#:     r = api.solve(case, FAMILY, config=RunConfig(quiet=True,
#:       write_mesh=False), **KEYWORDS);
#:     print(repr(r.rel_l2), r.total_iterations_1, r.total_iterations_2)"
TPUWAVE_UNSTRUCTURED = (
    ("newmark", 64, {"R": "1", "Dt": "1e-3", "T": "0.05", "Beta": "0.25",
                     "Gamma": "0.5"}, {}, 0.0005970855377285055, 650, 0),
    ("theta", 32, {"R": "2", "Dt": "1e-2", "T": "0.05", "Theta": "0.5"},
     {"precond": "chebyshev"}, 2.4786332250439278e-05, 90, 55),
)
#: tpuwave's results on phase 25's perturbed meshes (perturbed_mesh_file,
#: seed 0, amp 0.25, written by the port's write_msh), computed on the CPU
#: with the JAX package, f64. (a): final relative L2 error and total CG
#: iterations of phase 6's file (standing-mode-wsol.json with Nel 640, Dt
#: 8e-5, T 0.05, Beta 0.25, Gamma 0.5, Save Solution and Enable Logging
#: false; 626 steps; Newmark 1/4 jacobi on the parity engine) with Mesh
#: File Name perturbed-640.msh, by the command of TPUWAVE_UNSTRUCTURED with
#: those overrides. (b): per-step CG iterations (first, second solve) and
#: the final relative L2 error of theta 1/2 chebyshev at R 2 on
#: perturbed-320.msh (that file with R 2, Nel 320, Dt 1e-2, T 0.03, Theta
#: 0.5, written to case.json):
#:   JAX_PLATFORMS=cpu python -c "import numpy as np; from tpuwave import
#:     config; config.use_x64();
#:     from tpuwave.models.general import make_discretization;
#:     from tpuwave.models.runner import time_steps;
#:     from tpuwave.models.theta import ThetaSolver;
#:     from tpuwave.utils.params import load_params;
#:     p = load_params('case.json');
#:     s = ThetaSolver(make_discretization(p), precond='chebyshev');
#:     ts = time_steps(p.t_final, p.dt);
#:     st, info = s.run_steps(s.initial_state(), ts);
#:     print(list(zip(np.asarray(info['iterations_1']).tolist(),
#:       np.asarray(info['iterations_2']).tolist())),
#:       repr(float(s.disc.errors(st.u, ts[-1])[2])))"
TPUWAVE_UNSTRUCTURED_640 = (5.991096338054994e-06, 8138)
TPUWAVE_UNSTRUCTURED_320 = ([(44, 8)] * 3, 2.9386293448544515e-06)
#: phase 25's steps held cuda against cpu at full width, and the bound on
#: their states' difference (relative to the cpu state's largest entry):
#: phase 13's for u at 640^2 (the two devices' roundoff, carried through
#: 13-52 CG iterations a step at 410,881 DoF, reaches ~1e-10 here; at
#: Nel 24, phase 24 holds 1e-12)
UNSTRUCTURED_640_STEPS = 2
UNSTRUCTURED_640_RTOL = 1e-9


def perturbed_mesh_file(path: Path, nel: int, seed: int = 0,
                        amp: float = 0.25):
    """The structured nel x nel unit square with its interior vertices
    moved by up to ``amp`` of a cell (uniform, seeded; the perturbed_mesh
    of tests/test_unstructured.py), written as Gmsh 2.2 by the port's
    write_msh: (path, seconds to write)."""
    import numpy as np
    from tpuwave_torch.core.mesh import StructuredTriMesh
    from tpuwave_torch.core.unstructured import write_msh
    m = StructuredTriMesh((nel, nel), UNIT_SQUARE)
    pts = m.vertex_coords.copy()
    rng = np.random.default_rng(seed)
    interior = ~m.boundary_vertex_mask
    pts[interior] += (rng.uniform(-amp, amp, (interior.sum(), 2))
                      * np.array([m.hx, m.hy]))
    t0 = time.perf_counter()
    write_msh(path, pts, m.cells)
    return path, time.perf_counter() - t0


def _parity_solver(case: Path, family: str, precond: str, device: str,
                   mesh=None):
    """The parity solver of ``case`` on ``device`` (make_discretization
    with an already-read ``mesh``, as the CLI builds it)."""
    from tpuwave_torch.models.general import make_discretization
    from tpuwave_torch.models.newmark import NewmarkSolver
    from tpuwave_torch.models.theta import ThetaSolver
    from tpuwave_torch.utils.params import load_params
    disc = make_discretization(load_params(str(case)), device=device,
                               mesh=mesh)
    cls = ThetaSolver if family == "theta" else NewmarkSolver
    return cls(disc, precond=precond)


def _cuda_cpu_states(torch, case: Path, family: str, precond: str,
                     n_steps=None, mesh=None, rerun: bool = True) -> dict:
    """``case`` on the parity engine through run_steps, on cuda (twice
    with ``rerun``) and on the cpu: the cuda run's wall, per-step CG
    counts, whether they equal the cpu run's, the largest difference of
    u and v against the cpu run (relative to the cpu state's largest
    entry), the cuda run's final relative L2 error and whether the cuda
    rerun is bitwise equal."""
    import numpy as np
    from tpuwave_torch.models.runner import time_steps
    from tpuwave_torch.utils.params import load_params
    p = load_params(str(case))
    times = time_steps(p.t_final, p.dt)[:n_steps]
    runs, wall = [], None
    for dev in ("cuda", "cuda", "cpu") if rerun else ("cuda", "cpu"):
        s = _parity_solver(case, family, precond, dev, mesh)
        st = s.initial_state()
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs.append(s.run_steps(st, times))
        if wall is None:
            wall = time.perf_counter() - t0
            rel_l2 = float(s.disc.errors(runs[0][0].u, times[-1])[2])
        del s
    (a, ia), (c, ic) = runs[0], runs[-1]
    its = ("iterations_1", "iterations_2")
    rec = dict(wall=wall, steps=len(times), rel_l2=rel_l2,
               its=[(int(x), int(y)) for x, y in zip(ia[its[0]], ia[its[1]])],
               its_equal=all(np.array_equal(ia[k], ic[k]) for k in its),
               diff=max(float((getattr(a, k).cpu() - getattr(c, k)).abs().max()
                              / getattr(c, k).abs().max()) for k in "uv"))
    if rerun:
        b, ib = runs[1]
        rec["bitwise"] = (torch.equal(a.u, b.u) and torch.equal(a.v, b.v)
                          and all(np.array_equal(ia[k], ib[k]) for k in ia))
    return rec


def phase_unstructured_cli(torch, kn, work: Path):
    say("phase 24: imported meshes (Mesh File Name), f64, Log Every 1: (a) "
        "the reference's default mesh/mesh-square-40.msh through newmark "
        "--precond mg on cuda against the Nel 40 rectangle's run; (b) a "
        f"perturbed Nel 24 mesh at R = 1 and 2, {FAMILY_STEPS} steps, "
        "--device cuda against --device cpu (CSVs within rtol 1e-9, "
        "per-step CG counts equal, run_steps states within 1e-12, a second "
        "cuda run bitwise equal); (c) perturbed meshes through api.solve "
        "against tpuwave's final error and CG totals")
    failed = []
    # (a) recognised as the structured 40 x 40 rectangle
    dt = 1e-2
    texts, outs = {}, {}
    for tag, over in (("nel 40", {}),
                      ("mesh file", {"Mesh File Name": str(DEFAULT_MESH),
                                     "Nel": "7"})):
        out = work / "default_mesh" / tag.replace(" ", "_")
        out.mkdir(parents=True)
        case = _case(out, **{"Nel": "40", "Dt": str(dt),
                             "T": str(FAMILY_STEPS * dt), "Beta": "0.25",
                             "Gamma": "0.5", "Log Every": "1", **over})
        before = dict(kn.LAUNCHES)
        wall, texts[tag] = _cli("newmark", case, out, "cuda", quiet=False,
                                flags=("--precond", "mg"))
        n = {k: kn.LAUNCHES[k] - before[k] for k in PATH_I}
        outs[tag] = out
        say(f"  (a) {tag:<9} newmark 1/4 --precond mg: wall {wall:.2f} s, "
            f"launches {n}")
        failed += [f"(a) {tag}: no {k} launched" for k in PATH_I
                   if n[k] <= 0]
    lines = texts["mesh file"].splitlines()
    for want in ("  Recognised as a structured 40x40 rectangle -> "
                 "structured engines", "  Engine: fast (grid-stencil)"):
        say(f"      {'printed' if want in lines else 'MISSING'}: "
            f"{want.strip()}")
        if want not in lines:
            failed.append(f"(a) the mesh file's run did not print {want!r}")
    a, b = outs["nel 40"] / "res", outs["mesh file"] / "res"
    same = [f.name for f in sorted(a.rglob("*.csv"))
            if f.name != "convergence.csv"
            and f.read_bytes() == (b / f.relative_to(a)).read_bytes()]
    say(f"      byte-equal CSVs of the two runs: {same}")
    if len(same) != 4:
        failed.append("(a) the mesh file's CSVs differ from the Nel 40 run's")
    if (outs["mesh file"] / "mesh").exists():
        failed.append("(a) a mesh VTK snapshot was written for an import")

    # (b) a perturbed mesh on the parity engine
    msh, _ = perturbed_mesh_file(work / "perturbed-24.msh", 24, seed=0)
    for tag, family, flags, over in UNSTRUCTURED_RUNS:
        out = work / "unstructured" / re.sub(r"[ .,/=]+", "_", tag)
        out.mkdir(parents=True)
        case = _case(out, Nel="24", Dt=str(dt), T=str(FAMILY_STEPS * dt),
                     **{"Log Every": "1", "Mesh File Name": str(msh)},
                     **over)
        w_cuda, text = _cli(family, case, out / "cuda", "cuda", quiet=False,
                            flags=flags)
        w_cpu, _ = _cli(family, case, out / "cpu", "cpu", flags=flags)
        banner = ("  Engine: parity (fast engine ineligible: mesh is not a "
                  "generated structured rectangle)")
        if banner not in text.splitlines():
            failed.append(f"(b) {tag}: no parity banner")
        rows = _compare_csvs(out / "cuda" / "res", out / "cpu" / "res",
                             its_tol=0)
        precond = flags[1] if flags else "jacobi"
        rec = _cuda_cpu_states(torch, case, family, precond)
        say(f"  (b) {tag:<37} cuda {w_cuda:5.2f} s cpu {w_cpu:5.2f} s, "
            f"{rows} CSV rows agree; run_steps: CG counts "
            f"{'equal' if rec['its_equal'] else 'DIFFER'}, u / v within "
            f"{rec['diff']:.2e} of cpu, rerun bitwise "
            f"{'equal' if rec['bitwise'] else 'DIFFERENT'}")
        if not (rec["its_equal"] and rec["bitwise"]) or rec["diff"] > 1e-12:
            failed.append(f"(b) {tag}: {rec}")

    # (c) against tpuwave's results on perturbed meshes (api.solve)
    from tpuwave_torch import api
    from tpuwave_torch.models.runner import RunConfig
    for family, nel, over, kw, rel_l2, its1, its2 in TPUWAVE_UNSTRUCTURED:
        msh, _ = perturbed_mesh_file(work / f"perturbed-{nel}.msh", nel)
        case = json.loads((ROOT / "parameters"
                           / "standing-mode-wsol.json").read_text())
        case.update(over, **{"Save Solution": "false",
                             "Enable Logging": "false",
                             "Mesh File Name": str(msh)})
        t0 = time.perf_counter()
        r = api.solve(case, family, device="cuda",
                      config=RunConfig(quiet=True, write_mesh=False,
                                       results_root=str(work / "tpw")),
                      **kw)
        wall = time.perf_counter() - t0
        rel = abs(r.rel_l2 - rel_l2) / rel_l2
        its = (r.total_iterations_1, r.total_iterations_2)
        say(f"  (c) {family} R {over['R']} Nel {nel} perturbed "
            f"{kw or ''}: api.solve {wall:.2f} s, final rel L2 "
            f"{r.rel_l2:.12e} (tpuwave {rel_l2:.12e}, rel diff {rel:.2e}, "
            f"bound 1e-6), CG {its} (tpuwave {(its1, its2)})")
        if rel > 1e-6 or its != (its1, its2):
            failed.append(f"(c) {family} Nel {nel}: rel L2 or CG totals "
                          "differ from tpuwave's")
    say(f"  {'ok' if not failed else 'FAIL: ' + '; '.join(failed)}")
    if failed:
        raise AssertionError("phase 24: " + "; ".join(failed))


def phase_unstructured_640(torch, kn, work: Path):
    say("phase 25: a perturbed 640^2 mesh (seed 0, interior vertices moved "
        "by up to a quarter cell; 410,881 vertices, 819,200 triangles), "
        "written by write_msh, f64, --engine parity, on cuda")
    import math
    from tpuwave_torch.core.unstructured import read_mesh_file
    from tpuwave_torch.models.general import make_discretization
    from tpuwave_torch.utils.params import load_params
    failed = []
    msh, w_s = perturbed_mesh_file(work / "perturbed-640.msh", 640, seed=0)
    t0 = time.perf_counter()
    mesh = read_mesh_file(msh)
    parse_s = time.perf_counter() - t0
    say(f"  mesh file {msh.stat().st_size / 2 ** 20:.1f} MiB: write "
        f"{w_s:.2f} s, parse (read_mesh_file) {parse_s:.2f} s, "
        f"{mesh.n_vertices} vertices, {mesh.n_cells} triangles")
    if (mesh.n_vertices, mesh.n_cells) != (641 * 641, 2 * 640 * 640):
        failed.append("(a) the mesh has the wrong size")

    # (a) phase 6's file on the imported mesh
    out = work / "unstructured640a"
    out.mkdir()
    case = _case(out, T="0.05", Beta="0.25", Gamma="0.5",
                 **{"Enable Logging": "false", "Mesh File Name": str(msh)})
    p = load_params(str(case))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    disc = make_discretization(p, device="cuda", mesh=mesh)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    say(f"  setup (make_discretization on cuda, the mesh read): "
        f"{setup_s:.2f} s; the slot table pads to {disc.conn.slots.shape[1]}"
        f" cells a vertex")
    del disc
    torch.cuda.reset_peak_memory_stats()
    wall, text = _cli("newmark", case, out, "cuda", quiet=False,
                      flags=("--engine", "parity"))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rel_l2, elapsed, n_steps, its = _cli_summary(out, text)
    say(f"  (a) newmark beta 1/4 jacobi, dt 8e-5, T 0.05, logging off: CLI "
        f"wall {wall:.2f} s (the file read included), time loop "
        f"{elapsed:.3f} s = {elapsed / n_steps * 1e3:.3f} ms/step; peak "
        f"device memory {peak:.3f} GiB")
    want_l2, want_its = TPUWAVE_UNSTRUCTURED_640
    rel = abs(rel_l2 - want_l2) / want_l2
    say(f"      final rel L2 {rel_l2:.10e}, tpuwave {want_l2:.10e} (rel "
        f"diff {rel:.2e}, bound 1e-6; the structured mesh's: "
        f"{TPUWAVE_REL_L2:.10e}); CG iterations {its}, tpuwave {want_its}")
    if not (math.isfinite(rel_l2) and rel <= 1e-6 and its == want_its):
        failed.append(f"(a) rel L2 {rel_l2!r} / CG {its} against tpuwave's "
                      f"{want_l2!r} / {want_its}")
    rec = _cuda_cpu_states(torch, case, "newmark", "jacobi",
                           n_steps=UNSTRUCTURED_640_STEPS, mesh=mesh,
                           rerun=False)
    say(f"      the first {rec['steps']} steps through run_steps, cuda "
        f"against cpu: CG counts {rec['its']} "
        f"{'equal' if rec['its_equal'] else 'DIFFER'}, u / v within "
        f"{rec['diff']:.2e}")
    if not rec["its_equal"] or rec["diff"] > UNSTRUCTURED_640_RTOL:
        failed.append(f"(a) cuda against cpu: {rec}")
    # (a') a time-dependent C rebuilds the per-cell K(t) every step
    case_t = _case(out, Dt="8e-5", T=str(10 * 8e-5), Beta="0.25",
                   Gamma="0.5", **{"Mesh File Name": str(msh)}, **TDEP_C)
    s = _parity_solver(case_t, "newmark", "jacobi", "cuda", mesh)
    st, _ = s.step(s.initial_state(), 8e-5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    from tpuwave_torch.models.runner import time_steps
    st, info = s.run_steps(st, time_steps(10 * 8e-5, 8e-5)[1:])
    torch.cuda.synchronize()
    tdep_ms = (time.perf_counter() - t0) / 9 * 1e3
    say(f"  (a') the same with a time-dependent C (K(t) rebuilt per step): "
        f"{tdep_ms:.3f} ms/step over 9 steps, CG "
        f"{info['iterations_1'].tolist()}")
    del s, st

    # (b) R = 2 at Nel 320 (the same DoF count), theta 1/2 chebyshev
    msh2, _ = perturbed_mesh_file(work / "perturbed-320.msh", 320, seed=0)
    case2 = _case(out, R="2", Nel="320", Dt="1e-2", T="0.03", Theta="0.5",
                  **{"Mesh File Name": str(msh2)})
    rec = _cuda_cpu_states(torch, case2, "theta", "chebyshev",
                           mesh=read_mesh_file(msh2), rerun=False)
    want_its, want_l2 = TPUWAVE_UNSTRUCTURED_320
    rel = abs(rec["rel_l2"] - want_l2) / want_l2
    say(f"  (b) R = 2 Nel 320 (410,881 DoF) theta 1/2 --precond chebyshev, "
        f"dt 1e-2, {rec['steps']} steps: cuda {rec['wall'] / rec['steps'] * 1e3:.2f}"
        f" ms/step, CG {rec['its']} (tpuwave {want_its}), final rel L2 "
        f"{rec['rel_l2']:.10e} (tpuwave {want_l2:.10e}, rel diff "
        f"{rel:.2e}, bound 1e-6); cuda against cpu: CG counts "
        f"{'equal' if rec['its_equal'] else 'DIFFER'}, u / v within "
        f"{rec['diff']:.2e}")
    if rec["its"] != want_its or rel > 1e-6:
        failed.append(f"(b) CG {rec['its']} / rel L2 {rec['rel_l2']!r} "
                      f"against tpuwave's {want_its} / {want_l2!r}")
    if not rec["its_equal"] or rec["diff"] > UNSTRUCTURED_640_RTOL:
        failed.append(f"(b) cuda against cpu: {rec}")
    say(f"  {'ok' if not failed else 'FAIL: ' + '; '.join(failed)}")
    if failed:
        raise AssertionError("phase 25: " + "; ".join(failed))


def phase_unstructured_profile(torch, kn, work: Path):
    """Where a step of phase 25 (a) goes: one step on the perturbed 640^2
    mesh under torch.profiler after a warm one."""
    from torch.profiler import ProfilerActivity, profile
    say("phase 25 (profile): one step of run (a), newmark jacobi, the "
        "perturbed 640^2 mesh, f64, dt 8e-5, under torch.profiler")
    msh = work / "perturbed-640.msh"      # phase 25's, unless run alone
    if not msh.exists():
        perturbed_mesh_file(msh, 640, seed=0)
    case = _case(work, T="0.05", Beta="0.25", Gamma="0.5",
                 **{"Mesh File Name": str(msh)})
    s = _parity_solver(case, "newmark", "jacobi", "cuda")
    dt = 8e-5
    st, _ = s.step(s.initial_state(), dt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st, info = s.step(st, 2 * dt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_t = _device_time(prof)
    if dev_t is None:
        say("  the profiler saw no device time (not measured)")
        return
    say(f"  step 2 (CG {info['iterations_1']}): wall {wall * 1e3:.2f} ms "
        f"under the profiler, {dev_t[0]} device events, device busy "
        f"{dev_t[1]:.3f} ms = {dev_t[1] / 1e3 / wall:.3f} of the wall")
    for e in sorted(_device_events(prof),
                    key=lambda e: -e.self_device_time_total)[:8]:
        say(f"    {e.self_device_time_total / 1e3:8.3f} ms {e.count:6d}x "
            f"{e.key[:70]}")


# ---------------------------------------------------------------------------
# phases 26 and 27: path J, the run surface and the sweeps
# ---------------------------------------------------------------------------
#: phase 26 (a): (tag, family, flags, overrides of _case), each at 640^2,
#: f64, dt 8e-5, RUN_SURFACE_STEPS steps, Log Every 5, checkpoints every
#: CHECKPOINT_EVERY steps
RUN_SURFACE_RUNS = (
    ("auto newmark 1/4", "newmark", (), {"Beta": "0.25", "Gamma": "0.5"}),
    ("newmark 1/4 2term mg", "newmark", ("--solver", "2term", "--precond",
                                         "mg"),
     {"Beta": "0.25", "Gamma": "0.5"}),
    ("parity theta 1/2 time-dep. C", "theta", ("--engine", "parity"),
     {"Theta": "0.5", **TDEP_C}),
)
RUN_SURFACE_STEPS = 50
#: phase 27 (c)'s --T: 250 steps of the sweep's dt 8e-5 (its default 0.05)
SCALABILITY_T = 0.02
CHECKPOINT_EVERY = 25
RUN_LOGS = ("energy.csv", "error.csv", "probe.csv", "iterations.csv")
#: the __global__ functions of tpuwave_torch/csrc/*.cu
_KERNEL_RE = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\("
                        r"(?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(")


def port_kernel_names() -> set:
    names = set()
    for src in sorted((ROOT / "tpuwave_torch" / "csrc").glob("*.cu")):
        names |= set(_KERNEL_RE.findall(src.read_text()))
    return names - {"noop_kernel"}


def _run_folder(out: Path) -> Path:
    return next((out / "res").glob("*/run-*"))


def _conv_head(out: Path) -> str:
    """A run's convergence row without its wall-clock column."""
    conv = next((out / "res").glob("*/convergence.csv"))
    return conv.read_text().splitlines()[-1].rsplit(",", 1)[0]


def _resume_copy(run: Path, ckpt: Path, out: Path) -> Path:
    """A fresh run folder under ``out`` that holds ``ckpt`` alone."""
    fresh = out / "res" / run.parent.name / run.name
    fresh.mkdir(parents=True)
    shutil.copy(ckpt, fresh)
    return fresh


def _rows_after(run: Path, name: str, step: int) -> list:
    rows = (run / name).read_text().splitlines()
    return [rows[0]] + [r for r in rows[1:] if int(r.split(",")[0]) > step]


def _same_checkpoints(a: Path, b: Path) -> bool:
    """Bitwise equal checkpoint files: every field, step and time."""
    import numpy as np
    with np.load(a) as x, np.load(b) as y:
        return (sorted(x.files) == sorted(y.files)
                and all(np.array_equal(x[k], y[k]) for k in x.files))


def _trace_kernels(path: Path) -> tuple:
    """(the CUDA kernel events of a Chrome trace, the port's kernels' events
    counted by kernel name)."""
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    ours = {}
    for name in port_kernel_names():
        n = sum(re.search(rf"\b{name}\b", e.get("name", "")) is not None
                for e in kernels)
        if n:
            ours[name] = n
    return kernels, ours


def phase_run_surface(torch, kn, work: Path):
    from tpuwave_torch import harness
    from tpuwave_torch.models.runner import time_steps

    n_steps = len(time_steps(RUN_SURFACE_STEPS * 8e-5, 8e-5))
    say(f"phase 26: the run surface at BASELINE.md's 640^2 elements, f64, "
        f"dt 8e-5, {n_steps} steps, Log Every 5, on cuda: (a) each run "
        f"with --checkpoint-every {CHECKPOINT_EVERY} (the first also "
        f"without), then resumed from a middle checkpoint in a fresh folder "
        f"(CSV rows "
        f"after it byte-equal, the convergence row but its wall time, the "
        f"last checkpoints bitwise equal); (b) the first resume again "
        f"with --profile-dir (a trace that names a port kernel); (c) "
        f"harness.run_case with a 1 s wall-clock limit")
    failed = []
    for i, (tag, family, flags, over) in enumerate(RUN_SURFACE_RUNS):
        case = _case(work, T=str(RUN_SURFACE_STEPS * 8e-5),
                     **{"Log Every": "5"}, **over)
        base = work / "surface" / re.sub(r"[ .,/=]+", "_", tag)
        ck = ("--checkpoint-every", str(CHECKPOINT_EVERY))
        # the first run also without checkpoints (the chunked branch): its
        # ms/step against the checkpointing run's, and its CSVs
        runs = ("plain", "full", "resumed") if i == 0 else ("full",
                                                           "resumed")
        before = dict(kn.LAUNCHES)
        walls = {}
        if i == 0:
            walls["plain"], _ = _cli(family, case, base / "plain", "cuda",
                                     flags=flags)
        walls["full"], _ = _cli(family, case, base / "full", "cuda",
                                flags=flags + ck)
        n = {k: kn.LAUNCHES[k] - before[k] for k in PATH_J}
        full = _run_folder(base / "full")
        ckpts = sorted(full.glob("checkpoint_*.npz"))
        mid = ckpts[-2]
        step = int(mid.name[len("checkpoint_"):-len(".npz")])
        fresh = _resume_copy(full, mid, base / "resumed")
        walls["resumed"], text = _cli(family, case, base / "resumed", "cuda",
                                      quiet=False,
                                      flags=flags + ck + ("--resume",))
        if f"Resuming from checkpoint at step {step}," not in text:
            failed.append(f"{tag}: no resume line for step {step}")
        rows = sum(len(_rows_after(full, name, step)) - 1
                   for name in RUN_LOGS)
        for name in RUN_LOGS:
            if (fresh / name).read_text().splitlines() != \
                    _rows_after(full, name, step):
                failed.append(f"{tag}: {name} after step {step} differs")
            if i == 0 and (full / name).read_bytes() != \
                    (_run_folder(base / "plain") / name).read_bytes():
                failed.append(f"{tag}: {name} differs from the run "
                              "without checkpoints")
        for d in runs:
            if _conv_head(base / "full") != _conv_head(base / d):
                failed.append(f"{tag}: convergence rows of full and {d} "
                              "differ")
        bitwise = _same_checkpoints(ckpts[-1], fresh / ckpts[-1].name)
        if not bitwise:
            failed.append(f"{tag}: {ckpts[-1].name} not bitwise equal")
        loop = {d: float((next((base / d / "res").glob("*/convergence.csv"))
                          .read_text().splitlines()[-1].rsplit(",", 1)[1]))
                for d in runs}
        plain = (f"without checkpoints {loop['plain'] / n_steps * 1e3:.3f} "
                 "ms/step, " if i == 0 else "")
        say(f"  {tag:<30} time loop: {plain}with checkpoints "
            f"{loop['full'] / n_steps * 1e3:.3f} ms/step, resumed from "
            f"step {step} {loop['resumed'] / (n_steps - step) * 1e3:.3f} "
            f"ms/step; CLI walls "
            f"{' / '.join(f'{walls[d]:.2f}' for d in runs)} s; {rows} rows "
            f"after step {step} byte-equal, {ckpts[-1].name} bitwise "
            f"{'equal' if bitwise else 'DIFFERENT'}; launches {n}")
        if i == 0:
            # (b) the same resume under --profile-dir
            tdir = base / "trace"
            prof = _resume_copy(full, mid, base / "profiled")
            w_prof, _ = _cli(family, case, base / "profiled", "cuda",
                             flags=flags + ck + ("--resume", "--profile-dir",
                                                 str(tdir)))
            path = tdir / "trace.json"
            kernels, ours = _trace_kernels(path)
            say(f"  (b) --profile-dir: {path.name} "
                f"{path.stat().st_size / 2 ** 20:.1f} MiB, "
                f"{len(kernels)} CUDA kernel events, the port's kernels "
                f"{ours}; CLI wall {w_prof:.2f} s")
            if not ours:
                failed.append("(b) the trace names none of the port's "
                              "kernels")
            for name in RUN_LOGS:
                if (prof / name).read_bytes() != (fresh / name).read_bytes():
                    failed.append(f"(b) {name} differs under the profiler")

    # (c) the sweeps' per-run timeout on a long case
    over = {"Nel": "640", "Dt": "8e-5", "T": "1.0", "Save Solution": False,
            "Log Every": 10}
    code, elapsed, res = harness.run_case(
        "newmark-0.25", ROOT / "parameters" / "standing-mode-wsol.json",
        over, results_root=str(work / "timeout" / "res"), timeout_s=1.0,
        device="cuda")
    run = _run_folder(work / "timeout")
    last = {name: int((run / name).read_text().splitlines()[-1]
                      .split(",")[0]) for name in RUN_LOGS}
    say(f"  (c) run_case newmark-0.25, 640^2, 12500 steps, timeout_s 1: "
        f"code {code}, timed_out {res.timed_out if res else None}, "
        f"stopped at step {res.timestep_number if res else None} after "
        f"{res.elapsed_s if res else 0:.3f} s of time loop "
        f"({elapsed:.2f} s in all); last CSV rows at steps {last}")
    if code != -1 or not res.timed_out or res.timestep_number <= 0 or \
            set(last.values()) != {res.timestep_number} or \
            list((work / "timeout").rglob("convergence.csv")):
        failed.append(f"(c) code {code}, last rows {last}")
    say(f"  {'ok' if not failed else 'FAIL: ' + '; '.join(failed)}")
    if failed:
        raise AssertionError("phase 26: " + "; ".join(failed))


#: phase 27 (a): the convergence sweep at Nel 320, R = 1 and 2, T 1, its
#: CFL filter on, as two plans (name, schemes, dt): the implicit schemes at
#: dt 0.02 and 0.01, the explicit ones at dt 0.001 (the filter keeps R = 1
#: only: R = 2's limit is 4.97e-4)
CONVERGENCE_PLANS = (
    ("implicit", ("theta-0.5", "theta-1.0", "newmark-0.25"), ("0.02", "0.01")),
    ("explicit", ("theta-0.0", "newmark-0.00"), ("0.001",)),
)
#: tpuwave's rows of those plans, (method, theta, beta, R, dt) ->
#: (rel_L2_error_final, rel_H1_error_final) as its merged CSV prints
#: them, from CPU runs of the JAX package's own sweep script (f64), one
#: per plan, each in an empty directory:
#:   JAX_PLATFORMS=cpu python scripts/convergence_sweep.py --nel 320
#:     --r 1 2 --dt 0.02 0.01 --schemes theta-0.5 theta-1.0 newmark-0.25
#:     --results-root res --job-id ""
#:   JAX_PLATFORMS=cpu python scripts/convergence_sweep.py --nel 320
#:     --r 1 2 --dt 0.001 --schemes theta-0.0 newmark-0.00
#:     --results-root res --job-id ""
#: (theta-0.0 blows up at dt 0.001 within its CFL limit, as in
#: analysis/data/convergence-results.csv)
TPUWAVE_CONVERGENCE_320 = {
    ('theta-conv-params', '0.500000', 'N/A', '1', '0.02'):
        ('1.035672e-02', '1.143130e-02'),
    ('theta-conv-params', '0.500000', 'N/A', '1', '0.01'):
        ('2.434971e-03', '5.382905e-03'),
    ('theta-conv-params', '0.500000', 'N/A', '2', '0.02'):
        ('1.056619e-02', '1.056628e-02'),
    ('theta-conv-params', '0.500000', 'N/A', '2', '0.01'):
        ('2.644694e-03', '2.645180e-03'),
    ('theta-conv-params', '1.000000', 'N/A', '1', '0.02'):
        ('1.441142e-01', '1.441725e-01'),
    ('theta-conv-params', '1.000000', 'N/A', '1', '0.01'):
        ('8.451169e-02', '8.462533e-02'),
    ('theta-conv-params', '1.000000', 'N/A', '2', '0.02'):
        ('1.439390e-01', '1.439390e-01'),
    ('theta-conv-params', '1.000000', 'N/A', '2', '0.01'):
        ('8.431971e-02', '8.431971e-02'),
    ('newmark-conv-params', 'N/A', '0.250000', '1', '0.02'):
        ('1.035672e-02', '1.143126e-02'),
    ('newmark-conv-params', 'N/A', '0.250000', '1', '0.01'):
        ('2.434970e-03', '5.382873e-03'),
    ('newmark-conv-params', 'N/A', '0.250000', '2', '0.02'):
        ('1.056619e-02', '1.056619e-02'),
    ('newmark-conv-params', 'N/A', '0.250000', '2', '0.01'):
        ('2.644695e-03', '2.644711e-03'),
    ('theta-conv-params', '0.000000', 'N/A', '1', '0.001'):
        ('6.382746e+151', 'inf'),
    ('newmark-conv-params', 'N/A', '0.000000', '1', '0.001'):
        ('2.233323e-04', '4.793127e-03'),
}
#: phase 27 (b): the dissipation sweep at its defaults (Nel 60, R 1, T 5,
#: Log Every 1) on dt >= 0.005, as two plans (name, schemes, dt): every
#: scheme from 0.15 to 0.05 (the CFL filter drops the explicit ones: their
#: limit is 0.0106), and Newmark beta 0 at 0.005, the explicit scheme's
#: stable run (theta 0 blows up there, as in analysis/data)
DISSDISP_PLANS = (
    ("ladder", ("theta-0.0", "theta-0.5", "theta-1.0", "newmark-0.00",
                "newmark-0.25"), ("0.15", "0.1", "0.05")),
    ("explicit", ("newmark-0.00",), ("0.005",)),
)
#: tpuwave's dissdisp-results.csv rows of those plans, (scheme, dt) ->
#: (energy_ratio, energy_decay_rate, max_rel_L2, final_rel_L2,
#: final_rel_H1), from a CPU run of the JAX package's own sweep script
#: (f64) in an empty directory (its rows of the plans above):
#:   JAX_PLATFORMS=cpu python scripts/dissipation_dispersion_sweep.py
#:     --dt 0.15 0.1 0.05 0.02 0.01 0.005 --results-root res --job-id ""
TPUWAVE_DISSDISP = {
    ('theta-0.5', '0.15'):
        ('1.0', '0.0', '11.74243', '0.2647401', '0.2667038'),
    ('theta-0.5', '0.1'):
        ('1.0', '0.0', '18.6379', '0.2109595', '0.213215'),
    ('theta-0.5', '0.05'):
        ('1.0', '0.0', '4.521223', '0.03605706', '0.04472659'),
    ('theta-1.0', '0.15'):
        ('5.369693527420922e-06', '0.19607737849146523', '2.273927', '1.001019', '1.001019'),
    ('theta-1.0', '0.1'):
        ('0.00012182248026641552', '0.19605454461171248', '1.865921', '0.9898736', '0.9898736'),
    ('theta-1.0', '0.05'):
        ('0.008065766244815484', '0.1964226205455811', '2.920896', '0.9033257', '0.9033291'),
    ('newmark-0.00', '0.005'):
        ('0.9999918924616108', '1.6198877900594182e-06', '7.119506', '0.002555843', '0.02560677'),
    ('newmark-0.25', '0.15'):
        ('1.0', '0.0', '11.74243', '0.2647401', '0.2667038'),
    ('newmark-0.25', '0.1'):
        ('1.0', '0.0', '18.6379', '0.2109595', '0.213215'),
    ('newmark-0.25', '0.05'):
        ('1.0', '0.0', '4.521223', '0.03605706', '0.04472659'),
}


def _script(name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _in_dir(path: Path, fn, *args):
    """``fn(*args)`` with ``path`` (made) as the working directory and its
    console output captured: (result, wall s, text)."""
    path.mkdir(parents=True, exist_ok=True)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.chdir(path), contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, time.perf_counter() - t0, buf.getvalue()


def _blowup(vals) -> bool:
    """compare_with_reference.py's test of a run that left the solution."""
    import math
    return any(not math.isfinite(v) or abs(v) > 1e10 for v in vals)


def _pinned_gate(name: str, rows: list, pins: dict, key, cols,
                 computed=()) -> list:
    """``rows`` (csv.DictReader rows) against tpuwave's pinned values by
    ``key(row)``: each of ``cols`` within rtol 1e-6 plus one unit in the
    last printed digit (``computed`` columns, full-precision floats the
    sweep derives from printed ones, within rtol 1e-6 plus 1e-12), or a
    blowup on both sides."""
    bad = []
    if sorted(key(r) for r in rows) != sorted(pins):
        return [f"{name}: rows {sorted(key(r) for r in rows)} against "
                f"tpuwave's {sorted(pins)}"]
    for r in rows:
        want = dict(zip(cols, pins[key(r)]))
        gv = [float(r[c]) for c in cols]
        wv = [float(want[c]) for c in cols]
        if _blowup(gv) or _blowup(wv):
            if _blowup(gv) != _blowup(wv):
                bad.append(f"{name} {key(r)}: blowup {gv} vs {wv}")
            continue
        for c in cols:
            if c in computed:
                a, b = float(r[c]), float(want[c])
                if abs(a - b) > 1e-6 * max(abs(a), abs(b)) + 1e-12:
                    bad.append(f"{name} {key(r)} {c}: {r[c]} vs {want[c]}")
            else:
                bad += _rows_gate(f"{name} {key(r)}", [c], [r[c]],
                                  [want[c]], 1e-6)
    return bad


def _compare_tool(ours: Path, ref: Path) -> str:
    """The summary line of scripts/compare_with_reference.py."""
    tool = _script("compare_with_reference")
    argv, sys.argv = sys.argv, ["compare_with_reference", str(ours),
                                str(ref)]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            tool.main()
    finally:
        sys.argv = argv
    return buf.getvalue().strip().splitlines()[-1]


def phase_sweeps(torch, kn, work: Path):
    say("phase 27: the sweeps through scripts/torch_*.py on cuda: (a) "
        "convergence at Nel 320, R = 1 and 2, five schemes, T 1; (b) "
        "dissipation at its defaults (Nel 60, T 5, Log Every 1), dt >= "
        "0.005; (c) scalability at its defaults (640^2, dt 8e-5, f32) "
        f"but --T {SCALABILITY_T} and --repeats 1; (d) acceptance, 12 "
        "presets x 2 families, --t-max 0.05")
    failed = []

    # (a) convergence
    conv = _script("torch_convergence_sweep")
    rows = []
    for tag, schemes, dts in CONVERGENCE_PLANS:
        where = work / "sweeps" / f"convergence-{tag}"
        _, wall, text = _in_dir(where, conv.main, [
            "--nel", "320", "--r", "1", "2", "--dt", *dts, "--schemes",
            *schemes, "--results-root", "res", "--job-id", "", "--device",
            "cuda"])
        log = list(csv.DictReader((where / "convergence-runlog.csv").open()))
        got = list(csv.DictReader((where / "convergence-results.csv")
                                  .open()))
        rows += got
        codes = [int(r["returncode"]) for r in log]
        say(f"  (a) {tag}: {len(log)} runs in {wall:.2f} s, return codes "
            f"{codes}, run walls "
            f"{[round(float(r['elapsed_s']), 2) for r in log]} s")
        if any(codes):
            failed.append(f"(a) {tag}: return codes {codes}")
    merged = work / "sweeps" / "convergence-results.csv"
    with merged.open("w") as fh:
        w = csv.DictWriter(fh, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    for r in rows:
        say(f"      {r['method']:<20} R {r['r']} dt {r['dt']:<6} theta "
            f"{r['theta']:<9} beta {r['beta']:<9} rel L2 "
            f"{r['rel_L2_error_final']} rel H1 {r['rel_H1_error_final']}")
    failed += _pinned_gate(
        "(a)", rows, TPUWAVE_CONVERGENCE_320,
        lambda r: (r["method"], r["theta"], r["beta"], r["r"], r["dt"]),
        ("rel_L2_error_final", "rel_H1_error_final"))
    say(f"  (a) against analysis/data/convergence-results.csv (report "
        f"only): {_compare_tool(merged, ROOT / 'analysis' / 'data' / 'convergence-results.csv')}")

    # (b) dissipation
    diss = _script("torch_dissipation_dispersion_sweep")
    got = []
    for tag, schemes, dts in DISSDISP_PLANS:
        where = work / "sweeps" / f"dissdisp-{tag}"
        _, wall, text = _in_dir(where, diss.main, [
            "--dt", *dts, "--schemes", *schemes, "--results-root", "res",
            "--job-id", "", "--device", "cuda"])
        log = list(csv.DictReader((where / "dissdisp-runlog.csv").open()))
        got += list(csv.DictReader((where / "dissdisp-results.csv").open()))
        codes = [int(r["returncode"]) for r in log]
        n_steps = sum(round(float(r["T"]) / float(r["dt"])) for r in log)
        say(f"  (b) {tag}: {len(log)} runs, ~{n_steps} steps with per-step "
            f"diagnostics, in {wall:.2f} s; return codes {codes}")
        if any(codes):
            failed.append(f"(b) {tag}: return codes {codes}")
    diss_csv = work / "sweeps" / "dissdisp-results.csv"
    with diss_csv.open("w") as fh:
        w = csv.DictWriter(fh, fieldnames=list(got[0]))
        w.writeheader()
        w.writerows(got)
    for r in got:
        say(f"      {r['scheme']:<13} dt {r['dt']:<6} E ratio "
            f"{r['energy_ratio']} final rel L2 {r['final_rel_L2']}")
    failed += _pinned_gate(
        "(b)", got, TPUWAVE_DISSDISP,
        lambda r: (r["scheme"], r["dt"]),
        ("energy_ratio", "energy_decay_rate", "max_rel_L2", "final_rel_L2",
         "final_rel_H1"), computed=("energy_ratio", "energy_decay_rate"))
    say(f"  (b) against analysis/data/dissdisp-results.csv (report only): "
        f"{_compare_tool(diss_csv, ROOT / 'analysis' / 'data' / 'dissdisp-results.csv')}")

    # (c) scalability
    where = work / "sweeps" / "scalability"
    rc, wall, text = _in_dir(where, _script("torch_scalability_sweep").main,
                             ["--repeats", "1", "--T", str(SCALABILITY_T),
                              "--job-id", ""])
    out = where / "scalability-results-1.csv"
    got = list(csv.DictReader(out.open()))
    head = out.read_text().splitlines()[0]
    want_head = ("scheme,binary,nprocs,repeat,Nel,R,Dt,T,Theta,Beta,Gamma,"
                 "returncode,seconds")
    dofs = 641 * 641 * round(SCALABILITY_T / 8e-5)
    say(f"  (c) exit {rc} in {wall:.2f} s (warm runs included); "
        f"{len(got)} rows")
    for scheme in dict.fromkeys(r["scheme"] for r in got):
        secs = [float(r["seconds"]) for r in got if r["scheme"] == scheme]
        say(f"      {scheme:<13} {' / '.join(f'{s:.4f}' for s in secs)} s, "
            f"best {dofs / min(secs):.4e} DoF*steps/s")
    if rc != 0 or head != want_head or len(got) != 5 or \
            {r["binary"] for r in got} != {"tpuwave_torch-fast"}:
        failed.append(f"(c) exit {rc}, header {head!r}, {len(got)} rows")

    # (d) acceptance
    summary = work / "sweeps" / "acceptance-summary.csv"
    rc, wall, text = _in_dir(work / "sweeps" / "acceptance",
                             _script("torch_acceptance").main,
                             ["--t-max", "0.05", "--out", str(summary)])
    got = list(csv.DictReader(summary.open()))
    ref = {(r["preset"], r["family"]): r for r in csv.DictReader(
        (ROOT / "analysis" / "data" / "acceptance-summary.csv").open())}
    n_ok = sum(r["status"] == "OK" for r in got)
    say(f"  (d) exit {rc} in {wall:.2f} s: {n_ok} of {len(got)} runs OK")
    for r in got:
        if r["final_rel_L2"]:
            w = ref.get((r["preset"], r["family"]), {})
            say(f"      {r['preset']:<24} {r['family']:<8} rel L2 "
                f"{r['final_rel_L2']} (committed tpuwave "
                f"{w.get('final_rel_L2', '-')}), rel H1 "
                f"{r['final_rel_H1']} ({w.get('final_rel_H1', '-')}); "
                f"{r['elapsed_s']} s")
    if rc != 0 or n_ok != len(got) or len(got) != 24:
        failed.append(f"(d) exit {rc}, {n_ok} of {len(got)} runs OK")
    say(f"  {'ok' if not failed else 'FAIL: ' + '; '.join(failed)}")
    if failed:
        raise AssertionError("phase 27: " + "; ".join(failed))


# ---------------------------------------------------------------------------
# phases 28 and 29: path K, the rest of FWI (imaging, encoding, optimizers)
# ---------------------------------------------------------------------------
#: tpuwave's values pinned by phase 29, f64, computed on the CPU with the
#: JAX package: imaging_showcase.py's defaults (64^2, dt 0.35/64, 200 steps,
#: 5 shots and 24 receivers at y = 0.89, ring sponge 0.08, engine stencil,
#: adjoint reversal; c2_bg and dm_true its smooth background and
#: reflectivity_model): ||born(c2_bg, dm_true, srcs)||, ||rtm_image(c2_bg,
#: d, srcs)|| and lsrtm(c2_bg, d, n_iter=10, srcs)'s 11 residual norms:
#:   JAX_PLATFORMS=cpu python -c "from tpuwave import config;
#:     config.use_x64(); import numpy as np, jax.numpy as jnp;
#:     from tpuwave.models.inverse import FwiProblem;
#:     y = 0.89; p = FwiProblem((64, 64), ((0., 0.), (1., 1.)), 0.35 / 64,
#:       200, source=(0.5, y), receivers=[(x, y) for x in
#:       np.linspace(0.1, 0.9, 24)], sponge_width=0.08, engine='stencil',
#:       adjoint='reversal', boundary_save='ring');
#:     s = p.snap_vertices([(x, y) for x in np.linspace(0.15, 0.85, 5)]);
#:     c = p.mesh.vertex_coords[np.asarray(p.mesh.cells)].mean(1);
#:     x, z = c[:, 0], 1 - c[:, 1];
#:     c2 = jnp.asarray(1 + 0.6 * np.clip((z - 0.2) / 0.6, 0, 1));
#:     dm = np.zeros(p.n_cells); h = 1 / 64;
#:     dm[(abs(z - 0.45 - 0.2 * (x - 0.2)) < 0.8 * h) & (x > 0.2)
#:       & (x < 0.7)] = 0.15;
#:     [dm.__setitem__((x - a) ** 2 + (z - b) ** 2 < (1.5 * h) ** 2, 0.2)
#:       for a, b in ((0.8, 0.35), (0.35, 0.7))];
#:     d = p.born(c2, jnp.asarray(dm), sources=s);
#:     print(repr(float(jnp.linalg.norm(d))), repr(float(jnp.linalg.norm(
#:       p.rtm_image(c2, d, sources=s)))), repr(tuple(float(v) for v in
#:       p.lsrtm(c2, d, n_iter=10, sources=s)[1])))"
TPUWAVE_IMAGING_64 = (
    0.03400907825174475, 0.019607606559498923,
    (0.03400907825174475, 0.03081960667031168, 0.02622728848728594,
     0.02381583205389829, 0.02272789663177734, 0.0212605839507676,
     0.020204127037653338, 0.018698232446968555, 0.018184856433922446,
     0.01734504340512944, 0.01645975503305309))
#: tpuwave's misfit histories at fwi_demo.py's defaults (32^2, dt 0.006,
#: 160 steps, source (0.25, 0.5), its 8 receivers, c2_true its anomaly,
#: c2 = 1 to start), f64, on the CPU with the JAX package:
#: "gauss_newton" invert_gauss_newton(simulate(c2_true), ones, n_outer=3,
#: n_cg=3, bounds=(0.3, 2.0)) and "encoded" invert_encoded(
#: simulate_shots(c2_true, s), ones, sources=s, key=PRNGKey(0), n_iter=5,
#: learning_rate=0.02, bounds=(0.3, 2.0)) with s its 4-shot ring, both
#: on fwi_demo.py's engine="stencil", adjoint="remat"; "lbfgs" invert(
#: simulate(c2_true), ones, n_iter=5, optimizer="lbfgs", bounds=(0.3, 2.0))
#: on engine="stencil", adjoint="reversal":
#:   JAX_PLATFORMS=cpu python -c "from tpuwave import config;
#:     config.use_x64(); import numpy as np, jax, jax.numpy as jnp;
#:     from tpuwave.models.inverse import FwiProblem;
#:     r = [(x, y) for x in (0.15, 0.5, 0.85) for y in (0.15, 0.85)]
#:       + [(0.15, 0.5), (0.85, 0.5)];
#:     P = lambda **k: FwiProblem((32, 32), ((0., 0.), (1., 1.)), 0.006,
#:       160, source=(0.25, 0.5), receivers=r, engine='stencil', **k);
#:     p, q = P(adjoint='remat'), P(adjoint='reversal');
#:     c = p.mesh.vertex_coords[np.asarray(p.mesh.cells)].mean(1);
#:     t = jnp.asarray(np.where(np.sum((c - [0.6, 0.5]) ** 2, 1)
#:       < 0.18 ** 2, 0.65, 1.0)); o = jnp.ones(p.n_cells);
#:     s = p.snap_vertices([(0.2 + 0.2 * k, 0.2) for k in range(4)]);
#:     print(p.invert_gauss_newton(p.simulate(t), o, n_outer=3, n_cg=3,
#:       bounds=(0.3, 2.0)).misfits.tolist(), p.invert_encoded(
#:       p.simulate_shots(t, s), o, sources=s, key=jax.random.PRNGKey(0),
#:       n_iter=5, learning_rate=0.02, bounds=(0.3, 2.0)).misfits.tolist(),
#:       q.invert(q.simulate(t), o, n_iter=5, optimizer='lbfgs',
#:       bounds=(0.3, 2.0)).misfits.tolist())"
TPUWAVE_FWI_DEMO = {
    "gauss_newton": (0.0075150007981942485, 0.006329591884208297,
                     0.0055159155594254015),
    "encoded": (0.021266643848478588, 0.030486344621090348,
                0.03766303447493402, 0.026930051103346467,
                0.023665671684825695),
    "lbfgs": (0.0075150007981942485, 0.0074203251194294995,
              0.006964820015259194, 0.0065907527059744,
              0.006076680347593183),
}
#: tpuwave's misfit history of fwi_showcase.py's inversion at its defaults
#: (96^2, dt 0.35/96, 360 steps, 6 shots, 24 receivers, ring sponge 0.08,
#: its layered model and smooth start) with precondition="illumination"
#: (so optimizer="adam", lr 0.03, reg 1e-3, bounds (0.5, 2.2)), cutoffs
#: (0.6 f_peak, None), 3 + 3 iterations, f64, engine stencil, adjoint
#: reversal, on the CPU with the JAX package:
#:   JAX_PLATFORMS=cpu python -c "from tpuwave import config;
#:     config.use_x64(); import numpy as np, jax.numpy as jnp;
#:     from tpuwave.models.inverse import FwiProblem;
#:     from scripts.fwi_showcase import layered_model;
#:     dt, y, w = 0.35 / 96, 0.89, 0.11;
#:     r = [(x, y) for x in np.linspace(0.12, 0.88, 8)] + [(w, v) for v in
#:       np.linspace(0.15, 0.85, 8)] + [(1 - w, v) for v in
#:       np.linspace(0.15, 0.85, 8)];
#:     p = FwiProblem((96, 96), ((0., 0.), (1., 1.)), dt, 360,
#:       source=(0.5, y), receivers=r, sponge_width=0.08, engine='stencil',
#:       adjoint='reversal', boundary_save='ring');
#:     s = p.snap_vertices([(x, y) for x in np.linspace(0.15, 0.85, 6)]);
#:     z = 1 - p.mesh.vertex_coords[np.asarray(p.mesh.cells)].mean(1)[:, 1];
#:     print(p.invert_multiscale(p.simulate_shots(jnp.asarray(
#:       layered_model(p, np)), s), jnp.asarray(1 + 0.8 * np.clip(
#:       (z - 0.3) / 0.5, 0, 1)), cutoffs=[0.6 / (20 * dt), None],
#:       n_iter=[3, 3], learning_rate=0.03, bounds=(0.5, 2.2), sources=s,
#:       optimizer='adam', reg_lambda=1e-3,
#:       precondition='illumination').misfits.tolist())"
TPUWAVE_FWI_SHOWCASE = (0.02738380499505181, 0.02771519159046307,
                        0.0261017199541852, 0.14619037559435444,
                        0.13223084319607764, 0.08172156986401438)
#: phase 28's configuration: scripts/bench_imaging.py's defaults
IMAGING_NEL, IMAGING_DT, IMAGING_STEPS, IMAGING_SHOTS = 512, 4e-4, 1000, 8


def _imaging_problem(torch, dtype, engine="stencil", receivers_y=0.9):
    """bench_imaging.py's problem: 512^2, source (0.5, 0.1), 9 receivers
    at y = 0.9 (or ``receivers_y``), the reversal adjoint; its 8 shots at
    y = 0.1."""
    import numpy as np
    from tpuwave_torch.models.inverse import FwiProblem
    p = FwiProblem((IMAGING_NEL, IMAGING_NEL), UNIT_SQUARE, IMAGING_DT,
                   IMAGING_STEPS, source=(0.5, 0.1),
                   receivers=[(x, receivers_y)
                              for x in np.linspace(0.1, 0.9, 9)],
                   engine=engine, adjoint="reversal", dtype=dtype,
                   device="cuda")
    return p, p.snap_vertices(
        [(x, 0.1) for x in np.linspace(0.1, 0.9, IMAGING_SHOTS)])


def _vg(torch, loss):
    """value-and-gradient of ``loss`` in its first argument."""
    def f(m, *rest):
        m = m.detach().requires_grad_(True)
        with torch.enable_grad():
            val = loss(m, *rest)
            (g,) = torch.autograd.grad(val, m)
        return val.detach(), g
    return f


def phase_imaging(torch):
    import numpy as np
    from tpuwave_torch.utils import prng

    n_shots = IMAGING_SHOTS
    say(f"phase 28 ({nvidia_smi_line()}): imaging at "
        f"scripts/bench_imaging.py's defaults: "
        f"{IMAGING_NEL}^2 elements, dt {IMAGING_DT}, {IMAGING_STEPS} steps, "
        f"{n_shots} shots at y = 0.1, 9 receivers at y = 0.9, f32, stencil "
        f"engine, reversal adjoint; each timed once after a warm run "
        f"(host clock around a synchronize); gates: (a) the f64 "
        f"dot-product test <born dm, d> = <dm, migrate d> of shot 0 with "
        f"migrate on the stencil and on the kernel engine, rel 1e-9; (b) "
        f"the f32 supershot against sum_s codes_s x the f32 single shots, "
        f"within 2x the f32 supershot's rel L2 gap to the f64 one (two "
        f"f32 roundings, each of that size); both gates with the "
        f"receivers moved to y = 0.3: within t = 0.4 no wave from y = 0.1 "
        f"reaches y = 0.9, where the traces are rounding noise in f64 and "
        f"0 in f32")
    f32, f64 = torch.float32, torch.float64
    p, srcs = _imaging_problem(torch, f32)
    pk, _ = _imaging_problem(torch, f32, engine="kernel")
    rng = np.random.default_rng(0)
    c2 = torch.tensor(1.0 + 0.05 * rng.random(p.n_cells), dtype=f32,
                      device="cuda")
    dm = torch.tensor(rng.normal(size=p.n_cells), dtype=f32, device="cuda")
    codes = torch.tensor(rng.choice([-1.0, 1.0], n_shots), dtype=f32,
                         device="cuda")
    with torch.no_grad():
        obs = p.simulate_shots(torch.full_like(c2, 1.1), srcs)
    t_seq, _ = _best_of(torch, lambda: p.misfit_and_grad(c2, obs[0]), 1)
    enc = _vg(torch, lambda m: p.misfit_encoded(m, srcs, codes, obs))
    t_enc, _ = _best_of(torch, lambda: enc(c2), 1)
    t_born, _ = _best_of(torch, lambda: p.born(c2, dm), 1)
    t_mig, _ = _best_of(torch, lambda: p.migrate(c2, obs[0]), 1)
    t_migk, _ = _best_of(torch, lambda: pk.migrate(c2, obs[0]), 1)
    say(f"  sequential gradient {t_seq:.4f} s/shot x {n_shots} = "
        f"{t_seq * n_shots:.4f} s; encoded gradient (one supershot) "
        f"{t_enc:.4f} s: {t_seq * n_shots / t_enc:.2f}x (ideal {n_shots}x)")
    say(f"  one LSRTM iteration: born {t_born:.4f} s + migrate {t_mig:.4f} "
        f"s per shot x {n_shots} = {(t_born + t_mig) * n_shots:.4f} s; "
        f"migrate of shot 0 on the kernel engine (B14-B17) {t_migk:.4f} s "
        f"({t_mig / t_migk:.2f}x the stencil engine's)")

    failed = []
    # (a) the dot-product test in f64, shot 0
    p64, _ = _imaging_problem(torch, f64, receivers_y=0.3)
    pk64, _ = _imaging_problem(torch, f64, engine="kernel", receivers_y=0.3)
    c2d, dmd = c2.double(), dm.double()
    shot0 = srcs[:1]
    d = torch.tensor(rng.normal(size=(1, IMAGING_STEPS, 9)), dtype=f64,
                     device="cuda")
    lhs = float(torch.sum(p64.born(c2d, dmd, sources=shot0) * d))
    for label, q in (("stencil", p64), ("kernel", pk64)):
        rhs = float(torch.sum(dmd * q.migrate(c2d, d, sources=shot0)))
        gap = abs(lhs - rhs) / abs(lhs)
        ok = gap <= 1e-9
        say(f"  (a) <born dm, d> {lhs!r}, <dm, migrate d> ({label}) {rhs!r}:"
            f" rel gap {gap:.3e} (bound 1e-9) {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"(a) {label} gap {gap:.3e}")
    del p64, pk64
    # (b) the supershot is the coded sum of the single shots
    with torch.no_grad():
        q, _ = _imaging_problem(torch, f32, receivers_y=0.3)
        sup = q.simulate_supershot(c2, srcs, codes)
        lin = torch.einsum("s,snr->nr", codes, q.simulate_shots(c2, srcs))
        q64, _ = _imaging_problem(torch, f64, receivers_y=0.3)
        sup64 = q64.simulate_supershot(c2d, srcs, codes.double())
        del q, q64
    gap = _rel_l2(torch, sup, sup64)
    err = _rel_l2(torch, sup, lin)
    ok = err <= 2.0 * gap
    say(f"  (b) f32 supershot against the coded sum of the f32 single "
        f"shots: rel L2 {err:.3e}; the f32 supershot's gap to the f64 "
        f"one {gap:.3e}; bound {2.0 * gap:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        failed.append(f"(b) {err:.3e} > 2 x {gap:.3e}")
    if failed:
        raise AssertionError("phase 28: " + "; ".join(failed))


def _pinned(label: str, got, want, rtol: float = 1e-6) -> bool:
    import numpy as np
    got, want = np.asarray(got, float), np.asarray(want, float)
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    ok = got.shape == want.shape and rel <= rtol
    say(f"  {label}: {', '.join(f'{v:.10e}' for v in got.ravel())}; "
        f"max rel diff to tpuwave's {rel:.2e} (bound {rtol:g}) "
        f"{'ok' if ok else 'FAIL'}")
    return ok


def phase_fwi_optim(torch):
    import numpy as np
    from tpuwave_torch.models.inverse import FwiProblem

    layered_model = _script("torch_fwi_showcase").layered_model
    reflectivity_model = _script("torch_imaging_showcase").reflectivity_model

    say(f"phase 29 ({nvidia_smi_line()}): tpuwave's values in f64 (pinned "
        "from CPU runs of the JAX package), rtol 1e-6: imaging_showcase.py's "
        "defaults (born, rtm_image, 10 lsrtm iterations; stencil engine); "
        "fwi_demo.py's "
        "defaults (invert_gauss_newton 3 x 3 and invert_encoded with 4 "
        "shots, key 0, 5 iterations, on its stencil engine with the remat "
        "adjoint; 5 L-BFGS iterations with bounds (0.3, 2.0) on the kernel "
        "engine); fwi_showcase.py's multiscale inversion with "
        "precondition='illumination', 3 + 3 iterations, on the kernel "
        "engine; and the grid engine with the remat adjoint at 256^2 "
        "against the kernel engine's reversal gradient, rel 1e-9")
    f64 = torch.float64
    kw = dict(dtype=f64, device="cuda")
    ok = []

    def ones(p):
        return torch.ones(p.n_cells, **kw)

    # imaging_showcase.py
    t0 = time.perf_counter()
    y = 1.0 - 0.08 - 0.03
    p = FwiProblem((64, 64), UNIT_SQUARE, 0.35 / 64, 200, source=(0.5, y),
                   receivers=[(x, y) for x in np.linspace(0.1, 0.9, 24)],
                   sponge_width=0.08, engine="stencil", adjoint="reversal",
                   boundary_save="ring", **kw)
    srcs = p.snap_vertices([(x, y) for x in np.linspace(0.15, 0.85, 5)])
    z = 1.0 - p.mesh.vertex_coords[np.asarray(p.mesh.cells)].mean(1)[:, 1]
    c2 = torch.tensor(1.0 + 0.6 * np.clip((z - 0.2) / 0.6, 0, 1), **kw)
    d = p.born(c2, torch.tensor(reflectivity_model(p, np), **kw),
               sources=srcs)
    rtm = p.rtm_image(c2, d, sources=srcs)
    _, norms = p.lsrtm(c2, d, n_iter=10, sources=srcs)
    want = TPUWAVE_IMAGING_64
    ok.append(_pinned("imaging_showcase ||born||, ||rtm_image||",
                      [float(torch.linalg.vector_norm(d)),
                       float(torch.linalg.vector_norm(rtm))], want[:2]))
    ok.append(_pinned("imaging_showcase lsrtm residual norms", norms,
                      want[2]))
    say(f"    ({time.perf_counter() - t0:.2f} s)")

    # fwi_demo.py
    t0 = time.perf_counter()
    recs = [(x, y) for x in (0.15, 0.5, 0.85) for y in (0.15, 0.85)]
    recs += [(0.15, 0.5), (0.85, 0.5)]

    def demo(**over):
        return FwiProblem((32, 32), UNIT_SQUARE, 0.006, 160,
                          source=(0.25, 0.5), receivers=recs, **over, **kw)
    p = demo(engine="stencil", adjoint="remat")
    c2t = torch.tensor(_fwi_disk(np, p), **kw)
    ring = p.snap_vertices([(0.2 + 0.2 * k, 0.2) for k in range(4)])
    with torch.no_grad():
        obs, obs4 = p.simulate(c2t), p.simulate_shots(c2t, ring)
    res = p.invert_gauss_newton(obs, ones(p), n_outer=3, n_cg=3,
                                bounds=(0.3, 2.0))
    ok.append(_pinned("fwi_demo invert_gauss_newton misfits", res.misfits,
                      TPUWAVE_FWI_DEMO["gauss_newton"]))
    res = p.invert_encoded(obs4, ones(p), sources=ring, key=0, n_iter=5,
                           learning_rate=0.02, bounds=(0.3, 2.0))
    ok.append(_pinned("fwi_demo invert_encoded misfits", res.misfits,
                      TPUWAVE_FWI_DEMO["encoded"]))
    pk = demo(engine="kernel")
    res = pk.invert(obs, ones(pk), n_iter=5, optimizer="lbfgs",
                    bounds=(0.3, 2.0))
    ok.append(_pinned("fwi_demo invert(lbfgs) misfits (kernel engine)",
                      res.misfits, TPUWAVE_FWI_DEMO["lbfgs"]))
    say(f"    ({time.perf_counter() - t0:.2f} s)")

    # fwi_showcase.py
    t0 = time.perf_counter()
    nel, dt, y, w = 96, 0.35 / 96, 1.0 - 0.08 - 0.03, 0.08 + 0.03
    recs = [(x, y) for x in np.linspace(0.12, 0.88, 8)]
    recs += [(w, v) for v in np.linspace(0.15, 0.85, 8)]
    recs += [(1.0 - w, v) for v in np.linspace(0.15, 0.85, 8)]
    p = FwiProblem((nel, nel), UNIT_SQUARE, dt, 360, source=(0.5, y),
                   receivers=recs, sponge_width=0.08, engine="kernel",
                   adjoint="reversal", boundary_save="ring", **kw)
    srcs = p.snap_vertices([(x, y) for x in np.linspace(0.15, 0.85, 6)])
    z = 1.0 - p.mesh.vertex_coords[np.asarray(p.mesh.cells)].mean(1)[:, 1]
    with torch.no_grad():
        obs = p.simulate_shots(torch.tensor(layered_model(p, np), **kw),
                               srcs)
    res = p.invert_multiscale(
        obs, torch.tensor(1.0 + 0.8 * np.clip((z - 0.3) / 0.5, 0, 1), **kw),
        cutoffs=[0.6 / (20 * dt), None], n_iter=[3, 3], learning_rate=0.03,
        bounds=(0.5, 2.2), sources=srcs, optimizer="adam", reg_lambda=1e-3,
        precondition="illumination")
    ok.append(_pinned("fwi_showcase invert_multiscale misfits (kernel "
                      "engine)", res.misfits, TPUWAVE_FWI_SHOWCASE))
    say(f"    ({time.perf_counter() - t0:.2f} s)")

    # the grid engine with the remat adjoint at 256^2
    t0 = time.perf_counter()
    grads = {}
    for label, over in (("grid, remat", dict(engine="grid", adjoint="remat")),
                        ("kernel, reversal", dict(engine="kernel"))):
        p = FwiProblem((256, 256), UNIT_SQUARE, 2.5e-3, 200,
                       source=FWI_SOURCE, receivers=FWI_RECEIVERS, **over,
                       **kw)
        c2t = torch.tensor(_fwi_disk(np, p), **kw)
        with torch.no_grad():
            obs = p.simulate(c2t)
        torch.cuda.reset_peak_memory_stats()
        v, grads[label] = p.misfit_and_grad(torch.full_like(c2t, 0.9), obs)
        say(f"  256^2 {label:<16}: misfit {float(v)!r}, ||grad|| "
            f"{float(torch.linalg.vector_norm(grads[label]))!r} (tpuwave "
            f"{TPUWAVE_FWI_256[0]!r}, {TPUWAVE_FWI_256[1]!r}), peak device "
            f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    rel = _rel_l2(torch, grads["grid, remat"], grads["kernel, reversal"])
    ok.append(rel <= 1e-9)
    say(f"  256^2 remat (grid) against reversal (kernel) gradient: rel L2 "
        f"{rel:.3e} (bound 1e-9) {'ok' if ok[-1] else 'FAIL'} "
        f"({time.perf_counter() - t0:.2f} s)")
    if not all(ok):
        raise AssertionError("phase 29: a value differs from tpuwave's")


# ---------------------------------------------------------------------------
# phases 30 and 31: path L, the paths only the bench scripts reach
# ---------------------------------------------------------------------------
#: tpuwave's P2 bench solvers in f64, pinned by phase 30 (b), computed on
#: the CPU with the JAX package from sin(pi x) sin(pi y): P2FastSolver at
#: 200^2 elements, dt 4e-3, theta 1/2, mg, 5 steps (per-step CG of the u-
#: and v-solves, ||u||, ||v||); P2CanvasSolver at 256^2, dt 4e-3, Newmark
#: 1/4, mg, mg_pre_degree 2: the a0 solve's CG, 5 steps (CG, ||u||, ||v||,
#: ||a||), then implicit_2term_init and 4 recurrence steps (CG, ||u||,
#: ||u_prev||); the CG counts read from inside its jitted loops by a debug
#: callback around fast_p2.pcg:
#:   JAX_PLATFORMS=cpu python -c "from tpuwave import config;
#:     config.use_x64(); import jax, jax.numpy as jnp;
#:     from tpuwave.models import fast_p2 as m; its = []; pcg = m.pcg;
#:     m.pcg = lambda *a, **k: (lambda r: (jax.debug.callback(lambda i:
#:       its.append(int(i)), r.iterations), r)[1])(pcg(*a, **k));
#:     n = lambda x: float(jnp.linalg.norm(x));
#:     u0 = lambda x, y: jnp.sin(jnp.pi * x) * jnp.sin(jnp.pi * y);
#:     g = ((0., 0.), (1., 1.));
#:     f = m.P2FastSolver((200, 200), g, 4e-3, scheme='theta', theta=0.5,
#:       dtype=jnp.float64, precond='mg');
#:     s = f.run_scan(f.initial_state(u0), 5);
#:     print('flat', its[:], repr(n(s.u)), repr(n(s.v))); its.clear();
#:     c = m.P2CanvasSolver((256, 256), g, 4e-3, dtype=jnp.float64,
#:       precond='mg', mg_pre_degree=2);
#:     s0 = c.initial_state(u0); a0 = its[:]; its.clear();
#:     s = c.run_scan(s0, 5); print('canvas', a0, its[:], repr(n(s.u)),
#:       repr(n(s.v)), repr(n(s.a))); its.clear();
#:     p = c.run_implicit_2term(c.implicit_2term_init(s), 4);
#:     print('2term', its[:], repr(n(p.u)), repr(n(p.u_prev)))"
TPUWAVE_P2_BENCH = {
    "flat": ([3, 4, 3, 4, 3, 4, 3, 4, 3, 4],
             (199.21099253289273, 78.85088525452387)),
    "canvas": ([4, 4, 4, 4, 4, 4],
               (254.9900704458361, 100.92912406052173, 5033.246066623498)),
    "2term": ([3, 3, 3, 3, 3], (251.96825019530874, 252.7326484971997)),
}

#: scripts/bench_precision.py's implicit rows: the driven CN case
#: (sin(4 pi t) on the x <= 1/3 strip of the y = 0 edge), dt 1e-3
PRECISION_STEPS = 64
PRECISION_IMPLICIT_STEPS = 16


def phase_p2_bench(torch):
    import numpy as np
    from tpuwave_torch.models.fast_p2 import P2CanvasSolver, P2FastSolver

    nel, dt, n = 4096, 1e-3, 10
    u0 = _standing(torch)
    say(f"phase 30 ({nvidia_smi_line()}): the P2 bench solvers "
        f"(models/fast_p2.py). (a) P2CanvasSolver at scripts/"
        f"bench_p2_mg.py's defaults: {nel}^2 elements (67,125,249 DoF), "
        f"f32, Newmark 1/4, dt {dt}, {n} steps, mg (mg_pre_degree 2) and "
        f"jacobi, then the 2-term recurrence (init + {n - 1} steps), on "
        f"cuda; each timed after a 1-step warm run (host clock around a "
        f"synchronize); gates: every end state finite, mg against jacobi "
        f"rel diff < 1e-3, the 2-term against the 3-term end state < 1e-2 "
        f"(the f32 P2 cancellation floor: phase 11b ends 8.6e-4 from the "
        f"exact mode). (b) f64 against tpuwave's pinned CPU runs: "
        f"P2FastSolver 200^2 theta 1/2 mg, P2CanvasSolver 256^2 Newmark "
        f"1/4 mg and its 2-term recurrence: per-step CG counts equal, norms "
        f"within rtol 1e-10")
    failed = []
    ends = {}
    for precond in ("mg", "jacobi"):
        t0 = time.perf_counter()
        s = P2CanvasSolver((nel, nel), UNIT_SQUARE, dt, precond=precond,
                           mg_pre_degree=2, dtype=torch.float32,
                           device="cuda")
        st = s.initial_state(u0)
        setup = time.perf_counter() - t0
        s.run_scan(st, 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = s.run_scan(st, n)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / n * 1e3
        its = list(s.last_iterations)
        pair = s.implicit_2term_init(st)
        s.run_implicit_2term(pair, 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pair = s.run_implicit_2term(pair, n - 1)
        torch.cuda.synchronize()
        ms2 = (time.perf_counter() - t0) / (n - 1) * 1e3
        its2 = list(s.last_iterations)
        d2 = _rel_l2(torch, pair.u, out.u)
        finite = bool(torch.isfinite(out.u).all()
                      and torch.isfinite(pair.u).all())
        ends[precond] = out.u
        say(f"  {precond:<6} setup {setup:.2f} s; 3-term {ms:8.2f} ms/step "
            f"({s.n_dofs / ms * 1e3:.3e} DoF*steps/s), CG {its}; 2-term "
            f"{ms2:8.2f} ms/step ({s.n_dofs / ms2 * 1e3:.3e} DoF*steps/s, "
            f"{ms / ms2:.2f}x), CG {its2}; 2-term against 3-term rel diff "
            f"{d2:.3e}")
        if not (finite and d2 < 1e-2):
            failed.append(f"(a) {precond}: finite {finite}, 2-term diff "
                          f"{d2:.3e}")
        del s, st, out, pair
    d = _rel_l2(torch, ends["jacobi"], ends["mg"])
    say(f"  end-state rel diff jacobi vs mg {d:.3e} (bound 1e-3)")
    if not d < 1e-3:
        failed.append(f"(a) mg against jacobi {d:.3e}")
    del ends

    def gate(label, its, want_its, norms, want_norms):
        rel = float(np.max(np.abs(np.asarray(norms) - want_norms)
                           / np.asarray(want_norms)))
        ok = list(its) == list(want_its) and rel <= 1e-10
        say(f"  (b) {label}: CG {list(its)} (tpuwave {list(want_its)}), "
            f"norms {', '.join(repr(v) for v in norms)}, max rel diff to "
            f"tpuwave's {rel:.2e} {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"(b) {label}")

    def norms(*xs):
        return [float(torch.linalg.vector_norm(x)) for x in xs]

    f = P2FastSolver((200, 200), UNIT_SQUARE, 4e-3, scheme="theta",
                     theta=0.5, dtype=torch.float64, precond="mg",
                     device="cuda")
    out = f.run_scan(f.initial_state(u0), 5)
    gate("P2FastSolver 200^2 theta 1/2 mg", _flat(f.last_iterations),
         *TPUWAVE_P2_BENCH["flat"][:1], norms(out.u, out.v),
         TPUWAVE_P2_BENCH["flat"][1])
    c = P2CanvasSolver((256, 256), UNIT_SQUARE, 4e-3, dtype=torch.float64,
                       precond="mg", mg_pre_degree=2, device="cuda")
    st = c.initial_state(u0)
    its = list(c.last_iterations)
    out = c.run_scan(st, 5)
    gate("P2CanvasSolver 256^2 Newmark 1/4 mg", its + c.last_iterations,
         *TPUWAVE_P2_BENCH["canvas"][:1], norms(out.u, out.v, out.a),
         TPUWAVE_P2_BENCH["canvas"][1])
    pair = c.implicit_2term_init(out)
    its = list(c.last_iterations)
    pair = c.run_implicit_2term(pair, 4)
    gate("P2CanvasSolver 256^2 2-term (init + 4)", its + c.last_iterations,
         *TPUWAVE_P2_BENCH["2term"][:1], norms(pair.u, pair.u_prev),
         TPUWAVE_P2_BENCH["2term"][1])
    say(f"  {'ok' if not failed else 'FAIL: ' + '; '.join(failed)}")
    if failed:
        raise AssertionError("phase 30: " + "; ".join(failed))


def phase_precision(torch):
    from tpuwave_torch.models.fast import (CompensatedState, FastWaveSolver,
                                           LeapfrogState)
    from tpuwave_torch.models.fast_engine import make_fast_solver
    from tpuwave_torch.utils.params import load_params

    prec = _script("torch_bench_precision")
    nel, n, ni = 4096, PRECISION_STEPS, PRECISION_IMPLICIT_STEPS
    say(f"phase 31 ({nvidia_smi_line()}): scripts/bench_precision.py's "
        f"rows at {nel}^2 elements on cuda, each timed once after a warm "
        f"run (cut from 3 repeats); the explicit rows at its {n} steps "
        f"(dt 8e-5, standing mode), the implicit rows cut from 64 to {ni} "
        f"steps (driven CN, dt 1e-3, --solver 2term --precond mg: the f64 "
        f"row is the one the TPU could not run). Gates, from the same f32 "
        f"start as the f64 reference (its state cast up): the compensated "
        f"leapfrog's head + tail rel L2 ec < ep / 10 of the plain f32 "
        f"leapfrog's and its head < 2 ep; the compensated 2-term (standing "
        f"CN, tol_factor 1e-3) ec < ep / 8; the compensated driven 2-term "
        f"within 3e-6 (max rel) of the f64 2-term engine from rest at "
        f"tpuwave's gate size (24^2, dt 1e-2, 20 steps), its {nel}^2 "
        f"difference after {ni} steps reported")
    failed = []
    u0 = _standing(torch)

    def u0_32(xs, ys):
        return u0(xs.double(), ys.double()).to(xs.dtype)

    def timed(label, run, state, n_dofs, steps):
        out = run(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(out)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        say(f"  {label}: {sec / steps * 1e6:9.1f} us/step  "
            f"{n_dofs * steps / sec:.3e} DoF*steps/s")
        return out

    def rel(a, ref):
        return _rel_l2(torch, a, ref)

    # (a) the explicit rows, then the leapfrog gate from one start
    s32 = FastWaveSolver((nel, nel), UNIT_SQUARE, 8e-5, beta=0.0,
                         dtype=torch.float32, device="cuda")
    s64 = FastWaveSolver((nel, nel), UNIT_SQUARE, 8e-5, beta=0.0,
                         dtype=torch.float64, device="cuda")
    timed("f32  roll scan   ", lambda st: s32.run_leapfrog_scan(st, n),
          s32.initial_leapfrog_state(u0), s32.n_dofs, n)
    timed("f32c compensated ", lambda st: s32.run_leapfrog_compensated(st, n),
          s32.initial_compensated_state(u0), s32.n_dofs, n)
    timed("f64  roll scan   ", lambda st: s64.run_leapfrog_scan(st, n),
          s64.initial_leapfrog_state(u0), s64.n_dofs, n)
    lf = s32.initial_leapfrog_state(u0_32)
    ref = s64.run_leapfrog_scan(LeapfrogState(lf.u.double(),
                                              lf.u_prev.double()), n).u
    ep = rel(s32.run_leapfrog_scan(lf, n).u, ref)
    comp = s32.run_leapfrog_compensated(s32.initial_compensated_state(u0_32),
                                        n)
    ec = rel(comp.u.double() + comp.u_lo.double(), ref)
    eh = rel(comp.u, ref)
    ok = ec < ep / 10 and eh < 2 * ep
    say(f"  (a) leapfrog, {n} steps: ep {ep:.3e}, ec {ec:.3e} "
        f"({ep / max(ec, 1e-300):.1f}x), eh {eh:.3e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failed.append(f"(a) ep {ep:.3e} ec {ec:.3e} eh {eh:.3e}")
    del s32, s64, lf, ref, comp

    # (b) the implicit rows
    ts = (1e-3 * (1.0 + torch.arange(ni, dtype=torch.float64))).tolist()
    case = load_params(prec.implicit_case(nel))

    def engine_row(label, dtype):
        eng = make_fast_solver(case, "theta", solver="2term", precond="mg",
                               dtype=dtype, device="cuda")
        first, info = eng.run_steps(eng.initial_state(), ts)
        timed(label, lambda st: eng.run_steps(st, ts)[0], first,
              eng.disc.n_dofs, ni)
        say(f"      CG per step {info['iterations_1'].tolist()}")
        return torch.as_tensor(eng.disc.vertex_values(first.u),
                               device="cuda").reshape(nel + 1,
                                                      nel + 1).double()

    engine_row("f32  implicit CN driven (2term mg)", torch.float32)
    sc = FastWaveSolver((nel, nel), UNIT_SQUARE, 1e-3, scheme="theta",
                        theta=0.5, lumped=False, dtype=torch.float32,
                        device="cuda")
    def g_strip(x, y, t):
        # the engine case's G: if(y < 0.0001 && x < 0.34, sin(4 pi t), 0)
        # (bench_precision.py's own comp row drives x <= 1/3, which at
        # 4096^2 leaves out the node at x = 1392 / 4096)
        return torch.where((y < 1e-4) & (x < 0.34),
                           torch.sin(4.0 * torch.pi * t), 0.0)

    first = sc.run_implicit_mg_2term_comp_driven(
        sc.implicit_2term_init_comp(sc.initial_state(
            lambda x, y: torch.zeros_like(x))), ts, g_strip)
    driven = first.u.double() + first.u_lo.double()
    timed("f32c implicit CN compensated 2term driven",
          lambda st: sc.run_implicit_mg_2term_comp_driven(st, ts, g_strip),
          first, sc.n_dofs, ni)
    say(f"      CG per step {sc.last_iterations}")
    timed("f32c implicit CN compensated 2term standing",
          lambda st: sc.run_implicit_mg_2term_comp(st, ni),
          sc.implicit_2term_init_comp(sc.initial_state(u0)), sc.n_dofs, ni)
    say(f"      CG per step {sc.last_iterations}")
    u_ref = engine_row("f64  implicit CN driven (2term mg)", torch.float64)

    def max_rel(a, ref):
        return float(torch.max(torch.abs(a - ref))
                     / torch.clamp(torch.max(torch.abs(ref)), min=1e-30))

    # at 4096^2 the correction solve's L2 stopping floor leaves a local
    # error that grows with the grid near the strip's end (report only);
    # the gate is tests/test_multigrid.py:736's own: 24^2, dt 1e-2, 20
    # steps
    d_big = max_rel(driven, u_ref)
    del driven, u_ref, first
    n24, dt24, k24 = 24, 1e-2, 20
    case24 = prec.implicit_case(n24)
    case24["Dt"] = str(dt24)
    eng = make_fast_solver(load_params(case24), "theta", solver="2term",
                           precond="mg", dtype=torch.float64, device="cuda")
    ts24 = (dt24 * (1.0 + torch.arange(k24, dtype=torch.float64))).tolist()
    out, _ = eng.run_steps(eng.initial_state(), ts24)
    ref24 = torch.as_tensor(eng.disc.vertex_values(out.u),
                            device="cuda").reshape(n24 + 1, n24 + 1).double()
    s24 = FastWaveSolver((n24, n24), UNIT_SQUARE, dt24, scheme="theta",
                         theta=0.5, lumped=False, dtype=torch.float32,
                         device="cuda")
    got = s24.run_implicit_mg_2term_comp_driven(
        s24.implicit_2term_init_comp(s24.initial_state(
            lambda x, y: torch.zeros_like(x))), ts24, g_strip)
    d = max_rel(got.u.double() + got.u_lo.double(), ref24)
    ok = d < 3e-6
    say(f"  (b) compensated driven 2-term against the f64 engine: {ni} "
        f"steps at {nel}^2 max rel diff {d_big:.3e} (reported); the gate "
        f"at {n24}^2, dt {dt24}, {k24} steps: {d:.3e} (bound 3e-6) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failed.append(f"(b) driven {d:.3e}")

    # (c) the compensated 2-term gate: standing CN from one f32 start
    s64 = FastWaveSolver((nel, nel), UNIT_SQUARE, 1e-3, scheme="theta",
                         theta=0.5, lumped=False, dtype=torch.float64,
                         device="cuda")
    pair = sc.implicit_2term_init(sc.initial_state(u0_32))
    ref = s64.run_implicit_mg_2term(LeapfrogState(
        pair.u.double(), pair.u_prev.double()), ni - 1).u
    ep = rel(sc.run_implicit_mg_2term(pair, ni - 1).u, ref)
    zero = torch.zeros_like(pair.u)
    comp = sc.run_implicit_mg_2term_comp(
        CompensatedState(pair.u, zero, pair.u_prev, zero), ni - 1,
        tol_factor=1e-3)
    ec = rel(comp.u.double() + comp.u_lo.double(), ref)
    ok = ec < ep / 8
    say(f"  (c) compensated 2-term, standing CN, {ni - 1} recurrence steps: "
        f"ep {ep:.3e}, ec {ec:.3e} ({ep / max(ec, 1e-300):.1f}x), CG per "
        f"step {sc.last_iterations} {'ok' if ok else 'FAIL'}")
    if not ok:
        failed.append(f"(c) ep {ep:.3e} ec {ec:.3e}")
    say(f"  {'ok' if not failed else 'FAIL: ' + '; '.join(failed)}")
    if failed:
        raise AssertionError("phase 31: " + "; ".join(failed))


# ---------------------------------------------------------------------------
# path M (phase 32): domain decomposition over torch.distributed
# ---------------------------------------------------------------------------
#: the scalability configuration's schemes (scripts/scalability_sweep.py)
SHARD_SCHEMES = (("theta", 0.0), ("theta", 0.5), ("theta", 1.0),
                 ("newmark", 0.0), ("newmark", 0.25))
#: steps of each sharded scalability run (640^2, dt 8e-5, f64)
SHARD_STEPS = 10
#: halo.py's B2 leg: elements (4096^2 nodes: halo.py takes only row
#: counts that divide over the ranks), steps a pass, passes
SHARD_HALO = (4095, 8, 4)
#: seconds a launch of ranks may take before it is killed
SHARD_TIMEOUT_S = 300


def _shard_solver(torch, scheme: str, val: float, sharding, nel: int = 640,
                  dt: float = 8e-5):
    from tpuwave_torch.models.fast import FastWaveSolver
    kw = dict(dtype=torch.float64, device="cuda", sharding=sharding)
    if scheme == "theta":
        return FastWaveSolver((nel, nel), UNIT_SQUARE, dt, scheme="theta",
                              theta=val, lumped=False, **kw)
    return FastWaveSolver((nel, nel), UNIT_SQUARE, dt, scheme="newmark",
                          beta=val, gamma=0.5, lumped=val == 0.0, **kw)


def shard_worker(job: str, out: Path, backend: str) -> int:
    """One rank of a path-M launch (``--shard-worker``, started by
    torch.distributed.run): joins the process group, runs the jobs of
    ``job`` (comma-separated: scal, halo), and rank 0 writes the gathered
    results and, per job, the ranks' summed kernel launches and calls of
    a kernels.py plain version to ``out`` (.npz)."""
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT))
    from tpuwave_torch.models.fast import LeapfrogState
    from tpuwave_torch.ops import _build
    from tpuwave_torch.ops import kernels as kn
    from tpuwave_torch.parallel import sharding as shd
    from tpuwave_torch.parallel.halo import make_multistep_halo_leapfrog
    _build.load_library()
    shd.init_distributed(backend=backend, device="cuda")
    n = shd.world_size()
    res = {}

    def timed(fn):
        torch.cuda.synchronize()
        torch.distributed.barrier()
        t0 = time.perf_counter()
        out_ = fn()
        torch.cuda.synchronize()
        torch.distributed.barrier()
        return out_, time.perf_counter() - t0

    u0 = _standing(torch)
    jobs = job.split(",")
    if set(jobs) - {"scal", "halo"}:
        raise ValueError(f"unknown shard job {job!r}")
    # every plain version the kernels module holds, counted: on the
    # card's tensors a wrapper launches its kernel, so none may run
    refs_run = {"n": 0}
    for name in [a for a in dir(kn) if a.endswith("_reference")]:
        def counted(*a, _orig=getattr(kn, name), **k):
            refs_run["n"] += 1
            return _orig(*a, **k)
        setattr(kn, name, counted)

    def scal():
        grids = [("rows", None)]
        if n == 4 and backend == "gloo":
            grids.append(("blocks", (2, 2)))
        for gname, shape in grids:
            sh = shd.grid_sharding(shd.device_mesh(shape=shape))
            schemes = (SHARD_SCHEMES if gname == "rows"
                       else (("newmark", 0.25),))
            for scheme, val in schemes:
                s = _shard_solver(torch, scheme, val, sh)
                st0 = s.initial_state(u0)
                s.run_scan(st0, 2)                       # warm
                st, secs = timed(lambda: s.run_scan(st0, SHARD_STEPS))
                u = s.layout.gather_all(st.u)
                key = f"{gname} {scheme} {val}"
                res[f"u {key}"] = u.cpu().numpy()
                res[f"its {key}"] = np.asarray(s.last_iterations).reshape(
                    SHARD_STEPS, -1)
                res[f"ms {key}"] = np.asarray(1e3 * secs / SHARD_STEPS)

    def halo():
        from tpuwave_torch.models.fast import FastWaveSolver
        nel, k, passes = SHARD_HALO
        fs = FastWaveSolver((nel, nel), UNIT_SQUARE, 8e-5,
                            dtype=torch.float32, device="cuda")
        mesh = shd.device_mesh()
        adv, lay = make_multistep_halo_leapfrog(mesh, fs, k)
        lf = fs.initial_leapfrog_state(u0)
        st0 = LeapfrogState(lay.local(lf.u).contiguous(),
                            lay.local(lf.u_prev).contiguous())
        del lf

        def run():
            st = st0
            for _ in range(passes):
                st = adv(st)
            return st
        run()
        st, secs = timed(run)
        res["u halo"] = lay.gather_all(st.u).cpu().numpy()
        res["ms halo"] = np.asarray(1e3 * secs / (k * passes))

    names = sorted(kn.LAUNCHES)
    for j in jobs:
        # this job's launches and plain-version calls, summed over ranks
        before, refs_before = dict(kn.LAUNCHES), refs_run["n"]
        {"scal": scal, "halo": halo}[j]()
        counts = torch.tensor(
            [float(kn.LAUNCHES[k] - before[k]) for k in names]
            + [float(refs_run["n"] - refs_before)], dtype=torch.float64,
            device="cpu" if backend == "gloo" else "cuda")
        torch.distributed.all_reduce(counts)
        counts = [int(c) for c in counts.tolist()]
        res.update({f"launches {j} {k}": np.asarray(c)
                    for k, c in zip(names, counts)})
        res[f"references {j}"] = np.asarray(counts[-1])
    if shd.world_rank() == 0:
        np.savez(out, **res)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def _launch_ranks(n: int, argv: list, log: Path, timeout: float =
                  SHARD_TIMEOUT_S) -> float:
    """``argv`` (after ``python``) on ``n`` ranks through
    torch.distributed.run --standalone; every rank ends when one fails
    (the launcher stops the others) and the call raises. Returns the
    wall time."""
    import os
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={n}", *argv]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    with log.open("w") as fh:
        try:
            rc = subprocess.run(cmd, cwd=ROOT, env=env, stdout=fh,
                                stderr=subprocess.STDOUT,
                                timeout=timeout).returncode
        except subprocess.TimeoutExpired:
            rc = 124
    wall = time.perf_counter() - t0
    if rc != 0:
        tail = log.read_text()[-3000:]
        raise AssertionError(f"{n} ranks ({' '.join(argv[:3])}) exited {rc} "
                             f"after {wall:.0f} s:\n{tail}")
    return wall


#: the kernel each shard_worker job must launch on its ranks: B3, every
#: sharded CG matvec of the scalability runs; B2, halo.py's k steps
SHARD_JOB_KERNELS = {"scal": ("constrained_stencil_apply",),
                     "halo": ("leapfrog_multistep",)}


def _shard_job(kn, n: int, job: str, backend: str, work: Path) -> dict:
    """One launch of ``n`` ranks running shard_worker's ``job``; adds the
    ranks' launches to kn.LAUNCHES and returns rank 0's arrays. Raises
    where a job's ranks launched a kernel of SHARD_JOB_KERNELS no time or
    ran a plain version."""
    import numpy as np
    tag = f"shard-{job.replace(',', '-')}-{backend}-{n}"
    out = work / f"{tag}.npz"
    wall = _launch_ranks(n, [str(ROOT / "chip_smoke.py"), "--shard-worker",
                             job, "--shard-out", str(out),
                             "--shard-backend", backend],
                         work / f"{tag}.log")
    with np.load(out) as data:
        res = {k: data[k] for k in data.files}
    bad = []
    for j in job.split(","):
        got = {k: int(res[f"launches {j} {k}"]) for k in kn.LAUNCHES}
        for k, c in got.items():
            kn.LAUNCHES[k] += c
        want = {k: got[k] for k in SHARD_JOB_KERNELS[j]}
        refs = int(res[f"references {j}"])
        say(f"  {n} {backend} ranks, job {j}: launches {want}, plain "
            f"versions run {refs}")
        bad += [f"{j} launched no {k}" for k, c in want.items() if c <= 0]
        bad += [f"{j} ran {refs} plain versions"] if refs else []
    say(f"  {n} {backend} ranks, job {job}: {wall:.1f} s wall (launch, "
        "start-up and run)")
    if bad:
        raise AssertionError(f"{n} {backend} ranks: " + "; ".join(bad))
    return res


def _shard_refs(torch):
    """One-rank runs of the scalability configuration on the card."""
    refs = {}
    u0 = _standing(torch)
    for scheme, val in SHARD_SCHEMES:
        s = _shard_solver(torch, scheme, val, None)
        st0 = s.initial_state(u0)
        s.run_scan(st0, 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = s.run_scan(st0, SHARD_STEPS)
        torch.cuda.synchronize()
        refs[f"{scheme} {val}"] = (st.u.double(),
                                   s.last_iterations,
                                   1e3 * (time.perf_counter() - t0)
                                   / SHARD_STEPS)
    return refs


def _shard_scal_gate(torch, np, refs, res, n: int, backend: str) -> list:
    failed = []
    for key in sorted(k[2:] for k in res if k.startswith("u ")):
        if key == "halo":
            continue
        grid, ref_key = key.split(" ", 1)
        u_ref, its_ref, ms_ref = refs[ref_key]
        u = torch.as_tensor(res[f"u {key}"], device="cuda")
        rel = _rel_l2(torch, u, u_ref)
        its = res[f"its {key}"].reshape(len(its_ref), -1).tolist()
        want = np.asarray(its_ref).reshape(len(its_ref), -1).tolist()
        ok = rel <= 1e-12 and its == want
        say(f"  {backend} {n} ranks {grid:<6} {ref_key:<13} rel L2 "
            f"{rel:.3e} (bound 1e-12), CG {np.sum(its)} vs {np.sum(want)} "
            f"one-rank, {float(res[f'ms {key}']):.3f} ms/step vs "
            f"{ms_ref:.3f} one-rank {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"{backend} {n} {key}: rel {rel:.3e}, CG "
                          f"{np.sum(its)} vs {np.sum(want)}")
    return failed


def _shard_setup(torch, kn, work: Path) -> dict:
    """What path M is held to, made before its counted run: B3 at global
    offsets on a rank's padded block (the second of four row slabs of
    641^2, one-node halo) against its plain version; the one-rank runs of
    the scalability configuration; one-rank B2 over halo.py's steps; the
    one-rank CLI run."""
    say(f"phase 32: sharding ({time.perf_counter() - T_START:.0f} s since "
        "the start); one-rank references")
    fs = _shard_solver(torch, "newmark", 0.25, None)
    st = fs.system.stencil
    g = torch.Generator(device="cuda").manual_seed(5)
    for dtype in (torch.float64, torch.float32):
        x = torch.rand((163, 643), generator=g, device="cuda",
                       dtype=torch.float64).to(dtype)
        kw = dict(row_offset=159, col_offset=-1, n_rows=641, n_cols=641)
        got = kn.constrained_stencil_apply(x, st, st[1][1], **kw)
        want = kn.constrained_stencil_apply_reference(x, st, st[1][1], **kw)
        torch.cuda.synchronize()
        bound = (1e-12 * float(want.abs().max())
                 if dtype == torch.float64
                 else f32_bound(sum(abs(c) for r in st for c in r)))
        check(f"B3 at offsets (159, -1) of 641^2 {str(dtype)[6:]}",
              got[1:-1, 1:-1], want[1:-1, 1:-1], bound)
    del fs

    from tpuwave_torch.models.fast import FastWaveSolver
    nel, k, passes = SHARD_HALO
    fs = FastWaveSolver((nel, nel), UNIT_SQUARE, 8e-5, dtype=torch.float32,
                        device="cuda")
    lf = fs.initial_leapfrog_state(_standing(torch))
    stencil, coef = fs._kernel_args()
    u, up = lf.u.contiguous(), lf.u_prev.contiguous()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(passes):
        u, up = kn.leapfrog_multistep(u, up, stencil, coef, k)
    torch.cuda.synchronize()
    halo_ms = 1e3 * (time.perf_counter() - t0) / (k * passes)
    halo_bound = f32_bound(
        3.0 + coef * sum(abs(c) for r in stencil for c in r), k * passes)
    del fs, lf, up

    case = _case(work, **{"T": "0.0004", "Beta": "0.25",
                          "Log Every": "1"})
    one = work / "shard-one"
    _cli("newmark", case, one, "cuda", flags=("--precond", "mg"))
    return dict(refs=_shard_refs(torch), halo_u=u, halo_ms=halo_ms,
                halo_bound=halo_bound, case=case, one=one)


def phase_shard(torch, kn, work: Path, pre: dict = None):
    """Phase 32 (path M): the sharded port over torch.distributed.

    (a) 2 and 4 gloo ranks sharing the one card (asked for explicitly:
    NCCL refuses two ranks on one card): the scalability configuration
    (standing mode, 640^2, dt 8e-5, f64, SHARD_STEPS steps) for theta 0,
    1/2, 1 and Newmark 0, 1/4 over row slabs, and Newmark 1/4 over 2 x 2
    blocks, each held to the one-rank run (rel L2 <= 1e-12, equal CG
    counts); the Newmark CLI --shard rows --precond mg over 2 ranks, its
    CSVs byte-equal to the one-rank run's; halo.py's B2 k-step at 4096^2
    f32, k = 8, over 2 ranks against one-rank B2 (max abs err).
    (b) with two cards or more, the scalability runs over NCCL at world
    min(cards, 4), ms/step per rank count. ``pre``: _shard_setup's
    references (made here where not given). Only the ranks launch
    kernels after it, and each rank job must launch its kernels
    (SHARD_JOB_KERNELS) and run no plain version."""
    import numpy as np
    if not pre:
        pre = _shard_setup(torch, kn, work)
    say(f"phase 32: the ranks ({time.perf_counter() - T_START:.0f} s since "
        "the start)")
    failed = []
    refs = pre["refs"]

    # (a) gloo ranks on the one card
    halo = None
    for n in (2, 4):
        res = _shard_job(kn, n, "scal,halo" if n == 2 else "scal", "gloo",
                         work)
        failed += _shard_scal_gate(torch, np, refs, res, n, "gloo")
        halo = res if n == 2 else halo
    res = halo

    nel, k, passes = SHARD_HALO
    got = torch.as_tensor(res["u halo"], device="cuda")
    err = float((got - pre["halo_u"]).abs().max())
    bound = pre["halo_bound"]
    ok = err <= bound
    say(f"  halo.py B2 k={k} {nel + 1}^2 nodes f32 over 2 gloo ranks, "
        f"{k * passes} "
        f"steps: max abs err {err:.3e} against one-rank B2 (bound "
        f"{bound:.3e}), {float(res['ms halo']):.3f} ms/step vs "
        f"{pre['halo_ms']:.3f} one-rank {'ok' if ok else 'FAIL'}")
    if not ok:
        failed.append(f"halo {err:.3e}")
    del got

    # the CLI: newmark --shard rows --precond mg over 2 gloo ranks
    one, two = pre["one"], work / "shard-two"
    wall = _launch_ranks(2, ["-m", "tpuwave_torch.cli.newmark",
                             str(pre["case"]), "--device", "cuda",
                             "--results-root", str(two / "res"),
                             "--mesh-root", str(two / "mesh"), "--precond",
                             "mg", "--shard", "rows", "--dist-backend",
                             "gloo"],
                         work / "shard-cli.log")
    same = []
    for name in ("probe.csv", "energy.csv", "iterations.csv", "error.csv"):
        a = next((one / "res").rglob(name)).read_bytes()
        b = next((two / "res").rglob(name)).read_bytes()
        same.append(a == b)
        if a != b:
            failed.append(f"CLI {name} differs")
    say(f"  newmark --shard rows --precond mg, 2 gloo ranks, 5 steps at "
        f"640^2: CSVs byte-equal to one rank: {all(same)} ({wall:.1f} s "
        "wall)")

    failed += _shard_nccl(torch, np, kn, work, refs)
    if failed:
        raise AssertionError("phase 32: " + "; ".join(failed))
    say("  ok")


def _shard_nccl(torch, np, kn, work: Path, refs) -> list:
    """Phase 32 (b): the scalability runs over NCCL, one card a rank, at
    world 2 and min(cards, 4); skipped on one card."""
    cards = torch.cuda.device_count()
    if cards < 2:
        say(f"  (b) NCCL: skipped, {cards} card (needs 2 or more)")
        return []
    failed = []
    for n in sorted({2, min(cards, 4)}):
        res = _shard_job(kn, n, "scal", "nccl", work)
        failed += _shard_scal_gate(torch, np, refs, res, n, "nccl")
    return failed


def phase_shard_nccl(torch, kn, work: Path):
    """Phase 32 (b) alone, with the one-rank runs it is held to (for a
    multi-card machine: ``--only shard_nccl``)."""
    import numpy as np
    failed = _shard_nccl(torch, np, kn, work, _shard_refs(torch))
    if failed:
        raise AssertionError("phase 32 (b): " + "; ".join(failed))
    say("  ok")


#: the main paths' launches of B4, B9 and B11-B16 per shape (B14 also per
#: form; see _count_shapes; counted only while _run_path drives a path)
SHAPE_LAUNCHES = {}
_COUNTING = {"on": False}


def _count_shapes(kn):
    """Wrap the B4, B9, B11-B16 wrappers in the modules their callers
    reach them through, so that each call's launches (the change of the
    wrapper's own count in LAUNCHES) are added to SHAPE_LAUNCHES under the
    call's shape (and B14's form)."""
    from tpuwave_torch.ops import kernels_p2 as kp
    from tpuwave_torch.ops import kernels_varcoef as kv

    def wrap(mod, name, key):
        orig = getattr(mod, name)

        def counted(*args, **kwargs):
            before = kn.LAUNCHES[name]
            out = orig(*args, **kwargs)
            if _COUNTING["on"]:
                k = (name, key(*args))
                SHAPE_LAUNCHES[k] = (SHAPE_LAUNCHES.get(k, 0)
                                     + kn.LAUNCHES[name] - before)
            return out
        setattr(mod, name, counted)

    def grid(t):
        return f"{t.shape[0]}^2 {str(t.dtype)[6:]}" if t.shape[0] == \
            t.shape[1] else f"{t.shape[0]}x{t.shape[1]} {str(t.dtype)[6:]}"
    wrap(kn, "cheby_block", lambda x, r, st, th, cf:
         f"{grid(r)} degree {1 + len(cf)}{' zero guess' if x is None else ''}")
    wrap(kn, "theta_r0u", lambda u, *rest: grid(u))
    wrap(kv, "varcoef_leapfrog_step", lambda u, up, pl, coef, damp=None:
         f"{grid(u)} {'undamped' if damp is None else 'damped'}")
    wrap(kv, "varcoef_leapfrog_multistep", lambda u, up, pl, w, *rest:
         f"{grid(u)} k={w.numel()} {pl.shape[0]} planes")
    wrap(kv, "varcoef_adjoint_step", lambda un, *rest: grid(un))
    # the P2 engines and solve/multigrid.py call B11-B13 through the
    # kernels_p2 module
    wrap(kp, "p2_constrained_apply", lambda xc, *rest: f"4 x {grid(xc[0])}")
    wrap(kp, "p2_presmooth", lambda b, co, inv, th, sm, nx, ny:
         f"4 x {grid(b[0])} degree {1 + len(sm)}")
    wrap(kp, "p2_postsmooth", lambda x, r, c, co, inv, th, sm, nx, ny:
         f"4 x {grid(x[0])} degree {1 + len(sm)}")


def _run_path(kn, name, kernels, fn) -> dict:
    """Drive one main path with the launch counts at 0; every kernel of
    the path must have launched."""
    kn.reset_launches()
    _COUNTING["on"] = True
    try:
        fn()
    finally:
        _COUNTING["on"] = False
    launches = {k: kn.LAUNCHES[k] for k in kernels}
    say(f"path {name} launches: {launches} "
        f"({time.perf_counter() - T_START:.0f} s since the start)")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} was not launched by path "
                                 f"{name}")
    return launches


def _run_only(torch, dev, kn, names: str, foreign: bool) -> int:
    """Run the named phase functions (``phase_<name>``) alone, in order;
    ``foreign``: tpuwave_torch comes from another checkout
    (--kernels-from)."""
    import inspect
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        avail = dict(torch=torch, dev=dev, kn=kn, work=Path(tmp),
                     foreign=foreign)
        for name in names.split(","):
            fn = globals()[f"phase_{name.strip()}"]
            fn(**{k: avail[k] for k in inspect.signature(fn).parameters
                  if k in avail})
    say(f"done ({time.perf_counter() - T_START:.0f} s)")
    return 0


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", metavar="NAMES",
                    help="comma-separated phase functions without their "
                    "phase_ prefix (e.g. kernels,fwi_kernels,fwi_1024): "
                    "run phases 1 and 2 and these, then stop; no kernels "
                    "line and no result line")
    ap.add_argument("--kernels-from", metavar="DIR", type=Path,
                    help="import tpuwave_torch (and build its kernels) from "
                    "this checkout instead of the script's own, e.g. an "
                    "unpacked earlier commit, to time its kernels with this "
                    "script's phases (with --only)")
    ap.add_argument("--shard-worker", metavar="JOB",
                    help=argparse.SUPPRESS)
    ap.add_argument("--shard-out", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--shard-backend", default="gloo",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.shard_worker:
        return shard_worker(args.shard_worker, args.shard_out,
                            args.shard_backend)
    if args.kernels_from is not None and not args.only:
        ap.error("--kernels-from needs --only")
    import torch

    # phase 1
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke "
                           "test runs only on a CUDA device")
    smi = nvidia_smi_line()
    say(f"phase 1: {smi}")
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    say(f"  torch {torch.__version__} cuda {torch.version.cuda} on {kind}, "
        f"{torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2
    sys.path.insert(0, str((args.kernels_from or ROOT).resolve()))
    from tpuwave_torch.ops import _build
    from tpuwave_torch.ops import kernels as kn
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    lib_path, nvcc_s, log = _build.build_library()
    _build.load_library()
    say(f"phase 2: built {lib_path.name} in {time.perf_counter() - t0:.2f} s"
        f" (nvcc {nvcc_s:.2f} s)")
    for ln in ptxas_report(log):
        say(f"  {ln}")

    say(f"  tpuwave_torch from {Path(_build.__file__).parents[2]}")
    if args.only:
        return _run_only(torch, dev, kn, args.only,
                         args.kernels_from is not None)

    results = phase_kernels(torch, dev, kn)
    results.update(phase_fast_kernels(torch, dev, kn))
    results.update(phase_p2_kernels(torch, dev, kn))
    results.update(phase_fwi_kernels(torch, dev, kn))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        work = Path(tmp)

        phase6 = {}

        def path_a():
            phase_leapfrog(torch, dev)
            phase6["its"] = phase_cli(torch, kn, work)

        def path_b():
            phase_solvers(torch, kn, work)
            phase_2term_2048(torch, kn, work)

        def path_c():
            phase_p2_cli(torch, kn, work)
            phase_p2_1024(torch, kn, work)
            phase_p2_4096(torch, kn, work)

        def path_d():
            phase_fast_agree(torch)
            phase_fast_4096(torch)
            phase_fast_1024(torch)

        def path_e():
            phase_fwi_agree(torch)
            phase_fwi_1024(torch, dev)

        def path_f():
            phase_driven_4096(torch, kn)
            phase_driven_1024(torch)
            phase_cli_varcoef(torch, kn, work)

        def path_g():
            phase_p2_cli_varcoef(torch, kn, work)
            phase_p2_varcoef_1024(torch, kn, work)

        def path_h():
            phase_parity_cli(torch, kn, work)
            phase_parity_640(torch, kn, work, phase6["its"])

        def path_i():
            phase_unstructured_cli(torch, kn, work)
            phase_unstructured_640(torch, kn, work)

        def path_j():
            phase_run_surface(torch, kn, work)
            phase_sweeps(torch, kn, work)

        def path_k():
            phase_imaging(torch)
            phase_fwi_optim(torch)

        def path_l():
            phase_p2_bench(torch)
            phase_precision(torch)

        pre_m = {}

        def path_m():
            phase_shard(torch, kn, work, pre_m)

        _count_shapes(kn)
        launches_a = _run_path(kn, "A", PATH_A, path_a)
        launches_b = _run_path(kn, "B", PATH_B, path_b)
        phase_profile(torch, kn, work)
        launches_c = _run_path(kn, "C", PATH_C, path_c)
        phase_p2_profile(torch, kn, work)
        launches_d = _run_path(kn, "D", PATH_D, path_d)
        launches_e = _run_path(kn, "E", PATH_E, path_e)
        launches_f = _run_path(kn, "F", PATH_F, path_f)
        launches_g = _run_path(kn, "G", PATH_G, path_g)
        phase_p2_varcoef_profile(torch, kn, work)
        launches_h = _run_path(kn, "H", PATH_H, path_h)
        phase_parity_profile(torch, kn, work)
        launches_i = _run_path(kn, "I", PATH_I, path_i)
        phase_unstructured_profile(torch, kn, work)
        launches_j = _run_path(kn, "J", PATH_J, path_j)
        launches_k = _run_path(kn, "K", PATH_K, path_k)
        launches_l = _run_path(kn, "L", PATH_L, path_l)
        # path M is held to one-rank runs made before its counts start
        pre_m.update(_shard_setup(torch, kn, work))
        launches_m = _run_path(kn, "M", PATH_M, path_m)

    say("launches per shape, all paths:")
    for (name, shape), n in sorted(SHAPE_LAUNCHES.items()):
        say(f"  {name} {shape}: {n}")
    kernels = []
    for name in SOURCES:
        r = results[name]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name],
            launches=sum(ln.get(name, 0) for ln in (
                launches_a, launches_b, launches_c, launches_d, launches_e,
                launches_f, launches_g, launches_h, launches_i,
                launches_j, launches_k, launches_l, launches_m)),
            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            # no single PyTorch call computes any of these (F.conv2d
            # gives only the unmasked constant stencil term; the FWI
            # stencil's coefficients vary by node)
            library_ms=None))
    say(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
