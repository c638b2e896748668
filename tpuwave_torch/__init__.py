"""tpuwave_torch — the PyTorch / CUDA port of tpuwave.

Same problem class as tpuwave (the 2D scalar wave equation with P1 and
P2 elements on a structured triangulated rectangle), same module layout
and public names, on PyTorch tensors, with the hot stencil passes as CUDA
C++ kernels for Hopper (``ops/kernels.py``, ``ops/kernels_p2.py``,
``ops/kernels_varcoef.py``, ``csrc/*.cu``).

The port covers the structured wave step and its implicit solvers at
R = 1 and R = 2 (constant wave speed), and the differentiable FWI
propagator (variable wave speed, time-reversal adjoint):

- ``utils``   expressions, parameter files, CSV/VTU output, naming,
              checkpoints, profiler traces
- ``core``    structured mesh, P1/P2 shape functions, quadrature
- ``ops``     element classes, constant 3x3 stencils, the
              variable-coefficient planes, the P2 plane block-stencils,
              the CUDA kernels
- ``solve``   preconditioned CG (ReductionControl semantics), Chebyshev
              iteration and preconditioning, geometric and (p+h)
              multigrid
- ``models``  FastWaveSolver (explicit leapfrog), the fast Newmark/theta
              engines (3-term and 2-term; P1 grids and P2 canvases),
              O(grid) diagnostics, the run driver and FwiProblem
              (simulate, misfit_and_grad, invert)
- ``cli``     ``python -m tpuwave_torch.cli.newmark|theta <preset>``
- ``harness`` the sweep scripts' run_case (scripts/torch_*_sweep.py)

The package imports neither ``jax`` nor ``tpuwave``.
"""

__version__ = "0.1.0"
