#!/usr/bin/env python3
"""Where the time of kernel B17 (varcoef_adjoint_multistep, the FWI adjoint's
k fused backward steps) goes, block by block, on the card.

Builds tpuwave_torch's kernels with -DTW_B17_STAMPS (a library of its own
in the git-ignored tpuwave_torch/_build/, keyed by the flags), with which
every block of B17 records the card's %globaltimer at its start, after
its slabs are staged, after its steps and at its end. It then runs B17 on
chip_smoke.py's phase-17 shape (1025^2 f32, the disk model's planes) and
on its 513^2 f64 shape, at k = 1 and k = 8, and prints the kernel's
median time (chip_smoke.cuda_ms) and, over the blocks, the median time of
each phase. Needs one CUDA card and nvcc:

    python3 scripts/torch_b17_phases.py
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    import numpy as np
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as cs
    from tpuwave_torch.models.inverse import FwiProblem
    from tpuwave_torch.ops import _build
    from tpuwave_torch.ops import kernels_varcoef as kv

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    _build.COMPILE_FLAGS = (*_build.COMPILE_FLAGS, "-DTW_B17_STAMPS")
    lib = _build.load_library()
    lib.tw_b17_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    print(cs.nvidia_smi_line())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    for nel, dt, dtype in ((1024, 2e-4, torch.float32),
                           (512, 4e-4, torch.float64)):
        prob = FwiProblem((nel, nel), cs.UNIT_SQUARE, dt, 8,
                          source=cs.FWI_SOURCE, receivers=cs.FWI_RECEIVERS,
                          dtype=dtype, device=dev)
        planes = prob._stacked_planes(torch.tensor(
            cs._fwi_disk(np, prob), dtype=dtype, device=dev))
        coef = prob.dt ** 2 / prob._det_j
        shape = prob._grid

        def rnd(*s):
            return (2 * torch.rand(s, generator=gen, device=dev,
                                   dtype=torch.float64) - 1).to(dtype)

        un, uc, lam, lp = (rnd(*shape) for _ in range(4))
        wbar = rnd(7, *shape)
        rec = prob._receivers
        for k in (1, 8):
            w, inj = rnd(k), rnd(k, rec.rows.numel())
            tile = kv.adjoint_tile(k, 7, dtype, 232448)

            def call():
                kv.varcoef_adjoint_multistep(un, uc, lam, lp, planes, wbar, w,
                                             inj, (shape[0] // 3,
                                                   shape[1] // 3), coef,
                                             (rec.rows, rec.cols))
            ms = cs.cuda_ms(call, 20)
            flush = torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8,
                                device=dev)
            flush.fill_(0)
            call()
            torch.cuda.synchronize()
            n_blocks = -(-shape[0] // tile) * -(-shape[1] // tile)
            raw = np.zeros((16384, 4), dtype=np.uint64)
            if lib.tw_b17_stamps(ctypes.c_void_p(raw.ctypes.data),
                                 16384) != 0:
                raise RuntimeError("cannot read the stamps")
            st = raw[:min(n_blocks, 16384)].astype(np.float64) / 1e3
            phase = np.diff(st, axis=1)
            print(f"{shape[0]}^2 {str(dtype)[6:]} k={k}: tile {tile}, "
                  f"{n_blocks} blocks, kernel {ms * 1e3:.1f} us (median of "
                  f"20); per block, median over the blocks: staging "
                  f"{np.median(phase[:, 0]):.2f} us, {k} steps "
                  f"{np.median(phase[:, 1]):.2f} us, wbar stores "
                  f"{np.median(phase[:, 2]):.2f} us; blocks span "
                  f"{st[:, 3].max() - st[:, 0].min():.1f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
