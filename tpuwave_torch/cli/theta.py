"""``python -m tpuwave_torch.cli.theta`` — the main-theta equivalent of the
port (reference src/main-theta.cpp, tpuwave/cli/theta.py)."""

from __future__ import annotations

import sys

from tpuwave_torch.cli._common import run_main


def main(argv=None) -> int:
    return run_main("theta", argv)


if __name__ == "__main__":
    sys.exit(main())
