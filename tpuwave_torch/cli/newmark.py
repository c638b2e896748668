"""``python -m tpuwave_torch.cli.newmark`` — the main-newmark equivalent of the
port (reference src/main-newmark.cpp, tpuwave/cli/newmark.py)."""

from __future__ import annotations

import sys

from tpuwave_torch.cli._common import run_main


def main(argv=None) -> int:
    return run_main("newmark", argv)


if __name__ == "__main__":
    sys.exit(main())
