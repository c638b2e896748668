"""Profiling / tracing hooks.

The reference's tracing is a wall-clock timer around the loop plus a
commented-out Teuchos StackedTimer (WaveNewmark.cpp:404-423).
``trace(dir)`` is the port's counterpart of tpuwave's ``jax.profiler``
trace: ``torch.profiler`` over the host and, on the card, the device
(CUPTI), written as a Chrome trace (``trace.json``, viewable in Perfetto
or chrome://tracing). :class:`PhaseTimer` gives host-side per-phase
wall-clock accumulation for the coarse step/diagnostics/output breakdown.
A phase that ends in a host read of a device value (the runner's per-step
norms) includes the device time it waited for.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator, Optional

import torch

__all__ = ["trace", "PhaseTimer"]


@contextlib.contextmanager
def trace(trace_dir: Optional[str]) -> Iterator[None]:
    """torch.profiler trace (CPU, and CUDA where a card is present) when a
    directory is given, exported to ``<trace_dir>/trace.json`` on exit;
    a no-op otherwise."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))


class PhaseTimer:
    """Accumulates wall-clock per phase (host-side, blocking)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = ["Phase breakdown (host wall-clock):"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            tot, n = self.totals[name], self.counts[name]
            lines.append(f"  {name:<12} {tot:9.3f}s total, {n:7d} calls, "
                         f"{tot / max(n, 1) * 1e3:9.3f} ms/call")
        return "\n".join(lines)
