"""Checkpoint / resume for long runs and FWI inversions.

tpuwave's snapshot layer (tpuwave/utils/checkpoint.py), with its file
schema, so that a file written by either package is read by the other:
the stepper state's fields, the timestep number and the accumulated time
are written as ``checkpoint_NNNNNN.npz`` in the run folder every
``checkpoint_every`` steps (``__timestep``, ``__time``, one array per
state field, None fields skipped), through an atomic ``.tmp.npz`` replace,
keeping the newest ``keep`` files; ``load_latest`` returns the newest one
so that models/runner.py can continue mid-run (CSV logs are then opened in
append mode, after ``truncate_logs_after``). Tensors are written from the
host (``.cpu().numpy()``); a host-int field (the 2-term engines' step counter
``n``) is written as a 0-d array. Restoring fields onto a state of the
port is ``models/convert.py::like_state``.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_latest", "checkpoint_path",
           "truncate_logs_after", "save_inversion", "load_inversion"]

_CKPT_RE = re.compile(r"checkpoint_(\d{6})\.npz$")


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def checkpoint_path(folder, timestep: int) -> Path:
    return Path(folder) / f"checkpoint_{timestep:06d}.npz"


def _checkpoints(folder: Path) -> list:
    return sorted(p for p in folder.glob("checkpoint_*.npz")
                  if _CKPT_RE.search(p.name))


def save_checkpoint(folder, timestep: int, time: float, state, *,
                    keep: int = 2) -> Path:
    """Write the state tuple/NamedTuple; prune all but the newest ``keep``."""
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    fields = state._asdict() if hasattr(state, "_asdict") else {
        f"arr{i}": a for i, a in enumerate(state)}
    # None fields (optional state slots, e.g. ThetaState.k_payload when
    # Time Dependent C is off) are skipped; a restore leaves them at the
    # NamedTuple default
    arrays = {k: _host(v) for k, v in fields.items() if v is not None}
    path = checkpoint_path(folder, timestep)
    tmp = path.with_suffix(".tmp.npz")
    np.savez(tmp, __timestep=timestep, __time=time, **arrays)
    tmp.replace(path)

    for old in _checkpoints(folder)[:-keep]:
        old.unlink()
    return path


def truncate_logs_after(folder, timestep: int) -> None:
    """Drop CSV rows recorded after ``timestep`` from the per-run logs.

    A crash between the last checkpoint and the last logged row would
    otherwise leave rows that a resumed run re-appends (duplicate
    timesteps). Called by the runner before reopening logs in append mode.
    """
    folder = Path(folder)
    for name in ("energy.csv", "error.csv", "probe.csv", "iterations.csv"):
        path = folder / name
        if not path.exists():
            continue
        lines = path.read_text().splitlines()
        if not lines:
            continue
        kept = [lines[0]]
        for line in lines[1:]:
            try:
                step = int(line.split(",", 1)[0])
            except ValueError:
                continue
            if step <= timestep:
                kept.append(line)
        path.write_text("\n".join(kept) + "\n")


def save_inversion(path, n_done: int, misfits, params_leaves,
                   opt_leaves) -> Path:
    """Atomic snapshot of an FWI inversion loop (models/inverse.py::
    FwiProblem.invert): completed-iteration count, misfit history and
    the flattened (params, optimizer-state) leaves, in the order of
    tpuwave's pytree leaves. One file, overwritten in place."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {"__n_done": n_done,
              "__misfits": np.asarray(misfits, np.float64)}
    for i, leaf in enumerate(params_leaves):
        arrays[f"p{i}"] = _host(leaf)
    for i, leaf in enumerate(opt_leaves):
        arrays[f"o{i}"] = _host(leaf)
    tmp = path.with_suffix(".tmp.npz")
    np.savez(tmp, **arrays)
    tmp.replace(path)
    return path


def load_inversion(path):
    """(n_done, misfits, params_leaves, opt_leaves) or None if absent."""
    path = Path(path)
    if not path.exists():
        return None
    with np.load(path) as data:
        n_done = int(data["__n_done"])
        misfits = np.asarray(data["__misfits"])

        def leaves(prefix):
            keys = sorted((k for k in data.files if k.startswith(prefix)
                           and k[len(prefix):].isdigit()),
                          key=lambda k: int(k[len(prefix):]))
            return [data[k] for k in keys]

        return n_done, misfits, leaves("p"), leaves("o")


def load_latest(folder) -> Optional[Tuple[int, float, dict]]:
    """Return (timestep, time, {field: array}) of the newest checkpoint."""
    folder = Path(folder)
    if not folder.exists():
        return None
    ckpts = _checkpoints(folder)
    if not ckpts:
        return None
    with np.load(ckpts[-1]) as data:
        timestep = int(data["__timestep"])
        time = float(data["__time"])
        fields = {k: data[k] for k in data.files
                  if not k.startswith("__")}
    return timestep, time, fields
