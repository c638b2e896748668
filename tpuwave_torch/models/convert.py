"""Carry solver state across from tpuwave and back.

tpuwave's state types are NamedTuples of arrays (``FastState``,
``LeapfrogState``, ``FastGridState``). ``to_torch`` turns one (or any
NamedTuple / sequence of array-likes, e.g. its fields as numpy arrays) into
the port's counterpart with tensors on a given device and dtype;
``to_numpy`` goes back to numpy. Nothing here imports jax: anything with
``__array__`` converts.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tpuwave_torch.models.fast import FastState, LeapfrogState

__all__ = ["to_torch", "to_numpy"]


def _target(name: str):
    if name == "FastGridState":
        from tpuwave_torch.models.fast_engine import FastGridState
        return FastGridState
    return {"FastState": FastState, "LeapfrogState": LeapfrogState}.get(name)


def to_torch(state, device, dtype: torch.dtype, kind: Optional[str] = None):
    """tpuwave state (or its fields) -> the port's state type.

    ``kind`` names the target type ('FastState', 'LeapfrogState',
    'FastGridState'); by default the source's own type name. Fields that
    are None stay None.
    """
    kind = kind or type(state).__name__
    cls = _target(kind)
    if cls is None:
        raise TypeError(f"no tpuwave_torch counterpart for {kind!r}")
    fields = (state._asdict() if hasattr(state, "_asdict")
              else dict(zip(cls._fields, state)))
    return cls(**{k: None if v is None else
                  torch.tensor(np.asarray(v), dtype=dtype, device=device)
                  for k, v in fields.items() if k in cls._fields})


def to_numpy(state) -> dict:
    """The port's state -> {field: numpy array (or None)}."""
    return {k: None if v is None else v.detach().cpu().numpy()
            for k, v in state._asdict().items()}
