"""Carry solver state across from tpuwave and back.

tpuwave's state types are NamedTuples of arrays (``FastState``,
``LeapfrogState``, ``FastGridState``, ``Fast2TermState``). ``to_torch``
turns one (or any NamedTuple / sequence of array-likes, e.g. its fields as
numpy arrays) into the port's counterpart with tensors on a given device
and dtype; ``to_numpy`` goes back to numpy. The 2-term step counter ``n``
is a device scalar in tpuwave and a Python int in the port. Nothing here
imports jax: anything with ``__array__`` converts.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tpuwave_torch.models.fast import FastState, LeapfrogState

__all__ = ["to_torch", "to_numpy"]


#: fields that are host ints in the port
_INT_FIELDS = ("n",)


def _target(name: str):
    if name == "FastGridState":
        from tpuwave_torch.models.fast_engine import FastGridState
        return FastGridState
    if name == "Fast2TermState":
        from tpuwave_torch.models.fast_engine_2term import Fast2TermState
        return Fast2TermState
    return {"FastState": FastState, "LeapfrogState": LeapfrogState}.get(name)


def _field(name, v, device, dtype):
    if v is None:
        return None
    if name in _INT_FIELDS:
        return int(np.asarray(v))
    return torch.tensor(np.asarray(v), dtype=dtype, device=device)


def to_torch(state, device, dtype: torch.dtype, kind: Optional[str] = None):
    """tpuwave state (or its fields) -> the port's state type.

    ``kind`` names the target type ('FastState', 'LeapfrogState',
    'FastGridState', 'Fast2TermState'); by default the source's own type
    name. Fields that are None stay None.
    """
    kind = kind or type(state).__name__
    cls = _target(kind)
    if cls is None:
        raise TypeError(f"no tpuwave_torch counterpart for {kind!r}")
    fields = (state._asdict() if hasattr(state, "_asdict")
              else dict(zip(cls._fields, state)))
    return cls(**{k: _field(k, v, device, dtype)
                  for k, v in fields.items() if k in cls._fields})


def to_numpy(state) -> dict:
    """The port's state -> {field: numpy array (host ints and None as
    they are)}."""
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else v for k, v in state._asdict().items()}
