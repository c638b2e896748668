"""Global numeric configuration of the PyTorch port.

The reference solver (deal.II) is double precision throughout, so f64 is
the parity default, as in tpuwave. Every tensor the port builds carries an
explicit ``dtype`` and ``device``; nothing here changes torch's global
default dtype.
"""

from __future__ import annotations

import os

import torch

__all__ = ["DEFAULT_DTYPE", "default_float", "env_flag_enabled",
           "resolve_device"]

#: the parity dtype (reference deal.II runs are f64)
DEFAULT_DTYPE = torch.float64


def default_float(f32: bool = False) -> torch.dtype:
    """f32 when asked for (the CLI's ``--f32``), else the f64 parity dtype."""
    return torch.float32 if f32 else DEFAULT_DTYPE


def resolve_device(name) -> torch.device:
    """``torch.device("cuda")`` or ``torch.device("cpu")``, exactly as asked.

    Raises when CUDA is asked for and no CUDA device is available: the port
    never moves a run to the CPU on its own.
    """
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass --device cpu to run on the CPU")
        return torch.device("cuda")
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (cuda | cpu)")
    return torch.device("cpu")


def env_flag_enabled(name: str, default_value: bool) -> bool:
    """Read a boolean env flag with the reference's exact semantics.

    Mirrors the anonymous helper in the reference base class
    (src/WaveEquationBase.cpp:22-33): only the literal strings
    "0"/"false"/"FALSE"/"False" and "1"/"true"/"TRUE"/"True" are
    recognised; anything else returns the default.
    """
    v = os.environ.get(name)
    if v is None:
        return default_value
    if v in ("0", "false", "FALSE", "False"):
        return False
    if v in ("1", "true", "TRUE", "True"):
        return True
    return default_value
