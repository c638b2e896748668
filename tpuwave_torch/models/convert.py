"""Carry solver state across from tpuwave and back.

tpuwave's state types are NamedTuples of arrays (``FastState``,
``LeapfrogState``, ``FastGridState``, ``Fast2TermState``,
``P22TermState``). ``to_torch`` turns one (or any NamedTuple / sequence of
array-likes, e.g. its fields as numpy arrays) into the port's counterpart
with tensors on a given device and dtype; ``to_numpy`` goes back to numpy.
The 2-term step counter ``n`` is a device scalar in tpuwave and a Python
int in the port. Nothing here imports jax: anything with ``__array__``
converts.

At R = 2 the states hold (4, Hc, Wc) canvas stacks. tpuwave pads the rows
and columns of its Pallas route's canvases (block-row and lane multiples);
the port's canvas is the true (ny+3, nx+3). Pass ``canvas=(Hc, Wc)`` (the
port engine's ``_cshape``) and every canvas field is cropped or
zero-padded to it: the padding lies outside every plane's support.

FWI data (``fwi_to_torch``): the per-cell c^2 and the wavelet are the same
vectors in both packages (same cell order); tpuwave's Pallas route holds
grids on a padded (H, W) layout, plane stacks as (n, H, W), ring rows as
(..., 2, W) and ring columns as (..., H, 2) or (..., H, 128) lanes, all
cropped here to the true (ny+1, nx+1) grid.

An FWI problem's construction (``fwi_problem_kwargs``): tpuwave's keyword
arguments of ``FwiProblem`` become the port's, with tpuwave's defaults
made explicit (engine "scatter", adjoint "remat", where the port's are
"kernel" and "reversal"): engine "pallas" is "kernel",
``pallas_steps_per_call`` is ``steps_per_call``, the Pallas block rows
and interpret flag have no counterpart, a jax / numpy dtype becomes the
torch dtype of its name; ``remat``, ``adjoint``, ``boundary_save`` and
the rest carry over. An L-BFGS checkpoint's optimizer leaves
(``lbfgs_leaf_names``) are optax's ``tree_leaves`` of its ``lbfgs()``
state in both packages.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tpuwave_torch.models.fast import FastState, LeapfrogState

__all__ = ["to_torch", "to_numpy", "like_state", "fwi_to_torch",
           "fwi_problem_kwargs", "lbfgs_leaf_names"]


#: fields that are host ints in the port
_INT_FIELDS = ("n",)


def _target(name: str):
    if name == "FastGridState":
        from tpuwave_torch.models.fast_engine import FastGridState
        return FastGridState
    if name == "Fast2TermState":
        from tpuwave_torch.models.fast_engine_2term import Fast2TermState
        return Fast2TermState
    if name == "P22TermState":
        from tpuwave_torch.models.fast_engine_p2_2term import P22TermState
        return P22TermState
    return {"FastState": FastState, "LeapfrogState": LeapfrogState}.get(name)


def _field(name, v, device, dtype, canvas):
    if v is None:
        return None
    if name in _INT_FIELDS:
        return int(np.asarray(v))
    a = np.asarray(v)
    if canvas is not None and a.ndim == 3 and a.shape[0] == 4:
        out = np.zeros((4, *canvas), dtype=a.dtype)
        h, w = min(a.shape[1], canvas[0]), min(a.shape[2], canvas[1])
        out[:, :h, :w] = a[:, :h, :w]
        a = out
    return torch.tensor(a, dtype=dtype, device=device)


def to_torch(state, device, dtype: torch.dtype, kind: Optional[str] = None,
             canvas: Optional[Tuple[int, int]] = None):
    """tpuwave state (or its fields, or a ``to_numpy`` dict) -> the port's
    state type.

    ``kind`` names the target type ('FastState', 'LeapfrogState',
    'FastGridState', 'Fast2TermState', 'P22TermState'); by default the
    source's own type name. Fields that are None stay None. ``canvas``:
    the (Hc, Wc) every (4, H, W) canvas field is cropped or zero-padded to
    (R = 2 states).
    """
    kind = kind or type(state).__name__
    cls = _target(kind)
    if cls is None:
        raise TypeError(f"no tpuwave_torch counterpart for {kind!r}")
    if hasattr(state, "_asdict"):
        fields = state._asdict()
    elif isinstance(state, dict):
        fields = state
    else:
        fields = dict(zip(cls._fields, state))
    return cls(**{k: _field(k, v, device, dtype, canvas)
                  for k, v in fields.items() if k in cls._fields})


def to_numpy(state) -> dict:
    """The port's state -> {field: numpy array (host ints and None as
    they are)}."""
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else v for k, v in state._asdict().items()}


def like_state(template, fields: dict):
    """``type(template)(**fields)`` with each field in the template
    field's dtype and on its device (a checkpoint's restore, runner.py).

    A host-int field (the 2-term ``n``) comes back as an int; a field the
    file lacks, or whose template is None (a slot this configuration does
    not use), takes the NamedTuple's default. An array whose shape differs
    from the template's (tpuwave pads its R = 2 canvases and boundary
    strips) is cropped or zero-padded to it, from the leading corner:
    the padding lies outside every plane's support."""
    out = {}
    for k, v in fields.items():
        want = getattr(template, k, None)
        if want is None:
            continue
        if isinstance(want, int):
            out[k] = int(np.asarray(v))
            continue
        a = np.asarray(v)
        if a.shape != tuple(want.shape):
            if a.ndim != want.ndim:
                raise ValueError(f"checkpoint field {k!r} has shape "
                                 f"{a.shape}, the state {tuple(want.shape)}")
            fit = np.zeros(tuple(want.shape), dtype=a.dtype)
            keep = tuple(slice(0, min(x, y))
                         for x, y in zip(a.shape, want.shape))
            fit[keep] = a[keep]
            a = fit
        out[k] = torch.tensor(a, dtype=want.dtype, device=want.device)
    return type(template)(**out)


#: the kinds of FWI data ``fwi_to_torch`` takes
_FWI_KINDS = ("cells", "wavelet", "grid", "ring_rows", "ring_cols")


def fwi_to_torch(a, grid: Tuple[int, int], device, dtype: torch.dtype,
                 kind: str = "grid") -> torch.Tensor:
    """tpuwave FWI data -> a tensor of the port's layout on ``grid`` =
    (ny+1, nx+1): ``kind`` "cells" / "wavelet" pass through; "grid" crops
    the last two axes of an (..., H, W) array to ``grid`` (a flat
    (n_vertices,) field of the stencil engine passes through);
    "ring_rows" crops (..., 2, W) to (..., 2, nx+1); "ring_cols" crops
    (..., H, 2 | 128) to (..., ny+1, 2)."""
    if kind not in _FWI_KINDS:
        raise ValueError(f"unknown kind {kind!r} ({' | '.join(_FWI_KINDS)})")
    a = np.asarray(a)
    rows, cols = grid
    if kind == "grid" and a.ndim >= 2:
        a = a[..., :rows, :cols]
    elif kind == "ring_rows":
        a = a[..., :cols]
    elif kind == "ring_cols":
        a = a[..., :rows, :2]
    return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)


#: tpuwave FwiProblem's keywords with no counterpart in the port
_PALLAS_ONLY = ("pallas_block_rows", "pallas_interpret")


def fwi_problem_kwargs(device="cpu", **kw) -> dict:
    """tpuwave ``FwiProblem`` keyword arguments -> the port's, on
    ``device`` (the positional nel, geometry, dt, n_steps are the same).
    tpuwave's defaults engine="scatter" and adjoint="remat" are made
    explicit."""
    out = {"engine": "scatter", "adjoint": "remat", **kw, "device": device}
    if out["engine"] == "pallas":
        out["engine"] = "kernel"
    if "pallas_steps_per_call" in out:
        out["steps_per_call"] = out.pop("pallas_steps_per_call")
    for k in _PALLAS_ONLY:
        out.pop(k, None)
    if out.get("dtype") is not None:
        out["dtype"] = getattr(torch, np.dtype(out["dtype"]).name)
    if out.get("wavelet") is not None:
        out["wavelet"] = np.asarray(out["wavelet"])
    return out


def lbfgs_leaf_names(n_params: int = 1) -> list:
    """Names of the optimizer leaves of an L-BFGS inversion checkpoint, in
    the order of ``jax.tree_util.tree_leaves(optax.lbfgs().init(params))``
    (and of ``solve/lbfgs.py::Lbfgs.leaves``) for ``n_params`` parameter
    arrays (c2, and the wavelet with ``estimate_wavelet``)."""
    per = [f"{{}}{i}" for i in range(n_params)]
    names = ["count"]
    for field in ("params", "updates", "diff_params_memory",
                  "diff_updates_memory"):
        names += [p.format(field) for p in per]
    names += ["weights_memory", "learning_rate", "value"]
    names += [p.format("grad") for p in per]
    return names + ["num_linesearch_steps", "decrease_error",
                    "curvature_error"]
