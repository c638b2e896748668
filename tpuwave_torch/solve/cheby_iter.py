"""Analytic spectrum bounds of a constant-stencil operator.

Only :func:`stencil_symbol_bounds` of tpuwave's solve/cheby_iter.py is
ported so far: the fast engines use its upper bound in the f32
backward-error stopping floor. The Chebyshev iteration itself
(``--solver cheby``) is still to be ported (ROADMAP A6).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

__all__ = ["stencil_symbol_bounds"]


def stencil_symbol_bounds(stencil, n: int = 512,
                          pad_rel: float = 1e-3) -> Tuple[float, float]:
    """Spectrum bounds of a constant-stencil operator from its symbol.

    ``stencil``: (3, 3) coefficients, s[1+dj][1+di] = coupling to the
    neighbour at offset (di, dj); must be symmetric (s_d == s_{-d}), which
    holds for every FEM operator here. The Dirichlet (interior) matrix is
    a principal submatrix of the circulant whose eigenvalues are the
    symbol values, so its spectrum lies in [min lam, max lam]; pinned rows
    contribute exactly the diagonal s[1][1] = the symbol mean, inside the
    range. The symbol is a degree-1 trig polynomial per axis — a 512^2
    sample plus a relative pad far over-resolves its extrema.
    """
    if isinstance(stencil, tuple):
        return _symbol_bounds_cached(stencil, n, pad_rel)
    return _symbol_bounds_impl(np.asarray(stencil), n, pad_rel)


@functools.lru_cache(maxsize=256)
def _symbol_bounds_cached(stencil: Tuple, n: int, pad_rel: float):
    return _symbol_bounds_impl(np.asarray(stencil), n, pad_rel)


def _symbol_bounds_impl(stencil, n: int, pad_rel: float):
    s = np.asarray(stencil, dtype=np.float64)
    th = np.linspace(0.0, 2.0 * np.pi, n, endpoint=False)
    tx = th[None, :]
    ty = th[:, None]
    lam = np.zeros((n, n))
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            c = s[1 + dj, 1 + di]
            if c != 0.0:
                lam = lam + c * np.cos(di * tx + dj * ty)
    lo, hi = float(lam.min()), float(lam.max())
    pad = pad_rel * (hi - lo)
    return lo - pad, hi + pad
