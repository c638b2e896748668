"""The parity engine's discretisation factory.

Counterpart of tpuwave's models/general.py::make_discretization, whose
structured branch it ports: a parameter file without ``Mesh File Name``
gets the structured rectangle :class:`Discretization`. Imported meshes
(Gmsh / VTK, ``UnstructuredDiscretization``) are not ported yet and are
refused with one line naming the ROADMAP item.
"""

from __future__ import annotations

import torch

from tpuwave_torch.models.discretization import Discretization
from tpuwave_torch.utils.params import Params

__all__ = ["IMPORTED_MESH_REFUSAL", "make_discretization"]

#: the one-line refusal of a parameter file that sets ``Mesh File Name``
IMPORTED_MESH_REFUSAL = ("imported meshes (Mesh File Name) are not ported "
                         "yet (ROADMAP A10(b))")


def make_discretization(params: Params, dtype: torch.dtype = torch.float64,
                        device="cuda") -> Discretization:
    """The structured rectangle discretisation of ``params`` on
    ``device`` (default "cuda"); NotImplementedError for an imported
    mesh."""
    if params.mesh_file is not None:
        raise NotImplementedError(IMPORTED_MESH_REFUSAL)
    return Discretization(params, dtype=dtype, device=device)
