"""VTU / PVTU / legacy-VTK writers (host-side IO).

Replaces deal.II ``DataOut::write_vtu_with_pvtu_record`` (reference
WaveEquationBase.cpp:330-365) and ``GridOut::write_vtk`` (:48-63). Output
per step: ``solution_XXXX.0.vtu`` (the data piece) + ``solution_XXXX.pvtu``
(the parallel record), 4-digit counters, point fields u, v, optional
u_exact, and a per-cell ``partitioning`` field carrying the shard id.

Data is written as base64-encoded binary (VTK "binary" DataArray format) —
compact and fast to emit from numpy without a C++ dependency.
"""

from __future__ import annotations

import base64
import struct
from pathlib import Path
from typing import Dict, Optional

import numpy as np

__all__ = ["write_vtu_record", "write_mesh_vtk"]

_VTK_TRIANGLE = 5


def _b64_block(data: np.ndarray) -> str:
    raw = np.ascontiguousarray(data).tobytes()
    return base64.b64encode(struct.pack("<I", len(raw)) + raw).decode("ascii")


def _data_array(name: str, arr: np.ndarray, n_comp: int = 1) -> str:
    dtype = {"float64": "Float64", "float32": "Float32",
             "int32": "Int32", "uint8": "UInt8", "int64": "Int64"}[arr.dtype.name]
    return (f'<DataArray type="{dtype}" Name="{name}" '
            f'NumberOfComponents="{n_comp}" format="binary">\n'
            f"{_b64_block(arr)}\n</DataArray>\n")


def write_vtu_record(folder, basename: str, counter: int,
                     points: np.ndarray, cells: np.ndarray,
                     point_data: Dict[str, np.ndarray],
                     cell_data: Optional[Dict[str, np.ndarray]] = None,
                     n_digits: int = 4,
                     cell_shard: Optional[np.ndarray] = None,
                     only_pieces=None,
                     write_record: bool = True) -> Optional[Path]:
    """Write ``<basename>_<counter>.<p>.vtu`` piece(s) + ``.pvtu`` record.

    points: (N, 2) or (N, 3); cells: (E, 3) triangle connectivity.
    ``cell_shard``: optional (E,) int array of shard ids — when given, one
    piece is written per shard (parallel multi-piece output, mirroring the
    reference's one-VTU-per-MPI-rank ``write_vtu_with_pvtu_record``,
    WaveEquationBase.cpp:330-365) and the ``partitioning`` cell field
    carries the real shard id. Returns the path of the .pvtu record.

    Multi-host: ``only_pieces`` restricts which piece files THIS process
    writes (ids outside the set are skipped, but the .pvtu still references
    all of them), and ``write_record=False`` suppresses the .pvtu — so each
    process emits only its local shards' pieces while process 0 also writes
    the record, like the reference's per-rank VTU + rank-0 pvtu. Returns
    None when the record is suppressed.
    """
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    stem = f"{basename}_{counter:0{n_digits}d}"

    cells = np.asarray(cells, dtype=np.int32)
    if cell_shard is not None:
        shard = np.asarray(cell_shard, dtype=np.int64)
        n_pieces = int(shard.max()) + 1 if shard.size else 1
        if n_pieces > 1:
            pts2 = np.asarray(points, dtype=np.float64)
            piece_names = []
            for pid in range(n_pieces):
                piece_names.append(f"{stem}.{pid}.vtu")
                if only_pieces is not None and pid not in only_pieces:
                    continue
                mask = shard == pid
                pc = cells[mask]
                uniq, local = np.unique(pc, return_inverse=True)
                lpd = {k: np.asarray(v, dtype=np.float64)[uniq]
                       for k, v in point_data.items()}
                lcd = {k: np.asarray(v, dtype=np.float64)[mask]
                       for k, v in (cell_data or {}).items()}
                lcd["partitioning"] = np.full(pc.shape[0], float(pid))
                _write_piece(folder, piece_names[-1], pts2[uniq],
                             local.reshape(pc.shape).astype(np.int32),
                             lpd, lcd)
            if not write_record:
                return None
            return _write_pvtu(folder, stem, piece_names, point_data,
                               dict(cell_data or {}, partitioning=None))
        cell_data = dict(cell_data or {},
                         partitioning=np.zeros(cells.shape[0]))

    piece = f"{stem}.0.vtu"
    if only_pieces is None or 0 in only_pieces:
        _write_piece(folder, piece, points, cells, point_data, cell_data)
    if not write_record:
        return None
    return _write_pvtu(folder, stem, [piece], point_data, cell_data)


def _write_piece(folder: Path, piece_name: str,
                 points: np.ndarray, cells: np.ndarray,
                 point_data, cell_data) -> str:
    pts = np.asarray(points, dtype=np.float64)
    if pts.shape[1] == 2:
        pts = np.concatenate([pts, np.zeros((pts.shape[0], 1))], axis=1)
    cells = np.asarray(cells, dtype=np.int32)
    n_pts, n_cells = pts.shape[0], cells.shape[0]

    parts = []
    parts.append('<?xml version="1.0"?>\n')
    parts.append('<VTKFile type="UnstructuredGrid" version="0.1" '
                 'byte_order="LittleEndian">\n<UnstructuredGrid>\n')
    parts.append(f'<Piece NumberOfPoints="{n_pts}" NumberOfCells="{n_cells}">\n')
    parts.append("<Points>\n")
    parts.append(_data_array("Points", pts, 3))
    parts.append("</Points>\n<Cells>\n")
    parts.append(_data_array("connectivity", cells.astype(np.int32).ravel()))
    offsets = (3 * np.arange(1, n_cells + 1)).astype(np.int32)
    parts.append(_data_array("offsets", offsets))
    parts.append(_data_array("types",
                             np.full(n_cells, _VTK_TRIANGLE, dtype=np.uint8)))
    parts.append("</Cells>\n")

    parts.append("<PointData>\n")
    for name, arr in point_data.items():
        parts.append(_data_array(name, np.asarray(arr, dtype=np.float64)))
    parts.append("</PointData>\n")

    parts.append("<CellData>\n")
    for name, arr in (cell_data or {}).items():
        parts.append(_data_array(name, np.asarray(arr, dtype=np.float64)))
    parts.append("</CellData>\n")

    parts.append("</Piece>\n</UnstructuredGrid>\n</VTKFile>\n")
    (folder / piece_name).write_text("".join(parts))
    return piece_name


def _write_pvtu(folder: Path, stem: str, piece_names,
                point_data, cell_data) -> Path:
    # parallel record referencing all pieces
    pvtu = ['<?xml version="1.0"?>\n',
            '<VTKFile type="PUnstructuredGrid" version="0.1" '
            'byte_order="LittleEndian">\n<PUnstructuredGrid GhostLevel="0">\n',
            "<PPoints>\n"
            '<PDataArray type="Float64" NumberOfComponents="3"/>\n'
            "</PPoints>\n",
            "<PPointData>\n"]
    for name in point_data:
        pvtu.append(f'<PDataArray type="Float64" Name="{name}"/>\n')
    pvtu.append("</PPointData>\n<PCellData>\n")
    for name in (cell_data or {}):
        pvtu.append(f'<PDataArray type="Float64" Name="{name}"/>\n')
    pvtu.append("</PCellData>\n")
    for piece_name in piece_names:
        pvtu.append(f'<Piece Source="{piece_name}"/>\n')
    pvtu.append("</PUnstructuredGrid>\n</VTKFile>\n")
    record = folder / f"{stem}.pvtu"
    record.write_text("".join(pvtu))
    return record


def write_mesh_vtk(path, points: np.ndarray, cells: np.ndarray) -> Path:
    """Legacy-format VTK snapshot of the triangulation
    (= GridOut::write_vtk, reference WaveEquationBase.cpp:48-63)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    pts = np.asarray(points, dtype=np.float64)

    cells = np.asarray(cells, dtype=np.int64)
    lines = ["# vtk DataFile Version 3.0",
             "Triangulation generated by tpuwave", "ASCII",
             "DATASET UNSTRUCTURED_GRID",
             f"POINTS {pts.shape[0]} double"]
    for p in pts:
        z = p[2] if pts.shape[1] > 2 else 0.0
        lines.append(f"{p[0]:.12g} {p[1]:.12g} {z:.12g}")
    n_cells = cells.shape[0]
    lines.append(f"CELLS {n_cells} {4 * n_cells}")
    for c in cells:
        lines.append(f"3 {c[0]} {c[1]} {c[2]}")
    lines.append(f"CELL_TYPES {n_cells}")
    lines.extend(["5"] * n_cells)
    path.write_text("\n".join(lines) + "\n")
    return path
