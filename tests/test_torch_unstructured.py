"""The port's imported-mesh layer against tpuwave's, on the CPU in f64.

* Readers: Gmsh ASCII 2.2 and 4.1 and legacy VTK give tpuwave's arrays;
  ``write_msh`` writes tpuwave's bytes; a missing, unrecognised, binary,
  non-planar or triangle-free file and a degenerate cell raise tpuwave's
  exception type and text; ``detect_structured`` gives tpuwave's hits and
  rejections.
* Geometry and space at R = 1 and 2 on perturbed meshes (interior
  vertices moved by up to a quarter cell, seeds fixed): det J, J^-T,
  edges, boundary masks, ``locate_point`` (ties on vertices and edges
  included), cell DoFs and DoF coordinates equal tpuwave's.
* ``UnstructuredDiscretization``: mass and stiffness within rtol 1e-12,
  the lumped and diagonal masses, the load vector, K(t) with a
  time-dependent C, the errors and the probe; ``make_discretization``
  routes recognised rectangles onto the structured Discretization and
  refuses the multi-device shardings (ROADMAP A11).
* The reference's default mesh ``mesh/mesh-square-40.msh`` runs as the
  Nel 40 rectangle: the same final errors, and the console says so.
* The port alone: P1 on perturbed meshes at Nel 8 / 16 / 32 converges at
  order 1.6-2.6 in L2 (tpuwave's test).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (one torch thread)
from tpuwave_torch.core import unstructured as tu
from tpuwave_torch.core.mesh import StructuredTriMesh

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def perturbed_points(nel, seed=0, amp=0.25):
    """(points, cells) of the structured Nel x Nel unit square with its
    interior vertices displaced by up to ``amp * h`` (the ``perturbed_mesh``
    of tests/test_unstructured.py)."""
    m = StructuredTriMesh((nel, nel), ((0.0, 0.0), (1.0, 1.0)))
    pts = m.vertex_coords.copy()
    rng = np.random.default_rng(seed)
    interior = ~m.boundary_vertex_mask
    pts[interior] += (rng.uniform(-amp, amp, (interior.sum(), 2))
                      * np.array([m.hx, m.hy]))
    return pts, m.cells


def both_meshes(nel, seed):
    from tpuwave.core import unstructured as ju
    pts, cells = perturbed_points(nel, seed)
    return ju.UnstructuredTriMesh(pts, cells), tu.UnstructuredTriMesh(pts,
                                                                      cells)


def standing_case(**over):
    """A standing-mode case with a forcing and a C that varies in x, y
    and t, ``Time Dependent C`` on: every assembly path has work."""
    case = json.loads((ROOT / "parameters"
                       / "standing-mode-wsol.json").read_text())
    case.update({"T": "0.05", "Dt": "0.01", "Theta": "0.5",
                 "Save Solution": "false", "Log Every": "1",
                 "Time Dependent C": "true",
                 "C": {"Function expression":
                       "sqrt(1 + 0.5*sin(2*t) + 0.3*x*y)",
                       "Variable names": "x, y, t"},
                 "F": {"Function expression": "x*y*cos(3*t) + 1",
                       "Variable names": "x, y, t"}})
    case.update(over)
    return case


MSH41 = """$MeshFormat
4.1 0 8
$EndMeshFormat
$Entities
4 1 1 0
$EndEntities
$Nodes
3 5 1 9
0 1 0 1
9
0 0 0
2 1 0 2
3
7
1 0 0
1 1 0
2 1 0 2
5
8
0.5 0.45 0
0 1 0
$EndNodes
$Elements
3 7 1 7
0 1 15 1
1 9
1 1 1 2
2 9 3
3 3 7
2 1 2 4
4 9 3 5
5 3 7 5
6 7 8 5
7 8 9 5
$EndElements
"""


def _write(tmp_path, name, data):
    path = tmp_path / name
    if isinstance(data, bytes):
        path.write_bytes(data)
    else:
        path.write_text(data)
    return path


# ---------------------------------------------------------------------------
# readers / writer / detection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["msh22", "msh41", "vtk"])
def test_readers_match_tpuwave(tmp_path, fmt):
    from tpuwave.core import unstructured as ju
    from tpuwave.utils.vtu import write_mesh_vtk
    pts, cells = perturbed_points(5, seed=4)
    if fmt == "msh22":
        path = tu.write_msh(tmp_path / "m.msh", pts, cells)
    elif fmt == "msh41":
        # non-contiguous node tags over several entity blocks, point and
        # line elements to drop
        path = _write(tmp_path, "m4.msh", MSH41)
    else:
        path = write_mesh_vtk(tmp_path / "m.vtk", pts, cells)
    want, got = ju.read_mesh_file(path), tu.read_mesh_file(path)
    assert got.name == want.name
    np.testing.assert_array_equal(got.vertex_coords, want.vertex_coords)
    np.testing.assert_array_equal(got.cells, want.cells)
    assert got.cells.dtype == want.cells.dtype
    if fmt == "msh41":
        assert got.n_vertices == 5 and got.n_cells == 4


def test_write_msh_bytes_match_tpuwave(tmp_path):
    from tpuwave.core import unstructured as ju
    pts, cells = perturbed_points(4, seed=1)
    a = ju.write_msh(tmp_path / "j" / "m.msh", pts, cells)
    b = tu.write_msh(tmp_path / "t" / "m.msh", pts, cells)
    assert b.read_bytes() == a.read_bytes()


NONPLANAR = """$MeshFormat
2.2 0 8
$EndMeshFormat
$Nodes
3
1 0 0 0
2 1 0 0.5
3 0 1 0
$EndNodes
$Elements
1
1 2 2 0 1 1 2 3
$EndElements
"""
LINES_ONLY = NONPLANAR.replace("0 0.5", "0 0").replace(
    "1 2 2 0 1 1 2 3", "1 1 2 0 1 1 2")
BAD_FILES = {
    "missing": None,
    "unrecognised": "not a mesh",
    "binary": b"$MeshFormat\n4.1 1 8\n" + bytes(range(256)),
    "non-planar": NONPLANAR,
    "no triangles": LINES_ONLY,
    "vtk without cells": "# vtk DataFile Version 3.0\nm\nASCII\n"
                         "DATASET UNSTRUCTURED_GRID\nPOINTS 1 double\n0 0 0\n",
}


@pytest.mark.parametrize("what", sorted(BAD_FILES))
def test_reader_errors_match_tpuwave(tmp_path, what):
    from tpuwave.core import unstructured as ju
    data = BAD_FILES[what]
    suffix = ".vtk" if what.startswith("vtk") else ".msh"
    path = tmp_path / f"bad{suffix}"
    if data is not None:
        _write(tmp_path, path.name, data)
    with pytest.raises(Exception) as want:
        ju.read_mesh_file(path)
    with pytest.raises(Exception) as got:
        tu.read_mesh_file(path)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("what", ["degenerate", "shape", "range"])
def test_mesh_refusals_match_tpuwave(what):
    from tpuwave.core import unstructured as ju
    pts = np.array([[0.0, 0.0], [1.0, 0.0], [2.0, 0.0]])
    cells = {"degenerate": [[0, 1, 2]], "shape": [[0, 1]],
             "range": [[0, 1, 3]]}[what]
    with pytest.raises(ValueError) as want:
        ju.UnstructuredTriMesh(pts, np.array(cells))
    with pytest.raises(ValueError) as got:
        tu.UnstructuredTriMesh(pts, np.array(cells))
    assert str(got.value) == str(want.value)


def _detect_cases():
    """Meshes for detect_structured: hits (a rectangle, renumbered and
    rotated) and rejections (perturbed, other diagonal, uneven x)."""
    m = StructuredTriMesh((7, 4), ((-1.0, 2.0), (3.0, 5.0)))
    rng = np.random.default_rng(0)
    perm = rng.permutation(m.n_vertices)
    inv = np.argsort(perm)
    cells2 = np.roll(inv[m.cells][rng.permutation(m.n_cells)], 1, axis=1)
    n = 4
    sq = StructuredTriMesh((n, n), ((0.0, 0.0), (1.0, 1.0)))
    ii, jj = [a.ravel() for a in np.meshgrid(np.arange(n), np.arange(n))]
    vi = lambda i, j: j * (n + 1) + i                       # noqa: E731
    flipped = np.concatenate([
        np.stack([vi(ii, jj), vi(ii + 1, jj), vi(ii, jj + 1)], axis=-1),
        np.stack([vi(ii + 1, jj), vi(ii + 1, jj + 1), vi(ii, jj + 1)],
                 axis=-1)])
    m3 = StructuredTriMesh((3, 3), ((0.0, 0.0), (1.0, 1.0)))
    uneven = m3.vertex_coords.copy()
    uneven[:, 0] = np.array([0.0, 0.1, 0.5, 1.0])[
        np.rint(uneven[:, 0] * 3).astype(int)]
    return [(m.vertex_coords, m.cells), (m.vertex_coords[perm], cells2),
            perturbed_points(6, seed=1), (sq.vertex_coords, flipped),
            (uneven, m3.cells)]


def test_detect_structured_matches_tpuwave():
    from tpuwave.core import unstructured as ju
    got = []
    for pts, cells in _detect_cases():
        cells = np.asarray(cells, dtype=np.int32)
        want = ju.detect_structured(ju.UnstructuredTriMesh(pts, cells))
        hit = tu.detect_structured(tu.UnstructuredTriMesh(pts, cells))
        assert hit == want
        got.append(hit is not None)
    assert got == [True, True, False, False, False]


# ---------------------------------------------------------------------------
# geometry and space
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r", [1, 2])
def test_geometry_and_space_match_tpuwave(r):
    from tpuwave.core import unstructured as ju
    jm, tm = both_meshes(9, seed=3)
    for name in ("det_j", "jinv_t", "jacobians", "edges", "cell_edges",
                 "boundary_edge_mask", "boundary_vertex_mask",
                 "edge_midpoints", "cells"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name),
                                      err_msg=name)
    assert tm.bbox == jm.bbox and tm.h_max == jm.h_max
    # points inside, on vertices, on edges (argmin ties) and the centre
    pts = list(np.random.default_rng(0).uniform(0.02, 0.98, (6, 2)))
    pts += [tm.vertex_coords[40], tm.edge_midpoints[17],
            tm.edge_midpoints[tm.boundary_edge_mask][2], tm.center]
    for p in pts:
        assert tm.locate_point(p) == jm.locate_point(p)
    js, ts = ju.UnstructuredFeSpace(jm, r), tu.UnstructuredFeSpace(tm, r)
    assert ts.n_dofs == js.n_dofs and ts.n_local_dofs == js.n_local_dofs
    for name in ("cell_dofs", "dof_coords", "boundary_mask"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name),
                                      err_msg=name)
    from tpuwave.core.quadrature import gauss_simplex
    quad = gauss_simplex(r + 1)
    np.testing.assert_array_equal(ts.quad_points(quad), js.quad_points(quad))
    np.testing.assert_array_equal(
        ts.physical_grads(ts.shape_at(quad)),
        js.physical_grads(js.shape_at(quad)))
    cell, ref = tm.locate_point(tm.center)
    for a, b in zip(ts.eval_basis_at(cell, ref), js.eval_basis_at(cell, ref)):
        np.testing.assert_array_equal(a, b)


def test_locate_point_outside_warns_as_tpuwave():
    jm, tm = both_meshes(4, seed=0)
    with pytest.warns(UserWarning, match="outside the mesh") as rec:
        got = tm.locate_point((1.5, 0.5))
    with pytest.warns(UserWarning) as rec_j:
        want = jm.locate_point((1.5, 0.5))
    assert got == want and str(rec[0].message) == str(rec_j[0].message)


# ---------------------------------------------------------------------------
# UnstructuredDiscretization
# ---------------------------------------------------------------------------

def _close(got, want, rtol=1e-12, atol=0.0):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-300)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= rtol * scale + atol, (err, scale)


@pytest.fixture(scope="module", params=[1, 2], ids=["R1", "R2"])
def disc_pair(request):
    """tpuwave's and the port's UnstructuredDiscretization of one perturbed
    Nel 10 mesh and ``standing_case``, at R = 1 or 2."""
    from tpuwave.models.general import UnstructuredDiscretization as JU
    from tpuwave.utils.params import load_params as jload
    from tpuwave_torch.models.general import UnstructuredDiscretization
    from tpuwave_torch.utils.params import load_params
    case = standing_case(R=str(request.param))
    jm, tm = both_meshes(10, seed=request.param)
    return (JU(jload(case), mesh=jm),
            UnstructuredDiscretization(load_params(case), device=CPU,
                                       mesh=tm))


def test_discretization_operators_match_tpuwave(disc_pair):
    import jax.numpy as jnp
    jd, td = disc_pair
    assert td.n_dofs == jd.n_dofs
    assert td.conn.slots.shape[1] == np.bincount(
        td.space.cell_dofs.ravel()).max()
    for name in ("mass", "stiffness"):
        _close(getattr(td, name).to_dense(), getattr(jd, name).to_dense())
    for name in ("mass_diag", "lumped_mass"):
        _close(getattr(td, name), getattr(jd, name))
    np.testing.assert_array_equal(td.boundary_mask.numpy(),
                                  np.asarray(jd.boundary_mask))
    np.testing.assert_array_equal(td.boundary_idx.numpy(),
                                  np.asarray(jd.boundary_idx))
    x = np.sin(3.0 * td.dof_coords[:, 0]) * np.cos(2.0 * td.dof_coords[:, 1])
    _close(td.stiffness(torch.as_tensor(x)),
           jd.stiffness(jnp.asarray(x)))
    for t in (0.0, 0.37):
        _close(td.stiffness_at(t).to_dense(), jd.stiffness_at(t).to_dense())
        _close(td.load_vector(t), jd.load_vector(t))


def test_discretization_diagnostics_match_tpuwave(disc_pair):
    import jax.numpy as jnp
    jd, td = disc_pair
    p = td.params
    for t in (0.0, 0.05):
        _close(td.interpolate(p.solution, t), jd.interpolate(
            jd.params.solution, t))
        _close(td.boundary_values(p.g, t), jd.boundary_values(
            jd.params.g, t))
    x = td.dof_coords
    u = np.sin(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1]) * (1 + 0.1 * x[:, 0])
    v = np.cos(2.0 * x[:, 1])
    ut, vt = torch.as_tensor(u), torch.as_tensor(v)
    u, v = jnp.asarray(u), jnp.asarray(v)
    for got, want in zip(td.errors(ut, 0.03), jd.errors(u, 0.03)):
        assert float(got) == pytest.approx(float(want), rel=1e-12)
    assert float(td.probe(ut)) == pytest.approx(float(jd.probe(u)),
                                                rel=1e-12)
    assert float(td.energy(ut, vt)) == pytest.approx(
        float(jd.energy(u, v)), rel=1e-12)
    np.testing.assert_array_equal(td.vertex_values(ut),
                                  np.asarray(jd.vertex_values(u)))


def test_make_discretization_routes_as_tpuwave(tmp_path):
    from tpuwave_torch.models.discretization import Discretization
    from tpuwave_torch.models.fast_engine import \
        fast_engine_ineligible_reason
    from tpuwave_torch.models.general import (UnstructuredDiscretization,
                                              make_discretization,
                                              recognised_rectangle)
    from tpuwave_torch.utils.params import load_params
    m = StructuredTriMesh((6, 5), ((0.0, 0.0), (3.0, 1.0)))
    rect_file = tu.write_msh(tmp_path / "s.msh", m.vertex_coords, m.cells)
    pts, cells = perturbed_points(5, seed=3)
    pert = tu.write_msh(tmp_path / "p.msh", pts, cells)
    p = load_params(standing_case(**{"Mesh File Name": str(rect_file)}))
    d = make_discretization(p, device=CPU)
    assert type(d) is Discretization and d.params.nel == (6, 5)
    assert d.mesh.geometry == ((0.0, 0.0), (3.0, 1.0))
    assert d.params.mesh_file == str(rect_file)
    p2 = load_params(standing_case(**{"Mesh File Name": str(pert)}))
    assert type(make_discretization(p2, device=CPU)) is \
        UnstructuredDiscretization
    # the one rectangle check: the engines' Params of a recognised import
    rect = recognised_rectangle(p)
    assert (rect.nel, rect.geometry, rect.mesh_file, rect.mesh_recognised) \
        == ((6, 5), ((0.0, 0.0), (3.0, 1.0)), str(rect_file), True)
    assert recognised_rectangle(rect) is rect
    assert recognised_rectangle(p2) is None
    assert fast_engine_ineligible_reason(rect) is None
    assert fast_engine_ineligible_reason(p2) == \
        "imported mesh (factory routes recognisable rectangles)"
    assert type(make_discretization(rect, device=CPU)) is Discretization


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

def test_default_mesh_file_runs_as_nel_40(tmp_path, capsys):
    """The reference's default mesh (tpuwave/utils/params.py:103-108) is
    recognised as the 40 x 40 unit square and runs the Nel 40 rectangle's
    engine (``--precond mg``: the V-cycle)."""
    from tpuwave_torch.cli import newmark
    base = json.loads((ROOT / "parameters"
                       / "standing-mode-wsol.json").read_text())
    base.update({"Nel": "40", "T": "0.03", "Dt": "0.01", "Log Every": "1",
                 "Save Solution": "false"})
    runs = {}
    for tag, over in (("nel", {}), ("msh", {"Mesh File Name": str(
            ROOT / "mesh" / "mesh-square-40.msh"), "Nel": "7"})):
        path = tmp_path / f"{tag}.json"
        path.write_text(json.dumps(dict(base, **over)))
        rc = newmark.main([str(path), "--results-root", str(tmp_path / tag),
                           "--mesh-root", str(tmp_path / f"m{tag}"),
                           "--precond", "mg", "--device", "cpu"])
        assert rc == 0
        runs[tag] = capsys.readouterr().out
    assert "  Recognised as a structured 40x40 rectangle -> structured " \
           "engines" in runs["msh"].splitlines()
    assert "  Engine: fast (grid-stencil)" in runs["msh"].splitlines()
    assert (tmp_path / "mnel").exists()
    assert not (tmp_path / "mmsh").exists()   # no snapshot of an import

    def finals(out):
        return [float(ln.split("=")[1]) for ln in out.splitlines()
                if ln.startswith("  Relative")]
    want, got = finals(runs["nel"]), finals(runs["msh"])
    assert len(got) == 2
    for a, b in zip(got, want):
        assert abs(a - b) <= 1e-14 * abs(b)
    rel = "newmark-msh/run-R1-N40x40-dt0_01-T0_03-gamma0_5-beta0_25"
    for name in ("energy.csv", "error.csv", "probe.csv", "iterations.csv"):
        assert (tmp_path / "msh" / rel / name).read_text() == (
            tmp_path / "nel" / rel.replace("msh", "nel") / name).read_text()


def test_convergence_on_perturbed_meshes(tmp_path):
    """P1 L2 order on perturbed meshes at Nel 8 / 16 / 32 (theta 1/2, dt
    scaled with h), as tpuwave's test_convergence_on_perturbed_meshes."""
    from tpuwave_torch import api
    from tpuwave_torch.models.runner import RunConfig
    errs, hs = [], []
    for nel in (8, 16, 32):
        pts, cells = perturbed_points(nel, seed=5, amp=0.2)
        mesh = tu.UnstructuredTriMesh(pts, cells)
        msh = tu.write_msh(tmp_path / f"p{nel}.msh", pts, cells)
        case = json.loads((ROOT / "parameters"
                           / "standing-mode-wsol.json").read_text())
        case.update({"T": "0.1", "Dt": str(0.4 / nel), "Theta": "0.5",
                     "Log Every": "0", "Save Solution": "false",
                     "Mesh File Name": str(msh)})
        r = api.solve(case, "theta", device=CPU,
                      config=RunConfig(quiet=True, write_mesh=False,
                                       results_root=str(tmp_path / "res")))
        errs.append(r.rel_l2)
        hs.append(mesh.h_max)
    order = np.log(errs[0] / errs[2]) / np.log(hs[0] / hs[2])
    assert 1.6 < order < 2.6, (errs, hs, order)
