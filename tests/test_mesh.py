"""Mesh generators, boundary extraction, msh round-trip."""

import numpy as np
import pytest

from navierstokes_project_nm4pde_tpu.mesh import (
    Mesh,
    cube_mesh,
    cylinder_channel_2d,
    cylinder_duct_3d,
    read_msh,
    rectangle_mesh,
    write_msh,
)


def test_rectangle_mesh_basic():
    m = rectangle_mesh(4, 3, lx=2.0, ly=1.5)
    assert m.dim == 2
    assert m.n_cells == 4 * 3 * 2
    np.testing.assert_allclose(m.cell_volumes().sum(), 3.0, rtol=1e-12)
    assert np.all(m.cell_volumes() > 0)
    m.check_boundary_closed()
    # tags present: inlet, outlet, walls
    assert set(np.unique(m.bface_tag)) == {0, 1, 2}


def test_cube_mesh():
    m = cube_mesh(4)
    assert m.dim == 3
    assert m.n_cells == 4**3 * 6
    np.testing.assert_allclose(m.cell_volumes().sum(), 8.0, rtol=1e-12)
    assert np.all(m.cell_volumes() > 0)
    m.check_boundary_closed()
    assert set(np.unique(m.bface_tag)) == {0, 1, 2, 3, 4, 5}
    # Neumann face (tag 3) is y = +1: the reference's h formulas use outward
    # normal (0,+1,0) (see models/ethier_steinman.py docstring).
    for fv in m.bface_verts[m.bface_tag == 3][:10]:
        np.testing.assert_allclose(m.coords[fv][:, 1], 1.0, atol=1e-12)


def test_boundary_face_parents():
    m = cube_mesh(2)
    bc, bl = m.boundary_face_parents()
    # The facet must consist of exactly the parent cell's vertices minus one.
    for f in range(m.n_bfaces):
        cell = set(m.cells[bc[f]].tolist())
        face = set(m.bface_verts[f].tolist())
        assert face < cell
        # opposite vertex is cells[bc][bl]
        assert m.cells[bc[f]][bl[f]] not in face


def test_cylinder_channel_2d():
    m = cylinder_channel_2d(lc=0.08)
    assert m.dim == 2
    assert np.all(m.cell_volumes() > 0)
    m.check_boundary_closed()
    assert set(np.unique(m.bface_tag)) == {0, 1, 2, 3}
    # Domain area = rectangle minus circle (polygonal, slightly less).
    area = m.cell_volumes().sum()
    exact = 2.2 * 0.41 - np.pi * 0.05**2
    assert abs(area - exact) < 2e-3
    # Cylinder facet vertices sit on the circle.
    cyl = np.unique(m.bface_verts[m.bface_tag == 3])
    r = np.linalg.norm(m.coords[cyl] - [0.2, 0.2], axis=1)
    np.testing.assert_allclose(r, 0.05, rtol=1e-6)


def test_cylinder_duct_3d():
    m = cylinder_duct_3d(lc=0.1, nz=3)
    assert m.dim == 3
    assert np.all(m.cell_volumes() > 0)
    m.check_boundary_closed()
    assert set(np.unique(m.bface_tag)) == {0, 1, 2, 3}
    vol = m.cell_volumes().sum()
    exact = (2.5 * 0.41 - np.pi * 0.05**2) * 0.41
    assert abs(vol - exact) / exact < 2e-2


def test_msh_roundtrip(tmp_path):
    m = cube_mesh(2)
    path = str(tmp_path / "cube.msh")
    write_msh(m, path)
    m2 = read_msh(path)
    np.testing.assert_allclose(m2.coords, m.coords)
    assert m2.n_cells == m.n_cells
    assert m2.n_bfaces == m.n_bfaces
    np.testing.assert_allclose(m2.cell_volumes().sum(), 8.0, rtol=1e-12)
    m2.check_boundary_closed()

    m = cylinder_channel_2d(lc=0.1)
    path = str(tmp_path / "cyl.msh")
    write_msh(m, path)
    m2 = read_msh(path)
    assert m2.n_cells == m.n_cells
    assert set(np.unique(m2.bface_tag)) == {0, 1, 2, 3}


def test_msh_binary_roundtrip(tmp_path):
    """Binary v2.2 and v4.1 .msh round-trips (deal.II's read_msh accepts
    binary gmsh files; ref: src/NavierStokes2D.cpp:10-14)."""
    from navierstokes_project_nm4pde_tpu.mesh.msh_io import write_msh_v41

    for m, name in [
        (cube_mesh(2), "cube"),
        (cylinder_channel_2d(lc=0.1), "cyl"),
    ]:
        for writer, ver in [(write_msh, "v2"), (write_msh_v41, "v41")]:
            path = str(tmp_path / f"{name}_{ver}.msh")
            writer(m, path, binary=True)
            with open(path, "rb") as f:
                head = f.read(40)
            assert b" 1 8" in head  # really binary
            m2 = read_msh(path)
            np.testing.assert_allclose(m2.coords, m.coords)
            assert m2.n_cells == m.n_cells
            assert m2.n_bfaces == m.n_bfaces
            assert set(np.unique(m2.bface_tag)) == set(
                np.unique(m.bface_tag)
            )
            # same connectivity content (reader may renumber)
            np.testing.assert_allclose(
                np.sort(m2.cell_volumes()), np.sort(m.cell_volumes()),
                rtol=1e-12,
            )
            m2.check_boundary_closed()


def test_reorder_spatial_preserves_geometry():
    m = cylinder_channel_2d(lc=0.1)
    r = m.reorder_spatial()
    assert r.n_cells == m.n_cells and r.n_vertices == m.n_vertices
    np.testing.assert_allclose(
        r.cell_volumes().sum(), m.cell_volumes().sum(), rtol=1e-12
    )
    r.check_boundary_closed()
    assert set(np.unique(r.bface_tag)) == set(np.unique(m.bface_tag))
    # locality: the index span of consecutive cell blocks should shrink
    def mean_span(mesh, B=64):
        c = mesh.cells
        n = (mesh.n_cells // B) * B
        blocks = c[:n].reshape(-1, B * c.shape[1])
        return float(np.mean(blocks.max(axis=1) - blocks.min(axis=1)))
    assert mean_span(r) < mean_span(m)


def test_reorder_spatial_3d_solution_invariant():
    """Solving on the reordered mesh must give the same physics."""
    m = cube_mesh(2)
    r = m.reorder_spatial()
    np.testing.assert_allclose(
        np.sort(r.cell_volumes()), np.sort(m.cell_volumes()), rtol=1e-12
    )
    r.check_boundary_closed()


def test_msh_v41_roundtrip_uses_physical_tags(tmp_path):
    """v4.1 entity blocks carry geometric tags != physical tags; the reader
    must map through $Entities (round-1 advisor finding: using entity tags
    silently mis-tags every boundary)."""
    from navierstokes_project_nm4pde_tpu.mesh.msh_io import write_msh_v41

    m = cylinder_channel_2d(lc=0.12)
    path = str(tmp_path / "cyl41.msh")
    write_msh_v41(m, path)  # entity tag = physical tag + 1, by construction
    m2 = read_msh(path)
    np.testing.assert_allclose(m2.coords, m.coords)
    np.testing.assert_array_equal(m2.cells, m.cells)
    facet_tags = {
        (tuple(sorted(f.tolist())), int(t))
        for f, t in zip(m.bface_verts, m.bface_tag)
    }
    facet_tags2 = {
        (tuple(sorted(f.tolist())), int(t))
        for f, t in zip(m2.bface_verts, m2.bface_tag)
    }
    assert facet_tags2 == facet_tags
    m2.check_boundary_closed()


def test_msh_v41_fixture_parses_and_solves():
    """Committed gmsh-v4.1 DFG channel: parse, then run a few time steps
    (the reference's whole L0 contract is 'gmsh file in';
    ref: src/NavierStokes2D.cpp:10-14)."""
    import os

    from navierstokes_project_nm4pde_tpu.config import (
        NumericsConfig,
        RunConfig,
        SolverConfig,
        TimeConfig,
    )
    from navierstokes_project_nm4pde_tpu.models import (
        Cylinder2DProblem,
        NavierStokesSolver,
    )

    path = os.path.join(os.path.dirname(__file__), "fixtures", "dfg_channel_v41.msh")
    mesh = read_msh(path)
    assert set(np.unique(mesh.bface_tag)) == {0, 1, 2, 3}
    mesh.check_boundary_closed()
    cfg = RunConfig(
        time=TimeConfig(dt=0.01, t_end=0.03),
        solver=SolverConfig(rtol=1e-8, restart=40, maxiter=100),
        numerics=NumericsConfig(dtype="float64", steps_per_chunk=3),
    )
    solver = NavierStokesSolver(mesh, Cylinder2DProblem(test_case=2), cfg)
    state, diags = solver.run(3)
    assert np.all(np.isfinite(np.asarray(state.u)))
    assert np.all(np.isfinite(np.asarray(diags.drag)))
    # the inlet BC actually drives flow (tags were mapped correctly)
    assert float(np.abs(np.asarray(state.u)).max()) > 1e-3


def test_rcm_reorder_spans_bounded():
    """RCM must bound per-node cell spans (the band the banded frozen-Schur
    SpMV and the windowed gathers rely on)."""
    from navierstokes_project_nm4pde_tpu.fem.space import build_taylor_hood

    mesh = cylinder_duct_3d(lc=0.12, nz=4)
    for method, factor in [("morton", None), ("rcm", 0.35)]:
        m = mesh.reorder_spatial(method)
        space = build_taylor_hood(m)
        cells = np.asarray(space.cells_u, dtype=np.int64)
        E, nloc = cells.shape
        first = np.full(space.n_unodes, E, np.int64)
        last = np.full(space.n_unodes, -1, np.int64)
        ci = np.repeat(np.arange(E), nloc)
        np.minimum.at(first, cells.reshape(-1), ci)
        np.maximum.at(last, cells.reshape(-1), ci)
        span_max = int((last - first + 1).max())
        if factor is not None:
            assert span_max < factor * E, (method, span_max, E)
