"""Matrix-free operators vs an independent dense assembly (numpy loops).

This is the test the reference never had: every block (M, A, D, G, Mp, C(w))
is checked against a direct quadrature-loop dense assembly on small meshes.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from navierstokes_project_nm4pde_tpu.fem import quadrature as quad
from navierstokes_project_nm4pde_tpu.fem import reference as ref
from navierstokes_project_nm4pde_tpu.fem.geometry import cell_geometry
from navierstokes_project_nm4pde_tpu.fem.space import build_taylor_hood
from navierstokes_project_nm4pde_tpu.mesh import cube_mesh, rectangle_mesh
from navierstokes_project_nm4pde_tpu.ops import operators as ops


def dense_blocks(space, nu=1.0):
    """Independent dense assembly of M, A, D, Mp and node coords."""
    dim = space.dim
    mesh = space.mesh
    pts, w = quad.cell_rule(dim, 5)
    phi = ref.p2_shape(pts, dim)  # [q, nu]
    gref = ref.p2_grad(pts, dim)  # [q, nu, dim]
    phip = ref.p1_shape(pts, dim)  # [q, np]
    nU, nP = space.n_unodes, space.n_pnodes
    M = np.zeros((nU, nU))
    A = np.zeros((nU, nU))
    D = np.zeros((nP, nU, dim))
    Mp = np.zeros((nP, nP))
    for e in range(mesh.n_cells):
        vid = mesh.cells[e]
        v = mesh.coords[vid]
        J = (v[1:] - v[:1]).T
        detJ = np.linalg.det(J)
        Jinv = np.linalg.inv(J)
        gphys = np.einsum("qik,kd->qid", gref, Jinv)  # [q, nu, dim]
        iu = space.cells_u[e]
        ip = space.cells_p[e]
        Me = detJ * np.einsum("q,qi,qj->ij", w, phi, phi)
        Ae = detJ * np.einsum("q,qid,qjd->ij", w, gphys, gphys)
        De = detJ * np.einsum("q,qi,qjc->ijc", w, phip, gphys)
        Mpe = detJ * np.einsum("q,qi,qj->ij", w, phip, phip)
        M[np.ix_(iu, iu)] += Me
        A[np.ix_(iu, iu)] += Ae
        for c in range(dim):
            D[np.ix_(ip, iu, [c])] += De[:, :, c][:, :, None]
        Mp[np.ix_(ip, ip)] += Mpe
    return M, A, D, Mp


def dense_convection(space, wfield):
    """Dense scalar convection block C(w) including the Temam term."""
    dim = space.dim
    mesh = space.mesh
    pts, w = quad.cell_rule(dim, 5)
    phi = ref.p2_shape(pts, dim)
    gref = ref.p2_grad(pts, dim)
    nU = space.n_unodes
    C = np.zeros((nU, nU))
    for e in range(mesh.n_cells):
        v = mesh.coords[mesh.cells[e]]
        J = (v[1:] - v[:1]).T
        detJ = np.linalg.det(J)
        Jinv = np.linalg.inv(J)
        gphys = np.einsum("qik,kd->qid", gref, Jinv)
        iu = space.cells_u[e]
        we = wfield[iu]  # [nu, dim]
        w_q = np.einsum("qi,id->qd", phi, we)
        divw_q = np.einsum("qid,id->q", gphys, we)
        # (w . grad phi_j) phi_i + 0.5 divw phi_i phi_j
        Ce = detJ * np.einsum(
            "q,qi,qj->ij", w, phi, np.einsum("qjd,qd->qj", gphys, w_q)
        )
        Ce += detJ * 0.5 * np.einsum("q,q,qi,qj->ij", w, divw_q, phi, phi)
        C[np.ix_(iu, iu)] += Ce
    return C


@pytest.fixture(scope="module", params=[2, 3], ids=["tri", "tet"])
def setup(request):
    dim = request.param
    if dim == 2:
        mesh = rectangle_mesh(3, 2, lx=1.3, ly=0.9)
    else:
        mesh = cube_mesh(2)
    space = build_taylor_hood(mesh)
    geom = cell_geometry(space)
    mask = space.dirichlet_mask([0, 2]) if dim == 2 else space.dirichlet_mask([0])
    op = ops.build_operator(space, geom, mask, dtype=jnp.float64)
    return space, geom, op


def test_mass_and_stiffness(setup):
    space, geom, op = setup
    M, A, D, Mp = dense_blocks(space)
    rng = np.random.default_rng(0)
    u = rng.normal(size=(space.n_unodes, space.dim))
    np.testing.assert_allclose(
        np.asarray(ops.apply_mass(op, jnp.asarray(u))), M @ u, rtol=1e-10, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(ops.apply_stiffness(op, jnp.asarray(u))), A @ u, rtol=1e-10, atol=1e-12
    )
    # diagonals
    np.testing.assert_allclose(np.asarray(op.diagM), np.diag(M), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(op.diagA), np.diag(A), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(op.diagMp), np.diag(Mp), rtol=1e-10)


def test_divergence_gradient_adjoint(setup):
    space, geom, op = setup
    M, A, D, Mp = dense_blocks(space)
    rng = np.random.default_rng(1)
    u = rng.normal(size=(space.n_unodes, space.dim))
    p = rng.normal(size=space.n_pnodes)
    Du = np.einsum("pic,ic->p", D, u)
    np.testing.assert_allclose(
        np.asarray(ops.apply_divergence(op, jnp.asarray(u))), Du, rtol=1e-10, atol=1e-12
    )
    Gp = -np.einsum("pic,p->ic", D, p)
    np.testing.assert_allclose(
        np.asarray(ops.apply_gradient(op, jnp.asarray(p))), Gp, rtol=1e-10, atol=1e-12
    )
    # ELL path agrees with element path
    host = ops.build_operator(
        space, geom, np.asarray(op.dirichlet_mask), dtype=jnp.float64,
        want_host_schur=True,
    )[1]
    np.testing.assert_allclose(
        np.asarray(ops.apply_D_ell(host, jnp.asarray(u))), Du, rtol=1e-10, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(ops.apply_pressure_mass(op, jnp.asarray(p))), Mp @ p,
        rtol=1e-10, atol=1e-12,
    )


def test_convection(setup):
    space, geom, op = setup
    rng = np.random.default_rng(2)
    wf = rng.normal(size=(space.n_unodes, space.dim))
    u = rng.normal(size=(space.n_unodes, space.dim))
    conv = ops.convection_setup(op, jnp.asarray(wf))
    C = dense_convection(space, wf)
    np.testing.assert_allclose(
        np.asarray(ops.apply_convection(op, conv, jnp.asarray(u))), C @ u,
        rtol=1e-9, atol=1e-11,
    )
    np.testing.assert_allclose(np.asarray(conv.diagC), np.diag(C), rtol=1e-9, atol=1e-12)


def test_apply_F_consistency(setup):
    space, geom, op = setup
    rng = np.random.default_rng(3)
    wf = rng.normal(size=(space.n_unodes, space.dim))
    u = rng.normal(size=(space.n_unodes, space.dim))
    nu, dt = 0.01, 0.05
    conv = ops.convection_setup(op, jnp.asarray(wf))
    y = ops.apply_F(op, nu, dt, conv, jnp.asarray(u))
    y2 = (
        np.asarray(ops.apply_mass(op, jnp.asarray(u))) / dt
        + nu * np.asarray(ops.apply_stiffness(op, jnp.asarray(u)))
        + np.asarray(ops.apply_convection(op, conv, jnp.asarray(u)))
    )
    np.testing.assert_allclose(np.asarray(y), y2, rtol=1e-9, atol=1e-11)
    d = ops.diag_F(op, nu, dt, conv)
    np.testing.assert_allclose(
        np.asarray(d), np.asarray(op.diagM) / dt + nu * np.asarray(op.diagA) + np.asarray(conv.diagC),
        rtol=1e-12,
    )


def test_folded_F_matches_unfolded(setup):
    """The fold algebra: convection_setup(fold=(nu, dt)) bakes
    F_e = detJ/dt M^ + nu GKd:A^ + C_e(w) so apply_F/apply_system via the
    single batched matmul must equal the unfolded 5-einsum chain."""
    space, geom, op = setup
    rng = np.random.default_rng(7)
    wf = rng.normal(size=(space.n_unodes, space.dim))
    u = rng.normal(size=(space.n_unodes, space.dim))
    p = rng.normal(size=space.n_pnodes)
    nu, dt = 0.01, 0.05
    conv0 = ops.convection_setup(op, jnp.asarray(wf))
    convf = ops.convection_setup(op, jnp.asarray(wf), fold=(nu, dt))
    assert convf.F_e is not None and convf.fold_static == (nu, dt)
    np.testing.assert_allclose(
        np.asarray(ops.apply_F(op, nu, dt, convf, jnp.asarray(u))),
        np.asarray(ops.apply_F(op, nu, dt, conv0, jnp.asarray(u))),
        rtol=1e-9, atol=1e-11,
    )
    yu_f, yp_f = ops.apply_system(op, nu, dt, convf, jnp.asarray(u), jnp.asarray(p))
    yu_0, yp_0 = ops.apply_system(op, nu, dt, conv0, jnp.asarray(u), jnp.asarray(p))
    np.testing.assert_allclose(np.asarray(yu_f), np.asarray(yu_0), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(yp_f), np.asarray(yp_0), rtol=1e-9, atol=1e-11)
    # wrong-(nu, dt) application is refused (silent wrong-operator guard)
    with pytest.raises(ValueError, match="folded ConvectionData"):
        ops.apply_F(op, nu, 2 * dt, convf, jnp.asarray(u))


def test_fold_with_precomputed_base_matches(setup):
    """convection_setup(fold=..., base_e=...) with the setup-time constant
    viscous element stiffness (models/base.py DeviceData.conv_base: the
    exact-f32 broadcast contraction of GKd with AHAT) must equal the fold
    that rebuilds the contraction in place."""
    space, geom, op = setup
    rng = np.random.default_rng(21)
    wf = jnp.asarray(rng.normal(size=(space.n_unodes, space.dim)))
    nu, dt = 0.01, 0.05
    base_e = (
        op.GKd[:, :, :, None, None] * op.AHAT[None]
    ).sum(axis=(1, 2))
    conv0 = ops.convection_setup(op, wf, fold=(nu, dt))
    conv1 = ops.convection_setup(op, wf, fold=(nu, dt), base_e=base_e)
    np.testing.assert_allclose(
        np.asarray(conv1.F_e), np.asarray(conv0.F_e), rtol=1e-12, atol=1e-14
    )


def test_fused_mass_minus_gradient(setup):
    """The projection rhs fusion M h - G p (one element pass + one
    reduction) must equal the two separate applies."""
    space, geom, op = setup
    rng = np.random.default_rng(8)
    h = jnp.asarray(rng.normal(size=(space.n_unodes, space.dim)))
    p = jnp.asarray(rng.normal(size=space.n_pnodes))
    fused = ops.apply_mass_minus_gradient(op, h, p)
    ref = ops.apply_mass(op, h) - ops.apply_gradient(op, p)
    np.testing.assert_allclose(
        np.asarray(fused), np.asarray(ref), rtol=1e-10, atol=1e-12
    )


def test_pregathered_element_views_match(setup):
    """convection_setup(w_e=...) / apply_rhs_and_r0(h_e=, u0_e=) with a
    stacked wide gather (the projection stepper's one-gather fast path)
    must equal the internally-gathered defaults bit for bit."""
    space, geom, op = setup
    rng = np.random.default_rng(12)
    d = space.dim
    h = jnp.asarray(rng.normal(size=(space.n_unodes, d)))
    u0 = jnp.asarray(rng.normal(size=(space.n_unodes, d)))
    w = jnp.asarray(rng.normal(size=(space.n_unodes, d)))
    p = jnp.asarray(rng.normal(size=space.n_pnodes))
    nu, dt = 0.01, 0.05
    st_e = ops.gather_u(op, jnp.concatenate([h, u0, w], axis=1))
    h_e, u0_e, w_e = st_e[..., :d], st_e[..., d:2 * d], st_e[..., 2 * d:]
    conv0 = ops.convection_setup(op, w, fold=(nu, dt))
    conv1 = ops.convection_setup(op, w, fold=(nu, dt), w_e=w_e)
    np.testing.assert_array_equal(np.asarray(conv1.F_e), np.asarray(conv0.F_e))
    np.testing.assert_array_equal(
        np.asarray(conv1.diagC), np.asarray(conv0.diagC)
    )
    b0, r00 = ops.apply_rhs_and_r0(op, h, p, nu, dt, conv0, u0)
    b1, r01 = ops.apply_rhs_and_r0(
        op, h, p, nu, dt, conv1, u0, h_e=h_e, u0_e=u0_e
    )
    np.testing.assert_array_equal(np.asarray(b1), np.asarray(b0))
    np.testing.assert_array_equal(np.asarray(r01), np.asarray(r00))
    # with_diag=False: identical tables, no diagC, diag_F falls back to the
    # convection-free diagonal
    conv2 = ops.convection_setup(op, w, with_diag=False)
    assert conv2.diagC is None
    np.testing.assert_array_equal(np.asarray(conv2.WG), np.asarray(conv0.WG))
    np.testing.assert_allclose(
        np.asarray(ops.diag_F(op, nu, dt, conv2)),
        np.asarray(op.diagM) / dt + nu * np.asarray(op.diagA), rtol=1e-12,
    )


def test_schur(setup):
    space, geom, op = setup
    M, A, D, Mp = dense_blocks(space)
    Dm = D.transpose(0, 2, 1).reshape(space.n_pnodes, -1)  # [(p),(c,i)] -> careful
    # Build dense D over flattened velocity dofs ordered (node, comp).
    Dm = D.reshape(space.n_pnodes, -1)  # [p, i*dim + c] since D is [p, i, c]
    rng = np.random.default_rng(4)
    diagF = rng.uniform(1.0, 2.0, size=space.n_unodes)
    mask = np.asarray(op.dirichlet_mask)
    inv = 1.0 / diagF
    inv_full = np.repeat(inv, space.dim) * ~np.repeat(mask, space.dim)
    S = Dm @ np.diag(inv_full) @ Dm.T
    host = ops.build_operator(
        space, geom, mask, dtype=jnp.float64, want_host_schur=True
    )[1]
    np.testing.assert_allclose(
        np.asarray(ops.schur_diag(host, jnp.asarray(inv), op.dirichlet_mask)),
        np.diag(S), rtol=1e-10, atol=1e-12,
    )
    p = rng.normal(size=space.n_pnodes)
    np.testing.assert_allclose(
        np.asarray(ops.apply_schur(op, jnp.asarray(inv), jnp.asarray(p))),
        S @ p, rtol=1e-9, atol=1e-11,
    )


def test_divergence_theorem(setup):
    """D applied to a linear field integrates div u against each P1 basis;
    summing all pressure rows gives int_Omega div u = boundary flux."""
    space, geom, op = setup
    dim = space.dim
    coords = space.unode_coords
    # u = x  ->  div u = dim
    u = coords.copy()
    total = float(np.asarray(ops.apply_divergence(op, jnp.asarray(u))).sum())
    vol = space.mesh.cell_volumes().sum()
    np.testing.assert_allclose(total, dim * vol, rtol=1e-10)


def test_stiffness_annihilates_linears(setup):
    """A u = 0 at interior rows for linear u (Laplace of linear = 0)."""
    space, geom, op = setup
    coords = space.unode_coords
    u = coords @ np.arange(1.0, space.dim + 1.0)  # scalar linear field
    uv = np.stack([u] * space.dim, axis=1)
    y = np.asarray(ops.apply_stiffness(op, jnp.asarray(uv)))
    interior = ~space.dirichlet_mask(list(range(6)))  # all tags = full boundary
    assert np.abs(y[interior]).max() < 1e-10


def test_halving_plan_matches_table(setup):
    """HalvingPlan reduce == GatherPlan table reduce (same pairwise sums)."""
    from navierstokes_project_nm4pde_tpu.ops.scatter import (
        apply_gather_plan,
        apply_halving_plan,
        build_halving_plan,
    )

    space, geom, op = setup
    rng = np.random.default_rng(3)
    flat = jnp.asarray(
        rng.standard_normal((space.cells_u.size, space.dim)), jnp.float64
    )
    want = apply_gather_plan(op.plan_u, flat)
    for chunk in (4, 8):
        hp = build_halving_plan(
            np.asarray(space.cells_u), space.n_unodes, chunk=chunk
        )
        got = apply_halving_plan(hp, flat)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-12)


def test_windowed_plan_matches_table(setup):
    """WindowedPlan reduce == GatherPlan table reduce, for 1-D and wide
    payloads, across block sizes that exercise block-count padding."""
    from navierstokes_project_nm4pde_tpu.ops.scatter import (
        apply_gather_plan,
        apply_windowed_plan,
        build_windowed_plan,
    )

    space, geom, op = setup
    rng = np.random.default_rng(7)
    n_slots = space.cells_u.size
    for trail in ((), (space.dim,), (2 * space.dim,)):
        flat = jnp.asarray(rng.standard_normal((n_slots,) + trail))
        want = apply_gather_plan(op.plan_u, flat)
        for rpb in (64, 100, 4096):  # 100: ragged final block
            wp = build_windowed_plan(
                np.asarray(space.cells_u), space.n_unodes,
                splits=(space.mesh.n_vertices,), rows_per_block=rpb,
            )
            got = apply_windowed_plan(wp, flat)
            np.testing.assert_allclose(
                np.asarray(got), np.asarray(want), rtol=1e-12, atol=1e-12
            )


def test_vpu_contraction_matches_einsum(setup):
    """contraction='vpu' (broadcast multiply+sum) == the einsum lowering on
    every converted operator (same products, different summation order)."""
    import dataclasses

    space, geom, op = setup
    opv = dataclasses.replace(op, contraction="vpu")
    rng = np.random.default_rng(11)
    u = jnp.asarray(rng.standard_normal((space.n_unodes, space.dim)))
    p = jnp.asarray(rng.standard_normal((space.n_pnodes,)))
    nu, dt = 0.01, 0.1
    conv = ops.convection_setup(op, u, fold=(nu, dt))
    pairs = [
        (ops.apply_mass(op, u), ops.apply_mass(opv, u)),
        (ops.apply_divergence(op, u), ops.apply_divergence(opv, u)),
        (ops.apply_gradient(op, p), ops.apply_gradient(opv, p)),
        (ops.apply_mass_minus_gradient(op, u, p),
         ops.apply_mass_minus_gradient(opv, u, p)),
        (ops.apply_F(op, nu, dt, conv, u), ops.apply_F(opv, nu, dt, conv, u)),
    ]
    b0, r00 = ops.apply_rhs_and_r0(op, u, p, nu, dt, conv, u)
    b1, r01 = ops.apply_rhs_and_r0(opv, u, p, nu, dt, conv, u)
    pairs += [(b0, b1), (r00, r01)]
    for want, got in pairs:
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(want), rtol=1e-11, atol=1e-11
        )


def test_windowed_plan_wired_into_solver():
    """reduce_plan='windowed' produces the same apply_F as the table plan
    (dispatch through apply_gather_plan)."""
    import dataclasses

    from navierstokes_project_nm4pde_tpu.mesh import cube_mesh
    from navierstokes_project_nm4pde_tpu.ops.scatter import (
        build_windowed_plan,
    )

    mesh = cube_mesh(2)
    space = build_taylor_hood(mesh)
    geom = cell_geometry(space)
    mask = space.dirichlet_mask([0])
    op = ops.build_operator(space, geom, mask, dtype=jnp.float64)
    wp = build_windowed_plan(
        np.asarray(space.cells_u), space.n_unodes,
        splits=(mesh.n_vertices,), rows_per_block=128,
    )
    opw = dataclasses.replace(op, plan_u=wp)
    rng = np.random.default_rng(5)
    u = jnp.asarray(rng.standard_normal((space.n_unodes, 3)))
    conv = ops.convection_setup(op, u, fold=(0.01, 0.1))
    y_table = ops.apply_F(op, 0.01, 0.1, conv, u)
    y_windowed = ops.apply_F(opw, 0.01, 0.1, conv, u)
    np.testing.assert_allclose(
        np.asarray(y_windowed), np.asarray(y_table), rtol=1e-12
    )


def test_windowed_gather_matches_plain():
    """gather_plan='windowed' (per-block vertex/edge source windows) is a
    pure re-indexing of u[cells_u]: bit-identical gathers and operator
    applies (ops/scatter.py WindowedGather)."""
    import dataclasses

    from navierstokes_project_nm4pde_tpu.mesh import cube_mesh
    from navierstokes_project_nm4pde_tpu.ops.scatter import (
        apply_windowed_gather,
        build_windowed_gather,
    )

    mesh = cube_mesh(2).reorder_spatial("rcm")
    space = build_taylor_hood(mesh)
    geom = cell_geometry(space)
    mask = space.dirichlet_mask([0])
    op = ops.build_operator(space, geom, mask, dtype=jnp.float64)
    wg = build_windowed_gather(
        np.asarray(space.cells_u), mesh.n_vertices, space.n_unodes,
        cells_per_block=16, align=8,
    )
    opw = dataclasses.replace(op, wgather_u=wg)
    rng = np.random.default_rng(7)
    u = jnp.asarray(rng.standard_normal((space.n_unodes, 3)))
    p = jnp.asarray(rng.standard_normal((space.n_pnodes,)))
    np.testing.assert_array_equal(
        np.asarray(apply_windowed_gather(wg, u)),
        np.asarray(u)[np.asarray(space.cells_u)],
    )
    # wide payload (the stacked [n, 3d] step gather)
    u9 = jnp.concatenate([u, 2 * u, 3 * u], axis=1)
    np.testing.assert_array_equal(
        np.asarray(ops.gather_u(opw, u9)),
        np.asarray(u9)[np.asarray(space.cells_u)],
    )
    conv = ops.convection_setup(op, u, fold=(0.01, 0.1))
    np.testing.assert_array_equal(
        np.asarray(ops.apply_F(opw, 0.01, 0.1, conv, u)),
        np.asarray(ops.apply_F(op, 0.01, 0.1, conv, u)),
    )
    b0, r00 = ops.apply_rhs_and_r0(op, u, p, 0.01, 0.1, conv, u)
    b1, r01 = ops.apply_rhs_and_r0(opw, u, p, 0.01, 0.1, conv, u)
    np.testing.assert_array_equal(np.asarray(b1), np.asarray(b0))
    np.testing.assert_array_equal(np.asarray(r01), np.asarray(r00))


def test_halving_plan_wired_into_solver():
    """reduce_plan='halving' produces the same apply_F as the table plan."""
    import dataclasses

    from navierstokes_project_nm4pde_tpu.ops.scatter import build_halving_plan

    from navierstokes_project_nm4pde_tpu.mesh import cube_mesh

    mesh = cube_mesh(2)
    space = build_taylor_hood(mesh)
    geom = cell_geometry(space)
    mask = space.dirichlet_mask([0])
    op = ops.build_operator(space, geom, mask, dtype=jnp.float64)
    hp = build_halving_plan(np.asarray(space.cells_u), space.n_unodes)
    oph = dataclasses.replace(op, hplan_u=hp)
    rng = np.random.default_rng(5)
    u = jnp.asarray(rng.standard_normal((space.n_unodes, 3)))
    conv = ops.convection_setup(op, u, fold=(0.01, 0.1))
    y_table = ops.apply_F(op, 0.01, 0.1, conv, u)
    y_halving = ops.apply_F(oph, 0.01, 0.1, conv, u)
    np.testing.assert_allclose(
        np.asarray(y_halving), np.asarray(y_table), rtol=1e-12
    )


def test_gradient_weighted_plan_matches_element(setup):
    """grad_apply='ell' (assembled-transpose WeightedPlan) reproduces the
    element-pass gradient on both simplex types, including multi-bucket
    valence grouping (min_rows small enough to force several buckets)."""
    import dataclasses

    space, geom, op = setup
    host = ops.build_operator(
        space, geom, np.asarray(op.dirichlet_mask), dtype=jnp.float64,
        want_host_schur=True,
    )[1]
    rng = np.random.default_rng(11)
    p = jnp.asarray(rng.standard_normal(space.n_pnodes))
    y_elem = np.asarray(ops.apply_gradient(op, p))
    for min_rows in (4, 10**9):  # multi-bucket and single-bucket grouping
        gradt = ops.build_gradient_plan(
            host, space.n_unodes, dtype=jnp.float64, min_rows=min_rows
        )
        opg = dataclasses.replace(op, gradt=gradt)
        np.testing.assert_allclose(
            np.asarray(ops.apply_gradient(opg, p)), y_elem,
            rtol=1e-12, atol=1e-13,
        )


@pytest.mark.parametrize("mode", ["table", "columns"])
def test_vmapped_velocity_reduce_matches_segment_sum(setup, mode):
    """Ensemble members reduce their element contributions through the
    gather-sum plan under vmap (no custom batching rule): B=3 members must
    equal a per-member segment-sum scatter."""
    import jax

    from navierstokes_project_nm4pde_tpu.ops.scatter import (
        apply_gather_plan,
        build_gather_plan_grouped,
    )

    space, geom, op = setup
    cells = np.asarray(space.cells_u)
    plan = build_gather_plan_grouped(
        cells.reshape(-1, 1), space.n_unodes,
        thresholds=tuple(range(2, 97)), mode=mode,
    )
    rng = np.random.default_rng(7)
    flat = jnp.asarray(
        rng.standard_normal((3, cells.size, space.dim)), jnp.float64
    )
    got = jax.jit(
        jax.vmap(lambda f: apply_gather_plan(plan, f))
    )(flat)
    want = jax.vmap(
        lambda f: jax.ops.segment_sum(
            f, jnp.asarray(cells.reshape(-1)), num_segments=space.n_unodes
        )
    )(flat)
    assert got.shape == (3, space.n_unodes, space.dim)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=1e-12, atol=1e-12
    )
    # the vmapped scatter_u (element view) takes the same route
    y_e = flat.reshape(3, cells.shape[0], cells.shape[1], space.dim)
    got_e = jax.vmap(lambda y: ops.scatter_u(op, y))(y_e)
    np.testing.assert_allclose(
        np.asarray(got_e), np.asarray(want), rtol=1e-12, atol=1e-12
    )
