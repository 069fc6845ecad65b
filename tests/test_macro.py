"""Macro-element block-dense F (ops/macroblock.py).

F~ must be EXACTLY the assembled operator F (same values, different
summation order): unit equality against apply_F, and a full projection
step through the solver fast path against the element fallback.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np

from navierstokes_project_nm4pde_tpu.config import (
    NumericsConfig,
    PrecondConfig,
    RunConfig,
    SolverConfig,
    TimeConfig,
)
from navierstokes_project_nm4pde_tpu.fem.geometry import cell_geometry
from navierstokes_project_nm4pde_tpu.fem.space import build_taylor_hood
from navierstokes_project_nm4pde_tpu.mesh import cylinder_duct_3d
from navierstokes_project_nm4pde_tpu.models import (
    Cylinder3DProblem,
    NavierStokesSolver,
)
from navierstokes_project_nm4pde_tpu.ops import operators as ops
from navierstokes_project_nm4pde_tpu.ops.macroblock import (
    apply_macro,
    build_macro_plan,
    build_macro_values,
)


def test_macro_apply_matches_apply_F():
    mesh = cylinder_duct_3d(lc=0.25, nz=3).reorder_spatial("rcm")
    space = build_taylor_hood(mesh)
    geom = cell_geometry(space)
    mask = space.dirichlet_mask([0, 2, 4])
    op = ops.build_operator(space, geom, np.asarray(mask), dtype=jnp.float64)
    nu, dt = 1e-3, 2e-4
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.normal(size=(space.n_unodes, space.dim)))
    w = jnp.asarray(rng.normal(size=(space.n_unodes, space.dim)))
    conv = ops.convection_setup(op, w, fold=(nu, dt))
    y_ref = np.asarray(ops.apply_F(op, nu, dt, conv, u))

    mp = build_macro_plan(
        np.asarray(space.cells_u), space.n_unodes, U=128, c_blk=20,
        n_vertices=mesh.n_vertices,
    )
    assert mp.B * mp.c_blk >= mesh.n_cells
    y = np.asarray(apply_macro(mp, build_macro_values(mp, conv.F_e), u))
    np.testing.assert_allclose(y, y_ref, rtol=1e-13, atol=1e-13)


def test_macro_split3_build_matches_highest():
    """The exact-bf16 3-split build reproduces the HIGHEST build to f32
    summation-order tolerance (the one-hot operand is exact in bf16 and
    each placed value splits exactly into hi/mid/lo bf16 parts)."""
    from navierstokes_project_nm4pde_tpu.ops.macroblock import (
        build_macro_values_split3,
    )

    mesh = cylinder_duct_3d(lc=0.25, nz=3).reorder_spatial("rcm")
    space = build_taylor_hood(mesh)
    mp = build_macro_plan(
        np.asarray(space.cells_u), space.n_unodes, U=128, c_blk=20,
        n_vertices=mesh.n_vertices,
    )
    rng = np.random.default_rng(1)
    E, nloc = space.cells_u.shape
    F_e = jnp.asarray(
        rng.normal(size=(E, nloc, nloc)) * 10.0 ** rng.uniform(
            -3, 3, size=(E, 1, 1)
        ),
        jnp.float32,
    )
    ref = np.asarray(build_macro_values(mp, F_e), np.float64)
    out = np.asarray(build_macro_values_split3(mp, F_e), np.float64)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out, ref, rtol=2e-6, atol=2e-6 * scale)


def test_macro_rhs_and_r0_matches_element_pass():
    """(M hist, F u0) from the dual-channel macro pass equal the element
    fused rhs/r0 pass (with p = 0 the element b is exactly M hist, and
    b - r0 is exactly F u0)."""
    from navierstokes_project_nm4pde_tpu.ops.macroblock import (
        apply_rhs_and_r0_macro,
    )

    mesh = cylinder_duct_3d(lc=0.25, nz=3).reorder_spatial("rcm")
    space = build_taylor_hood(mesh)
    geom = cell_geometry(space)
    mask = space.dirichlet_mask([0, 2, 4])
    op = ops.build_operator(space, geom, np.asarray(mask), dtype=jnp.float64)
    nu, dt = 1e-3, 2e-4
    rng = np.random.default_rng(2)
    hist = jnp.asarray(rng.normal(size=(space.n_unodes, space.dim)))
    u0 = jnp.asarray(rng.normal(size=(space.n_unodes, space.dim)))
    w = jnp.asarray(rng.normal(size=(space.n_unodes, space.dim)))
    conv = ops.convection_setup(op, w, fold=(nu, dt))
    p0 = jnp.zeros(space.n_pnodes, jnp.float64)
    b_ref, r0_ref = ops.apply_rhs_and_r0(op, hist, p0, nu, dt, conv, u0)

    mp = build_macro_plan(
        np.asarray(space.cells_u), space.n_unodes, U=128, c_blk=20,
        n_vertices=mesh.n_vertices,
    )
    M_e = op.MHAT[None, :, :] * op.detJ[:, None, None]
    Mt = build_macro_values(mp, M_e)
    Ft = build_macro_values(mp, conv.F_e)
    Mh, Fu0 = apply_rhs_and_r0_macro(mp, Mt, Ft, hist, u0)
    np.testing.assert_allclose(
        np.asarray(Mh), np.asarray(b_ref), rtol=1e-12, atol=1e-13
    )
    np.testing.assert_allclose(
        np.asarray(Fu0), np.asarray(b_ref - r0_ref), rtol=1e-11, atol=1e-12
    )


def _cfg(f_apply):
    return RunConfig(
        time=TimeConfig(dt=1e-3, t_end=1.0, stepper="projection"),
        solver=SolverConfig(rtol=1e-11, restart=20, maxiter=100,
                            tol_mode="b", guess_order=2),
        precond=PrecondConfig(kind="yosida", f_iters=0, s_iters=3,
                              mg2_form="additive"),
        numerics=NumericsConfig(
            dtype="float64", precise_dots=False, steps_per_chunk=2,
            f_apply=f_apply,
        ),
    )


def test_macro_projection_step_matches_element():
    """Full projection steps through the solver: macro fast path vs the
    element fold fallback (identical operator)."""
    mesh = cylinder_duct_3d(lc=0.22, nz=3)
    problem = Cylinder3DProblem(test_case=2)
    s_fast = NavierStokesSolver(mesh, problem, _cfg("macro"))
    assert s_fast._macro is not None
    st_fast, _ = s_fast.run(2)
    s_ref = NavierStokesSolver(mesh, problem, _cfg("element"))
    assert s_ref._macro is None
    st_ref, _ = s_ref.run(2)
    np.testing.assert_allclose(
        np.asarray(st_fast.u), np.asarray(st_ref.u), rtol=1e-8, atol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(st_fast.p), np.asarray(st_ref.p), rtol=1e-7, atol=1e-9
    )


def test_macro_split_projection_step_matches_unsplit():
    """K/C split (setup-time mass/stiffness macros + per-step conv-only
    fold) vs the unsplit per-step full-F build: the combine is linear, so
    with the exact conv engine the steps agree to summation order."""
    mesh = cylinder_duct_3d(lc=0.22, nz=3)
    problem = Cylinder3DProblem(test_case=2)
    cfg = _cfg("macro")
    cfg_split = dataclasses.replace(
        cfg,
        numerics=dataclasses.replace(
            cfg.numerics, macro_split="on", macro_conv_build="highest"
        ),
    )
    s_split = NavierStokesSolver(mesh, problem, cfg_split)
    assert s_split._macro_stiff is not None
    st_split, d_split = s_split.run(2)
    s_ref = NavierStokesSolver(mesh, problem, cfg)
    assert s_ref._macro_stiff is None
    st_ref, d_ref = s_ref.run(2)
    np.testing.assert_allclose(
        np.asarray(st_split.u), np.asarray(st_ref.u), rtol=1e-8, atol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(st_split.p), np.asarray(st_ref.p), rtol=1e-7, atol=1e-9
    )


def test_macro_wide_blocks_match_apply_F():
    """U=256 blocks (the int16 slot-table path; int8 wraps above 127)
    must produce the same operator as U=128 and the element apply."""
    mesh = cylinder_duct_3d(lc=0.25, nz=3).reorder_spatial("rcm")
    space = build_taylor_hood(mesh)
    geom = cell_geometry(space)
    mask = space.dirichlet_mask([0, 2, 4])
    op = ops.build_operator(space, geom, np.asarray(mask), dtype=jnp.float64)
    nu, dt = 1e-3, 2e-4
    rng = np.random.default_rng(3)
    u = jnp.asarray(rng.normal(size=(space.n_unodes, space.dim)))
    w = jnp.asarray(rng.normal(size=(space.n_unodes, space.dim)))
    conv = ops.convection_setup(op, w, fold=(nu, dt))
    y_ref = np.asarray(ops.apply_F(op, nu, dt, conv, u))
    mp = build_macro_plan(
        np.asarray(space.cells_u), space.n_unodes, U=256, c_blk=48,
        n_vertices=mesh.n_vertices,
    )
    assert int(np.asarray(mp.uidx).max()) <= space.n_unodes
    y = np.asarray(apply_macro(mp, build_macro_values(mp, conv.F_e), u))
    np.testing.assert_allclose(y, y_ref, rtol=1e-13, atol=1e-13)


def test_slot_expand_elem_matches_gather():
    """The one-hot expansion of a slot view must reproduce the
    forward element gather BITWISE: f32 rides the exact 3-way bf16 split
    (products one-hot-selected, recombination restores the mantissa),
    f64 goes through a HIGHEST einsum on exact 0/1 operands."""
    from navierstokes_project_nm4pde_tpu.ops.macroblock import (
        slot_expand_elem,
        slot_gather,
    )

    mesh = cylinder_duct_3d(lc=0.25, nz=3).reorder_spatial("rcm")
    space = build_taylor_hood(mesh)
    mp = build_macro_plan(
        np.asarray(space.cells_u), space.n_unodes, U=128, c_blk=20,
        n_vertices=mesh.n_vertices,
    )
    rng = np.random.default_rng(7)
    for dt in (np.float32, np.float64):
        w = jnp.asarray(rng.normal(size=(space.n_unodes, 3)).astype(dt))
        w_e_ref = w[jnp.asarray(np.asarray(space.cells_u))]
        w_e = slot_expand_elem(mp, slot_gather(mp, w))
        assert w_e.dtype == w.dtype
        np.testing.assert_array_equal(np.asarray(w_e), np.asarray(w_e_ref))


def test_macro_wfuse_off_matches_on():
    """Fused up-front slot gather (macro_wfuse) vs separate gathers: the
    expansion is bit-exact and the rhs pass sees identical slot values,
    so full projection steps agree bitwise-tight."""
    mesh = cylinder_duct_3d(lc=0.22, nz=3)
    problem = Cylinder3DProblem(test_case=2)
    cfg_on = _cfg("macro")
    cfg_off = dataclasses.replace(
        cfg_on,
        numerics=dataclasses.replace(cfg_on.numerics, macro_wfuse="off"),
    )
    st_on, _ = NavierStokesSolver(mesh, problem, cfg_on).run(2)
    st_off, _ = NavierStokesSolver(mesh, problem, cfg_off).run(2)
    np.testing.assert_allclose(
        np.asarray(st_on.u), np.asarray(st_off.u), rtol=1e-12, atol=1e-14
    )
    np.testing.assert_allclose(
        np.asarray(st_on.p), np.asarray(st_off.p), rtol=1e-12, atol=1e-14
    )


def test_macro_apply_split3_matches_highest():
    """Pre-split bf16 apply engine: the six significance products must
    reproduce the HIGHEST-emulation apply to its own error class
    (~1e-8 relative -- products exact, f32 summation order differs)."""
    from navierstokes_project_nm4pde_tpu.ops.macroblock import (
        apply_macro_split3,
        split3_values,
    )

    mesh = cylinder_duct_3d(lc=0.25, nz=3).reorder_spatial("rcm")
    space = build_taylor_hood(mesh)
    mp = build_macro_plan(
        np.asarray(space.cells_u), space.n_unodes, U=128, c_blk=20,
        n_vertices=mesh.n_vertices,
    )
    rng = np.random.default_rng(11)
    E = space.cells_u.shape[0]
    nl = space.cells_u.shape[1]
    F_e = jnp.asarray(
        rng.normal(size=(E, nl, nl)).astype(np.float32)
    ) / nl
    u = jnp.asarray(
        rng.normal(size=(space.n_unodes, 3)).astype(np.float32)
    )
    Ft = build_macro_values(mp, F_e)
    y_ref = apply_macro(mp, Ft, u)
    y = apply_macro_split3(mp, split3_values(Ft), u)
    err = float(
        np.linalg.norm(np.asarray(y - y_ref))
        / np.linalg.norm(np.asarray(y_ref))
    )
    assert err < 5e-7, err
