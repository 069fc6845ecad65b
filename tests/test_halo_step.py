"""A full projection time step under the owned+halo plan vs single-device.

parallel/halo_step.py carries the reference's owned/ghost execution model
(ref: src/NavierStokes2D.cpp:71-87, :315-320) through a COMPLETE production
step: velocity FGMRES with psum'd reductions and halo ppermutes, replicated
frozen-Schur CG, halo-reduced projection update.  The equality bar is the
same as the cell-sharded replicated-path tests (tests/test_parallel.py).
Covers both the plain config and the judged-bench one (guess_order-2
warm-start extrapolation + recycled frozen-Schur projection space).
"""

import numpy as np
import pytest

from navierstokes_project_nm4pde_tpu.config import (
    NumericsConfig,
    PrecondConfig,
    RunConfig,
    SolverConfig,
    TimeConfig,
)
from navierstokes_project_nm4pde_tpu.mesh import cylinder_duct_3d
from navierstokes_project_nm4pde_tpu.models import (
    Cylinder3DProblem,
    NavierStokesSolver,
)
from navierstokes_project_nm4pde_tpu.parallel import make_device_mesh
from navierstokes_project_nm4pde_tpu.parallel.halo import (
    collective_bytes_per_apply,
)
from navierstokes_project_nm4pde_tpu.parallel.halo_step import (
    HaloProjectionStep,
)


def _cfg(extrapolate=False, guess_order=1, s_recycle=0):
    return RunConfig(
        time=TimeConfig(dt=1e-3, t_end=1.0, stepper="projection"),
        solver=SolverConfig(rtol=1e-10, restart=8, maxiter=80,
                            tol_mode="b", extrapolate_guess=extrapolate,
                            guess_order=guess_order),
        precond=PrecondConfig(kind="yosida", f_iters=0, s_iters=3,
                              mg2_form="additive", s_recycle=s_recycle),
        numerics=NumericsConfig(
            dtype="float64", precise_dots=False, steps_per_chunk=1,
            proj_schur="frozen", schur_spmv="auto",
        ),
    )


def _run_both(cfg, n_steps):
    mesh = cylinder_duct_3d(lc=0.3, nz=3)
    problem = Cylinder3DProblem(test_case=2)

    s1 = NavierStokesSolver(mesh, problem, cfg)
    state1, d1 = s1.run(n_steps)

    s2 = NavierStokesSolver(mesh, problem, cfg)
    hs = HaloProjectionStep(s2, make_device_mesh(8))
    st = hs.init_state()
    iters = []
    for _ in range(n_steps):
        st, (itf, its) = hs(st)
        iters.append((int(itf), int(its)))
    u = np.asarray(hs.unshard(st.u))
    return state1, u, np.asarray(st.p), iters


def test_halo_projection_step_matches_single_device():
    state1, u, p, iters = _run_both(_cfg(), 2)
    assert all(f > 0 and s > 0 for f, s in iters), iters
    # Both paths converge to atol ~ rtol*||b|| through DIFFERENT summation
    # orders (halo slab reduces + psum'd dots vs global gather-sum plans),
    # so states agree to the solver tolerance, not to fp: the observed max
    # deviation is ~1e-9 absolute at rtol=1e-10.
    np.testing.assert_allclose(
        u, np.asarray(state1.u), rtol=1e-6, atol=5e-9
    )
    np.testing.assert_allclose(
        p, np.asarray(state1.p), rtol=1e-6, atol=5e-8
    )


def test_halo_step_judged_config_matches_single_device():
    """Judged-bench parity: guess_order=2 warm-start extrapolation and the
    recycled frozen-Schur pool, 3 steps so every gate (not_first,
    not_second, a non-trivial spool) is exercised."""
    cfg = _cfg(extrapolate=True, guess_order=2, s_recycle=3)
    state1, u, p, iters = _run_both(cfg, 3)
    assert all(f > 0 for f, _ in iters), iters
    np.testing.assert_allclose(
        u, np.asarray(state1.u), rtol=1e-6, atol=5e-9
    )
    np.testing.assert_allclose(
        p, np.asarray(state1.p), rtol=1e-6, atol=5e-8
    )


def test_halo_step_collective_volume_bounded():
    """The halo step's velocity-space collectives move boundary slabs, not
    global vectors: the per-apply exchanged volume must be a small
    fraction of the replicated path's full-vector all-reduce."""
    mesh = cylinder_duct_3d(lc=0.3, nz=3)
    problem = Cylinder3DProblem(test_case=2)
    s = NavierStokesSolver(mesh, problem, _cfg())
    hs = HaloProjectionStep(s, make_device_mesh(8))
    vol = collective_bytes_per_apply(hs.plan, s.space.dim, itemsize=8)
    assert vol["ratio"] < 0.5, vol


def _dot_precisions(jaxpr):
    """Precision of every dot_general in a (closed) jaxpr, recursing into
    sub-jaxprs (jit, scan, while, cond, shard_map, custom rules)."""
    from jax.extend import core as jex_core

    out = []
    jaxpr = getattr(jaxpr, "jaxpr", jaxpr)
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params.get("precision"))
        for v in eqn.params.values():
            for sub in v if isinstance(v, (tuple, list)) else (v,):
                if isinstance(sub, (jex_core.Jaxpr, jex_core.ClosedJaxpr)):
                    out.extend(_dot_precisions(sub))
    return out


def _traced_steps(which):
    """The jaxpr of one program under the default NumericsConfig."""
    import jax
    import jax.numpy as jnp

    cfg = RunConfig(
        time=TimeConfig(dt=2e-4, t_end=1.0, stepper="projection"),
        solver=SolverConfig(rtol=1e-6, restart=8, maxiter=60,
                            tol_mode="b", guess_order=2),
        precond=PrecondConfig(kind="yosida", f_iters=0, s_iters=3,
                              mg2_form="additive", freeze_conv_diag=True),
        numerics=NumericsConfig(dtype="float32", precise_dots=False,
                                reduce_plan="columns"),
    )
    assert cfg.numerics.matmul_precision == "highest"
    s = NavierStokesSolver(
        cylinder_duct_3d(lc=0.3, nz=3), Cylinder3DProblem(test_case=2), cfg
    )
    if which == "solver.step":
        assert s._dev.macro is not None  # the macro / one-hot einsums traced
        return jax.make_jaxpr(lambda st, dev: s.step(st, dev=dev))(
            s.initial_state(), s._dev
        )
    dmesh = make_device_mesh(8)
    if which == "halo step":
        hs = HaloProjectionStep(s, dmesh)
        return jax.make_jaxpr(hs._step_jit)(hs._consts, hs.init_state())
    from navierstokes_project_nm4pde_tpu.ops import operators as ops
    from navierstokes_project_nm4pde_tpu.parallel.halo import (
        build_halo_plan,
        halo_apply_system,
        shard_vectors,
    )
    from navierstokes_project_nm4pde_tpu.parallel.sharding import (
        _pad_cells,
        shard_operator,
    )

    op = s.op
    plan = build_halo_plan(
        _pad_cells(op, 8), 8, n_vertices=s.space.mesh.n_vertices
    )
    op_sh = shard_operator(op, dmesh)
    w = jnp.ones((s.space.n_unodes, 3), jnp.float32)
    conv = ops.convection_setup(op_sh, w)
    u_sh, p_sh = shard_vectors(
        plan, dmesh, w, jnp.ones(s.space.n_pnodes, jnp.float32)
    )
    return jax.make_jaxpr(
        lambda a, b: halo_apply_system(
            op_sh, plan, dmesh, 1e-3, 2e-4, conv, a, b
        )
    )(u_sh, p_sh)


@pytest.mark.parametrize("which", ["solver.step", "halo step", "halo apply"])
def test_every_dot_general_runs_at_highest_precision(which):
    """Under the default NumericsConfig (matmul_precision="highest") every
    matmul the single-device step, the owned+halo step and the halo apply
    trace carries Precision.HIGHEST -- none falls back to the backend
    default (TF32 operands on the GPU)."""
    import jax

    highest = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    precs = _dot_precisions(_traced_steps(which))
    assert precs
    assert all(p == highest for p in precs), set(precs)
