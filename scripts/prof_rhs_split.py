"""Sub-split the fused rhs/r0 pass (apply_rhs_and_r0) at bench scale:
p-gather, contractions, concat, and the 3- vs 6-channel velocity reduce.

Usage: python scripts/prof_rhs_split.py [lc] [nz]   (default 609k mesh)
"""
from __future__ import annotations

import sys
import time

sys.path.insert(0, __import__("os").path.dirname(
    __import__("os").path.dirname(__import__("os").path.abspath(__file__))))

import jax
import jax.numpy as jnp

from navierstokes_project_nm4pde_tpu.config import (
    NumericsConfig, PrecondConfig, RunConfig, SolverConfig, TimeConfig,
)
from navierstokes_project_nm4pde_tpu.mesh import cylinder_duct_3d
from navierstokes_project_nm4pde_tpu.models import (
    Cylinder3DProblem, NavierStokesSolver,
)
from navierstokes_project_nm4pde_tpu.ops import operators as ops
from navierstokes_project_nm4pde_tpu.ops.operators import _emv, _grad_p_e
from navierstokes_project_nm4pde_tpu.ops.scatter import apply_gather_plan

REPS = 20


def timeit(f, u0):
    def prog(u):
        def body(_, v):
            out = f(v)
            return out / (1e-30 + jnp.max(jnp.abs(out)))
        return jnp.sum(jax.lax.fori_loop(0, REPS, body, u0))

    jprog = jax.jit(prog)
    float(jprog(u0))
    float(jprog(u0))
    t0 = time.perf_counter()
    float(jprog(u0))
    return (time.perf_counter() - t0) / REPS * 1e3


def main():
    lc = float(sys.argv[1]) if len(sys.argv) > 1 else 0.028
    nz = int(sys.argv[2]) if len(sys.argv) > 2 else 12
    mesh = cylinder_duct_3d(lc=lc, nz=nz)
    cfg = RunConfig(
        time=TimeConfig(dt=2e-4, t_end=4.0, stepper="projection"),
        solver=SolverConfig(rtol=1e-6, restart=8, maxiter=60, tol_mode="b",
                            guess_order=2),
        precond=PrecondConfig(kind="yosida", f_iters=0, s_iters=3,
                              s_solver="mg2_cg", freeze_conv_diag=True,
                              mg2_form="additive"),
        numerics=NumericsConfig(dtype="float32", precise_dots=False,
                                reduce_plan="columns",
                                matmul_precision="highest",
                                proj_schur="frozen", schur_spmv="auto",
                                element_contraction="vpu"),
    )
    solver = NavierStokesSolver(mesh, Cylinder3DProblem(test_case=2), cfg)
    op = solver.op
    dev = solver._dev
    nu, dt_eff = solver.problem.nu, 2.0 * cfg.time.dt / 3.0
    n, d = solver.space.n_unodes, solver.space.dim
    n_p = solver.space.n_pnodes
    E, nloc = op.cells_u.shape
    print(f"# {E} cells, {solver.space.n_dofs} DoFs", file=sys.stderr)

    key = jax.random.PRNGKey(0)
    u0 = jax.random.normal(key, (n, d), dtype=jnp.float32)
    p0 = jax.random.normal(key, (n_p,), dtype=jnp.float32)
    conv = ops.convection_setup(op, u0, backflow=dev.backflow,
                                fold=(nu, dt_eff),
                                w_e=ops.gather_u(op, u0), with_diag=False)
    F_e = conv.F_e

    base = timeit(lambda v: v + 1.0, u0)
    r = {}

    def pick(y_e):
        return jnp.broadcast_to(jnp.sum(y_e.reshape(-1)), (n, d))

    # pieces (each includes the driving u-gather where noted)
    r["u gather"] = timeit(lambda v: pick(ops.gather_u(op, v)), u0)
    r["p gather (v-dep)"] = timeit(
        lambda v: pick(ops.gather_p(op, p0 + v[0, 0])), u0)
    r["+emv MHAT"] = timeit(
        lambda v: pick(_emv(op.MHAT, ops.gather_u(op, v))), u0)
    r["+emv MHAT +grad_p +emv F_e"] = timeit(
        lambda v: pick(
            (_emv(op.MHAT, ops.gather_u(op, v))
             + _grad_p_e(op, ops.gather_p(op, p0 + v[0, 0])))
            * op.detJ[:, None, None]
            + _emv(F_e, ops.gather_u(op, v))
        ), u0)

    def red(ch):
        def f(v):
            u_e = ops.gather_u(op, v)
            y_e = _emv(F_e, u_e)
            y_e = jnp.concatenate([y_e] * (ch // d), axis=-1)
            y = apply_gather_plan(op.plan_u, y_e.reshape(-1, ch))
            return jnp.broadcast_to(jnp.sum(y), (n, d))
        return f

    r["gather+emv+reduce 3ch"] = timeit(red(3), u0)
    r["gather+emv+reduce 6ch"] = timeit(red(6), u0)
    r["gather+emv+reduce 9ch"] = timeit(red(9), u0)

    def full(v):
        ve = ops.gather_u(op, v)
        b, r0 = ops.apply_rhs_and_r0(op, v, p0 + v[0, 0], nu, dt_eff, conv,
                                     v, h_e=ve, u0_e=ve)
        return v + (b + r0) * 0.5

    r["full apply_rhs_and_r0"] = timeit(full, u0)

    for k, v in r.items():
        print(f"{k:32s} {v - base:8.2f} ms")
    print(f"{'(baseline)':32s} {base:8.2f} ms")


if __name__ == "__main__":
    main()
