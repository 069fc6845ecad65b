"""Split the folded apply_F cost at bench scale: gather / contraction /
reduce, plus windowed-gather variants (scripts/prof_window_gather.py).

Usage: python scripts/prof_apply_split.py [lc] [nz]   (default 609k mesh)
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

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
from navierstokes_project_nm4pde_tpu.ops.operators import _emv
from navierstokes_project_nm4pde_tpu.ops.scatter import apply_gather_plan

from prof_window_gather import build_windows

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
    E, nloc = op.cells_u.shape
    print(f"# {E} cells, {solver.space.n_dofs} DoFs", file=sys.stderr)

    key = jax.random.PRNGKey(0)
    u0 = jax.random.normal(key, (n, d), dtype=jnp.float32)
    conv = ops.convection_setup(op, u0, backflow=dev.backflow,
                                fold=(nu, dt_eff),
                                w_e=ops.gather_u(op, u0), with_diag=False)
    F_e = conv.F_e

    base = timeit(lambda v: v + 1.0, u0)
    r = {}

    def pick(y_e):  # collapse an element array to a u-shaped output
        return jnp.broadcast_to(jnp.sum(y_e.reshape(-1)), (n, d))

    r["gather"] = timeit(lambda v: pick(ops.gather_u(op, v)), u0)
    r["gather+emv"] = timeit(
        lambda v: pick(_emv(F_e, ops.gather_u(op, v))), u0)
    r["full apply_F"] = timeit(
        lambda v: ops.apply_F(op, nu, dt_eff, conv, v), u0)
    r["reduce only"] = timeit(
        lambda v: apply_gather_plan(
            op.plan_u,
            (ops.gather_u(op, v)).reshape(-1, d),
        ) - ops.gather_u(op, v)[0, 0] * 0.0, u0)

    cells_np = np.asarray(op.cells_u)
    vs, es, local, Wv, We, nb, _ = build_windows(
        cells_np, mesh.n_vertices, n, 4096
    )

    def wgather(v):
        def body(carry, blk):
            v0, e0, tab = blk
            wv = jax.lax.dynamic_slice(v, (v0, 0), (Wv, d))
            we = jax.lax.dynamic_slice(v, (e0, 0), (We, d))
            win = jnp.concatenate([wv, we], axis=0)
            return carry, win[tab]
        _, o = jax.lax.scan(body, None, (vs, es, local))
        return o.reshape(-1, nloc, d)[:E]

    r["wgather"] = timeit(lambda v: pick(wgather(v)), u0)
    r["wgather+emv"] = timeit(lambda v: pick(_emv(F_e, wgather(v))), u0)

    def wgather_emv_fused(v):
        def body(carry, blk):
            v0, e0, tab, fe = blk
            wv = jax.lax.dynamic_slice(v, (v0, 0), (Wv, d))
            we = jax.lax.dynamic_slice(v, (e0, 0), (We, d))
            win = jnp.concatenate([wv, we], axis=0)
            return carry, _emv(fe, win[tab])
        F_blk = jnp.concatenate(
            [F_e, jnp.zeros((nb * 4096 - E, nloc, nloc), F_e.dtype)]
        ).reshape(nb, 4096, nloc, nloc)
        _, o = jax.lax.scan(body, None, (vs, es, local, F_blk))
        return o.reshape(-1, nloc, d)[:E]

    r["wgather+emv fused-in-scan"] = timeit(
        lambda v: pick(wgather_emv_fused(v)), u0)

    for k, v in r.items():
        print(f"{k:28s} {v - base:8.2f} ms")
    print(f"{'(baseline)':28s} {base:8.2f} ms")


if __name__ == "__main__":
    main()
