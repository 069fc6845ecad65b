"""Per-iteration cost of the frozen-Schur CG at bench scale.

One CG iteration = banded SpMV + additive two-level apply +
dots/updates.  This script measures the ms/iter of the FULL loop
(fixed-iteration CG, baseline-subtracted) and its components, to decide
whether a fused iteration kernel would pay.

Usage: python scripts/prof_schur_iter.py [lc] [nz]   (default 965k mesh)
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

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
from navierstokes_project_nm4pde_tpu.ops.banded import banded_matvec
from navierstokes_project_nm4pde_tpu.ops.coarse import (
    inv_solve_c,
    cho_solve_c,
    twolevel_apply_additive_g,
)
from navierstokes_project_nm4pde_tpu.solvers.krylov import cg

REPS = 10


def timeit(f, data, x0, reps=REPS):
    def prog(dd, v):
        def body(_, vv):
            out = f(dd, vv)
            return vv * (1.0 + 1e-30 * jnp.max(jnp.abs(out)))

        return jnp.sum(jax.lax.fori_loop(0, reps, body, v))

    jp = jax.jit(prog)
    float(jp(data, x0))
    float(jp(data, x0))
    t0 = time.perf_counter()
    float(jp(data, x0))
    return (time.perf_counter() - t0) / reps * 1e3


def main():
    lc = float(sys.argv[1]) if len(sys.argv) > 1 else 0.024
    nz = int(sys.argv[2]) if len(sys.argv) > 2 else 14
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
                                proj_schur="frozen", schur_spmv="auto"),
    )
    solver = NavierStokesSolver(mesh, Cylinder3DProblem(test_case=2), cfg)
    op = solver.op
    fz = solver._dev.proj_schur
    assert fz is not None and fz.band is not None
    n_p = solver.space.n_pnodes
    band = fz.band
    print(f"# {solver.space.n_dofs} DoFs, n_p={n_p}, band vals "
          f"{band.vals.shape} = {band.vals.size * 4 / 1e6:.0f} MB, "
          f"tiles {band.tiles.shape}", file=sys.stderr)

    solve_c = (
        inv_solve_c(fz.inv_c) if fz.inv_c is not None
        else cho_solve_c((fz.cho_L, True))
    )
    inv_d = 1.0 / fz.diag1

    p0 = jax.random.normal(jax.random.PRNGKey(0), (n_p,), jnp.float32)

    base = timeit(lambda dd, v: v + 1.0, None, p0)
    print(f"baseline               : {base:7.3f} ms")
    t_spmv = timeit(lambda bd, v: banded_matvec(bd, v), band, p0)
    print(f"banded SpMV            : {t_spmv - base:7.3f} ms")
    t_m2 = timeit(
        lambda cs, v: twolevel_apply_additive_g(cs, solve_c, inv_d, v),
        op.coarse, p0,
    )
    print(f"additive two-level     : {t_m2 - base:7.3f} ms")

    def dots(dd, v):
        a = jnp.vdot(v, v)
        b = jnp.vdot(v, v + 1.0)
        return v * (a / b)

    t_dots = timeit(dots, None, p0)
    print(f"two dots + axpy        : {t_dots - base:7.3f} ms")

    # Full fixed-iteration CG: rtol 0 forces exactly `iters` iterations.
    for iters in (8, 16):
        def run_cg(data, v):
            bd, cs = data
            x, info = cg(
                lambda pv: banded_matvec(bd, pv),
                v,
                M=lambda rv: twolevel_apply_additive_g(cs, solve_c, inv_d, rv),
                rtol=0.0, atol=0.0, maxiter=iters, precise=False,
            )
            return x

        t_cg = timeit(run_cg, (band, op.coarse), p0, reps=4)
        print(f"cg maxiter={iters:3d}         : {t_cg - base:7.3f} ms "
              f"({(t_cg - base) / iters:.3f} ms/iter)")


if __name__ == "__main__":
    main()
