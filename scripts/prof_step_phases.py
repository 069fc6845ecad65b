"""Per-phase cost accounting of one projection step at bench scale.

Times every device phase of models/base._step_projection individually
(chained fori_loops, baseline-subtracted, a host readback as the
completion barrier) and prints an accounting table against the measured
warm step time.

Usage: python scripts/prof_step_phases.py [lc] [nz]
       (defaults to the 965k bench mesh lc=0.024 nz=14)
"""
from __future__ import annotations

import json
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
from navierstokes_project_nm4pde_tpu.ops import operators as ops
from navierstokes_project_nm4pde_tpu.ops import functionals as fn
from navierstokes_project_nm4pde_tpu.ops.banded import banded_matvec
from navierstokes_project_nm4pde_tpu.ops.coarse import (
    cho_solve_c,
    inv_solve_c,
    twolevel_apply_additive_g,
)

REPS = 20


def timeit(f, data, u0):
    # NOTE: the program returns a SCALAR that the host reads back with
    # float() -- a value data-dependent on the whole chain, so the timer
    # stops after the device finished.
    def prog(dd, u):
        def body(_, v):
            out = f(dd, v)
            return out / (1e-30 + jnp.max(jnp.abs(out)))

        return jnp.sum(jax.lax.fori_loop(0, REPS, body, u))

    jprog = jax.jit(prog)
    float(jprog(data, u0))  # compile
    float(jprog(data, u0))  # second warm run
    t0 = time.perf_counter()
    float(jprog(data, u0))
    return (time.perf_counter() - t0) / REPS * 1e3


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
                                reduce_plan="columns", matmul_precision="highest",
                                proj_schur="frozen", schur_spmv="auto"),
    )
    solver = NavierStokesSolver(mesh, Cylinder3DProblem(test_case=2), cfg)
    op = solver.op
    dev = solver._dev
    fz = dev.proj_schur
    nu = solver.problem.nu
    dt = cfg.time.dt
    dt_eff = 2.0 * dt / 3.0  # BDF2 warm steps
    n, d = solver.space.n_unodes, solver.space.dim
    n_p = solver.space.n_pnodes
    print(f"# {mesh.n_cells} cells, {solver.space.n_dofs} DoFs",
          file=sys.stderr)

    key = jax.random.PRNGKey(0)
    u0 = jax.random.normal(key, (n, d), dtype=jnp.float32)
    p0 = jax.random.normal(key, (n_p,), dtype=jnp.float32)
    w_e0 = ops.gather_u(op, u0)
    conv = ops.convection_setup(op, u0, backflow=dev.backflow,
                                fold=(nu, dt_eff), w_e=w_e0, with_diag=False)

    r = {}
    r["baseline_u"] = timeit(lambda dd, v: v + 1.0, None, u0)
    base_p = timeit(lambda dd, v: v + 1.0, None, p0)

    # 1. stacked [n, 3d] velocity gather (hist/u0/w)
    def stacked_gather(dd, v):
        st = jnp.concatenate([v, v, v], axis=1)
        st_e = ops.gather_u(dd, st)
        s = jnp.sum(st_e, axis=(0, 1))
        return v + s[None, :d]

    r["stacked_gather_3d"] = timeit(stacked_gather, op, u0)

    # 2. convection fold (element pass + F_e write), frozen diag.
    # w_e must be v-DEPENDENT or the whole fold hoists out of the timing
    # loop (an earlier version of this script timed nothing); the gather is
    # part of the phase here (the real step amortises it via the stacked
    # [n, 3d] gather -- subtract ~1/3 of stacked_gather_3d to compare).
    def conv_fold(dd, v):
        cv = ops.convection_setup(dd, v, backflow=dev.backflow,
                                  fold=(nu, dt_eff), with_diag=False)
        return v * (1.0 + 1e-30 * jnp.sum(cv.F_e[:, 0, 0]))

    r["conv_fold+gather"] = timeit(conv_fold, op, u0)

    # 3. fused rhs + r0 pass (same hoisting hazard: h/u0 element views are
    # re-gathered from v inside the loop)
    def rhs_r0(data, v):
        dd, cv, pp = data
        ve = ops.gather_u(dd, v)
        b, r0 = ops.apply_rhs_and_r0(dd, v, pp, nu, dt_eff, cv, v,
                                     h_e=ve, u0_e=ve)
        return v + (b + r0) * 0.5

    r["fused_rhs_r0+gather"] = timeit(rhs_r0, (op, conv, p0), u0)

    # 4. folded F apply (one velocity Krylov iteration's operator work)
    r["apply_F"] = timeit(
        lambda data, v: ops.apply_F(data[0], nu, dt_eff, data[1], v),
        (op, conv), u0)

    # 5. divergence (element pass + pressure-space reduce)
    def div(dd, v):
        y = ops.apply_divergence(dd, v)
        return v + jnp.sum(y) * 1e-6

    r["divergence"] = timeit(div, op, u0)

    # 6. gradient (pressure gather + einsum + velocity reduce)
    def grad(dd, pv):
        y = ops.apply_gradient(dd, pv)
        return pv + jnp.sum(y) * 1e-6

    r["gradient"] = timeit(grad, op, p0) - base_p + r["baseline_u"]

    # 7. banded frozen-Schur SpMV (one pressure CG iteration's operator)
    if fz is not None and fz.band is not None:
        r["schur_banded_spmv"] = timeit(
            lambda bd, pv: banded_matvec(bd, pv), fz.band, p0
        ) - base_p + r["baseline_u"]
        solve_c = (inv_solve_c(fz.inv_c) if fz.inv_c is not None
                   else cho_solve_c((fz.cho_L, True)))
        inv_d = 1.0 / fz.diag1

        def m2(dd, pv):
            return twolevel_apply_additive_g(dd, solve_c, inv_d, pv)

        r["schur_precond_additive"] = timeit(
            m2, op.coarse, p0) - base_p + r["baseline_u"]

    # 8. diagnostics (forces + probe)
    def diags(dd, v):
        drag, lift = fn.forces_3d(dev.forces, v, p0, nu, solver.problem.rho)
        pv = dev.probe.pressure(p0)
        return v + (drag + lift + pv[0]) * 1e-9

    r["diagnostics"] = timeit(diags, None, u0)

    # 9. velocity-space dot / norm (Krylov fixed cost per iteration)
    def dots(dd, v):
        a = jnp.vdot(v.reshape(-1), v.reshape(-1))
        return v * (1.0 + 1e-12 * a)

    r["dot_un"] = timeit(dots, None, u0)

    base = r["baseline_u"]
    out = {k: round(v - base if not k.startswith("baseline") else v, 3)
           for k, v in r.items()}
    out["dofs"] = solver.space.n_dofs

    # accounting: warm step = F iters x (apply + ~2 dots + CGS basis) +
    # S iters x (spmv + precond + ~3 dots) + fixed passes
    f_it, s_it = 4.0, 8.0
    fixed = (out["stacked_gather_3d"] + out["conv_fold+gather"] +
             out["fused_rhs_r0+gather"] + out["divergence"] +
             out["gradient"] + out["diagnostics"]
             - 2.0 * out["stacked_gather_3d"] / 3.0)  # gathers the real
    # step amortises via the stacked [n, 3d] gather
    per_f = out["apply_F"] + 2 * out["dot_un"]
    per_s = (out.get("schur_banded_spmv", 0.0)
             + out.get("schur_precond_additive", 0.0))
    out["accounting_ms"] = round(
        fixed + f_it * per_f + s_it * per_s, 1)
    out["accounting_note"] = (
        f"fixed {fixed:.1f} + F {f_it}x{per_f:.1f} + S {s_it}x{per_s:.2f}"
    )
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
