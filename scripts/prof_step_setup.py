"""Split the per-step SETUP costs on the accelerator.

The apply-phase split (prof_apply.py) accounts for the Krylov iterations;
this measures what a step pays BEFORE iterating: convection tabulation
(+ folded F_e), Schur ELL value assembly, and the mg2 coarse factor.

Usage: python scripts/prof_step_setup.py [lc] [nz]
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from navierstokes_project_nm4pde_tpu.config import RunConfig, TimeConfig
from navierstokes_project_nm4pde_tpu.mesh import cylinder_duct_3d
from navierstokes_project_nm4pde_tpu.models import (
    Cylinder3DProblem,
    NavierStokesSolver,
)
from navierstokes_project_nm4pde_tpu.ops import operators as ops
from navierstokes_project_nm4pde_tpu.ops.coarse import coarse_factor
from navierstokes_project_nm4pde_tpu.ops.schur_ell import (
    assemble_schur_values,
    schur_ell_diag,
)

REPS = 20


def timeit(fn, data, u0):
    def prog(data, u):
        def body(_, v):
            out = fn(data, v)
            return out / (1e-30 + jnp.max(jnp.abs(out)))

        return jnp.sum(jax.lax.fori_loop(0, REPS, body, u))

    # float() readback: the host reads a value that depends on the whole
    # chain, so the timer stops after the device finished.
    jprog = jax.jit(prog)
    float(jprog(data, u0))  # compile
    float(jprog(data, u0))  # second warm run
    t0 = time.perf_counter()
    float(jprog(data, u0))
    return (time.perf_counter() - t0) / REPS * 1e3


def main():
    lc = float(sys.argv[1]) if len(sys.argv) > 1 else 0.028
    nz = int(sys.argv[2]) if len(sys.argv) > 2 else 12
    mesh = cylinder_duct_3d(lc=lc, nz=nz)
    cfg = RunConfig(time=TimeConfig(dt=2e-4, t_end=4.0))
    solver = NavierStokesSolver(mesh, Cylinder3DProblem(test_case=2), cfg)
    op = solver.op
    nu, dt = solver.problem.nu, cfg.time.dt
    n, d = solver.space.n_unodes, solver.space.dim
    print(f"# {mesh.n_cells} cells, {solver.space.n_dofs} DoFs",
          file=sys.stderr, flush=True)

    key = jax.random.PRNGKey(0)
    u0 = jax.random.normal(key, (n, d), dtype=jnp.float32)

    results = {"dofs": solver.space.n_dofs}
    results["baseline"] = timeit(lambda _, v: v + 1.0, None, u0)

    def conv_nofold(dd, v):
        c = ops.convection_setup(dd, v)
        return v + jnp.sum(c.diagC)[None, None]

    results["convection_setup"] = timeit(conv_nofold, op, u0)

    def conv_fold(dd, v):
        c = ops.convection_setup(dd, v, fold=(nu, dt))
        return v + jnp.sum(c.F_e[0])[None, None]

    results["convection_setup_folded"] = timeit(conv_fold, op, u0)

    mask = op.dirichlet_mask

    def schur_assemble(dd, v):
        dF = ops.diag_F(dd, nu, dt, None)
        schur_inv = jnp.where(mask, 0.0, dt / dd.diagM)
        vals = assemble_schur_values(dd.schur, schur_inv)
        diag = schur_ell_diag(dd.schur, vals)
        return v + (jnp.sum(diag) + jnp.sum(dF))[None, None]

    results["schur_assembly"] = timeit(schur_assemble, op, u0)

    def mg2_factor(dd, v):
        schur_inv = jnp.where(mask, 0.0, dt / dd.diagM)
        vals = assemble_schur_values(dd.schur, schur_inv)
        L = coarse_factor(dd.coarse, vals)[0]
        return v + jnp.sum(L)[None, None]

    results["schur_assembly+mg2_factor"] = timeit(mg2_factor, op, u0)

    base = results["baseline"]
    out = {
        k: round(v - base, 3)
        if isinstance(v, float) and k != "baseline" else v
        for k, v in results.items()
    }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
