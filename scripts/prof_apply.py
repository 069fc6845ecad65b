"""Split the cost of one F-apply on the accelerator: gather / einsum / reduce.

Usage: python scripts/prof_apply.py [lc] [nz]
Each phase is timed as a chained lax.fori_loop (data dependence defeats the
async-dispatch illusion) over REPS iterations, minus a
baseline loop of the same length, divided by REPS.
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
from navierstokes_project_nm4pde_tpu.ops.scatter import apply_gather_plan

REPS = 30


def timeit(fn, dev, u0):
    """Chained fori_loop: each iteration feeds the next (no dispatch overlap)."""

    def prog(dd, u):
        def body(_, v):
            out = fn(dd, v)
            # re-normalise to keep magnitudes finite and force data flow
            return out / (1e-30 + jnp.max(jnp.abs(out)))

        return jnp.sum(jax.lax.fori_loop(0, REPS, body, u))

    # float() readback: the host reads a value that depends on the whole
    # chain, so the timer stops after the device finished.
    jprog = jax.jit(prog)
    float(jprog(dev, u0))  # compile
    float(jprog(dev, u0))  # second warm run
    t0 = time.perf_counter()
    float(jprog(dev, u0))
    return (time.perf_counter() - t0) / REPS * 1e3  # ms per op


def main():
    lc = float(sys.argv[1]) if len(sys.argv) > 1 else 0.028
    nz = int(sys.argv[2]) if len(sys.argv) > 2 else 12
    mesh = cylinder_duct_3d(lc=lc, nz=nz)
    cfg = RunConfig(time=TimeConfig(dt=2e-4, t_end=4.0))
    solver = NavierStokesSolver(mesh, Cylinder3DProblem(test_case=2), cfg)
    op = solver.op
    nu, dt = solver.problem.nu, cfg.time.dt
    n, d = solver.space.n_unodes, solver.space.dim
    E, nloc = op.cells_u.shape
    print(f"# {mesh.n_cells} cells, {solver.space.n_dofs} DoFs", file=sys.stderr)

    key = jax.random.PRNGKey(0)
    u0 = jax.random.normal(key, (n, d), dtype=jnp.float32)
    conv = ops.convection_setup(op, u0)

    results = {}

    # noop baseline (loop + normalisation overhead)
    results["baseline"] = timeit(lambda dd, v: v + 1.0, op, u0)

    # full F apply (conv threaded as part of the jit argument: closure
    # constants would be embedded in the program)
    results["apply_F"] = timeit(
        lambda dd, v: ops.apply_F(dd[0], nu, dt, dd[1], v), (op, conv), u0
    )

    # gather only: u_e -> collapse back to [n, d] with a cheap slice
    def gather_only(dd, v):
        u_e = ops.gather_u(dd, v)  # [E, nloc, d]
        s = jnp.sum(u_e, axis=(0, 1))  # tiny reduce to force materialisation
        return v + s[None, :]

    results["gather"] = timeit(gather_only, op, u0)

    # gather + element einsums, cheap fold (no plan reduce)
    def gather_einsum(data, v):
        dd, cv = data
        u_e = ops.gather_u(dd, v)
        y_e = jnp.einsum("ij,ejc->eic", dd.MHAT, u_e) * (dd.detJ / dt)[:, None, None]
        y_e = y_e + nu * jnp.einsum("ekl,klij,ejc->eic", dd.GKd, dd.AHAT, u_e)
        u_q = jnp.einsum("qi,eic->eqc", dd.PHI_U, u_e)
        dir_q = jnp.einsum("eqi,eic->eqc", cv.WG, u_e)
        r = dir_q + 0.5 * cv.divw[:, :, None] * u_q
        y_e = y_e + jnp.einsum("q,qi,eqc->eic", dd.W, dd.PHI_U, r) * dd.detJ[:, None, None]
        s = jnp.sum(y_e, axis=(0, 1))
        return v + s[None, :]

    results["gather+einsum"] = timeit(gather_einsum, (op, conv), u0)

    # reduce only (plan applied to a fixed element array reconstructed from v)
    def reduce_only(dd, v):
        flat = jnp.broadcast_to(v[:1, :], (E * nloc, d)) + v[0, 0]
        return apply_gather_plan(dd.plan_u, flat)

    results["reduce"] = timeit(reduce_only, op, u0)

    # folded element-matrix variant: F_e [E, nloc, nloc] precomputed, apply =
    # gather + batched matmul + reduce
    MHATd = op.MHAT[None] * (op.detJ / dt)[:, None, None]
    AHATd = nu * jnp.einsum("ekl,klij->eij", op.GKd, op.AHAT)
    CW = jnp.einsum("q,qi,eqj->eij", op.W, op.PHI_U, conv.WG + 0.5 * conv.divw[:, :, None] * op.PHI_U[None]) * op.detJ[:, None, None]
    F_e = MHATd + AHATd + CW

    def folded(data, v):
        dd, fe = data
        u_e = ops.gather_u(dd, v)
        y_e = jnp.einsum("eij,ejc->eic", fe, u_e)
        return ops.scatter_u(dd, y_e)

    results["folded_full"] = timeit(folded, (op, F_e), u0)

    def folded_bf16(data, v):
        dd, fe16 = data
        u_e = ops.gather_u(dd, v.astype(jnp.bfloat16))
        y_e = jnp.einsum(
            "eij,ejc->eic", fe16, u_e,
            preferred_element_type=jnp.float32,
        )
        return ops.scatter_u(dd, y_e)

    results["folded_bf16gather"] = timeit(
        folded_bf16, (op, F_e.astype(jnp.bfloat16)), u0
    )

    base = results["baseline"]
    out = {k: round(v - base if k != "baseline" else v, 3) for k, v in results.items()}
    out["dofs"] = solver.space.n_dofs
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
