"""Compare velocity-reduce plan variants on the accelerator at bench size.

Usage: python scripts/prof_reduce.py [lc] [nz]
Variants: table-form GatherPlan (current), HalvingPlan chunk 4/8/16,
each measured standalone and inside a folded F-apply.
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
from navierstokes_project_nm4pde_tpu.ops.scatter import (
    apply_gather_plan,
    apply_halving_plan,
    build_halving_plan,
)

REPS = 30


def timeit(fn, data, u0):
    """fn(data, u); `data` (plans/operators/folded tables) is threaded as a
    jit ARGUMENT -- closure constants would be embedded in the program."""

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
    E, nloc = op.cells_u.shape
    print(f"# {mesh.n_cells} cells, {solver.space.n_dofs} DoFs", file=sys.stderr)

    cells_np = jax.device_get(op.cells_u)
    chunks = tuple(
        int(c) for c in os.environ.get("NS_PROF_CHUNKS", "4,8,16").split(",")
    )
    hplans = {c: build_halving_plan(cells_np, n, chunk=c) for c in chunks}

    key = jax.random.PRNGKey(0)
    u0 = jax.random.normal(key, (n, d), dtype=jnp.float32)
    conv = ops.convection_setup(op, u0, fold=(nu, dt))

    results = {}
    results["baseline"] = timeit(lambda _, v: v + 1.0, None, u0)

    # correctness: halving reduce == table reduce
    flat = jax.random.normal(key, (E * nloc, d), dtype=jnp.float32)
    ref = apply_gather_plan(op.plan_u, flat)
    for c, hp in hplans.items():
        got = apply_halving_plan(hp, flat)
        err = float(jnp.max(jnp.abs(got - ref)) / jnp.max(jnp.abs(ref)))
        assert err < 1e-5, (c, err)
    print("# halving == table reduce (to roundoff)", file=sys.stderr)

    def mk_reduce(applyfn):
        def f(plan, v):
            fl = jnp.broadcast_to(v[:1, :], (E * nloc, d)) + v[0, 0]
            return applyfn(plan, fl)

        return f

    results["reduce_table"] = timeit(mk_reduce(apply_gather_plan), op.plan_u, u0)
    for c, hp in hplans.items():
        results[f"reduce_halving{c}"] = timeit(mk_reduce(apply_halving_plan), hp, u0)

    # folded F-apply with each reduce
    def mk_apply(reduce_fn):
        def f(data, v):
            op_, F_e, plan = data
            u_e = ops.gather_u(op_, v)
            y_e = jnp.einsum("eij,ejc->eic", F_e, u_e)
            return reduce_fn(plan, y_e.reshape(-1, d))

        return f

    results["applyF_folded_table"] = timeit(
        mk_apply(apply_gather_plan), (op, conv.F_e, op.plan_u), u0
    )
    for c, hp in hplans.items():
        results[f"applyF_folded_halving{c}"] = timeit(
            mk_apply(apply_halving_plan), (op, conv.F_e, hp), u0
        )

    base = results["baseline"]
    out = {k: round(v - base if k != "baseline" else v, 3) for k, v in results.items()}
    out["dofs"] = solver.space.n_dofs
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
