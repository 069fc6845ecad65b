"""Reduce-asymmetry experiments.

Before the H100 port the velocity reduce paid ~3x the forward gather's cost
per row on identical row counts (not yet measured on the H100).
Candidates timed here, standalone at bench size:

  table        current 2-bucket padded [rows, K] gather + row sum
  exact        valence-exact grouped buckets (zero padded rows)
  transposed   [K, rows] access order (column-major gather, sum axis 0)
  segsum       sorted-contribution jax.ops.segment_sum(indices_are_sorted)
  columns      valence-exact buckets applied as K UNROLLED 1-D row gathers
               (each a pure row-copy at the forward rate?) + adds
  fwd          the forward gather u[cells] for the rate reference

Usage: python scripts/prof_reduce2.py [lc] [nz]
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from navierstokes_project_nm4pde_tpu.config import RunConfig, TimeConfig
from navierstokes_project_nm4pde_tpu.mesh import cylinder_duct_3d
from navierstokes_project_nm4pde_tpu.models import (
    Cylinder3DProblem,
    NavierStokesSolver,
)
from navierstokes_project_nm4pde_tpu.ops import operators as ops
from navierstokes_project_nm4pde_tpu.ops.scatter import (
    apply_gather_plan,
    build_gather_plan_grouped,
)

REPS = 30


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
    cfg = RunConfig(time=TimeConfig(dt=2e-4, t_end=4.0, stepper="projection"))
    solver = NavierStokesSolver(mesh, Cylinder3DProblem(test_case=2), cfg)
    op = solver.op
    n, d = solver.space.n_unodes, solver.space.dim
    E, nloc = op.cells_u.shape
    n_slots = E * nloc
    print(f"# {mesh.n_cells} cells, {solver.space.n_dofs} DoFs, "
          f"{n_slots} slots", file=sys.stderr)

    cells_np = jax.device_get(op.cells_u)
    flat_ids = cells_np.reshape(-1).astype(np.int64)

    # valence-exact grouped plan
    plan_exact = build_gather_plan_grouped(
        flat_ids[:, None], n, thresholds=tuple(range(2, 96)),
    )

    # sorted-segment structures
    order = np.argsort(flat_ids, kind="stable")
    sorted_ids = flat_ids[order]
    order_dev = jnp.asarray(order, jnp.int32)
    sorted_ids_dev = jnp.asarray(sorted_ids, jnp.int32)

    key = jax.random.PRNGKey(0)
    u0 = jax.random.normal(key, (n, d), dtype=jnp.float32)

    results = {}
    results["baseline"] = timeit(lambda _, v: v + 1.0, None, u0)

    def synth_flat(v):
        # cheap data-dependent [n_slots, d] payload
        return jnp.broadcast_to(v[:1, :], (n_slots, d)) + v[0, 0]

    # forward gather rate reference
    def fwd(cells, v):
        g = v[cells]  # [E, nloc, d]
        return g.sum(axis=(0, 1), keepdims=True)[0] + v[:1]

    results["fwd_gather_ref"] = timeit(
        lambda c, v: jnp.broadcast_to(fwd(c, v), v.shape), op.cells_u, u0
    )

    results["table"] = timeit(
        lambda p, v: apply_gather_plan(p, synth_flat(v)), op.plan_u, u0
    )
    results["exact"] = timeit(
        lambda p, v: apply_gather_plan(p, synth_flat(v)), plan_exact, u0
    )

    # transposed access order on the current plan's tables
    def transposed(plan, v):
        fl = synth_flat(v)
        padded = jnp.concatenate(
            [fl, jnp.zeros((1, fl.shape[1]), fl.dtype)], axis=0
        )
        outs = [padded[tab.T].sum(axis=0) for tab in plan.slots]
        return jnp.concatenate(outs, axis=0)

    results["transposed"] = timeit(transposed, op.plan_u, u0)

    # K unrolled single-column gathers per bucket: every gather is a pure
    # [rows]-indexed row copy (the forward gather's access pattern), the
    # row sum becomes explicit adds between gathers.
    def columns(plan, v):
        fl = synth_flat(v)
        padded = jnp.concatenate(
            [fl, jnp.zeros((1, fl.shape[1]), fl.dtype)], axis=0
        )
        outs = []
        for tab in plan.slots:
            acc = padded[tab[:, 0]]
            for k in range(1, tab.shape[1]):
                acc = acc + padded[tab[:, k]]
            outs.append(acc)
        out = jnp.concatenate(outs, axis=0) if len(outs) > 1 else outs[0]
        if plan.row_unperm is not None:
            out = out[plan.row_unperm]
        return out

    results["columns_exact"] = timeit(columns, plan_exact, u0)

    # sorted segment sum (gather into sorted order, then segment-reduce)
    def segsum(data, v):
        order_, ids_ = data
        fl = synth_flat(v)
        g = fl[order_]
        return jax.ops.segment_sum(
            g, ids_, num_segments=n, indices_are_sorted=True
        )

    results["segsum_sorted"] = timeit(segsum, (order_dev, sorted_ids_dev), u0)

    # windowed reduce: scan over RCM-contiguous destination blocks, each
    # gathering window-locally from a dynamic-sliced source window (the
    # gather rate is source-working-set bound: prof_gather_rate.py)
    from navierstokes_project_nm4pde_tpu.ops.scatter import (
        apply_windowed_plan,
        build_windowed_plan,
    )

    n_vert = solver.mesh.n_vertices
    win_plans = {}
    for rpb in (1024, 2048, 4096):
        wp = build_windowed_plan(cells_np, n, splits=(n_vert,),
                                 rows_per_block=rpb)
        win_plans[rpb] = wp
        wins = tuple(s.window for s in wp.segs)
        print(f"# windowed rpb={rpb}: windows {wins} "
              f"({[round(w * d * 4 / 1e6, 2) for w in wins]} MB)",
              file=sys.stderr)
        results[f"windowed_{rpb}"] = timeit(
            lambda p, v: apply_windowed_plan(p, synth_flat(v)), wp, u0
        )

    # correctness of each vs table
    flat = jax.random.normal(key, (n_slots, d), dtype=jnp.float32)
    ref = apply_gather_plan(op.plan_u, flat)
    got_e = apply_gather_plan(plan_exact, flat)
    pad = jnp.concatenate([flat, jnp.zeros((1, d), flat.dtype)], axis=0)
    got_t = jnp.concatenate(
        [pad[tab.T].sum(axis=0) for tab in op.plan_u.slots], axis=0
    )
    got_s = jax.ops.segment_sum(
        flat[order_dev], sorted_ids_dev, num_segments=n,
        indices_are_sorted=True,
    )
    pad_e = jnp.concatenate([flat, jnp.zeros((1, d), flat.dtype)], axis=0)
    outs_c = []
    for tab in plan_exact.slots:
        acc = pad_e[tab[:, 0]]
        for k in range(1, tab.shape[1]):
            acc = acc + pad_e[tab[:, k]]
        outs_c.append(acc)
    got_cols = jnp.concatenate(outs_c, axis=0)[plan_exact.row_unperm]
    got_w = apply_windowed_plan(win_plans[2048], flat)
    for name, got in (("exact", got_e), ("transposed", got_t),
                      ("segsum", got_s), ("columns", got_cols),
                      ("windowed", got_w)):
        err = float(jnp.max(jnp.abs(got - ref)) / jnp.max(jnp.abs(ref)))
        assert err < 1e-5, (name, err)
    print("# all variants == table reduce (to roundoff)", file=sys.stderr)

    base = results["baseline"]
    out = {
        k: round(v - base if k != "baseline" else v, 3)
        for k, v in results.items()
    }
    out["dofs"] = solver.space.n_dofs
    out["n_slots"] = n_slots
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
