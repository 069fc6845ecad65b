"""A/B the projection update gradient at bench scale: element pass
(p-gather + contraction + velocity-space reduce) vs assembled-transpose
WeightedPlan (valence-bucketed ELL gathering from the KB-scale pressure
vector -- ops/operators.py build_gradient_plan).

Usage: python scripts/prof_grad.py [lc] [nz]   (default 965k mesh)
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import dataclasses

import jax
import jax.numpy as jnp

from navierstokes_project_nm4pde_tpu.fem.geometry import cell_geometry
from navierstokes_project_nm4pde_tpu.fem.space import build_taylor_hood
from navierstokes_project_nm4pde_tpu.mesh import cylinder_duct_3d
from navierstokes_project_nm4pde_tpu.ops import operators as ops

REPS = 20


def timeit(f, x0):
    def prog(x):
        def body(_, v):
            out = f(v)
            # chain a data dependence back into the p-shaped carry
            return x * (1.0 + 1e-30 * jnp.max(jnp.abs(out)))
        return jnp.sum(jax.lax.fori_loop(0, REPS, body, x))

    jprog = jax.jit(prog)
    float(jprog(x0))
    float(jprog(x0))
    t0 = time.perf_counter()
    float(jprog(x0))
    return (time.perf_counter() - t0) / REPS * 1e3


def main():
    lc = float(sys.argv[1]) if len(sys.argv) > 1 else 0.024
    nz = int(sys.argv[2]) if len(sys.argv) > 2 else 14
    t0 = time.time()
    mesh = cylinder_duct_3d(lc=lc, nz=nz).reorder_spatial("rcm")
    space = build_taylor_hood(mesh)
    geom = cell_geometry(space)
    mask = space.dirichlet_mask([0, 2, 4])
    op, host = ops.build_operator(
        space, geom, mask, dtype=jnp.float32,
        device_schur_assembly=False, want_host_schur=True,
    )
    op = dataclasses.replace(op, contraction="vpu")
    tb = time.time()
    gradt = ops.build_gradient_plan(host, space.n_unodes, dtype=jnp.float32)
    widths = [c.shape for c in gradt.cols]
    rows_tot = sum(c.shape[0] * c.shape[1] for c in gradt.cols)
    print(
        f"# {mesh.n_cells} cells, {space.n_dofs} DoFs, n_p={space.n_pnodes}; "
        f"plan build {time.time() - tb:.1f}s, buckets={len(widths)}, "
        f"padded rows={rows_tot / 1e6:.2f}M, setup {time.time() - t0:.1f}s",
        file=sys.stderr,
    )
    opg = dataclasses.replace(op, gradt=gradt)

    key = jax.random.PRNGKey(0)
    p0 = jax.random.normal(key, (space.n_pnodes,), dtype=jnp.float32)

    def grad_elem(p):
        return ops.apply_gradient(op, p)

    def grad_ell(p):
        return ops.apply_gradient(opg, p)

    # equality sanity at bench scale
    ye = grad_elem(p0)
    yl = grad_ell(p0)
    err = float(jnp.linalg.norm(ye - yl) / jnp.linalg.norm(ye))
    print(f"# rel diff element vs ell: {err:.2e}", file=sys.stderr)

    def grad_ell_table(p):
        # 2-D [rows, K] gather + weighted row-sum variant (vs the unrolled
        # per-column row gathers of apply_weighted_plan)
        xp = jnp.concatenate([p, jnp.zeros((1,), p.dtype)])
        outs = []
        for cb, vb in zip(gradt.cols, gradt.vals):
            outs.append((xp[cb][:, :, None] * vb).sum(axis=1))
        out = outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=0)
        return out[gradt.row_unperm]

    yt = grad_ell_table(p0)
    print(
        f"# rel diff table vs ell: "
        f"{float(jnp.linalg.norm(yt - yl) / jnp.linalg.norm(ye)):.2e}",
        file=sys.stderr,
    )
    t_elem = timeit(grad_elem, p0)
    t_ell = timeit(grad_ell, p0)
    t_tab = timeit(grad_ell_table, p0)
    print(f"gradient element pass : {t_elem:8.2f} ms")
    print(f"gradient ELL (gradt)  : {t_ell:8.2f} ms")
    print(f"gradient ELL 2-D table: {t_tab:8.2f} ms")


if __name__ == "__main__":
    main()
