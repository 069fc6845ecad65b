"""Matmul-precision surcharge on the hot element contractions, and exact
elementwise alternatives, at bench scale.

The solver jits its chunk under jax.default_matmul_precision("highest")
(NumericsConfig.matmul_precision -- required for fine-mesh stability and
low Krylov counts), which makes every f32 einsum a full-precision matmul.
The per-element contractions are TINY (j=10, k*j=30): this script times
each hot contraction at default vs highest precision vs an unrolled
multiply-sum that is EXACTLY f32 whatever the matmul precision.

Usage: python scripts/prof_precision.py [lc] [nz]   (default 965k mesh)
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

REPS = 20


def timeit(f, data, u0):
    def prog(dd, u):
        def body(_, v):
            out = f(dd, v)
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
    lc = float(sys.argv[1]) if len(sys.argv) > 1 else 0.024
    nz = int(sys.argv[2]) if len(sys.argv) > 2 else 14
    mesh = cylinder_duct_3d(lc=lc, nz=nz)
    cfg = RunConfig(time=TimeConfig(dt=2e-4, t_end=4.0, stepper="projection"))
    solver = NavierStokesSolver(mesh, Cylinder3DProblem(test_case=2), cfg)
    op = solver.op
    nu = solver.problem.nu
    dt_eff = 2.0 * cfg.time.dt / 3.0
    n, d = solver.space.n_unodes, solver.space.dim
    n_p = solver.space.n_pnodes
    print(f"# {mesh.n_cells} cells, {solver.space.n_dofs} DoFs",
          file=sys.stderr)

    key = jax.random.PRNGKey(0)
    u0 = jax.random.normal(key, (n, d), dtype=jnp.float32)
    p0 = jax.random.normal(key, (n_p,), dtype=jnp.float32)
    w_e0 = ops.gather_u(op, u0)
    conv = ops.convection_setup(op, u0, backflow=None, fold=(nu, dt_eff),
                                w_e=w_e0, with_diag=False)

    r = {}
    r["baseline"] = timeit(lambda dd, v: v + 1.0, None, u0)

    def apply_f(data, v):
        return ops.apply_F(data[0], nu, dt_eff, data[1], v)

    def div(dd, v):
        return v + jnp.sum(ops.apply_divergence(dd, v)) * 1e-6

    def grad_roundtrip(dd, v):
        # pressure gather/einsum/velocity reduce driven from a velocity
        # vector so the chain stays v-dependent
        pv = ops.apply_divergence(dd, v)
        return ops.apply_gradient(dd, pv)

    for prec in ("default", "highest"):
        with jax.default_matmul_precision(prec):
            r[f"apply_F_{prec}"] = timeit(apply_f, (op, conv), u0)
            r[f"div_{prec}"] = timeit(div, op, u0)
            r[f"div+grad_{prec}"] = timeit(grad_roundtrip, op, u0)

    # Exact folded apply: unroll the j-contraction as a broadcast
    # multiply + sum (elementwise f32 arithmetic, no matmul, exact --
    # strictly more accurate than the bf16-pass "highest" emulation).
    def apply_f_vpu(data, v):
        dd, cv = data
        u_e = ops.gather_u(dd, v)  # [E, nloc, d]
        y_e = (cv.F_e[:, :, :, None] * u_e[:, None, :, :]).sum(axis=2)
        return ops.scatter_u(dd, y_e)

    r["apply_F_vpu"] = timeit(apply_f_vpu, (op, conv), u0)

    # Exact divergence: contract c via broadcast-sum, then the tiny
    # static BHAT contraction via dot_general.
    def div_vpu(dd, v):
        u_e = ops.gather_u(dd, v)  # [E, j, c]
        # t[e,k,j] = sum_c Jinv[e,k,c] u_e[e,j,c]
        t = (dd.Jinv[:, :, None, :] * u_e[:, None, :, :]).sum(axis=-1)
        # y[e,i] = sum_kj BHAT[k,i,j] t[e,k,j]
        y_e = (dd.BHAT[None] * t[:, :, None, :]).sum(axis=(1, 3))
        y_e = y_e * dd.detJ[:, None]
        return v + jnp.sum(ops.scatter_p(dd, y_e)) * 1e-6

    r["div_vpu"] = timeit(div_vpu, op, u0)

    # correctness: elementwise apply == highest-precision einsum apply (to f32
    # roundoff; both are f32-exact summations of the same products)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(apply_f)((op, conv), u0)
    got = jax.jit(apply_f_vpu)((op, conv), u0)
    import numpy as np

    err = float(jnp.max(jnp.abs(got - want)) / jnp.max(jnp.abs(want)))
    print(f"# vpu apply max rel err vs highest: {err:.2e}", file=sys.stderr)
    assert err < 1e-5

    base = r["baseline"]
    out = {k: round(v - base if k != "baseline" else v, 3)
           for k, v in r.items()}
    out["dofs"] = solver.space.n_dofs
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
