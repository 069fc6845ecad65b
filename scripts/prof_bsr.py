"""A/B the supernode BSR divergence/gradient (ops/bsr.py) against the
older forms (element pass, assembled-ELL gradient) at bench scale.

Usage: python scripts/prof_bsr.py [lc] [nz] [bs ...]   (default 965k mesh,
block sizes 8 16 32 64 -- any multiple of 8 tiles exactly)
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
from navierstokes_project_nm4pde_tpu.ops.bsr import (
    apply_bsr,
    build_divergence_bsr,
    build_gradient_bsr,
)

REPS = 20


def timeit(f, x0, m=None):
    """Time f (or f(m, .)): the operator `m` is threaded as a jit ARGUMENT,
    never a closure -- closure constants would embed the GB-scale BSR
    values in the program."""

    def prog(mm, x):
        def body(_, v):
            out = f(v) if mm is None else f(mm, v)
            return x * (1.0 + 1e-30 * jnp.max(jnp.abs(out)))

        return jnp.sum(jax.lax.fori_loop(0, REPS, body, x))

    jprog = jax.jit(prog)
    float(jprog(m, x0))
    float(jprog(m, x0))
    t0 = time.perf_counter()
    float(jprog(m, x0))
    return (time.perf_counter() - t0) / REPS * 1e3


def stats(name, m):
    widths = [c.shape[1] for c in m.cols]
    print(
        f"# {name}: bs={m.bs} buckets={len(m.cols)} (W {min(widths)}-"
        f"{max(widths)}), vals {m.value_bytes / 1e6:.0f} MB, gathered rows "
        f"{m.gathered_rows / 1e3:.0f}k",
        file=sys.stderr,
    )


def main():
    lc = float(sys.argv[1]) if len(sys.argv) > 1 else 0.024
    nz = int(sys.argv[2]) if len(sys.argv) > 2 else 14
    bss = [int(a) for a in sys.argv[3:]] or [8, 16, 32, 64]
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
    gradt = ops.build_gradient_plan(host, space.n_unodes, dtype=jnp.float32)
    opg = dataclasses.replace(op, gradt=gradt)
    print(
        f"# {mesh.n_cells} cells, {space.n_dofs} DoFs, n_p={space.n_pnodes}, "
        f"n_u={space.n_unodes}; setup {time.time() - t0:.1f}s",
        file=sys.stderr,
    )

    key = jax.random.PRNGKey(0)
    u0 = jax.random.normal(key, (space.n_unodes, space.dim), dtype=jnp.float32)
    p0 = jax.random.normal(key, (space.n_pnodes,), dtype=jnp.float32)

    t_div_el = timeit(lambda u: ops.apply_divergence(op, u), u0)
    t_grad_el = timeit(lambda p: ops.apply_gradient(op, p), p0)
    t_grad_ell = timeit(lambda p: ops.apply_gradient(opg, p), p0)
    print(f"divergence element pass : {t_div_el:8.2f} ms")
    print(f"gradient element pass   : {t_grad_el:8.2f} ms")
    print(f"gradient ELL (gradt)    : {t_grad_ell:8.2f} ms")

    d_ref = ops.apply_divergence(op, u0)
    g_ref = ops.apply_gradient(op, p0)
    for bs in bss:
        tb = time.time()
        dbsr = build_divergence_bsr(
            host, space.n_unodes, space.n_pnodes, bs=bs, dtype=jnp.float32
        )
        gbsr = build_gradient_bsr(
            host, space.n_unodes, space.n_pnodes, bs=bs, dtype=jnp.float32
        )
        jax.block_until_ready(dbsr.vals)
        print(f"# bs={bs} build {time.time() - tb:.1f}s", file=sys.stderr)
        stats(f"D bs={bs}", dbsr)
        stats(f"G bs={bs}", gbsr)
        errd = float(jnp.linalg.norm(apply_bsr(dbsr, u0)[:, 0] - d_ref)
                     / jnp.linalg.norm(d_ref))
        errg = float(jnp.linalg.norm(apply_bsr(gbsr, p0[:, None]) - g_ref)
                     / jnp.linalg.norm(g_ref))
        print(f"# rel diff D/G bs={bs}: {errd:.2e} / {errg:.2e}",
              file=sys.stderr)
        t_d = timeit(lambda m, u: apply_bsr(m, u)[:, 0], u0, dbsr)
        t_g = timeit(lambda m, p: apply_bsr(m, p[:, None]), p0, gbsr)
        d2 = dataclasses.replace(dbsr, contraction="einsum")
        g2 = dataclasses.replace(gbsr, contraction="einsum")
        t_d2 = timeit(lambda m, u: apply_bsr(m, u)[:, 0], u0, d2)
        t_g2 = timeit(lambda m, p: apply_bsr(m, p[:, None]), p0, g2)
        print(f"divergence BSR bs={bs:3d}   : {t_d:8.2f} ms "
              f"(einsum {t_d2:.2f})")
        print(f"gradient   BSR bs={bs:3d}   : {t_g:8.2f} ms "
              f"(einsum {t_g2:.2f})")

    # Constant velocity block K = M/dt + nu A (explicit/IMEX modes).
    if os.environ.get("NS_PROF_K", "1") == "1":
        from navierstokes_project_nm4pde_tpu.ops.bsr import (
            apply_bsr_scalar,
            build_velocity_kbsr,
        )
        from navierstokes_project_nm4pde_tpu.ops.tables import (
            build_ref_tables,
        )

        nu, dt = 1e-3, 2e-4
        t_k_el = timeit(
            lambda u: ops.apply_F(op, nu, dt, None, u), u0
        )
        print(f"K element pass (apply_F): {t_k_el:8.2f} ms")
        tabs = build_ref_tables(space.dim)
        k_ref = ops.apply_F(op, nu, dt, None, u0)
        for bs in bss:
            tb = time.time()
            kbsr = build_velocity_kbsr(
                space, geom, tabs, nu, dt, bs=bs, dtype=jnp.float32
            )
            jax.block_until_ready(kbsr.vals[0])
            print(f"# K bs={bs} build {time.time() - tb:.1f}s",
                  file=sys.stderr)
            stats(f"K bs={bs}", kbsr)
            errk = float(
                jnp.linalg.norm(apply_bsr_scalar(kbsr, u0) - k_ref)
                / jnp.linalg.norm(k_ref)
            )
            print(f"# rel diff K bs={bs}: {errk:.2e}", file=sys.stderr)
            t_k = timeit(apply_bsr_scalar, u0, kbsr)
            k2 = dataclasses.replace(kbsr, contraction="einsum")
            t_k2 = timeit(apply_bsr_scalar, u0, k2)
            print(f"K BSR bs={bs:3d}          : {t_k:8.2f} ms "
                  f"(einsum {t_k2:.2f})")


if __name__ == "__main__":
    main()
