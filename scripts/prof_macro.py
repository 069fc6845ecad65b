"""A/B the macro-element block-dense F apply (ops/macroblock.py) against
the folded element pass at bench scale, including the per-step value
build.

Usage: python scripts/prof_macro.py [lc] [nz] [c_blk ...]  (default 965k,
c_blk 16 20)
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from navierstokes_project_nm4pde_tpu.fem.geometry import cell_geometry
from navierstokes_project_nm4pde_tpu.fem.space import build_taylor_hood
from navierstokes_project_nm4pde_tpu.mesh import cylinder_duct_3d
from navierstokes_project_nm4pde_tpu.ops import operators as ops
from navierstokes_project_nm4pde_tpu.ops.macroblock import (
    apply_macro,
    build_macro_plan,
    build_macro_values,
)

REPS = 20


def timeit(f, m, x0):
    def prog(mm, x):
        def body(_, v):
            out = f(mm, v)
            return x * (1.0 + 1e-30 * jnp.max(jnp.abs(out)))

        return jnp.sum(jax.lax.fori_loop(0, REPS, body, x))

    jp = jax.jit(prog)
    float(jp(m, x0))
    float(jp(m, x0))
    t0 = time.perf_counter()
    float(jp(m, x0))
    return (time.perf_counter() - t0) / REPS * 1e3


def main():
    lc = float(sys.argv[1]) if len(sys.argv) > 1 else 0.024
    nz = int(sys.argv[2]) if len(sys.argv) > 2 else 14
    cbs = [int(a) for a in sys.argv[3:]] or [16, 20]
    t0 = time.time()
    mesh = cylinder_duct_3d(lc=lc, nz=nz).reorder_spatial("rcm")
    space = build_taylor_hood(mesh)
    geom = cell_geometry(space)
    mask = space.dirichlet_mask([0, 2, 4])
    import dataclasses

    op = dataclasses.replace(
        ops.build_operator(space, geom, mask, dtype=jnp.float32),
        contraction="vpu",
    )
    nu, dt = 1e-3, 2e-4
    print(
        f"# {mesh.n_cells} cells, {space.n_dofs} DoFs; setup "
        f"{time.time() - t0:.1f}s",
        file=sys.stderr,
    )
    key = jax.random.PRNGKey(0)
    u0 = jax.random.normal(key, (space.n_unodes, space.dim), jnp.float32)
    w0 = jax.random.normal(jax.random.PRNGKey(1), u0.shape, jnp.float32)
    conv = ops.convection_setup(op, w0, fold=(nu, dt), with_diag=False)
    Fe = conv.F_e

    t_el = timeit(lambda cv, u: ops.apply_F(op, nu, dt, cv, u), conv, u0)
    print(f"apply_F fold element    : {t_el:8.2f} ms")
    y_ref = ops.apply_F(op, nu, dt, conv, u0)

    for cb in cbs:
        tb = time.time()
        mp = build_macro_plan(
            np.asarray(space.cells_u), space.n_unodes, U=128, c_blk=cb,
            n_vertices=mesh.n_vertices,
        )
        jax.block_until_ready(mp.onehot)
        print(
            f"# c_blk={mp.c_blk}: B={mp.B} U={mp.U} "
            f"Ft {mp.B * mp.U * mp.U * 4 / 1e6:.0f} MB, apply rows "
            f"{mp.B * mp.U / 1e3:.0f}k; build {time.time() - tb:.1f}s",
            file=sys.stderr,
        )
        # jit the one-off builds: eager mode keeps every 3.3 GB einsum
        # intermediate alive at once and OOMs at 965k
        jbuild = jax.jit(build_macro_values)
        Ft = jbuild(mp, Fe)
        err = float(
            jnp.linalg.norm(apply_macro(mp, Ft, u0) - y_ref)
            / jnp.linalg.norm(y_ref)
        )
        print(f"# rel err c={mp.c_blk}: {err:.2e}", file=sys.stderr)
        # thread EVERYTHING as jit args -- closure constants would embed
        # GB-scale arrays in the program
        t_build = timeit(
            lambda m, fe: build_macro_values(m, fe)[:, 0, 0], mp, Fe
        )
        t_apply = timeit(
            lambda mft, u: apply_macro(mft[0], mft[1], u), (mp, Ft), u0
        )

        # variants: one-dot apply (one HIGHEST dot),
        # HIGH-precision build (bf16x3 is exact against a 0/1 operand),
        # plain (unwindowed) slot gather
        def gather_ub(m, u):
            from navierstokes_project_nm4pde_tpu.ops.scatter import (
                apply_windowed_gather)
            if m.wgather is not None:
                return apply_windowed_gather(m.wgather, u)
            xb = jnp.concatenate(
                [u, jnp.zeros((1, u.shape[1]), u.dtype)], axis=0)
            return xb[m.uidx]

        def apply_dot(mft, u):
            m, ft = mft
            from navierstokes_project_nm4pde_tpu.ops.scatter import (
                apply_gather_plan)
            u_b = gather_ub(m, u)
            y_b = jnp.einsum("buv,bvc->buc", ft, u_b,
                             precision=jax.lax.Precision.HIGHEST)
            return apply_gather_plan(m.plan, y_b.reshape(m.B * m.U, -1))

        t_apply_dot = timeit(apply_dot, (mp, Ft), u0)

        def build_high_full(m, fe):
            B, c, U = m.B, m.c_blk, m.U
            nl = fe.shape[1]
            fep = jnp.concatenate(
                [fe, jnp.zeros((B * c - fe.shape[0], nl, nl), fe.dtype)], 0
            ).reshape(B, c, nl, nl)
            P = m.onehot.astype(fe.dtype)
            A = jnp.einsum("bciu,bcij->bcju", P, fep,
                           precision=jax.lax.Precision.HIGH)
            return jnp.einsum("bcju,bcjv->buv", A, P,
                              precision=jax.lax.Precision.HIGH)

        t_build_high = timeit(
            lambda m, fe: build_high_full(m, fe)[:, 0, 0], mp, Fe
        )
        err_h = float(jnp.linalg.norm(
            apply_macro(mp, jax.jit(build_high_full)(mp, Fe), u0) - y_ref
        ) / jnp.linalg.norm(y_ref))
        print(f"  # build HIGH rel err: {err_h:.2e}", file=sys.stderr)
        import dataclasses as _dc
        mp_plain = _dc.replace(mp, wgather=None)
        t_apply_plain = timeit(
            lambda mft, u: apply_macro(mft[0], mft[1], u), (mp_plain, Ft), u0
        )

        # precision ladder on the matvec: HIGHEST vs HIGH and DEFAULT,
        # and a hand-split double-bf16 scheme (3 exact bf16 products over
        # HALF the bytes -- the value array itself stored as a hi/lo bf16
        # pair)
        from navierstokes_project_nm4pde_tpu.ops.scatter import (
            apply_gather_plan)

        def apply_prec(pm):
            def f(mft, u):
                m, ft = mft
                u_b = gather_ub(m, u)
                y_b = jnp.einsum("buv,bvc->buc", ft, u_b, precision=pm)
                return apply_gather_plan(m.plan, y_b.reshape(m.B * m.U, -1))
            return f

        for name, pm in (("high", jax.lax.Precision.HIGH),
                         ("dflt", jax.lax.Precision.DEFAULT)):
            fp = apply_prec(pm)
            err_p = float(jnp.linalg.norm(fp((mp, Ft), u0) - y_ref)
                          / jnp.linalg.norm(y_ref))
            t_p = timeit(fp, (mp, Ft), u0)
            print(f"  dot {name}: apply {t_p:7.2f} ms  rel err {err_p:.2e}")

        Fth = Ft.astype(jnp.bfloat16)
        Ftl = (Ft - Fth.astype(jnp.float32)).astype(jnp.bfloat16)

        def apply_split(mft, u):
            m, (fh, fl) = mft
            u_b = gather_ub(m, u)
            uh = u_b.astype(jnp.bfloat16)
            ul = (u_b - uh.astype(jnp.float32)).astype(jnp.bfloat16)
            ein = lambda a, b: jnp.einsum(  # noqa: E731
                "buv,bvc->buc", a, b,
                preferred_element_type=jnp.float32)
            y_b = ein(fh, uh) + ein(fh, ul) + ein(fl, uh)
            return apply_gather_plan(m.plan, y_b.reshape(m.B * m.U, -1))

        err_s = float(jnp.linalg.norm(apply_split((mp, (Fth, Ftl)), u0)
                                      - y_ref) / jnp.linalg.norm(y_ref))
        t_split = timeit(apply_split, (mp, (Fth, Ftl)), u0)
        print(f"  dot split2: apply {t_split:7.2f} ms  rel err {err_s:.2e}")
        print(f"  variants: apply dot {t_apply_dot:7.2f}  apply plain "
              f"{t_apply_plain:7.2f}  build high {t_build_high:7.2f}")
        print(
            f"macro c={mp.c_blk:3d}: build {t_build:7.2f} ms  apply "
            f"{t_apply:7.2f} ms  (build + 4 applies "
            f"{t_build + 4 * t_apply:7.2f} vs element {4 * t_el:7.2f})"
        )


if __name__ == "__main__":
    main()
