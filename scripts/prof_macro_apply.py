"""Decompose the macro-element block apply (ops/macroblock.py) into its
gather / matvec / reduce phases and A/B matvec layouts, using a cached
mesh so re-runs skip the host setup.

The matvec is a batched [U, V] x [V, C] with C=3: the narrow operand sits
in the minor dim.  The transposed form [C, V] x [V, U] puts the wide axis
minor (the same orientation the one-hot BUILD einsums use).  This script times both plus
the raw Ft stream floor.

Usage: python scripts/prof_macro_apply.py [lc] [nz]  (default 965k)
Cache: .jax_cache/macro_apply_cache_{lc}_{nz}.npz in the checkout
(cells_u only; values are random -- apply timing does not need the real
operator).
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from navierstokes_project_nm4pde_tpu.ops.macroblock import (
    apply_macro,
    build_macro_plan,
)
from navierstokes_project_nm4pde_tpu.ops.scatter import (
    apply_gather_plan,
    apply_windowed_gather,
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


def load_or_build(lc: float, nz: int):
    tag = f"{lc:g}_{nz}"
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache", f"macro_apply_cache_{tag}.npz",
    )
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        d = np.load(path)
        return d["cells_u"], int(d["n_unodes"]), int(d["n_vertices"])
    from navierstokes_project_nm4pde_tpu.fem.space import build_taylor_hood
    from navierstokes_project_nm4pde_tpu.mesh import cylinder_duct_3d

    mesh = cylinder_duct_3d(lc=lc, nz=nz).reorder_spatial("rcm")
    space = build_taylor_hood(mesh)
    cells_u = np.asarray(space.cells_u)
    np.savez(
        path, cells_u=cells_u, n_unodes=space.n_unodes,
        n_vertices=mesh.n_vertices,
    )
    return cells_u, space.n_unodes, mesh.n_vertices


def gather_ub(m, u):
    if m.wgather is not None:
        return apply_windowed_gather(m.wgather, u)
    xb = jnp.concatenate([u, jnp.zeros((1, u.shape[1]), u.dtype)], axis=0)
    return xb[m.uidx]


def main():
    lc = float(sys.argv[1]) if len(sys.argv) > 1 else 0.024
    nz = int(sys.argv[2]) if len(sys.argv) > 2 else 14
    t0 = time.time()
    cells_u, n_unodes, n_vertices = load_or_build(lc, nz)
    mp = build_macro_plan(
        cells_u, n_unodes, U=128, c_blk=20, n_vertices=n_vertices
    )
    jax.block_until_ready(mp.onehot)
    E = cells_u.shape[0]
    print(
        f"# E={E} n={n_unodes} B={mp.B}; setup {time.time() - t0:.1f}s",
        file=sys.stderr,
    )
    key = jax.random.PRNGKey(0)
    u0 = jax.random.normal(key, (n_unodes, 3), jnp.float32)
    Ft = jax.random.normal(jax.random.PRNGKey(1), (mp.B, 128, 128),
                           jnp.float32) / 128.0
    FtT = jnp.swapaxes(Ft, 1, 2)  # [B, V, U]
    HI = jax.lax.Precision.HIGHEST

    y_ref = apply_macro(mp, Ft, u0)

    # raw stream floor: one pass over Ft
    t = timeit(lambda f, u: jnp.sum(f, axis=(1, 2)) + u[: mp.B, 0], Ft, u0)
    print(f"stream Ft (712 MB)      : {t:7.2f} ms")

    # gather only
    t = timeit(lambda m, u: gather_ub(m, u)[:, 0, 0], mp, u0)
    print(f"gather u_b              : {t:7.2f} ms")

    # gather + matvec (reduce elided; scalar consume keeps the matvec)
    def gm(mft, u):
        m, f = mft
        u_b = gather_ub(m, u)
        y_b = jnp.einsum("buv,bvc->buc", f, u_b, precision=HI)
        return y_b[:, 0, 0]

    t = timeit(gm, (mp, Ft), u0)
    print(f"gather+matvec (buv,bvc) : {t:7.2f} ms")

    # transposed matvec: wide axis in lanes on both operands
    def gmt(mft, u):
        m, f = mft
        u_b = gather_ub(m, u)  # [B, V, C]
        u_t = jnp.swapaxes(u_b, 1, 2)  # [B, C, V]
        y_t = jnp.einsum("bcv,bvu->bcu", u_t, f, precision=HI)
        return y_t[:, 0, 0]

    t = timeit(gmt, (mp, FtT), u0)
    print(f"gather+matvecT (bcv,bvu): {t:7.2f} ms")

    # full transposed apply (gather + matvecT + transpose-back + reduce)
    def apply_t(mft, u):
        m, f = mft
        u_b = gather_ub(m, u)
        u_t = jnp.swapaxes(u_b, 1, 2)
        y_t = jnp.einsum("bcv,bvu->bcu", u_t, f, precision=HI)
        y_b = jnp.swapaxes(y_t, 1, 2)
        return apply_gather_plan(m.plan, y_b.reshape(m.B * m.U, -1))

    err = float(
        jnp.linalg.norm(apply_t((mp, FtT), u0) - y_ref)
        / jnp.linalg.norm(y_ref)
    )
    t_full_t = timeit(apply_t, (mp, FtT), u0)
    print(f"apply transposed        : {t_full_t:7.2f} ms  rel err {err:.1e}")

    # reference: current full apply
    t_full = timeit(lambda mft, u: apply_macro(mft[0], mft[1], u),
                    (mp, Ft), u0)
    print(f"apply current           : {t_full:7.2f} ms")

    # reduce-only estimate
    print(f"# reduce ~ current - gather - matvec = "
          f"{t_full - t:7.2f} (vs gm split)", file=sys.stderr)


def extra_build_reduce(lc=0.024, nz=14):
    """Build-precision ladder + reduce bucketing variants (run after
    main(), or standalone: NS_PROF_EXTRA=1)."""
    from navierstokes_project_nm4pde_tpu.ops.macroblock import (
        build_macro_values,
    )
    from navierstokes_project_nm4pde_tpu.ops.scatter import (
        build_gather_plan_grouped,
    )

    cells_u, n_unodes, n_vertices = load_or_build(lc, nz)
    mp = build_macro_plan(
        cells_u, n_unodes, U=128, c_blk=20, n_vertices=n_vertices
    )
    jax.block_until_ready(mp.onehot)
    E = cells_u.shape[0]
    nl = mp.onehot.shape[2]
    Fe = jax.random.normal(jax.random.PRNGKey(2), (E, nl, nl),
                           jnp.float32) / nl
    Ft_ref = jax.jit(build_macro_values)(mp, Fe)

    t = timeit(lambda m, fe: build_macro_values(m, fe)[:, 0, 0], mp, Fe)
    print(f"build HIGHEST           : {t:7.2f} ms")

    # stage split: where does the build time go?  stage 1 (placement, nloc
    # contraction) vs stage 2 (the [U, c*nloc] x [c*nloc, U] batched GEMM
    # over the 1.1 GB materialised intermediate A)
    HI = jax.lax.Precision.HIGHEST
    B, c, U = mp.B, mp.c_blk, mp.U

    def pad_fe(m, fe):
        nl = fe.shape[1]
        fep = jnp.concatenate(
            [fe, jnp.zeros((m.B * m.c_blk - fe.shape[0], nl, nl),
                           fe.dtype)], 0)
        return fep.reshape(m.B, m.c_blk, nl, nl)

    def stage1(m, fe):
        P = m.onehot.astype(fe.dtype)
        A = jnp.einsum("bciu,bcij->bcju", P, pad_fe(m, fe), precision=HI)
        return A[:, 0, 0, 0]

    t1 = timeit(stage1, mp, Fe)
    print(f"  stage1 HIGHEST        : {t1:7.2f} ms")

    def full_via(m, fe, prec2, split_a=False):
        P = m.onehot.astype(fe.dtype)
        A = jnp.einsum("bciu,bcij->bcju", P, pad_fe(m, fe), precision=HI)
        if not split_a:
            return jnp.einsum("bcju,bcjv->buv", A, P, precision=prec2)
        Ah = A.astype(jnp.bfloat16)
        Al = (A - Ah.astype(jnp.float32)).astype(jnp.bfloat16)
        Pb = m.onehot
        y = jnp.einsum("bcju,bcjv->buv", Ah, Pb,
                       preferred_element_type=jnp.float32)
        y = y + jnp.einsum("bcju,bcjv->buv", Al, Pb,
                           preferred_element_type=jnp.float32)
        return y

    for tag, kw in (
        ("s2 HIGHEST", dict(prec2=HI)),
        ("s2 DEFAULT", dict(prec2=jax.lax.Precision.DEFAULT)),
        ("s2 split-A", dict(prec2=None, split_a=True)),
    ):
        fv = lambda m, fe, kw=kw: full_via(m, fe, **kw)  # noqa: E731
        err = float(jnp.linalg.norm(jax.jit(fv)(mp, Fe) - Ft_ref)
                    / jnp.linalg.norm(Ft_ref))
        t = timeit(lambda m, fe, fv=fv: fv(m, fe)[:, 0, 0], mp, Fe)
        print(f"  {tag}           : {t:7.2f} ms  rel err {err:.1e}")

    def build_prec(m, fe, prec):
        B, c, U = m.B, m.c_blk, m.U
        nl = fe.shape[1]
        fep = jnp.concatenate(
            [fe, jnp.zeros((B * c - fe.shape[0], nl, nl), fe.dtype)], 0
        ).reshape(B, c, nl, nl)
        P = m.onehot  # bf16 already
        if prec == "default":
            A = jnp.einsum("bciu,bcij->bcju", P.astype(jnp.float32), fep)
            return jnp.einsum("bcju,bcjv->buv", A, P.astype(jnp.float32))
        # split chains: F_e decomposed into exact bf16 components; each
        # chain runs at DEFAULT (bf16 operands, f32 accumulate) with the
        # one-hot operand exact in bf16
        comps = []
        r = fep
        for _ in range(3 if prec == "split3" else 2):
            h = r.astype(jnp.bfloat16)
            comps.append(h)
            r = r - h.astype(jnp.float32)
        out = None
        for h in comps:
            A = jnp.einsum("bciu,bcij->bcju", P, h,
                           preferred_element_type=jnp.float32)
            Y = jnp.einsum("bcju,bcjv->buv", A.astype(jnp.bfloat16), P,
                           preferred_element_type=jnp.float32)
            out = Y if out is None else out + Y
        return out

    for prec in ("default", "split2", "split3"):
        f = lambda m, fe, p=prec: build_prec(m, fe, p)[:, 0, 0]  # noqa
        err = float(jnp.linalg.norm(
            jax.jit(lambda m, fe, p=prec: build_prec(m, fe, p))(mp, Fe)
            - Ft_ref) / jnp.linalg.norm(Ft_ref))
        t = timeit(f, mp, Fe)
        print(f"build {prec:8s}        : {t:7.2f} ms  rel err {err:.1e}")

    # NOTE: split2/split3's second einsum truncates A (the placed f32
    # rows) back to bf16 -- the exactness claim needs A's own split; the
    # rel err printed is the honest measure.

    y_flat = jax.random.normal(jax.random.PRNGKey(3), (mp.B * mp.U, 3),
                               jnp.float32)
    t = timeit(lambda p, y: apply_gather_plan(p, y), mp.plan, y_flat)
    print(f"reduce current (2,4,8)  : {t:7.2f} ms")
    uidx = np.asarray(mp.uidx)
    for th in ((1, 2, 3, 4, 6, 8), (1, 2, 3, 4, 5, 6, 8, 12)):
        p2 = build_gather_plan_grouped(
            uidx.reshape(-1), mp.n, thresholds=th, drop_row=mp.n,
            mode="columns",
        )
        rows = sum(t_.shape[0] * t_.shape[1] for t_ in p2.slots)
        t = timeit(lambda p, y: apply_gather_plan(p, y), p2, y_flat)
        print(f"reduce {str(th):24s}: {t:7.2f} ms  ({rows/1e3:.0f}k rows)")


if __name__ == "__main__":
    if os.environ.get("NS_PROF_EXTRA"):
        extra_build_reduce(
            float(sys.argv[1]) if len(sys.argv) > 1 else 0.024,
            int(sys.argv[2]) if len(sys.argv) > 2 else 14,
        )
    else:
        main()
