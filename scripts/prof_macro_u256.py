"""Sweep the macro-block geometry (U, c_blk): larger blocks cut the
block-overlap factor beta = B*U_used/n, and with it the row count of BOTH
gather phases of every macro F apply (slot gather + bucketed reduce).  The
price is a bigger value stream (B*U^2 grows ~U per node) and a costlier
build.

Prints, per (U, c_blk): block stats, apply phases, split3 build time.

Usage: python scripts/prof_macro_u256.py [lc] [nz]  (default 965k mesh,
cells cached by prof_macro_apply.py's load_or_build).
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from prof_macro_apply import gather_ub, load_or_build, timeit  # noqa: E402

from navierstokes_project_nm4pde_tpu.ops.macroblock import (
    apply_macro,
    build_macro_plan,
    build_macro_values,
    build_macro_values_split3,
)
def main():
    lc = float(sys.argv[1]) if len(sys.argv) > 1 else 0.024
    nz = int(sys.argv[2]) if len(sys.argv) > 2 else 14
    cells_u, n_unodes, n_vertices = load_or_build(lc, nz)
    E = cells_u.shape[0]
    u0 = jax.random.normal(jax.random.PRNGKey(0), (n_unodes, 3), jnp.float32)

    configs = ((192, 34), (256, 48))
    if len(sys.argv) > 3:
        configs = tuple(
            tuple(map(int, s.split(","))) for s in sys.argv[3].split(";")
        )
    for U, cb in configs:
        t0 = time.time()
        try:
            mp = build_macro_plan(
                cells_u, n_unodes, U=U, c_blk=cb, n_vertices=n_vertices
            )
        except ValueError as e:
            print(f"U={U} c={cb}: plan failed: {e}")
            continue
        jax.block_until_ready(mp.onehot)
        used = int((np.asarray(mp.uidx) < n_unodes).sum())
        beta = used / n_unodes
        mb = mp.B * mp.U * mp.U * 4 / 1e6
        print(
            f"U={U} c_blk={mp.c_blk} (asked {cb}): B={mp.B} "
            f"slots={mp.B * mp.U / 1e6:.2f}M used={used / 1e6:.2f}M "
            f"beta={beta:.2f} vals={mb:.0f}MB "
            f"wgather={'none' if mp.wgather is None else mp.wgather.window_rows} "
            f"plan {time.time() - t0:.0f}s"
        )
        Ft = jax.random.normal(
            jax.random.PRNGKey(1), (mp.B, U, U), jnp.float32
        ) / U

        t = timeit(lambda m, u: gather_ub(m, u)[:, 0, 0], mp, u0)
        print(f"  gather u_b            : {t:7.2f} ms")

        t = timeit(
            lambda mft, u: apply_macro(mft[0], mft[1], u), (mp, Ft), u0
        )
        print(f"  apply full            : {t:7.2f} ms")

        nl = cells_u.shape[1]
        Fe = jax.random.normal(
            jax.random.PRNGKey(2), (E, nl, nl), jnp.float32
        ) / nl
        ref = jax.jit(build_macro_values)(mp, Fe)
        out = jax.jit(build_macro_values_split3)(mp, Fe)
        err = float(jnp.linalg.norm(out - ref) / jnp.linalg.norm(ref))
        t = timeit(
            lambda m, fe: build_macro_values_split3(m, fe)[:, 0, 0], mp, Fe
        )
        print(f"  build split3          : {t:7.2f} ms  rel err {err:.1e}")
        t = timeit(
            lambda m, fe: build_macro_values(m, fe)[:, 0, 0], mp, Fe
        )
        print(f"  build highest         : {t:7.2f} ms")
        del mp, Ft, Fe, ref, out


if __name__ == "__main__":
    main()
