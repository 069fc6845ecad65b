"""A/B the macro F apply engines at bench scale: HIGHEST (6-pass bf16
emulation re-streaming the f32 values) vs the pre-split bf16 split3 apply
(one stream of each half-size part), plus the per-step cost of splitting
the values.

Usage: python scripts/prof_macro_apply_split3.py [lc] [nz]
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from prof_macro_apply import load_or_build, timeit  # noqa: E402

from navierstokes_project_nm4pde_tpu.ops.macroblock import (  # noqa: E402
    apply_macro,
    apply_macro_split3,
    build_macro_plan,
    split3_values,
)


def main():
    lc = float(sys.argv[1]) if len(sys.argv) > 1 else 0.024
    nz = int(sys.argv[2]) if len(sys.argv) > 2 else 14
    cells_u, n_unodes, n_vertices = load_or_build(lc, nz)
    mp = build_macro_plan(
        cells_u, n_unodes, U=128, c_blk=20, n_vertices=n_vertices
    )
    jax.block_until_ready(mp.onehot)
    print(f"# B={mp.B} n={n_unodes}", file=sys.stderr)

    u0 = jax.random.normal(jax.random.PRNGKey(0), (n_unodes, 3), jnp.float32)
    Ft = jax.random.normal(
        jax.random.PRNGKey(1), (mp.B, mp.U, mp.U), jnp.float32
    ) / mp.U

    y_ref = jax.jit(lambda f, u: apply_macro(mp, f, u))(Ft, u0)
    Ft3 = jax.jit(split3_values)(Ft)
    y_s3 = jax.jit(lambda f3, u: apply_macro_split3(mp, f3, u))(Ft3, u0)
    err = float(
        jnp.linalg.norm(y_s3 - y_ref) / jnp.linalg.norm(y_ref)
    )
    print(f"rel err split3 vs highest: {err:.2e}")

    t = timeit(lambda f, u: apply_macro(mp, f, u)[:, 0], Ft, u0)
    print(f"apply highest        : {t:7.2f} ms")
    t = timeit(lambda f3, u: apply_macro_split3(mp, f3, u)[:, 0], Ft3, u0)
    print(f"apply split3 (presplit): {t:7.2f} ms")
    t = timeit(
        lambda f, u: split3_values(f)[0][:, 0, 0] + u[: mp.B, 0], Ft, u0
    )
    print(f"split3_values (per step): {t:7.2f} ms")


if __name__ == "__main__":
    main()
