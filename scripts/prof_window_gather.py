"""A/B the forward element DoF gather: plain u[cells_u] vs a windowed form.

Before the H100 port the gather row rate was SOURCE-working-set bound
(scripts/prof_gather_rate.py), so gathering block-by-block from a
dynamic-sliced <=0.5 MB window beat the few-MB node array; not yet
measured on the H100.  Unlike the windowed REDUCE (rejected: segment-max
valence padding + window overlap re-streaming a tens-of-MB source), the forward gather has NO padding (every
slot is exactly one row) and its source is only a few MB (overlap
re-streaming is noise), so the windowed rate should survive intact.

P2 wrinkle: cells_u references two first-touch-numbered bands (vertices
[0, n_v), edges [n_v, n_u)) -- one window per band per block, gathered from
their concatenation with band-offset local indices.

Usage: python scripts/prof_window_gather.py   (on the GPU; NS_LC/NS_NZ to size)
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def build_windows(cells_u: np.ndarray, n_vertices: int, n_unodes: int,
                  cpb: int, align: int = 512):
    """Per-block (vstart, estart) + band-local index table.

    Returns (vstarts, estarts, local [nb, cpb, nloc], Wv, We, nb, pad_cells).
    Local index encodes: idx < Wv -> vertex window row; else We row Wv+k.
    """
    E, nloc = cells_u.shape
    nb = -(-E // cpb)
    pad = nb * cpb - E
    cells = np.concatenate(
        [cells_u, np.repeat(cells_u[-1:], pad, axis=0)], axis=0
    ) if pad else cells_u
    blk = cells.reshape(nb, cpb, nloc)
    isv = blk < n_vertices
    vmin = np.where(isv, blk, n_vertices).reshape(nb, -1).min(axis=1)
    vmax = np.where(isv, blk, -1).reshape(nb, -1).max(axis=1)
    emin = np.where(~isv, blk, n_unodes).reshape(nb, -1).min(axis=1)
    emax = np.where(~isv, blk, -1).reshape(nb, -1).max(axis=1)
    vmin = np.minimum(vmin, np.maximum(vmax, 0))
    emin = np.minimum(emin, np.maximum(emax, n_vertices))
    vstart = np.maximum(vmin - vmin % align, 0)
    estart = np.maximum(emin - (emin - n_vertices) % align, n_vertices)
    Wv = int((vmax - vstart).max()) + 1
    We = int((emax - estart).max()) + 1
    Wv = min(-(-Wv // align) * align, n_vertices)
    We = min(-(-We // align) * align, n_unodes - n_vertices)
    vstart = np.minimum(vstart, n_vertices - Wv)
    estart = np.minimum(estart, n_unodes - We)
    local = np.where(
        isv,
        blk - vstart[:, None, None],
        Wv + blk - estart[:, None, None],
    )
    assert local.min() >= 0 and local.max() < Wv + We
    return (
        jnp.asarray(vstart, jnp.int32),
        jnp.asarray(estart, jnp.int32),
        jnp.asarray(local, jnp.int32),
        Wv, We, nb, pad,
    )


def main():
    lc = float(os.environ.get("NS_LC", "0.028"))
    nz = int(os.environ.get("NS_NZ", "12"))
    c = int(os.environ.get("NS_C", "3"))
    reps = 8

    from navierstokes_project_nm4pde_tpu.fem.space import build_taylor_hood
    from navierstokes_project_nm4pde_tpu.mesh import cylinder_duct_3d

    t0 = time.time()
    mesh = cylinder_duct_3d(lc=lc, nz=nz).reorder_spatial("rcm")
    space = build_taylor_hood(mesh)
    cells_u = np.asarray(space.cells_u)
    E, nloc = cells_u.shape
    n = space.n_unodes
    print(f"# mesh {E} cells, {n} unodes ({mesh.n_vertices} verts); "
          f"host build {time.time() - t0:.1f}s", file=sys.stderr)

    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.normal(size=(n, c)).astype(np.float32))
    cells_d = jnp.asarray(cells_u.astype(np.int32))

    def bench(fn, *args):
        @jax.jit
        def run(u, *args):
            def body(i, acc):
                y = fn(u + acc[0, 0, 0], *args)
                return 0.5 * acc + y
            return jax.lax.fori_loop(
                0, reps, body, jnp.zeros((E, nloc, c), jnp.float32)
            ).sum()

        float(run(u, *args))
        float(run(u, *args))
        t0 = time.perf_counter()
        v = float(run(u, *args))
        return (time.perf_counter() - t0) / reps * 1e3, v

    def plain(u, cells):
        return u[cells]

    ms0, _ = bench(plain, cells_d)
    rows = E * nloc
    print(f"plain      {ms0:8.2f} ms  {ms0 * 1e6 / rows:5.2f} ns/row")

    for cpb in (2048, 4096, 8192):
        vs, es, local, Wv, We, nb, pad = build_windows(
            cells_u, mesh.n_vertices, n, cpb
        )
        mb = (Wv + We) * 4 * c / 1e6

        def windowed(u, vs, es, local, Wv=Wv, We=We):
            def body(carry, blk):
                v0, e0, tab = blk
                wv = jax.lax.dynamic_slice(u, (v0, 0), (Wv, c))
                we = jax.lax.dynamic_slice(u, (e0, 0), (We, c))
                win = jnp.concatenate([wv, we], axis=0)
                return carry, win[tab]
            _, o = jax.lax.scan(body, None, (vs, es, local))
            return o.reshape(-1, nloc, c)[:E]

        # exactness
        ref = np.asarray(u)[cells_u]
        got = np.asarray(jax.jit(windowed)(u, vs, es, local))
        assert np.array_equal(got, ref), "windowed gather mismatch"
        ms, _ = bench(windowed, vs, es, local)
        print(
            f"cpb={cpb:5d} {ms:8.2f} ms  {ms * 1e6 / rows:5.2f} ns/row  "
            f"(window {mb:.2f} MB = {Wv}+{We} rows, {nb} blocks)"
        )


if __name__ == "__main__":
    main()
