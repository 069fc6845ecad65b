"""Probe the XLA gather row rate as a function of SOURCE array size.

Before the H100 port the forward gather (u[cells], source = the [n_u, d]
node array) ran 2.4-3x faster per row than every reduce-side variant
(source = the [slots, d] element-output array) at IDENTICAL gathered row
counts.  Hypothesis: the per-row cost is bound by the source working set
(a source in fast on-chip memory -> fast row copies), not by the access
pattern.  Not yet measured on the H100.  This script gathers the SAME
number of rows (random permutation, pure row-copy pattern) from sources of
increasing size and reports ns/row.

Usage:  python scripts/prof_gather_rate.py            (on the GPU)
        JAX_PLATFORMS=cpu python scripts/...          (sanity only)
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def time_gather(n_src: int, n_rows: int, c: int, reps: int = 8) -> float:
    """Milliseconds per gather of n_rows rows from an [n_src, c] source,
    chained inside one jit so the dispatch/async overheads amortize."""
    rng = np.random.default_rng(0)
    src = jnp.asarray(rng.normal(size=(n_src, c)).astype(np.float32))
    idx = jnp.asarray(rng.integers(0, n_src, size=n_rows).astype(np.int32))

    @jax.jit
    def run(src, idx):
        def body(i, acc):
            # loop-counter-dependent indices: cannot be hoisted or CSE'd;
            # every gathered row is consumed so DCE cannot shrink the
            # gather.
            j = (idx + i) % n_src
            y = src[j]
            return 0.5 * acc + y

        return jax.lax.fori_loop(
            0, reps, body, jnp.zeros((n_rows, src.shape[1]), jnp.float32)
        ).sum()

    # float() readback: a host read of a value that depends on the whole
    # loop is the completion barrier.
    float(run(src, idx))  # compile
    float(run(src, idx))  # second warm run
    t0 = time.perf_counter()
    float(run(src, idx))
    return (time.perf_counter() - t0) / reps * 1e3


def time_windowed(n_src: int, n_rows: int, c: int, window: int,
                  reps: int = 8) -> float:
    """Same total rows, but gathered block-by-block from a dynamic-sliced
    contiguous WINDOW of the source (the candidate fix if the plain rate
    is source-working-set bound): scan over n_blocks blocks; each block
    dynamic-slices [window, c] from the source (contiguous HBM stream)
    and gathers its rows from that small array with window-local indices.
    Mirrors an RCM-localized reduce plan where every destination block's
    contributing slots live in a bounded span."""
    rng = np.random.default_rng(0)
    src = jnp.asarray(rng.normal(size=(n_src, c)).astype(np.float32))
    n_blocks = max(1, n_rows // 65536)
    rows_per_block = n_rows // n_blocks
    starts_np = np.linspace(
        0, max(1, n_src - window), n_blocks
    ).astype(np.int32)
    local_np = rng.integers(
        0, window, size=(n_blocks, rows_per_block)
    ).astype(np.int32)
    starts = jnp.asarray(starts_np)
    local = jnp.asarray(local_np)

    @jax.jit
    def run(src, starts, local):
        def outer(i, acc):
            def body(carry, blk):
                start, idx = blk
                win = jax.lax.dynamic_slice(
                    src, (start, 0), (window, src.shape[1])
                )
                rows = win[(idx + i) % window]
                return carry + rows.sum(), None

            tot, _ = jax.lax.scan(body, 0.0, (starts, local))
            return 0.5 * acc + tot

        return jax.lax.fori_loop(0, reps, outer, 0.0)

    float(run(src, starts, local))
    float(run(src, starts, local))
    t0 = time.perf_counter()
    float(run(src, starts, local))
    total = n_blocks * rows_per_block
    return (time.perf_counter() - t0) / reps * 1e3, total


def main():
    n_rows = 2_000_000
    c = 3  # 12 B rows (the single-run velocity payload)
    print(f"# gathering {n_rows} rows of {4 * c} B each; varying source size")
    print(f"{'src rows':>12} {'src MB':>8} {'ms':>8} {'ns/row':>8}")
    for n_src in (200_000, 650_000, 1_300_000, 2_600_000, 5_200_000,
                  10_400_000):
        ms = time_gather(n_src, n_rows, c)
        mb = n_src * 4 * c / 1e6
        print(f"{n_src:>12} {mb:>8.1f} {ms:>8.2f} {ms * 1e6 / n_rows:>8.2f}")
    print("# windowed (dynamic-slice + local gather) from the largest source")
    print(f"{'window':>12} {'win MB':>8} {'ms':>8} {'ns/row':>8}")
    for window in (8_192, 32_768, 131_072, 524_288):
        ms, total = time_windowed(2_600_000, n_rows, c, window)
        mb = window * 4 * c / 1e6
        print(f"{window:>12} {mb:>8.1f} {ms:>8.2f} {ms * 1e6 / total:>8.2f}")


if __name__ == "__main__":
    main()
