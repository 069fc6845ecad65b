"""Block-banded dense form of the frozen projection Schur operator.

The ELL SpMV on the pressure Schur S1 = D diag(M)^-1 D^T gathers ~n_p * W
SCALAR elements of p (4-byte rows), and the Schur CG pays that gather every
iteration (a row-rate-bound cost before the H100 port; not yet measured on
the H100 -- ROADMAP S3).  But the frozen S1 never changes, and after the mesh's RCM spatial reordering its pattern is BANDED:
every row's columns lie inside a contiguous window of width ~2x the vertex
RCM bandwidth.  This module restructures S1 once at setup into

    vals  [n_blk, R, W]   dense banded values (R consecutive rows per block
                          share one column window; zero where no entry)
    tiles [n_blk, T]      static 128-wide tile ids of each block's window

so the SpMV becomes

    win = p2d[tiles]             # [n_blk, T, 128]: a few THOUSAND 512-byte
                                 # row gathers instead of ~n_p * W scalars
    y   = einsum('brw,bw->br', vals, win.reshape(n_blk, W))   # batched

The matmul is bound by reading `vals` (~100-500 MB at bench sizes) from
device memory.  Only worthwhile
because S1 is FROZEN: the dense banded values would cost a scatter per step
otherwise.  (Reference analogue: the Trilinos sparse mmult S~ the frozen
path replaces, ref: include/Preconditioners.hpp:144,248.)
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

TILE = 128


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BandedSchur:
    """Static block-banded structure (see module docstring)."""

    vals: jax.Array  # [n_blk, R, W] dense banded values
    tiles: jax.Array  # [n_blk, T] int32 tile ids into the padded p (T*128=W)
    n_rows: int = dataclasses.field(metadata=dict(static=True))
    n_tiles_pad: int = dataclasses.field(metadata=dict(static=True))


def build_banded_schur(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_rows: int,
    block_rows: int = 128,
    dtype=jnp.float32,
    max_bytes: int = 2 << 30,
) -> BandedSchur | None:
    """Build the banded form from COO triplets (host-side, one-time).

    Returns None when the pattern is not band-limited enough for the dense
    values to fit under `max_bytes` (caller falls back to the ELL SpMV).
    """
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)

    R = block_rows
    n_blk = -(-n_rows // R)
    blk = rows // R

    # Per-block column window, tile-aligned.
    bmin = np.full(n_blk, n_rows, np.int64)
    bmax = np.full(n_blk, 0, np.int64)
    np.minimum.at(bmin, blk, cols)
    np.maximum.at(bmax, blk, cols)
    start = (bmin // TILE) * TILE
    width = bmax - start + 1
    T = int(-(-width.max() // TILE)) if n_blk else 1
    W = T * TILE
    nbytes = n_blk * R * W * np.dtype(np.float32).itemsize
    if nbytes > max_bytes:
        return None

    # Keep every window inside the padded vector: tiles index into p padded
    # to n_tiles_pad * TILE zeros past n_rows.
    n_tiles_p = -(-n_rows // TILE)
    n_tiles_pad = max(n_tiles_p, int((start // TILE).max()) + T if n_blk else T)

    dense = np.zeros((n_blk, R, W), np.float32)
    dense[blk, rows % R, cols - start[blk]] = vals

    tiles = (start // TILE)[:, None] + np.arange(T)[None, :]
    return BandedSchur(
        vals=jnp.asarray(dense, dtype),
        tiles=jnp.asarray(tiles, jnp.int32),
        n_rows=n_rows,
        n_tiles_pad=int(n_tiles_pad),
    )


def banded_matvec(b: BandedSchur, p: jax.Array) -> jax.Array:
    """Exact S1 @ p via window row-gather + batched dense matvec."""
    pad = b.n_tiles_pad * TILE - p.shape[0]
    p2d = jnp.concatenate([p, jnp.zeros((pad,), p.dtype)]).reshape(-1, TILE)
    n_blk, T = b.tiles.shape
    win = p2d[b.tiles].reshape(n_blk, T * TILE)
    y = jnp.einsum("brw,bw->br", b.vals, win)
    return y.reshape(-1)[: b.n_rows]
