"""Supernode block-sparse (block-ELL) applies for the CONSTANT operators.

Grouping `bs` consecutive nodes into one supernode makes every gathered
row a [bs] panel (512 B at bs=128), so an assembled operator whose sparsity
follows the supernode adjacency gathers few wide rows instead of many
narrow ones, while the dense blocks are one fused multiply-reduce over a
value array streamed from device memory.  (Chosen before the H100 port,
whose gathers were row-rate bound, not byte bound; not yet measured on the
H100 -- ROADMAP S3c.)

Used for the constant blocks of the time step -- the divergence D and the
pressure gradient G = -D^T (the reference's B / -B^T blocks,
ref: src/NavierStokes2D.cpp:259-262), and the constant velocity block
K = M/dt + nu A of the explicit/IMEX steppers.  Values are assembled once
on the host in float64; only nnz-level COO triples go to the device
(the dense block values are materialised by a one-time on-device
scatter).

Value layout:
  * a [rows, W, bs, Cout, bs, Cin] value array with Cin=3 minor is padded
    by (8, 128)-tiled layouts in every trailing dim (51 GB at 965k);
  * at bs=128 the dense 128x128 blocks of the RECTANGULAR D/G are ~6%
    full (4 GB per operator at 965k DoF -- the P2 edge-node numbering
    scatters a p-block's column set over 56-85 velocity blocks).
  So the whole contraction axis is FOLDED into the minor dim: value
  buckets are [rows, Cout, bs, Cin*W*bs] (second-minor bs is a multiple
  of 8, minor is thousands of entries -- no tile padding at ANY bs >= 8),
  and the apply is one batched matvec per bucket.  Small bs keeps the
  blocks dense (bs=32 stores ~exactly the block-pattern nnz); the
  gathered source stays wide because the GATHER granularity is still a
  [bs] panel: the source is PLANAR per input channel, [Cin, nb+1, bs],
  reshaped+transposed to [rows, Cin*W*bs] after the gather (a ~30 MB
  transient repack, not a value-array bloat).

Block rows are VALENCE-BUCKETED: the neighbor-count distribution is
heavy-tailed (at 609k DoF, bs=32: D row blocks average 66 neighbor
blocks but max 120), so a single padded width stores 2-4x the exact block
count.  But every bucket costs a fixed per-op overhead, so the cut points are chosen by a small
DP that minimises padded-entries + per-bucket penalty, capped at
`max_buckets`.  Outputs are restored to natural order by one block-level
gather.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BSRMatrix:
    """Bucketed block-ELL operator [n_rows x n_src], Cout x Cin component
    blocks:

    y[R*bs + a, o] = sum_{i, w, b} vals[R, o, a, (i*W + w)*bs + b]
                                   * x[cols[R, w]*bs + b, i]

    with R running over permuted block rows (buckets concatenated;
    `row_unperm` restores natural block order).  `cols` pads with
    `nb_src` (a zero source block appended at apply time)."""

    cols: tuple  # per bucket [rows_b, W_b] int32 source-block ids
    vals: tuple  # per bucket [rows_b, Cout, bs, Cin*W_b*bs]
    row_unperm: jax.Array  # [NB] int32 block-row inverse permutation
    nb_src: int = dataclasses.field(metadata=dict(static=True))
    n_rows: int = dataclasses.field(metadata=dict(static=True))
    n_src: int = dataclasses.field(metadata=dict(static=True))
    bs: int = dataclasses.field(metadata=dict(static=True))
    cin: int = dataclasses.field(default=1, metadata=dict(static=True))
    # "vpu": broadcast multiply + sum (exact f32 whatever the matmul
    # precision -- see NumericsConfig.element_contraction); "einsum":
    # matmul lowering.
    contraction: str = dataclasses.field(
        default="vpu", metadata=dict(static=True)
    )

    @property
    def cout(self) -> int:
        return self.vals[0].shape[1]

    @property
    def value_bytes(self) -> int:
        return sum(v.size * v.dtype.itemsize for v in self.vals)

    @property
    def gathered_rows(self) -> int:
        return sum(c.shape[0] * c.shape[1] for c in self.cols)


def _bucket_cuts(
    cnt_sorted: np.ndarray, max_buckets: int, penalty: int
) -> list:
    """Cut points into the count-sorted block rows minimising
    sum_t rows_t * W_t + penalty * n_buckets (entries units), by DP over
    the distinct-count boundaries (<= ~max valence of them, so tiny)."""
    NB = len(cnt_sorted)
    bounds = [0]
    for i in range(1, NB):
        if cnt_sorted[i] != cnt_sorted[i - 1]:
            bounds.append(i)
    bounds.append(NB)
    m = len(bounds) - 1
    K = min(max_buckets, m)
    INF = float("inf")
    # dp[j] after k buckets covering bounds[:j+1]
    dp = [INF] * (m + 1)
    dp[0] = 0.0
    back = [[-1] * (m + 1) for _ in range(K + 1)]
    best = (INF, 1, None)
    for k in range(1, K + 1):
        ndp = [INF] * (m + 1)
        for j in range(1, m + 1):
            w = int(cnt_sorted[bounds[j] - 1])
            for i in range(0, j):
                if dp[i] == INF:
                    continue
                c = dp[i] + (bounds[j] - bounds[i]) * w
                if c < ndp[j]:
                    ndp[j] = c
                    back[k][j] = i
        if ndp[m] + k * penalty < best[0]:
            best = (ndp[m] + k * penalty, k, [r[:] for r in back])
        dp = ndp
    _, k_best, back = best
    cuts = [m]
    k = k_best
    while cuts[-1] > 0:
        cuts.append(back[k][cuts[-1]])
        k -= 1
    return [bounds[j] for j in reversed(cuts)]


def build_bsr(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_rows: int,
    n_src: int,
    bs: int = 32,
    dtype=jnp.float32,
    contraction: str = "vpu",
    max_buckets: int = 4,
    bucket_penalty: int = 100_000_000,
) -> BSRMatrix:
    """Build a BSRMatrix from COO triples (duplicate (row, col) pairs must
    already be merged).  `vals` is [nnz, Cout, Cin] ([nnz] => 1x1 blocks).

    Host side computes the block pattern, the valence buckets, and flat
    scatter indices; the dense value arrays are materialised on device
    by ONE sorted unique scatter (a per-bucket scatter would cost a
    compile each)."""
    rows = np.asarray(rows, dtype=np.int64).reshape(-1)
    cols = np.asarray(cols, dtype=np.int64).reshape(-1)
    vals = np.asarray(vals)
    if vals.ndim == 1:
        vals = vals[:, None, None]
    nnz, Cout, Cin = vals.shape
    NB = -(-n_rows // bs)
    nb_src = -(-n_src // bs)

    I = rows // bs
    a = rows % bs
    J = cols // bs
    b = cols % bs

    # Block pattern: unique (I, J), sorted so one row's blocks are runs.
    key = I * nb_src + J
    uniq, inv = np.unique(key, return_inverse=True)
    bI = uniq // nb_src
    bJ = uniq % nb_src
    counts = np.bincount(bI, minlength=NB)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])

    # Valence buckets over block rows: DP cut points (see module doc).
    row_order = np.argsort(counts, kind="stable")
    unperm = np.empty(NB, dtype=np.int64)
    unperm[row_order] = np.arange(NB)
    cnt_sorted = counts[row_order]
    cuts = _bucket_cuts(
        cnt_sorted, max_buckets, bucket_penalty // (bs * bs * Cout * Cin)
    )

    # Per block: its bucket, its (local) row within the bucket, its slot.
    bucket_of_row = np.empty(NB, dtype=np.int64)
    local_row = np.empty(NB, dtype=np.int64)
    widths = []
    for t in range(len(cuts) - 1):
        rows_t = row_order[cuts[t]:cuts[t + 1]]
        bucket_of_row[rows_t] = t
        local_row[rows_t] = np.arange(len(rows_t))
        widths.append(max(int(counts[rows_t].max()) if rows_t.size else 1, 1))
    slot_of_block = np.arange(len(uniq)) - starts[bI]  # w slot per block

    # Column tables + ONE flat dense index per nnz component entry: all
    # buckets share a single concatenated value array so the one-time
    # device materialisation is ONE sorted scatter.
    col_tabs = []
    bucket_sizes = []
    for t in range(len(cuts) - 1):
        rows_t = row_order[cuts[t]:cuts[t + 1]]
        W = widths[t]
        ct = np.full((len(rows_t), W), nb_src, dtype=np.int64)
        sel_blocks = bucket_of_row[bI] == t
        ct[local_row[bI[sel_blocks]], slot_of_block[sel_blocks]] = bJ[
            sel_blocks
        ]
        col_tabs.append(jnp.asarray(ct, jnp.int32))
        bucket_sizes.append(len(rows_t) * bs * Cout * Cin * W * bs)
    offsets = np.concatenate([[0], np.cumsum(bucket_sizes)])
    N_total = int(offsets[-1])
    if N_total >= np.iinfo(np.int32).max:
        raise ValueError(
            f"BSR dense value array too large for int32 indexing "
            f"({N_total}); reduce bs"
        )

    # Flat index of entry (lr, o, a, i, w, b) inside bucket t's
    # [rows_t, Cout, bs, Cin*W_t*bs] value array.
    blk = inv  # block id per nnz entry
    t_of = bucket_of_row[bI[blk]]
    W_of = np.asarray(widths)[t_of]
    slot = slot_of_block[blk]
    lr = local_row[bI[blk]]
    lane = Cin * W_of * bs
    base = offsets[t_of] + (lr * Cout) * bs * lane + a * lane + (
        slot * bs + b
    )
    o_idx = np.arange(Cout, dtype=np.int64)
    i_idx = np.arange(Cin, dtype=np.int64)
    step_o = (bs * lane)[:, None, None] * o_idx[None, :, None]
    step_i = (W_of * bs)[:, None, None] * i_idx[None, None, :]
    flat = (base[:, None, None] + step_o + step_i).reshape(-1)
    v_flat = vals.reshape(-1)
    keep = v_flat != 0.0
    flat, v_flat = flat[keep], v_flat[keep]
    order = np.argsort(flat)
    flat, v_flat = flat[order], v_flat[order]
    dense = (
        jnp.zeros((max(N_total, 1),), dtype)
        .at[jnp.asarray(flat, jnp.int32)]
        .set(
            jnp.asarray(v_flat, dtype),
            unique_indices=True,
            indices_are_sorted=True,
        )
    )
    val_tabs = []
    for t in range(len(cuts) - 1):
        rows_t = cuts[t + 1] - cuts[t]
        W = widths[t]
        seg = jax.lax.slice_in_dim(
            dense, int(offsets[t]), int(offsets[t + 1])
        )
        val_tabs.append(
            seg.reshape(max(rows_t, 1), Cout, bs, Cin * W * bs)[:rows_t]
        )

    return BSRMatrix(
        cols=tuple(col_tabs),
        vals=tuple(val_tabs),
        row_unperm=jnp.asarray(unperm, jnp.int32),
        nb_src=nb_src,
        n_rows=n_rows,
        n_src=n_src,
        bs=bs,
        cin=Cin,
        contraction=contraction,
    )


def _pad_source(m: BSRMatrix, x: jax.Array) -> jax.Array:
    """[n_src, C] -> [C, nb_src + 1, bs] planar blocks with a trailing
    zero pad block (bs-wide gather rows, no tiny minor dim)."""
    C = x.shape[1]
    pad = m.nb_src * m.bs - m.n_src
    xp = jnp.concatenate([x, jnp.zeros((pad + m.bs, C), x.dtype)], axis=0)
    return xp.reshape(m.nb_src + 1, m.bs, C).transpose(2, 0, 1)


def _unpermute(m: BSRMatrix, outs: list, cout: int) -> jax.Array:
    y = outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=0)
    y = y[m.row_unperm]  # [NB, bs, Cout] block-level gather (wide rows)
    return y.reshape(-1, cout)[: m.n_rows]


def apply_bsr(m: BSRMatrix, x: jax.Array) -> jax.Array:
    """y = A x: [n_src, Cin] -> [n_rows, Cout]."""
    xb = _pad_source(m, x)  # [Cin, nb+1, bs]
    outs = []
    for ct, vt in zip(m.cols, m.vals):
        g = xb[:, ct]  # [Cin, rows_b, W, bs] -- bs-wide row gather
        g2 = g.transpose(1, 0, 2, 3).reshape(ct.shape[0], -1)
        if m.contraction == "vpu":
            y = (vt * g2[:, None, None, :]).sum(axis=-1)  # [n, Cout, bs]
        else:
            y = jnp.einsum("noal,nl->noa", vt, g2)
        outs.append(y.transpose(0, 2, 1))  # [n, bs, Cout]
    return _unpermute(m, outs, m.cout)


def apply_bsr_scalar(m: BSRMatrix, x: jax.Array) -> jax.Array:
    """y = (A x_c) per channel c for a scalar-block BSRMatrix (1x1
    component blocks): [n_src, C] -> [n_rows, C].  The velocity block
    K = M/dt + nu A is component-diagonal, so one scalar operator serves
    all dim channels of the [n, dim] state; the channel axis rides as a
    free batch dim of the contraction (the value stream is read once)."""
    xb = _pad_source(m, x)  # [C, nb+1, bs]
    C = x.shape[1]
    outs = []
    for ct, vt in zip(m.cols, m.vals):
        g = xb[:, ct].reshape(C, ct.shape[0], -1)  # [C, rows_b, W*bs]
        vk = vt[:, 0]  # [rows_b, bs, W*bs]
        if m.contraction == "vpu":
            y = (vk[None] * g[:, :, None, :]).sum(axis=-1)  # [C, n, bs]
            y = y.transpose(1, 2, 0)
        else:
            y = jnp.einsum("nal,cnl->nac", vk, g)
        outs.append(y)  # [n, bs, C]
    return _unpermute(m, outs, C)


def build_velocity_kbsr(
    space, geom, tables, nu: float, dt: float, bs: int = 32,
    dtype=jnp.float32, contraction: str = "vpu",
) -> BSRMatrix:
    """Assemble the CONSTANT velocity block K = M/dt + nu A once into the
    supernode BSR form (scalar blocks; K is component-diagonal).

    The reference assembles M and A once and reuses them across steps
    (ref: src/NavierStokes2D.cpp:164, :387-390); with convection explicit
    or IMEX-partitioned the whole remaining block is constant, so every
    Krylov iteration becomes wide-row block gathers + one streamed value
    array instead of the element gather+reduce pass."""
    import scipy.sparse as sp

    t = tables
    n = space.n_unodes
    nloc = t.MHAT.shape[0]
    GKd = np.einsum("ekd,eld->ekl", geom.Jinv, geom.Jinv) * geom.detJ[
        :, None, None
    ]
    K_e = (geom.detJ / dt)[:, None, None] * t.MHAT[None]
    K_e = K_e + nu * np.einsum("ekl,klij->eij", GKd, t.AHAT)
    cells = np.asarray(space.cells_u, dtype=np.int64)
    rows = np.repeat(cells, nloc, axis=1).reshape(-1)
    cols = np.tile(cells, (1, nloc)).reshape(-1)
    csr = sp.csr_matrix((K_e.reshape(-1), (rows, cols)), shape=(n, n))
    csr.sum_duplicates()
    coo = csr.tocoo()
    return build_bsr(
        coo.row, coo.col, coo.data[:, None, None], n, n,
        bs=bs, dtype=dtype, contraction=contraction,
    )


# ----------------------------------------------------------------------
# D / G construction from the host divergence ELL
# ----------------------------------------------------------------------
def _divergence_coo(schur_host: dict):
    """COO triples of D from the host ELL (`schur_host["D_cols"/"D_vals"]`,
    [n_p, Wd] cols / [n_p, Wd, dim] vals, duplicates pre-merged)."""
    D_cols, D_vals = schur_host["D_cols"], schur_host["D_vals"]
    n_p, Wd = D_cols.shape
    keep = (D_vals != 0.0).any(axis=-1)
    rows = np.broadcast_to(np.arange(n_p)[:, None], (n_p, Wd))[keep]
    cols = D_cols[keep]
    vals = D_vals[keep]  # [nnz, dim]
    return rows, cols, vals


def build_divergence_bsr(
    schur_host: dict, n_unodes: int, n_pnodes: int, bs: int = 32,
    dtype=jnp.float32, contraction: str = "vpu",
) -> BSRMatrix:
    """D as a BSR operator: u [n_unodes, dim] -> D u [n_pnodes]
    (apply via `apply_bsr(dbsr, u)[:, 0]`)."""
    rows, cols, vals = _divergence_coo(schur_host)
    return build_bsr(
        rows, cols, vals[:, None, :], n_pnodes, n_unodes,
        bs=bs, dtype=dtype, contraction=contraction,
    )


def build_gradient_bsr(
    schur_host: dict, n_unodes: int, n_pnodes: int, bs: int = 32,
    dtype=jnp.float32, contraction: str = "vpu",
) -> BSRMatrix:
    """G = -D^T as a BSR operator: p [n_pnodes, 1] -> G p [n_unodes, dim]
    (apply via `apply_bsr(gbsr, p[:, None])`)."""
    rows, cols, vals = _divergence_coo(schur_host)
    return build_bsr(
        cols, rows, -vals[:, :, None], n_unodes, n_pnodes,
        bs=bs, dtype=dtype, contraction=contraction,
    )
