"""Explicit per-step assembly of the Schur operator S~ = D diag(F)^-1 D^T.

The reference assembles S~ every step with a Trilinos sparse `mmult`
(ref: include/Preconditioners.hpp:144,248,358,468).  Here the *pattern* and
the *pair-product table* are precomputed once per mesh:

    S~[i, j] = sum_k D[i, k] * D[j, k] / dF[k]

Every nonzero (i, j) corresponds to a static list of shared velocity-column
pairs; per time step the values are one gather of 1/dF plus one grouped
gather reduction.  The inner solve then iterates on a tiny pressure-space
SpMV (25-30x smaller than the velocity space) instead of two full
element-space passes per iteration.

Layout: rows are permuted into valence classes so both the SpMV and the
per-step value reduction use tight padded widths (uniform-width ELL would
pad every row to the diagonal's worst case); a cheap inverse-permutation
gather restores natural ordering.  Only the upper triangle is assembled
(S~ is symmetric) and mirrored through a flat gather.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from navierstokes_project_nm4pde_tpu.ops.scatter import (
    GatherPlan,
    apply_gather_plan,
    build_gather_plan_grouped,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SchurELL:
    """Static structure for per-step S~ assembly + SpMV (valence-bucketed)."""

    cols: tuple  # per bucket: [rows_b, W_b] int32 column ids (pad: own row)
    mask: tuple  # per bucket: [rows_b, W_b] 1.0 where a real entry exists
    row_unperm: jax.Array  # [n_p] natural-order restore for SpMV outputs
    slot_base: tuple = dataclasses.field(metadata=dict(static=True))
    # Pair-product assembly table (upper triangle).  None when the operator
    # was built with device_assembly=False (frozen projection Schur: the
    # values are assembled once host-side and these ~230 MB of tables never
    # go to the device).
    prod_vals: jax.Array | None  # [T] D[i,k]*D[j,k] summed over components
    prod_k: jax.Array | None  # [T] int32 velocity node k (for the 1/dF gather)
    plan: GatherPlan | None  # reduces the T products into the flat value slots
    mirror: jax.Array | None  # [n_slots] lower-triangle slots -> upper mirror
    diag_slot: jax.Array | None  # [n_p] flat slot of each diagonal entry

    @property
    def n_rows(self) -> int:
        return self.row_unperm.shape[0]


def build_schur_ell(
    space, D_cols: np.ndarray, D_vals: np.ndarray, dtype=jnp.float32,
    device_assembly: bool = True,
):
    """Precompute the S~ pattern and pair-product table from the ELL rows of
    D (cols [n_p, Wd], vals [n_p, Wd, dim]).

    Returns (SchurELL, host) where `host` is a dict of numpy assembly
    tables (pair products, slot layout, diagonal slots) usable by
    `host_assemble_schur_values` / host coarse assembly.  With
    device_assembly=False the SchurELL carries only the SpMV structure
    (cols/mask/row_unperm) -- the assembly tables stay host-only."""
    n_p, Wd, dim = D_vals.shape
    real = np.abs(D_vals).sum(axis=2) > 0  # [n_p, Wd]

    # Invert D's columns: for each velocity node k, the pressure rows touching it.
    ridx, widx = np.nonzero(real)
    kcol = D_cols[ridx, widx]
    order = np.argsort(kcol, kind="stable")
    kcol_s, ridx_s, widx_s = kcol[order], ridx[order], widx[order]

    # All products D[i,k]*D[j,k] (vectorised pair enumeration per k-run).
    vals_flat = D_vals[ridx_s, widx_s]  # [nnzD, dim]
    uniq_k, k_start = np.unique(kcol_s, return_index=True)
    k_counts = np.diff(np.concatenate([k_start, [len(kcol_s)]]))
    pair_counts = k_counts.astype(np.int64) ** 2
    T = int(pair_counts.sum())
    pk = np.repeat(np.arange(len(uniq_k)), pair_counts)
    pair_off = np.concatenate([[0], np.cumsum(pair_counts)[:-1]])
    within = np.arange(T, dtype=np.int64) - pair_off[pk]
    a = within // k_counts[pk]
    b = within % k_counts[pk]
    gi = k_start[pk] + a
    gj = k_start[pk] + b
    prod_i = ridx_s[gi]
    prod_j = ridx_s[gj]
    prod_val = np.einsum("pd,pd->p", vals_flat[gi], vals_flat[gj])
    prod_k = uniq_k[pk]

    # Unique (i, j) pattern.
    key = prod_i * np.int64(n_p) + prod_j
    uniq_pairs, inv = np.unique(key, return_inverse=True)
    ui = (uniq_pairs // n_p).astype(np.int64)
    uj = (uniq_pairs % n_p).astype(np.int64)
    counts = np.bincount(ui, minlength=n_p)

    # --- valence-bucketed row layout --------------------------------------
    # Two buckets: the wide tail is small, and each extra bucket adds fixed
    # per-op cost to every SpMV (which the inner solve runs ~10-25x per
    # preconditioner application).
    thresholds = (32,)
    kmax = int(counts.max()) if n_p else 1
    widths = [t for t in thresholds if t < kmax] + [max(kmax, 1)]
    cls = np.searchsorted(np.asarray(widths), counts)
    row_order = np.argsort(cls, kind="stable")  # rows grouped by class
    unperm = np.empty(n_p, dtype=np.int64)
    unperm[row_order] = np.arange(n_p)

    # per-row new flat slot base
    Wb = np.asarray(widths)[cls]  # padded width per row (natural order)
    base_grouped = np.concatenate([[0], np.cumsum(Wb[row_order])[:-1]])
    base = np.empty(n_p, dtype=np.int64)
    base[row_order] = base_grouped
    n_slots = int(Wb.sum())

    # within-row slot index of each unique pair (pairs are sorted by (i, j))
    row_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot_in_row = np.arange(len(uniq_pairs)) - row_start[ui]
    pair_flat_slot = base[ui] + slot_in_row  # [n_pairs] bucketed flat slots

    # bucketed cols/mask arrays
    cols_t, mask_t, slot_base = [], [], []
    off = 0
    for bnum, W in enumerate(widths):
        rows_b = row_order[cls[row_order] == bnum]
        cb = np.tile(rows_b[:, None], (1, W))  # pad: own row id
        mb = np.zeros((len(rows_b), W))
        cols_t.append(cb)
        mask_t.append(mb)
        slot_base.append(off)
        off += len(rows_b) * W
    # fill entries
    for bnum, W in enumerate(widths):
        rows_b = row_order[cls[row_order] == bnum]
        sel = cls[ui] == bnum
        # local row position within bucket
        pos_in_bucket = (base[ui[sel]] - slot_base[bnum]) // W
        cols_t[bnum][pos_in_bucket, slot_in_row[sel]] = uj[sel]
        mask_t[bnum][pos_in_bucket, slot_in_row[sel]] = 1.0

    # symmetry: only i <= j products are reduced; mirror the rest
    upper = prod_i <= prod_j
    prod_slot = pair_flat_slot[inv][upper]
    prod_val = prod_val[upper]
    prod_k_u = prod_k[upper]

    mirror = np.arange(n_slots, dtype=np.int64)
    lower = ui > uj
    tkey = uj[lower] * np.int64(n_p) + ui[lower]
    tpos = np.searchsorted(uniq_pairs, tkey)
    mirror[pair_flat_slot[lower]] = pair_flat_slot[tpos]

    diag_slot = np.zeros(n_p, dtype=np.int64)
    is_diag = ui == uj
    diag_slot[ui[is_diag]] = pair_flat_slot[is_diag]

    # Host-side slot layout (row, col, real) of every flat value slot, and
    # the raw assembly tables -- numpy, never transferred unless the
    # device-assembly path below materialises them.
    srow = np.concatenate([
        np.repeat(row_order[cls[row_order] == bnum], W)
        for bnum, W in enumerate(widths)
    ])
    host = dict(
        prod_val=prod_val,
        prod_k=prod_k_u,
        prod_slot=prod_slot,
        mirror=mirror,
        diag_slot=diag_slot,
        n_slots=n_slots,
        srow=srow,
        scol=np.concatenate([c.reshape(-1) for c in cols_t]),
        smask=np.concatenate([m.reshape(-1) > 0 for m in mask_t]),
    )

    if device_assembly:
        plan = build_gather_plan_grouped(prod_slot[:, None], n_slots)
        dev_asm = dict(
            prod_vals=jnp.asarray(prod_val, dtype),
            prod_k=jnp.asarray(prod_k_u, jnp.int32),
            plan=plan,
            mirror=jnp.asarray(mirror, jnp.int32),
            diag_slot=jnp.asarray(diag_slot, jnp.int32),
        )
    else:
        dev_asm = dict(
            prod_vals=None, prod_k=None, plan=None, mirror=None,
            diag_slot=None,
        )

    schur = SchurELL(
        cols=tuple(jnp.asarray(c, jnp.int32) for c in cols_t),
        mask=tuple(jnp.asarray(m, dtype) for m in mask_t),
        row_unperm=jnp.asarray(unperm, jnp.int32),
        slot_base=tuple(slot_base),
        **dev_asm,
    )
    return schur, host


def build_schur_frozen(
    D_cols: np.ndarray,
    D_vals: np.ndarray,
    inv_dF: np.ndarray,
    n_unodes: int,
    dtype=jnp.float32,
):
    """Frozen-path builder: pattern AND values of S1 = D diag(inv) D^T in
    one scipy SpGEMM per velocity component.

    The generic `build_schur_ell` enumerates every velocity-node pair to
    build the per-step reassembly tables -- O(sum_k cnt(k)^2) ~ tens of
    millions of int64 numpy temporaries, measured 207 s at 609k DoF on a
    1-core host.  The frozen projection Schur never reassembles, so the
    pair tables are pure waste there: Gustavson SpGEMM inside scipy gives
    the pattern and float64 values together in ~2 s.  The ELL slot layout
    rules (valence buckets, row permutation, sorted columns within a row)
    match `build_schur_ell`'s; the pattern itself may be TIGHTER (scipy
    prunes numerically-zero entries, e.g. pairs only sharing Dirichlet-
    masked velocity nodes) -- the same exact operator with fewer slots.

    Returns (SchurELL without assembly tables, host dict with `vals1`).
    """
    import scipy.sparse as sp

    n_p, Wd, dim = D_vals.shape
    real = np.abs(D_vals).sum(axis=2) > 0
    ridx, widx = np.nonzero(real)
    kcol = D_cols[ridx, widx]

    S = None
    for d in range(dim):
        Dd = sp.csr_matrix(
            (D_vals[ridx, widx, d], (ridx, kcol)), shape=(n_p, n_unodes)
        )
        Ds = Dd.copy()
        Ds.data = Ds.data * inv_dF[Ds.indices]
        Sd = Ds @ Dd.T
        S = Sd if S is None else S + Sd
    # scipy's SpGEMM (and sparse add) prunes numerically-zero entries (e.g.
    # pairs whose only shared velocity nodes are Dirichlet-masked).  That is
    # the exact same operator with a tighter pattern -- keep it -- but the
    # diagonal slot of every row must exist for the Jacobi diag extraction,
    # so missing diagonals are re-injected through the COO constructor
    # (which sums duplicates but never prunes explicit zeros).
    S = S.tocoo()
    has_diag = np.zeros(n_p, dtype=bool)
    has_diag[S.row[S.row == S.col]] = True
    missing = np.nonzero(~has_diag)[0]
    if len(missing):
        S = sp.csr_matrix(
            (
                np.concatenate([S.data, np.zeros(len(missing))]),
                (
                    np.concatenate([S.row, missing]),
                    np.concatenate([S.col, missing]),
                ),
            ),
            shape=(n_p, n_p),
        )
    else:
        S = S.tocsr()
    S.sum_duplicates()
    S.sort_indices()
    counts = np.diff(S.indptr)

    # --- identical valence-bucketed layout to build_schur_ell -------------
    thresholds = (32,)
    kmax = int(counts.max()) if n_p else 1
    widths = [t for t in thresholds if t < kmax] + [max(kmax, 1)]
    cls = np.searchsorted(np.asarray(widths), counts)
    row_order = np.argsort(cls, kind="stable")
    unperm = np.empty(n_p, dtype=np.int64)
    unperm[row_order] = np.arange(n_p)
    Wb = np.asarray(widths)[cls]
    base_grouped = np.concatenate([[0], np.cumsum(Wb[row_order])[:-1]])
    base = np.empty(n_p, dtype=np.int64)
    base[row_order] = base_grouped
    n_slots = int(Wb.sum())

    nnz = int(S.indptr[-1])
    erow = np.repeat(np.arange(n_p, dtype=np.int64), counts)
    slot_in_row = np.arange(nnz, dtype=np.int64) - S.indptr[:-1][erow]
    flat_slot = base[erow] + slot_in_row

    vals1 = np.zeros(n_slots)
    vals1[flat_slot] = S.data

    cols_t, mask_t, slot_base = [], [], []
    off = 0
    for bnum, W in enumerate(widths):
        rows_b = row_order[cls[row_order] == bnum]
        cb = np.tile(rows_b[:, None], (1, W))  # pad: own row id
        mb = np.zeros((len(rows_b), W))
        sel = cls[erow] == bnum
        pos_in_bucket = (base[erow[sel]] - off) // W
        cb[pos_in_bucket, slot_in_row[sel]] = S.indices[sel]
        mb[pos_in_bucket, slot_in_row[sel]] = 1.0
        cols_t.append(cb)
        mask_t.append(mb)
        slot_base.append(off)
        off += len(rows_b) * W

    is_diag = S.indices == erow
    assert np.array_equal(
        np.bincount(erow[is_diag], minlength=n_p), np.ones(n_p, np.int64)
    ), "every S1 row needs exactly one diagonal slot"
    diag_slot = np.zeros(n_p, dtype=np.int64)
    diag_slot[erow[is_diag]] = flat_slot[is_diag]

    srow = np.concatenate([
        np.repeat(row_order[cls[row_order] == bnum], W)
        for bnum, W in enumerate(widths)
    ])
    host = dict(
        vals1=vals1,
        diag_slot=diag_slot,
        n_slots=n_slots,
        srow=srow,
        scol=np.concatenate([c.reshape(-1) for c in cols_t]),
        smask=np.concatenate([m.reshape(-1) > 0 for m in mask_t]),
    )
    schur = SchurELL(
        cols=tuple(jnp.asarray(c, jnp.int32) for c in cols_t),
        mask=tuple(jnp.asarray(m, dtype) for m in mask_t),
        row_unperm=jnp.asarray(unperm, jnp.int32),
        slot_base=tuple(slot_base),
        prod_vals=None, prod_k=None, plan=None, mirror=None, diag_slot=None,
    )
    return schur, host


def host_assemble_schur_values(host: dict, inv_dF: np.ndarray) -> np.ndarray:
    """Numpy mirror of `assemble_schur_values` over the host tables (one-time
    frozen-Schur setup; float64 accumulation)."""
    w = host["prod_val"] * inv_dF[host["prod_k"]]
    vals = np.bincount(
        host["prod_slot"], weights=w, minlength=host["n_slots"]
    )
    return vals[host["mirror"]]


def assemble_schur_values(s: SchurELL, inv_dF: jax.Array, dtype=None) -> jax.Array:
    """Per-step flat values [n_slots]: reduce upper-triangle products weighted
    by 1/dF, then mirror the lower triangle (S~ is symmetric)."""
    w = s.prod_vals * inv_dF[s.prod_k]
    vals = apply_gather_plan(s.plan, w[:, None])[:, 0]
    return vals[s.mirror]


def _bucket_views(s: SchurELL, vals: jax.Array):
    for b, cols in enumerate(s.cols):
        rows_b, W = cols.shape
        off = s.slot_base[b]
        yield b, cols, s.mask[b], vals[off:off + rows_b * W].reshape(rows_b, W)


def schur_ell_matvec(s: SchurELL, vals: jax.Array, p: jax.Array) -> jax.Array:
    outs = [
        jnp.einsum("rw,rw->r", vb * mb, p[cb])
        for (_, cb, mb, vb) in _bucket_views(s, vals)
    ]
    out = jnp.concatenate(outs, axis=0)
    return out[s.row_unperm]


def schur_ell_matvec_bf16(s: SchurELL, vals16: tuple, p: jax.Array, out_dtype):
    """bf16-payload SpMV: vals16 are per-bucket pre-masked bf16 arrays."""
    p16 = p.astype(jnp.bfloat16)
    outs = []
    for b, cols in enumerate(s.cols):
        g = vals16[b] * p16[cols]
        outs.append(jnp.sum(g.astype(out_dtype), axis=1))
    return jnp.concatenate(outs, axis=0)[s.row_unperm]


def masked_bf16_vals(s: SchurELL, vals: jax.Array) -> tuple:
    return tuple(
        (vb * mb).astype(jnp.bfloat16) for (_, _, mb, vb) in _bucket_views(s, vals)
    )


def schur_ell_diag(s: SchurELL, vals: jax.Array) -> jax.Array:
    return vals[s.diag_slot]
