"""Transpose-free assembly: scatter-add recast as gather + sum.

The reference's assembly reduction (`matrix.add` + `compress()`;
ref: src/NavierStokes2D.cpp:307-320) is a scatter-add.  On the engine's
first target XLA serialised scatter/segment-sum, which would have dominated
every operator application, while gathers ran near memory bandwidth.  The
GPU has atomic scatter-add; whether these plans still win there is open
(ROADMAP D4).

So the framework *inverts* the reduction at setup time: for every global DoF
row we precompute the (static) list of element-local contribution slots, and
assembly becomes

    out[row] = sum_k flat_contributions[slots[row, k]]     (gather + sum)

with slots padded by an index that points at a zero pad row.  Rows are
bucketed by valence (P2 vertex nodes touch ~24 cells, edge nodes ~6) so the
padding waste stays small; the vertex/edge split falls out of the node
numbering (vertices first).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class GatherPlan:
    """Per-bucket slot tables; bucket b covers rows [starts[b], starts[b+1]).

    If `row_unperm` is set, rows were reordered (grouped by valence so each
    bucket's padded width is tight) and the concatenated bucket outputs are
    put back in original order by one cheap gather.

    `mode` selects the apply strategy: "table" issues one [rows_b, K_b]
    2-D gather per bucket and row-sums it; "columns" unrolls each bucket
    into K_b 1-D row gathers with explicit adds between them -- each gather
    is then a pure row copy (the forward gather's access pattern;
    scripts/prof_reduce2.py)."""

    slots: tuple  # tuple of [rows_b, K_b] int32 arrays (padded with n_slots)
    n_slots: int = dataclasses.field(metadata=dict(static=True))  # pad index
    row_starts: tuple = dataclasses.field(metadata=dict(static=True))
    row_unperm: jax.Array | None = None  # [n_rows] int32 or None
    mode: str = dataclasses.field(default="table", metadata=dict(static=True))


def build_gather_plan(
    cells: np.ndarray, n_rows: int, splits: tuple = ()
) -> GatherPlan:
    """Build the inverse map of a [F, nloc] index array.

    `splits` are row boundaries for valence buckets (e.g. (n_vertices,) to
    separate P2 vertex rows from edge rows); each bucket gets its own padded
    width = its max valence.  Uses the native meshkit O(N) inversion when
    available (numpy argsort fallback inside `invert_map`)."""
    from navierstokes_project_nm4pde_tpu.mesh.native import invert_map

    flat = cells.reshape(-1).astype(np.int32)
    n_slots = flat.shape[0]
    slots_full, counts = invert_map(flat, n_rows, pad_value=n_slots)

    bounds = (0,) + tuple(splits) + (n_rows,)
    slot_tables = []
    for b in range(len(bounds) - 1):
        lo, hi = bounds[b], bounds[b + 1]
        c = counts[lo:hi]
        K = max(int(c.max()) if c.size else 1, 1)
        slot_tables.append(jnp.asarray(slots_full[lo:hi, :K], dtype=jnp.int32))
    return GatherPlan(
        slots=tuple(slot_tables),
        n_slots=n_slots,
        row_starts=tuple(bounds[:-1]) + (n_rows,),
    )


def apply_gather_plan(plan, flat: jax.Array) -> jax.Array:
    """Reduce flat contributions [n_slots, ...] -> [n_rows, ...]."""
    if isinstance(plan, WindowedPlan):
        return apply_windowed_plan(plan, flat)
    pad_shape = (1,) + flat.shape[1:]
    padded = jnp.concatenate([flat, jnp.zeros(pad_shape, flat.dtype)], axis=0)
    if plan.mode == "columns":
        outs = []
        for tab in plan.slots:
            acc = padded[tab[:, 0]]
            for k in range(1, tab.shape[1]):
                acc = acc + padded[tab[:, k]]
            outs.append(acc)
    else:
        outs = [padded[tab].sum(axis=1) for tab in plan.slots]
    out = jnp.concatenate(outs, axis=0) if len(outs) > 1 else outs[0]
    if plan.row_unperm is not None:
        out = out[plan.row_unperm]
    return out


def build_gather_plan_grouped(
    flat: np.ndarray, n_rows: int, thresholds=(2, 8, 32), drop_row=None,
    mode: str = "table",
) -> GatherPlan:
    """Gather plan with rows grouped by valence class (not by index range):
    rows are permuted so each class gets a tight padded width, and the
    output is restored to natural order by an inverse-permutation gather.
    Used where valence varies wildly across rows (e.g. Schur pair-product
    reduction: diagonal slots take ~85 products, off-diagonal ~5).

    Built from sorted runs (never materialises a [n_rows, K_max] table --
    a single hot row, e.g. a drop/pad row, would make that explode).
    `drop_row`: contributions mapped to this row are discarded entirely.
    """
    flat = flat.reshape(-1).astype(np.int64)
    n_slots = flat.shape[0]
    if drop_row is not None:
        keep = flat != drop_row
        positions = np.nonzero(keep)[0]
        flat_k = flat[keep]
    else:
        positions = np.arange(n_slots)
        flat_k = flat
    order_pos = np.argsort(flat_k, kind="stable")
    sorted_rows = flat_k[order_pos]
    src = positions[order_pos]  # original slot positions in row-sorted order
    counts = np.bincount(flat_k, minlength=n_rows)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])

    kmax = int(counts.max()) if counts.size else 1
    bounds = [t for t in thresholds if t < kmax] + [max(kmax, 1)]
    cls = np.searchsorted(np.asarray(bounds), counts)
    row_order = np.argsort(cls, kind="stable")
    unperm = np.empty(n_rows, dtype=np.int64)
    unperm[row_order] = np.arange(n_rows)

    tables = []
    for b, K in enumerate(bounds):
        rows_b = row_order[cls[row_order] == b]
        K = max(K, 1)
        idx = starts[rows_b][:, None] + np.arange(K)[None, :]
        valid = np.arange(K)[None, :] < counts[rows_b][:, None]
        idx = np.clip(idx, 0, max(len(src) - 1, 0))
        tab = np.where(valid, src[idx] if len(src) else 0, n_slots)
        tables.append(jnp.asarray(tab, dtype=jnp.int32))
    return GatherPlan(
        slots=tuple(tables),
        n_slots=n_slots,
        row_starts=(0, n_rows),
        row_unperm=jnp.asarray(unperm, jnp.int32),
        mode=mode,
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class WindowedSeg:
    """One row segment of a WindowedPlan (e.g. P2 vertex rows or edge rows;
    each segment gets its own padded valence width K)."""

    starts: jax.Array  # [n_blocks] int32 window start row into flat
    table: jax.Array  # [n_blocks, rows_per_block, K] int32 WINDOW-LOCAL ids
    mask: jax.Array  # [n_blocks, rows_per_block, K] bool (False = pad)
    window: int = dataclasses.field(metadata=dict(static=True))
    rows: int = dataclasses.field(metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class WindowedPlan:
    """Reduce plan that scans destination-row blocks, dynamic-slicing a
    contiguous WINDOW of the flat contribution array per block and gathering
    window-locally.

    Motivation (scripts/prof_gather_rate.py): the XLA row-gather rate is
    bound by the SOURCE working set -- ~3.3 ns/row from a <=0.5 MB window
    vs ~7-8 ns/row from the tens-of-MB flat element-output array.  RCM
    ordering (mesh.reorder_spatial) bounds every destination block's slot
    span by the mesh cross-section, so each block's contributions live in
    a small contiguous window that streams in once and stays hot."""

    segs: tuple  # of WindowedSeg
    n_slots: int = dataclasses.field(metadata=dict(static=True))


def build_windowed_plan(
    cells: np.ndarray,
    n_rows: int,
    splits: tuple = (),
    rows_per_block: int = 2048,
) -> WindowedPlan:
    """Build the windowed reduce for a [F, nloc] index array.

    `splits` are row boundaries separating valence regimes (e.g. P2 vertex
    rows from edge rows) so each segment's padded width K is tight.  Rows
    must be spatially ordered (RCM) within each segment or the windows
    degenerate to the whole slot array."""
    from navierstokes_project_nm4pde_tpu.mesh.native import invert_map

    flat = cells.reshape(-1).astype(np.int32)
    n_slots = flat.shape[0]
    slots_full, counts = invert_map(flat, n_rows, pad_value=n_slots)

    bounds = (0,) + tuple(splits) + (n_rows,)
    segs = []
    for b in range(len(bounds) - 1):
        lo, hi = bounds[b], bounds[b + 1]
        seg_rows = hi - lo
        c = counts[lo:hi]
        K = max(int(c.max()) if c.size else 1, 1)
        tab = slots_full[lo:hi, :K].astype(np.int64)
        valid = np.arange(K)[None, :] < c[:, None]

        rpb = min(rows_per_block, max(seg_rows, 1))
        nb = max((seg_rows + rpb - 1) // rpb, 1)
        pad_rows = nb * rpb - seg_rows
        if pad_rows:
            tab = np.concatenate(
                [tab, np.zeros((pad_rows, K), tab.dtype)], axis=0
            )
            valid = np.concatenate(
                [valid, np.zeros((pad_rows, K), bool)], axis=0
            )
        tab3 = tab.reshape(nb, rpb, K)
        val3 = valid.reshape(nb, rpb, K)

        # per-block slot span (over valid entries only)
        big = np.where(val3, tab3, np.int64(n_slots))
        mn = big.reshape(nb, -1).min(axis=1)
        small = np.where(val3, tab3, np.int64(-1))
        mx = small.reshape(nb, -1).max(axis=1)
        empty = mx < 0
        mn[empty], mx[empty] = 0, 0
        # align window starts down (cheap DMA alignment) and size the
        # shared window to the widest block's span
        starts = np.maximum(mn - (mn % 64), 0)
        W = int((mx - starts).max()) + 1
        W = min(-(-W // 64) * 64, n_slots)
        starts = np.minimum(starts, n_slots - W)
        local = np.where(val3, tab3 - starts[:, None, None], 0)
        assert local.min() >= 0 and local.max() < W
        segs.append(
            WindowedSeg(
                starts=jnp.asarray(starts, jnp.int32),
                table=jnp.asarray(local, jnp.int32),
                mask=jnp.asarray(val3),
                window=W,
                rows=seg_rows,
            )
        )
    return WindowedPlan(segs=tuple(segs), n_slots=n_slots)


def apply_windowed_plan(plan: WindowedPlan, flat: jax.Array) -> jax.Array:
    """Reduce flat contributions [n_slots, ...] -> [n_rows, ...]."""
    trail = flat.shape[1:]
    outs = []
    for seg in plan.segs:
        window = seg.window

        def body(carry, blk, window=window):
            start, tab, msk = blk
            zero = jnp.zeros((), start.dtype)
            win = jax.lax.dynamic_slice(
                flat,
                (start,) + (zero,) * len(trail),
                (window,) + trail,
            )
            rows = win[tab]  # [rows_per_block, K, *trail]
            m = msk.astype(flat.dtype).reshape(msk.shape + (1,) * len(trail))
            return carry, (rows * m).sum(axis=1)

        _, o = jax.lax.scan(body, None, (seg.starts, seg.table, seg.mask))
        outs.append(o.reshape((-1,) + trail)[: seg.rows])
    return jnp.concatenate(outs, axis=0) if len(outs) > 1 else outs[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class WindowedGather:
    """Forward element-DoF gather through per-block dynamic-sliced source
    windows: u[cells] evaluated as scan(blocks): slice a vertex window and
    an edge window out of the node array, gather window-locally.

    Motivation (scripts/prof_apply_split.py, 965k bench mesh): before the
    H100 port the XLA row gather was SOURCE-working-set bound, so once the
    [n_unodes, c] node array outgrew the fast set the windowed form won;
    below that size the plain gather won -- gate by source size
    (NumericsConfig.gather_plan="auto").  Not yet measured on the H100.

    P2 wrinkle: cells_u references two first-touch-numbered bands (vertices
    [0, n_v), edge nodes [n_v, n_u)), so one window per band per block; the
    local table indexes their concatenation.  Requires RCM cell ordering
    (mesh.reorder_spatial("rcm")) for bounded windows.
    """

    vstarts: jax.Array  # [nb] int32 vertex-window start rows
    estarts: jax.Array  # [nb] int32 edge-window start rows
    local: jax.Array  # [nb, cpb, n_loc] int32 into concat(v-win, e-win)
    Wv: int = dataclasses.field(metadata=dict(static=True))
    We: int = dataclasses.field(metadata=dict(static=True))
    n_cells: int = dataclasses.field(metadata=dict(static=True))

    @property
    def window_rows(self) -> int:
        return self.Wv + self.We


def build_windowed_gather(
    cells: np.ndarray,
    n_vertices: int,
    n_rows: int,
    cells_per_block: int = 4096,
    align: int = 512,
) -> WindowedGather:
    """Build the per-block window tables for a [E, n_loc] index array whose
    rows are spatially (RCM) ordered.  Window widths are the max block span
    per band, rounded to `align`; degenerate (unordered) inputs just yield
    windows ~the whole band -- callers gate on `window_rows`."""
    E, nloc = cells.shape
    cpb = min(cells_per_block, max(E, 1))
    nb = -(-E // cpb)
    pad = nb * cpb - E
    if pad:
        cells = np.concatenate([cells, np.repeat(cells[-1:], pad, axis=0)])
    blk = cells.reshape(nb, cpb, nloc).astype(np.int64)
    isv = blk < n_vertices
    vmin = np.where(isv, blk, n_vertices).reshape(nb, -1).min(axis=1)
    vmax = np.where(isv, blk, -1).reshape(nb, -1).max(axis=1)
    emin = np.where(~isv, blk, n_rows).reshape(nb, -1).min(axis=1)
    emax = np.where(~isv, blk, -1).reshape(nb, -1).max(axis=1)
    # blocks with no vertex (or edge) entries get a degenerate window at 0
    vmin = np.minimum(vmin, np.maximum(vmax, 0))
    emin = np.minimum(emin, np.maximum(emax, n_vertices))
    vstart = np.maximum(vmin - vmin % align, 0)
    estart = np.maximum(emin - (emin - n_vertices) % align, n_vertices)
    Wv = int((vmax - vstart).max()) + 1
    We = int((emax - estart).max()) + 1
    Wv = min(-(-Wv // align) * align, max(n_vertices, 1))
    We = min(-(-We // align) * align, max(n_rows - n_vertices, 1))
    vstart = np.clip(vstart, 0, max(n_vertices - Wv, 0))
    estart = np.clip(estart, n_vertices, max(n_rows - We, n_vertices))
    local = np.where(
        isv, blk - vstart[:, None, None], Wv + blk - estart[:, None, None]
    )
    assert local.min() >= 0 and local.max() < Wv + We
    return WindowedGather(
        vstarts=jnp.asarray(vstart, jnp.int32),
        estarts=jnp.asarray(estart, jnp.int32),
        local=jnp.asarray(local, jnp.int32),
        Wv=Wv,
        We=We,
        n_cells=E,
    )


def apply_windowed_gather(wg: WindowedGather, u: jax.Array) -> jax.Array:
    """u[cells] via the windowed plan: [n_rows, c] -> [E, n_loc, c]."""
    c = u.shape[1]
    Wv, We = wg.Wv, wg.We
    nloc = wg.local.shape[-1]

    def body(carry, blk):
        v0, e0, tab = blk
        zero = jnp.zeros((), v0.dtype)
        wv = jax.lax.dynamic_slice(u, (v0, zero), (Wv, c))
        we = jax.lax.dynamic_slice(u, (e0, zero), (We, c))
        win = jnp.concatenate([wv, we], axis=0)
        return carry, win[tab]

    _, o = jax.lax.scan(body, None, (wg.vstarts, wg.estarts, wg.local))
    return o.reshape(-1, nloc, c)[: wg.n_cells]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class HalvingPlan:
    """Reduce plan with ONE flat gather + contiguous pairwise halvings.

    The [rows, K] table form of GatherPlan makes XLA issue a padded 2-D
    gather and reduce it row-wise; this form issues a 1-D gather consumed
    by reshape sums instead.  Layout: rows are
    permuted so rows needing the same number of `chunk`-slot groups are
    contiguous; every row's slots are padded to n_chunks[r]*chunk positions
    in `sort_idx`.  Applying is then

        g = padded[sort_idx]                  (one flat 1-D-indexed gather)
        log2(chunk) x: g = g.reshape(-1, 2, C).sum(1)   (contiguous)
        per class c: reshape(rows_c, c, C).sum(1)        (contiguous)
        restore natural row order                        (one tiny gather)

    All sums are pairwise -> exact same roundoff class as the table form.
    """

    sort_idx: jax.Array  # [N_pad] int32 flat slot ids (pad: n_slots)
    n_slots: int = dataclasses.field(metadata=dict(static=True))
    chunk: int = dataclasses.field(metadata=dict(static=True))
    # (rows_in_class, chunks_per_row) in layout order
    classes: tuple = dataclasses.field(metadata=dict(static=True))
    row_unperm: jax.Array  # [n_rows] int32


def build_halving_plan(
    cells: np.ndarray, n_rows: int, chunk: int = 8
) -> HalvingPlan:
    """Build a HalvingPlan from a [F, nloc] cell->row index array."""
    from navierstokes_project_nm4pde_tpu.mesh.native import invert_map

    assert chunk & (chunk - 1) == 0, "chunk must be a power of two"
    flat = cells.reshape(-1).astype(np.int32)
    n_slots = flat.shape[0]
    slots_full, counts = invert_map(flat, n_rows, pad_value=n_slots)

    n_chunks = np.maximum((counts + chunk - 1) // chunk, 1).astype(np.int64)
    row_order = np.argsort(n_chunks, kind="stable")
    unperm = np.empty(n_rows, dtype=np.int64)
    unperm[row_order] = np.arange(n_rows)

    classes = []
    idx_parts = []
    nc_sorted = n_chunks[row_order]
    boundaries = np.concatenate(
        [[0], np.nonzero(np.diff(nc_sorted))[0] + 1, [n_rows]]
    )
    for lo, hi in zip(boundaries[:-1], boundaries[1:]):
        rows_c = row_order[lo:hi]
        c = int(nc_sorted[lo])
        width = c * chunk
        tab = slots_full[rows_c][:, :width]
        if tab.shape[1] < width:  # Kmax < width (all-pad rows)
            pad = np.full((len(rows_c), width - tab.shape[1]), n_slots,
                          dtype=tab.dtype)
            tab = np.concatenate([tab, pad], axis=1)
        classes.append((int(len(rows_c)), c))
        idx_parts.append(tab.reshape(-1))
    sort_idx = np.concatenate(idx_parts) if idx_parts else np.zeros(0, np.int64)
    return HalvingPlan(
        sort_idx=jnp.asarray(sort_idx, jnp.int32),
        n_slots=n_slots,
        chunk=chunk,
        classes=tuple(classes),
        row_unperm=jnp.asarray(unperm, jnp.int32),
    )


def apply_halving_plan(plan: HalvingPlan, flat: jax.Array) -> jax.Array:
    """Reduce flat contributions [n_slots, ...] -> [n_rows, ...]."""
    pad_shape = (1,) + flat.shape[1:]
    padded = jnp.concatenate([flat, jnp.zeros(pad_shape, flat.dtype)], axis=0)
    g = padded[plan.sort_idx]
    rest = g.shape[1:]
    k = plan.chunk
    while k > 1:
        g = g.reshape((-1, 2) + rest).sum(axis=1)
        k //= 2
    outs = []
    off = 0
    for rows_c, c in plan.classes:
        seg = jax.lax.slice_in_dim(g, off, off + rows_c * c)
        outs.append(
            seg if c == 1 else seg.reshape((rows_c, c) + rest).sum(axis=1)
        )
        off += rows_c * c
    out = jnp.concatenate(outs, axis=0) if len(outs) > 1 else outs[0]
    return out[plan.row_unperm]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class InverseMap:
    """Gather-form of `out[idx] = vals`: out = table[inv][...] with a zero/
    passthrough pad.  Used for Dirichlet value injection without scatter."""

    inv: jax.Array  # [n_rows] int32 into the (concatenated) values array
    n_vals: int = dataclasses.field(metadata=dict(static=True))


def build_inverse_map(index_groups, n_rows: int) -> InverseMap:
    """index_groups: list of int arrays; their concatenation must be unique.
    Rows not covered map to the pad slot (n_vals)."""
    inv = np.full(n_rows, -1, dtype=np.int64)
    off = 0
    for g in index_groups:
        g = np.asarray(g)
        inv[g] = off + np.arange(len(g))
        off += len(g)
    inv[inv < 0] = off
    return InverseMap(inv=jnp.asarray(inv, dtype=jnp.int32), n_vals=off)


def apply_inverse_map(m: InverseMap, values: jax.Array, fill=0.0) -> jax.Array:
    pad = jnp.full((1,) + values.shape[1:], fill, values.dtype)
    return jnp.concatenate([values, pad], axis=0)[m.inv]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class WeightedPlan:
    """Assembled sparse matvec y[r, :] = sum_k vals[r, k, :] * x[cols[r, k]]
    as valence-bucketed weighted row gathers.

    Same access pattern as GatherPlan's "columns" mode (K unrolled 1-D row
    gathers with explicit adds), but each gathered row is scaled by a
    per-(row, slot) coefficient vector -- i.e. an ELL SpMV whose rows are
    grouped by nnz count so padding stays negligible.  Built for operators
    whose SOURCE vector is tiny (e.g. the pressure space): it trades the
    big element-array reduction for extra gathered rows from a KB-scale
    source.  Rows are permuted by valence class; `row_unperm` restores
    natural order."""

    cols: tuple  # per bucket [rows_b, K_b] int32 (pad index = n_src)
    vals: tuple  # per bucket [rows_b, K_b, C]
    row_unperm: jax.Array  # [n_rows] int32
    n_src: int = dataclasses.field(metadata=dict(static=True))


def build_weighted_plan(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_rows: int,
    n_src: int,
    dtype=np.float32,
    min_rows: int = 4096,
) -> WeightedPlan:
    """Build a WeightedPlan from COO triplets (duplicate (row, col) pairs
    must already be merged; zero-valued entries are fine but wasteful).

    Rows are sorted by nnz count and grouped into valence-exact buckets;
    consecutive valence classes are merged until a bucket holds at least
    `min_rows` rows (padding only up to the merged class's max valence), so
    the bucket count stays small without the 2-bucket split's ~28% padding
    waste."""
    rows = np.asarray(rows).astype(np.int64).reshape(-1)
    cols = np.asarray(cols).astype(np.int64).reshape(-1)
    vals = np.asarray(vals)
    if vals.ndim == 1:
        vals = vals[:, None]
    C = vals.shape[-1]
    order = np.argsort(rows, kind="stable")
    rows_s, cols_s, vals_s = rows[order], cols[order], vals[order]
    counts = np.bincount(rows_s, minlength=n_rows)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])

    # valence-sorted row order; cut buckets at valence changes once the
    # current bucket is big enough
    row_order = np.argsort(counts, kind="stable")
    unperm = np.empty(n_rows, dtype=np.int64)
    unperm[row_order] = np.arange(n_rows)
    cnt_sorted = counts[row_order]
    cuts = [0]
    run = 0
    for i in range(1, n_rows):
        run += 1
        if cnt_sorted[i] != cnt_sorted[i - 1] and run >= min_rows:
            cuts.append(i)
            run = 0
    cuts.append(n_rows)

    col_tabs, val_tabs = [], []
    for b in range(len(cuts) - 1):
        rows_b = row_order[cuts[b]:cuts[b + 1]]
        K = max(int(counts[rows_b].max()) if rows_b.size else 1, 1)
        idx = starts[rows_b][:, None] + np.arange(K)[None, :]
        valid = np.arange(K)[None, :] < counts[rows_b][:, None]
        idx = np.clip(idx, 0, max(len(cols_s) - 1, 0))
        ctab = np.where(valid, cols_s[idx] if len(cols_s) else 0, n_src)
        vtab = np.where(
            valid[..., None], vals_s[idx] if len(vals_s) else 0.0, 0.0
        )
        col_tabs.append(jnp.asarray(ctab, dtype=jnp.int32))
        val_tabs.append(jnp.asarray(vtab, dtype=dtype))
    return WeightedPlan(
        cols=tuple(col_tabs),
        vals=tuple(val_tabs),
        row_unperm=jnp.asarray(unperm, jnp.int32),
        n_src=n_src,
    )


def apply_weighted_plan(plan: WeightedPlan, x: jax.Array) -> jax.Array:
    """y = A x for the WeightedPlan's ELL operator: [n_src] -> [n_rows, C]."""
    xp = jnp.concatenate([x, jnp.zeros((1,), x.dtype)])
    outs = []
    for cb, vb in zip(plan.cols, plan.vals):
        acc = vb[:, 0, :] * xp[cb[:, 0]][:, None]
        for k in range(1, cb.shape[1]):
            acc = acc + vb[:, k, :] * xp[cb[:, k]][:, None]
        outs.append(acc)
    out = outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=0)
    return out[plan.row_unperm]
