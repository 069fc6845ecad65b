"""DoF-sharded operator application: owned nodes + neighbor halo exchange.

The default sharded path (parallel/sharding.py) replicates DoF vectors and
all-reduces a full [n_u, dim] global vector per apply -- correct, and the
right trade below ~10M DoF, but its per-step collective volume is O(global)
regardless of device count.  This module provides the scalable counterpart
of the reference's owned/ghost IndexSet model (ref: src/NavierStokes2D.cpp:
71-87 owned/relevant DoFs; :315-320 compress()): DoF vectors are sharded in
contiguous blocks aligned with the cell blocks, and each operator
application exchanges only the *halo* rows -- per-device cross-device bytes
scale with the subdomain boundary, not the global problem size.

Device mapping (no MPI, no ghost bookkeeping in the hot loop):

  * nodes are block-partitioned in their spatial (Morton/RCM) order, so a
    device's cell block touches almost only its own node block plus thin
    slabs owned by neighboring blocks;
  * the forward halo (gather u on ghost rows) and the reverse halo
    (scatter-add boundary assembly contributions back to their owners) are
    `lax.ppermute` ring shifts inside `shard_map` -- the XLA collective
    carries a payload of exactly the halo slab;
  * all slab shapes are padded to the per-shift maximum across devices so
    the program is SPMD with static shapes.

Use `collective_bytes_per_apply` to quantify the exchanged volume against
the replicated path's full-vector all-reduce.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from navierstokes_project_nm4pde_tpu.config import (
    NumericsConfig,
    matmul_precision_scope,
)
from navierstokes_project_nm4pde_tpu.ops import operators as ops


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class HaloSide:
    """Halo structure for one DoF space (velocity nodes or pressure nodes)."""

    # extended-local cell connectivity: global ids remapped to
    # [0, n_loc) owned | [n_loc + off_s, ...) ghosts per shift
    cells_loc: jax.Array  # [n_dev, E_d, nloc] int32
    # per shift s (static `shifts[i]`): rows each device SENDS to the
    # device `shift` places behind it (local ids in the sender's block)
    send: tuple  # of [n_dev, H_s] int32
    # local reduce table: ext-row -> contribution slots (pad = n_slots)
    table: jax.Array  # [n_dev, n_ext, K] int32
    # natural row id -> owned-layout position (and n_dev*n_loc padding):
    # the id space is split PER SUB-SPACE (vertices / edges each into
    # n_dev blocks) so ownership follows the spatial first-touch order of
    # each sub-space; a single contiguous split of the combined space
    # would hand device d's edge nodes to other devices wholesale.
    perm: jax.Array  # [n_rows] int32 into [0, n_dev * n_loc)
    n_loc: int = dataclasses.field(metadata=dict(static=True))
    n_ext: int = dataclasses.field(metadata=dict(static=True))
    shifts: tuple = dataclasses.field(metadata=dict(static=True))
    halo_sizes: tuple = dataclasses.field(metadata=dict(static=True))
    n_slots: int = dataclasses.field(metadata=dict(static=True))
    n_rows: int = dataclasses.field(metadata=dict(static=True))  # unpadded


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class HaloPlan:
    u: HaloSide
    p: HaloSide
    n_dev: int = dataclasses.field(metadata=dict(static=True))
    E_d: int = dataclasses.field(metadata=dict(static=True))


def _ownership_perm(n_rows: int, n_dev: int, splits: tuple):
    """Permutation natural-id -> block-owned layout, splitting every
    sub-space (e.g. P2 vertices / first-touch edges) into n_dev contiguous
    blocks; device d owns one block of each.  Returns (perm, n_loc)."""
    bounds = (0,) + tuple(splits) + (n_rows,)
    seg_loc = [
        -(-(bounds[i + 1] - bounds[i]) // n_dev)
        for i in range(len(bounds) - 1)
    ]
    n_loc = sum(seg_loc)
    seg_base = np.concatenate([[0], np.cumsum(seg_loc)[:-1]])
    perm = np.empty(n_rows, dtype=np.int64)
    for i in range(len(bounds) - 1):
        lo, hi, sl = bounds[i], bounds[i + 1], seg_loc[i]
        ids = np.arange(lo, hi)
        d = (ids - lo) // sl
        perm[ids] = d * n_loc + seg_base[i] + (ids - lo) % sl
    return perm, n_loc


def _build_side(
    cells: np.ndarray, n_rows: int, n_dev: int, splits: tuple = ()
) -> HaloSide:
    """Halo structure for one DoF space from [E_pad, nloc] connectivity
    (E_pad a multiple of n_dev; padding cells must reference row 0)."""
    E_pad, nloc = cells.shape
    E_d = E_pad // n_dev
    perm, n_loc = _ownership_perm(n_rows, n_dev, splits)
    cells = perm[cells]  # work in the owned layout throughout

    owner = cells // n_loc  # [E, nloc] owning device of each referenced node
    blocks = cells.reshape(n_dev, E_d, nloc)
    owner_b = owner.reshape(n_dev, E_d, nloc)

    # ghosts per (device, shift)
    ghost_ids = {}  # (d, s) -> sorted unique global ids
    shift_set = set()
    for d in range(n_dev):
        g = blocks[d].reshape(-1)
        o = owner_b[d].reshape(-1)
        for s in np.unique((o - d) % n_dev):
            if s == 0:
                continue
            ids = np.unique(g[(o - d) % n_dev == s])
            ghost_ids[(d, int(s))] = ids
            shift_set.add(int(s))
    shifts = tuple(sorted(shift_set))
    halo_sizes = tuple(
        max((len(ghost_ids.get((d, s), ())) for d in range(n_dev)), default=0)
        for s in shifts
    )

    # send lists: device o sends to (o - s) % n_dev the rows that device
    # needs from o, i.e. ghost_ids[(o - s) % n_dev, s] localized to o's block
    send = []
    for s, H in zip(shifts, halo_sizes):
        tab = np.zeros((n_dev, H), dtype=np.int64)
        for o in range(n_dev):
            want = ghost_ids.get(((o - s) % n_dev, s), np.zeros(0, np.int64))
            tab[o, : len(want)] = want - o * n_loc
        send.append(jnp.asarray(tab, jnp.int32))

    # extended-local connectivity
    offs = np.concatenate([[0], np.cumsum(halo_sizes)[:-1]]) + n_loc
    n_ext = n_loc + int(sum(halo_sizes))
    cells_loc = np.empty_like(blocks)
    for d in range(n_dev):
        remap = {}
        for i, s in enumerate(shifts):
            for j, g in enumerate(ghost_ids.get((d, s), ())):
                remap[int(g)] = int(offs[i]) + j
        flat = blocks[d].reshape(-1)
        own = (flat // n_loc) == d
        loc = np.where(own, flat - d * n_loc, 0)
        for k, g in enumerate(flat):
            if not own[k]:
                loc[k] = remap[int(g)]
        cells_loc[d] = loc.reshape(E_d, nloc)

    # local reduce tables (uniform width across devices for stacking)
    from navierstokes_project_nm4pde_tpu.mesh.native import invert_map

    n_slots = E_d * nloc
    slots_l, counts_l = [], []
    for d in range(n_dev):
        sl, ct = invert_map(
            cells_loc[d].reshape(-1).astype(np.int32), n_ext, pad_value=n_slots
        )
        slots_l.append(sl)
        counts_l.append(ct)
    K = max(1, max(int(c.max()) for c in counts_l))
    table = np.full((n_dev, n_ext, K), n_slots, dtype=np.int64)
    for d in range(n_dev):
        w = slots_l[d].shape[1]
        table[d, :, : min(w, K)] = slots_l[d][:, :K]

    return HaloSide(
        cells_loc=jnp.asarray(cells_loc, jnp.int32),
        send=tuple(send),
        table=jnp.asarray(table, jnp.int32),
        perm=jnp.asarray(perm, jnp.int32),
        n_loc=n_loc,
        n_ext=n_ext,
        shifts=shifts,
        halo_sizes=halo_sizes,
        n_slots=n_slots,
        n_rows=n_rows,
    )


def build_halo_plan(
    op: ops.NSOperator, n_dev: int, n_vertices: int | None = None
) -> HaloPlan:
    """Build from a *cell-padded* operator (see sharding._pad_cells).

    `n_vertices` splits the P2 velocity space into its vertex/edge
    sub-spaces so each is block-partitioned separately (both follow the
    cells' spatial first-touch order; a single contiguous split of the
    combined space would misalign ownership with the cell blocks)."""
    cells_u = np.asarray(op.cells_u)
    cells_p = np.asarray(op.cells_p)
    assert cells_u.shape[0] % n_dev == 0, "pad cells to a multiple of n_dev"
    u_splits = (n_vertices,) if n_vertices else ()
    return HaloPlan(
        u=_build_side(cells_u, op.n_unodes, n_dev, splits=u_splits),
        p=_build_side(cells_p, op.n_pnodes, n_dev),
        n_dev=n_dev,
        E_d=cells_u.shape[0] // n_dev,
    )


# ----------------------------------------------------------------------
# Device-local kernels (run inside shard_map; leading axes squeezed)
# ----------------------------------------------------------------------
def _perm(shift: int, n_dev: int, reverse: bool):
    """Forward: device d receives its shift-s ghost slab from (d+s)%n.
    Reverse: device d returns that slab's assembly contributions to its
    owner (d+s)%n."""
    if reverse:
        return [(d, (d + shift) % n_dev) for d in range(n_dev)]
    return [((d + shift) % n_dev, d) for d in range(n_dev)]


def _gather_ext(side: HaloSide, x_loc, send_loc, n_dev, axis):
    """Owned block [n_loc, ...] -> extended block [n_ext, ...] via forward
    halo ppermutes (one slab per shift)."""
    slabs = [x_loc]
    for i, s in enumerate(side.shifts):
        out = x_loc[send_loc[i]]
        slabs.append(jax.lax.ppermute(out, axis, _perm(s, n_dev, False)))
    return jnp.concatenate(slabs, axis=0)


def _reduce_ext(side: HaloSide, flat, table_loc, send_loc, n_dev, axis):
    """Flat contributions [n_slots, ...] -> owned rows [n_loc, ...]: local
    gather-sum into the extended layout, then reverse halo ppermutes
    scatter-adding boundary contributions back to their owners."""
    pad = jnp.zeros((1,) + flat.shape[1:], flat.dtype)
    padded = jnp.concatenate([flat, pad], axis=0)
    y_ext = padded[table_loc].sum(axis=1)  # [n_ext, ...]
    y_own = y_ext[: side.n_loc]
    off = side.n_loc
    for i, s in enumerate(side.shifts):
        H = side.halo_sizes[i]
        slab = jax.lax.ppermute(
            y_ext[off:off + H], axis, _perm(s, n_dev, True)
        )
        y_own = y_own.at[send_loc[i]].add(slab)
        off += H
    return y_own


def _to_owned(side: HaloSide, x, n_dev):
    out = jnp.zeros((n_dev * side.n_loc,) + x.shape[1:], x.dtype)
    return out.at[side.perm].set(x)


def to_natural(side: HaloSide, y):
    """Owned-layout (padded, sharded) vector -> natural row order."""
    return y[side.perm]


def shard_vectors(plan: HaloPlan, mesh: Mesh, u, p):
    """Permute (u, p) into the owned block layout, pad, and place them
    block-sharded over the mesh's first axis."""
    axis = mesh.axis_names[0]
    sh = NamedSharding(mesh, P(axis))
    u_pad = _to_owned(plan.u, jnp.asarray(u), plan.n_dev)
    p_pad = _to_owned(plan.p, jnp.asarray(p), plan.n_dev)
    return jax.device_put(u_pad, sh), jax.device_put(p_pad, sh)


def halo_apply_system(
    op: ops.NSOperator,
    plan: HaloPlan,
    mesh: Mesh,
    nu,
    dt,
    conv: ops.ConvectionData | None,
    u_pad,
    p_pad,
):
    """(y_u, y_p) = K [u; p] with DoF-sharded vectors and halo collectives.

    Matches ops.apply_system(..., mask_rows=False) on the unpadded rows.
    `u_pad`/`p_pad` come from `shard_vectors`; outputs keep that sharding.
    Geometry/convection arrays must be cell-sharded over the same mesh
    (shard_operator) so each device sees its own element block.  The
    element einsums run under NumericsConfig's default matmul precision
    (full f32 products on every backend).
    """
    axis = mesh.axis_names[0]
    n_dev = plan.n_dev

    spec_cells = P(axis)
    spec_stack = P(axis)  # [n_dev, ...] tables: one row per device

    conv_in = (conv.WG, conv.divw) if conv is not None else None

    def local(u_loc, p_loc, cu, cp, send_u, send_p, tab_u, tab_p,
              detJ, GKd, Jinv, conv_loc):
        # squeeze the stacked device axis
        cu, cp = cu[0], cp[0]
        send_u = [t[0] for t in send_u]
        send_p = [t[0] for t in send_p]
        tab_u, tab_p = tab_u[0], tab_p[0]

        u_ext = _gather_ext(plan.u, u_loc, send_u, n_dev, axis)
        p_ext = _gather_ext(plan.p, p_loc, send_p, n_dev, axis)
        u_e = u_ext[cu]  # [E_d, nloc_u, dim]
        p_e = p_ext[cp]  # [E_d, nloc_p]

        y_e = jnp.einsum("ij,ejc->eic", op.MHAT, u_e) * (
            detJ / dt
        )[:, None, None]
        y_e = y_e + nu * jnp.einsum("ekl,klij,ejc->eic", GKd, op.AHAT, u_e)
        if conv_loc is not None:
            WG, divw = conv_loc
            u_q = jnp.einsum("qi,eic->eqc", op.PHI_U, u_e)
            dir_q = jnp.einsum("eqi,eic->eqc", WG, u_e)
            r = dir_q + 0.5 * divw[:, :, None] * u_q
            y_e = y_e + jnp.einsum(
                "q,qi,eqc->eic", op.W, op.PHI_U, r
            ) * detJ[:, None, None]
        # pressure gradient fused into the same velocity reduction
        y_e = y_e - jnp.einsum(
            "ekc,kij,ei->ejc", Jinv, op.BHAT, p_e
        ) * detJ[:, None, None]
        y_u = _reduce_ext(
            plan.u, y_e.reshape(-1, y_e.shape[-1]), tab_u, send_u, n_dev, axis
        )
        y_pe = jnp.einsum(
            "ekc,kij,ejc->ei", Jinv, op.BHAT, u_e
        ) * detJ[:, None]
        y_p = _reduce_ext(
            plan.p, y_pe.reshape(-1), tab_p, send_p, n_dev, axis
        )
        return y_u, y_p

    def scoped_local(*args):
        with matmul_precision_scope(NumericsConfig.matmul_precision):
            return local(*args)

    fn = jax.shard_map(
        scoped_local,
        mesh=mesh,
        in_specs=(
            spec_cells, spec_cells,  # u_loc, p_loc (node blocks)
            spec_stack, spec_stack,  # cells_loc u/p
            tuple(spec_stack for _ in plan.u.send),
            tuple(spec_stack for _ in plan.p.send),
            spec_stack, spec_stack,  # tables
            spec_cells, spec_cells, spec_cells,  # detJ, GKd, Jinv
            None if conv_in is None else (spec_cells, spec_cells),
        ),
        out_specs=(spec_cells, spec_cells),
    )
    return fn(
        u_pad, p_pad,
        plan.u.cells_loc, plan.p.cells_loc,
        tuple(plan.u.send), tuple(plan.p.send),
        plan.u.table, plan.p.table,
        op.detJ, op.GKd, op.Jinv,
        conv_in,
    )


def collective_bytes_per_apply(plan: HaloPlan, dim: int, itemsize: int = 4):
    """Cross-device traffic of one halo_apply_system vs the replicated path.

    Halo path: per shift, every device sends one slab forward (gather) and
    one back (assembly compress) for each DoF space.  Replicated path: the
    scatter_add mode all-reduces the full [n_u, dim] + [n_p] outputs (ring
    all-reduce moves ~2x the payload per device).
    """
    halo = 0
    for H in plan.u.halo_sizes:
        halo += 2 * plan.n_dev * H * dim * itemsize
    for H in plan.p.halo_sizes:
        halo += 2 * plan.n_dev * H * itemsize
    repl = 2 * (plan.u.n_rows * dim + plan.p.n_rows) * itemsize * plan.n_dev
    return {
        "halo_bytes_total": halo,
        "halo_bytes_per_device": halo // plan.n_dev,
        "replicated_allreduce_bytes_total": repl,
        "ratio": halo / max(repl, 1),
    }
