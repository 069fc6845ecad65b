"""Matrix-free Navier-Stokes block operators (device, JAX).

Matrix-free replacement for the reference's assembled Trilinos block matrices
and their SpMV (ref: src/NavierStokes2D.cpp:164-357, include/IncludesFile.hpp).
Nothing global is ever assembled for the velocity block: each application is

    gather (cell DoFs)  ->  shared-table einsums  ->  sorted segment-sum

The constant blocks (mass, stiffness, divergence, pressure mass) contract
per-element geometry with the tiny reference tensors of `ops.tables`; the
convection block C(w) is linearised at the previous velocity (ref:
src/NavierStokes2D.cpp:253-256, including the Temam stabilisation term
0.5*(div w)(u,v)) and is refreshed once per time step via `convection_setup`,
after which every Krylov iteration reuses its quadrature tables.

State layout: velocity `u[n_unodes, dim]`, pressure `p[n_pnodes]`.
Block system (same algebra as the reference):

    [ F(w)  G ] [u]   F = M/dt + nu*A + C(w),  G = -D^T (pressure gradient)
    [ D     0 ] [p]   D = divergence
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from navierstokes_project_nm4pde_tpu.fem.geometry import CellGeometry
from navierstokes_project_nm4pde_tpu.fem.space import TaylorHoodSpace
from navierstokes_project_nm4pde_tpu.ops.scatter import (
    GatherPlan,
    apply_gather_plan,
    build_gather_plan,
)
from navierstokes_project_nm4pde_tpu.ops.coarse import CoarseSchur, build_coarse_schur
from navierstokes_project_nm4pde_tpu.ops.schur_ell import SchurELL, build_schur_ell
from navierstokes_project_nm4pde_tpu.ops.tables import RefTables, build_ref_tables


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class NSOperator:
    """Static per-mesh operator data (a pytree of device arrays)."""

    # connectivity
    cells_u: jax.Array  # [E, n_loc_u] int32
    cells_p: jax.Array  # [E, dim+1] int32
    # assembly reductions as gather-sum plans (see ops/scatter.py)
    plan_u: GatherPlan
    plan_p: GatherPlan
    # geometry
    detJ: jax.Array  # [E]
    Jinv: jax.Array  # [E, dim, dim]
    GKd: jax.Array  # [E, dim, dim] = detJ * Jinv @ Jinv^T
    # reference tables
    W: jax.Array
    PHI_U: jax.Array
    GRAD_U: jax.Array
    PHI_P: jax.Array
    MHAT: jax.Array
    MPHAT: jax.Array
    AHAT: jax.Array  # [dim, dim, nu, nu]
    BHAT: jax.Array  # [dim, np, nu]
    # host-assembled global diagonals (scalar velocity space / pressure space)
    diagM: jax.Array  # [n_unodes] mass diag (unscaled by dt)
    diagA: jax.Array  # [n_unodes] stiffness diag (unscaled by nu)
    lumpM: jax.Array  # [n_unodes] abs-lumped mass (unscaled by dt)
    diagMp: jax.Array  # [n_pnodes] pressure-mass diag
    # Explicit S~ structure (pattern + pair products; see ops/schur_ell.py)
    schur: "SchurELL"
    # Two-level coarse aggregation over S~ (see ops/coarse.py)
    coarse: "CoarseSchur"
    # Dirichlet
    dirichlet_mask: jax.Array  # [n_unodes] bool
    # Optional frozen SPAI values on the S~ pattern (see ops/spai.py)
    spai_vals: jax.Array | None = None
    # Per-cell IMEX convection weight (TimeConfig.convection="imex"):
    # 1.0 = this cell's convection stays linearised-implicit inside F,
    # 0.0 = it moves to the explicit AB rhs.  None = fully implicit.
    # Every C(w) contribution below is scaled by it; the explicit
    # complement (1 - imex_scale) weights the rhs term N(w)
    # (apply_rhs_and_r0 / apply_convection_self).
    imex_scale: jax.Array | None = None
    # Optional pairwise-halving reduce plan for the velocity scatter
    # (ops/scatter.py HalvingPlan): one flat 1-D gather + contiguous
    # reshape sums instead of the padded [rows, K] table gather.  Built
    # when NumericsConfig.reduce_plan == "halving".
    hplan_u: "object | None" = None
    # Optional p-multigrid (P2->P1) two-level structure for the velocity
    # block (ops/pmg.py); built when PrecondConfig.f_solver == "pmg".
    pmg: "object | None" = None
    # Optional windowed forward-gather plan (ops/scatter.py WindowedGather):
    # when set, gather_u streams per-cell-block vertex/edge windows and
    # gathers window-locally (gated by size via
    # NumericsConfig.gather_plan="auto").  Requires RCM ordering; single-
    # device only (not built for sharded or vmapped-ensemble operators).
    wgather_u: "object | None" = None
    # Optional assembled-transpose gradient (ops/scatter.py WeightedPlan):
    # when set, apply_gradient runs G p = -D^T p as a valence-bucketed ELL
    # SpMV gathering from the KB-scale pressure vector instead of the
    # element pass (p-gather + contraction + big velocity-space reduction
    # over the tens-of-MB element array): nnz(D) rows from a tiny source
    # instead of E*n_loc_u rows from a large one.  Built when
    # NumericsConfig.grad_apply resolves to "ell"; single-device only.
    gradt: "object | None" = None
    # Optional supernode block-sparse forms of the constant D / G blocks
    # (ops/bsr.py BSRMatrix): every gathered row is a [bs, C] panel (~384 B)
    # and the dense block values stream from device memory, replacing the
    # element-pass divergence and the narrow-row ELL gradient.  Values
    # assembled once on the host (float64).
    # Single-device only (sharded operators and vmapped ensembles strip
    # them, like wgather_u/gradt).
    dbsr: "object | None" = None
    gbsr: "object | None" = None
    # Scatter strategy (static): "gather" uses the precomputed gather-sum
    # plans (the single-device path, chosen before the H100 port, whose
    # scatter was serialised -- ROADMAP D4);
    # "scatter_add" uses jnp .at[].add on the cell index map -- under GSPMD
    # with the cell axis sharded this becomes per-device partial assembly +
    # an automatic psum, i.e. the reference's compress() collective (ref:
    # src/NavierStokes2D.cpp:315-320) expressed as an XLA reduction.
    scatter_mode: str = dataclasses.field(
        default="gather", metadata=dict(static=True)
    )
    # Element-contraction strategy (static): "vpu" evaluates the tiny
    # per-element matvecs ([E, i, j] x [E, j, c], j = n_loc) as broadcast
    # multiply + sum -- elementwise f32 arithmetic, EXACT whatever the
    # matmul precision (chosen before the H100 port; not yet measured on
    # the H100).  "einsum" keeps the matmul lowering -- the safe choice
    # under vmap (ensembles), where the broadcast intermediate relies on
    # XLA fusing a [B, E, i, j, c] product.
    contraction: str = dataclasses.field(
        default="einsum", metadata=dict(static=True)
    )

    @property
    def dim(self) -> int:
        return self.Jinv.shape[-1]

    @property
    def n_unodes(self) -> int:
        return self.diagM.shape[0]

    @property
    def n_pnodes(self) -> int:
        return self.diagMp.shape[0]

    @property
    def n_cells(self) -> int:
        return self.cells_u.shape[0]


# ----------------------------------------------------------------------
# Construction (host)
# ----------------------------------------------------------------------
def build_operator(
    space: TaylorHoodSpace,
    geom: CellGeometry,
    dirichlet_mask: np.ndarray,
    dtype=jnp.float32,
    tables: RefTables | None = None,
    coarse_agg: int = 24,
    device_schur_assembly: bool = True,
    want_host_schur: bool = False,
):
    """Build the static per-mesh operator pytree.

    device_schur_assembly=False keeps the S~ pair-product/assembly tables
    host-only (the frozen projection Schur assembles its values once in
    numpy -- ~230 MB at ~1M DoF that never go to the device).
    want_host_schur=True additionally returns the numpy assembly dict
    (pair products, slot layout, diagM) as a second value."""
    dim = space.dim
    t = tables or build_ref_tables(dim)
    E = space.mesh.n_cells

    GK = np.einsum("ekd,eld->ekl", geom.Jinv, geom.Jinv)
    GKd = GK * geom.detJ[:, None, None]

    # Global diagonals (float64 host assembly).
    diagM = np.zeros(space.n_unodes)
    diagA = np.zeros(space.n_unodes)
    lumpM = np.zeros(space.n_unodes)
    diagMp = np.zeros(space.n_pnodes)
    mdiag_e = geom.detJ[:, None] * np.diag(t.MHAT)[None, :]
    adiag_ref = np.einsum("klii->kli", t.AHAT)  # [dim, dim, n_loc_u]
    adiag_e = np.einsum("ekl,kli->ei", GKd, adiag_ref)
    lump_e = geom.detJ[:, None] * np.sum(np.abs(t.MHAT), axis=1)[None, :]
    mpdiag_e = geom.detJ[:, None] * np.diag(t.MPHAT)[None, :]
    np.add.at(diagM, space.cells_u, mdiag_e)
    np.add.at(diagA, space.cells_u, adiag_e)
    np.add.at(lumpM, space.cells_u, lump_e)
    np.add.at(diagMp, space.cells_p, mpdiag_e)

    # Divergence matrix in padded ELL (host-only: feeds the S~ pattern and
    # SPAI; never transferred to the device).
    D_cols, D_vals = _assemble_divergence_ell(space, geom, t)
    if device_schur_assembly:
        schur, schur_host = build_schur_ell(
            space, D_cols, D_vals, dtype=dtype, device_assembly=True,
        )
    else:
        # Frozen projection Schur: the values are needed only for the ONE
        # inv = diag(M)^-1 (Dirichlet-masked); SpGEMM computes pattern and
        # values together ~100x faster than the pair-enumeration tables
        # (which exist solely to support per-step reassembly).
        from navierstokes_project_nm4pde_tpu.ops.schur_ell import (
            build_schur_frozen,
        )

        inv1 = np.where(
            np.asarray(dirichlet_mask, dtype=bool), 0.0, 1.0 / diagM
        )
        schur, schur_host = build_schur_frozen(
            D_cols, D_vals, inv1, space.n_unodes, dtype=dtype
        )
    coarse = build_coarse_schur(
        schur, agg=coarse_agg, with_plan=device_schur_assembly
    )
    schur_host["diagM"] = diagM
    schur_host["D_cols"] = D_cols
    schur_host["D_vals"] = D_vals

    plan_u = build_gather_plan(
        space.cells_u, space.n_unodes, splits=(space.mesh.n_vertices,)
    )
    plan_p = build_gather_plan(space.cells_p, space.n_pnodes)

    dev = lambda x: jnp.asarray(x, dtype=dtype)  # noqa: E731
    idx = lambda x: jnp.asarray(x, dtype=jnp.int32)  # noqa: E731

    op = NSOperator(
        cells_u=idx(space.cells_u),
        cells_p=idx(space.cells_p),
        plan_u=plan_u,
        plan_p=plan_p,
        detJ=dev(geom.detJ),
        Jinv=dev(geom.Jinv),
        GKd=dev(GKd),
        W=dev(t.W),
        PHI_U=dev(t.PHI_U),
        GRAD_U=dev(t.GRAD_U),
        PHI_P=dev(t.PHI_P),
        MHAT=dev(t.MHAT),
        MPHAT=dev(t.MPHAT),
        AHAT=dev(t.AHAT),
        BHAT=dev(t.BHAT),
        diagM=dev(diagM),
        diagA=dev(diagA),
        lumpM=dev(lumpM),
        diagMp=dev(diagMp),
        schur=schur,
        coarse=coarse,
        dirichlet_mask=jnp.asarray(dirichlet_mask, dtype=bool),
    )
    return (op, schur_host) if want_host_schur else op


def _assemble_divergence_ell(space: TaylorHoodSpace, geom: CellGeometry, t: RefTables):
    """Assemble D (pressure rows x velocity-node cols, one value per velocity
    component) into padded ELL: cols [n_p, W], vals [n_p, W, dim]."""
    dim = space.dim
    E = space.mesh.n_cells
    n_locp, n_locu = t.PHI_P.shape[1], t.PHI_U.shape[1]
    # element divergence blocks: D_e[i, j, c] = detJ * sum_k Jinv[k,c] BHAT[k,i,j]
    D_e = np.einsum("ekc,kij->eijc", geom.Jinv, t.BHAT) * geom.detJ[:, None, None, None]
    rows = np.repeat(space.cells_p.astype(np.int64), n_locu, axis=1).reshape(-1)
    cols = np.tile(space.cells_u.astype(np.int64), (1, n_locp)).reshape(-1)
    vals = D_e.reshape(-1, dim)  # [(E*n_locp*n_locu), dim]

    # Duplicate (row, col) reduction via scipy's COO->CSR canonicalisation
    # (C-speed sort+sum; the former key-argsort/unique/reduceat chain over
    # the 18M raw slots cost ~47 s at 609k DoF on a 1-core host).  All dim
    # components share the same coordinates, so the canonical patterns are
    # identical and the per-component data align slot for slot.
    import scipy.sparse as sp

    csr = [
        sp.csr_matrix(
            (vals[:, d], (rows, cols)),
            shape=(space.n_pnodes, space.n_unodes),
        )
        for d in range(dim)
    ]
    for c in csr:
        c.sum_duplicates()
        c.sort_indices()
        assert c.nnz == csr[0].nnz
    indptr, indices = csr[0].indptr, csr[0].indices
    counts = np.diff(indptr)
    Wd = int(counts.max())
    urow = np.repeat(np.arange(space.n_pnodes, dtype=np.int64), counts)
    slot = np.arange(indices.shape[0], dtype=np.int64) - indptr[:-1][urow]
    D_cols = np.zeros((space.n_pnodes, Wd), dtype=np.int64)
    D_vals = np.zeros((space.n_pnodes, Wd, dim))
    D_cols[urow, slot] = indices
    for d in range(dim):
        D_vals[urow, slot, d] = csr[d].data
    return D_cols, D_vals


# ----------------------------------------------------------------------
# Gather / scatter
# ----------------------------------------------------------------------
def gather_u(op: NSOperator, u: jax.Array) -> jax.Array:
    if op.wgather_u is not None:
        from navierstokes_project_nm4pde_tpu.ops.scatter import (
            apply_windowed_gather,
        )

        return apply_windowed_gather(op.wgather_u, u)
    return u[op.cells_u]  # [E, n_loc_u, dim]


def gather_p(op: NSOperator, p: jax.Array) -> jax.Array:
    return p[op.cells_p]  # [E, dim+1]


def scatter_u(op: NSOperator, y_e: jax.Array) -> jax.Array:
    """[E, n_loc_u, dim] element contributions -> [n_unodes, dim]."""
    if op.scatter_mode == "scatter_add":
        out = jnp.zeros((op.n_unodes, y_e.shape[-1]), y_e.dtype)
        return out.at[op.cells_u].add(y_e)
    flat = y_e.reshape(-1, y_e.shape[-1])
    if op.hplan_u is not None:
        from navierstokes_project_nm4pde_tpu.ops.scatter import (
            apply_halving_plan,
        )

        return apply_halving_plan(op.hplan_u, flat)
    return apply_gather_plan(op.plan_u, flat)


def scatter_u_scalar(op: NSOperator, d_e: jax.Array) -> jax.Array:
    """[E, n_loc_u] scalar element contributions -> [n_unodes]."""
    if op.scatter_mode == "scatter_add":
        out = jnp.zeros((op.n_unodes,), d_e.dtype)
        return out.at[op.cells_u].add(d_e)
    return apply_gather_plan(op.plan_u, d_e.reshape(-1))


def scatter_p(op: NSOperator, y_e: jax.Array) -> jax.Array:
    if op.scatter_mode == "scatter_add":
        out = jnp.zeros((op.n_pnodes,), y_e.dtype)
        return out.at[op.cells_p].add(y_e)
    return apply_gather_plan(op.plan_p, y_e.reshape(-1))


# ----------------------------------------------------------------------
# Exact elementwise element contractions (see NSOperator.contraction)
# ----------------------------------------------------------------------
def _emv(A: jax.Array, x: jax.Array) -> jax.Array:
    """[(E,) i, j] x [E, j, c] -> [E, i, c] as broadcast multiply + sum:
    exact f32 arithmetic whatever the matmul precision.  A may be
    unbatched ([i, j], e.g. MHAT) -- broadcasting aligns trailing dims."""
    return (A[..., :, :, None] * x[..., None, :, :]).sum(axis=-2)


def _grad_p_e(op: NSOperator, p_e: jax.Array) -> jax.Array:
    """D^T p element contribution: y[e,j,c] = sum_ki Jinv[e,k,c]
    BHAT[k,i,j] p_e[e,i] (times detJ at the call site)."""
    if op.contraction == "vpu":
        # s[e,k,j] = sum_i BHAT[k,i,j] p_e[e,i]
        s = (op.BHAT[None] * p_e[:, None, :, None]).sum(axis=2)
        # y[e,j,c] = sum_k s[e,k,j] Jinv[e,k,c]
        return (s[:, :, :, None] * op.Jinv[:, :, None, :]).sum(axis=1)
    return jnp.einsum("ekc,kij,ei->ejc", op.Jinv, op.BHAT, p_e)


def _div_u_e(op: NSOperator, u_e: jax.Array) -> jax.Array:
    """D u element contribution: y[e,i] = sum_kjc Jinv[e,k,c] BHAT[k,i,j]
    u_e[e,j,c] (times detJ at the call site)."""
    if op.contraction == "vpu":
        # t[e,k,j] = sum_c Jinv[e,k,c] u_e[e,j,c]
        t = (op.Jinv[:, :, None, :] * u_e[:, None, :, :]).sum(axis=-1)
        # y[e,i] = sum_kj BHAT[k,i,j] t[e,k,j]
        return (op.BHAT[None] * t[:, :, None, :]).sum(axis=(1, 3))
    return jnp.einsum("ekc,kij,ejc->ei", op.Jinv, op.BHAT, u_e)


# ----------------------------------------------------------------------
# Constant blocks
# ----------------------------------------------------------------------
def apply_mass(op: NSOperator, u: jax.Array) -> jax.Array:
    """y = M u (velocity mass, unscaled; scale by 1/dt at the call site)."""
    u_e = gather_u(op, u)
    if op.contraction == "vpu":
        y_e = _emv(op.MHAT, u_e) * op.detJ[:, None, None]
    else:
        y_e = jnp.einsum("ij,ejc->eic", op.MHAT, u_e) * op.detJ[:, None, None]
    return scatter_u(op, y_e)


def apply_stiffness(op: NSOperator, u: jax.Array) -> jax.Array:
    """y = A u (vector Laplacian, unscaled by nu)."""
    u_e = gather_u(op, u)
    y_e = jnp.einsum("ekl,klij,ejc->eic", op.GKd, op.AHAT, u_e)
    return scatter_u(op, y_e)


def apply_divergence(op: NSOperator, u: jax.Array) -> jax.Array:
    """y = D u : continuity rows (q, div u) (ref: src/NavierStokes2D.cpp:262)."""
    if op.dbsr is not None:
        from navierstokes_project_nm4pde_tpu.ops.bsr import apply_bsr

        return apply_bsr(op.dbsr, u)[:, 0]
    return apply_divergence_e(op, gather_u(op, u))


def apply_divergence_e(op: NSOperator, u_e: jax.Array) -> jax.Array:
    """D u from a pre-gathered element view u_e [E, n_loc_u, dim]: the
    projection stepper reconstructs u*'s element view from the Krylov
    applies' gathers (fgmres aux=True) and skips the divergence gather."""
    y_e = _div_u_e(op, u_e) * op.detJ[:, None]
    return scatter_p(op, y_e)


def apply_gradient(op: NSOperator, p: jax.Array) -> jax.Array:
    """y = G p = -D^T p : momentum rows -(p, div v) (ref: src/NavierStokes2D.cpp:259)."""
    if op.gbsr is not None:
        from navierstokes_project_nm4pde_tpu.ops.bsr import apply_bsr

        return apply_bsr(op.gbsr, p[:, None])
    if op.gradt is not None:
        from navierstokes_project_nm4pde_tpu.ops.scatter import (
            apply_weighted_plan,
        )

        return apply_weighted_plan(op.gradt, p)
    p_e = gather_p(op, p)
    y_e = -_grad_p_e(op, p_e) * op.detJ[:, None, None]
    return scatter_u(op, y_e)


def build_gradient_plan(
    schur_host: dict, n_unodes: int, dtype=jnp.float32, min_rows: int = 4096
):
    """Assemble G = -D^T into a WeightedPlan (see NSOperator.gradt) from the
    host-side divergence ELL (`schur_host["D_cols"/"D_vals"]`, one value per
    velocity component per (pressure row, velocity col) pair)."""
    from navierstokes_project_nm4pde_tpu.ops.scatter import (
        build_weighted_plan,
    )

    D_cols, D_vals = schur_host["D_cols"], schur_host["D_vals"]
    n_p, Wd = D_cols.shape
    keep = (D_vals != 0.0).any(axis=-1)  # drops ELL padding (+ exact zeros)
    rows = D_cols[keep]  # velocity node = transpose row
    cols = np.broadcast_to(np.arange(n_p)[:, None], (n_p, Wd))[keep]
    vals = -D_vals[keep]  # G = -D^T
    return build_weighted_plan(
        rows, cols, vals, n_unodes, n_p, dtype=dtype, min_rows=min_rows
    )


def apply_mass_minus_gradient(op: NSOperator, h: jax.Array, p: jax.Array) -> jax.Array:
    """y = M h - G p = M h + D^T p in ONE element pass + ONE velocity-space
    reduction (the projection stepper's momentum rhs; two separate applies
    would pay the reduction twice)."""
    u_e = gather_u(op, h)
    p_e = gather_p(op, p)
    if op.contraction == "vpu":
        y_e = (_emv(op.MHAT, u_e) + _grad_p_e(op, p_e)) * op.detJ[:, None, None]
    else:
        y_e = jnp.einsum("ij,ejc->eic", op.MHAT, u_e) * op.detJ[:, None, None]
        y_e = y_e + jnp.einsum(
            "ekc,kij,ei->ejc", op.Jinv, op.BHAT, p_e
        ) * op.detJ[:, None, None]
    return scatter_u(op, y_e)


def apply_rhs_and_r0(
    op: NSOperator, h: jax.Array, p: jax.Array, nu, dt,
    conv: "ConvectionData | None", u0: jax.Array,
    h_e: jax.Array | None = None, u0_e: jax.Array | None = None,
    w_e: jax.Array | None = None,
):
    """(b, r0) = (M h - G p,  b - F u0) in ONE element pass and ONE
    dual-channel reduction.

    The projection step needs both the momentum rhs (for the absolute
    tolerance target) and the warm-start residual; computed separately they
    pay the velocity reduction twice (one [n, 2*dim] reduce instead of two
    [n, dim] ones).  Dirichlet rows and the backflow facet term are the
    caller's business (cheap vector ops).

    `h_e`/`u0_e` accept pre-gathered element views of `h`/`u0`: a caller
    that stacks several node-space vectors into one wide gather
    (models/base.py `_step_projection`) pays for ONE gather instead of
    three.

    `w_e` (IMEX mode, op.imex_scale set): the element view of the
    convection velocity w, used to fuse the explicit cells' rhs term
    -(1 - imex_scale) N(w) into the same pass."""
    h_e = gather_u(op, h) if h_e is None else h_e
    u0_e = gather_u(op, u0) if u0_e is None else u0_e
    p_e = gather_p(op, p)
    if op.contraction == "vpu":
        b_e = (_emv(op.MHAT, h_e) + _grad_p_e(op, p_e)) * op.detJ[:, None, None]
    else:
        b_e = jnp.einsum("ij,ejc->eic", op.MHAT, h_e) * op.detJ[:, None, None]
        b_e = b_e + jnp.einsum(
            "ekc,kij,ei->ejc", op.Jinv, op.BHAT, p_e
        ) * op.detJ[:, None, None]
    if conv is not None and conv.F_e is not None:
        _check_fold(conv, nu, dt)
        if op.contraction == "vpu":
            f_e = _emv(conv.F_e, u0_e)
        else:
            f_e = jnp.einsum("eij,ejc->eic", conv.F_e, u0_e)
    else:
        f_e = jnp.einsum("ij,ejc->eic", op.MHAT, u0_e) * (op.detJ / dt)[:, None, None]
        f_e = f_e + nu * jnp.einsum("ekl,klij,ejc->eic", op.GKd, op.AHAT, u0_e)
        if conv is not None:
            u_q = jnp.einsum("qi,eic->eqc", op.PHI_U, u0_e)
            dir_q = jnp.einsum("eqi,eic->eqc", conv.WG, u0_e)
            r = dir_q + 0.5 * conv.divw[:, :, None] * u_q
            if op.imex_scale is not None:
                r = r * op.imex_scale[:, None, None]
            f_e = f_e + jnp.einsum(
                "q,qi,eqc->eic", op.W, op.PHI_U, r
            ) * op.detJ[:, None, None]
    if conv is not None and op.imex_scale is not None and w_e is not None:
        # IMEX: the explicit cells' convection rhs N(w) = C(w) w, weighted
        # by (1 - imex_scale) and FUSED into this pass (its own element
        # pass would cost a second full gather + reduce).  conv.WG/divw
        # are already the tables of C(w) at these quadrature points.
        w_q = jnp.einsum("qi,eic->eqc", op.PHI_U, w_e)
        nw = jnp.einsum("eqi,eic->eqc", conv.WG, w_e)
        nw = nw + 0.5 * conv.divw[:, :, None] * w_q
        nw = nw * (1.0 - op.imex_scale)[:, None, None]
        b_e = b_e - jnp.einsum(
            "q,qi,eqc->eic", op.W, op.PHI_U, nw
        ) * op.detJ[:, None, None]
    y_e = jnp.concatenate([b_e, b_e - f_e], axis=-1)  # [E, nloc, 2*dim]
    y = scatter_u(op, y_e)
    d = h.shape[1]
    b, r0 = y[:, :d], y[:, d:]
    if conv is not None and conv.bf_coef is not None:
        from navierstokes_project_nm4pde_tpu.ops.scatter import apply_gather_plan

        bf = conv.bf
        u_f = u0[bf.cells_u]
        u_qf = jnp.einsum("fqi,fic->fqc", bf.phi_u, u_f)
        y_f = jnp.einsum("fq,fqi,fqc->fic", conv.bf_coef, bf.phi_u, u_qf)
        r0 = r0 - apply_gather_plan(
            bf.plan, y_f.reshape(-1, y_f.shape[-1])
        ).astype(r0.dtype)
    return b, r0


def apply_pressure_mass(op: NSOperator, p: jax.Array) -> jax.Array:
    """y = Mp p (unscaled; the reference scales by 1/nu at assembly:
    src/NavierStokes2D.cpp:265)."""
    p_e = gather_p(op, p)
    y_e = jnp.einsum("ij,ej->ei", op.MPHAT, p_e) * op.detJ[:, None]
    return scatter_p(op, y_e)


# ----------------------------------------------------------------------
# Convection C(w): refreshed once per time step
# ----------------------------------------------------------------------
@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BackflowTables:
    """Static facet tables for backflow stabilisation on an open boundary
    (the reference carries this term disabled behind `&& false`;
    ref: src/NavierStokes2D.cpp:456-483 -- here it is a live option)."""

    cells_u: jax.Array  # [f, n_loc_u]
    phi_u: jax.Array  # [f, q, n_loc_u]
    jxw: jax.Array  # [f, q]
    normal: jax.Array  # [f, dim]
    plan: "object"  # GatherPlan into the velocity space


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ConvectionData:
    WG: jax.Array  # [E, q, n_loc_u]  (w . grad phi_i)(x_q)
    divw: jax.Array  # [E, q]          div w (x_q)
    # Global diagonal of C(w); None when built with with_diag=False (the
    # projection stepper's freeze_conv_diag mode: the diagonal of the
    # skew-symmetrised convection + Temam form is near zero, and computing
    # it costs a full scalar reduction per step).
    diagC: jax.Array | None
    bf: BackflowTables | None = None
    bf_coef: jax.Array | None = None  # [f, q] -rho/2 min(w.n, 0) JxW
    # Folded per-element F matrices [E, n_loc_u, n_loc_u] for the (nu, dt)
    # this step solves with: F_e = detJ/dt M^ + nu GKd:A^ + C_e(w).  One
    # batched matmul per apply replaces the 5-einsum chain (whose q-space
    # intermediates round-trip device memory).  Costs ~400 B/cell; built
    # per step when fold=(nu, dt) is passed.
    F_e: jax.Array | None = None
    # The concrete (nu, dt) the fold was built for, when both were Python
    # numbers at fold time (None when either was traced, e.g. vmapped nu or
    # BDF2's dt_eff).  apply_F/apply_system verify their arguments against
    # it so a folded ConvectionData cannot silently apply the wrong
    # operator.
    fold_static: tuple | None = dataclasses.field(
        default=None, metadata=dict(static=True)
    )
    # F_e holds ONLY the convection part C_e(w) (the macro K/C split:
    # the constant M/dt + nu A lives in setup-time macro blocks and is
    # recombined there).  apply_F/apply_system refuse such a fold -- it
    # is not the full velocity operator.
    conv_only: bool = dataclasses.field(
        default=False, metadata=dict(static=True)
    )


def convection_setup(
    op: NSOperator,
    w: jax.Array,
    backflow: BackflowTables | None = None,
    fold: tuple | None = None,
    w_e: jax.Array | None = None,
    with_diag: bool = True,
    base_e: jax.Array | None = None,
    conv_only: bool = False,
) -> ConvectionData:
    """Tabulate the linearised convection + Temam term at quadrature points.

    Mirrors `assemble_time_step` rebuilding only C(u_n)
    (ref: src/NavierStokes2D.cpp:361-527).  With `backflow` tables, adds the
    stabilisation -rho/2 min(w.n, 0)(u, v) on the open boundary (the
    reference's dormant variant uses a 3/2 factor with BDF2 extrapolation;
    here the standard rho/2 form acts on the same convection velocity w).

    `w_e` accepts a pre-gathered element view of `w` (see apply_rhs_and_r0).
    `with_diag=False` skips the diagC tabulation -- an element pass plus a
    full scalar reduction whose only consumer is the Jacobi
    diagonal of F (the projection stepper's freeze_conv_diag mode; forced
    on when `backflow` is present, whose facet term does shift the
    diagonal)."""
    if w_e is None:
        w_e = gather_u(op, w)  # [E, nu, dim]
    w_q = jnp.einsum("qi,eic->eqc", op.PHI_U, w_e)
    wtilde = jnp.einsum("ekd,eqd->eqk", op.Jinv, w_q)
    WG = jnp.einsum("qik,eqk->eqi", op.GRAD_U, wtilde)
    gref = jnp.einsum("qik,eic->eqkc", op.GRAD_U, w_e)
    divw = jnp.einsum("eqkc,ekc->eq", gref, op.Jinv)
    diagC = None
    s = op.imex_scale  # IMEX: implicit-cell weight on every C(w) term
    if with_diag or backflow is not None:
        # diagonal: sum_q jxw * (WG_i * phi_i + 0.5 * divw * phi_i^2)
        d_e = jnp.einsum(
            "q,eqi,qi->ei", op.W, WG + 0.5 * divw[:, :, None] * op.PHI_U[None],
            op.PHI_U,
        ) * op.detJ[:, None]
        if s is not None:
            d_e = d_e * s[:, None]
        diagC = scatter_u_scalar(op, d_e)

    bf_coef = None
    if backflow is not None:
        from navierstokes_project_nm4pde_tpu.ops.scatter import apply_gather_plan

        w_f = w[backflow.cells_u]  # [f, nloc, dim]
        w_qf = jnp.einsum("fqi,fic->fqc", backflow.phi_u, w_f)
        un = jnp.einsum("fqc,fc->fq", w_qf, backflow.normal)
        bf_coef = -0.5 * jnp.minimum(un, 0.0) * backflow.jxw  # >= 0
        d_f = jnp.einsum("fq,fqi,fqi->fi", bf_coef, backflow.phi_u, backflow.phi_u)
        diagC = diagC + apply_gather_plan(backflow.plan, d_f.reshape(-1))

    F_e = None
    fold_static = None
    if fold is not None:
        nu, dt = fold
        if conv_only:
            # Macro K/C split: emit ONLY the convection element matrices
            # C_e(w) (skew form + Temam term); the constant M/dt + nu A
            # part lives in setup-time macro blocks (models/base.py
            # macro_mass/macro_stiff) and is recombined per step on the
            # block-dense side.
            F_e = jnp.zeros(
                (op.detJ.shape[0],) + op.MHAT.shape, WG.dtype
            )
        else:
            F_e = op.MHAT[None] * (op.detJ / dt)[:, None, None]
            if base_e is not None:
                # `base_e` is the constant GKd:AHAT element stiffness,
                # precomputed ONCE at setup (models/base.py DeviceData
                # .conv_base) -- the einsum below rebuilt a
                # time-independent [E, nloc, nloc] array every step.
                F_e = F_e + nu * base_e
            else:
                F_e = F_e + nu * jnp.einsum("ekl,klij->eij", op.GKd, op.AHAT)
        R = WG + 0.5 * divw[:, :, None] * op.PHI_U[None]
        cdet = op.detJ if s is None else op.detJ * s
        if op.contraction == "vpu":
            WPHI = op.W[:, None] * op.PHI_U  # [q, i]
            F_e = F_e + (
                WPHI[None, :, :, None] * R[:, :, None, :]
            ).sum(axis=1) * cdet[:, None, None]
        else:
            F_e = F_e + jnp.einsum(
                "q,qi,eqj->eij", op.W, op.PHI_U, R
            ) * cdet[:, None, None]
        if not conv_only and isinstance(nu, (int, float)) and isinstance(
            dt, (int, float)
        ):
            fold_static = (float(nu), float(dt))
    return ConvectionData(
        WG=WG, divw=divw, diagC=diagC, bf=backflow, bf_coef=bf_coef, F_e=F_e,
        fold_static=fold_static, conv_only=conv_only and fold is not None,
    )


def apply_convection_self(
    op: NSOperator, w: jax.Array, backflow: BackflowTables | None = None
) -> jax.Array:
    """y = C(w) w: the explicit-convection rhs term, fused.

    One DoF gather + one reduction per STEP (vs the implicit scheme's
    per-iteration convection inside F): evaluates ((w.grad)w, v) +
    0.5((div w) w, v) (the Temam term, ref: src/NavierStokes2D.cpp:256)
    directly at quadrature points without materialising ConvectionData
    (no diagC reduction, no fold).  With `backflow`, the open-boundary
    stabilisation -rho/2 min(w.n, 0)(w, v) is evaluated on w as well."""
    w_e = gather_u(op, w)
    w_q = jnp.einsum("qi,eic->eqc", op.PHI_U, w_e)
    wtilde = jnp.einsum("ekd,eqd->eqk", op.Jinv, w_q)
    WG = jnp.einsum("qik,eqk->eqi", op.GRAD_U, wtilde)
    gref = jnp.einsum("qik,eic->eqkc", op.GRAD_U, w_e)
    divw = jnp.einsum("eqkc,ekc->eq", gref, op.Jinv)
    dir_q = jnp.einsum("eqi,eic->eqc", WG, w_e)
    r = dir_q + 0.5 * divw[:, :, None] * w_q
    y_e = jnp.einsum("q,qi,eqc->eic", op.W, op.PHI_U, r) * op.detJ[:, None, None]
    y = scatter_u(op, y_e)
    if backflow is not None:
        from navierstokes_project_nm4pde_tpu.ops.scatter import apply_gather_plan

        w_f = w[backflow.cells_u]
        w_qf = jnp.einsum("fqi,fic->fqc", backflow.phi_u, w_f)
        un = jnp.einsum("fqc,fc->fq", w_qf, backflow.normal)
        coef = -0.5 * jnp.minimum(un, 0.0) * backflow.jxw
        y_f = jnp.einsum("fq,fqi,fqc->fic", coef, backflow.phi_u, w_qf)
        y = y + apply_gather_plan(
            backflow.plan, y_f.reshape(-1, y_f.shape[-1])
        ).astype(y.dtype)
    return y


def apply_convection(op: NSOperator, conv: ConvectionData, u: jax.Array) -> jax.Array:
    """y = C(w) u = ((w.grad)u, v) + 0.5((div w) u, v) (implicit part
    only under IMEX: scaled by op.imex_scale)."""
    u_e = gather_u(op, u)
    u_q = jnp.einsum("qi,eic->eqc", op.PHI_U, u_e)
    dir_q = jnp.einsum("eqi,eic->eqc", conv.WG, u_e)
    r = dir_q + 0.5 * conv.divw[:, :, None] * u_q
    if op.imex_scale is not None:
        r = r * op.imex_scale[:, None, None]
    y_e = jnp.einsum("q,qi,eqc->eic", op.W, op.PHI_U, r) * op.detJ[:, None, None]
    return scatter_u(op, y_e)


# ----------------------------------------------------------------------
# IMEX fine subset: the implicit-convection cells' per-iteration pass
# ----------------------------------------------------------------------
@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ImexTables:
    """Static tables of the IMEX fine (implicit-convection) cell subset.

    With the constant K = M/dt + nu A applied as a supernode BSR operator
    (ops/bsr.py), only this subset pays the per-Krylov-iteration element
    pass: F u = K u + C_fine(w) u."""

    f_idx: jax.Array  # [E_f] int32 cell ids (into the full cell axis)
    cells_f: jax.Array  # [E_f, n_loc_u] int32
    Jinv_f: jax.Array  # [E_f, dim, dim]
    detJ_f: jax.Array  # [E_f]
    plan_f: "object"  # GatherPlan: [E_f * n_loc_u] slots -> n_unodes rows


def build_imex_tables(space, geom, implicit_cells, dtype) -> ImexTables:
    """Tables for the implicit-convection subset (cell ids
    `implicit_cells`)."""
    from navierstokes_project_nm4pde_tpu.ops.scatter import (
        build_gather_plan_grouped,
    )

    f = np.asarray(implicit_cells, dtype=np.int64)
    cells_f = np.asarray(space.cells_u)[f]
    plan_f = build_gather_plan_grouped(
        cells_f.reshape(-1, 1), space.n_unodes,
        thresholds=tuple(range(1, 97)), mode="columns",
    )
    return ImexTables(
        f_idx=jnp.asarray(f, jnp.int32),
        cells_f=jnp.asarray(cells_f, jnp.int32),
        Jinv_f=jnp.asarray(geom.Jinv[f], dtype),
        detJ_f=jnp.asarray(geom.detJ[f], dtype),
        plan_f=plan_f,
    )


def convection_fine_fold(op: NSOperator, imex: ImexTables, w_ef: jax.Array):
    """Per-element C_e(w) on the fine subset: [E_f, n_loc, n_loc]
    (unweighted -- fine cells carry imex_scale 1).  `w_ef` is the element
    view of w on the subset (slice the step's stacked gather)."""
    w_q = jnp.einsum("qi,eic->eqc", op.PHI_U, w_ef)
    wtilde = jnp.einsum("ekd,eqd->eqk", imex.Jinv_f, w_q)
    WG = jnp.einsum("qik,eqk->eqi", op.GRAD_U, wtilde)
    gref = jnp.einsum("qik,eic->eqkc", op.GRAD_U, w_ef)
    divw = jnp.einsum("eqkc,ekc->eq", gref, imex.Jinv_f)
    R = WG + 0.5 * divw[:, :, None] * op.PHI_U[None]
    if op.contraction == "vpu":
        WPHI = op.W[:, None] * op.PHI_U  # [q, i]
        C = (WPHI[None, :, :, None] * R[:, :, None, :]).sum(axis=1)
    else:
        C = jnp.einsum("q,qi,eqj->eij", op.W, op.PHI_U, R)
    return C * imex.detJ_f[:, None, None]


def apply_convection_fine(
    op: NSOperator, imex: ImexTables, C_ef: jax.Array, u: jax.Array
) -> jax.Array:
    """y = C_fine(w) u: subset gather + tiny contraction + subset reduce."""
    from navierstokes_project_nm4pde_tpu.ops.scatter import apply_gather_plan

    u_ef = u[imex.cells_f]
    if op.contraction == "vpu":
        y_ef = _emv(C_ef, u_ef)
    else:
        y_ef = jnp.einsum("eij,ejc->eic", C_ef, u_ef)
    return apply_gather_plan(imex.plan_f, y_ef.reshape(-1, u.shape[1]))


# ----------------------------------------------------------------------
# The time-step velocity block F = M/dt + nu*A + C(w) and the full system
# ----------------------------------------------------------------------
def apply_F(
    op: NSOperator, nu, dt, conv: ConvectionData | None, u: jax.Array,
    u_e: jax.Array | None = None,
) -> jax.Array:
    """F u with F = M/dt + nu*A + C(w).

    If `u` arrives as bfloat16 (the preconditioner's low-precision mode),
    both gather payloads -- the DoF gather and the contribution reduction --
    stay bf16 (half the dominant memory traffic); the einsum arithmetic still
    accumulates in f32 against the f32 reference tables.

    `u_e` accepts a pre-gathered element view of `u` (must equal
    gather_u(op, u); callers that need the element view anyway -- e.g. the
    projection stepper's aux-collecting Krylov operator -- pay one gather)."""
    lowp = u.dtype == jnp.bfloat16
    if u_e is None:
        u_e = gather_u(op, u)
    if lowp:
        u_e = u_e.astype(op.MHAT.dtype)
    if conv is not None and conv.F_e is not None:
        # Folded fast path: conv.F_e was built for THIS (nu, dt) by
        # convection_setup(..., fold=(nu, dt)) -- caller contract,
        # verified whenever both sides are concrete.
        _check_fold(conv, nu, dt)
        if op.contraction == "vpu":
            y_e = _emv(conv.F_e, u_e)
        else:
            y_e = jnp.einsum("eij,ejc->eic", conv.F_e, u_e)
    else:
        y_e = jnp.einsum("ij,ejc->eic", op.MHAT, u_e) * (op.detJ / dt)[:, None, None]
        y_e = y_e + nu * jnp.einsum("ekl,klij,ejc->eic", op.GKd, op.AHAT, u_e)
        if conv is not None:
            u_q = jnp.einsum("qi,eic->eqc", op.PHI_U, u_e)
            dir_q = jnp.einsum("eqi,eic->eqc", conv.WG, u_e)
            r = dir_q + 0.5 * conv.divw[:, :, None] * u_q
            if op.imex_scale is not None:
                r = r * op.imex_scale[:, None, None]
            y_e = y_e + jnp.einsum("q,qi,eqc->eic", op.W, op.PHI_U, r) * op.detJ[:, None, None]
    if lowp:
        y_e = y_e.astype(jnp.bfloat16)
    y = scatter_u(op, y_e)
    if conv is not None and conv.bf_coef is not None:
        from navierstokes_project_nm4pde_tpu.ops.scatter import apply_gather_plan

        bf = conv.bf
        u_f = u[bf.cells_u]
        if lowp:
            u_f = u_f.astype(op.MHAT.dtype)
        u_qf = jnp.einsum("fqi,fic->fqc", bf.phi_u, u_f)
        y_f = jnp.einsum("fq,fqi,fqc->fic", conv.bf_coef, bf.phi_u, u_qf)
        y = y + apply_gather_plan(
            bf.plan, y_f.reshape(-1, y_f.shape[-1])
        ).astype(y.dtype)
    return y


def _check_fold(conv: ConvectionData, nu, dt) -> None:
    """Raise if a folded ConvectionData is applied with a different concrete
    (nu, dt) than it was built for (silent wrong-operator guard)."""
    if conv.conv_only:
        raise ValueError(
            "ConvectionData was folded conv_only (macro K/C split): its "
            "F_e is NOT the full velocity operator and cannot drive "
            "apply_F/apply_system"
        )
    if conv.fold_static is None:
        return
    if not (isinstance(nu, (int, float)) and isinstance(dt, (int, float))):
        return  # traced values: cannot compare at trace time
    fnu, fdt = conv.fold_static
    if abs(float(nu) - fnu) > 1e-12 * max(1.0, abs(fnu)) or (
        abs(float(dt) - fdt) > 1e-12 * max(1.0, abs(fdt))
    ):
        raise ValueError(
            f"folded ConvectionData was built for (nu={fnu}, dt={fdt}) but "
            f"applied with (nu={nu}, dt={dt}); rebuild via convection_setup"
        )


def diag_F(op: NSOperator, nu, dt, conv: ConvectionData | None) -> jax.Array:
    d = op.diagM / dt + nu * op.diagA
    if conv is not None and conv.diagC is not None:
        d = d + conv.diagC
    return d


def apply_system(op: NSOperator, nu, dt, conv, u, p, mask_rows: bool = True):
    """Full saddle-point operator with Dirichlet row elimination.

    Constrained velocity rows become identity rows, mirroring
    `MatrixTools::apply_boundary_values` with eliminate_columns=false
    (ref: src/NavierStokes2D.cpp:354).

    The F and G element contributions share one element pass and ONE
    velocity-space reduction (each separate reduction has a fixed on-device
    cost that rivals its bandwidth cost)."""
    u_e = gather_u(op, u)
    p_e = gather_p(op, p)
    # F part (folded fast path when conv.F_e matches this (nu, dt))
    if conv is not None and conv.F_e is not None:
        _check_fold(conv, nu, dt)
        if op.contraction == "vpu":
            y_e = _emv(conv.F_e, u_e)
        else:
            y_e = jnp.einsum("eij,ejc->eic", conv.F_e, u_e)
    else:
        y_e = jnp.einsum("ij,ejc->eic", op.MHAT, u_e) * (op.detJ / dt)[:, None, None]
        y_e = y_e + nu * jnp.einsum("ekl,klij,ejc->eic", op.GKd, op.AHAT, u_e)
        if conv is not None:
            u_q = jnp.einsum("qi,eic->eqc", op.PHI_U, u_e)
            dir_q = jnp.einsum("eqi,eic->eqc", conv.WG, u_e)
            r = dir_q + 0.5 * conv.divw[:, :, None] * u_q
            if op.imex_scale is not None:
                r = r * op.imex_scale[:, None, None]
            y_e = y_e + jnp.einsum("q,qi,eqc->eic", op.W, op.PHI_U, r) * op.detJ[:, None, None]
    # G part (momentum pressure gradient) fused into the same reduction
    y_e = y_e - jnp.einsum("ekc,kij,ei->ejc", op.Jinv, op.BHAT, p_e) * op.detJ[:, None, None]
    y_u = scatter_u(op, y_e)
    if conv is not None and conv.bf_coef is not None:
        from navierstokes_project_nm4pde_tpu.ops.scatter import apply_gather_plan

        bf = conv.bf
        u_f = u[bf.cells_u]
        u_qf = jnp.einsum("fqi,fic->fqc", bf.phi_u, u_f)
        y_f = jnp.einsum("fq,fqi,fqc->fic", conv.bf_coef, bf.phi_u, u_qf)
        y_u = y_u + apply_gather_plan(bf.plan, y_f.reshape(-1, y_f.shape[-1]))
    # divergence rows
    y_pe = jnp.einsum("ekc,kij,ejc->ei", op.Jinv, op.BHAT, u_e) * op.detJ[:, None]
    y_p = scatter_p(op, y_pe)
    if mask_rows:
        y_u = jnp.where(op.dirichlet_mask[:, None], u, y_u)
    return y_u, y_p


# ----------------------------------------------------------------------
# Schur-complement support: S = D diag(F)^-1 D^T via the ELL rows of D
# ----------------------------------------------------------------------
def apply_D_ell(host: dict, u: jax.Array) -> jax.Array:
    """D u via the host-assembled ELL rows of D (cross-check against the
    element-path apply_divergence; `host` from want_host_schur=True)."""
    D_cols = jnp.asarray(host["D_cols"], jnp.int32)
    D_vals = jnp.asarray(host["D_vals"], u.dtype)
    return jnp.einsum("pwc,pwc->p", D_vals, u[D_cols])


def apply_Dt_ell(op: NSOperator, p: jax.Array, mask=None) -> jax.Array:
    """D^T p (velocity space). Computed element-free via scatter of ELL rows
    would need a transpose plan; use the element path instead."""
    return -apply_gradient(op, p)


def schur_diag(host: dict, inv_diag_F: jax.Array, mask: jax.Array) -> jax.Array:
    """diag(S~) with S~ = D diag(F)^-1 D^T, excluding Dirichlet-masked
    velocity columns (their F rows are identity rows).  Host ELL rows of D
    (`host` from want_host_schur=True)."""
    D_cols = jnp.asarray(host["D_cols"], jnp.int32)
    D_vals = jnp.asarray(host["D_vals"], inv_diag_F.dtype)
    w = jnp.where(mask[D_cols], 0.0, inv_diag_F[D_cols])  # [n_p, Wd]
    return jnp.einsum("pwc,pw->p", D_vals**2, w)


def apply_schur(op: NSOperator, inv_diag_F: jax.Array, p: jax.Array) -> jax.Array:
    """S~ p = D diag(F)^-1 D^T p with Dirichlet velocity columns masked out."""
    g = -apply_gradient(op, p)  # D^T p
    g = jnp.where(op.dirichlet_mask[:, None], 0.0, g) * inv_diag_F[:, None]
    return apply_divergence(op, g)
