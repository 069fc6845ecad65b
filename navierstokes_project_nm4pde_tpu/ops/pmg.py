"""p-multigrid (P2 -> P1) two-level preconditioner for the velocity block.

The velocity operator F = M/dt + nu A + C(w) is mass-dominated at practical
dt, but as the mesh refines the nu*A part makes plain Jacobi smoothing lose
its grip on the smooth (low-frequency) modes: the bench's velocity FGMRES
climbed from ~16 iterations at 609k DoF to ~22+ at 965k.  The classical
cure the reference applies is ILU (include/Preconditioners.hpp:92-98) --
serial triangular solves.  Here: a two-level p-coarsening,

    z  = omega D^-1 r                      (fine Jacobi smoothing)
    z += P Fc^-1 P^T (r - F z)             (P1 coarse correction)
    z += omega D^-1 (r - F z)              (post-smoothing)

where P is the natural P2-onto-P1 embedding (vertex values pass through,
edge-node values are endpoint means), so P^T is a 2-slots-per-edge
gather-sum and P is a pairwise gather -- no dense transfer operators.  The
coarse operator Fc = M1/dt_eff + nu A1 is the *assembled* P1 scalar
reaction-diffusion matrix (convection dropped: it perturbs the smooth
modes only mildly at practical dt), held as two static ELL value tables
combined per step for the exact (nu, dt_eff) -- assembly cost zero per
step.  The coarse space has ~6-7x fewer nodes (3D P2 -> P1), and the
coarse solve is a fixed-iteration Jacobi-CG on a [n_v, W]-ELL SpMV whose
gather traffic is ~25x smaller than one fine F-apply.

Dirichlet: constrained VERTEX rows/cols of Fc are eliminated (identity
row, zero coupling), the restricted residual is masked to zero there, and
the prolonged correction is masked on constrained fine nodes -- matching
the increment-form convention of the fine solve (models/base.py).
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
class VelocityPMG:
    """Static P2->P1 two-level structure (built once per mesh)."""

    cols: jax.Array  # [n_v, W] int32 coarse ELL columns (pad: own row)
    m_vals: jax.Array  # [n_v, W] P1 mass values (Dirichlet-eliminated)
    a_vals: jax.Array  # [n_v, W] P1 stiffness values (Dirichlet-eliminated)
    diag_onehot: jax.Array  # [n_v, W] 1.0 exactly at the diagonal slot
    # (padding slots also carry the own-row column id, so a cols==row mask
    # would hit them too -- the one-hot disambiguates)
    dir_v: jax.Array  # [n_v] bool Dirichlet vertex mask
    edges: jax.Array  # [n_e, 2] int32 endpoint vertices of each edge node
    plan_r: GatherPlan  # P^T: reduces n_v + 2*n_e slots -> n_v rows
    n_v: int = dataclasses.field(metadata=dict(static=True))


def build_velocity_pmg(space, geom, dirichlet_mask, dtype=jnp.float32):
    """Host-assemble the P1 coarse operator and transfer structures.

    `dirichlet_mask` is the fine [n_unodes] mask; its first n_v entries are
    the vertex constraints (P2 node ordering contract: vertices first)."""
    mesh = space.mesh
    dim = mesh.dim
    cells = np.asarray(mesh.cells, dtype=np.int64)  # [E, dim+1]
    coords = np.asarray(mesh.coords)
    n_v = mesh.n_vertices

    # --- element matrices -------------------------------------------------
    v = coords[cells]  # [E, dim+1, dim]
    J = np.swapaxes(v[:, 1:] - v[:, :1], 1, 2)  # [E, dim, dim]
    detJ = np.abs(np.linalg.det(J))
    Jinv = np.linalg.inv(J)
    gref1 = np.concatenate([-np.ones((1, dim)), np.eye(dim)], axis=0)
    g = np.einsum("ik,ekd->eid", gref1, Jinv)  # [E, dim+1, dim]
    A_e = np.einsum("eid,ejd->eij", g, g) * detJ[:, None, None]
    # P1 mass on the reference simplex: detJ * (1 + delta_ij) / c
    nl = dim + 1
    Mref = (np.ones((nl, nl)) + np.eye(nl))
    Mref *= {2: 1.0 / 24.0, 3: 1.0 / 120.0}[dim]
    M_e = Mref[None] * detJ[:, None, None]

    # --- Dirichlet elimination (rows and columns) -------------------------
    dir_v = np.asarray(dirichlet_mask)[:n_v]
    dmask_e = dir_v[cells]  # [E, nl]
    keep = ~(dmask_e[:, :, None] | dmask_e[:, None, :])
    A_e = np.where(keep, A_e, 0.0)
    M_e = np.where(keep, M_e, 0.0)

    # --- assemble to ELL (sort/unique over (row, col) keys) ---------------
    rows = np.repeat(cells, nl, axis=1).reshape(-1)
    colsf = np.tile(cells, (1, nl)).reshape(-1)
    a_flat = A_e.reshape(-1)
    m_flat = M_e.reshape(-1)
    key = rows * np.int64(n_v) + colsf
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq, start = np.unique(key_s, return_index=True)
    a_red = np.add.reduceat(a_flat[order], start)
    m_red = np.add.reduceat(m_flat[order], start)
    urow = (uniq // n_v).astype(np.int64)
    ucol = (uniq % n_v).astype(np.int64)
    # drop eliminated zero couplings (keep diagonals so every row exists)
    keep_nz = (np.abs(a_red) + np.abs(m_red) > 0) | (urow == ucol)
    urow, ucol = urow[keep_nz], ucol[keep_nz]
    a_red, m_red = a_red[keep_nz], m_red[keep_nz]
    counts = np.bincount(urow, minlength=n_v)
    W = int(counts.max())
    slot = np.arange(len(urow)) - np.concatenate(
        [[0], np.cumsum(counts)[:-1]]
    )[urow]
    cols = np.tile(np.arange(n_v, dtype=np.int64)[:, None], (1, W))
    a_tab = np.zeros((n_v, W))
    m_tab = np.zeros((n_v, W))
    donehot = np.zeros((n_v, W))
    cols[urow, slot] = ucol
    a_tab[urow, slot] = a_red
    m_tab[urow, slot] = m_red
    dsel = urow == ucol
    donehot[urow[dsel], slot[dsel]] = 1.0

    # --- P^T gather plan: slots = [vertex self | edge end0 | edge end1] ---
    edges = np.asarray(space.edges, dtype=np.int64)
    slots = np.concatenate([np.arange(n_v), edges[:, 0], edges[:, 1]])
    plan_r = build_gather_plan_grouped(slots[:, None], n_v)

    return VelocityPMG(
        cols=jnp.asarray(cols, jnp.int32),
        m_vals=jnp.asarray(m_tab, dtype),
        a_vals=jnp.asarray(a_tab, dtype),
        diag_onehot=jnp.asarray(donehot, dtype),
        dir_v=jnp.asarray(dir_v),
        edges=jnp.asarray(edges, jnp.int32),
        plan_r=plan_r,
        n_v=n_v,
    )


def pmg_vals(pmg: VelocityPMG, nu, dt):
    """Per-step coarse ELL values Fc = M1/dt + nu A1 (identity Dirichlet
    rows) and the inverse diagonal. Cost: one fused elementwise pass."""
    vals = pmg.m_vals / dt + nu * pmg.a_vals
    vals = jnp.where(pmg.dir_v[:, None], pmg.diag_onehot, vals)
    diag = jnp.sum(pmg.diag_onehot * vals, axis=1)
    return vals, 1.0 / diag


def pmg_matvec(pmg: VelocityPMG, vals: jax.Array, x: jax.Array) -> jax.Array:
    """Coarse SpMV, payload [n_v, d]."""
    return jnp.einsum("vw,vwd->vd", vals, x[pmg.cols])


def restrict_p(pmg: VelocityPMG, r: jax.Array) -> jax.Array:
    """P^T r: [n_unodes, d] -> [n_v, d] (edge residuals split to endpoints)."""
    n_v = pmg.n_v
    flat = jnp.concatenate(
        [r[:n_v], 0.5 * r[n_v:], 0.5 * r[n_v:]], axis=0
    )
    rc = apply_gather_plan(pmg.plan_r, flat)
    return jnp.where(pmg.dir_v[:, None], 0.0, rc)


def prolong_p(pmg: VelocityPMG, zc: jax.Array, n_unodes: int) -> jax.Array:
    """P zc: [n_v, d] -> [n_unodes, d] (edge values = endpoint means)."""
    ze = 0.5 * (zc[pmg.edges[:, 0]] + zc[pmg.edges[:, 1]])
    return jnp.concatenate([zc, ze], axis=0)


def pmg_coarse_solve(pmg, vals, inv_diag, rc, iters: int, precise=False):
    """Fixed-iteration Jacobi-CG on the coarse operator, payload [n_v, d]."""
    from navierstokes_project_nm4pde_tpu.solvers.krylov import cg_fixed

    d = rc.shape[1]
    n = rc.shape[0]

    def A(v):
        return pmg_matvec(pmg, vals, v.reshape(n, d)).reshape(-1)

    def M(v):
        return (inv_diag[:, None] * v.reshape(n, d)).reshape(-1)

    z = cg_fixed(A, rc.reshape(-1), M, iters=iters, precise=precise)
    return z.reshape(n, d)
