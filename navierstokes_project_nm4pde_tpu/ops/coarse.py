"""Two-level (coarse-grid corrected) preconditioner for the Schur block.

The pressure Schur complement is Laplacian-like: one-level smoothers
(Jacobi, SPAI) lose effectiveness as the mesh refines, and every CG
iteration costs ~15 device ops.  A classic two-level method cuts the
iteration count:

    z = omega D^-1 r                              (fine smoothing)
    z += R^T Sc^-1 R (r - S z)                    (coarse correction)

with aggregates of G consecutive pressure nodes.  Because nodes are
Morton/first-touch ordered (mesh.reorder_spatial), consecutive index
ranges are spatially compact, so R is a *reshape+sum* and R^T a *repeat*
-- no gathers at all.  The coarse matrix Sc = R S R^T is reduced from the
per-step ELL values through a static gather plan and Cholesky-factorised
densely on device (nc ~ n_p/G is tiny).  Sc inherits S~'s constant
null space and is Tikhonov-shifted.

Capability-wise this upgrades the reference's ILU-preconditioned inner CG
(ref: include/Preconditioners.hpp:92-98) to a mesh-independent method.
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
class CoarseSchur:
    # None when built with with_plan=False (frozen projection Schur: the
    # coarse matrix is assembled once host-side; per-step only restrict/
    # prolong -- pure reshapes -- and the cached factor are used).
    plan: GatherPlan | None  # reduces flat S~ values into the dense nc x nc
    nc: int = dataclasses.field(metadata=dict(static=True))
    agg: int = dataclasses.field(metadata=dict(static=True))  # aggregate size
    n_pad: int = dataclasses.field(metadata=dict(static=True))


def build_coarse_schur(schur, agg: int = 24, with_plan: bool = True) -> CoarseSchur:
    """Static aggregation structure over the S~ ELL layout."""
    n_p = schur.n_rows
    nc = (n_p + agg - 1) // agg
    if not with_plan:
        return CoarseSchur(plan=None, nc=nc, agg=agg, n_pad=nc * agg)
    from navierstokes_project_nm4pde_tpu.ops.spai import _slot_layout

    srow, scol, smask = _slot_layout(schur)
    a = srow // agg
    b = scol // agg
    flat = np.where(smask, a * nc + b, nc * nc)  # masked slots -> drop row
    # rows = nc^2 dense entries; the grouped plan keeps empty rows cheap and
    # drops the masked slots outright
    plan = build_gather_plan_grouped(
        flat[:, None], nc * nc, thresholds=(1, 4, 16, 64), drop_row=nc * nc
    )
    return CoarseSchur(plan=plan, nc=nc, agg=agg, n_pad=nc * agg)


def host_coarse_dense(
    host: dict, vals_flat: np.ndarray, nc: int, agg: int
) -> np.ndarray:
    """Numpy mirror of `coarse_dense` over the schur_ell host slot layout
    (one-time frozen-Schur setup)."""
    keep = host["smask"]
    a = host["srow"][keep] // agg
    b = host["scol"][keep] // agg
    Sc = np.zeros((nc, nc))
    np.add.at(Sc, (a, b), vals_flat[keep])
    Sc = 0.5 * (Sc + Sc.T)
    shift = 1e-6 * np.trace(Sc) / nc
    return Sc + shift * np.eye(nc)


def coarse_dense(cs: CoarseSchur, vals_flat: jax.Array) -> jax.Array:
    """Dense coarse matrix Sc = R S~ R^T from S~'s flat ELL values,
    symmetrised and Tikhonov-shifted for the constant null space."""
    sc = apply_gather_plan(cs.plan, vals_flat[:, None])[:, 0]
    Sc = sc.reshape(cs.nc, cs.nc)
    Sc = 0.5 * (Sc + Sc.T)
    shift = 1e-6 * jnp.trace(Sc) / cs.nc
    return Sc + shift * jnp.eye(cs.nc, dtype=Sc.dtype)


def coarse_factor(cs: CoarseSchur, vals_flat: jax.Array):
    """Per-step dense coarse matrix + Cholesky factor from S~'s flat values."""
    return jax.scipy.linalg.cho_factor(coarse_dense(cs, vals_flat), lower=True)


def coarse_inverse(cs: CoarseSchur, vals_flat: jax.Array) -> jax.Array:
    """Explicit dense inverse of the coarse matrix (one-time setup for the
    frozen projection Schur operator): each application becomes a single
    [nc, nc] matmul instead of two sequential triangular solves,
    so large coarse spaces (small aggregates) stay cheap per iteration."""
    cho = jax.scipy.linalg.cho_factor(coarse_dense(cs, vals_flat), lower=True)
    eye = jnp.eye(cs.nc, dtype=vals_flat.dtype)
    return jax.scipy.linalg.cho_solve(cho, eye)


def restrict(cs: CoarseSchur, r: jax.Array) -> jax.Array:
    pad = cs.n_pad - r.shape[0]
    rp = jnp.concatenate([r, jnp.zeros(pad, r.dtype)]) if pad else r
    return rp.reshape(cs.nc, cs.agg).sum(axis=1)


def prolong(cs: CoarseSchur, rc: jax.Array, n_p: int) -> jax.Array:
    return jnp.repeat(rc, cs.agg)[:n_p]


def twolevel_apply_g(cs: CoarseSchur, solve_c, S, inv_diag, r, omega=0.7,
                     post=True):
    """Multiplicative two-level application z ~ S^-1 r with a generic
    coarse solve `solve_c(rc) -> zc`.

    With post=True this is the symmetric V(1,1) (smooth, coarse, smooth)
    -- SPD, safe as a CG preconditioner; post=False drops the symmetry
    (only usable inside nonsymmetric outer solvers)."""
    z = omega * inv_diag * r
    r2 = r - S(z)
    zc = solve_c(restrict(cs, r2))
    z = z + prolong(cs, zc, r.shape[0])
    if post:
        z = z + omega * inv_diag * (r - S(z))
    return z


def twolevel_apply_additive_g(cs: CoarseSchur, solve_c, inv_diag, r,
                              omega=0.7):
    """ADDITIVE two-level application z = omega D^-1 r + R^T Sc^-1 R r.

    Symmetric (CG-safe) like the V(1,1) form but with ZERO S SpMVs per
    application -- every Schur CG iteration otherwise pays three SpMVs
    (the CG matvec + the V-cycle's two residuals)."""
    zc = solve_c(restrict(cs, r))
    return omega * inv_diag * r + prolong(cs, zc, r.shape[0])


def cho_solve_c(cho):
    """Coarse solve from a dense Cholesky factor (two triangular solves)."""
    return lambda rc: jax.scipy.linalg.cho_solve(cho, rc)


def inv_solve_c(Sc_inv):
    """Coarse solve from a precomputed dense inverse: one [nc, nc] matvec
    -- per-application cost independent of the factor structure,
    which makes much smaller aggregates (stronger coarse spaces) affordable
    when the operator is frozen (projection mode)."""
    return lambda rc: Sc_inv @ rc


def twolevel_apply(cs: CoarseSchur, cho, S, inv_diag, r, omega=0.7, post=True):
    return twolevel_apply_g(cs, cho_solve_c(cho), S, inv_diag, r, omega, post)


def twolevel_apply_additive(cs: CoarseSchur, cho, inv_diag, r, omega=0.7):
    return twolevel_apply_additive_g(cs, cho_solve_c(cho), inv_diag, r, omega)
