"""Block preconditioners for the saddle-point system (SIMPLE/Yosida family).

Same block algebra as the reference's preconditioner library
(ref: include/Preconditioners.hpp:7-534), re-derived from the block-LU
factorisation and rebuilt for batched device execution:

With K = [[F, G], [D, 0]], G = -D^T, the exact factorisation is
K = [[F, 0], [D, S]] [[I, F^-1 G], [0, I]] with S = D F^-1 D^T.  Each member
replaces F^-1 by something cheaper in S and/or in the correction step:

  kind              S~ uses            correction step      inner solves
  ----------------- ------------------ -------------------- --------------------
  identity          --                 --                   none
  block_identity    --                 --                   none
  block_triangular  pressure mass Mp/nu (Cahouet-Chabard-   CG on nu*A, CG on Mp
                    style; ref :41-105) free)
  simple            D diag(F)^-1 D^T   D^-1_hat correction  GMRES(F), CG(S~)
  asimple           D diag(F)^-1 D^T   same, alpha=1        GMRES(F), CG(S~)
  yosida            D (dt/diag M) D^T  extra F solve        2x GMRES(F), CG(S~)
  ayosida           D (dt/lump M) D^T  diagonal F-hat       CG(S~) only

The reference's inner ILU-preconditioned solves to rel. 1e-2
(ref: include/Preconditioners.hpp:260-261,271-273) become Jacobi-
preconditioned *fixed-iteration* GMRES/CG: ILU's sequential triangular
sweeps are sequential, while short Jacobi-Krylov iterations are
pure gather/einsum kernels and keep everything inside one XLA program.
The preconditioners are nonstationary either way, which is why the outer
solver is *flexible* GMRES.

Dirichlet handling: F has identity rows on constrained velocity DoFs
(row-elimination as in the reference, ref: src/NavierStokes2D.cpp:354);
S~ masks constrained velocity columns, matching the exact Schur complement
of the row-eliminated system.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from navierstokes_project_nm4pde_tpu.config import PrecondConfig
from navierstokes_project_nm4pde_tpu.ops import operators as ops
from navierstokes_project_nm4pde_tpu.ops.coarse import coarse_factor, twolevel_apply
from navierstokes_project_nm4pde_tpu.ops.schur_ell import (
    assemble_schur_values,
    schur_ell_diag,
    schur_ell_matvec,
)
from navierstokes_project_nm4pde_tpu.solvers.krylov import cg_fixed, gmres_fixed
from navierstokes_project_nm4pde_tpu.solvers.smoothers import (
    chebyshev_fixed,
    power_lambda_max,
    richardson_fixed,
)

PRECOND_KINDS = (
    "identity",
    "block_identity",
    "block_triangular",
    "simple",
    "asimple",
    "yosida",
    "ayosida",
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PrecondState:
    """Per-time-step preconditioner data (rebuilt each step, mirroring the
    reference's per-step `initialize`; ref: src/NavierStokes2D.cpp:540-619)."""

    diag_Fhat: jax.Array  # [n_unodes] diag of F with 1.0 on constrained rows
    inv_diag_Fhat: jax.Array  # [n_unodes]
    inv_diag_free: jax.Array  # [n_unodes] 1/diagF on free nodes, 0 on constrained
    schur_inv: jax.Array  # [n_unodes] the weight inside S~ (kind-dependent)
    schur_vals: jax.Array  # [n_pnodes, W] per-step assembled S~ ELL values
    schur_diag: jax.Array  # [n_pnodes] diag(S~) for Jacobi-CG
    schur_lam_max: jax.Array  # estimated lam_max of Jacobi-scaled S~ (Chebyshev)
    schur_cho_L: jax.Array | None  # dense coarse Cholesky factor (two-level)
    f_lam_max: jax.Array  # estimated lam_max of Jacobi-scaled F (Richardson)
    conv: ops.ConvectionData | None


def build_precond_state(
    op: ops.NSOperator,
    nu,
    dt,
    conv: ops.ConvectionData | None,
    kind: str,
    s_solver: str = "cg",
    f_solver: str = "gmres",
    f_lam: jax.Array | None = None,
    skip_schur: bool = False,
) -> PrecondState:
    """`skip_schur=True` skips the per-step S~ ELL assembly and coarse
    factorisation (the projection stepper's frozen-Schur path provides
    those once at setup; models/base.py) -- only the velocity-block
    diagonals and `schur_inv` (needed by the velocity update) are built."""
    mask = op.dirichlet_mask
    dF = ops.diag_F(op, nu, dt, conv)
    diag_Fhat = jnp.where(mask, 1.0, dF)
    inv_diag_Fhat = 1.0 / diag_Fhat
    inv_diag_free = jnp.where(mask, 0.0, 1.0 / dF)

    if kind in ("yosida",):
        # S~ from the mass block: dt * diag(M)^-1 (ref: Preconditioners.hpp:350-358)
        schur_inv = jnp.where(mask, 0.0, dt / op.diagM)
    elif kind in ("ayosida",):
        # lumped mass (abs row sums; ref: Preconditioners.hpp:456-468)
        schur_inv = jnp.where(mask, 0.0, dt / op.lumpM)
    else:
        # SIMPLE family: diag(F)^-1 (ref: Preconditioners.hpp:135-144)
        schur_inv = inv_diag_free

    if skip_schur:
        one = jnp.ones((), schur_inv.dtype)
        schur_vals = None
        schur_diag = one
        lam_max = 2.0 * one
        cho_L = None
        f_lam = _f_lam_bound(
            op, nu, dt, conv, f_solver, f_lam, inv_diag_Fhat, mask, one.dtype
        )
        return PrecondState(
            diag_Fhat=diag_Fhat,
            inv_diag_Fhat=inv_diag_Fhat,
            inv_diag_free=inv_diag_free,
            schur_inv=schur_inv,
            schur_vals=schur_vals,
            schur_diag=schur_diag,
            schur_lam_max=lam_max,
            schur_cho_L=cho_L,
            f_lam_max=f_lam,
            conv=conv,
        )

    # Assemble S~ explicitly in its small pressure-space ELL pattern
    # (the reference's per-step mmult; ref: Preconditioners.hpp:144,248).
    schur_vals = assemble_schur_values(op.schur, schur_inv)
    schur_diag = schur_ell_diag(op.schur, schur_vals)
    # Guard empty rows (should not happen: every pressure node touches cells)
    schur_diag = jnp.where(schur_diag > 0, schur_diag, 1.0)
    if s_solver == "chebyshev":
        inv_d = 1.0 / schur_diag
        v0 = jnp.sin(jnp.arange(op.n_pnodes, dtype=schur_diag.dtype))
        lam_max = power_lambda_max(
            lambda p: schur_ell_matvec(op.schur, schur_vals, p),
            lambda p: inv_d * p,
            v0,
            iters=8,
        )
    else:
        lam_max = jnp.asarray(2.0, schur_diag.dtype)

    if s_solver.startswith("mg2"):
        cho_L = coarse_factor(op.coarse, schur_vals)[0]
    else:
        cho_L = None

    f_lam = _f_lam_bound(
        op, nu, dt, conv, f_solver, f_lam, inv_diag_Fhat, mask,
        schur_diag.dtype,
    )
    return PrecondState(
        diag_Fhat=diag_Fhat,
        inv_diag_Fhat=inv_diag_Fhat,
        inv_diag_free=inv_diag_free,
        schur_inv=schur_inv,
        schur_vals=schur_vals,
        schur_diag=schur_diag,
        schur_lam_max=lam_max,
        schur_cho_L=cho_L,
        f_lam_max=f_lam,
        conv=conv,
    )


def _f_lam_bound(op, nu, dt, conv, f_solver, f_lam, inv_diag_Fhat, mask, dtype):
    """Spectral bound lam_max(diag(F)^-1 F) for the damped smoothers.

    With a setup-time `f_lam` (power iteration on the convection-free F at
    the warm-step dt_eff; NavierStokesSolver._setup) the per-step cost is a
    margin plus a Gershgorin-style bump for the convection perturbation:
    |lam(D^-1(F0+C)) - lam(D^-1 F0)| is not bounded by the diagonal of C
    alone, but max|diagC|/diagF tracks the perturbation scale and the
    smoothers only need a safe upper bound (under-damping stalls; modest
    over-damping costs a few percent)."""
    if f_lam is not None:
        f_lam = 1.1 * f_lam
        if conv is not None and conv.diagC is not None:
            bump = jnp.max(jnp.abs(conv.diagC) * inv_diag_Fhat)
            f_lam = f_lam + 2.0 * bump
        return f_lam
    if f_solver in ("richardson", "chebyshev", "pmg"):
        # lam_max of diag(F)^-1 F: the P2 mass block alone already exceeds 2
        # (P2 mass matrices are not diagonally dominant), so a fixed damping
        # diverges -- estimate per step and damp by 1/lam_max.
        n, d = op.n_unodes, op.dim

        def Fj(v):
            u = v.reshape(n, d)
            y = ops.apply_F(op, nu, dt, conv, u)
            y = jnp.where(mask[:, None], u, y)
            return y.reshape(-1)

        minv = inv_diag_Fhat[:, None].repeat(d, axis=1).reshape(-1)
        v0 = jnp.sin(jnp.arange(n * d, dtype=dtype))
        return power_lambda_max(Fj, lambda v: minv * v, v0, iters=6)
    return jnp.asarray(2.0, dtype)


# ----------------------------------------------------------------------
# Inner solves
# ----------------------------------------------------------------------
def _solve_F(op, st: PrecondState, nu, dt, rhs_u, cfg: PrecondConfig, iters=None):
    """Approximately solve F_hat z = rhs, flat over [n, dim].

    f_solver="gmres": Jacobi-preconditioned fixed-iteration GMRES (robust).
    f_solver="richardson": dot-free damped Jacobi (F is mass-dominated at
    practical dt, so the Jacobi-scaled spectrum clusters near 1).
    With cfg.low_precision the operator input is cast to bfloat16 -- the
    gathers that dominate the apply cost move half the bytes."""
    n, d = rhs_u.shape
    mask = op.dirichlet_mask
    dtype = rhs_u.dtype
    cast = jnp.bfloat16 if cfg.low_precision else None

    def Aflat(v):
        u = v.reshape(n, d)
        if cast is not None:
            u = u.astype(cast)
        y = ops.apply_F(op, nu, dt, st.conv, u).astype(dtype)
        y = jnp.where(mask[:, None], v.reshape(n, d), y)
        return y.reshape(-1)

    Minv = st.inv_diag_Fhat[:, None].repeat(d, axis=1).reshape(-1)
    it = iters if iters is not None else cfg.f_iters
    if cfg.f_solver == "richardson":
        omega = (cfg.omega / (0.5 * (1.0 + st.f_lam_max))).astype(dtype)
        z = richardson_fixed(
            Aflat, rhs_u.reshape(-1), lambda v: Minv * v,
            iters=it, omega=omega,
        )
    elif cfg.f_solver == "chebyshev":
        # At practical dt the Jacobi-scaled F is mass-dominated: nearly SPD
        # with a tight spectrum, so Chebyshev (no dots, ~2/3 the ops of the
        # inner GMRES) matches its smoothing quality.
        lam_max = 1.05 * st.f_lam_max
        z = chebyshev_fixed(
            Aflat, rhs_u.reshape(-1), lambda v: Minv * v, iters=it,
            lam_min=lam_max / 8.0, lam_max=lam_max,
        )
    elif cfg.f_solver == "pmg":
        # ADDITIVE two-level P2->P1 correction (ops/pmg.py): damped Jacobi
        # plus a prolonged coarse solve of the SAME residual,
        #   z = omega D^-1 r + P Fc^-1 P^T r.
        # Zero fine F-applies per call (the multiplicative variant's
        # pre/post-smoothing residuals cost 2 applies/call and lost
        # end-to-end despite fewer outer iterations at 609k DoF, before the
        # H100 port); the coarse Jacobi-CG iterates on an
        # [n_v, W] ELL SpMV ~25x smaller than one fine apply.
        from navierstokes_project_nm4pde_tpu.ops.pmg import (
            pmg_coarse_solve,
            pmg_vals,
            prolong_p,
            restrict_p,
        )

        omega = (cfg.omega / (0.5 * (1.0 + st.f_lam_max))).astype(dtype)
        cvals, inv_dc = pmg_vals(op.pmg, nu, dt)
        b = rhs_u.reshape(-1)
        zc = pmg_coarse_solve(
            op.pmg, cvals, inv_dc, restrict_p(op.pmg, rhs_u), iters=it
        )
        dz = prolong_p(op.pmg, zc, n)
        z = omega * Minv * b + jnp.where(
            mask[:, None], 0.0, dz
        ).reshape(-1)
    else:
        z = gmres_fixed(
            Aflat, rhs_u.reshape(-1), lambda v: Minv * v, iters=it
        )
    return z.reshape(n, d)


def _solve_S(op, st: PrecondState, rhs_p, cfg: PrecondConfig):
    """Approximately solve S~ z = rhs on the assembled pressure-space ELL
    form -- each iteration is one tiny [n_p, W] SpMV.  s_solver="chebyshev"
    avoids CG's per-iteration dot products using the per-step power-iteration
    estimate of lam_max."""

    if cfg.low_precision:
        # bf16 ELL values + iterate for the gather-heavy SpMV; f32 accumulate.
        from navierstokes_project_nm4pde_tpu.ops.schur_ell import (
            masked_bf16_vals,
            schur_ell_matvec_bf16,
        )

        vals16 = masked_bf16_vals(op.schur, st.schur_vals)

        def S(p):
            return schur_ell_matvec_bf16(op.schur, vals16, p, rhs_p.dtype)

    else:

        def S(p):
            return schur_ell_matvec(op.schur, st.schur_vals, p)

    if cfg.s_solver in ("mg2", "mg2_cg"):
        # Two-level (Jacobi + dense coarse Cholesky) application -- ~20 ops,
        # mesh-independent quality (see ops/coarse.py).
        inv_d = 1.0 / st.schur_diag

        def M2(v):
            return twolevel_apply(
                op.coarse, (st.schur_cho_L, True), S, inv_d, v
            )

        if cfg.s_solver == "mg2":
            return M2(rhs_p)
        return cg_fixed(S, rhs_p, M2, iters=cfg.s_iters)

    if cfg.s_solver in ("spai", "spai_cg"):
        # One (or CG-accelerated) application of the frozen sparse
        # approximate inverse -- minimal op count (see ops/spai.py).
        def Mspai(v):
            return schur_ell_matvec(op.schur, op.spai_vals, v)

        if cfg.s_solver == "spai":
            return Mspai(rhs_p)
        return cg_fixed(S, rhs_p, Mspai, iters=cfg.s_iters)

    Minv = 1.0 / st.schur_diag
    if cfg.s_solver == "chebyshev":
        lam_max = 1.05 * st.schur_lam_max
        return chebyshev_fixed(
            S, rhs_p, lambda v: Minv * v, iters=cfg.s_iters,
            lam_min=lam_max / 30.0, lam_max=lam_max,
        )
    return cg_fixed(S, rhs_p, lambda v: Minv * v, iters=cfg.s_iters)


def _dt_apply(op, p):
    """D^T p in the velocity space (= -G p)."""
    return -ops.apply_gradient(op, p)


# ----------------------------------------------------------------------
# Application
# ----------------------------------------------------------------------
def apply_precond(
    kind: str,
    cfg: PrecondConfig,
    op: ops.NSOperator,
    st: PrecondState,
    nu,
    dt,
    v_u: jax.Array,
    v_p: jax.Array,
):
    """z = P^-1 v for the selected preconditioner kind (static)."""
    if kind == "identity" or kind == "block_identity":
        # ref: Preconditioners.hpp:7-37
        return v_u, v_p

    if kind == "block_triangular":
        # ref: Preconditioners.hpp:41-105 -- block-triangular: velocity solve,
        # then pressure-mass solve of (v_p - D z_u).  The reference solves the
        # *stiffness* block (its class targets steady Stokes and is unused in
        # the NS solve switch, ref: src/NavierStokes2D.cpp:547-619); for the
        # unsteady system we solve the full F block -- with dt -> 0 a pure
        # stiffness solve stops preconditioning M/dt and the outer solver
        # stalls.  The pressure block stays the nu-scaled pressure mass
        # (Cahouet-Chabard-style), ref: src/NavierStokes2D.cpp:265.
        z_u = _solve_F(op, st, nu, dt, v_u, cfg)
        rhs_p = v_p - ops.apply_divergence(op, z_u)

        def Mp(p):
            return ops.apply_pressure_mass(op, p) / nu

        MinvP = nu / op.diagMp
        z_p = cg_fixed(Mp, rhs_p, lambda v: MinvP * v, iters=cfg.s_iters)
        return z_u, z_p

    if kind in ("simple", "asimple"):
        # ref: Preconditioners.hpp:118-217 (SIMPLE), :220-329 (aSIMPLE)
        alpha = cfg.alpha
        y_u = _solve_F(op, st, nu, dt, v_u, cfg)
        rhs_p = v_p - ops.apply_divergence(op, y_u)
        y_p = _solve_S(op, st, rhs_p, cfg)
        z_p = y_p / alpha
        corr = st.inv_diag_free[:, None] * _dt_apply(op, z_p)
        z_u = y_u + corr
        return z_u, z_p

    if kind == "yosida":
        # ref: Preconditioners.hpp:332-423 -- L-solve with S~ from dt*M^-1,
        # then a second F solve for the velocity correction.
        y_u = _solve_F(op, st, nu, dt, v_u, cfg)
        rhs_p = v_p - ops.apply_divergence(op, y_u)
        y_p = _solve_S(op, st, rhs_p, cfg)
        z_p = y_p
        rhs_corr = _dt_apply(op, z_p)
        rhs_corr = jnp.where(op.dirichlet_mask[:, None], 0.0, rhs_corr)
        corr = _solve_F(
            op, st, nu, dt, rhs_corr, cfg,
            iters=cfg.f_corr_iters or None,
        )
        z_u = y_u + corr
        return z_u, z_p

    if kind == "ayosida":
        # ref: Preconditioners.hpp:427-534 -- all F solves replaced by
        # diagonal scalings, one real CG on the lumped-mass Schur block.
        # (The reference's step order is reworked into the consistent
        # block-LU form; its original Step-4/5 sequence is documented as
        # anomalous -- SURVEY.md section 7 quirks.)
        y_u = st.inv_diag_Fhat[:, None] * v_u
        rhs_p = v_p - ops.apply_divergence(op, y_u)
        y_p = _solve_S(op, st, rhs_p, cfg)
        z_p = y_p
        corr = st.inv_diag_free[:, None] * _dt_apply(op, z_p)
        z_u = y_u + corr
        return z_u, z_p

    raise ValueError(f"unknown preconditioner kind: {kind}")
