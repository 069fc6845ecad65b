"""Pure-JAX Krylov solvers: flexible GMRES, CG, and fixed-iteration variants.

Pure-JAX replacement for the reference's Trilinos `SolverGMRES`/`SolverCG`
(ref: src/NavierStokes2D.cpp:538-559, include/Preconditioners.hpp:66,159,180):

  * `fgmres`     -- right-preconditioned *flexible* GMRES under
                    `lax.while_loop` with Givens-rotation residual tracking.
    Flexibility matters: the block preconditioners contain inner iterative
    solves, so the preconditioner is nonstationary; plain GMRES (what the
    reference uses) silently relies on loose inner tolerances, FGMRES is the
    robust formulation and stores one extra basis (Z).
  * `cg`         -- preconditioned CG with relative-tolerance while_loop.
  * `cg_fixed` / `gmres_fixed` -- fixed-iteration inner solvers for the
    block preconditioners: no convergence checks (fewer scalar reductions,
    fully compilable, vmap/ensemble friendly), playing the role of the
    reference's inner solves-to-1e-2 (ref: include/Preconditioners.hpp:260).

All solvers act on flat 1-D vectors; callers wrap block states.
Dot products optionally accumulate in float64 (`precise=True`): the
arrays stay f32 (bandwidth) while the reductions keep Krylov recurrences
accurate enough for 1e-6 relative residuals.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


def _psum(v, axis_name):
    """Cross-device sum when running inside shard_map (the owned+halo
    path, parallel/halo_step.py): every vector is a device-local block,
    so Krylov reductions must all-reduce.  No-op (None) outside."""
    return v if axis_name is None else jax.lax.psum(v, axis_name)


def _matvec_dots(V, w, precise: bool, axis_name=None):
    """Row-wise dot products V @ w as one matmul (optionally f64-accumulated)."""
    if precise:
        h = V.astype(jnp.float64) @ w.astype(jnp.float64)
        return _psum(h, axis_name).astype(w.dtype)
    return _psum(V @ w, axis_name)


def _dot(x, y, precise: bool, axis_name=None):
    if precise:
        s = jnp.sum(x.astype(jnp.float64) * y.astype(jnp.float64))
        return _psum(s, axis_name).astype(x.dtype)
    return _psum(jnp.sum(x * y), axis_name)


def _norm(x, precise: bool, axis_name=None):
    return jnp.sqrt(_dot(x, x, precise, axis_name))


def _dot2(x, y, precise: bool, axis_name=None):
    """(x.y, y.y) in ONE fused device reduction.

    Stacking the two dot products into a [2, n] @ [n] matvec halves the
    fixed per-op launch cost; the CG loop needs r.z and r.r at the same
    point every iteration."""
    if precise:
        xs = jnp.stack([x, y]).astype(jnp.float64) @ y.astype(jnp.float64)
        xs = _psum(xs, axis_name).astype(x.dtype)
    else:
        xs = _psum(jnp.stack([x, y]) @ y, axis_name)
    return xs[0], xs[1]


class SolveInfo(NamedTuple):
    iters: jax.Array  # total iterations performed
    residual: jax.Array  # final (preconditioned-system) residual norm


# ----------------------------------------------------------------------
# Flexible GMRES
# ----------------------------------------------------------------------
def fgmres(
    A: Callable,
    b: jax.Array,
    M: Callable | None = None,
    x0: jax.Array | None = None,
    *,
    rtol: float = 1e-6,
    atol: float = 0.0,
    restart: int = 50,
    maxiter: int = 200,
    precise: bool = True,
    tol_mode: str = "r0",
    aux: bool = False,
    axis_name: str | None = None,
    return_resid: bool = False,
):
    """Solve A x = b with right-preconditioned flexible GMRES.

    Returns (x, SolveInfo).  `M` maps a residual to a preconditioned
    correction; it may be nonstationary (inner iterative solves).

    tol_mode selects what `rtol` is relative to: "r0" = the initial
    residual ||b - A x0|| (the honest per-step convention for warm-started
    time stepping -- ||b|| is inflated by the M/dt history term and makes
    rtol behave like a loose absolute tolerance), "b" = ||b||, "abs" =
    absolute (the reference's SolverControl convention,
    ref: src/NavierStokes2D.cpp:535).

    aux=True: `A` returns (A z, f(z)) where f is any LINEAR function of its
    input (e.g. the element-DoF gather inside a matrix-free apply); the
    return becomes (x, SolveInfo, f(x)) with f(x) accumulated from the
    per-iteration values -- callers get f of the solution WITHOUT a second
    evaluation (the projection stepper reuses the Krylov applies' gathers
    for the divergence rhs; same exact-arithmetic value, fp summation order
    differs by the basis combination).
    """
    n = b.shape[0]
    dtype = b.dtype
    if M is None:
        M = lambda v: v  # noqa: E731

    if aux:
        A_full = A
    else:
        A_full = lambda z: (A(z), jnp.zeros((), dtype))  # noqa: E731
    aux_shape = jax.eval_shape(lambda z: A_full(z)[1], b)
    aux_zero = jnp.zeros(aux_shape.shape, aux_shape.dtype)

    # Zero initial guess => the initial residual IS b: skip the A(x0)
    # apply (warm-started time stepping solves in increment form with
    # x0 = 0, so this is the common path -- the operator apply is ~10x the
    # cost of everything else in an iteration).
    if x0 is None:
        x0 = jnp.zeros_like(b)
        r_init = b
        aux_init = aux_zero
    else:
        w0, aux_init = A_full(x0)
        r_init = b - w0

    r0_norm = _norm(r_init, precise, axis_name)
    if tol_mode == "r0":
        ref_norm = r0_norm
    elif tol_mode == "b":
        ref_norm = _norm(b, precise, axis_name)
    else:
        ref_norm = jnp.asarray(1.0, dtype)
    tol = jnp.maximum(rtol * ref_norm, atol).astype(dtype)

    m = restart

    def cycle(x, r):
        """One restart cycle from residual `r`; returns (x, next residual
        vector, residual norm, iters done, aux increment).  The next-cycle
        residual is reconstructed from the Arnoldi recurrence (exact in
        exact arithmetic: r_new = g[j] * V^T Q^T e_j) instead of an extra
        operator apply -- restarts are rare in warm-started solves and the
        stopping value |g[j]| is unchanged."""
        beta = _norm(r, precise, axis_name)

        V = jnp.zeros((m + 1, n), dtype)
        Z = jnp.zeros((m, n), dtype)
        Zaux = jnp.zeros((m,) + aux_zero.shape, aux_zero.dtype)
        H = jnp.zeros((m + 1, m), dtype)
        cs = jnp.zeros(m, dtype)
        sn = jnp.zeros(m, dtype)
        g = jnp.zeros(m + 1, dtype)
        g = g.at[0].set(beta)
        V = V.at[0].set(jnp.where(beta > 0, r / beta, r))

        def arnoldi_cond(carry):
            V, Z, Zaux, H, cs, sn, g, j, res = carry
            return (j < m) & (res > tol)

        def arnoldi_body(carry):
            V, Z, Zaux, H, cs, sn, g, j, res = carry
            z = M(V[j])
            w, a = A_full(z)
            Zaux = Zaux.at[j].set(a)
            # Batched classical Gram-Schmidt with reorthogonalisation (CGS2):
            # two matmuls against the whole basis instead of a sequential MGS
            # loop -- hundreds of tiny dot/axpy ops collapse into 4 large ones
            # (every device op has a fixed launch cost).  Rows > j of V are exactly
            # zero (fresh basis each cycle), so no masking is needed.
            hcol1 = _matvec_dots(V, w, precise, axis_name)
            w = w - V.T @ hcol1
            hcol2 = _matvec_dots(V, w, precise, axis_name)
            w = w - V.T @ hcol2
            hcol = hcol1 + hcol2
            hlast = _norm(w, precise, axis_name)
            hcol = hcol.at[j + 1].set(hlast)
            V = V.at[j + 1].set(jnp.where(hlast > 0, w / hlast, w))
            Z = Z.at[j].set(z)

            # Apply accumulated Givens rotations to the new column.
            def givens_body(i, hcol):
                t1 = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
                t2 = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
                new = hcol.at[i].set(t1).at[i + 1].set(t2)
                return jnp.where(i < j, new, hcol)

            hcol = jax.lax.fori_loop(0, m, givens_body, hcol)

            # New rotation to kill hcol[j+1].
            denom = jnp.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
            c = jnp.where(denom > 0, hcol[j] / denom, 1.0)
            s = jnp.where(denom > 0, hcol[j + 1] / denom, 0.0)
            cs = cs.at[j].set(c)
            sn = sn.at[j].set(s)
            hcol = hcol.at[j].set(denom).at[j + 1].set(0.0)
            H = H.at[:, j].set(hcol)
            g_j1 = -s * g[j]
            g = g.at[j + 1].set(g_j1).at[j].set(c * g[j])
            res = jnp.abs(g_j1)
            return V, Z, Zaux, H, cs, sn, g, j + 1, res

        V, Z, Zaux, H, cs, sn, g, j, res = jax.lax.while_loop(
            arnoldi_cond,
            arnoldi_body,
            (V, Z, Zaux, H, cs, sn, g, jnp.array(0, jnp.int32), beta),
        )

        # Solve the (masked) triangular system H[:j,:j] y = g[:j].
        jm = jnp.arange(m)
        active = jm < j
        Hm = jnp.where(active[None, :] & active[:, None], H[:m, :m], 0.0)
        Hm = Hm + jnp.where(active, 0.0, 1.0) * jnp.eye(m, dtype=dtype)
        gm = jnp.where(active, g[:m], 0.0)
        y = jax.scipy.linalg.solve_triangular(Hm, gm, lower=False)
        x = x + Z.T @ y
        # aux increment: f linear => f(Z^T y) = sum_j y_j f(z_j); inactive
        # y entries are exactly zero, so the padded rows contribute nothing.
        aux_inc = jnp.tensordot(y, Zaux, axes=(0, 0))

        # Next-cycle residual by recurrence: beta e1 - H_bar y = Q^T e_j
        # g[j] (the first j rotated entries vanish because y solves the
        # triangular system exactly), so r_new = g[j] * V^T (Q^T e_j).
        w = (jnp.arange(m + 1) == j).astype(dtype)
        def unrotate(i2, w):
            i = m - 1 - i2  # apply G_i^T in reverse order i = j-1 .. 0
            wi = cs[i] * w[i] - sn[i] * w[i + 1]
            wi1 = sn[i] * w[i] + cs[i] * w[i + 1]
            new = w.at[i].set(wi).at[i + 1].set(wi1)
            return jnp.where(i < j, new, w)
        w = jax.lax.fori_loop(0, m, unrotate, w)
        r_new = (g[j] * w) @ V
        return x, r_new, res, j, aux_inc

    def outer_cond(carry):
        x, r, res, iters, aux_x = carry
        return (res > tol) & (iters < maxiter)

    def outer_body(carry):
        x, r, res, iters, aux_x = carry
        x, r, res, j, aux_inc = cycle(x, r)
        return x, r, res, iters + j, aux_x + aux_inc

    x, r, res, iters, aux_x = jax.lax.while_loop(
        outer_cond,
        outer_body,
        (x0, r_init, r0_norm, jnp.array(0, jnp.int32), aux_init),
    )
    info = SolveInfo(iters=iters, residual=res)
    out = (x, info, aux_x) if aux else (x, info)
    if return_resid:
        # The final residual VECTOR, reconstructed from the Arnoldi
        # recurrence inside cycle() (exact in exact arithmetic, no extra
        # operator apply).  Lets callers harvest the solution's exact
        # image A x = b - r for recycled warm starts (ls_warmstart).
        out = out + (r,)
    return out


def ls_warmstart(D, Y, r0, precise: bool = True):
    """Least-squares warm start from recycled (direction, image) pairs.

    Given k prior directions D [k, n] and their operator images Y ~= A D
    [k, n], computes the combination c minimising ||r0 - Y^T c||
    (ridge-regularised normal equations -- consecutive time-step
    directions are near-collinear) and returns (x0 = D^T c,
    r0' = r0 - Y^T c).  Costs ZERO operator applies: four fixed-cost
    matmuls + a k x k solve.

    With slightly stale images (the velocity block drifts by the
    convection delta between steps), r0' still drives an HONEST solve:
    the caller solves A e = r0' exactly, so the stale-image error enters
    only as an O(||dA|| ||x0||) rhs perturbation (models/base.py
    quantifies it at ~1e-5 of the increment for the projection F).  A
    monotonicity guard rejects the projection wholesale when it fails to
    shrink the residual (heavily stale or degenerate pools, e.g. the
    all-zero initial pool), so the warm start can never hurt.
    """
    k = D.shape[0]
    G = _matvec_dots(Y, Y.T, precise)  # [k, k]
    rhs = _matvec_dots(Y, r0, precise)  # [k]
    ridge = 1e-8 * jnp.maximum(
        jnp.max(jnp.diagonal(G)), jnp.asarray(1e-30, G.dtype)
    )
    c = jnp.linalg.solve(G + ridge * jnp.eye(k, dtype=G.dtype), rhs)
    x0 = D.T @ c
    r_new = r0 - Y.T @ c
    ok = _norm(r_new, precise) < _norm(r0, precise)
    x0 = jnp.where(ok, x0, jnp.zeros_like(x0))
    r_new = jnp.where(ok, r_new, r0)
    return x0, r_new


# ----------------------------------------------------------------------
# Recycled-block GCR (wide-payload Krylov for payload-insensitive applies)
# ----------------------------------------------------------------------
def gcr_recycled(
    A_block: Callable,
    b: jax.Array,
    M: Callable,
    pool: jax.Array,
    *,
    rtol: float = 1e-6,
    atol: float = 0.0,
    tol_mode: str = "r0",
    max_narrow: int = 8,
    precise: bool = True,
):
    """Solve A x = b by least-squares over recycled + fresh directions.

    Exploits a property measured before the H100 port (not yet measured
    on the H100): the matrix-free apply was ROW-rate bound (gather +
    reduce), so applying A to a [n, K] block of vectors cost barely more
    than to one vector.  Round 1 therefore
    applies A to the whole block [M b, pool_0, ..] in ONE wide apply and
    takes the least-squares-optimal combination; subsequent narrow rounds
    add one fresh direction M r each (classic GCR, re-solving the small
    LS each round).  With a pool recycled from the previous TIME STEP of
    a warm-started solver, the wide round replaces most of the sequential
    FGMRES iterations (the operator drifts slowly between steps, so last
    step's preconditioned Krylov directions still span most of the new
    increment).

    Exactness: every direction is applied with the CURRENT operator and
    the residual is re-formed from the big vectors every round (no
    recurrence), so the converged x satisfies ||b - A x|| <= tol in true
    arithmetic -- unlike recycling schemes that project onto the
    *previous* operator's images.  The small LS solves are incremental
    against the exact residual (iterative-refinement structure), so plain
    f32 Gram solves suffice for 1e-6 relative targets.

    `A_block` maps [n, K] -> [n, K] (columns independent); `M` likewise.
    `pool` is [k, n] (zero rows are ignored via the norm guard).  Returns
    (x, SolveInfo, D) with D [1 + k + max_narrow, n] the direction rows
    actually used (callers harvest the fresh rows as next step's pool):
    row 0 = M b, rows 1..k = pool, rows k+1.. = narrow-round directions.
    SolveInfo.iters counts OPERATOR APPLY COLUMNS that a sequential solver
    would have paid (narrow rounds done + 1 for the fused wide round), so
    iteration telemetry stays comparable with fgmres.
    """
    n = b.shape[0]
    dtype = b.dtype
    k = pool.shape[0]
    K = 1 + k + max_narrow

    ref_norm = _norm(b, precise)
    if tol_mode == "abs":
        ref_norm = jnp.asarray(1.0, dtype)
    tol = jnp.maximum(rtol * ref_norm, atol).astype(dtype)

    # ---- round 1: one wide apply over [M b, pool] --------------------
    D = jnp.zeros((K, n), dtype)
    W = jnp.zeros((K, n), dtype)
    D0 = jnp.concatenate([M(b[:, None]).T, pool], axis=0)
    W0 = A_block(D0.T).T  # [1 + k, n]
    # Gram + projections in one matmul: [W0; b] [W0; b]^T.
    S0 = jnp.concatenate([W0, b[None, :]], axis=0)
    G0 = _matvec_dots(S0, S0.T, precise)  # [k+2, k+2]
    wnorm = jnp.sqrt(jnp.clip(jnp.diagonal(G0)[: 1 + k], 0.0, None))
    scale0 = jnp.where(wnorm > 0, 1.0 / wnorm, 0.0)
    D = D.at[: 1 + k].set(D0 * scale0[:, None])
    W = W.at[: 1 + k].set(W0 * scale0[:, None])

    # Normalised Gram (unit diagonal on live rows) + ridge: near-duplicate
    # or zero pool rows stay harmless.
    def _solve_small(G, h, active):
        # Rows are normalised (unit diagonal when live), so a small ridge
        # bounds the condition number; dead/inactive rows become identity
        # rows with zero rhs -> exactly zero coefficients.
        ridge = jnp.asarray(1e-5, G.dtype)
        mask2 = active[:, None] & active[None, :]
        Gm = jnp.where(
            jnp.eye(K, dtype=bool),
            jnp.where(active, jnp.diagonal(G) + ridge, 1.0),
            jnp.where(mask2, G, 0.0),
        )
        hm = jnp.where(active, h, 0.0)
        return jnp.linalg.solve(Gm, hm)

    act0 = jnp.arange(K) < 1 + k
    Gfull = jnp.zeros((K, K), dtype)
    Gn0 = G0[: 1 + k, : 1 + k] * scale0[:, None] * scale0[None, :]
    Gfull = Gfull.at[: 1 + k, : 1 + k].set(Gn0)
    h0 = jnp.zeros(K, dtype).at[: 1 + k].set(G0[: 1 + k, 1 + k] * scale0)
    c0 = _solve_small(Gfull, h0, act0)
    r = b - W.T @ c0
    # One refinement pass against the exact residual: the ridge caps a
    # single solve's reduction at ~ridge, which matters exactly when the
    # recycled pool is good enough to finish in the wide round (3 cheap
    # fixed-cost ops, no operator applies).
    h1 = _matvec_dots(W, r, precise)
    d1 = _solve_small(Gfull, h1, act0)
    c0 = c0 + d1
    r = r - W.T @ d1
    res = _norm(r, precise)

    def cond(carry):
        D, W, G, c, r, res, j = carry
        return (res > tol) & (j < max_narrow)

    def body(carry):
        D, W, G, c, r, res, j = carry
        i = 1 + k + j
        d = M(r[:, None]).reshape(n)
        w = A_block(d[:, None]).reshape(n)
        # One matmul: all of (W.w, b?.w, w.w) and (W.r, w.r) together.
        lhs = jnp.concatenate([W, w[None, :]], axis=0)  # [K+1, n]
        rhs = jnp.stack([w, r], axis=1)  # [n, 2]
        T = _matvec_dots(lhs, rhs, precise)  # [K+1, 2]
        wn = jnp.sqrt(jnp.clip(T[K, 0], 0.0, None))
        s = jnp.where(wn > 0, 1.0 / wn, 0.0)
        D = D.at[i].set(d * s)
        W = W.at[i].set(w * s)
        gcol = (T[:K, 0] * s).at[i].set(jnp.where(wn > 0, 1.0, 0.0))
        G = G.at[:, i].set(gcol).at[i, :].set(gcol)
        # Incremental LS against the EXACT residual r: delta = argmin
        # ||r - W delta|| -- refinement structure keeps f32 Gram solves
        # accurate over rounds.
        hr = (T[:K, 1]).at[i].set(T[K, 1] * s)
        active = jnp.arange(K) <= i
        delta = _solve_small(G, hr, active)
        c = c + delta
        r = r - W.T @ delta
        return D, W, G, c, r, _norm(r, precise), j + 1

    D, W, Gfull, c, r, res, j = jax.lax.while_loop(
        cond, body, (D, W, Gfull, c0, r, res, jnp.array(0, jnp.int32))
    )
    x = D.T @ c
    info = SolveInfo(iters=1 + j, residual=res)
    return x, info, D


# ----------------------------------------------------------------------
# CG (SPD systems)
# ----------------------------------------------------------------------
def cg(
    A: Callable,
    b: jax.Array,
    M: Callable | None = None,
    x0: jax.Array | None = None,
    *,
    rtol: float = 1e-6,
    atol: float = 0.0,
    maxiter: int = 1000,
    precise: bool = True,
    axis_name: str | None = None,
):
    """Preconditioned conjugate gradients with relative tolerance.

    The residual norm rides the loop state (computed in the body, fused
    with the r.z reduction via `_dot2`) instead of being recomputed in the
    while-loop condition: one fixed-cost device reduction per iteration
    saved on a backend where op COUNT dominates below ~1 MB payloads."""
    if M is None:
        M = lambda v: v  # noqa: E731
    if x0 is None:
        x0 = jnp.zeros_like(b)
        r = b  # zero guess: skip the A(x0) apply
    else:
        r = b - A(x0)
    z = M(r)
    p = z
    rz, rr = _dot2(z, r, precise, axis_name)
    res = jnp.sqrt(rr)
    b_norm = _norm(b, precise, axis_name)
    tol = jnp.maximum(rtol * b_norm, atol)

    def cond(carry):
        x, r, p, rz, res, k = carry
        return (res > tol) & (k < maxiter)

    def body(carry):
        x, r, p, rz, res, k = carry
        Ap = A(p)
        alpha = rz / _dot(p, Ap, precise, axis_name)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new, rr = _dot2(z, r, precise, axis_name)
        beta = rz_new / rz
        p = z + beta * p
        return x, r, p, rz_new, jnp.sqrt(rr), k + 1

    x, r, p, rz, res, k = jax.lax.while_loop(
        cond, body, (x0, r, p, rz, res, jnp.array(0, jnp.int32))
    )
    return x, SolveInfo(iters=k, residual=res)


# ----------------------------------------------------------------------
# CG with a recycled projection space (FROZEN operators only)
# ----------------------------------------------------------------------
def cg_recycled(
    A: Callable,
    b: jax.Array,
    M: Callable | None,
    x0: jax.Array | None,
    poolD: jax.Array,
    poolW: jax.Array,
    *,
    rtol: float = 1e-6,
    atol: float = 0.0,
    maxiter: int = 1000,
    precise: bool = True,
):
    """Preconditioned CG warm-started by a least-squares projection onto a
    recycled subspace whose A-images are carried along.

    VALID ONLY when A is literally the same operator that produced
    `poolW = A poolD` (the projection stepper's frozen Schur S1 never
    changes after setup, so directions harvested from previous time steps
    keep exact images -- the wide projection costs ZERO operator applies,
    unlike gcr_recycled's wide round).  Returns (x, SolveInfo, harvest)
    with harvest = [x - x_proj, r_proj - r_final] stacked [2, n]: the next
    pool's (d, A d) row, both sides free.  The harvest spans ONLY the
    post-projection CG increment: its image comes purely from this step's
    recurrence (fp drift ~1e-7 relative, an order below the 1e-6 solve
    targets).  Harvesting the full x - x0 would fold in the projection
    part, whose image was reconstructed from the PREVIOUS pool's inexact
    images -- that error propagates transitively through harvests and can
    random-walk above the recurrence drift over long runs; the projection
    part lies in the old pool's span
    anyway, so excluding it loses no new subspace information.

    `poolD`/`poolW` are [k, n]; zero rows are ignored via the norm guard.
    """
    if M is None:
        M = lambda v: v  # noqa: E731
    if x0 is None:
        x0 = jnp.zeros_like(b)
        r = b
    else:
        r = b - A(x0)
    k, n = poolD.shape
    dtype = b.dtype

    # Projection: c = argmin ||r - poolW^T c||, x += poolD^T c.  Gram +
    # rhs in one matmul; one refinement pass against the exact residual
    # (f32 Gram solves; see gcr_recycled).
    S = jnp.concatenate([poolW, r[None, :]], axis=0)
    G = _matvec_dots(S, S.T, precise)  # [k+1, k+1]
    wn = jnp.sqrt(jnp.clip(jnp.diagonal(G)[:k], 0.0, None))
    sc = jnp.where(wn > 0, 1.0 / wn, 0.0)
    Gn = G[:k, :k] * sc[:, None] * sc[None, :]
    ridge = jnp.asarray(1e-5, dtype)
    Gn = Gn + ridge * jnp.eye(k, dtype=dtype)
    Gn = jnp.where(
        jnp.eye(k, dtype=bool) & (wn == 0)[:, None], 1.0, Gn
    )
    h = G[:k, k] * sc
    c = jnp.linalg.solve(Gn, h)
    x = x0 + (poolD * sc[:, None]).T @ c
    r = r - (poolW * sc[:, None]).T @ c
    h2 = _matvec_dots(poolW * sc[:, None], r, precise)
    c2 = jnp.linalg.solve(Gn, h2)
    x = x + (poolD * sc[:, None]).T @ c2
    r = r - (poolW * sc[:, None]).T @ c2
    x_proj, r_proj = x, r  # harvest baseline: this step's CG increment only

    z = M(r)
    p = z
    rz, rr = _dot2(z, r, precise)
    res = jnp.sqrt(rr)
    b_norm = _norm(b, precise)
    tol = jnp.maximum(rtol * b_norm, atol)

    def cond(carry):
        x, r, p, rz, res, j = carry
        return (res > tol) & (j < maxiter)

    def body(carry):
        x, r, p, rz, res, j = carry
        Ap = A(p)
        alpha = rz / _dot(p, Ap, precise)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new, rr = _dot2(z, r, precise)
        beta = rz_new / rz
        p = z + beta * p
        return x, r, p, rz_new, jnp.sqrt(rr), j + 1

    x, r, p, rz, res, j = jax.lax.while_loop(
        cond, body, (x, r, p, rz, res, jnp.array(0, jnp.int32))
    )
    harvest = jnp.stack([x - x_proj, r_proj - r])
    return x, SolveInfo(iters=j, residual=res), harvest


# ----------------------------------------------------------------------
# Fixed-iteration inner solvers (for the block preconditioners)
# ----------------------------------------------------------------------
def cg_fixed(A: Callable, b: jax.Array, M: Callable, iters: int, precise: bool = False):
    """`iters` steps of preconditioned CG, no convergence checks."""
    x = jnp.zeros_like(b)
    r = b
    z = M(r)
    p = z
    rz = _dot(r, z, precise)

    def body(carry, _):
        x, r, p, rz = carry
        Ap = A(p)
        pAp = _dot(p, Ap, precise)
        alpha = jnp.where(pAp > 0, rz / pAp, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = _dot(r, z, precise)
        beta = jnp.where(rz > 0, rz_new / rz, 0.0)
        p = z + beta * p
        return (x, r, p, rz_new), None

    (x, _, _, _), _ = jax.lax.scan(body, (x, r, p, rz), None, length=iters)
    return x


def gmres_fixed(A: Callable, b: jax.Array, M: Callable, iters: int, precise: bool = False):
    """One `iters`-step GMRES cycle (right-preconditioned), no checks.

    The inner F-block solve of the SIMPLE/Yosida preconditioners: F is
    nonsymmetric (convection), mildly nonnormal, and strongly diagonally
    dominant (M/dt); a short fixed GMRES with Jacobi preconditioning plays
    the reference's inner GMRES-to-1e-2 role."""
    n = b.shape[0]
    dtype = b.dtype
    m = iters
    beta = _norm(b, precise)
    V0 = jnp.where(beta > 0, b / beta, b)

    V = jnp.zeros((m + 1, n), dtype).at[0].set(V0)
    Z = jnp.zeros((m, n), dtype)
    H = jnp.zeros((m + 1, m + 1), dtype)

    def body(j, carry):
        V, Z, H = carry
        z = M(V[j])
        w = A(z)
        # Single-pass batched CGS (rows > j of V are zero; see fgmres).
        # The inner solve plays the reference's loose-tolerance role
        # (ref: Preconditioners.hpp:260), so one orthogonalisation pass is
        # enough and saves two fixed-cost device ops per iteration.
        hcol = _matvec_dots(V, w, precise)
        w = w - V.T @ hcol
        hlast = _norm(w, precise)
        V = V.at[j + 1].set(jnp.where(hlast > 0, w / hlast, w))
        Z = Z.at[j].set(z)
        H = H.at[:, j].set(hcol.at[j + 1].set(hlast))
        return V, Z, H

    V, Z, H = jax.lax.fori_loop(0, m, body, (V, Z, H))

    # Least squares on the (m+1) x m Hessenberg via normal equations
    # (m is small and fixed; this is cheap and avoids dynamic shapes).
    Hm = H[: m + 1, :m]
    e1 = jnp.zeros(m + 1, dtype).at[0].set(beta)
    HtH = Hm.T @ Hm + 1e-30 * jnp.eye(m, dtype=dtype)
    y = jnp.linalg.solve(HtH, Hm.T @ e1)
    return Z.T @ y
