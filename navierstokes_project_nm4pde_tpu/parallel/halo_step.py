"""A FULL IPCS projection time step under the owned+halo DoF sharding.

parallel/halo.py ends at the SpMV boundary (halo_apply_system); this
module carries the owned/ghost execution model through a complete
production time step -- the reference runs its whole solve, Krylov loops
included, on owned+ghost vectors (ref: src/NavierStokes2D.cpp:71-87
owned/relevant DoFs, :315-320 compress()).  Device mapping:

  * VELOCITY (94% of the DoFs) is block-sharded in the owned layout;
    every element pass gathers the halo slabs via `lax.ppermute` ring
    shifts and every Krylov reduction is a `psum` of device-local dots
    (solvers/krylov.py `axis_name`) -- per-device cross-device bytes scale
    with the subdomain boundary, not the global problem.
  * PRESSURE (a few hundred KB) is REPLICATED: the divergence rhs is
    one psum of per-device partial assemblies, and the frozen-Schur CG
    (banded/ELL + additive two-level, all setup-time constants) runs
    identically on every device -- the coarse solve is replicated.

Judged-config parity: BDF1/BDF2, guess_order 1/2 warm-start
extrapolation, and the recycled frozen-Schur projection space
(s_recycle) are all carried; the remaining asserts are physics/solver
restrictions (implicit convection, Jacobi-diag F preconditioner, frozen
Schur, no forcing/Neumann/backflow).  Equality vs the single-device
`_step_projection` -- including the warm-started configuration -- is
tested on 8 CPU devices (tests/test_halo_step.py).

All device constants (owned masks/diagonals, halo tables, sharded
geometry, frozen-Schur values, coarse factors, BC tables) enter the
jitted step as ONE explicit pytree ARGUMENT: closing a jitted function
over big arrays would embed them in the program as constants (the
repo-wide DeviceData rule).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from navierstokes_project_nm4pde_tpu.config import matmul_precision_scope
from navierstokes_project_nm4pde_tpu.ops import operators as ops
from navierstokes_project_nm4pde_tpu.ops.coarse import (
    cho_solve_c,
    inv_solve_c,
    twolevel_apply_additive_g,
)
from navierstokes_project_nm4pde_tpu.ops.schur_ell import schur_ell_matvec
from navierstokes_project_nm4pde_tpu.parallel.halo import (
    HaloPlan,
    _gather_ext,
    _reduce_ext,
    build_halo_plan,
    to_natural,
)
from navierstokes_project_nm4pde_tpu.parallel.sharding import (
    _pad_cells,
    shard_operator,
)
from navierstokes_project_nm4pde_tpu.solvers.krylov import (
    _norm,
    cg,
    cg_recycled,
    fgmres,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class HaloStepState:
    """Owned-layout step state (the sharded counterpart of models.base
    State for the halo step's supported config subset)."""

    u: jax.Array  # [n_dev * n_loc, d] owned layout, sharded
    p: jax.Array  # [n_p] replicated
    step: jax.Array  # int32 scalar
    u_prev: jax.Array | None = None  # BDF2 / extrapolation history (owned)
    u_prev2: jax.Array | None = None  # guess_order=2 history (owned)
    p_prev: jax.Array | None = None  # pressure extrapolation history
    spool: jax.Array | None = None  # [2, k, n_p] recycled (d, S1 d) rows


class HaloProjectionStep:
    """Callable one-step driver: HaloStepState -> (HaloStepState,
    (f_iters, s_iters)).  Build once per (solver, device mesh);
    `init_state` / `shard` / `unshard` move states in and out of the
    owned layout."""

    def __init__(self, solver, dmesh: Mesh):
        cfg = solver.config
        t = cfg.time
        assert t.stepper == "projection", "halo step: projection stepper"
        assert t.scheme in ("bdf1", "bdf2")
        assert t.convection == "implicit", "halo step: implicit convection"
        assert cfg.precond.f_iters == 0, "halo step: Jacobi-diag F precond"
        assert cfg.precond.mg2_form == "additive"
        assert cfg.solver.tol_mode == "b"
        fz = solver._dev.proj_schur
        assert fz is not None, "halo step needs the frozen projection Schur"
        assert solver._dev.backflow is None
        assert solver.problem.forcing is None
        assert solver._dev.neumann is None

        self.solver = solver
        self.dmesh = dmesh
        self.axis = dmesh.axis_names[0]
        n_dev = dmesh.devices.size
        self.n_dev = n_dev
        self._bdf2 = t.scheme == "bdf2"
        self._extrap = cfg.solver.extrapolate_guess
        self._quad = self._extrap and cfg.solver.guess_order >= 2
        self._srec = cfg.precond.s_recycle if fz is not None else 0
        self._chol = fz.inv_c is None

        op = solver.op
        # The halo plan works on the cell-padded operator; shard_operator
        # both pads and cell-shards the geometry (and strips the
        # node-space-assembled forms, which do not follow the cell axis).
        op_pad = _pad_cells(op, n_dev)
        self.plan: HaloPlan = build_halo_plan(
            op_pad, n_dev, n_vertices=solver.space.mesh.n_vertices
        )
        op_sh = shard_operator(op, dmesh)
        self.fz = fz

        from navierstokes_project_nm4pde_tpu.precond.blocks import (
            build_precond_state,
        )

        # freeze_conv_diag semantics: the Jacobi diagonal of F is the
        # convection-free one (constant given dt_eff; BDF2's dt_eff switch
        # between step 0 and the rest shifts it by a benign 3/2 on the
        # mass part -- same approximation class as freezing C's diagonal).
        pst = build_precond_state(
            op, solver.problem.nu, t.dt, None, "yosida",
            s_solver="mg2", f_solver=cfg.precond.f_solver, skip_schur=True,
        )

        # Owned-layout constants.  `iperm` inverts the ownership
        # permutation as a GATHER (owned position -> natural row id,
        # padding rows -> an appended zero row).
        def inv_perm(side):
            perm = np.asarray(side.perm)
            ip = np.full(self.n_dev * side.n_loc, side.n_rows, np.int64)
            ip[perm] = np.arange(side.n_rows)
            return jnp.asarray(ip, jnp.int32)

        iperm_u = inv_perm(self.plan.u)
        u_sh = NamedSharding(dmesh, P(self.axis))
        self.u_sharding = u_sh
        self._iperm_u = iperm_u

        def own_u(x, pad_value=0.0):
            xp = jnp.concatenate(
                [x, jnp.full((1,) + x.shape[1:], pad_value, x.dtype)], 0
            )
            return jax.device_put(xp[iperm_u], u_sh)

        self._own_u = own_u
        dev = solver._dev
        # Everything the jitted step reads from device memory, as ONE
        # pytree argument (see module docstring).  "sh" leaves are sharded
        # on their leading axis (owned vectors and per-device stacked
        # tables alike); "rep" leaves are replicated.
        self._consts = {
            "sh": {
                "mask": own_u(op.dirichlet_mask.astype(solver.dtype)) > 0.5,
                "invdiag": own_u(pst.inv_diag_Fhat),
                "inv1": own_u(fz.inv1),  # diag(M)^-1 on free nodes
                "cells": self.plan.u.cells_loc,
                # natural-id pressure connectivity, stacked one block per
                # device (the replicated pressure needs no halo remap)
                "cp_nat": jnp.asarray(
                    np.asarray(op_pad.cells_p).reshape(
                        n_dev, -1, np.asarray(op_pad.cells_p).shape[1]
                    )
                ),
                "send": tuple(self.plan.u.send),
                "table": self.plan.u.table,
                "detJ": op_sh.detJ,
                "GKd": op_sh.GKd,
                "Jinv": op_sh.Jinv,
            },
            "rep": {
                "iperm_u": iperm_u,
                "vals1": fz.vals1,
                "inv_d": 1.0 / fz.diag1,
                "band": fz.band,
                "schur": solver.op.schur,
                "coarse": solver.op.coarse,
                "coarse_f": fz.inv_c if fz.inv_c is not None else fz.cho_L,
                "bc_coords": tuple(dev.bc_coords),
                "bc_inverse": dev.bc_inverse,
            },
        }
        # Small reference tables (KB-scale: quadrature + basis) may ride
        # the closure; only the O(n)/O(E) arrays must be arguments.
        self._tabs = {
            "PHI_U": op.PHI_U, "GRAD_U": op.GRAD_U, "W": op.W,
            "MHAT": op.MHAT, "AHAT": op.AHAT, "BHAT": op.BHAT,
        }
        precision = cfg.numerics.matmul_precision

        def traced_step(consts, state):
            # The same matmul precision scope as NavierStokesSolver.step:
            # without it the element einsums below run at the backend's
            # default f32 matmul precision (TF32 on the GPU).
            with matmul_precision_scope(precision):
                return self._step_impl(consts, state)

        self._step_jit = jax.jit(traced_step)

    # -- layout helpers ------------------------------------------------
    def shard(self, u):
        return self._own_u(jnp.asarray(u))

    def unshard(self, u_own):
        return to_natural(self.plan.u, u_own)

    def init_state(self, state=None) -> HaloStepState:
        """Owned-layout state from a models.base State (or the solver's
        initial state)."""
        if state is None:
            state = self.solver.initial_state()
        u_own = self.shard(state.u)
        keep_hist = self._bdf2 or self._extrap
        return HaloStepState(
            u=u_own,
            p=jnp.asarray(state.p),
            step=jnp.asarray(state.step, jnp.int32),
            u_prev=u_own if keep_hist else None,
            u_prev2=u_own if self._quad else None,
            p_prev=jnp.asarray(state.p) if self._extrap else None,
            spool=(
                jnp.zeros(
                    (2, self._srec, self.solver.space.n_pnodes),
                    self.solver.dtype,
                )
                if self._srec > 0
                else None
            ),
        )

    # -- the step ------------------------------------------------------
    def __call__(self, state: HaloStepState):
        return self._step_jit(self._consts, state)

    def _step_impl(self, consts, state: HaloStepState):
        solver, cfg, plan = self.solver, self.solver.config, self.plan
        tabs = self._tabs
        axis, n_dev = self.axis, self.n_dev
        dt = cfg.time.dt
        nu = solver.problem.nu
        dtype = solver.dtype
        n_loc, d = plan.u.n_loc, solver.space.dim
        n_p = solver.space.n_pnodes
        precise = cfg.numerics.precise_dots
        rep = consts["rep"]

        step_idx = state.step
        t_new = (step_idx.astype(dtype) + 1.0) * dt
        # Dirichlet data: a global node-space evaluation (cheap, one per
        # step), then routed into the owned layout by the inverse-perm
        # gather.
        from navierstokes_project_nm4pde_tpu.ops.scatter import (
            apply_inverse_map,
        )

        vals = [
            jnp.asarray(fn_g(coords, t_new), dtype)
            for fn_g, coords in zip(solver._bc_fns, rep["bc_coords"])
        ]
        if vals:
            g_nat = apply_inverse_map(
                rep["bc_inverse"], jnp.concatenate(vals, axis=0)
            )
        else:
            g_nat = jnp.zeros((solver.space.n_unodes, d), dtype)
        g_own = jnp.concatenate([g_nat, jnp.zeros((1, d), dtype)], 0)[
            rep["iperm_u"]
        ]

        # BDF terms + extrapolated warm guess: elementwise on owned
        # vectors (sharding-transparent), mirroring models.base
        # _bdf_terms/_warm_guess arithmetic gating so one program covers
        # the bootstrap and warm phases.
        u, u_prev = state.u, state.u_prev
        if self._bdf2:
            first = (step_idx == 0).astype(dtype)
            beta = 1.5 - 0.5 * first
            w = jnp.where(first > 0, u, 2.0 * u - u_prev)
            hist = jnp.where(
                first > 0, u / dt, (4.0 * u - u_prev) / (2.0 * dt)
            )
            dt_eff = dt / beta
        else:
            w, hist, dt_eff = u, u / dt, dt
        if self._extrap:
            not_first = (step_idx > 0).astype(dtype)
            u_guess = u + not_first * (u - u_prev)
            p_guess = state.p + not_first * (state.p - state.p_prev)
            if self._quad:
                not_second = (step_idx > 1).astype(dtype)
                u_guess = u_guess + not_second * (
                    u - 2.0 * u_prev + state.u_prev2
                )
        else:
            u_guess, p_guess = u, state.p

        spec_sh = P(axis)  # owned vectors / per-device stacked tables
        spec_r = P()  # replicated

        def local(sh, rp, g_loc, u_loc, w_loc, hist_loc, ug_loc, p_full,
                  phi0, spool, dt_eff):
            cu = sh["cells"][0]
            cp_nat = sh["cp_nat"][0]
            send_u = [s[0] for s in sh["send"]]
            tab_u = sh["table"][0]
            detJ, GKd, Jinv = sh["detJ"], sh["GKd"], sh["Jinv"]
            mask2 = sh["mask"][:, None]

            # ---- rhs + warm residual (one ext-gather, one dual reduce)
            u0 = jnp.where(mask2, g_loc, ug_loc)
            stacked = jnp.concatenate([hist_loc, u0, w_loc], axis=1)
            st_ext = _gather_ext(plan.u, stacked, send_u, n_dev, axis)
            st_e = st_ext[cu]  # [E_d, nloc, 3d]
            h_e, u0_e, w_e = (
                st_e[..., :d], st_e[..., d:2 * d], st_e[..., 2 * d:]
            )
            p_e = p_full[cp_nat]  # replicated pressure: plain gather

            # convection tables at the quadrature points (cell-local)
            w_q = jnp.einsum("qi,eic->eqc", tabs["PHI_U"], w_e)
            wtilde = jnp.einsum("ekd,eqd->eqk", Jinv, w_q)
            WG = jnp.einsum("qik,eqk->eqi", tabs["GRAD_U"], wtilde)
            gref = jnp.einsum("qik,eic->eqkc", tabs["GRAD_U"], w_e)
            divw = jnp.einsum("eqkc,ekc->eq", gref, Jinv)

            def conv_term(v_e):
                v_q = jnp.einsum("qi,eic->eqc", tabs["PHI_U"], v_e)
                r = jnp.einsum("eqi,eic->eqc", WG, v_e)
                r = r + 0.5 * divw[:, :, None] * v_q
                return jnp.einsum(
                    "q,qi,eqc->eic", tabs["W"], tabs["PHI_U"], r
                ) * detJ[:, None, None]

            def K_term(v_e):
                y = jnp.einsum("ij,ejc->eic", tabs["MHAT"], v_e) * (
                    detJ / dt_eff
                )[:, None, None]
                return y + nu * jnp.einsum(
                    "ekl,klij,ejc->eic", GKd, tabs["AHAT"], v_e
                )

            b_e = jnp.einsum("ij,ejc->eic", tabs["MHAT"], h_e) * detJ[
                :, None, None
            ]
            b_e = b_e + jnp.einsum(
                "ekc,kij,ei->ejc", Jinv, tabs["BHAT"], p_e
            ) * detJ[:, None, None]
            f_e = K_term(u0_e) + conv_term(u0_e)
            y_e = jnp.concatenate([b_e, b_e - f_e], axis=-1)
            y2 = _reduce_ext(
                plan.u, y_e.reshape(-1, 2 * d), tab_u, send_u, n_dev, axis
            )
            b_u, r0_u = y2[:, :d], y2[:, d:]
            rhs_u = jnp.where(mask2, g_loc, b_u)
            r0 = jnp.where(mask2, 0.0, r0_u).reshape(-1)

            # ---- 1. tentative velocity: FGMRES with psum'd reductions
            bnorm = _norm(rhs_u.reshape(-1), precise, axis)
            atol = jnp.maximum(cfg.solver.rtol * bnorm, cfg.solver.atol)

            def Fop(v):
                uv = v.reshape(n_loc, d)
                u_ext = _gather_ext(plan.u, uv, send_u, n_dev, axis)
                u_e = u_ext[cu]
                y_el = (K_term(u_e) + conv_term(u_e)).reshape(-1, d)
                y = _reduce_ext(plan.u, y_el, tab_u, send_u, n_dev, axis)
                return jnp.where(mask2, uv, y).reshape(-1)

            minv = jnp.broadcast_to(
                sh["invdiag"][:, None], (n_loc, d)
            ).reshape(-1)
            du, info_f = fgmres(
                Fop,
                r0,
                M=lambda v: minv * v,
                rtol=0.0,
                atol=atol,
                tol_mode="abs",
                restart=cfg.solver.restart,
                maxiter=cfg.solver.maxiter,
                precise=precise,
                axis_name=axis,
            )
            u_star = u0 + du.reshape(n_loc, d)

            # ---- 2. pressure Poisson on the REPLICATED pressure space
            us_ext = _gather_ext(plan.u, u_star, send_u, n_dev, axis)
            us_e = us_ext[cu]
            div_e = jnp.einsum(
                "ekc,kij,ejc->ei", Jinv, tabs["BHAT"], us_e
            ) * detJ[:, None]
            rhs_part = jnp.zeros((n_p,), dtype).at[
                cp_nat.reshape(-1)
            ].add(div_e.reshape(-1))
            # frozen: S~ = dt_eff * S1, solve the rescaled system
            rhs_p = -jax.lax.psum(rhs_part, axis) / dt_eff

            if rp["band"] is not None:
                from navierstokes_project_nm4pde_tpu.ops.banded import (
                    banded_matvec,
                )

                S = lambda pv: banded_matvec(rp["band"], pv)  # noqa: E731
            else:
                S = lambda pv: schur_ell_matvec(  # noqa: E731
                    rp["schur"], rp["vals1"], pv
                )

            solve_c = (
                cho_solve_c((rp["coarse_f"], True)) if self._chol
                else inv_solve_c(rp["coarse_f"])
            )

            def M2(v):
                return twolevel_apply_additive_g(
                    rp["coarse"], solve_c, rp["inv_d"], v
                )

            rp_norm = _norm(rhs_p, precise)
            s_atol = jnp.minimum(
                atol / dt_eff, cfg.solver.proj_div_cap * rp_norm
            )
            if spool is not None:
                phi, info_s, harv = cg_recycled(
                    S, rhs_p, M2, phi0, spool[0], spool[1],
                    rtol=0.0, atol=s_atol,
                    maxiter=cfg.solver.maxiter, precise=precise,
                )
                spool = jnp.concatenate(
                    [harv[:, None, :], spool[:, :-1]], axis=1
                )
            else:
                phi, info_s = cg(
                    S, rhs_p, M=M2, x0=phi0, rtol=0.0, atol=s_atol,
                    maxiter=cfg.solver.maxiter, precise=precise,
                )

            # ---- 3. update
            phi_e = phi[cp_nat]
            gphi_e = -jnp.einsum(
                "ekc,kij,ei->ejc", Jinv, tabs["BHAT"], phi_e
            ) * detJ[:, None, None]
            gphi = _reduce_ext(
                plan.u, gphi_e.reshape(-1, d), tab_u, send_u, n_dev, axis
            )
            u_new = u_star - (dt_eff * sh["inv1"])[:, None] * gphi
            p_new = p_full + phi
            return u_new, p_new, spool, info_f.iters, info_s.iters

        # warm start for the pressure CG: the previous increment
        phi0 = (
            p_guess - state.p
            if self._extrap
            else jnp.zeros_like(state.p)
        )
        fn = jax.shard_map(
            local,
            mesh=self.dmesh,
            in_specs=(
                spec_sh,  # the sharded-constants dict (leading-axis split)
                spec_r,  # the replicated-constants dict
                spec_sh, spec_sh, spec_sh, spec_sh, spec_sh,  # g,u,w,hist,ug
                spec_r, spec_r, spec_r, spec_r,  # p, phi0, spool, dt_eff
            ),
            out_specs=(spec_sh, spec_r, spec_r, spec_r, spec_r),
            check_vma=False,
        )
        u_new, p_new, spool_new, itf, its = fn(
            consts["sh"], rep, g_own, u, w, hist, u_guess,
            state.p, phi0, state.spool, jnp.asarray(dt_eff, dtype),
        )
        keep_hist = self._bdf2 or self._extrap
        new_state = HaloStepState(
            u=u_new,
            p=p_new,
            step=step_idx + 1,
            u_prev=state.u if keep_hist else None,
            u_prev2=state.u_prev if self._quad else None,
            p_prev=state.p if self._extrap else None,
            spool=spool_new,
        )
        return new_state, (itf, its)
