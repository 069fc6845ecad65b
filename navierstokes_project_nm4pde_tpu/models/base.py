"""Time-stepping Navier-Stokes solver: setup / step / solve.

The JAX counterpart of the reference's `NavierStokes` solver classes
(setup: src/NavierStokes2D.cpp:2-157; time loop: :699-750; per-step solve:
:530-639).  Differences by design:

  * all constant data (operators, boundary tables, probes) is precomputed at
    `setup` into static device arrays -- there is no global sparse matrix;
  * one time step is a pure jitted function; the reference's
    assemble / assemble_time_step split (cache M, A, B, rebuild only C(u_n);
    ref: src/NavierStokes2D.cpp:361-390) maps to `convection_setup` producing
    per-step quadrature tables while everything else is reused;
  * the outer solve is flexible GMRES with the selected block preconditioner,
    rebuilt each step exactly as the reference re-initialises its
    preconditioner per step (ref: src/NavierStokes2D.cpp:540-619);
  * steps are batched `steps_per_chunk` at a time under `lax.scan`, emitting
    per-step telemetry (GMRES iterations, residual, drag/lift, delta-p) --
    the CSV material of the reference (gmres.csv, coeff_2.csv).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from navierstokes_project_nm4pde_tpu.config import RunConfig, matmul_precision_scope
from navierstokes_project_nm4pde_tpu.fem.geometry import (
    boundary_tables,
    cell_geometry,
)
from navierstokes_project_nm4pde_tpu.fem.space import build_taylor_hood
from navierstokes_project_nm4pde_tpu.mesh.core import Mesh
from navierstokes_project_nm4pde_tpu.ops import functionals as fn
from navierstokes_project_nm4pde_tpu.ops import operators as ops
from navierstokes_project_nm4pde_tpu.precond import (
    apply_precond,
    build_precond_state,
)
from navierstokes_project_nm4pde_tpu.solvers.krylov import fgmres


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    """Physics + boundary data of one benchmark problem.

    Plays the role of the reference's `Function<dim>` subclasses
    (InletVelocity / ExactSolution / FunctionH / FunctionU0; ref:
    include/NavierStokes2D.hpp:18-81, include/Convergence3D.hpp:18-265),
    as JAX-traceable callables of (x, t).
    """

    dim: int
    nu: float
    rho: float = 1.0
    # Dirichlet: tag -> g(x[n, dim], t) -> [n, dim]
    dirichlet: dict = dataclasses.field(default_factory=dict)
    # Neumann: tag -> h(x[..., dim], t) -> [..., dim]; None = no Neumann
    neumann_tag: Optional[int] = None
    neumann_value: Optional[Callable] = None
    forcing: Optional[Callable] = None  # f(x, t) -> [..., dim]
    u0: Optional[Callable] = None  # u0(x) -> [n, dim]
    p0: Optional[Callable] = None  # p0(x) -> [n]
    # Backflow stabilisation on an open boundary (live version of the
    # reference's disabled term; ref: src/NavierStokes2D.cpp:456-483)
    backflow_tag: Optional[int] = None
    # Functionals
    obstacle_tag: Optional[int] = None
    probe_points: Optional[tuple] = None
    mean_velocity: Optional[Callable] = None  # U_ref(t) for coefficients
    diameter: float = 0.1
    span: Optional[float] = None  # 3D coefficient normalisation


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class State:
    u: jax.Array  # [n_unodes, dim]
    p: jax.Array  # [n_pnodes]
    t: jax.Array  # scalar time
    step: jax.Array  # int32 step counter
    u_prev: jax.Array | None = None  # u^{n-1} (BDF2 / extrapolation history)
    p_prev: jax.Array | None = None  # p^{n-1} (guess extrapolation)
    u_prev2: jax.Array | None = None  # u^{n-2} (guess_order=2 only)
    p_prev2: jax.Array | None = None  # reserved (quadratic p guess: rejected)
    # N(u^{n-1}) = C(u^{n-1}) u^{n-1} (explicit-convection history).  The
    # true AB2 rhs is 2 N(u^n) - N(u^{n-1}): N is QUADRATIC, so evaluating
    # C(w)w at the extrapolated w = 2u^n - u^{n-1} is NOT second order --
    # its leading term is 4 N(u^n) and it destabilises the impulsive DFG
    # start at CFL ~ 0.15 (measured divergence at 47k and 965k DoF).
    conv_prev: jax.Array | None = None
    # Recycled Krylov pool for the projection velocity solve
    # (cfg.precond.f_recycle > 0): [k, n_unodes * dim] direction rows from
    # the previous step's GCR solve (solvers/krylov.py gcr_recycled).
    # Pure accelerator state: zeros are always valid (e.g. after resume).
    fpool: jax.Array | None = None
    # Recycled projection space for the frozen-Schur pressure CG
    # (cfg.precond.s_recycle > 0): [2, k, n_p] with [0] = directions and
    # [1] = their EXACT S1 images (S1 is frozen at setup, so images stay
    # valid across steps).  Zeros are always valid.
    spool: jax.Array | None = None
    # Zero-extra-apply warm-start pool for the velocity FGMRES
    # (cfg.precond.f_warmstart > 0): [k, n_unodes * dim] direction rows
    # (the last k steps' post-warmstart solve increments).  Their images
    # F D under THIS step's operator are recomputed exactly each step by
    # riding extra channels through the dual-channel macro rhs pass
    # (ops/macroblock.py apply_rhs_and_r0_macro) -- no stale-image error,
    # unlike pools that carry images across steps.  Zeros are
    # always valid.
    fwpool: jax.Array | None = None


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class FrozenSchur:
    """One-time (setup) data for the projection pressure Poisson.

    In projection mode S~ = D diag(M/dt_eff)^-1 D^T = dt_eff * S1 with S1
    time-independent (M, D, and the Dirichlet mask never change), so the
    scaled system S1 phi = rhs / dt_eff is solved instead -- identical
    solution, zero per-step Schur assembly/factorisation, and the one-time
    setup can afford a strong coarse correction (dense inverse)."""

    inv1: jax.Array  # [n_unodes] (1/diagM on free nodes, 0 constrained)
    vals1: jax.Array  # [n_slots] S1 ELL values
    diag1: jax.Array  # [n_p]
    cho_L: jax.Array | None  # coarse Cholesky factor (coarse_solve="chol")
    inv_c: jax.Array | None  # dense coarse inverse (coarse_solve="inv")
    # Block-banded dense form of S1 (ops/banded.py): the Schur CG's SpMV as
    # a static tile gather + batched dense matvec instead of the ELL
    # gather.  None when the pattern is not band-limited enough
    # or numerics.schur_spmv == "ell".
    band: object = None


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DeviceData:
    """All device arrays a time step touches, bundled as one pytree.

    Passed as an explicit jit argument (never closed over): closure
    constants are embedded into the serialized program, which both bloats
    compile payloads past backend limits at scale and forces a recompile
    per solver instance."""

    op: ops.NSOperator
    bc_idx: tuple
    bc_coords: tuple
    bc_inverse: object
    neumann: object
    neumann_points: object
    neumann_plan: object
    backflow: object
    forces: object
    probe: object
    ftab: object
    # Setup-time power-iteration bound on lam_max(diag(F)^-1 F) for the
    # convection-free F (None unless a smoother needs it) -- replaces the
    # per-step power iteration (6 F-applies/step) in build_precond_state.
    f_lam0: object = None
    # Frozen projection-mode Schur data (None in monolithic mode or with
    # numerics.proj_schur == "step").
    proj_schur: "FrozenSchur | None" = None
    # Constant GKd:AHAT element stiffness [E, nloc, nloc], precomputed once
    # at setup for the folded convection path (None when fold_elem is off;
    # ~400 B/cell -- the same footprint the per-step F_e fold already pays).
    conv_base: "jax.Array | None" = None
    # IMEX fine-subset tables (ops/operators.py ImexTables) and the
    # constant-K supernode BSR operator (ops/bsr.py): the fast velocity
    # apply F u = K_bsr u + C_fine(w) u.  Single-device only -- sharded
    # and vmapped runs strip both and fall back to the masked element
    # fold (identical operator).
    imex: "object | None" = None
    kbsr: "object | None" = None
    # Macro-element block-dense F (ops/macroblock.py MacroPlan): the
    # implicit-convection fast velocity apply -- per-step values are
    # assembled from the folded F_e by one-hot contractions and the
    # Krylov apply becomes a beta*n-row gather + batched dense matvec.
    # Single-device only; sharded/vmapped runs strip it.
    macro: "object | None" = None
    # Setup-time macro form of the constant velocity mass M [B, U, U]
    # (None unless the macro plan is active): rides the same slot gather
    # and node reduce as the per-step F values in the dual-channel
    # rhs/r0 pass (ops/macroblock.py apply_rhs_and_r0_macro).
    macro_mass: "jax.Array | None" = None
    # Setup-time macro form of the constant stiffness A [B, U, U] (the
    # K/C split, NumericsConfig.macro_split): per step only C_e(w) is
    # one-hot folded and Ft = macro_mass/dt_eff + nu*macro_stiff + Ct.
    macro_stiff: "jax.Array | None" = None
    # Gate for the fgmres-aux divergence reuse (accumulating the Krylov
    # applies' element gathers into du_e so the divergence rhs skips its
    # own gather).  Pays on large single runs WITHOUT the assembled
    # D forms; vmapped ensembles strip it (the [restart+1, B, E, nloc, d]
    # aux basis is pure extra traffic when members are small).
    aux_div: bool = dataclasses.field(
        default=True, metadata=dict(static=True)
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class StepDiagnostics:
    iters: jax.Array  # total iterations (outer FGMRES, or F + Schur solves)
    residual: jax.Array
    drag: jax.Array
    lift: jax.Array
    c_d: jax.Array
    c_l: jax.Array
    delta_p: jax.Array
    # Per-solve split (projection mode: velocity solve / pressure Poisson;
    # monolithic mode: iters_f == iters, iters_s == 0).
    iters_f: jax.Array | None = None
    iters_s: jax.Array | None = None


class NavierStokesSolver:
    """End-to-end solver for one `ProblemSpec` on one `Mesh`."""

    def __init__(self, mesh: Mesh, problem: ProblemSpec, config: RunConfig):
        self.mesh = mesh
        self.problem = problem
        self.config = config
        self.dtype = jnp.dtype(config.numerics.dtype)
        # Setup-time device programs (macro values, spectral bound) run
        # under the same matmul precision as the step.
        with matmul_precision_scope(config.numerics.matmul_precision):
            self._setup()

    # ------------------------------------------------------------------
    def _setup(self):
        import os
        import time as _time

        _verbose = os.environ.get("NS_SETUP_VERBOSE") == "1"
        _t = [_time.perf_counter()]

        def _mark(label):
            if _verbose:
                now = _time.perf_counter()
                import sys

                print(f"# setup {label}: {now - _t[0]:.1f}s", file=sys.stderr)
                _t[0] = now

        cfg = self.config
        if cfg.time.convection not in ("implicit", "explicit", "imex"):
            raise ValueError(f"unknown convection mode: {cfg.time.convection}")
        if cfg.time.convection not in ("implicit",) and (
            cfg.time.stepper != "projection"
        ):
            raise ValueError(
                f"convection={cfg.time.convection!r} requires the projection "
                "stepper (the monolithic saddle-point path keeps the "
                "reference's linearised-implicit convection)"
            )
        if cfg.time.convection == "imex" and cfg.time.imex_umax is None:
            raise ValueError(
                "convection='imex' requires TimeConfig.imex_umax (the CFL "
                "velocity scale of the per-cell explicit/implicit partition)"
            )
        _wants_banded = (
            cfg.time.stepper == "projection"
            and cfg.numerics.proj_schur == "frozen"
            and cfg.numerics.schur_spmv in ("auto", "banded")
        )
        self._reorder_method = None
        if cfg.numerics.spatial_reorder:
            # RCM gives the bounded band the banded frozen-Schur SpMV needs
            # (Morton spans are heavy-tailed).  Morton remains the default
            # otherwise.
            method = "rcm" if _wants_banded else "morton"
            self.mesh = self.mesh.reorder_spatial(method)
            self._reorder_method = method
        self.space = build_taylor_hood(self.mesh)
        self.geom = cell_geometry(self.space)
        dtags = sorted(self.problem.dirichlet.keys())
        mask = self.space.dirichlet_mask(dtags)
        # In frozen-projection mode the S~ values are assembled ONCE at
        # setup, host-side: the ~230 MB of pair-product/reduction tables the
        # per-step device assembly needs then never go to the device.
        frozen_schur = (
            cfg.time.stepper == "projection"
            and cfg.numerics.proj_schur == "frozen"
        )
        self.op, self._schur_host = ops.build_operator(
            self.space, self.geom, mask, dtype=self.dtype,
            coarse_agg=cfg.numerics.schur_agg,
            device_schur_assembly=not frozen_schur,
            want_host_schur=True,
        )
        _mark("operator (host tables + schur pattern)")
        if cfg.numerics.element_contraction != "einsum":
            import dataclasses as _dc

            self.op = _dc.replace(
                self.op, contraction=cfg.numerics.element_contraction
            )
        if cfg.precond.f_solver == "pmg":
            import dataclasses as _dc

            from navierstokes_project_nm4pde_tpu.ops.pmg import (
                build_velocity_pmg,
            )

            pmg = build_velocity_pmg(
                self.space, self.geom, np.asarray(mask), dtype=self.dtype
            )
            self.op = _dc.replace(self.op, pmg=pmg)
        if cfg.numerics.reduce_plan == "halving":
            import dataclasses as _dc

            from navierstokes_project_nm4pde_tpu.ops.scatter import (
                build_halving_plan,
            )

            hp = build_halving_plan(
                np.asarray(self.space.cells_u), self.space.n_unodes
            )
            self.op = _dc.replace(self.op, hplan_u=hp)
        elif cfg.numerics.reduce_plan == "windowed":
            import dataclasses as _dc

            from navierstokes_project_nm4pde_tpu.ops.scatter import (
                build_windowed_plan,
            )

            self.op = _dc.replace(
                self.op,
                plan_u=build_windowed_plan(
                    np.asarray(self.space.cells_u), self.space.n_unodes,
                    splits=(self.mesh.n_vertices,),
                    rows_per_block=cfg.numerics.windowed_rows,
                ),
                plan_p=build_windowed_plan(
                    np.asarray(self.space.cells_p), self.space.n_pnodes,
                    rows_per_block=cfg.numerics.windowed_rows,
                ),
            )
        elif cfg.numerics.reduce_plan in ("exact", "columns"):
            # Valence-exact buckets: zero padded rows in the [rows, K]
            # reduce tables (the padded rows of the 2-bucket split were
            # ~28% of the rows at 609k DoF).  "columns" applies the same
            # buckets as K unrolled 1-D row gathers with explicit adds.
            import dataclasses as _dc

            from navierstokes_project_nm4pde_tpu.ops.scatter import (
                build_gather_plan_grouped,
            )

            exact = tuple(range(2, 97))
            mode = (
                "columns" if cfg.numerics.reduce_plan == "columns" else "table"
            )
            self.op = _dc.replace(
                self.op,
                plan_u=build_gather_plan_grouped(
                    np.asarray(self.space.cells_u).reshape(-1, 1),
                    self.space.n_unodes, thresholds=exact, mode=mode,
                ),
                plan_p=build_gather_plan_grouped(
                    np.asarray(self.space.cells_p).reshape(-1, 1),
                    self.space.n_pnodes, thresholds=exact, mode=mode,
                ),
            )
        # Windowed forward gather (ops/scatter.py WindowedGather): chosen
        # from ~1M DoF (768k node entries) before the H100 port, for a
        # gather rate bound by the source working set; not yet measured on
        # the H100 (ROADMAP S3).  Needs the RCM ordering for bounded
        # windows; skipped when the built windows are degenerate
        # (unordered meshes).
        _gp = cfg.numerics.gather_plan
        if _gp == "auto":
            _gp = (
                "windowed"
                if self.space.n_unodes * self.space.dim >= 768_000
                and self._reorder_method == "rcm"
                else "plain"
            )
        if _gp == "windowed":
            import dataclasses as _dc

            from navierstokes_project_nm4pde_tpu.ops.scatter import (
                build_windowed_gather,
            )

            wg = build_windowed_gather(
                np.asarray(self.space.cells_u),
                self.mesh.n_vertices,
                self.space.n_unodes,
                cells_per_block=cfg.numerics.gather_cpb,
            )
            # auto mode only pays when the windows are genuinely small
            # (degenerate windows = unordered mesh); an explicit request
            # is honored regardless (correct at any window size).
            if (
                cfg.numerics.gather_plan == "windowed"
                or wg.window_rows <= 0.5 * self.space.n_unodes
            ):
                self.op = _dc.replace(self.op, wgather_u=wg)
        elif _gp != "plain":
            raise ValueError(f"unknown gather_plan: {cfg.numerics.gather_plan}")
        # Assembled-transpose gradient (NSOperator.gradt): the projection
        # stepper's update gradient is a full element pass + velocity-space
        # reduction per step; the ELL form gathers nnz(D) rows from the
        # KB-scale pressure vector instead.  Sharded/ensemble runs strip it
        # (parallel/sharding.py, parallel/ensemble.py).
        _ga = cfg.numerics.grad_apply
        if _ga == "auto":
            _ga = "bsr" if cfg.time.stepper == "projection" else "element"
        if _ga == "ell":
            import dataclasses as _dc

            self.op = _dc.replace(
                self.op,
                gradt=ops.build_gradient_plan(
                    self._schur_host, self.space.n_unodes, dtype=self.dtype
                ),
            )
        elif _ga == "bsr":
            import dataclasses as _dc

            from navierstokes_project_nm4pde_tpu.ops.bsr import (
                build_gradient_bsr,
            )

            self.op = _dc.replace(
                self.op,
                gbsr=build_gradient_bsr(
                    self._schur_host, self.space.n_unodes,
                    self.space.n_pnodes,
                    bs=cfg.numerics.bsr_block_grad or cfg.numerics.bsr_block,
                    dtype=self.dtype,
                ),
            )
        elif _ga != "element":
            raise ValueError(f"unknown grad_apply: {cfg.numerics.grad_apply}")
        # Supernode BSR divergence (see NSOperator.dbsr): the projection
        # stepper's pressure-Poisson rhs -D u* as wide-row block gathers.
        _da = cfg.numerics.div_apply
        if _da == "auto":
            _da = "bsr" if cfg.time.stepper == "projection" else "element"
        if _da == "bsr":
            import dataclasses as _dc

            from navierstokes_project_nm4pde_tpu.ops.bsr import (
                build_divergence_bsr,
            )

            self.op = _dc.replace(
                self.op,
                dbsr=build_divergence_bsr(
                    self._schur_host, self.space.n_unodes,
                    self.space.n_pnodes,
                    bs=cfg.numerics.bsr_block_div or cfg.numerics.bsr_block,
                    dtype=self.dtype,
                ),
            )
        elif _da != "element":
            raise ValueError(f"unknown div_apply: {cfg.numerics.div_apply}")
        _mark("assembled D/G forms")

        # IMEX convection partition: cells violating the explicit CFL bound
        # (u_max dt / h_cell > imex_cfl, h_cell = shortest edge) keep the
        # linearised implicit C(w); the rest move to the explicit rhs.
        self._imex = None
        self._imex_frac = None
        if cfg.time.convection == "imex":
            import dataclasses as _dc

            cc = self.mesh.coords[self.mesh.cells]  # [E, nvloc, dim]
            nvloc = cc.shape[1]
            h = None
            for i in range(nvloc):
                for j in range(i + 1, nvloc):
                    e = np.linalg.norm(cc[:, i] - cc[:, j], axis=1)
                    h = e if h is None else np.minimum(h, e)
            implicit = (
                cfg.time.imex_umax * cfg.time.dt / np.maximum(h, 1e-300)
                > cfg.time.imex_cfl
            )
            self._imex_frac = float(implicit.mean())
            self.op = _dc.replace(
                self.op,
                imex_scale=jnp.asarray(
                    implicit.astype(np.float64), self.dtype
                ),
            )
            if implicit.any():
                self._imex = ops.build_imex_tables(
                    self.space, self.geom, np.nonzero(implicit)[0],
                    self.dtype,
                )
            if _verbose:
                import sys

                print(
                    f"# imex: {self._imex_frac:.1%} of cells implicit "
                    f"(h* = {cfg.time.imex_umax * cfg.time.dt / cfg.time.imex_cfl:.4f})",
                    file=sys.stderr,
                )

        # Constant-K velocity block as a supernode BSR operator: valid when
        # the non-convective block is CONSTANT across warm steps
        # (projection + explicit/imex convection + bdf1).
        self._kbsr = None
        _va = cfg.numerics.vel_apply
        _const_K = (
            cfg.time.stepper == "projection"
            and cfg.time.convection in ("explicit", "imex")
            and cfg.time.scheme == "bdf1"
        )
        if _va == "auto":
            _va = "bsr" if _const_K else "element"
        if _va == "bsr":
            if not _const_K:
                raise ValueError(
                    "vel_apply='bsr' requires the projection stepper with "
                    "convection 'explicit'/'imex' and scheme 'bdf1' (the "
                    "velocity block must be constant)"
                )
            from navierstokes_project_nm4pde_tpu.ops.bsr import (
                build_velocity_kbsr,
            )
            from navierstokes_project_nm4pde_tpu.ops.tables import (
                build_ref_tables,
            )

            self._kbsr = build_velocity_kbsr(
                self.space, self.geom, build_ref_tables(self.space.dim),
                self.problem.nu, cfg.time.dt,
                bs=cfg.numerics.bsr_block_vel or cfg.numerics.bsr_block,
                dtype=self.dtype,
            )
            _mark("constant-K BSR")
        elif _va != "element":
            raise ValueError(f"unknown vel_apply: {cfg.numerics.vel_apply}")

        # Macro-element block-dense F (implicit convection): per-step
        # values assembled on device from the folded F_e; each Krylov
        # apply becomes a beta*n-row gather + batched dense matvec
        # (ops/macroblock.py).  Needs the fold (F_e) and the spatial
        # reorder (RCM/Morton cell locality bounds the per-block unique
        # node count).
        self._macro = None
        self._macro_mass = None
        self._macro_stiff = None
        _fa = cfg.numerics.f_apply
        _macro_ok = (
            cfg.time.stepper == "projection"
            and cfg.time.convection == "implicit"
            and cfg.numerics.fold_elem
            and cfg.numerics.spatial_reorder
            and self._kbsr is None
            # The macro values encode only the volume terms of F_e; the
            # backflow facet term would be silently dropped from the
            # Krylov operator.
            and self.problem.backflow_tag is None
        )
        if _fa == "auto":
            _fa = "macro" if _macro_ok else "element"
        if _fa == "macro":
            if not _macro_ok:
                raise ValueError(
                    "f_apply='macro' requires the projection stepper with "
                    "implicit convection, fold_elem and spatial_reorder"
                )
            from navierstokes_project_nm4pde_tpu.ops.macroblock import (
                build_macro_plan,
            )

            self._macro = build_macro_plan(
                np.asarray(self.space.cells_u), self.space.n_unodes,
                U=cfg.numerics.macro_u, c_blk=cfg.numerics.macro_cblk,
                n_vertices=self.mesh.n_vertices,
            )
            if cfg.numerics.macro_rhs != "off":
                from navierstokes_project_nm4pde_tpu.ops.macroblock import (
                    build_macro_values,
                )

                M_e = (
                    self.op.MHAT[None, :, :]
                    * self.op.detJ[:, None, None]
                )
                self._macro_mass = jax.jit(build_macro_values)(
                    self._macro, M_e
                )
                _msplit = cfg.numerics.macro_split
                if _msplit == "auto":
                    _msplit = "off"  # chosen before the H100 port
                if _msplit == "on" and cfg.precond.f_iters > 0:
                    # The smoother path (_solve_F) applies F via the
                    # element fold, which a conv-only fold cannot drive.
                    _msplit = "off"
                if _msplit == "on":
                    # Setup-time macro stiffness: per step only C_e(w)
                    # is folded, so the constant blocks never pay the
                    # per-step build again.  The plan is a jit ARGUMENT
                    # -- closing over it would embed the 557 MB one-hot
                    # in the program as a constant.
                    def _stiff(mp_, GKd, AHAT):
                        return build_macro_values(
                            mp_, jnp.einsum("ekl,klij->eij", GKd, AHAT)
                        )

                    self._macro_stiff = jax.jit(_stiff)(
                        self._macro, self.op.GKd, self.op.AHAT
                    )
                elif _msplit != "off":
                    raise ValueError(
                        f"unknown macro_split: {cfg.numerics.macro_split}"
                    )
            _mark("macro-element block plan")
        elif _fa != "element":
            raise ValueError(f"unknown f_apply: {cfg.numerics.f_apply}")
        if cfg.precond.s_solver.startswith("spai"):
            import dataclasses as _dc

            from navierstokes_project_nm4pde_tpu.ops.spai import build_spai_values

            vals = build_spai_values(
                self.op, self._schur_host, self.problem.nu, cfg.time.dt
            )
            self.op = _dc.replace(
                self.op, spai_vals=jnp.asarray(vals, self.dtype)
            )

        # Dirichlet node lists per tag. Later tags override earlier at shared
        # (corner) nodes, matching the reference's map overwrite order where
        # walls/obstacle are interpolated after the inlet
        # (ref: src/NavierStokes2D.cpp:330-352).
        taken = np.zeros(self.space.n_unodes, dtype=bool)
        self._bc_groups = []
        node_groups = []
        for tag in reversed(dtags):
            nodes = self.space.boundary_unodes([tag])
            nodes = nodes[~taken[nodes]]
            taken[nodes] = True
            node_groups.append(nodes)
            self._bc_groups.append(
                (
                    self.problem.dirichlet[tag],
                    jnp.asarray(nodes, dtype=jnp.int32),
                    jnp.asarray(
                        self.space.unode_coords[nodes], dtype=self.dtype
                    ),
                )
            )
        # scatter-free injection of boundary values (see ops/scatter.py)
        from navierstokes_project_nm4pde_tpu.ops.scatter import build_inverse_map

        self._bc_inverse = build_inverse_map(node_groups, self.space.n_unodes)

        bt = boundary_tables(self.space, self.geom, degree=4)
        self._btables = bt
        _mark("boundary tables")

        # Neumann tables
        self.neumann = None
        if self.problem.neumann_tag is not None:
            sel = np.where(bt.tag == self.problem.neumann_tag)[0]
            self.neumann = fn.ForceTables(
                cells_u=jnp.asarray(
                    self.space.cells_u[bt.cell[sel]], dtype=jnp.int32
                ),
                cells_p=jnp.asarray(
                    self.space.cells_p[bt.cell[sel]], dtype=jnp.int32
                ),
                phi_u=jnp.asarray(bt.phi_u[sel], dtype=self.dtype),
                grad_u=jnp.asarray(bt.grad_u[sel], dtype=self.dtype),
                phi_p=jnp.asarray(bt.phi_p[sel], dtype=self.dtype),
                jxw=jnp.asarray(bt.jxw[sel], dtype=self.dtype),
                normal=jnp.asarray(bt.normal[sel], dtype=self.dtype),
            )
            self._neumann_points = jnp.asarray(
                bt.points[sel], dtype=self.dtype
            )
            from navierstokes_project_nm4pde_tpu.ops.scatter import (
                build_gather_plan,
            )

            self._neumann_plan = build_gather_plan(
                self.space.cells_u[bt.cell[sel]], self.space.n_unodes
            )

        # Backflow stabilisation tables on the open boundary
        self.backflow = None
        if self.problem.backflow_tag is not None:
            from navierstokes_project_nm4pde_tpu.ops.scatter import (
                build_gather_plan,
            )

            sel = np.where(bt.tag == self.problem.backflow_tag)[0]
            self.backflow = ops.BackflowTables(
                cells_u=jnp.asarray(
                    self.space.cells_u[bt.cell[sel]], dtype=jnp.int32
                ),
                phi_u=jnp.asarray(bt.phi_u[sel], dtype=self.dtype),
                jxw=jnp.asarray(bt.jxw[sel], dtype=self.dtype),
                normal=jnp.asarray(bt.normal[sel], dtype=self.dtype),
                plan=build_gather_plan(
                    self.space.cells_u[bt.cell[sel]], self.space.n_unodes
                ),
            )

        # Force tables on the obstacle
        self.forces = None
        if self.problem.obstacle_tag is not None:
            self.forces = fn.build_force_tables(
                self.space, bt, tag=self.problem.obstacle_tag, dtype=self.dtype
            )

        # Pressure probes
        self.probe = None
        if self.problem.probe_points is not None:
            self.probe = fn.build_point_probe(
                self.space, self.geom, self.problem.probe_points, dtype=self.dtype
            )

        self._unode_coords_dev = jnp.asarray(self.space.unode_coords, self.dtype)
        self._pnode_coords_dev = jnp.asarray(self.mesh.coords, self.dtype)
        _mark("functional tables + transfers")

        # Quadrature tables for the forcing term (only if the problem has one).
        self._ftab = None
        if self.problem.forcing is not None:
            from navierstokes_project_nm4pde_tpu.ops.functionals import (
                build_error_tables,
            )

            self._ftab = build_error_tables(
                self.space, self.geom, degree=4, dtype=self.dtype
            )

        self._bc_fns = [fn_g for (fn_g, _, _) in self._bc_groups]

        # One-time spectral bound for the dot-free F smoothers: power
        # iteration on the convection-free F (M/dt + nu*A with Dirichlet
        # identity rows).  The per-step convection term perturbs lam_max only
        # mildly at practical dt (F is mass-dominated); build_precond_state
        # adds a 1.1 margin.  Computed only when a consumer exists.
        self._f_lam0 = None
        # Needed only by the omega-damped smoothers (richardson/chebyshev/
        # pmg): the plain-Jacobi and fixed-GMRES paths never read the
        # bound, and the extra jitted program costs a compile in every
        # solver setup.
        if cfg.precond.f_solver in ("richardson", "chebyshev", "pmg"):
            op, nu = self.op, self.problem.nu
            # Bound the spectrum at the dt the WARM steps actually solve
            # with: BDF2's velocity block is F = M/dt_eff + ... with
            # dt_eff = 2dt/3 after step 0 (more mass-dominated, hence a
            # larger Jacobi-scaled lam_max) -- bounding at dt under-damps
            # every warm step.
            dt = cfg.time.dt
            if cfg.time.scheme == "bdf2":
                dt = dt / 1.5
            n, d = self.space.n_unodes, self.space.dim
            mask = op.dirichlet_mask
            dF = ops.diag_F(op, nu, dt, None)
            minv = jnp.where(mask, 1.0, 1.0 / dF)[:, None].repeat(
                d, axis=1
            ).reshape(-1)
            # One jitted program with the operator as an ARGUMENT (a traced
            # closure would embed the operator arrays as program constants;
            # an eager loop pays one dispatch per op).
            def _power(op_, minv_, mask_):
                v = jnp.sin(jnp.arange(n * d, dtype=self.dtype))
                v = v / jnp.sqrt(jnp.sum(v * v))

                def body(_, carry):
                    v, _lam = carry
                    u = v.reshape(n, d)
                    y = ops.apply_F(op_, nu, dt, None, u)
                    y = jnp.where(mask_[:, None], u, y).reshape(-1)
                    w = minv_ * y
                    lam = jnp.sqrt(jnp.sum(w * w))
                    return w / jnp.maximum(lam, 1e-30), lam

                _, lam = jax.lax.fori_loop(
                    0, 8, body, (v, jnp.asarray(1.0, self.dtype))
                )
                return lam

            self._f_lam0 = jax.jit(_power)(op, minv, mask)

        # Frozen projection Schur: assemble S1 = D diag(M)^-1 D^T and its
        # coarse correction ONCE (see FrozenSchur).  The per-step solve
        # rescales the rhs by 1/dt_eff instead of the values by dt_eff.
        self._proj_schur = None
        if frozen_schur:
            from navierstokes_project_nm4pde_tpu.ops.coarse import (
                host_coarse_dense,
            )
            from navierstokes_project_nm4pde_tpu.ops.schur_ell import (
                host_assemble_schur_values,
            )

            # Host-side numpy assembly (float64): the pair-product tables
            # stay on the host and only the [n_slots] values + the tiny
            # coarse factor are transferred -- the device-assembly path
            # ships ~230 MB of setup-only tables at 965k DoF.
            # build_operator's frozen SpGEMM path precomputes `vals1`; the
            # fallback covers operators built with device assembly on.
            host = self._schur_host
            mask_np = np.asarray(mask, dtype=bool)
            inv1 = np.where(mask_np, 0.0, 1.0 / host["diagM"])
            vals1 = host.get("vals1")
            if vals1 is None:
                vals1 = host_assemble_schur_values(host, inv1)
            diag1 = vals1[host["diag_slot"]]
            diag1 = np.where(diag1 > 0, diag1, 1.0)
            Sc = host_coarse_dense(
                host, vals1, self.op.coarse.nc, self.op.coarse.agg
            )
            cho_L = inv_c = None
            if cfg.numerics.coarse_solve == "inv":
                inv_c = jnp.asarray(np.linalg.inv(Sc), self.dtype)
            else:
                cho_L = jnp.asarray(np.linalg.cholesky(Sc), self.dtype)
            band = None
            if cfg.numerics.schur_spmv in ("auto", "banded"):
                from navierstokes_project_nm4pde_tpu.ops.banded import (
                    build_banded_schur,
                )

                smask = host["smask"]
                band = build_banded_schur(
                    host["srow"][smask], host["scol"][smask], vals1[smask],
                    n_rows=len(diag1), dtype=self.dtype,
                )
                if band is None and cfg.numerics.schur_spmv == "banded":
                    raise ValueError(
                        "schur_spmv='banded': the RCM band is too wide for "
                        "the dense form; use 'auto' or 'ell'"
                    )
            self._proj_schur = FrozenSchur(
                inv1=jnp.asarray(inv1, self.dtype),
                vals1=jnp.asarray(vals1, self.dtype),
                diag1=jnp.asarray(diag1, self.dtype),
                cho_L=cho_L, inv_c=inv_c, band=band,
            )
            _mark("frozen projection Schur (host assembly)")

        self._rebuild_device_data()

    def _rebuild_device_data(self):
        """(Re)collect the DeviceData pytree from solver attributes (called
        after setup and after sharding mutates the arrays)."""
        self._conv_base = None
        if self.config.numerics.fold_elem:
            # Constant GKd:AHAT element stiffness, computed ONCE as an
            # exact-f32 elementwise contraction (the per-step fold used to rebuild
            # this time-independent [E, nloc, nloc] array inside the chunk).
            def _base(gkd, ahat):
                return (
                    gkd[:, :, :, None, None] * ahat[None]
                ).sum(axis=(1, 2))

            self._conv_base = jax.jit(_base)(self.op.GKd, self.op.AHAT)

        self._dev = DeviceData(
            op=self.op,
            bc_idx=tuple(idx for (_, idx, _) in self._bc_groups),
            bc_coords=tuple(c for (_, _, c) in self._bc_groups),
            bc_inverse=self._bc_inverse,
            neumann=self.neumann,
            neumann_points=getattr(self, "_neumann_points", None),
            neumann_plan=getattr(self, "_neumann_plan", None),
            backflow=self.backflow,
            forces=self.forces,
            probe=self.probe,
            ftab=self._ftab,
            f_lam0=getattr(self, "_f_lam0", None),
            proj_schur=getattr(self, "_proj_schur", None),
            conv_base=self._conv_base,
            imex=getattr(self, "_imex", None),
            kbsr=getattr(self, "_kbsr", None),
            macro=getattr(self, "_macro", None),
            macro_mass=getattr(self, "_macro_mass", None),
            macro_stiff=getattr(self, "_macro_stiff", None),
        )

    # ------------------------------------------------------------------
    def initial_state(self) -> State:
        """Interpolate the initial condition (ref: src/NavierStokes2D.cpp:708)."""
        n, d = self.space.n_unodes, self.space.dim
        if self.problem.u0 is not None:
            u = jnp.asarray(
                self.problem.u0(self._unode_coords_dev), dtype=self.dtype
            )
        else:
            u = jnp.zeros((n, d), self.dtype)
        if self.problem.p0 is not None:
            p = jnp.asarray(
                self.problem.p0(self._pnode_coords_dev), dtype=self.dtype
            )
        else:
            p = jnp.zeros(self.space.n_pnodes, self.dtype)
        keep_hist = (
            self.config.time.scheme == "bdf2"
            or self.config.solver.extrapolate_guess
        )
        quad = (
            self.config.solver.extrapolate_guess
            and self.config.solver.guess_order >= 2
        )
        explicit_bdf2 = (
            self.config.time.convection == "explicit"
            and self.config.time.scheme == "bdf2"
        )
        return State(
            u=u,
            p=p,
            t=jnp.asarray(0.0, self.dtype),
            step=jnp.asarray(0, jnp.int32),
            u_prev=u if keep_hist else None,
            p_prev=p if self.config.solver.extrapolate_guess else None,
            u_prev2=u if quad else None,
            # placeholder; step 0 falls back to AB1 and overwrites it
            conv_prev=jnp.zeros_like(u) if explicit_bdf2 else None,
            # zero pool = wide round degenerates to one Jacobi direction
            fpool=(
                jnp.zeros(
                    (self.config.precond.f_recycle, n * d), self.dtype
                )
                if (
                    self.config.precond.f_recycle > 0
                    and self.config.time.stepper == "projection"
                )
                else None
            ),
            spool=(
                jnp.zeros(
                    (2, self.config.precond.s_recycle, self.space.n_pnodes),
                    self.dtype,
                )
                if (
                    self.config.precond.s_recycle > 0
                    and self.config.time.stepper == "projection"
                )
                else None
            ),
            fwpool=(
                jnp.zeros(
                    (self.config.precond.f_warmstart, n * d), self.dtype
                )
                if (
                    self.config.precond.f_warmstart > 0
                    and self.config.time.stepper == "projection"
                )
                else None
            ),
        )

    # ------------------------------------------------------------------
    def _ensure_pools(self, state: State) -> State:
        """Fill missing recycle pools on an externally supplied state.

        A checkpoint written before f_recycle/s_recycle existed (or by a
        run with them off) has no pool arrays; the step's recycle guard
        requires `state.fpool/spool is not None`, so resuming such a
        checkpoint with recycling enabled would silently disable it for
        the whole run.  Zero pools are always
        valid (initial_state's contract: the solvers' norm guards ignore
        zero rows)."""
        import dataclasses as _dc

        cfg = self.config
        if cfg.time.stepper != "projection":
            return state
        n, d = self.space.n_unodes, self.space.dim
        upd = {}
        if cfg.precond.f_recycle > 0 and state.fpool is None:
            upd["fpool"] = jnp.zeros(
                (cfg.precond.f_recycle, n * d), self.dtype
            )
        if cfg.precond.s_recycle > 0 and state.spool is None:
            upd["spool"] = jnp.zeros(
                (2, cfg.precond.s_recycle, self.space.n_pnodes), self.dtype
            )
        if cfg.precond.f_warmstart > 0 and state.fwpool is None:
            upd["fwpool"] = jnp.zeros(
                (cfg.precond.f_warmstart, n * d), self.dtype
            )
        return _dc.replace(state, **upd) if upd else state

    # ------------------------------------------------------------------
    def _dirichlet_values(self, t, dev: DeviceData) -> jax.Array:
        """Full [n_unodes, dim] array with g(x, t) on constrained nodes.

        Built scatter-free: per-group values are concatenated and routed
        through a precomputed inverse gather map (ops/scatter.py)."""
        from navierstokes_project_nm4pde_tpu.ops.scatter import apply_inverse_map

        vals = [
            jnp.asarray(fn_g(coords, t), self.dtype)
            for fn_g, coords in zip(self._bc_fns, dev.bc_coords)
        ]
        if not vals:
            return jnp.zeros((self.space.n_unodes, self.space.dim), self.dtype)
        return apply_inverse_map(dev.bc_inverse, jnp.concatenate(vals, axis=0))

    def _pack(self, u, p):
        return jnp.concatenate([u.reshape(-1), p])

    def _unpack(self, x):
        n, d = self.space.n_unodes, self.space.dim
        return x[: n * d].reshape(n, d), x[n * d:]

    # ------------------------------------------------------------------
    def _bdf_terms(self, state: State, dt: float):
        """(w, hist, dt_eff): convection linearisation point, mass-history
        combination, and the effective dt of the velocity block."""
        cfg = self.config
        if cfg.time.scheme == "bdf2":
            # BDF2 with extrapolated convection; falls back to BDF1 on the
            # first step (no history yet).  All branching is arithmetic so
            # the same compiled program covers both phases under scan.
            first = (state.step == 0).astype(self.dtype)
            beta = 1.5 - 0.5 * first  # 1.0 on step 0, else 3/2
            w = jnp.where(first > 0, state.u, 2.0 * state.u - state.u_prev)
            hist = jnp.where(
                first > 0,
                state.u / dt,
                (4.0 * state.u - state.u_prev) / (2.0 * dt),
            )
            return w, hist, dt / beta
        return state.u, state.u / dt, dt

    def _warm_guess(self, state: State):
        """(u_guess, p_guess): linearly extrapolated warm start when history
        is available, else the previous solution."""
        cfg = self.config
        if cfg.solver.extrapolate_guess and state.u_prev is not None:
            not_first = (state.step > 0).astype(self.dtype)
            u_guess = state.u + not_first * (state.u - state.u_prev)
            p_guess = state.p + not_first * (state.p - state.p_prev)
            if state.u_prev2 is not None:
                # quadratic through (x_{n-2}, x_{n-1}, x_n) at t_{n+1}:
                # x + (x - x_prev) + (x - 2 x_prev + x_prev2), second
                # difference gated until two real histories exist.
                # VELOCITY ONLY: extrapolating the pressure quadratically
                # second-differences the CG solver noise (the projection
                # phi increments are tiny at small dt, so the noise is
                # relatively large): at 965k DoF the Schur CG count rose
                # from 14.7 to 23.5 per step.
                not_second = (state.step > 1).astype(self.dtype)
                u_guess = u_guess + not_second * (
                    state.u - 2.0 * state.u_prev + state.u_prev2
                )
            return u_guess, p_guess
        return state.u, state.p

    def _tol_kwargs(self, b):
        """Map config tol_mode onto the increment-form solver call (the
        solver's rhs is the warm-start residual r0, so 'r0' = solver 'b',
        and 'b' = an absolute target scaled by the FULL rhs)."""
        cfg = self.config
        if cfg.solver.tol_mode == "b":
            from navierstokes_project_nm4pde_tpu.solvers.krylov import _norm

            bnorm = _norm(b, cfg.numerics.precise_dots)
            return dict(
                rtol=0.0,
                atol=jnp.maximum(cfg.solver.rtol * bnorm, cfg.solver.atol),
                tol_mode="abs",
            )
        return dict(
            rtol=cfg.solver.rtol,
            atol=cfg.solver.atol,
            tol_mode="b" if cfg.solver.tol_mode == "r0" else cfg.solver.tol_mode,
        )

    def _external_rhs(self, t_new, dev: DeviceData):
        """Neumann + forcing contributions to the momentum rhs (zero-cost
        when the problem has neither)."""
        rhs = None
        if dev.neumann is not None:
            rhs = self._neumann_rhs(t_new, dev)
        if self.problem.forcing is not None:
            f = self._forcing_rhs(t_new, dev)
            rhs = f if rhs is None else rhs + f
        return rhs

    # ------------------------------------------------------------------
    def step(self, state: State, nu=None, dev: DeviceData | None = None):
        """One semi-implicit time step (pure; jit/scan/vmap-able).

        `nu` may be a traced scalar to support vmapped Reynolds ensembles.
        `dev` must be threaded as a jit argument by callers that jit this
        function (see DeviceData); it defaults to the solver's own data for
        eager use."""
        cfg = self.config
        if nu is None:
            nu = self.problem.nu
        if dev is None:
            dev = self._dev
        # Scope the matmul precision to this trace (a process-global
        # jax.config.update here would leak into other solvers and make
        # same-process A/B comparisons meaningless).
        with matmul_precision_scope(cfg.numerics.matmul_precision):
            return self._step_dispatch(state, nu, dev)

    def _step_dispatch(self, state: State, nu, dev: DeviceData):
        cfg = self.config
        if cfg.time.stepper == "projection":
            return self._step_projection(state, nu, dev)
        dt = cfg.time.dt
        op = dev.op
        # Time from the exact integer step counter, not accumulated sums:
        # t += dt in float32 drifts by several dt over ~20k steps, perturbing
        # time-dependent Dirichlet data (sin(pi t/8) ramps).
        t_new = (state.step.astype(self.dtype) + 1.0) * dt

        w, hist, dt_eff = self._bdf_terms(state, dt)
        fold = (nu, dt_eff) if cfg.numerics.fold_elem else None
        conv = ops.convection_setup(op, w, backflow=dev.backflow, fold=fold,
                                    base_e=dev.conv_base)
        pst = build_precond_state(
            op, nu, dt_eff, conv, cfg.precond.kind,
            s_solver=cfg.precond.s_solver, f_solver=cfg.precond.f_solver,
            f_lam=dev.f_lam0,
        )
        dt = dt_eff  # the velocity block is F = M/dt_eff + nu*A + C(w)

        # RHS: mass applied to the BDF history combination
        # (BDF1: (M/dt) u_n, ref: src/NavierStokes2D.cpp:270,450)
        rhs_u = ops.apply_mass(op, hist)
        ext = self._external_rhs(t_new, dev)
        if ext is not None:
            rhs_u = rhs_u + ext

        # Dirichlet rows: rhs = g, operator row = identity.
        g = self._dirichlet_values(t_new, dev)
        rhs_u = jnp.where(op.dirichlet_mask[:, None], g, rhs_u)
        rhs_p = jnp.zeros(self.space.n_pnodes, self.dtype)

        def A(x):
            u, p = self._unpack(x)
            y_u, y_p = ops.apply_system(op, nu, dt, conv, u, p)
            return self._pack(y_u, y_p)

        def M(x):
            u, p = self._unpack(x)
            z_u, z_p = apply_precond(
                cfg.precond.kind, cfg.precond, op, pst, nu, dt, u, p
            )
            return self._pack(z_u, z_p)

        b = self._pack(rhs_u, rhs_p)
        # warm start: previous solution, linearly extrapolated when history
        # is available (strictly better initial residual on smooth flows)
        u_guess, p_guess = self._warm_guess(state)
        x0 = self._pack(jnp.where(op.dirichlet_mask[:, None], g, u_guess), p_guess)
        # Solve in increment form: A dx = b - A x0, x = x0 + dx.  Exact-
        # arithmetic-equivalent to solving for x directly, but the M/dt bulk
        # of b cancels analytically instead of numerically -- in float32 the
        # direct form loses ~2-3 digits to cancellation at small dt (the
        # rhs is ~|u|/dt while the per-step increment is tiny).
        r0 = b - A(x0)
        tol_kw = self._tol_kwargs(b)
        dx, info = fgmres(
            A,
            r0,
            M=M,
            restart=cfg.solver.restart,
            maxiter=cfg.solver.maxiter,
            precise=cfg.numerics.precise_dots,
            **tol_kw,
        )
        x = x0 + dx
        u_new, p_new = self._unpack(x)
        keep_hist = cfg.time.scheme == "bdf2" or cfg.solver.extrapolate_guess
        quad = state.u_prev2 is not None
        new_state = State(
            u=u_new,
            p=p_new,
            t=t_new,
            step=state.step + 1,
            u_prev=state.u if keep_hist else None,
            p_prev=state.p if cfg.solver.extrapolate_guess else None,
            u_prev2=state.u_prev if quad else None,
        )

        diag = self._diagnostics(u_new, p_new, t_new, info, nu, dev)
        return new_state, diag

    # ------------------------------------------------------------------
    def _step_projection(self, state: State, nu, dev: DeviceData):
        """One incremental pressure-correction (IPCS) step.

        The fast alternative to the monolithic saddle-point solve
        (which stays the reference-parity mode): every outer FGMRES
        iteration there costs an inner F solve + Schur solve + coupled
        apply, ~10-15x per step; here a step is exactly

          1. tentative velocity:  F u* = M h + f - G p_n,  u*|_D = g(t+dt)
          2. pressure Poisson:    S~ phi = D u*,
             with S~ = D diag(M/dt_eff)^-1 D^T restricted to free velocity
             columns -- the *same* operator the Yosida preconditioner
             assembles (ops/schur_ell.py), solved by two-level-preconditioned
             CG in the 25-30x smaller pressure space
          3. update:  p_{n+1} = p_n + phi,
                      u_{n+1} = u* + diag(M/dt_eff)^-1 G phi   (free nodes)

        Step 3 makes D u_{n+1} = CG residual by construction, so discrete
        incompressibility holds to solver tolerance.  The splitting error of
        the incremental form is O(dt^2) in velocity -- subdominant to the
        semi-implicit scheme's own O(dt) linearisation error (the same
        linearisation as ref: src/NavierStokes2D.cpp:253).
        """
        from navierstokes_project_nm4pde_tpu.ops.coarse import (
            cho_solve_c,
            inv_solve_c,
            twolevel_apply_additive_g,
            twolevel_apply_g,
        )
        from navierstokes_project_nm4pde_tpu.ops.schur_ell import (
            schur_ell_matvec,
        )
        from navierstokes_project_nm4pde_tpu.precond.blocks import _solve_F
        from navierstokes_project_nm4pde_tpu.solvers.krylov import cg

        cfg = self.config
        op = dev.op
        dt = cfg.time.dt
        t_new = (state.step.astype(self.dtype) + 1.0) * dt
        w, hist, dt_eff = self._bdf_terms(state, dt)
        mask = op.dirichlet_mask
        n, d = self.space.n_unodes, self.space.dim
        # Warm start / Dirichlet data up front: hist, u0 and w are all cheap
        # node-space combinations, and the implicit path below stacks them
        # into ONE wide gather instead of three (a [n, 3d] payload cost
        # about what [n, d] did before the H100 port; not yet measured on
        # the H100).
        g = self._dirichlet_values(t_new, dev)
        u_guess, p_guess = self._warm_guess(state)
        u0 = jnp.where(mask[:, None], g, u_guess)
        h_e = u0_e = None
        explicit = cfg.time.convection == "explicit"
        if explicit:
            # Convection moves to the rhs (one fused element pass per
            # step); the velocity block is the constant SPD
            # K = M/dt_eff + nu A.  The rhs term must be the TRUE AB2
            # combination 2 N(u^n) - N(u^{n-1}) (see State.conv_prev) --
            # N(u) = C(u)u is quadratic, so C(w)w at the extrapolated w
            # is wrong by a 4x leading term and diverges.
            conv = None
            n_cur = ops.apply_convection_self(
                op, state.u, backflow=dev.backflow
            )
            if cfg.time.scheme == "bdf2" and state.conv_prev is not None:
                first = (state.step == 0).astype(self.dtype)
                conv_rhs = jnp.where(
                    first > 0, n_cur, 2.0 * n_cur - state.conv_prev
                )
            else:
                conv_rhs = n_cur
        use_macro_rhs = (
            not explicit
            and dev.macro is not None
            and dev.macro_mass is not None
            and cfg.numerics.macro_rhs != "off"
        )
        x_b_rhs = None
        warm_f = False
        D_ch = None
        if not explicit:
            fold = (nu, dt_eff) if cfg.numerics.fold_elem else None
            if use_macro_rhs and cfg.numerics.macro_wfuse != "off":
                # ONE up-front slot gather for the whole step: hist/u0
                # (the rhs/r0 pass), the warm-start pool directions, and
                # the convection velocity w all ride the same beta*n-row
                # gather; w's ELEMENT view is then a one-hot
                # expansion from its slot panels (slot_expand_elem)
                # instead of the 2.2M-row forward gather -- the slot
                # gather the rhs pass would have paid is reused, so two
                # of the step's three gathers are retired.
                from navierstokes_project_nm4pde_tpu.ops.macroblock import (
                    slot_expand_elem,
                    slot_gather,
                )

                warm_f = (
                    cfg.precond.f_warmstart > 0 and state.fwpool is not None
                )
                xs = [hist, u0]
                if warm_f:
                    kf = cfg.precond.f_warmstart
                    D_ch = jnp.moveaxis(
                        state.fwpool.reshape(kf, n, d), 0, 1
                    ).reshape(n, kf * d)
                    xs.append(D_ch)
                xs.append(w)
                x_b_all = slot_gather(
                    dev.macro, jnp.concatenate(xs, axis=1)
                )
                x_b_rhs = x_b_all[..., :-d]
                w_e = slot_expand_elem(dev.macro, x_b_all[..., -d:])
            elif use_macro_rhs:
                # hist/u0 ride the macro pass's SLOT gather (beta*n
                # rows); only the convection velocity needs the element
                # view.
                w_e = ops.gather_u(op, w)
            else:
                stacked = jnp.concatenate([hist, u0, w], axis=1)  # [n, 3d]
                st_e = ops.gather_u(op, stacked)  # [E, n_loc, 3d]
                h_e, u0_e, w_e = (
                    st_e[..., :d], st_e[..., d:2 * d], st_e[..., 2 * d:]
                )
            conv = ops.convection_setup(
                op, w, backflow=dev.backflow, fold=fold, w_e=w_e,
                with_diag=not cfg.precond.freeze_conv_diag,
                base_e=dev.conv_base,
                # K/C split: fold only C_e(w); the constant blocks are
                # recombined on the macro side below.
                conv_only=use_macro_rhs and dev.macro_stiff is not None,
            )
        fz = dev.proj_schur
        pst = build_precond_state(
            op, nu, dt_eff, conv, "yosida",
            s_solver="mg2", f_solver=cfg.precond.f_solver,
            f_lam=dev.f_lam0, skip_schur=fz is not None,
        )

        # Per-step macro values, built ONCE for the rhs/r0 pass and every
        # Krylov apply below (engine per cfg.numerics.macro_build).
        Ft_macro = None
        if dev.macro is not None and conv is not None and conv.F_e is not None:
            from navierstokes_project_nm4pde_tpu.ops.macroblock import (
                macro_build_fn,
            )

            if conv.conv_only:
                # K/C split: fold only the convection values (engine per
                # macro_conv_build -- "default" puts the bf16-class build
                # error on C's small share of F) and recombine with the
                # setup-time constant blocks in one fused pass.
                _cb = cfg.numerics.macro_conv_build
                Ct = macro_build_fn("default" if _cb == "auto" else _cb)(
                    dev.macro, conv.F_e
                )
                Ft_macro = (
                    dev.macro_mass * (1.0 / dt_eff)
                    + nu * dev.macro_stiff
                    + Ct
                )
            else:
                Ft_macro = macro_build_fn(cfg.numerics.macro_build)(
                    dev.macro, conv.F_e
                )

        # ---- 1. tentative velocity ------------------------------------
        # b = M h - G p_n and the warm-start residual r0 = b - F u0 in ONE
        # fused element pass + ONE dual-channel reduction (separately they
        # were the two largest fixed costs of the step).  Under IMEX the
        # explicit cells' convection rhs -(1-s) N(w) fuses into the same
        # pass (w_e is already gathered).
        Yw = None
        if use_macro_rhs and Ft_macro is not None:
            # Macro form: (M hist, F u0) share one slot gather + one
            # dual-channel node reduce against [Mt | Ft]; the G p term
            # comes from the assembled gradient (BSR when enabled).
            # Same values as the element pass to summation order.  When
            # the step's fused up-front gather ran (x_b_rhs), the pass
            # consumes the PRE-GATHERED slots and pays no gather at all.
            from navierstokes_project_nm4pde_tpu.ops.macroblock import (
                apply_rhs_and_r0_macro,
            )

            if x_b_rhs is None:
                warm_f = (
                    cfg.precond.f_warmstart > 0 and state.fwpool is not None
                )
            if warm_f:
                # Warm-start pool images F D under THIS step's operator,
                # riding extra channels through the same gather + matvec
                # + reduce.  Masked like the
                # solve operator (pool rows are zero on Dirichlet rows).
                kf = cfg.precond.f_warmstart
                if D_ch is None:
                    D_ch = jnp.moveaxis(
                        state.fwpool.reshape(kf, n, d), 0, 1
                    ).reshape(n, kf * d)
                Mh, Fu0, FD = apply_rhs_and_r0_macro(
                    dev.macro, dev.macro_mass, Ft_macro, hist, u0,
                    extra=D_ch, x_b=x_b_rhs,
                )
                Yw = jnp.moveaxis(
                    jnp.where(mask[:, None], 0.0, FD).reshape(n, kf, d),
                    1, 0,
                ).reshape(kf, n * d)
            else:
                Mh, Fu0 = apply_rhs_and_r0_macro(
                    dev.macro, dev.macro_mass, Ft_macro, hist, u0,
                    x_b=x_b_rhs,
                )
            b_u = Mh - ops.apply_gradient(op, state.p)
            r0_u = b_u - Fu0
        else:
            b_u, r0_u = ops.apply_rhs_and_r0(
                op, hist, state.p, nu, dt_eff, conv, u0, h_e=h_e, u0_e=u0_e,
                w_e=(
                    w_e
                    if (not explicit and op.imex_scale is not None)
                    else None
                ),
            )
        if explicit:
            b_u = b_u - conv_rhs
            r0_u = r0_u - conv_rhs
        ext = self._external_rhs(t_new, dev)
        if ext is not None:
            b_u = b_u + ext
            r0_u = r0_u + ext
        rhs_u = jnp.where(mask[:, None], g, b_u)
        r0_u = jnp.where(mask[:, None], 0.0, r0_u)

        # Fcore: the unmasked operator on [n, C] with ANY channel count C
        # (the element tables, macro values, and BSR streams are all
        # channel-generic) -- the recycled-block GCR path below rides wide
        # channel payloads through it.  None when a per-iteration term is
        # not channel-safe (the IMEX fine-subset correction).
        Fcore = None
        if dev.kbsr is not None:
            from navierstokes_project_nm4pde_tpu.ops.bsr import (
                apply_bsr_scalar,
            )

            # Constant-K fast path: K streams as a supernode BSR operator
            # (wide-row block gathers); only the IMEX fine subset pays a
            # per-iteration element pass.
            C_ef = None
            if dev.imex is not None and not explicit:
                C_ef = ops.convection_fine_fold(
                    op, dev.imex, w_e[dev.imex.f_idx]
                )
            if C_ef is None:
                Fcore = lambda u2: apply_bsr_scalar(dev.kbsr, u2)  # noqa: E731

            def Fop(v):
                u = v.reshape(n, d)
                y = apply_bsr_scalar(dev.kbsr, u)
                if C_ef is not None:
                    y = y + ops.apply_convection_fine(op, dev.imex, C_ef, u)
                return jnp.where(mask[:, None], u, y).reshape(-1)

        elif Ft_macro is not None:
            from navierstokes_project_nm4pde_tpu.ops.macroblock import (
                apply_macro,
                apply_macro_split3,
                split3_values,
            )

            # Macro-element fast path: the per-step block-dense values
            # assembled above (one-hot contractions, no scatter) make
            # every Krylov apply a beta*n-row gather + batched dense
            # matvec instead of the element gather+reduce pair.  Exactly
            # F (same values, different summation order).  The split3
            # engine pre-splits the values once and streams bf16 parts
            # per apply (macro_apply config; ~1e-8 rel class).
            _ma = cfg.numerics.macro_apply
            if _ma == "auto":
                _ma = "highest"
            if _ma == "split3" and self.dtype != jnp.float32:
                # the 3-way bf16 split covers exactly the f32 mantissa
                _ma = "highest"
            if _ma == "split3":
                Ft3 = split3_values(Ft_macro)
                Fcore = lambda u2: apply_macro_split3(  # noqa: E731
                    dev.macro, Ft3, u2
                )
            else:
                Fcore = lambda u2: apply_macro(  # noqa: E731
                    dev.macro, Ft_macro, u2
                )

            def Fop(v):
                u = v.reshape(n, d)
                y = Fcore(u)
                return jnp.where(mask[:, None], u, y).reshape(-1)

        else:
            Fcore = lambda u2: ops.apply_F(op, nu, dt_eff, conv, u2)  # noqa: E731

            def Fop(v):
                u = v.reshape(n, d)
                y = ops.apply_F(op, nu, dt_eff, conv, u)
                return jnp.where(mask[:, None], u, y).reshape(-1)

        def Fop_aux(v):
            # aux = the element-DoF gather of the input: fgmres(aux=True)
            # combines the per-iteration gathers into gather(du), so the
            # divergence rhs below needs NO u*-gather of its own (the
            # gather is linear; fp summation order differs from gathering
            # the combined du by ~1 ulp per basis column).
            u = v.reshape(n, d)
            u_e = ops.gather_u(op, u)
            y = ops.apply_F(op, nu, dt_eff, conv, u, u_e=u_e)
            return jnp.where(mask[:, None], u, y).reshape(-1), u_e

        # F preconditioner: the same fixed-iteration Jacobi smoothers the
        # block preconditioners use (f_solver/f_iters from config); plain
        # Jacobi needs ~4x the outer iterations (at 609k DoF).
        if cfg.precond.f_iters > 0:

            def Mf(v):
                z = _solve_F(
                    op, pst, nu, dt_eff, v.reshape(n, d), cfg.precond
                )
                return z.reshape(-1)

        else:
            minv = jnp.broadcast_to(
                pst.inv_diag_Fhat[:, None], (n, d)
            ).reshape(-1)
            Mf = lambda v: minv * v  # noqa: E731

        b_flat = rhs_u.reshape(-1)
        r0 = r0_u.reshape(-1)
        tol_kw = self._tol_kwargs(b_flat)
        du_e = None
        fpool_new = state.fpool
        fwpool_new = state.fwpool
        recycle = (
            cfg.precond.f_recycle > 0
            and not explicit
            and Fcore is not None
            and state.fpool is not None
        )
        if recycle:
            from navierstokes_project_nm4pde_tpu.solvers.krylov import (
                gcr_recycled,
            )

            kpool = cfg.precond.f_recycle

            def Fop_block(Vc):
                Kc = Vc.shape[1]
                u3 = Vc.reshape(n, d, Kc)
                y2 = Fcore(u3.reshape(n, d * Kc))
                y3 = jnp.where(
                    mask[:, None, None], u3, y2.reshape(n, d, Kc)
                )
                return y3.reshape(n * d, Kc)

            minv_flat = jnp.broadcast_to(
                pst.inv_diag_Fhat[:, None], (n, d)
            ).reshape(-1)

            def M_block(Vc):
                return minv_flat[:, None] * Vc

            du, info_f, Dused = gcr_recycled(
                Fop_block,
                r0,
                M_block,
                state.fpool,
                # Full maxiter headroom, same convergence guarantee as the
                # fgmres path it replaces: capping below maxiter made an
                # F-iteration spike (impulsive start, shedding window) exit
                # silently under-converged.
                # Cost: two [n*dim] buffer rows per slot (~1.5 GB at 965k,
                # maxiter=60) -- f_recycle is an opt-in mode.
                max_narrow=cfg.solver.maxiter,
                precise=cfg.numerics.precise_dots,
                **tol_kw,
            )
            # Next step's pool: the converged increment, the fresh Jacobi
            # direction, and the first narrow-round directions (all fresh
            # information from THIS step's operator; unused narrow slots
            # are zero rows, which the solver's norm guard ignores).
            fresh = [du[None, :], Dused[0:1]]
            if kpool > 2:
                fresh.append(Dused[kpool + 1: kpool + 1 + (kpool - 2)])
            fpool_new = jnp.concatenate(fresh, axis=0)[:kpool]
        elif explicit:
            # K is SPD on the free subspace (r0 vanishes on Dirichlet rows,
            # so CG iterates stay there and the row-masked operator is
            # symmetric on the Krylov space): CG instead of FGMRES -- no
            # basis matmuls, ~4 fixed-cost ops per iteration.
            if tol_kw.get("tol_mode") == "abs":
                cg_rtol, cg_atol = 0.0, jnp.maximum(
                    jnp.asarray(tol_kw["rtol"], b_flat.dtype), tol_kw["atol"]
                )
            else:  # relative to the increment rhs r0 (cg's own b)
                cg_rtol, cg_atol = tol_kw["rtol"], tol_kw["atol"]
            du, info_f = cg(
                Fop,
                r0,
                M=Mf,
                rtol=cg_rtol,
                atol=cg_atol,
                maxiter=cfg.solver.maxiter,
                precise=cfg.numerics.precise_dots,
            )
        elif (
            op.dbsr is None and dev.kbsr is None and dev.macro is None
            and dev.aux_div
        ):
            du, info_f, du_e = fgmres(
                Fop_aux,
                r0,
                M=Mf,
                restart=cfg.solver.restart,
                maxiter=cfg.solver.maxiter,
                precise=cfg.numerics.precise_dots,
                aux=True,
                **tol_kw,
            )
        else:
            # BSR divergence: D u* needs no element gather, so the
            # aux-gather reuse (accumulating the Krylov applies' element
            # gathers into du_e) is dropped -- plain FGMRES, no Zaux
            # basis.
            du_ws = None
            r0_in = r0
            if warm_f and Yw is not None:
                from navierstokes_project_nm4pde_tpu.solvers.krylov import (
                    ls_warmstart,
                )

                # Zero-extra-apply warm start: project r0 onto the pool
                # images F D computed EXACTLY under this step's operator
                # by the macro rhs pass above -- the projected residual
                # r0_in = r0 - F (D c) is exact (no stale-image error),
                # so FGMRES finishes the very system it is handed and the
                # tolerance contract is untouched.
                du_ws, r0_in = ls_warmstart(
                    state.fwpool, Yw, r0,
                    precise=cfg.numerics.precise_dots,
                )
            du, info_f = fgmres(
                Fop,
                r0_in,
                M=Mf,
                restart=cfg.solver.restart,
                maxiter=cfg.solver.maxiter,
                precise=cfg.numerics.precise_dots,
                **tol_kw,
            )
            if warm_f:
                # Harvest THIS step's post-warmstart increment (the
                # innovation beyond the pooled span; its image next step
                # is recomputed fresh, so nothing can compound).
                fwpool_new = jnp.concatenate(
                    [du[None, :], state.fwpool[:-1]], axis=0
                )
                if du_ws is not None:
                    du = du + du_ws
        u_star = u0 + du.reshape(n, d)

        # ---- 2. pressure Poisson in the assembled Schur space ----------
        # M du/dt_eff + G phi = 0 and D(u* + du) = 0 with G = -D^T give
        # S~ phi = -D u* with S~ = D diag(M/dt_eff)^-1 D^T.
        if du_e is None:
            rhs_p = -ops.apply_divergence(op, u_star)
        else:
            # u*'s element view for free: u0_e from the stacked step gather,
            # du_e from the Krylov applies' gathers (fgmres aux) -- the
            # divergence pass skips its element gather entirely.
            rhs_p = -ops.apply_divergence_e(op, u0_e + du_e)
        if fz is not None:
            # S~ = dt_eff * S1 with S1 frozen at setup: solve the rescaled
            # system S1 phi = rhs / dt_eff (identical phi; the tolerance
            # below is computed on the scaled rhs so it rescales with it).
            rhs_p = rhs_p / dt_eff
            s_vals, s_diag = fz.vals1, fz.diag1
            solve_c = (
                inv_solve_c(fz.inv_c) if fz.inv_c is not None
                else cho_solve_c((fz.cho_L, True))
            )
            upd_inv = dt_eff * fz.inv1  # diag(M/dt_eff)^-1 on free nodes
        else:
            s_vals, s_diag = pst.schur_vals, pst.schur_diag
            solve_c = cho_solve_c((pst.schur_cho_L, True))
            upd_inv = pst.schur_inv

        if fz is not None and fz.band is not None:
            from navierstokes_project_nm4pde_tpu.ops.banded import (
                banded_matvec,
            )

            def S(pv):
                return banded_matvec(fz.band, pv)

        else:

            def S(pv):
                return schur_ell_matvec(op.schur, s_vals, pv)

        inv_d = 1.0 / s_diag

        if cfg.precond.mg2_form == "additive":

            def M2(v):
                return twolevel_apply_additive_g(op.coarse, solve_c, inv_d, v)

        else:

            def M2(v):
                return twolevel_apply_g(op.coarse, solve_c, S, inv_d, v)

        # The Poisson solve meets the same ABSOLUTE target as the velocity
        # solve (that is exactly what the monolithic FGMRES enforces on the
        # continuity rows: one tolerance on the combined residual, dominated
        # by the momentum scale).  Measuring it against ||D u*|| -- which a
        # good F solve has already made small -- over-solves by ~2 orders.
        # BUT the absolute target must never exceed the divergence signal
        # itself: when atol > ||D u*||, CG exits immediately with the
        # extrapolated guess and the pressure evolves open-loop
        # (p <- 2 p_n - p_{n-1}, a neutrally stable recursion) -- observed
        # to blow up within ~20 Stokes-regime steps on a 53k-DoF mesh.
        # Capping at a fixed fractional reduction of ||rhs_p|| keeps the
        # feedback loop closed at ~2-3 extra CG iterations.
        from navierstokes_project_nm4pde_tpu.solvers.krylov import _norm

        rp_norm = _norm(rhs_p, cfg.numerics.precise_dots)
        # In the frozen path the system is rescaled by 1/dt_eff, so any
        # ABSOLUTE target must rescale with it (rp_norm already did, since
        # rhs_p was divided above); relative targets are scale-invariant.
        a_scale = 1.0 / dt_eff if fz is not None else 1.0
        if tol_kw.get("tol_mode") == "abs":
            # fgmres's "abs" convention carries the target in BOTH slots
            # (tol = max(rtol * 1, atol)): _tol_kwargs puts it in atol for
            # cfg tol_mode="b" but in rtol for cfg tol_mode="abs" --
            # reading only atol collapsed the target to 0 there and pinned
            # the CG at maxiter every step.
            abs_target = jnp.maximum(
                jnp.asarray(tol_kw["rtol"], rhs_p.dtype), tol_kw["atol"]
            )
            s_rtol = 0.0
            s_atol = jnp.minimum(
                abs_target * a_scale, cfg.solver.proj_div_cap * rp_norm
            )
        else:
            s_rtol = cfg.solver.rtol
            s_atol = jnp.minimum(
                jnp.asarray(cfg.solver.atol, rhs_p.dtype) * a_scale,
                cfg.solver.proj_div_cap * rp_norm,
            )
        # warm start: the previous pressure increment (phi_n ~ p_n - p_{n-1})
        phi0 = p_guess - state.p
        spool_new = state.spool
        if (
            cfg.precond.s_recycle > 0
            and fz is not None
            and state.spool is not None
        ):
            from navierstokes_project_nm4pde_tpu.solvers.krylov import (
                cg_recycled,
            )

            # S1 is frozen, so the recycled images state.spool[1] are
            # exact -- the projection warm start costs no S applies.
            phi, info_s, sh = cg_recycled(
                S,
                rhs_p,
                M2,
                phi0,
                state.spool[0],
                state.spool[1],
                rtol=s_rtol,
                atol=s_atol,
                maxiter=cfg.solver.maxiter,
                precise=cfg.numerics.precise_dots,
            )
            # FIFO harvest: this step's (dphi, S1 dphi) replaces the oldest
            spool_new = jnp.concatenate(
                [sh[:, None, :], state.spool[:, :-1]], axis=1
            )
        else:
            phi, info_s = cg(
                S,
                rhs_p,
                M=M2,
                x0=phi0,
                rtol=s_rtol,
                atol=s_atol,
                maxiter=cfg.solver.maxiter,
                precise=cfg.numerics.precise_dots,
            )

        # ---- 3. update --------------------------------------------------
        # du = -dt_eff diag(M)^-1 G phi = -upd_inv * (G phi) on free nodes
        p_new = state.p + phi
        u_new = u_star - upd_inv[:, None] * ops.apply_gradient(op, phi)

        keep_hist = cfg.time.scheme == "bdf2" or cfg.solver.extrapolate_guess
        quad = state.u_prev2 is not None
        new_state = State(
            u=u_new,
            p=p_new,
            t=t_new,
            step=state.step + 1,
            u_prev=state.u if keep_hist else None,
            p_prev=state.p if cfg.solver.extrapolate_guess else None,
            u_prev2=state.u_prev if quad else None,
            conv_prev=(
                n_cur if explicit and state.conv_prev is not None else None
            ),
            fpool=fpool_new,
            spool=spool_new,
            fwpool=fwpool_new,
        )
        info = type(info_f)(
            iters=info_f.iters + info_s.iters,
            residual=jnp.maximum(info_f.residual, info_s.residual),
        )
        diag = self._diagnostics(
            u_new, p_new, t_new, info, nu, dev,
            iters_f=info_f.iters, iters_s=info_s.iters,
        )
        return new_state, diag

    # ------------------------------------------------------------------
    def _diagnostics(
        self, u, p, t, info, nu=None, dev=None, iters_f=None, iters_s=None
    ) -> StepDiagnostics:
        if nu is None:
            nu = self.problem.nu
        if dev is None:
            dev = self._dev
        rho = self.problem.rho
        zero = jnp.asarray(0.0, self.dtype)
        drag = lift = c_d = c_l = delta_p = zero
        if dev.forces is not None:
            if self.space.dim == 2:
                drag, lift = fn.forces_2d(dev.forces, u, p, nu)
            else:
                drag, lift = fn.forces_3d(dev.forces, u, p, nu, rho)
            if self.problem.mean_velocity is not None:
                U = self.problem.mean_velocity(t)
                c_d, c_l = fn.drag_lift_coefficients(
                    drag, lift, U, self.problem.diameter, self.problem.span, rho
                )
        if dev.probe is not None:
            pv = dev.probe.pressure(p)
            delta_p = pv[0] - pv[1]
        return StepDiagnostics(
            iters=info.iters,
            residual=info.residual,
            drag=drag,
            lift=lift,
            c_d=c_d,
            c_l=c_l,
            delta_p=delta_p,
            iters_f=info.iters if iters_f is None else iters_f,
            iters_s=jnp.zeros_like(info.iters) if iters_s is None else iters_s,
        )

    # ------------------------------------------------------------------
    def _neumann_rhs(self, t, dev: DeviceData) -> jax.Array:
        """int_Gamma h . v ds on the Neumann facets
        (ref: src/Convergence3D.cpp:303-332)."""
        from navierstokes_project_nm4pde_tpu.ops.scatter import apply_gather_plan

        nt = dev.neumann
        h = self.problem.neumann_value(dev.neumann_points, t)  # [f, q, dim]
        y = jnp.einsum("fq,fqc,fqi->fic", nt.jxw, h, nt.phi_u)
        return apply_gather_plan(
            dev.neumann_plan, y.reshape(-1, self.space.dim)
        )

    def _forcing_rhs(self, t, dev: DeviceData) -> jax.Array:
        """int_Omega f . v (assembled via cell quadrature on the fly)."""
        ft = dev.ftab
        f = self.problem.forcing(ft.qpoints, t)  # [E, q, dim]
        y = jnp.einsum("eq,eqc,qi->eic", ft.jxw, f, ft.phi_u)
        return ops.scatter_u(dev.op, y)

    # ------------------------------------------------------------------
    def run(
        self,
        n_steps: int,
        state: State | None = None,
        callback: Callable | None = None,
    ):
        """Advance `n_steps`, chunked under jit+scan.

        `callback(solver, state, diags_chunk)` fires between chunks (host
        side: VTU export, CSV logging).  Returns (state, stacked diagnostics).
        """
        if state is None:
            state = self.initial_state()
        else:
            state = self._ensure_pools(state)
        if n_steps <= 0:
            # e.g. resuming a finished checkpoint: nothing to do.
            empty = np.zeros(0, dtype=np.float64)
            zi = np.zeros(0, dtype=np.int32)
            return state, StepDiagnostics(
                iters=zi, residual=empty, drag=empty,
                lift=empty, c_d=empty, c_l=empty, delta_p=empty,
                iters_f=zi, iters_s=zi,
            )
        chunk = max(1, self.config.numerics.steps_per_chunk)

        # The jitted chunk runner is cached on the solver so repeated run()
        # calls (and CLI chunk loops) reuse the compiled executable.  All
        # device arrays enter as the `dev` ARGUMENT -- closing over them
        # would embed hundreds of MB of constants into the program.
        if not hasattr(self, "_run_chunk"):

            @partial(jax.jit, static_argnames=("k",))
            def run_chunk(dev, state, k):
                def body(st, _):
                    st, d = self.step(st, dev=dev)
                    return st, d

                return jax.lax.scan(body, state, None, length=k)

            self._run_chunk = run_chunk
        run_chunk = self._run_chunk

        all_diags = []
        done = 0
        while done < n_steps:
            k = min(chunk, n_steps - done)
            state, diags = run_chunk(self._dev, state, k)
            done += k
            d = jax.device_get(diags)
            all_diags.append(d)
            # Failure detection (new capability -- the reference has none,
            # SURVEY.md section 5): stop with context instead of silently
            # marching NaNs or burning maxiter every step.
            if not np.all(np.isfinite(d.residual)):
                raise FloatingPointError(
                    f"solver diverged: non-finite residual at step {done} "
                    f"(residuals {d.residual})"
                )
            if np.all(np.maximum(d.iters_f, d.iters_s) >= self.config.solver.maxiter):
                import warnings

                warnings.warn(
                    f"outer GMRES hit maxiter={self.config.solver.maxiter} "
                    f"for an entire chunk at step {done}; solution may be "
                    "inaccurate (consider stronger preconditioning)",
                    stacklevel=2,
                )
            if callback is not None:
                callback(self, state, d)
        stacked = jax.tree.map(lambda *xs: np.concatenate(xs), *all_diags)
        return state, stacked
