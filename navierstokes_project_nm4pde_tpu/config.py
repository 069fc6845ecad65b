"""Declarative configuration for the solver stack.

The reference hard-codes every physical/numerical parameter in its mains and
headers (ref: src/main2D.cpp:17-22, include/NavierStokes2D.hpp:159,
src/NavierStokes2D.cpp:535,547; Preconditioners.hpp:207,260-261,328).  Here the
same parameter surface is exposed as plain dataclasses so runs are scriptable
and ensembles can vmap over them.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional


def matmul_precision_scope(precision: str | None):
    """Context manager applying `NumericsConfig.matmul_precision` to the
    traces opened inside it (a no-op for None: the ambient setting)."""
    if precision is None:
        return contextlib.nullcontext()
    import jax

    return jax.default_matmul_precision(precision)


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Outer flexible-GMRES controls.

    The reference outer solve is GMRES with absolute tolerance 1e-4 and
    maxiter 100000 (ref: src/NavierStokes2D.cpp:534-538).  We default to a
    relative tolerance (more robust across mesh sizes) and a restart length
    that keeps the Krylov basis in HBM comfortably.
    """

    rtol: float = 1e-6
    atol: float = 0.0
    restart: int = 50
    maxiter: int = 200  # outer iterations across restarts
    # What rtol is relative to: "r0" (initial residual; honest per-step
    # accuracy under warm starts), "b" (rhs norm; inflated by the M/dt
    # term), or "abs" (the reference's absolute convention).
    tol_mode: str = "r0"
    # Warm-start the outer solve from the linear extrapolation
    # 2 x_n - x_{n-1} instead of x_n (the reference warm-starts from x_n
    # implicitly via solution_owned; extrapolation is strictly better for
    # smooth trajectories and costs one extra stored state).
    extrapolate_guess: bool = True
    # Projection-mode pressure-Poisson target cap: the CG absolute target
    # is min(velocity-solve target, proj_div_cap * ||rhs_p||), so the
    # divergence feedback loop always closes by at least this fractional
    # reduction even when the absolute target sits above the divergence
    # signal (see _step_projection; 1.0 would let the pressure go
    # open-loop and blow up).
    proj_div_cap: float = 0.1
    # Extrapolation order of the warm start: 1 (linear, 2 x_n - x_{n-1})
    # or 2 (quadratic through the last three states; for the projection
    # pressure increment this is the difference between a first-order and
    # a second-order guess of phi, where the Schur CG count tracks the
    # guess quality).  Costs one more stored state.
    guess_order: int = 1


@dataclasses.dataclass(frozen=True)
class PrecondConfig:
    """Block-preconditioner family selection and inner-solve controls.

    kinds: "identity", "block_identity", "block_triangular", "simple",
    "asimple", "yosida", "ayosida" -- same family as ref:
    include/Preconditioners.hpp:7-534.  The reference's inner solves are
    ILU-preconditioned Krylov to rel. tol 1e-2
    (ref: include/Preconditioners.hpp:260-261); ILU's sequential triangular
    solves serialise on wide accelerators, so inner solves here are
    Jacobi-preconditioned fixed-iteration Krylov / Chebyshev with the same
    loose-tolerance role.
    """

    kind: str = "asimple"
    alpha: float = 1.0  # SIMPLE damping; ref uses 0.5 (SIMPLE) / 1.0 (aSIMPLE)
    # Velocity-block (F) inner solve: fixed iterations.
    f_iters: int = 8
    # "gmres" (robust), "richardson" (dot-free damped Jacobi), or
    # "chebyshev" (dot-free; F is near-SPD at practical dt) -- fewer device
    # ops per iteration.
    f_solver: str = "gmres"
    # Yosida's velocity-correction solve iterations (0 = same as f_iters).
    f_corr_iters: int = 0
    omega: float = 0.9  # Richardson damping
    # Schur-block inner solve: fixed iterations; "cg" or "chebyshev"
    # (dot-free; bounds from one per-step power iteration).
    s_iters: int = 25
    s_solver: str = "cg"
    # Apply the preconditioner's velocity-block operators in bfloat16
    # (halves the gather traffic; the outer flexible GMRES sees the
    # preconditioner as a black box so accuracy is unaffected).
    low_precision: bool = False
    # mg2 two-level form for the projection pressure Poisson: "v11"
    # (symmetric multiplicative V(1,1); 2 extra S SpMVs per application)
    # or "additive" (omega D^-1 r + coarse(r); zero S SpMVs, weaker but
    # each Schur CG iteration drops from 3 SpMVs to 1).  Both are SPD
    # (CG-safe).
    mg2_form: str = "v11"
    # Projection stepper only: keep the Jacobi diagonal of F at its
    # convection-free value diag(M/dt + nu A) instead of re-tabulating
    # diag(C(w)) every step.  The skew-symmetrised convection + Temam form
    # has near-zero diagonal, but computing it costs an element pass plus a
    # full scalar reduction per step.  Only valid with the
    # plain-Jacobi velocity preconditioner (f_iters=0, f_solver="gmres"):
    # the damped smoothers need diag(C) for their spectral-bound bump.
    freeze_conv_diag: bool = False
    # Projection stepper only: pool size k for the recycled-block GCR
    # velocity solve (0 = plain FGMRES).  One WIDE apply over
    # [Jacobi(r0), pool of k directions recycled from the previous time
    # step] replaces most of the sequential FGMRES iterations -- a gain
    # only while a [n, K*dim] payload costs about what [n, dim] does (true
    # of the row-rate-bound gathers before the H100 port; not yet measured
    # on the H100).  Narrow GCR rounds finish to tolerance against the
    # exact residual (solvers/krylov.py gcr_recycled).
    # Requires the plain-Jacobi velocity preconditioner (f_iters == 0).
    f_recycle: int = 0
    # Projection stepper with the FROZEN Schur only: pool size k for the
    # recycled-projection warm start of the pressure-Poisson CG.  S1 never
    # changes after setup, so directions harvested from previous steps
    # keep exact images W = S1 D and the least-squares projection costs
    # ZERO extra S applies (solvers/krylov.py cg_recycled); each step
    # harvests (dphi, S1 dphi) for free from the CG entry/exit residuals.
    s_recycle: int = 0
    # Projection stepper with the macro rhs pass only: pool size k for
    # the ZERO-extra-apply least-squares warm start of the velocity
    # FGMRES.  The last k steps' solve increments ride extra channels
    # through the dual-channel macro rhs pass, yielding EXACT images F D
    # under this step's
    # operator; the warm-start residual is LS-projected onto them
    # (solvers/krylov.py ls_warmstart) before iterating.  No stale-image
    # error -- the projected residual is exactly r0 - F(D c) -- and a
    # monotonicity guard makes the projection a no-op whenever it fails
    # to shrink the residual.  Inactive when the macro rhs pass is off.
    f_warmstart: int = 0

    def __post_init__(self):
        if self.f_warmstart > 0 and self.f_recycle > 0:
            raise ValueError(
                "f_warmstart and f_recycle are mutually exclusive "
                "velocity-solve accelerators"
            )
        if self.f_recycle > 0 and self.f_iters != 0:
            raise ValueError(
                "f_recycle requires the plain-Jacobi velocity "
                "preconditioner (f_iters=0); got "
                f"f_iters={self.f_iters}"
            )
        if self.freeze_conv_diag and self.f_solver in (
            "richardson", "chebyshev", "pmg"
        ):
            raise ValueError(
                "freeze_conv_diag requires a Krylov velocity solve "
                "(f_solver='gmres'): the damped smoothers' spectral bound "
                f"needs diag(C); got f_solver={self.f_solver!r}"
            )


@dataclasses.dataclass(frozen=True)
class NumericsConfig:
    """Floating-point and scheduling knobs.

    Where a default below says "chosen before the H100 port", it was picked
    by measurements on the engine's first target and has not yet been
    measured on the H100 (ROADMAP S3)."""

    dtype: str = "float32"  # array dtype on device
    precise_dots: bool = True  # accumulate Krylov dot products in float64
    steps_per_chunk: int = 10  # time steps fused into one jitted scan
    spatial_reorder: bool = True  # spatial cell + first-touch node renumbering
    # Fold the per-element F matrices once per step (F_e = detJ/dt M^ +
    # nu GKd:A^ + C_e(w), ~400 B/cell) so every F-apply is one batched
    # matmul instead of the 5-einsum chain.  Disable for very large
    # vmapped ensembles if the B x E x nloc^2 buffer pressures device
    # memory.
    fold_elem: bool = True
    # Velocity-reduce plan: "table" (2-bucket padded [rows, K] gather
    # tables), "exact" (valence-exact buckets, zero padded rows),
    # "columns" (exact buckets applied as K unrolled 1-D row gathers +
    # adds), "halving" (one flat 1-D gather + contiguous pairwise halving
    # sums, ops/scatter.py HalvingPlan), or "windowed" (scan over
    # RCM-contiguous destination blocks, each gathering window-locally
    # from a dynamic-sliced source window).  Same roundoff class; pick by
    # measurement on the target backend (all chosen before the H100 port,
    # where scatter was serialised -- ROADMAP D4).
    reduce_plan: str = "table"
    # Destination rows per windowed-reduce block (reduce_plan="windowed"):
    # smaller blocks = smaller source windows but more scan steps.
    windowed_rows: int = 2048
    # Per-element contraction lowering (ops/operators.py): "vpu" evaluates
    # the tiny [E, i, j] x [E, j, c] matvecs as broadcast multiply + sum --
    # elementwise f32 arithmetic, EXACT whatever the matmul precision.
    # "einsum" keeps the matmul lowering (the safe choice for wide vmapped
    # ensembles, where the broadcast relies on XLA fusing the [B, E, i, j,
    # c] product; run_ensemble forces it).
    element_contraction: str = "vpu"
    # Schur SpMV form in frozen-projection mode: "auto" uses the block-
    # banded dense form (ops/banded.py -- static 128-wide tile gather +
    # batched dense matvec) whenever the RCM band fits the dense-value
    # budget, falling back to "ell" otherwise; "banded" requires it; "ell"
    # keeps the bucketed ELL gather SpMV everywhere.
    schur_spmv: str = "auto"
    # Aggregate size of the two-level Schur coarse space (ops/coarse.py):
    # n_p/agg coarse rows, dense-Cholesky-factorised per step.  Smaller
    # aggregates = stronger coarse correction = fewer Schur CG iterations
    # at a larger per-step factorisation.
    schur_agg: int = 24
    # Projection-stepper Schur handling: the pressure-Poisson operator
    # S~ = D diag(M/dt_eff)^-1 D^T is TIME-INDEPENDENT up to the dt_eff
    # scale factor (M and the Dirichlet mask never change).  "frozen"
    # assembles S1 = D diag(M)^-1 D^T and its coarse correction ONCE at
    # setup and solves the rescaled system S1 phi = rhs/dt_eff each step
    # (identical solution; saves the per-step ELL assembly + coarse
    # factorisation and allows arbitrarily expensive one-time setup).
    # "step" rebuilds per step (kept for A/B).
    proj_schur: str = "frozen"
    # How the two-level coarse system is solved per CG iteration:
    # "chol" back-substitutes the (per-step or frozen) dense Cholesky
    # factor; "inv" precomputes the explicit dense inverse ONCE so each
    # application is a single [nc, nc] matmul, independent of nc, which
    # makes much smaller aggregates (stronger coarse spaces) affordable.
    # "inv" requires proj_schur="frozen".
    coarse_solve: str = "chol"
    # Forward element-DoF gather plan: "plain" (u[cells]), "windowed"
    # (per-cell-block dynamic-sliced vertex/edge windows, gathered
    # window-locally -- ops/scatter.py WindowedGather), or "auto" (windowed
    # iff the [n_unodes, dim] node array is at least 768k entries, i.e.
    # from ~1M DoF; chosen before the H100 port).  Windowed requires RCM
    # ordering and is skipped for sharded operators and vmapped ensembles.
    gather_plan: str = "auto"
    # Cells per windowed-gather block (gather_plan="windowed"/"auto").
    gather_cpb: int = 4096
    # Pressure-gradient application: "element" runs G p = -D^T p as an
    # element pass (p-gather + contraction + velocity-space reduction over
    # the tens-of-MB element array); "ell" as an assembled valence-bucketed
    # ELL SpMV gathering nnz(D) rows from the KB-scale pressure vector
    # (ops/operators.py build_gradient_plan); "bsr" as a supernode
    # block-sparse apply (ops/bsr.py: [bs, C]-panel gathers + one streamed
    # dense value array -- wide rows instead of many narrow ones; chosen
    # before the H100 port).  "auto" = "bsr" for the single-device
    # projection stepper (where the update gradient is on the hot path),
    # "element" otherwise (sharded operators and vmapped ensembles keep the
    # element pass).
    grad_apply: str = "auto"
    # Divergence application: "element" (gather + contraction + pressure-
    # space reduce), "bsr" (assembled supernode block-sparse, see
    # grad_apply), or "auto" ("bsr" for the single-device projection
    # stepper, whose pressure-Poisson rhs is on the hot path).  With the
    # BSR divergence the projection stepper also drops the aux-gather
    # FGMRES machinery (reusing Krylov gathers for the divergence rhs).
    div_apply: str = "auto"
    # Supernode (block) size of the BSR operators.  Any multiple of 8
    # tiles exactly (the value arrays fold the whole contraction axis
    # into the minor dim; ops/bsr.py).  Larger blocks cut gathered ROWS
    # but lose block fill (dense-slot waste grows with bs on the
    # rectangular D/G); D/K 32 and G 16 were chosen at 965k DoF before the
    # H100 port (scripts/prof_bsr.py).  The per-operator overrides default
    # to `bsr_block` when None.
    bsr_block: int = 32
    bsr_block_div: Optional[int] = None
    bsr_block_grad: Optional[int] = 16
    bsr_block_vel: Optional[int] = None
    # Velocity-block application when the non-convective part is CONSTANT
    # (projection stepper with convection "explicit" or "imex", scheme
    # bdf1): "bsr" assembles K = M/dt + nu A once into the supernode BSR
    # form so every Krylov iteration streams K instead of paying the
    # element gather+reduce; "element" keeps the matrix-free element pass;
    # "auto" picks "bsr" where it applies (single device).
    vel_apply: str = "auto"
    # Velocity-block application when convection is IMPLICIT (the
    # benchmark): "macro" assembles the per-step folded F_e into
    # macro-element block-dense [U, U] operators on device
    # (ops/macroblock.py: one-hot assembly, beta*n-row gathers instead of
    # slot-row gathers); "auto" picks "macro" for the single-device
    # projection stepper with fold_elem.
    f_apply: str = "auto"
    # Cells per macro block (auto-shrinks until every block's unique
    # node count fits the U-slot table).
    macro_cblk: int = 20
    # Macro block slot width U (multiples of 128).  Wider blocks cut the
    # block-overlap factor beta = B*U/n and with it the row count of BOTH
    # gather phases of every macro apply (slot gather + bucketed reduce),
    # at the price of a larger value stream and build
    # (scripts/prof_macro_u256.py).
    macro_u: int = 128
    # Macro value assembly engine.  "highest": f32 operands at full
    # matmul precision.  "split3": F_e split into three exactly-bf16
    # parts so both one-hot contractions run on bf16 operands -- same
    # values to f32 summation order (equality-tested).  "auto" =
    # "highest" (chosen before the H100 port).
    macro_build: str = "auto"
    # K/C split of the per-step macro build: the constant K = M/dt + nu A
    # is folded into block-dense macro values ONCE at setup (macro_mass /
    # macro_stiff); per step only the convection part C_e(w) is one-hot
    # folded (engine per macro_conv_build) and the three value arrays are
    # recombined in one fused elementwise pass.  Requires the macro rhs
    # pass (the element rhs/r0 fallback needs the FULL folded F_e).
    # "auto" = "off" (chosen before the H100 port); "on"/"off" force it.
    macro_split: str = "auto"
    # Assembly engine for the convection-only macro values under the
    # split.  "default" (backend-default matmul precision) puts its
    # value error on C's ~1/30 share of F only -- the constant blocks
    # stay exact; "highest" keeps the full-fidelity build.  "auto" =
    # "default".
    macro_conv_build: str = "auto"
    # Macro matvec engine for the Krylov F apply: "highest" streams the
    # f32 value array at full matmul precision every apply; "split3"
    # pre-splits the values into exact bf16 (hi, mid, lo) parts once per
    # step and pays ONE stream of each half-size part per apply (six
    # significance products, ~1e-8 rel error class -- the split3 build's
    # class; equality-tested).  "auto" = "highest" (chosen before the H100
    # port).
    macro_apply: str = "auto"
    # Momentum rhs + warm-start residual through the macro values
    # (b = M hist - G p and r0 = b - F u0 from one slot gather, a
    # dual-channel [Mt | Ft] matvec and one node reduce, plus the BSR
    # gradient for G p) instead of the fused element pass.  "auto": on
    # whenever the macro F apply is active; "off" keeps the element
    # pass (A/B hook).
    macro_rhs: str = "auto"
    # Fused step gather: with the macro rhs pass active, ONE up-front
    # slot gather carries hist/u0/warm-start-pool/w and the convection
    # velocity's element view comes from a one-hot expansion of its
    # slot panels (ops/macroblock.py slot_expand_elem) -- retiring the
    # standalone 2.2M-row forward gather AND the rhs pass's own slot
    # gather.  Exact (bit-level) vs the gathered form.  "off" keeps the
    # separate gathers (A/B hook).
    macro_wfuse: str = "auto"
    # Matmul precision scoped around every program the solver jits
    # (NavierStokesSolver.step, its setup-time builds, HaloProjectionStep
    # -- NOT a process-global setting).  The backend default may run f32
    # matmuls on reduced-precision operands (TF32 on the GPU); that class
    # of operand error destabilised the projection stepper on fine meshes
    # when it was last tested (before the H100 port; not yet measured on
    # the H100 -- ROADMAP S3e).  "highest" keeps full f32 products; None
    # leaves the ambient setting.
    matmul_precision: str | None = "highest"


@dataclasses.dataclass(frozen=True)
class TimeConfig:
    """Time-integration window: semi-implicit first-order scheme.

    Mirrors the reference loop `while (time < T - 0.5*deltat)` with the
    convection linearised at the previous velocity
    (ref: src/NavierStokes2D.cpp:699-750, :253).
    """

    dt: float = 0.01
    t_end: float = 8.0
    # "bdf1": semi-implicit first order (the reference's live scheme,
    # ref: src/NavierStokes2D.cpp:250-253).  "bdf2": second-order backward
    # differentiation with extrapolated convection w = 2u_n - u_{n-1}
    # (the reference carries only a dead BDF2 branch gated on time == -1;
    # ref: src/NavierStokes3D.cpp:390-394 -- here it is a real option).
    scheme: str = "bdf1"
    # "monolithic": one coupled saddle-point FGMRES per step (the
    # reference's solve, ref: src/NavierStokes2D.cpp:530-639 -- the parity
    # mode).  "projection": incremental pressure-correction splitting --
    # one velocity solve + one pressure-Poisson solve per step, ~5-10x
    # fewer operator applies at an O(dt^2) incremental splitting error
    # (subdominant to the scheme's own O(dt) at benchmark step sizes).
    stepper: str = "monolithic"
    # Convection treatment in the projection stepper.  "implicit": the
    # linearised C(w) sits inside the velocity block (the reference's
    # scheme, ref: src/NavierStokes2D.cpp:253) -- F is nonsymmetric and
    # rebuilt every step; unconditionally stable.  "explicit": the true
    # AB2 combination 2 N(u^n) - N(u^{n-1}) moves to the rhs (IMEX-BDF2);
    # the velocity block becomes the CONSTANT SPD operator
    # K = M/dt_eff + nu A, solved by CG with no per-step convection fold
    # and a constant Jacobi diagonal.  Subject to the convective CFL limit
    # of the FINEST cells (P2 factor ~4: dt <~ 0.1 h_min / u_max --
    # measured: the graded 47k DFG duct is stable at dt=2e-4 and diverges
    # at 5e-4; the 965k duct diverges already at 2e-4, so this mode does
    # NOT serve the ~1M-DoF benchmark).  Projection stepper only.
    # "imex": per-cell partition of the convection term -- cells whose
    # size violates the explicit CFL bound (the graded region near the
    # obstacle) keep the linearised implicit C(w), all others move to the
    # explicit rhs.  The velocity block is then K + C_fine(w): the
    # CONSTANT K applies as a supernode BSR operator (wide-row gathers,
    # ops/bsr.py) and only the small fine subset pays the per-iteration
    # element pass.  Unconditionally stable on the fine cells by
    # construction; the explicit cells obey their own CFL bound.
    convection: str = "implicit"
    # IMEX classification (convection="imex"): a cell is EXPLICIT iff
    # u_max * dt / h_cell <= imex_cfl with h_cell its shortest edge.
    # imex_umax defaults to the problem's peak inlet speed when the
    # problem provides one.  The conservative default CFL is the largest
    # measured-stable point of the fully explicit mode (the 47k duct at
    # dt=2e-4: CFL 0.07 stable, 0.174 unstable); raising it grows the
    # explicit fraction -- A/B against a stability probe before trusting
    # a higher value.
    imex_umax: Optional[float] = None
    imex_cfl: float = 0.07

    @property
    def n_steps(self) -> int:
        import math

        # Number of iterations of `while (time < T - dt/2): time += dt`.
        return max(0, int(math.floor(self.t_end / self.dt - 0.5)) + 1)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    # Physical constants (nu, rho) live in ProblemSpec -- they are problem
    # data (vmapped over in ensembles), not run configuration.
    time: TimeConfig = dataclasses.field(default_factory=TimeConfig)
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    precond: PrecondConfig = dataclasses.field(default_factory=PrecondConfig)
    numerics: NumericsConfig = dataclasses.field(default_factory=NumericsConfig)
    test_case: int = 2  # inlet profile selector (ref: include/NavierStokes2D.hpp:29-44)
    output_dir: Optional[str] = None
    output_every: int = 0  # 0 = no field output
