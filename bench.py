"""Benchmark: 3D flow-past-a-cylinder time-stepping throughput on one GPU.

One in-process measurement of the 965,265-DoF DFG duct (test case 2,
dt=2e-4, rtol 1e-6 vs ||b||): setup, compile + two warm-up chunks, then a
timed stretch.  Prints a device line (JAX platform, device kind and count,
and the card's `nvidia-smi` name and power limit), then ONE JSON line:

  {"metric": "...", "value": N, "unit": "steps/s", "device": {...}, ...}

It exits non-zero when JAX's default backend is not a GPU or the run
fails; there is no fallback to another device or a smaller mesh.  Mesh
size and solver knobs are tunable via env (NS_BENCH_*):
  NS_BENCH_LC / NS_BENCH_NZ  (mesh; default 0.024 / 14 = 965k DoF)
  NS_BENCH_STEPS             (timed steps, default 80)
  NS_BENCH_CHUNK             (steps per jitted chunk, default 80)

    python bench.py
"""

from __future__ import annotations

import json
import os
import sys
import time


def measure():
    lc = float(os.environ.get("NS_BENCH_LC", "0.024"))
    nz = int(os.environ.get("NS_BENCH_NZ", "14"))  # 965k DoF
    n_steps = int(os.environ.get("NS_BENCH_STEPS", "80"))
    # Keep n_steps a MULTIPLE of chunk, or the odd remainder compiles
    # inside the timed run.
    chunk = int(os.environ.get("NS_BENCH_CHUNK", "80"))
    # Timed chunk length; 0 = same as chunk.  A different length is a
    # separate program, compiled and run once outside the timed section.
    timed_chunk = int(os.environ.get("NS_BENCH_TIMED_CHUNK", "0")) or chunk
    precond = os.environ.get("NS_BENCH_PRECOND", "yosida")
    f_corr = int(os.environ.get("NS_BENCH_F_CORR", "0"))
    s_iters = int(os.environ.get("NS_BENCH_S_ITERS", "3"))
    # FGMRES restart length: every iteration's orthogonalisation reads
    # the whole [restart+1, n] basis.
    restart = int(os.environ.get("NS_BENCH_RESTART", "8"))
    # Outer-iteration cap, with headroom for the impulsive first steps.
    maxiter = int(os.environ.get("NS_BENCH_MAXITER", "60"))
    lowp = os.environ.get("NS_BENCH_LOWP", "0") == "1"
    s_solver = os.environ.get("NS_BENCH_S_SOLVER", "mg2_cg")
    f_solver = os.environ.get("NS_BENCH_F_SOLVER", "gmres")
    # rtol relative to ||b|| (the scipy/PETSc convention; far stricter than
    # the reference's absolute 1e-4).  tol_mode="r0" demands a 1e-6
    # *reduction of the warm-start residual* -- ~3x more iterations.
    tol_mode = os.environ.get("NS_BENCH_TOL_MODE", "b")
    # "projection" (incremental pressure-correction: one F solve + one
    # Schur CG per step, validated to the same ES orders / DFG
    # coefficients as the monolithic solve) or "monolithic"
    # (reference-parity saddle-point FGMRES).
    stepper = os.environ.get("NS_BENCH_STEPPER", "projection")
    # "implicit" (reference-parity linearised convection inside F),
    # "explicit" (C(w)w in the rhs; constant SPD velocity block -- CFL-
    # unstable at the 965k mesh at dt=2e-4), or "imex" (per-cell
    # partition: implicit C(w) only on the CFL-critical graded cells).
    conv_mode = os.environ.get("NS_BENCH_CONV", "implicit")
    # IMEX classification knobs: u_max defaults to the problem's peak
    # inlet speed (u_m = 9); the CFL bound is the stable point of the fully
    # explicit mode (see TimeConfig).
    imex_umax = float(os.environ.get("NS_BENCH_IMEX_UMAX", "9.0"))
    imex_cfl = float(os.environ.get("NS_BENCH_IMEX_CFL", "0.07"))
    # Velocity-solve preconditioner strength: plain Jacobi (f_iters=0) in
    # projection mode; the monolithic Yosida path needs the inner
    # 4-iteration GMRES smoother.
    f_iters = int(
        os.environ.get(
            "NS_BENCH_F_ITERS", "0" if stepper == "projection" else "4"
        )
    )

    import jax

    from navierstokes_project_nm4pde_tpu.utils.compile_cache import (
        enable_compile_cache,
    )
    from navierstokes_project_nm4pde_tpu.utils.device import (
        card_line,
        require_gpu,
    )

    device = require_gpu()
    card = card_line()
    enable_compile_cache()

    from navierstokes_project_nm4pde_tpu.config import (
        NumericsConfig,
        PrecondConfig,
        RunConfig,
        SolverConfig,
        TimeConfig,
    )
    from navierstokes_project_nm4pde_tpu.mesh import cylinder_duct_3d
    from navierstokes_project_nm4pde_tpu.models import (
        Cylinder3DProblem,
        NavierStokesSolver,
    )

    t0 = time.perf_counter()
    mesh = cylinder_duct_3d(lc=lc, nz=nz)
    cfg = RunConfig(
        time=TimeConfig(dt=2e-4, t_end=4.0, stepper=stepper, convection=conv_mode,
                        imex_umax=imex_umax, imex_cfl=imex_cfl),
        solver=SolverConfig(
            rtol=1e-6, restart=restart, maxiter=maxiter, tol_mode=tol_mode,
            # quadratic VELOCITY warm start (pressure increment stays
            # linear)
            guess_order=int(os.environ.get("NS_BENCH_GUESS", "2")),
            proj_div_cap=float(os.environ.get("NS_BENCH_PCAP", "0.1")),
        ),
        precond=PrecondConfig(
            kind=precond, f_iters=f_iters, f_corr_iters=f_corr,
            s_iters=s_iters, s_solver=s_solver, f_solver=f_solver,
            low_precision=lowp,
            # Recycled-block GCR velocity solve (PrecondConfig.f_recycle).
            f_recycle=int(
                os.environ.get("NS_BENCH_RECYCLE", "0")
            ) if f_iters == 0 else 0,
            # Frozen-Schur CG projection warm start: the recycled images
            # stay exact (S1 is setup-frozen), so this costs no S applies.
            s_recycle=int(os.environ.get("NS_BENCH_SRECYCLE", "1")),
            # Zero-extra-apply LS warm start of the velocity FGMRES
            # (PrecondConfig.f_warmstart).
            f_warmstart=int(os.environ.get("NS_BENCH_FWARM", "0")),
            # Skip the per-step diag(C) tabulation (its convection part is
            # near zero in the skew-symmetrised form).
            freeze_conv_diag=(
                os.environ.get("NS_BENCH_FREEZE_DIAG", "1") == "1"
                and f_iters == 0
            ),
            # additive two-level Schur: zero S SpMVs per preconditioner
            # application.
            mg2_form=os.environ.get("NS_BENCH_MG2", "additive"),
        ),
        numerics=NumericsConfig(
            dtype="float32", precise_dots=False, steps_per_chunk=chunk,
            reduce_plan=os.environ.get("NS_BENCH_REDUCE", "columns"),
            # "highest" (the config default) is the correctness-validated
            # setting; "default" / "high" expose reduced-precision
            # matmuls for A/B only.
            matmul_precision={
                "default": None, "high": "high", "highest": "highest",
            }[os.environ.get("NS_BENCH_PRECISION", "highest")],
            schur_agg=int(os.environ.get("NS_BENCH_SCHUR_AGG", "24")),
            element_contraction=os.environ.get("NS_BENCH_CONTRACT", "vpu"),
            proj_schur=os.environ.get("NS_BENCH_PROJ_SCHUR", "frozen"),
            gather_plan=os.environ.get("NS_BENCH_GATHER", "auto"),
            # "auto" = supernode BSR gradient / divergence (ops/bsr.py);
            # "ell" / "element" keep the older forms for A/B.
            grad_apply=os.environ.get("NS_BENCH_GRAD", "auto"),
            div_apply=os.environ.get("NS_BENCH_DIV", "auto"),
            bsr_block=int(os.environ.get("NS_BENCH_BSR_BLOCK", "32")),
            bsr_block_grad=int(os.environ.get("NS_BENCH_BSR_GRAD", "16")),
            # "auto" = macro-element block-dense F apply for the implicit
            # projection stepper (ops/macroblock.py); "element" keeps the
            # folded element pass for A/B.
            f_apply=os.environ.get("NS_BENCH_F_APPLY", "auto"),
            macro_cblk=int(os.environ.get("NS_BENCH_MACRO_CBLK", "20")),
            macro_u=int(os.environ.get("NS_BENCH_MACRO_U", "128")),
            # Macro value-assembly engine, rhs/r0 pass and step-gather
            # fusion (A/B hooks; "auto" follows config.py).
            macro_build=os.environ.get("NS_BENCH_MACRO_BUILD", "auto"),
            macro_rhs=os.environ.get("NS_BENCH_MACRO_RHS", "auto"),
            macro_wfuse=os.environ.get("NS_BENCH_MACRO_WFUSE", "auto"),
            macro_apply=os.environ.get("NS_BENCH_MACRO_APPLY", "auto"),
            macro_split=os.environ.get("NS_BENCH_MACRO_SPLIT", "auto"),
            macro_conv_build=os.environ.get(
                "NS_BENCH_MACRO_CONV_BUILD", "auto"
            ),
            coarse_solve=os.environ.get("NS_BENCH_COARSE_SOLVE", "chol"),
            # "auto" = block-banded dense SpMV when the RCM band fits
            # (frozen Schur only); "ell" forces the bucketed ELL form.
            schur_spmv=os.environ.get("NS_BENCH_SCHUR_SPMV", "auto"),
        ),
    )
    solver = NavierStokesSolver(mesh, Cylinder3DProblem(test_case=2), cfg)
    n_dofs = solver.space.n_dofs
    setup_s = time.perf_counter() - t0
    print(
        f"# mesh: {mesh.n_cells} cells, {n_dofs} DoFs; setup {setup_s:.1f}s",
        file=sys.stderr,
    )

    # Warm-up: compile + two chunks past the impulsive start (iteration
    # counts take ~6 steps to settle at >=600k DoF).
    t0 = time.perf_counter()
    warmup = int(os.environ.get("NS_BENCH_WARMUP", "8"))
    state, _ = solver.run(max(2 * chunk, warmup))
    if timed_chunk != chunk:
        import dataclasses as _dc

        solver.config = _dc.replace(
            solver.config,
            numerics=_dc.replace(
                solver.config.numerics, steps_per_chunk=timed_chunk
            ),
        )
        state, _ = solver.run(timed_chunk, state=state)
    warmup_s = time.perf_counter() - t0
    # solver.run brings every chunk's diagnostics to the host, so the
    # device has finished when it returns.
    t0 = time.perf_counter()
    state, diags = solver.run(n_steps, state=state)
    jax.block_until_ready(state.u)
    elapsed = time.perf_counter() - t0
    steps_per_sec = n_steps / elapsed
    print(
        f"# {n_steps} steps in {elapsed:.3f}s; F iters "
        f"{list(map(int, diags.iters_f))}; S {list(map(int, diags.iters_s))}",
        file=sys.stderr,
    )
    stats = jax.devices()[0].memory_stats() or {}

    print(f"# device: {json.dumps(device)}; card: {card}")
    print(
        json.dumps(
            {
                "metric": f"3D cylinder time steps/s at {n_dofs} DoF (GMRES rtol 1e-6)",
                "value": steps_per_sec,
                "unit": "steps/s",
                "ms_per_step": 1e3 * elapsed / n_steps,
                "iters_f_sum": int(diags.iters_f.sum()),
                "iters_s_sum": int(diags.iters_s.sum()),
                "setup_s": setup_s,
                "warmup_s": warmup_s,
                "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
                "device": device,
                "card": card,
            }
        )
    )


if __name__ == "__main__":
    measure()
