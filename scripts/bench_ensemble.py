"""Ensemble throughput refresh: B vmapped 3D cylinder members with the
single-run stack applied where it composes with vmap (frozen
projection Schur shared across members -- S~ is nu-independent -- plain
Jacobi velocity FGMRES, additive two-level Schur CG, columns reduce,
stacked gathers, fused rhs/r0, quadratic-u warm start, frozen conv diag).

run_ensemble prints the sustained member-steps/s itself (steps after the
compile chunk).  Env knobs: NS_ENS_B, NS_ENS_LC, NS_ENS_NZ, NS_ENS_STEPS,
NS_ENS_CHUNK, NS_ENS_MAXITER, NS_ENS_FROZEN.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main():
    B = int(os.environ.get("NS_ENS_B", "64"))
    lc = float(os.environ.get("NS_ENS_LC", "0.08"))
    nz = int(os.environ.get("NS_ENS_NZ", "6"))
    n_steps = int(os.environ.get("NS_ENS_STEPS", "96"))
    chunk = int(os.environ.get("NS_ENS_CHUNK", "8"))
    maxiter = int(os.environ.get("NS_ENS_MAXITER", "25"))
    frozen = os.environ.get("NS_ENS_FROZEN", "1") == "1"

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
    from navierstokes_project_nm4pde_tpu.parallel import run_ensemble

    mesh = cylinder_duct_3d(lc=lc, nz=nz)
    cfg = RunConfig(
        time=TimeConfig(dt=2e-4, t_end=4.0, stepper="projection"),
        solver=SolverConfig(rtol=1e-6, restart=8, maxiter=maxiter,
                            tol_mode="b", guess_order=2),
        precond=PrecondConfig(kind="yosida", f_iters=0, s_iters=3,
                              s_solver="mg2_cg", f_solver="gmres",
                              freeze_conv_diag=True, mg2_form="additive"),
        numerics=NumericsConfig(
            dtype="float32", precise_dots=False, steps_per_chunk=chunk,
            reduce_plan="columns", matmul_precision="highest",
            schur_agg=24, proj_schur="frozen" if frozen else "step",
            coarse_solve="chol", schur_spmv="auto",
        ),
    )
    problem = Cylinder3DProblem(test_case=2)
    solver = NavierStokesSolver(mesh, problem, cfg)
    print(f"# B={B}, {solver.space.n_dofs} DoFs/member, "
          f"{B * solver.space.n_dofs / 1e6:.1f}M aggregate, frozen={frozen}",
          file=sys.stderr)

    U = problem.mean_velocity(0.0) or 1.0
    re = np.linspace(20.0, 300.0, B)
    nus = abs(U) * problem.diameter / re
    bstate, bdiags = run_ensemble(solver, nus, n_steps)
    cd = np.asarray(bdiags.c_d)
    assert np.all(np.isfinite(cd)), "non-finite drag in ensemble"
    print(f"# c_d final range: [{cd[:, -1].min():.3f}, {cd[:, -1].max():.3f}]",
          file=sys.stderr)


if __name__ == "__main__":
    main()
