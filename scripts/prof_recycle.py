"""A/B the recycled-block GCR velocity solve (PrecondConfig.f_recycle)
against the plain-Jacobi FGMRES path on the bench workload shape.

Convergence behaviour (iteration counts per step) is hardware-independent,
so run on CPU (JAX_PLATFORMS=cpu) at small scale first; the device win is
then (narrow rounds saved) x (macro apply cost) minus the wide round's
extra channel cost.

Usage: [JAX_PLATFORMS=cpu] python scripts/prof_recycle.py [lc] [nz] [steps]
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import dataclasses

import numpy as np


def main():
    lc = float(sys.argv[1]) if len(sys.argv) > 1 else 0.12
    nz = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    steps = int(sys.argv[3]) if len(sys.argv) > 3 else 24

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

    mesh = cylinder_duct_3d(lc=lc, nz=nz)
    chunk = int(os.environ.get("NS_CHUNK", "8"))

    def cfg(k):
        return RunConfig(
            time=TimeConfig(dt=2e-4, t_end=4.0, stepper="projection"),
            solver=SolverConfig(
                rtol=1e-6, restart=8, maxiter=60, tol_mode="b",
                guess_order=2, proj_div_cap=0.1,
            ),
            precond=PrecondConfig(
                kind="yosida", f_iters=0, s_iters=3, s_solver="mg2_cg",
                freeze_conv_diag=True, mg2_form="additive", f_recycle=k,
                s_recycle=(
                    int(os.environ.get("NS_SRECYCLE", "0")) if k else 0
                ),
            ),
            numerics=NumericsConfig(
                dtype="float32", precise_dots=False, steps_per_chunk=chunk,
                reduce_plan="columns",
            ),
        )

    out = {}
    for k in ([0] + [int(x) for x in os.environ.get(
            "NS_RECYCLE_KS", "4").split(",")]):
        t0 = time.time()
        solver = NavierStokesSolver(mesh, Cylinder3DProblem(test_case=2), cfg(k))
        state, diags = solver.run(steps)
        itf = np.asarray(diags.iters_f, int)
        its = np.asarray(diags.iters_s, int)
        res = np.asarray(diags.residual)
        out[k] = itf
        print(
            f"k={k}: F iters/step {itf.tolist()}\n"
            f"      S iters/step {its.tolist()}\n"
            f"      total F applies {itf.sum()}  max residual {res.max():.2e}"
            f"  wall {time.time() - t0:.0f}s",
            flush=True,
        )
        if k > 0:
            # sequential-apply accounting: recycled step pays 1 wide
            # (~1 narrow-equivalent) + (iters-1) narrow applies
            base = out[0].sum()
            print(
                f"      sequential-apply-equivalents {itf.sum()} vs "
                f"fgmres {base}  ({100 * (base - itf.sum()) / base:.0f}% fewer)"
            )


if __name__ == "__main__":
    main()
