"""Measure projection-stepper configurations on the accelerator.

Usage:  python scripts/exp_projection.py [lc] [nz]
Prints one JSON line per configuration: steps/s + iteration split.
"""
from __future__ import annotations

import json
import os
import sys
import time

# Same sys.path setup as running bench.py from the repo root.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

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

CONFIGS = [
    ("jacobi", dict(f_iters=0)),
    ("gmres4", dict(f_solver="gmres", f_iters=4)),
    ("cheb3", dict(f_solver="chebyshev", f_iters=3)),
    ("cheb5", dict(f_solver="chebyshev", f_iters=5)),
    ("rich3", dict(f_solver="richardson", f_iters=3)),
]


def main():
    lc = float(sys.argv[1]) if len(sys.argv) > 1 else 0.05
    nz = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    names = sys.argv[3].split(",") if len(sys.argv) > 3 else None
    mesh = cylinder_duct_3d(lc=lc, nz=nz)
    for name, pc in CONFIGS:
        if names and name not in names:
            continue
        cfg = RunConfig(
            time=TimeConfig(dt=2e-4, t_end=4.0, stepper="projection"),
            solver=SolverConfig(rtol=1e-6, restart=20, maxiter=40, tol_mode="b"),
            precond=PrecondConfig(kind="yosida", s_solver="mg2", **pc),
            numerics=NumericsConfig(
                dtype="float32", precise_dots=False, steps_per_chunk=2
            ),
        )
        t0 = time.time()
        solver = NavierStokesSolver(mesh, Cylinder3DProblem(test_case=2), cfg)
        n_dofs = solver.space.n_dofs
        state, _ = solver.run(8)  # compile + past the impulsive start
        setup_s = time.time() - t0
        t0 = time.perf_counter()
        state, diags = solver.run(10, state=state)
        jax.block_until_ready(state.u)
        el = time.perf_counter() - t0
        print(
            json.dumps(
                {
                    "config": name,
                    "dofs": n_dofs,
                    "steps_per_s": round(10 / el, 4),
                    "iters_f": list(map(int, diags.iters_f)),
                    "iters_s": list(map(int, diags.iters_s)),
                    "setup_s": round(setup_s, 1),
                }
            ),
            flush=True,
        )


if __name__ == "__main__":
    main()
