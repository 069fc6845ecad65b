"""Cost of the per-step diagnostics on the accelerator.

Every step computes forces, delta-p, the divergence norm, and kinetic
energy (StepDiagnostics) -- the last two are full element passes.  This
times warm chunked steps with the real diagnostics vs a stub, same
solver config, separate solver instances (each owns its compiled chunk
runner).

Usage: python scripts/prof_step_diag.py [lc] [nz] [steps]
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

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
from navierstokes_project_nm4pde_tpu.models.base import StepDiagnostics


def build(mesh, stub: bool, maxiter: int = 40):
    cfg = RunConfig(
        time=TimeConfig(dt=2e-4, t_end=4.0, stepper="projection"),
        solver=SolverConfig(rtol=1e-6, maxiter=maxiter, tol_mode="b",
                            restart=20),
        precond=PrecondConfig(kind="yosida", f_iters=0, s_iters=3,
                              s_solver="mg2_cg"),
        numerics=NumericsConfig(steps_per_chunk=2, precise_dots=False),
    )
    s = NavierStokesSolver(mesh, Cylinder3DProblem(test_case=2), cfg)
    if stub:
        z = lambda: jnp.asarray(0.0, s.dtype)  # noqa: E731

        def cheap_diag(u, p, t, info, nu=None, dev=None,
                       iters_f=None, iters_s=None):
            return StepDiagnostics(
                iters=info.iters, residual=info.residual,
                drag=z(), lift=z(), c_d=z(), c_l=z(), delta_p=z(),
                iters_f=info.iters, iters_s=info.iters,
            )

        s._diagnostics = cheap_diag
    return s


def main():
    lc = float(sys.argv[1]) if len(sys.argv) > 1 else 0.028
    nz = int(sys.argv[2]) if len(sys.argv) > 2 else 12
    n_steps = int(sys.argv[3]) if len(sys.argv) > 3 else 10
    mesh = cylinder_duct_3d(lc=lc, nz=nz)
    out = {}
    for name, stub, mi in (
        ("full", False, 40),
        ("stub_diag", True, 40),
        ("maxiter1", False, 1),
        ("maxiter5", False, 5),
    ):
        s = build(mesh, stub, mi)
        state, _ = s.run(8)  # compile + past the impulsive start
        t0 = time.perf_counter()
        state, d = s.run(n_steps, state=state)
        jax.block_until_ready(state.u)
        el = time.perf_counter() - t0
        out[name] = round(n_steps / el, 4)
        fi = [int(i) for i in d.iters_f] if d.iters_f is not None else None
        si = [int(i) for i in d.iters_s] if d.iters_s is not None else None
        print(f"# {name}: {out[name]} steps/s; iters_f {fi} iters_s {si}",
              file=sys.stderr, flush=True)
    import json

    out["dofs"] = s.space.n_dofs
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
