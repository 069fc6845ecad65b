"""DFG 3D-1Z validation run: steady inlet, Re=20, drag/lift/delta-p.

The reference's 3D executable hardcodes U_m=9 (Re=400, no published DFG
table applies); with u_m=0.45 the identical geometry/profile is the
published DFG 3D-1Z benchmark (Schaefer-Turek 1996, circular cylinder,
steady): mean U = 4 u_m / 9 = 0.2, Re = U D / nu = 20, and the flow
converges to a steady state with
  c_d in [6.05, 6.25],  c_l in [0.008, 0.010],  delta-p in [0.165, 0.175]
(coefficients normalised by frontal area D*H; probes at the cylinder
front/back (0.45, 0.2, 0.205) / (0.55, 0.2, 0.205) -- exactly this
model's probe points, models/cylinder3d.py).

Runs with an inlet start-up ramp (impulsive starts are convectively
harsh on refined meshes), steps to t_end, and reports the tail-window
mean and the residual drift so steadiness is checkable.

Usage:
  python scripts/dfg3d_validate.py --lc 0.05 --nz 10 --dt 4e-3 --t-end 3

Prints one JSON summary line and writes outputDFG/coeff_3d1z.csv.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

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


def ramped(base_g, t_ramp: float):
    def g(x, t):
        ramp = jnp.minimum(t / t_ramp, 1.0) if t_ramp > 0 else 1.0
        return ramp * base_g(x, t)

    return g


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--u-m", type=float, default=0.45, help="Re = 4 u_m/9 * D/nu")
    ap.add_argument("--lc", type=float, default=0.05)
    ap.add_argument("--nz", type=int, default=10)
    ap.add_argument("--dt", type=float, default=4e-3)
    ap.add_argument("--t-end", type=float, default=3.0)
    ap.add_argument("--t-ramp", type=float, default=0.5)
    ap.add_argument("--t-measure", type=float, default=None,
                    help="tail window start (default: last 20%%)")
    ap.add_argument("--scheme", default="bdf2")
    ap.add_argument("--chunk", type=int, default=25)
    ap.add_argument("--maxiter", type=int, default=60)
    ap.add_argument("--out-dir", default="outputDFG")
    args = ap.parse_args()

    problem = Cylinder3DProblem(test_case=2, u_m=args.u_m)
    dirichlet = dict(problem.dirichlet)
    dirichlet[0] = ramped(dirichlet[0], args.t_ramp)
    problem = dataclasses.replace(problem, dirichlet=dirichlet)

    t0 = time.time()
    mesh = cylinder_duct_3d(lc=args.lc, nz=args.nz)
    cfg = RunConfig(
        time=TimeConfig(dt=args.dt, t_end=args.t_end, scheme=args.scheme,
                        stepper="projection"),
        solver=SolverConfig(rtol=1e-6, maxiter=args.maxiter, tol_mode="b"),
        precond=PrecondConfig(kind="yosida", f_iters=0, s_iters=3,
                              s_solver="mg2_cg"),
        numerics=NumericsConfig(dtype="float32", precise_dots=False,
                                steps_per_chunk=args.chunk),
    )
    solver = NavierStokesSolver(mesh, problem, cfg)
    n_steps = int(round(args.t_end / args.dt))
    n_steps -= n_steps % args.chunk  # chunk-multiple (one compiled program)
    U = 4.0 * args.u_m / 9.0
    re = U * problem.diameter / problem.nu
    print(
        f"# 3D-1Z Re={re:.0f} mesh {mesh.n_cells} cells, "
        f"{solver.space.n_dofs} DoFs, {n_steps} steps; setup "
        f"{time.time() - t0:.0f}s; device {jax.devices()[0]}",
        file=sys.stderr, flush=True,
    )

    t0 = time.time()
    state, diags = solver.run(n_steps)
    jax.block_until_ready(state.u)
    wall = time.time() - t0

    t = (np.arange(n_steps) + 1) * args.dt
    cd = np.asarray(diags.c_d, np.float64)
    cl = np.asarray(diags.c_l, np.float64)
    dp = np.asarray(diags.delta_p, np.float64)
    os.makedirs(args.out_dir, exist_ok=True)
    csv = os.path.join(args.out_dir, "coeff_3d1z.csv")
    with open(csv, "w") as f:
        f.write("t,c_d,c_l,delta_p,iters\n")
        for i in range(n_steps):
            f.write(f"{t[i]:.6f},{cd[i]:.6f},{cl[i]:.6f},{dp[i]:.6f},"
                    f"{int(diags.iters[i])}\n")

    t_meas = args.t_measure if args.t_measure is not None else 0.8 * t[-1]
    w = t >= t_meas
    # steadiness: relative drift of c_d across the tail window
    drift = (cd[w][-1] - cd[w][0]) / np.mean(cd[w])
    summary = {
        "case": "DFG 3D-1Z (steady, circular cylinder)",
        "re": round(re, 2),
        "dofs": int(solver.space.n_dofs),
        "cells": int(mesh.n_cells),
        "dt": args.dt,
        "window": [float(t_meas), float(t[-1])],
        "cd": float(np.mean(cd[w])),
        "cl": float(np.mean(cl[w])),
        "delta_p": float(np.mean(dp[w])),
        "cd_drift_rel": float(drift),
        "published": {"cd": [6.05, 6.25], "cl": [0.008, 0.01],
                      "delta_p": [0.165, 0.175]},
        "steps_per_sec": round(n_steps / wall, 3),
        "iters_per_step_warm": float(np.mean(np.asarray(diags.iters)[w])),
    }
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
