"""Command-line entry points mirroring the reference's three executables.

  cylinder2d   <->  navier_stokes2D (ref: src/main2D.cpp:4-63)
  cylinder3d   <->  navier_stokes3D (ref: src/main3D.cpp:4-79)
  convergence  <->  convergence     (ref: src/main_convergence3D.cpp:5-77)

Unlike the reference (all parameters compile-time constants, only the mesh
path on argv; ref: src/main2D.cpp:14-22), every physical/numerical knob is a
flag.  Meshes come from a `.msh` file (--mesh) or the built-in generators.

Outputs keep the reference's artifact set: per-step stdout progress,
gmres.csv, coeff_2.csv, forces CSV, VTU snapshots, and the convergence
table with log2 rates -- plus checkpoints, a wall-time summary, and a
Strouhal estimate (new).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def _build_config(args, defaults):
    from navierstokes_project_nm4pde_tpu.config import (
        NumericsConfig,
        PrecondConfig,
        RunConfig,
        SolverConfig,
        TimeConfig,
    )

    if getattr(args, "fast", False):
        # The benchmarked projection stack (bench.py defaults, but for
        # bench.py's s_recycle=1 and maxiter 60).  Overrides the individual
        # solver flags it touches.
        return RunConfig(
            time=TimeConfig(
                dt=args.dt, t_end=args.t_end,
                scheme=getattr(args, "scheme", "bdf1"),
                stepper="projection",
            ),
            solver=SolverConfig(
                rtol=args.rtol, restart=8, maxiter=args.maxiter,
                tol_mode="b", guess_order=2,
            ),
            precond=PrecondConfig(
                kind="yosida", f_iters=0, s_iters=3,
                f_solver="gmres", s_solver="mg2_cg",
                freeze_conv_diag=True, mg2_form="additive",
            ),
            numerics=NumericsConfig(
                dtype=args.dtype, precise_dots=False,
                steps_per_chunk=args.steps_per_chunk,
                reduce_plan="columns", proj_schur="frozen",
                coarse_solve="chol", schur_spmv="auto",
            ),
            test_case=args.test_case if hasattr(args, "test_case") else 2,
            output_dir=args.output_dir,
            output_every=args.output_every,
        )

    return RunConfig(
        time=TimeConfig(
            dt=args.dt, t_end=args.t_end,
            scheme=getattr(args, "scheme", "bdf1"),
            stepper=getattr(args, "stepper", "monolithic"),
        ),
        solver=SolverConfig(
            rtol=args.rtol, restart=args.restart, maxiter=args.maxiter,
            tol_mode=getattr(args, "tol_mode", "r0"),
        ),
        precond=PrecondConfig(
            kind=args.precond, f_iters=args.f_iters, s_iters=args.s_iters,
            f_solver=args.f_solver, s_solver=args.s_solver,
            alpha=0.5 if args.precond == "simple" else 1.0,
        ),
        numerics=NumericsConfig(
            dtype=args.dtype,
            precise_dots=not args.no_precise_dots,
            steps_per_chunk=args.steps_per_chunk,
        ),
        test_case=args.test_case if hasattr(args, "test_case") else 2,
        output_dir=args.output_dir,
        output_every=args.output_every,
    )


def _common_flags(p, dt, t_end, precond):
    p.add_argument("--mesh", type=str, default=None, help=".msh file (else built-in generator)")
    p.add_argument("--dt", type=float, default=dt)
    p.add_argument("--t-end", type=float, default=t_end)
    p.add_argument("--n-steps", type=int, default=None, help="override step count")
    p.add_argument("--precond", type=str, default=precond)
    p.add_argument("--scheme", type=str, default="bdf1", choices=["bdf1", "bdf2"],
                   help="time scheme (bdf2: live second-order variant)")
    p.add_argument("--stepper", type=str, default="monolithic",
                   choices=["monolithic", "projection"],
                   help="monolithic saddle-point solve (reference parity) or "
                        "incremental pressure-correction splitting (faster)")
    p.add_argument("--fast", action="store_true",
                   help="use the benchmarked projection stack (frozen banded "
                        "Schur + additive two-level CG, plain-Jacobi FGMRES, "
                        "quadratic warm start, rtol vs ||b||); overrides "
                        "--stepper/--precond/--restart/--f-iters/--s-iters/"
                        "--f-solver/--s-solver/--tol-mode")
    p.add_argument("--rtol", type=float, default=1e-6)
    p.add_argument("--tol-mode", type=str, default="r0",
                   choices=["r0", "b", "abs"],
                   help="stopping criterion: relative to the warm-start "
                        "residual (r0, reference-like), to ||rhs|| (b, the "
                        "scipy/PETSc convention), or absolute")
    p.add_argument("--restart", type=int, default=50)
    p.add_argument("--maxiter", type=int, default=200)
    p.add_argument("--f-iters", type=int, default=6)
    p.add_argument("--s-iters", type=int, default=30)
    p.add_argument("--f-solver", type=str, default="gmres",
                   choices=["gmres", "richardson", "chebyshev", "pmg"])
    p.add_argument("--s-solver", type=str, default="cg",
                   choices=["cg", "chebyshev", "mg2", "mg2_cg", "spai", "spai_cg"])
    p.add_argument("--dtype", type=str, default="float32")
    p.add_argument("--nu", type=float, default=None, help="kinematic viscosity override (Re sweeps)")
    p.add_argument("--debug-nans", action="store_true", help="enable jax.debug_nans")
    p.add_argument("--no-precise-dots", action="store_true")
    p.add_argument("--steps-per-chunk", type=int, default=10)
    p.add_argument("--output-dir", type=str, default=None)
    p.add_argument("--output-every", type=int, default=0, help="VTU cadence (0=off)")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", type=str, default=None, help="checkpoint to resume from")
    p.add_argument("--shard-cells", type=int, default=0,
                   help="shard the element batch over N devices (domain "
                        "decomposition; 0 = single device).  VTU snapshots "
                        "gain the reference's `partitioning` subdomain field "
                        "(ref: src/NavierStokes2D.cpp:662-665)")


def _run_cylinder(args, dim: int):
    import jax.numpy as jnp

    from navierstokes_project_nm4pde_tpu.io import CSVLogger, save_checkpoint, write_pvd, write_vtu
    from navierstokes_project_nm4pde_tpu.io.checkpoint import load_checkpoint
    from navierstokes_project_nm4pde_tpu.mesh import (
        cylinder_channel_2d,
        cylinder_duct_3d,
        read_msh,
    )
    from navierstokes_project_nm4pde_tpu.models import (
        Cylinder2DProblem,
        Cylinder3DProblem,
        NavierStokesSolver,
    )
    from navierstokes_project_nm4pde_tpu.utils import Timer, strouhal_number

    t_total = Timer(sync=False).start()
    if args.mesh:
        mesh = read_msh(args.mesh)
    elif dim == 2:
        mesh = cylinder_channel_2d(lc=args.lc)
    else:
        mesh = cylinder_duct_3d(lc=args.lc, nz=args.nz)
    print(f"Mesh: {mesh.n_cells} cells, {mesh.n_vertices} vertices")

    if args.debug_nans:
        import jax

        jax.config.update("jax_debug_nans", True)
    nu_kw = {} if args.nu is None else {"nu": args.nu}
    if getattr(args, "u_m", None) is not None:
        nu_kw["u_m"] = args.u_m
    problem = (
        Cylinder2DProblem(test_case=args.test_case, **nu_kw)
        if dim == 2
        else Cylinder3DProblem(test_case=args.test_case, **nu_kw)
    )
    cfg = _build_config(args, None)
    solver = NavierStokesSolver(mesh, problem, cfg)
    sp = solver.space
    print(
        f"DoFs: velocity={sp.n_udofs} pressure={sp.n_pnodes} total={sp.n_dofs}"
    )

    cell_part = None
    if getattr(args, "shard_cells", 0):
        from navierstokes_project_nm4pde_tpu.parallel import (
            cell_partitioning,
            make_device_mesh,
            shard_solver,
        )

        dev_mesh = make_device_mesh(args.shard_cells)
        shard_solver(solver, dev_mesh)
        cell_part = cell_partitioning(solver, dev_mesh)
        print(f"Sharded cells over {dev_mesh.devices.size} devices")

    out_dir = args.output_dir or f"output{dim}D"
    log = CSVLogger(out_dir)
    vtu_entries = []

    state = (
        load_checkpoint(args.resume, dtype=jnp.dtype(args.dtype))
        if args.resume
        else solver.initial_state()
    )
    n_steps = args.n_steps or cfg.time.n_steps
    # 3D: output every 20 steps like the reference (src/NavierStokes3D.cpp:734)
    out_every = args.output_every or 0

    cd_max, cl_min = -np.inf, np.inf
    done = {"n": int(state.step)}

    # True mean inlet velocity U(t) in pure numpy: the telemetry callback
    # runs per chunk, and evaluating the (jnp) problem.mean_velocity per
    # step would cost one eager device op each -- 20k extra round-trips on
    # the 3D default run.  (The reference's gmres.csv Re
    # column hardcodes 0.1*1.5*sin(t pi/8)/1e-3 regardless of case and
    # viscosity, src/NavierStokes2D.cpp:622; this generalises it to the
    # run's actual inlet profile and nu.)
    # `is not None` (a truthiness test would treat an explicit --u-m 0 as
    # unset)
    u_m_def = 1.5 if dim == 2 else 9.0
    u_m2 = args.u_m if getattr(args, "u_m", None) is not None else u_m_def
    # 2D mean = 2 u_m / 3; 3D mean = 4 u_m / 9 (cylinder3d.py)
    base_mean = 2.0 * u_m2 / 3.0 if dim == 2 else 4.0 * u_m2 / 9.0
    ramped = (dim == 2 and args.test_case == 2) or (
        dim == 3 and args.test_case == 3
    )

    def inlet_mean_np(t):
        t = np.asarray(t, dtype=float)
        if args.test_case == 1:
            return np.zeros_like(t)
        # always array-valued: scalar returns broke the Re column's
        # .astype on non-ramped cases (3D case 2, the reference default)
        f = np.sin(np.pi * t / 8.0) if ramped else np.ones_like(t)
        return base_mean * f

    # Per-step wall-time columns (the reference logs time_prec/time_solve
    # per step, ref: src/main2D.cpp:50-58).  Steps run fused inside one
    # jitted chunk here, so: `time solve` = measured chunk wall / steps
    # (includes the fused per-step preconditioner assembly); `time prec`
    # carries the ONE-TIME preconditioner/solver setup on the first row
    # and 0 after (this engine builds its Schur/coarse structures once at
    # setup instead of re-initialising every step).
    now0 = time.perf_counter()
    setup_s = now0 - t_total._t0
    clock = {"last": now0, "setup": setup_s}
    chunk_s = []  # host wall seconds per chunk (the first includes compile)

    def callback(solver, state, diags):
        nonlocal cd_max, cl_min
        now = time.perf_counter()
        chunk_wall, clock["last"] = now - clock["last"], now
        k = len(diags.iters)
        chunk_s.append(chunk_wall)
        steps = np.arange(done["n"] + 1, done["n"] + k + 1)
        times = steps * cfg.time.dt
        done["n"] += k
        # Re(t) = U_mean(t) D / nu (see inlet_mean_np above)
        re = (problem.diameter * inlet_mean_np(times) / problem.nu).astype(int)
        log.log_gmres(times, re, diags.iters)
        log.log_coefficients(steps, diags.c_d, diags.c_l)
        t_prec = np.zeros(k)
        if clock["setup"] is not None:
            t_prec[0], clock["setup"] = clock["setup"], None
        log.log_forces(
            f"forces_results_{dim}D_{args.test_case}case.csv",
            times, diags.drag, diags.lift, diags.c_d, diags.c_l,
            t_prec=t_prec, t_solve=np.full(k, chunk_wall / k),
        )
        # force extrema; 3D gates accumulation until t > 0.1
        # (ref: src/NavierStokes3D.cpp:728-733)
        sel = times > 0.1 if dim == 3 else slice(None)
        if np.any(times > 0.1) or dim == 2:
            cd_max = max(cd_max, np.max(diags.c_d[sel]))
            cl_min = min(cl_min, np.min(diags.c_l[sel]))
        it, res = diags.iters[-1], diags.residual[-1]
        print(
            f"n = {done['n']:4d}, t = {times[-1]:.4f}: {it} GMRES iters, "
            f"residual {res:.3e}, c_d {diags.c_d[-1]:.4f}, c_l {diags.c_l[-1]:.4f}"
        )
        if out_every and (done["n"] % out_every == 0 or done["n"] >= n_steps):
            if cell_part is not None:
                # Sharded runs write the reference's multi-file parallel
                # record: piece .vtu files per subdomain + a .pvtu master
                # (ref: src/NavierStokes2D.cpp:669-675).
                from navierstokes_project_nm4pde_tpu.io import (
                    write_vtu_with_pvtu_record,
                )

                path = write_vtu_with_pvtu_record(
                    out_dir, f"solution_{done['n']:06d}", solver.space,
                    np.asarray(state.u), np.asarray(state.p),
                    partitioning=cell_part,
                )
            else:
                path = os.path.join(out_dir, f"solution_{done['n']:06d}.vtu")
                write_vtu(
                    path, solver.space, np.asarray(state.u),
                    np.asarray(state.p), partitioning=cell_part,
                )
            vtu_entries.append((float(state.t), path))
        if args.checkpoint_every and done["n"] % args.checkpoint_every == 0:
            save_checkpoint(os.path.join(out_dir, "checkpoint.npz"), state)

    state, diags = solver.run(n_steps - int(state.step), state=state, callback=callback)

    if vtu_entries:
        write_pvd(os.path.join(out_dir, "solution.pvd"), vtu_entries)
    save_checkpoint(os.path.join(out_dir, "final.npz"), state)

    print("=" * 47)
    print(f"Drag Coefficient Max ----->   {cd_max}")
    print(f"Lift Coefficient Min ----->   {cl_min}")
    print(f"Pressure difference (P(A) - P(B)) = {diags.delta_p[-1]}")
    # characteristic velocity for St: the run's peak mean inlet velocity
    t_grid = np.arange(1, n_steps + 1) * cfg.time.dt
    U_char = float(np.max(np.abs(inlet_mean_np(t_grid))))
    st = strouhal_number(
        diags.c_l, cfg.time.dt, diameter=problem.diameter,
        velocity=U_char or 1.0,
    )
    print(f"Strouhal number (from c_l) = {st:.4f}")
    print(f"Total wall time: {t_total.stop():.2f} s")
    return {
        "solver": solver, "state": state, "diags": diags,
        "setup_s": setup_s, "chunk_s": chunk_s,
    }


def _run_convergence(args):
    from navierstokes_project_nm4pde_tpu.io import CSVLogger
    from navierstokes_project_nm4pde_tpu.mesh import cube_mesh
    from navierstokes_project_nm4pde_tpu.models import (
        EthierSteinmanProblem,
        NavierStokesSolver,
    )
    from navierstokes_project_nm4pde_tpu.models.ethier_steinman import (
        exact_velocity,
        exact_velocity_gradient,
    )
    from navierstokes_project_nm4pde_tpu.ops.functionals import (
        build_error_tables,
        velocity_error_norms,
    )
    from navierstokes_project_nm4pde_tpu.utils import ConvergenceTable, Timer

    timer = Timer(sync=False).start()
    table = ConvergenceTable()
    out_dir = args.output_dir or "outputConvergence"
    log = CSVLogger(out_dir)
    hs, l2s, h1s = [], [], []
    # mesh ladder: n subdivisions of [-1,1]^3 -> h = 2/n
    for n in args.levels:
        mesh = cube_mesh(n)
        solver = NavierStokesSolver(mesh, EthierSteinmanProblem(), _build_config(args, None))
        n_steps = args.n_steps or max(1, solver.config.time.n_steps)
        state, diags = solver.run(n_steps)
        et = build_error_tables(solver.space, solver.geom, degree=5,
                                dtype=np.dtype(args.dtype))
        l2, h1 = velocity_error_norms(
            et, state.u, exact_velocity, exact_velocity_gradient, float(state.t)
        )
        h = 2.0 / n
        print(
            f"h={h:.3f}: cells={mesh.n_cells} dofs={solver.space.n_dofs} "
            f"L2={float(l2):.6e} H1={float(h1):.6e} iters={list(diags.iters)}"
        )
        hs.append(h)
        l2s.append(float(l2))
        h1s.append(float(h1))
        table.add_row(h, L2=float(l2), H1=float(h1))
    log.log_convergence(hs, l2s, h1s)
    print(table.format())
    print(f"Time taken to solve ENTIRE Navier Stokes problem: {timer.stop():.2f} s")
    return table


def _run_ensemble(args):
    """Vmapped Reynolds sweep (BASELINE.json config 5: '64 vmapped 3D
    cylinder runs over Re in [20, 300]') -- a capability the reference can
    only emulate with separate mpirun launches."""
    import numpy as np

    from navierstokes_project_nm4pde_tpu.io import CSVLogger
    from navierstokes_project_nm4pde_tpu.mesh import (
        cylinder_channel_2d,
        cylinder_duct_3d,
        read_msh,
    )
    from navierstokes_project_nm4pde_tpu.models import (
        Cylinder2DProblem,
        Cylinder3DProblem,
        NavierStokesSolver,
    )
    from navierstokes_project_nm4pde_tpu.parallel import run_ensemble
    from navierstokes_project_nm4pde_tpu.utils import Timer

    timer = Timer(sync=False).start()
    if args.mesh:
        mesh = read_msh(args.mesh)
    elif args.dim == 2:
        mesh = cylinder_channel_2d(lc=args.lc)
    else:
        mesh = cylinder_duct_3d(lc=args.lc, nz=args.nz)
    problem = (
        Cylinder2DProblem(test_case=args.test_case)
        if args.dim == 2
        else Cylinder3DProblem(test_case=args.test_case)
    )
    cfg = _build_config(args, None)
    solver = NavierStokesSolver(mesh, problem, cfg)

    # Re = U_mean * D / nu; characteristic U = the profile's peak mean
    # velocity over a ramp period (steady profiles are constant in t)
    t_grid = np.linspace(0.0, max(8.0, args.t_end), 65)
    U = float(np.max(np.abs([problem.mean_velocity(t) for t in t_grid]))) or 1.0
    re = np.linspace(args.re_min, args.re_max, args.n_members)
    nus = U * problem.diameter / re
    print(f"Ensemble: {args.n_members} members, Re in [{re[0]:.0f}, {re[-1]:.0f}], "
          f"{mesh.n_cells} cells, {solver.space.n_dofs} DoFs each")

    sharding = None
    if args.shard_batch:
        import jax
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        devs = jax.devices()
        n = max(1, len(devs))
        b = args.n_members
        nshard = n if b % n == 0 else 1
        sharding = NamedSharding(
            Mesh(np.array(devs[:nshard]), ("batch",)), P("batch")
        )

    n_steps = args.n_steps or cfg.time.n_steps
    bstate, bdiags = run_ensemble(solver, nus, n_steps, sharding=sharding)
    out_dir = args.output_dir or "outputEnsemble"
    log = CSVLogger(out_dir)
    rows = []
    for m in range(args.n_members):
        cd = bdiags.c_d[m]
        cl = bdiags.c_l[m]
        rows.append((re[m], nus[m], float(np.max(cd)), float(np.min(cl)),
                     float(bdiags.delta_p[m][-1])))
    log.log_table(
        "ensemble.csv", "Re,nu,cd_max,cl_min,delta_p_final", rows
    )
    print(f"Wrote {out_dir}/ensemble.csv; wall time {timer.stop():.1f}s")
    return {"solver": solver, "state": bstate, "diags": bdiags, "nus": nus}


def main(argv=None):
    """Parse `argv` and run one subcommand; returns its result (a summary
    dict for cylinder2d/cylinder3d/ensemble, the ConvergenceTable for
    convergence) so the same entry point can be driven in-process."""
    from navierstokes_project_nm4pde_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    parser = argparse.ArgumentParser(
        prog="navierstokes-tpu",
        description="Incompressible Navier-Stokes FEM benchmarks (JAX)",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p2 = sub.add_parser("cylinder2d", help="DFG 2D flow past a cylinder")
    _common_flags(p2, dt=0.01, t_end=8.0, precond="asimple")
    p2.add_argument("--lc", type=float, default=0.05)
    p2.add_argument("--test-case", type=int, default=2,
                    help="1-3: reference cases; 4: steady inlet with correct "
                         "constant mean (DFG 2D-2 validation)")
    p2.add_argument("--u-m", type=float, default=None,
                    help="peak inlet velocity (Re = (2/3) u_m D / nu); "
                         "default 1.5 (Re=100); 3.0 gives Re=200.  Note: "
                         "the gmres.csv Re column and the Strouhal U use "
                         "the run's TRUE time-dependent inlet mean, which "
                         "for case 3 differs from the reference's "
                         "hardcoded case-2 formula "
                         "(ref: src/NavierStokes2D.cpp:622)")

    p3 = sub.add_parser("cylinder3d", help="DFG 3D flow past a cylinder")
    p3.add_argument("--u-m", type=float, default=None,
                    help="peak inlet velocity; default 9.0 (the reference's "
                         "hardcoded value, Re=400); 0.45 gives the published "
                         "DFG 3D-1Z steady case at Re=20")
    _common_flags(p3, dt=2e-4, t_end=4.0, precond="yosida")
    p3.add_argument("--lc", type=float, default=0.05)
    p3.add_argument("--nz", type=int, default=8)
    p3.add_argument("--test-case", type=int, default=2)

    pe = sub.add_parser("ensemble", help="vmapped Reynolds-sweep ensemble")
    _common_flags(pe, dt=0.01, t_end=0.5, precond="asimple")
    pe.add_argument("--dim", type=int, default=3, choices=[2, 3])
    pe.add_argument("--lc", type=float, default=0.08)
    pe.add_argument("--nz", type=int, default=4)
    pe.add_argument("--test-case", type=int, default=2)
    pe.add_argument("--n-members", type=int, default=64)
    pe.add_argument("--re-min", type=float, default=20.0)
    pe.add_argument("--re-max", type=float, default=300.0)
    pe.add_argument("--shard-batch", action="store_true",
                    help="shard the ensemble axis over available devices")

    pc = sub.add_parser("convergence", help="Ethier-Steinman convergence study")
    _common_flags(pc, dt=4e-4, t_end=4e-4, precond="asimple")
    pc.add_argument("--levels", type=int, nargs="+", default=[2, 4, 8, 16],
                    help="cube subdivisions (h = 2/n)")
    pc.set_defaults(test_case=2, dtype="float32")

    args = parser.parse_args(argv)
    enable_compile_cache()
    if getattr(args, "dtype", "float32") == "float64":
        import jax

        jax.config.update("jax_enable_x64", True)
    if args.cmd == "cylinder2d":
        return _run_cylinder(args, dim=2)
    if args.cmd == "cylinder3d":
        return _run_cylinder(args, dim=3)
    if args.cmd == "convergence":
        return _run_convergence(args)
    return _run_ensemble(args)


if __name__ == "__main__":
    main()
