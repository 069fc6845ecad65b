"""Smoke test of the engine on NVIDIA GPUs: the main path at full size,
checked against the plain references.

    python chip_smoke.py              # one card: phases a-e below
    python chip_smoke.py --four-gpus  # four cards: the sharded paths only

One card (every phase runs in this one process; nothing else opens the
card):

  a. device -- the card's `nvidia-smi` name and power limit; fails unless
     JAX's default backend is a GPU.
  b. main path -- `cylinder3d --fast` at 965,265 DoF through the CLI's
     main(): compile + two warm-up chunks + 80 timed steps.  Every step
     must have finite c_d / c_l / delta-p and F and S Krylov counts below
     maxiter (so both solves met rtol 1e-6 vs ||b||).  Reports setup and
     compile seconds (cold cache, then warm), steps/s, ms/step, the F/S
     iteration sums and peak device memory.
  c. card vs plain reference at 965k, float32, matmul precision "highest":
     the macro F apply, the production element apply, the BSR divergence
     and gradient against the element passes with scatter-add assembly
     (relative max-norm <= REL_MAX_BOUND); the one-hot slot expansion and
     the windowed gather against a plain gather (bit-exact); the banded
     Schur SpMV against the ELL form (<= REL_MAX_BOUND).  Then the same
     20 steps of the 47k mesh on the GPU and on the in-process CPU backend
     (u, p relative L2 <= TRAJ_REL_L2; F/S counts within ITER_SLACK).
  d. ensemble -- B=64 vmapped members at 47k DoF each, two chunks; two
     members against the same members stepped alone (TRAJ_REL_L2,
     ITER_SLACK).  Also times the vmapped velocity reduce at B=16/64.
  e. the float64 Ethier-Steinman ladder (convergence --dt 4e-4 --n-steps 1
     --levels 4 8 16 --rtol 1e-9): L2 order ~3, H1 order ~2, errors equal
     to the recorded CPU values (VALIDATION.md) to 3 significant digits.

Four cards (--four-gpus): `cylinder3d --shard-cells 4` at 965k and the
owned+halo HaloProjectionStep on a 4-device mesh, each against the same
step on one card and against the single-card production step (another
operator form; BIG_REL_L2, BIG_ITER_SLACK), and `ensemble --shard-batch`
B=64 against the unsharded ensemble (TRAJ_REL_L2, ITER_SLACK); every
sharded result must span all four cards.

Any failure raises (non-zero exit).  Numbers go to earlier lines, each
beside the card's name and power limit, and to output_smoke/results.json;
the last line of stdout is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from functools import partial

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "output_smoke")  # CLI outputs + results.json

# 965,265 DoF: the benchmark's DFG duct (bench.py defaults).
MAIN_MESH = {"lc": 0.024, "nz": 14}
# ~47k DoF: scripts/bench_ensemble.py's member mesh.
SMALL_MESH = {"lc": 0.08, "nz": 6}
MAXITER = 60

# Card vs plain reference, relative max-norm, float32 under "highest":
# both sides compute the same sums in another order.
REL_MAX_BOUND = 1e-5
# u, p after 20 steps of the 47k mesh, relative L2: each step solves to
# rtol 1e-6 vs ||b|| in f32 Krylov with another summation order.
TRAJ_REL_L2 = 1e-4
ITER_SLACK = 1  # F / S Krylov counts per step
# The same 20 steps at 965k drift further apart under ANY change of
# summation order: each step solves only to rtol 1e-6 vs ||b||, and the
# pressure CG may stop at 0.1 ||rhs_p||, so one flipped Schur count moves
# p by that solve's remaining error.  On one H100, the same step through
# two operator forms with equal values (macro / BSR vs element passes with
# scatter-add) differs by u 1.07e-4, p 5.9e-3 (relative L2) and 2 Schur
# iterations after 20 steps; 965k comparisons are held to ~3x that.
BIG_REL_L2 = {"u": 3e-4, "p": 2e-2}
BIG_ITER_SLACK = 3
# Ethier-Steinman f64 ladder, h = 0.5 / 0.25 / 0.125 (VALIDATION.md).
ES_REFERENCE = {
    4: (3.0910e-02, 5.2529e-01),
    8: (3.8997e-03, 1.3199e-01),
    16: (4.9968e-04, 3.3785e-02),
}
ES_ORDER_SLACK = 0.1  # |order - 3| (L2), |order - 2| (H1)


class SmokeFailure(AssertionError):
    pass


def check(ok, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def result_line(device: dict) -> str:
    """The last line of stdout."""
    return json.dumps({
        "ok": True,
        "device": {
            "platform": device["platform"],
            "kind": device["kind"],
            "count": device["count"],
        },
    })


def rel_max(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def time_ms(fn, *args, reps: int = 20) -> float:
    """Mean device time of fn(*args) in ms (warm, each call waited for)."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(fn(*args))
    return 1e3 * (time.perf_counter() - t0) / reps


class Report:
    """Prints each result beside the card and keeps it for results.json."""

    def __init__(self, card: str):
        self.card = card.replace("\n", "; ")
        self.results = {"card": self.card}

    def line(self, name: str, **values) -> None:
        self.results[name] = values
        body = ", ".join(f"{k}={v}" for k, v in values.items())
        print(f"[{self.card}] {name}: {body}", flush=True)

    def save(self) -> None:
        os.makedirs(OUT, exist_ok=True)
        with open(os.path.join(OUT, "results.json"), "w") as f:
            json.dump(self.results, f, indent=1, default=str)


class CompileClock:
    """Sums JAX's trace / lower / backend-compile durations."""

    def __init__(self):
        import jax

        self.events = []  # (event, fun_name, seconds)
        jax.monitoring.register_event_duration_secs_listener(self)

    def __call__(self, event, duration, **kwargs):
        if event.startswith("/jax/core/compile/"):
            self.events.append((event, kwargs.get("fun_name", ""), duration))

    def mark(self) -> int:
        return len(self.events)

    def seconds(self, since: int = 0, fun: str | None = None) -> float:
        return sum(
            s for (_, f, s) in self.events[since:]
            if fun is None or fun in str(f)
        )


def _cli(argv):
    from navierstokes_project_nm4pde_tpu import cli

    return cli.main(argv)


def _cylinder_argv(mesh, n_steps, chunk, out, extra=()):
    return [
        "cylinder3d", "--fast", "--lc", str(mesh["lc"]), "--nz",
        str(mesh["nz"]), "--n-steps", str(n_steps), "--steps-per-chunk",
        str(chunk), "--maxiter", str(MAXITER), "--output-dir",
        os.path.join(OUT, out), *extra,
    ]


def _ensemble_argv(mesh, members, n_steps, chunk, out, extra=()):
    return [
        "ensemble", "--fast", "--dt", "2e-4", "--lc", str(mesh["lc"]),
        "--nz", str(mesh["nz"]), "--n-members", str(members), "--n-steps",
        str(n_steps), "--steps-per-chunk", str(chunk), "--maxiter",
        str(MAXITER), "--output-dir", os.path.join(OUT, out), *extra,
    ]


def check_steps(diags, what: str) -> None:
    """Finite coefficients and residuals; both solves below maxiter."""
    for name in ("c_d", "c_l", "delta_p", "residual"):
        check(
            np.all(np.isfinite(np.asarray(getattr(diags, name)))),
            f"{what}: non-finite {name}",
        )
    for name in ("iters_f", "iters_s"):
        it = np.asarray(getattr(diags, name))
        check(
            np.all(it < MAXITER),
            f"{what}: {name} reached maxiter={MAXITER} ({it.max()})",
        )


def compare_runs(rep, name, u, p, u_ref, p_ref, it, it_ref,
                 bound_u=TRAJ_REL_L2, bound_p=TRAJ_REL_L2,
                 iter_slack=ITER_SLACK) -> None:
    """Trajectory agreement: u, p relative L2 and per-step F/S counts."""
    du, dp = rel_l2(u, u_ref), rel_l2(p, p_ref)
    dit = int(np.max(np.abs(np.asarray(it) - np.asarray(it_ref))))
    rep.line(name, u_rel_l2=du, p_rel_l2=dp, max_iter_diff=dit,
             bounds=[bound_u, bound_p, iter_slack])
    check(du <= bound_u, f"{name}: u rel L2 {du:.3e} > {bound_u}")
    check(dp <= bound_p, f"{name}: p rel L2 {dp:.3e} > {bound_p}")
    check(dit <= iter_slack, f"{name}: F/S counts differ by {dit}")


def compare_965k(rep, name, *args) -> None:
    """compare_runs for two 965k trajectories (BIG_* bounds)."""
    compare_runs(rep, name, *args, bound_u=BIG_REL_L2["u"],
                 bound_p=BIG_REL_L2["p"], iter_slack=BIG_ITER_SLACK)


def _fs(diags):
    return np.stack([np.asarray(diags.iters_f), np.asarray(diags.iters_s)])


# ----------------------------------------------------------------------
# a. device
# ----------------------------------------------------------------------
def phase_device() -> tuple[dict, str]:
    """(device_info, nvidia-smi line); raises unless the backend is a GPU."""
    from navierstokes_project_nm4pde_tpu.utils.device import (
        card_line,
        require_gpu,
    )

    device = require_gpu()
    card = card_line()
    print(card, flush=True)
    return device, card


# ----------------------------------------------------------------------
# b. the 965k main path through the CLI
# ----------------------------------------------------------------------
def phase_main_path(rep, clock, mesh=MAIN_MESH, chunk=40, n_chunks=4):
    """Compile + 2 warm-up chunks, then (n_chunks - 2) * chunk timed steps."""
    import jax

    from navierstokes_project_nm4pde_tpu.utils.compile_cache import (
        compile_cache_dir,
    )

    cache = compile_cache_dir()
    cached = len(os.listdir(cache)) if os.path.isdir(cache) else 0
    mark = clock.mark()
    t0 = time.perf_counter()
    res = _cli(_cylinder_argv(mesh, chunk * n_chunks, chunk, "cylinder3d"))
    wall = time.perf_counter() - t0
    solver, state, diags = res["solver"], res["state"], res["diags"]
    check_steps(diags, "main path")
    timed = res["chunk_s"][2:]
    check(len(timed) >= 1, "main path: no timed chunk")
    timed_steps = chunk * len(timed)
    elapsed = sum(timed)
    compile_cold = clock.seconds(mark)
    chunk_cold = clock.seconds(mark, fun="run_chunk")

    # Warm cache: drop the in-memory executables and compile the chunk
    # program again -- JAX now finds it in the persistent cache.
    jax.clear_caches()
    t1 = time.perf_counter()
    solver._run_chunk.lower(solver._dev, state, k=chunk).compile()
    chunk_warm = time.perf_counter() - t1

    stats = jax.devices()[0].memory_stats() or {}
    tf = np.asarray(diags.iters_f)[-timed_steps:]
    ts = np.asarray(diags.iters_s)[-timed_steps:]
    rep.line(
        "main_path_965k",
        n_dofs=solver.space.n_dofs,
        setup_s=res["setup_s"],
        compile_s_cold_all_programs=compile_cold,
        compile_s_cold_chunk=chunk_cold,
        compile_s_warm_chunk=chunk_warm,
        cache_entries_at_start=cached,
        first_chunk_s=res["chunk_s"][0],
        timed_steps=timed_steps,
        steps_per_s=timed_steps / elapsed,
        ms_per_step=1e3 * elapsed / timed_steps,
        iters_f_sum=int(tf.sum()),
        iters_s_sum=int(ts.sum()),
        iters_f_range=[int(tf.min()), int(tf.max())],
        iters_s_range=[int(ts.min()), int(ts.max())],
        residual_max=float(np.max(diags.residual)),
        c_d_last=float(diags.c_d[-1]),
        c_l_last=float(diags.c_l[-1]),
        delta_p_last=float(diags.delta_p[-1]),
        peak_bytes_in_use=stats.get("peak_bytes_in_use"),
        wall_s=wall,
    )
    return solver, state


# ----------------------------------------------------------------------
# c. card vs plain reference
# ----------------------------------------------------------------------
def plain_operator(op):
    """The element operator in its plainest form: plain gathers, einsum
    contractions and scatter-add assembly (no gather-sum plans, windowed
    gathers or assembled BSR forms)."""
    import dataclasses

    return dataclasses.replace(
        op, wgather_u=None, hplan_u=None, gradt=None, dbsr=None, gbsr=None,
        contraction="einsum", scatter_mode="scatter_add",
    )


def phase_card_vs_reference(rep, solver, state):
    import jax
    import jax.numpy as jnp

    from navierstokes_project_nm4pde_tpu.config import matmul_precision_scope
    from navierstokes_project_nm4pde_tpu.ops import operators as ops
    from navierstokes_project_nm4pde_tpu.ops.banded import banded_matvec
    from navierstokes_project_nm4pde_tpu.ops.macroblock import (
        apply_macro,
        build_macro_values,
        slot_expand_elem,
        slot_gather,
    )
    from navierstokes_project_nm4pde_tpu.ops.schur_ell import (
        schur_ell_matvec,
    )

    dev = solver._dev
    op, mp, fz = dev.op, dev.macro, dev.proj_schur
    check(mp is not None, "macro F apply was not built")
    check(op.dbsr is not None and op.gbsr is not None, "BSR D/G not built")
    check(fz is not None and fz.band is not None, "banded Schur not built")
    ref = plain_operator(op)
    nu, dt = solver.problem.nu, solver.config.time.dt
    n, d = solver.space.n_unodes, solver.space.dim
    rng = np.random.default_rng(0)
    dtype = solver.dtype
    u = jnp.asarray(rng.standard_normal((n, d)), dtype)
    p = jnp.asarray(rng.standard_normal(solver.space.n_pnodes), dtype)
    w = state.u  # the flow's own convection field

    def apply_F(o, conv, u):
        return ops.apply_F(o, nu, dt, conv, u)

    f_apply_F = jax.jit(apply_F)
    f_apply_macro = jax.jit(apply_macro)
    with matmul_precision_scope("highest"):
        # the plain reference: unfolded element quadrature, scatter-add
        conv_ref = jax.jit(ops.convection_setup)(ref, w)
        y_ref = f_apply_F(ref, conv_ref, u)
        # the production forms: folded F_e -> macro blocks / element pass
        conv = jax.jit(
            lambda o, w, base: ops.convection_setup(
                o, w, fold=(nu, dt), base_e=base
            )
        )(op, w, dev.conv_base)
        Ft = jax.jit(build_macro_values)(mp, conv.F_e)
        y_mac = f_apply_macro(mp, Ft, u)
        y_el = f_apply_F(op, conv, u)
        u_e = u[op.cells_u]
        e_slot = jax.jit(
            lambda m, x: slot_expand_elem(m, slot_gather(m, x))
        )(mp, u)
        e_win = jax.jit(ops.gather_u)(op, u)
        div = jax.jit(ops.apply_divergence)
        grad = jax.jit(ops.apply_gradient)
        D_bsr, D_ref = div(op, u), div(ref, u)
        G_bsr, G_ref = grad(op, p), grad(ref, p)
        S_band = jax.jit(banded_matvec)(fz.band, p)
        S_ell = jax.jit(schur_ell_matvec)(op.schur, fz.vals1, p)

    errs = {
        "macro_F_vs_element": rel_max(y_mac, y_ref),
        "element_F_plans_vs_scatter_add": rel_max(y_el, y_ref),
        "bsr_divergence_vs_element": rel_max(D_bsr, D_ref),
        "bsr_gradient_vs_element": rel_max(G_bsr, G_ref),
        "banded_schur_vs_ell": rel_max(S_band, S_ell),
    }
    exact = {
        "slot_expand_elem_vs_gather": bool(jnp.array_equal(e_slot, u_e)),
        "windowed_gather_vs_gather": bool(jnp.array_equal(e_win, u_e)),
    }
    rep.line(
        "card_vs_reference_965k", bound=REL_MAX_BOUND,
        windowed_gather_built=op.wgather_u is not None, **errs, **exact,
    )
    for name, e in errs.items():
        check(e <= REL_MAX_BOUND, f"{name}: rel max {e:.3e}")
    for name, ok in exact.items():
        check(ok, f"{name}: not bit-exact")

    # What XLA makes of the plain forms at 965k: the bar a hand-written
    # kernel for the F apply has to clear.
    ft_bytes = mp.B * mp.U * mp.U * np.dtype(dtype).itemsize
    io_bytes = 2 * n * d * np.dtype(dtype).itemsize  # u in, y out
    with matmul_precision_scope("highest"):
        t_mac = time_ms(f_apply_macro, mp, Ft, u)
        t_el = time_ms(f_apply_F, op, conv, u)
        t_ref = time_ms(f_apply_F, ref, conv_ref, u)
    rep.line(
        "plain_xla_timings_965k",
        apply_macro_ms=t_mac,
        apply_macro_bytes=ft_bytes + io_bytes,
        apply_macro_GBps=(ft_bytes + io_bytes) / t_mac / 1e6,
        apply_macro_share_of_3_35TBps=(ft_bytes + io_bytes)
        / t_mac / 1e6 / 3350.0,
        element_F_folded_plans_ms=t_el,
        element_F_unfolded_scatter_add_ms=t_ref,
    )


def phase_gpu_vs_cpu(rep, mesh=SMALL_MESH, n_steps=20, chunk=10):
    """The same steps on the default device and on the CPU backend."""
    import jax

    gpu = _cli(_cylinder_argv(mesh, n_steps, chunk, "cylinder3d_47k_gpu"))
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = _cli(_cylinder_argv(mesh, n_steps, chunk, "cylinder3d_47k_cpu"))
    check_steps(gpu["diags"], "47k default device")
    check_steps(cpu["diags"], "47k cpu")
    compare_runs(
        rep, "trajectory_47k_gpu_vs_cpu",
        gpu["state"].u, gpu["state"].p, cpu["state"].u, cpu["state"].p,
        _fs(gpu["diags"]), _fs(cpu["diags"]),
    )


# ----------------------------------------------------------------------
# d. ensemble
# ----------------------------------------------------------------------
def phase_ensemble(rep, mesh=SMALL_MESH, members=64, chunk=8, n_chunks=2,
                   alone=(0, -1), reduce_batches=(16, 64)):
    import jax
    import jax.numpy as jnp

    from navierstokes_project_nm4pde_tpu.ops.scatter import apply_gather_plan

    t0 = time.perf_counter()
    res = _cli(_ensemble_argv(mesh, members, chunk * n_chunks, chunk,
                              "ensemble"))
    wall = time.perf_counter() - t0
    solver, bstate, bd, nus = (
        res["solver"], res["state"], res["diags"], res["nus"]
    )
    check_steps(bd, "ensemble")
    rep.line("ensemble", members=members, n_dofs_per_member=solver.space.n_dofs,
             steps=chunk * n_chunks, wall_s_incl_setup_compile=wall)

    @partial(jax.jit, static_argnames="k")
    def run_alone(dev, st, nu, k):
        def body(s, _):
            return solver.step(s, nu=nu, dev=dev)

        return jax.lax.scan(body, st, None, length=k)

    for m in alone:
        m = m % members
        st, dg = run_alone(
            solver._dev, solver.initial_state(),
            jnp.asarray(nus[m], solver.dtype), k=chunk * n_chunks,
        )
        compare_runs(
            rep, f"ensemble_member_{m}_vs_alone",
            bstate.u[m], bstate.p[m], st.u, st.p,
            np.stack([bd.iters_f[m], bd.iters_s[m]]),
            np.stack([np.asarray(dg.iters_f), np.asarray(dg.iters_s)]),
        )

    # The vmapped velocity reduce at ensemble widths: the gather-sum plan
    # against scatter-add (segment_sum) -- plain XLA, no custom kernel.
    op = solver.op
    cells = op.cells_u.reshape(-1)
    n, d = solver.space.n_unodes, solver.space.dim
    rng = np.random.default_rng(1)
    plan_fn = jax.jit(
        lambda plan, f: jax.vmap(lambda x: apply_gather_plan(plan, x))(f)
    )
    seg_fn = jax.jit(
        lambda idx, f: jax.vmap(
            lambda x: jax.ops.segment_sum(x, idx, num_segments=n)
        )(f)
    )
    for B in reduce_batches:
        flat = jnp.asarray(
            rng.standard_normal((B, cells.shape[0], d)), solver.dtype
        )
        e = rel_max(plan_fn(op.plan_u, flat), seg_fn(cells, flat))
        check(e <= REL_MAX_BOUND, f"vmapped reduce B={B}: rel max {e:.3e}")
        nbytes = (B * cells.shape[0] * d + B * n * d) * flat.dtype.itemsize
        t_plan = time_ms(plan_fn, op.plan_u, flat)
        t_seg = time_ms(seg_fn, cells, flat)
        rep.line(
            f"vmapped_velocity_reduce_B{B}_47k",
            plan_ms=t_plan, segment_sum_ms=t_seg, bytes=nbytes,
            plan_GBps=nbytes / t_plan / 1e6,
            segment_sum_GBps=nbytes / t_seg / 1e6,
            plan_share_of_3_35TBps=nbytes / t_plan / 1e6 / 3350.0,
            rel_max_plan_vs_segment_sum=e,
        )


# ----------------------------------------------------------------------
# e. float64 Ethier-Steinman ladder
# ----------------------------------------------------------------------
def phase_es_ladder(rep, levels=(4, 8, 16), reference=ES_REFERENCE):
    t0 = time.perf_counter()
    table = _cli([
        "convergence", "--dt", "4e-4", "--n-steps", "1", "--levels",
        *map(str, levels), "--rtol", "1e-9", "--dtype", "float64",
        "--output-dir", os.path.join(OUT, "convergence"),
    ])
    wall = time.perf_counter() - t0
    l2 = [e["L2"] for (_, e) in table.rows]
    h1 = [e["H1"] for (_, e) in table.rows]
    rates = table.rates()
    rep.line("es_ladder_f64", levels=list(levels), L2=l2, H1=h1,
             L2_orders=rates["L2"], H1_orders=rates["H1"], wall_s=wall)
    for r in rates["L2"]:
        check(abs(r - 3.0) <= ES_ORDER_SLACK, f"ES L2 order {r:.3f}")
    for r in rates["H1"]:
        check(abs(r - 2.0) <= ES_ORDER_SLACK, f"ES H1 order {r:.3f}")
    for lev, a, b in zip(levels, l2, h1):
        if lev not in reference:
            continue
        for got, want, name in zip((a, b), reference[lev], ("L2", "H1")):
            half_unit = 0.5 * 10.0 ** (np.floor(np.log10(abs(want))) - 2)
            check(
                abs(got - want) < half_unit,
                f"ES level {lev} {name} {got:.4e} != {want:.4e} to 3 digits",
            )


# ----------------------------------------------------------------------
# four cards
# ----------------------------------------------------------------------
def _spans(x, devices) -> bool:
    return set(x.sharding.device_set) == set(devices)


def phase_four_gpus(rep, mesh=MAIN_MESH, n_steps=20, chunk=10,
                    ens_mesh=SMALL_MESH, members=64, ens_chunk=8,
                    min_bytes=1 << 20):
    import jax

    from navierstokes_project_nm4pde_tpu.parallel import make_device_mesh
    from navierstokes_project_nm4pde_tpu.parallel.halo_step import (
        HaloProjectionStep,
    )

    devices = jax.devices()[:4]
    check(len(devices) == 4, f"need 4 devices, found {len(jax.devices())}")

    def bytes_in_use():
        return [
            (dv.memory_stats() or {}).get("bytes_in_use", 0)
            for dv in devices
        ]

    # One card: the production step, and the forms the sharded step runs
    # (shard_solver on a 1-device mesh: element passes, scatter-add).
    ref = _cli(_cylinder_argv(mesh, n_steps, chunk, "four_single"))
    check_steps(ref["diags"], "single card")
    one = _cli(_cylinder_argv(mesh, n_steps, chunk, "four_shard_cells_1",
                              ("--shard-cells", "1")))
    check_steps(one["diags"], "shard-cells 1")
    compare_965k(
        rep, "shard_cells_1_vs_single_forms",
        one["state"].u, one["state"].p, ref["state"].u, ref["state"].p,
        _fs(one["diags"]), _fs(ref["diags"]),
    )

    # cylinder3d --shard-cells 4
    sh = _cli(_cylinder_argv(mesh, n_steps, chunk, "four_shard_cells_4",
                             ("--shard-cells", "4")))
    check_steps(sh["diags"], "shard-cells 4")
    spans = _spans(sh["solver"].op.cells_u, devices)
    used = bytes_in_use()
    rep.line("shard_cells_4_placement", cells_span_4=spans,
             bytes_in_use=used)
    check(spans, "shard-cells: cell arrays do not span the 4 cards")
    check(min(used) >= min_bytes, f"shard-cells: a card holds {min(used)} B")
    compare_965k(
        rep, "shard_cells_4_vs_1",
        sh["state"].u, sh["state"].p, one["state"].u, one["state"].p,
        _fs(sh["diags"]), _fs(one["diags"]),
    )
    compare_965k(
        rep, "shard_cells_4_vs_single",
        sh["state"].u, sh["state"].p, ref["state"].u, ref["state"].p,
        _fs(sh["diags"]), _fs(ref["diags"]),
    )
    del sh, one

    # owned+halo step on a 4-device ("cells",) mesh, against the same step
    # on one device and against the single-card _step_projection
    def halo_run(n_dev):
        hs = HaloProjectionStep(ref["solver"], make_device_mesh(n_dev))
        hstate = hs.init_state()
        its = []
        for _ in range(n_steps):
            hstate, (itf, its_) = hs(hstate)
            its.append((int(itf), int(its_)))
        return hs, hstate, np.asarray(its).T

    hs1, h1, it1 = halo_run(1)
    u1, p1 = np.asarray(hs1.unshard(h1.u)), np.asarray(h1.p)
    del hs1, h1
    hs4, h4, it4 = halo_run(4)
    spans = _spans(h4.u, devices)
    used = bytes_in_use()
    rep.line("halo_step_4_placement", u_span_4=spans, bytes_in_use=used)
    check(spans, "halo step: owned velocity does not span the 4 cards")
    check(min(used) >= min_bytes, f"halo step: a card holds {min(used)} B")
    u4 = hs4.unshard(h4.u)
    compare_965k(rep, "halo_step_4_vs_1", u4, h4.p, u1, p1, it4, it1)
    compare_965k(
        rep, "halo_step_4_vs_single",
        u4, h4.p, ref["state"].u, ref["state"].p, it4, _fs(ref["diags"]),
    )
    del hs4, h4, ref

    # ensemble --shard-batch
    steps = 2 * ens_chunk
    one = _cli(_ensemble_argv(ens_mesh, members, steps, ens_chunk,
                              "four_ensemble_ref"))
    four = _cli(_ensemble_argv(ens_mesh, members, steps, ens_chunk,
                               "four_ensemble_shard", ("--shard-batch",)))
    check_steps(four["diags"], "ensemble shard-batch")
    spans = _spans(four["state"].u, devices)
    used = bytes_in_use()
    rep.line("shard_batch_4_placement", u_span_4=spans, bytes_in_use=used)
    check(spans, "shard-batch: ensemble state does not span the 4 cards")
    check(min(used) >= min_bytes, f"shard-batch: a card holds {min(used)} B")
    compare_runs(
        rep, "shard_batch_4_vs_unsharded",
        four["state"].u, four["state"].p, one["state"].u, one["state"].p,
        np.stack([four["diags"].iters_f, four["diags"].iters_s]),
        np.stack([one["diags"].iters_f, one["diags"].iters_s]),
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the four-card sharded paths")
    args = ap.parse_args(argv)

    device, card = phase_device()
    import jax

    from navierstokes_project_nm4pde_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    rep = Report(card)
    rep.line("device", **device, jax_version=jax.__version__)
    t0 = time.perf_counter()
    if args.four_gpus:
        check(device["count"] >= 4, f"--four-gpus needs 4 cards, "
              f"found {device['count']}")
        phase_four_gpus(rep)
    else:
        clock = CompileClock()
        solver, state = phase_main_path(rep, clock)
        phase_card_vs_reference(rep, solver, state)
        del solver, state
        phase_gpu_vs_cpu(rep)
        phase_ensemble(rep)
        phase_es_ladder(rep)
    rep.line("total", wall_s=time.perf_counter() - t0)
    rep.save()
    print(result_line(device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
