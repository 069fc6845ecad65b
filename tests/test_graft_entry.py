"""Entry points of __graft_entry__: the multi-device dryrun must work
in-process.

These tests pin two properties: the dryrun executes on the
8-virtual-device CPU mesh end to end, and the 2-axis batch x cells
composition matches the unsharded ensemble run (an earlier version of its
2-axis branch silently ran without cell sharding).
"""

import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

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
from navierstokes_project_nm4pde_tpu.parallel import run_ensemble, shard_solver


def test_dryrun_multichip_runs_in_process():
    import __graft_entry__ as ge

    # conftest already forced cpu x8; the dryrun's self-configuration must
    # be an idempotent no-op in that case.
    ge.dryrun_multichip(8)


def test_entry_returns_jittable_step():
    import jax

    import __graft_entry__ as ge

    fn, args = ge.entry()
    u, p, iters = jax.jit(fn)(*args)
    assert np.all(np.isfinite(np.asarray(u)))
    assert np.all(np.isfinite(np.asarray(p)))


def test_two_axis_ensemble_matches_unsharded():
    """batch x cells composition == plain (unsharded, unvmapped-device) run."""
    import jax

    mesh = cylinder_duct_3d(lc=0.3, nz=2)
    cfg = RunConfig(
        time=TimeConfig(dt=2e-4, t_end=4.0),
        solver=SolverConfig(rtol=1e-8, restart=30, maxiter=60),
        precond=PrecondConfig(kind="asimple", f_iters=4, s_iters=20),
        numerics=NumericsConfig(
            dtype="float64", precise_dots=False, steps_per_chunk=2
        ),
    )
    nus = np.array([1e-3, 2e-3])

    plain = NavierStokesSolver(mesh, Cylinder3DProblem(test_case=2), cfg)
    bstate_ref, _ = run_ensemble(plain, nus, n_steps=2)

    dev_mesh = Mesh(
        np.array(jax.devices()[:8]).reshape(2, 4), ("batch", "cells")
    )
    sharded = NavierStokesSolver(mesh, Cylinder3DProblem(test_case=2), cfg)
    shard_solver(sharded, dev_mesh)
    # the sharded operator must actually be wired into the device data
    assert sharded._dev.op is sharded.op
    bsh = NamedSharding(dev_mesh, P("batch"))
    bstate, bdiags = run_ensemble(sharded, nus, n_steps=2, sharding=bsh)

    np.testing.assert_allclose(
        np.asarray(bstate.u), np.asarray(bstate_ref.u), rtol=1e-8, atol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(bstate.p), np.asarray(bstate_ref.p), rtol=1e-7, atol=1e-9
    )
