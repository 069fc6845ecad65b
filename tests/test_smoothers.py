"""Dot-free smoothers + preconditioner variants (richardson / chebyshev /
low-precision) keep the outer solver converging."""

import numpy as np
import pytest

from navierstokes_project_nm4pde_tpu.solvers.smoothers import (
    chebyshev_fixed,
    power_lambda_max,
    richardson_fixed,
)


def make_spd(n, cond, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    return Q @ np.diag(np.geomspace(1.0, cond, n)) @ Q.T


def test_richardson_contracts():
    import jax.numpy as jnp

    n = 60
    A = np.eye(n) * 5 + 0.4 * np.random.default_rng(1).normal(size=(n, n))
    b = np.random.default_rng(2).normal(size=n)
    Aj = jnp.asarray(A)
    d = jnp.asarray(1.0 / np.diag(A))
    x = richardson_fixed(lambda v: Aj @ v, jnp.asarray(b), lambda v: d * v, iters=20)
    r = np.linalg.norm(b - A @ np.asarray(x)) / np.linalg.norm(b)
    assert r < 1e-2


def test_chebyshev_beats_richardson_on_spd():
    import jax.numpy as jnp

    n = 80
    A = make_spd(n, cond=100.0)
    b = np.random.default_rng(3).normal(size=n)
    Aj = jnp.asarray(A)
    d = jnp.asarray(1.0 / np.diag(A))
    lam = power_lambda_max(lambda v: Aj @ v, lambda v: d * v, jnp.asarray(b), iters=15)
    lam_max = 1.05 * float(lam)
    xc = chebyshev_fixed(
        lambda v: Aj @ v, jnp.asarray(b), lambda v: d * v, iters=25,
        lam_min=lam_max / 30, lam_max=lam_max,
    )
    xr = richardson_fixed(
        lambda v: Aj @ v, jnp.asarray(b), lambda v: d * v, iters=25, omega=0.9
    )
    rc = np.linalg.norm(b - A @ np.asarray(xc))
    rr = np.linalg.norm(b - A @ np.asarray(xr))
    assert rc < rr
    assert rc / np.linalg.norm(b) < 5e-2


@pytest.mark.parametrize(
    "opts",
    [
        dict(f_solver="richardson", s_solver="cg"),
        dict(f_solver="gmres", s_solver="chebyshev"),
        dict(f_solver="richardson", s_solver="chebyshev", low_precision=True),
    ],
)
def test_fast_precond_variants_converge(opts):
    """Ethier-Steinman single step with the tuned preconditioner knobs."""
    from navierstokes_project_nm4pde_tpu.config import (
        NumericsConfig,
        PrecondConfig,
        RunConfig,
        SolverConfig,
        TimeConfig,
    )
    from navierstokes_project_nm4pde_tpu.mesh import cube_mesh
    from navierstokes_project_nm4pde_tpu.models import (
        EthierSteinmanProblem,
        NavierStokesSolver,
    )

    cfg = RunConfig(
        time=TimeConfig(dt=4e-4, t_end=4e-4),
        solver=SolverConfig(rtol=1e-8, restart=60, maxiter=250),
        precond=PrecondConfig(kind="asimple", f_iters=6, s_iters=30, **opts),
        numerics=NumericsConfig(dtype="float64", precise_dots=False, steps_per_chunk=1),
    )
    solver = NavierStokesSolver(cube_mesh(3), EthierSteinmanProblem(), cfg)
    state, diags = solver.run(1)
    assert int(diags.iters[-1]) < 250, opts
    assert np.all(np.isfinite(np.asarray(state.u)))
