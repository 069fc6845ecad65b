"""Unsteady incompressible Navier-Stokes simulation engine in JAX.

A JAX/XLA framework with the capability surface of the
deal.II/Trilinos/MPI reference solver (lelecaruso/NavierStokes_Project_NM4PDE):
Taylor-Hood P2-P1 simplex FEM, semi-implicit time stepping, preconditioned
flexible GMRES with the SIMPLE/Yosida block-preconditioner family, DFG
cylinder benchmarks (drag/lift/pressure-difference) and the Ethier-Steinman
manufactured-solution convergence study.

Architecture (accelerator-first, not a port):
  * static-shape element batches; constant operators (mass, stiffness,
    divergence, pressure mass) assembled once into padded ELL sparse format
    (uniform gathers + reductions);
  * the convection operator is applied matrix-free each time step through
    shared reference-table contractions (batched matmuls);
  * Krylov solvers are pure JAX (`lax.while_loop` / `lax.scan`), inner
    ILU solves of the reference are replaced by Jacobi / Chebyshev
    smoothing (same inner-tolerance behaviour);
  * multi-device runs shard the element batch over a `jax.sharding.Mesh`
    (the SPMD domain-decomposition model of the reference's MPI layer),
    with XLA collectives instead of MPI reductions;
  * parameter ensembles run via `vmap` (a capability the reference lacks).

Reference parity citations use `ref:` = the reference repository's paths.
"""

__version__ = "0.1.0"

from navierstokes_project_nm4pde_tpu.config import (  # noqa: F401
    NumericsConfig,
    PrecondConfig,
    SolverConfig,
)
