"""Multi-device SPMD: element-batch domain decomposition over a device mesh.

The reference's only parallel strategy is domain decomposition over MPI ranks
(partitioned triangulation, owned-cell filtering, compress() reductions;
ref: src/NavierStokes2D.cpp:16-19, :212-213, :315-320 -- SURVEY.md section 2c).
The device mapping:

  * the *element batch* axis is sharded over a 1-D `jax.sharding.Mesh`
    ("cells"); every per-element array (connectivity, geometry, convection
    tables) is split, DoF vectors stay replicated (a few MB -- the right
    trade below ~10M DoF, where gathers stay local and only the assembly
    reduction crosses devices);
  * assembly uses the scatter-add path: under GSPMD each device accumulates
    its partial global vector and XLA inserts the `psum` -- this *is* the
    reference's `compress()`/`MPI_Reduce` but as compiler-placed
    collectives;
  * scalar reductions (dot products, norms, drag/lift) are plain `jnp.sum`
    over replicated/partial arrays -- GSPMD turns them into `psum` too.

No MPI, no ghost-DoF bookkeeping: ownership is a sharding annotation.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from navierstokes_project_nm4pde_tpu.ops.operators import NSOperator

# Element-axis-sharded leaves of NSOperator; everything else is replicated.
_CELL_FIELDS = ("cells_u", "cells_p", "detJ", "Jinv", "GKd", "imex_scale")


def make_device_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), axis_names=("cells",))


def _pad_cells(op: NSOperator, multiple: int) -> NSOperator:
    """Pad the element batch to a multiple of the device count.

    Padding cells are degenerate copies of cell 0 with zeroed geometry
    (detJ = 0), so they contribute nothing to any integral."""
    E = op.n_cells
    rem = (-E) % multiple
    if rem == 0:
        return op
    import jax.numpy as jnp

    def pad(x, zero: bool):
        padding = jnp.repeat(x[:1] * (0 if zero else 1), rem, axis=0)
        return jnp.concatenate([x, padding], axis=0)

    extra = {}
    if op.imex_scale is not None:
        # degenerate pad cells (detJ = 0) contribute nothing either way
        extra["imex_scale"] = pad(op.imex_scale, False)
    return dataclasses.replace(
        op,
        cells_u=pad(op.cells_u, False),
        cells_p=pad(op.cells_p, False),
        detJ=pad(op.detJ, True),
        Jinv=pad(op.Jinv, False),
        GKd=pad(op.GKd, True),
        **extra,
    )


def shard_operator(op: NSOperator, mesh: Mesh) -> NSOperator:
    """Move an operator onto the device mesh, cells axis sharded."""
    n_dev = mesh.devices.size
    op = dataclasses.replace(
        _pad_cells(op, n_dev),
        scatter_mode="scatter_add",
        # The windowed forward gather scans dynamic slices of the (replicated)
        # node array -- incompatible with the cells-sharded GSPMD layout; the
        # plain gather partitions cleanly along the cell axis.
        wgather_u=None,
        # The assembled-transpose gradient's row buckets don't follow the
        # cell axis; the element-pass gradient shards cleanly.
        gradt=None,
        # The supernode BSR D/G forms are node-space assembled (no cell
        # axis); the element passes shard cleanly instead.
        dbsr=None,
        gbsr=None,
    )
    cell_sh = NamedSharding(mesh, P("cells"))
    repl_sh = NamedSharding(mesh, P())

    updates = {}
    for f in dataclasses.fields(op):
        if f.metadata.get("static"):
            continue
        val = getattr(op, f.name)
        sh = cell_sh if f.name in _CELL_FIELDS else repl_sh
        updates[f.name] = jax.device_put(val, sh)
    return dataclasses.replace(op, **updates)


def shard_solver(solver, mesh: Mesh):
    """Shard a NavierStokesSolver's operator in place; functional tables and
    DoF vectors stay replicated.  Returns the solver for chaining."""
    solver.op = shard_operator(solver.op, mesh)
    repl = NamedSharding(mesh, P())

    def repl_tree(t):
        return jax.tree.map(lambda x: jax.device_put(x, repl), t)

    if solver.forces is not None:
        solver.forces = repl_tree(solver.forces)
    if solver.neumann is not None:
        solver.neumann = repl_tree(solver.neumann)
        solver._neumann_points = jax.device_put(solver._neumann_points, repl)
    if solver.probe is not None:
        solver.probe = repl_tree(solver.probe)
    solver._bc_groups = [
        (f, jax.device_put(i, repl), jax.device_put(c, repl))
        for (f, i, c) in solver._bc_groups
    ]
    solver._unode_coords_dev = jax.device_put(solver._unode_coords_dev, repl)
    solver._pnode_coords_dev = jax.device_put(solver._pnode_coords_dev, repl)
    solver._bc_inverse = repl_tree(solver._bc_inverse)
    if solver._ftab is not None:
        solver._ftab = repl_tree(solver._ftab)
    if getattr(solver, "_neumann_plan", None) is not None:
        solver._neumann_plan = repl_tree(solver._neumann_plan)
    if getattr(solver, "_proj_schur", None) is not None:
        solver._proj_schur = repl_tree(solver._proj_schur)
    if getattr(solver, "_f_lam0", None) is not None:
        solver._f_lam0 = jax.device_put(solver._f_lam0, repl)
    # The IMEX fine-subset tables and the constant-K BSR operator are
    # node-space assembled (no cell axis): drop them so the sharded step
    # falls back to the masked element fold (identical operator).
    solver._imex = None
    solver._kbsr = None
    solver._macro = None
    solver._macro_mass = None
    solver._macro_stiff = None
    solver._rebuild_device_data()
    return solver


def cell_partitioning(solver, mesh: Mesh) -> np.ndarray:
    """Per-cell owning-device ids for the sharded element batch (the VTU
    `partitioning` field, mirroring the reference's subdomain output;
    ref: src/NavierStokes2D.cpp:662-665).  Matches GSPMD's contiguous
    block layout of the padded cell axis."""
    n_dev = mesh.devices.size
    e_pad = solver.op.n_cells  # padded to a multiple of n_dev
    block = e_pad // n_dev
    return np.arange(solver.mesh.n_cells) // block
