"""Collective-volume accounting for the DoF-sharded halo apply at bench
scale (host-only: builds the halo plan, no device work).

Compares per-apply cross-device bytes of the owned+halo path
(parallel/halo.py) against the replicated path's full-vector all-reduce,
at the benchmark mesh sizes.  Usage:

    JAX_PLATFORMS=cpu python scripts/halo_volume.py [lc] [nz] [n_dev]
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from navierstokes_project_nm4pde_tpu.fem.space import build_taylor_hood
from navierstokes_project_nm4pde_tpu.mesh import cylinder_duct_3d
from navierstokes_project_nm4pde_tpu.parallel.halo import (
    _build_side,
    _ownership_perm,
)


def main():
    lc = float(sys.argv[1]) if len(sys.argv) > 1 else 0.028
    nz = int(sys.argv[2]) if len(sys.argv) > 2 else 12
    n_dev = int(sys.argv[3]) if len(sys.argv) > 3 else 8

    mesh = cylinder_duct_3d(lc=lc, nz=nz).reorder_spatial("morton")
    space = build_taylor_hood(mesh)
    n_u, n_p = space.n_unodes, space.n_pnodes
    dim = 3
    print(f"mesh: {mesh.n_cells} cells, {3 * n_u + n_p} DoFs, {n_dev} devices")

    # pad cells to a multiple of n_dev (pad rows reference cell 0 like
    # sharding._pad_cells; their spurious node-0 ghosts are counted too)
    cells_u = np.asarray(space.cells_u)
    cells_p = np.asarray(space.cells_p)
    rem = (-cells_u.shape[0]) % n_dev
    if rem:
        cells_u = np.concatenate([cells_u, np.repeat(cells_u[:1], rem, 0)])
        cells_p = np.concatenate([cells_p, np.repeat(cells_p[:1], rem, 0)])

    side_u = _build_side(cells_u, n_u, n_dev, splits=(mesh.n_vertices,))
    side_p = _build_side(cells_p, n_p, n_dev)

    f32 = 4
    halo_u = sum(side_u.halo_sizes)
    halo_p = sum(side_p.halo_sizes)
    halo_bytes = 2 * n_dev * (halo_u * dim + halo_p) * f32  # fwd + reverse
    repl_bytes = 2 * n_dev * (n_u * dim + n_p) * f32  # ring all-reduce
    print(f"velocity: n_loc={side_u.n_loc}, shifts={side_u.shifts}, "
          f"halo/shift={side_u.halo_sizes} (total {halo_u} rows "
          f"= {halo_u / side_u.n_loc:.1%} of owned)")
    print(f"pressure: n_loc={side_p.n_loc}, halo total {halo_p} rows")
    print(f"halo bytes/apply (all devices, fwd+rev): {halo_bytes / 1e6:.2f} MB")
    print(f"replicated all-reduce bytes/apply:       {repl_bytes / 1e6:.2f} MB")
    print(f"ratio: {halo_bytes / repl_bytes:.3f}")


if __name__ == "__main__":
    main()
