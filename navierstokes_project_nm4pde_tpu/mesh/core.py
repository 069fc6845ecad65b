"""Host-side mesh container: static arrays, boundary facets, orientation.

The reference delegates this layer to deal.II (`GridIn::read_msh`,
`parallel::fullydistributed::Triangulation`; ref: src/NavierStokes2D.cpp:8-19).
Here a mesh is four numpy arrays -- everything the device code needs is
derived from them at setup time and shipped as static-shaped jnp arrays:

  coords      [n_vertices, dim] float64
  cells       [n_cells, dim+1]  int32   (simplex vertex ids, positive volume)
  bface_verts [n_bfaces, dim]   int32   (boundary facet vertex ids)
  bface_tag   [n_bfaces]        int32   (physical boundary tag)

Boundary tags follow the reference's gmsh conventions: 0=inlet, 1=outlet,
2=walls, 3=obstacle/Neumann (ref: mesh/Cylinder2D.geo:40-44).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Mesh:
    coords: np.ndarray  # [n_v, dim] float64
    cells: np.ndarray  # [n_c, dim+1] int32
    bface_verts: np.ndarray  # [n_bf, dim] int32
    bface_tag: np.ndarray  # [n_bf] int32

    def __post_init__(self):
        self.coords = np.asarray(self.coords, dtype=np.float64)
        self.cells = np.asarray(self.cells, dtype=np.int32)
        self.bface_verts = np.asarray(self.bface_verts, dtype=np.int32).reshape(
            -1, self.dim
        )
        self.bface_tag = np.asarray(self.bface_tag, dtype=np.int32).reshape(-1)
        self._fix_orientation()

    @property
    def dim(self) -> int:
        return self.coords.shape[1]

    @property
    def n_vertices(self) -> int:
        return self.coords.shape[0]

    @property
    def n_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def n_bfaces(self) -> int:
        return self.bface_verts.shape[0]

    # ------------------------------------------------------------------
    def _fix_orientation(self) -> None:
        """Permute cell vertices so every simplex has positive volume."""
        v = self.coords[self.cells]  # [n_c, dim+1, dim]
        e = v[:, 1:, :] - v[:, :1, :]  # [n_c, dim, dim]
        det = np.linalg.det(e)
        flip = det < 0.0
        if np.any(flip):
            cells = self.cells.copy()
            # Swapping the last two vertices flips the sign of the volume.
            cells[flip, -2], cells[flip, -1] = (
                self.cells[flip, -1],
                self.cells[flip, -2],
            )
            self.cells = cells
        if np.any(np.isclose(np.abs(det), 0.0)):
            raise ValueError("mesh contains degenerate (zero-volume) cells")

    # ------------------------------------------------------------------
    def reorder_spatial(self, method: str = "morton") -> "Mesh":
        """Renumber cells spatially and vertices (first-touch by the
        sorted cells).

        Gathers dominate matrix-free operator application; spatial
        ordering gives DoF gathers/reductions cache-friendly locality, and
        it is the prerequisite for the windowed gathers and the banded
        Schur form (RCM).
        Plays the role of the reference's mesh partitioning/renumbering
        (ref: src/NavierStokes2D.cpp:16-19, :62-69) for a single device.

        method="morton": Z-curve over uniform physical bins.  Good average
        locality but heavy-tailed *spans* (the index range of the cells
        around one vertex): a vertex sitting on a Z-curve fold sees its
        ~24 cells spread across a large index range.
        method="rcm": reverse Cuthill-McKee on the vertex-shared cell
        adjacency graph.  Minimises exactly the span/bandwidth quantity,
        giving tail-free windows -- the prerequisite for the banded
        frozen-Schur SpMV (ops/banded.py) and the windowed gathers.
        """
        if method == "rcm":
            cell_order = self._cell_order_rcm()
        elif method == "morton":
            cell_order = self._cell_order_morton()
        else:
            raise ValueError(f"unknown reorder method: {method}")
        cells = self.cells[cell_order]

        # first-touch vertex renumbering (vectorised)
        flat = cells.reshape(-1)
        uniq, first_pos = np.unique(flat, return_index=True)
        appearance = uniq[np.argsort(first_pos, kind="stable")]
        new_id = np.full(self.n_vertices, -1, dtype=np.int64)
        new_id[appearance] = np.arange(len(appearance))
        missing = np.where(new_id < 0)[0]  # vertices in no cell (none expected)
        new_id[missing] = len(appearance) + np.arange(len(missing))

        coords = np.empty_like(self.coords)
        coords[new_id] = self.coords
        return Mesh(
            coords,
            new_id[cells],
            new_id[self.bface_verts],
            self.bface_tag.copy(),
        )

    def _cell_order_morton(self) -> np.ndarray:
        cent = self.coords[self.cells].mean(axis=1)
        lo = cent.min(axis=0)
        # Uniform physical bin size across axes: per-axis normalisation would
        # interleave fine bits of short axes with coarse bits of long ones and
        # destroy locality on anisotropic domains (e.g. the 2.5 x 0.41 x 0.41
        # duct).
        span = max(float((cent.max(axis=0) - lo).max()), 1e-300)
        q = np.clip(((cent - lo) / span * 1023).astype(np.int64), 0, 1023)

        def _spread(v):  # interleave bits (Morton)
            v = (v | (v << 16)) & 0x0000FFFF0000FFFF
            v = (v | (v << 8)) & 0x00FF00FF00FF00FF
            v = (v | (v << 4)) & 0x0F0F0F0F0F0F0F0F
            v = (v | (v << 2)) & 0x3333333333333333
            v = (v | (v << 1)) & 0x5555555555555555
            return v

        key = _spread(q[:, 0]) | (_spread(q[:, 1]) << 1)
        if self.dim == 3:
            key |= _spread(q[:, 2]) << 2
        return np.argsort(key, kind="stable")

    def _cell_order_rcm(self) -> np.ndarray:
        """Reverse Cuthill-McKee order of the vertex-shared cell graph."""
        from scipy.sparse import coo_matrix
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        E, n_loc = self.n_cells, self.cells.shape[1]
        rows = np.repeat(np.arange(E, dtype=np.int64), n_loc)
        inc = coo_matrix(
            (np.ones(E * n_loc, np.int8), (rows, self.cells.reshape(-1))),
            shape=(E, self.n_vertices),
        ).tocsr()
        adj = (inc @ inc.T).tocsr()
        perm = reverse_cuthill_mckee(adj, symmetric_mode=True)
        return np.asarray(perm, dtype=np.int64)

    # ------------------------------------------------------------------
    def cell_volumes(self) -> np.ndarray:
        v = self.coords[self.cells]
        e = v[:, 1:, :] - v[:, :1, :]
        det = np.linalg.det(e)
        fact = 2.0 if self.dim == 2 else 6.0
        return det / fact

    # ------------------------------------------------------------------
    def _all_facets(self):
        """All (cell, local) facets, vectorised.

        Returns (facets_sorted [n_c*(d+1), d], cell_ids, local_ids), where
        local facet k of a simplex is the facet opposite local vertex k.
        """
        dim, n_loc = self.dim, self.dim + 1
        # facet k keeps every local vertex except k
        keep = np.array(
            [[j for j in range(n_loc) if j != k] for k in range(n_loc)],
            dtype=np.int64,
        )  # [n_loc, dim]
        facets = self.cells[:, keep]  # [n_c, n_loc, dim]
        facets = np.sort(facets.reshape(-1, dim), axis=1)
        cell_ids = np.repeat(np.arange(self.n_cells, dtype=np.int32), n_loc)
        local_ids = np.tile(np.arange(n_loc, dtype=np.int32), self.n_cells)
        return facets, cell_ids, local_ids

    @staticmethod
    def _facet_keys(facets: np.ndarray) -> np.ndarray:
        """Pack sorted facet vertex tuples into a single int64 key per facet.

        The multiplicative base bounds the collision-free range: three
        vertex ids must fit in int64, so ids must stay below the base.
        Oversize meshes fail loudly here instead of silently mis-matching
        facets downstream."""
        f = facets.astype(np.int64)
        if f.size and int(f.max()) >= 2_000_003:
            raise ValueError(
                "facet keys support < 2,000,003 vertices "
                f"(got vertex id {int(f.max())}); use the native facet "
                "matcher for larger meshes"
            )
        key = f[:, 0]
        for j in range(1, f.shape[1]):
            key = key * 2_000_003 + f[:, j]
        return key

    def boundary_face_parents(self):
        """Locate the owning cell and local facet index for each boundary facet.

        Returns (bface_cell [n_bf], bface_local [n_bf]).
        """
        from navierstokes_project_nm4pde_tpu.mesh.native import match_facets

        native = match_facets(self.cells, self.bface_verts)
        if native is not None:
            return native
        facets, cell_ids, local_ids = self._all_facets()
        keys = self._facet_keys(facets)
        order = np.argsort(keys, kind="stable")
        keys_sorted = keys[order]
        bkeys = self._facet_keys(np.sort(self.bface_verts, axis=1))
        pos = np.searchsorted(keys_sorted, bkeys)
        ok = (pos < keys_sorted.shape[0]) & (keys_sorted[np.minimum(pos, len(keys_sorted) - 1)] == bkeys)
        if not np.all(ok):
            raise ValueError("some tagged boundary facets are not cell facets")
        idx = order[pos]
        return cell_ids[idx], local_ids[idx]

    # ------------------------------------------------------------------
    def check_boundary_closed(self) -> None:
        """Every facet shared by exactly one cell must carry a boundary tag."""
        facets, _, _ = self._all_facets()
        keys = self._facet_keys(facets)
        uniq, counts = np.unique(keys, return_counts=True)
        boundary = set(uniq[counts == 1].tolist())
        tagged = set(
            self._facet_keys(np.sort(self.bface_verts, axis=1)).tolist()
        )
        missing = boundary - tagged
        extra = tagged - boundary
        if missing or extra:
            raise ValueError(
                f"boundary mismatch: {len(missing)} untagged, {len(extra)} bogus"
            )
