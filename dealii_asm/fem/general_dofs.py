"""Continuous FE_Q DoF numbering on unstructured meshes, orientation-correct.

The reference resolves shared-entity orientations at *runtime* inside its
compressed gather/scatter (/root/reference/include/reduced_access.h:8-285:
line/quad orientation words decoded per access;
vector_access_reduced.h:273-548).  This redesign resolves them ONCE
on the host: global DoFs are numbered per entity (vertices, then line
interiors in canonical line order, then quad interiors in canonical quad
order, then cell interiors), and each cell's ``cell_dofs`` table is filled
with the orientation-applied permutation, vectorized over cells.  Device code
then runs plain gathers/scatter-adds — no orientation logic on the hot path.

Canonical orientations (host conventions, replacing deal.II's):
- line: from its lower global vertex id to the higher;
- quad: origin = corner with the smallest global vertex id; canonical u-axis
  points to its adjacent corner with the smaller id, v-axis to the other.
This covers all 2 line / 8 quad orientation states
(reduced_access.h:97-152 packs the same information into a 30-bit word).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from ..mesh.unstructured import (
    UnstructuredMesh,
    _VERTEX_COORDS,
    _edge_vertices,
    _face_vertices,
)


@dataclass(frozen=True)
class GeneralDofHandler:
    mesh: UnstructuredMesh
    degree: int

    # -- entity enumeration ------------------------------------------------------

    @cached_property
    def _lines(self):
        """(cell_line_ids (C, n_local_edges), line_flip (C, n_local_edges),
        n_lines).  line_flip: True where the cell's local edge direction
        (toward higher local coordinate) runs opposite the canonical
        (ascending-vertex-id) direction."""
        mesh = self.mesh
        edges = _edge_vertices(mesh.dim)
        cv = mesh.cells  # (C, 2^dim)
        v0 = np.stack([cv[:, a] for (a, b, _ax) in edges], axis=1)
        v1 = np.stack([cv[:, b] for (a, b, _ax) in edges], axis=1)
        lo = np.minimum(v0, v1)
        hi = np.maximum(v0, v1)
        keys = np.stack([lo, hi], axis=2).reshape(-1, 2)  # (C*E, 2)
        uniq, inv = np.unique(keys, axis=0, return_inverse=True)
        ids = inv.reshape(v0.shape).astype(np.int64)
        flip = v0 > v1  # local runs a->b with a at lower coord; canonical lo->hi
        return ids, flip, len(uniq)

    @cached_property
    def _quads(self):
        """(cell_quad_ids (C, 6), corner arrays, n_quads) — 3D only.

        corners: (C, 6, 4) global vertex ids of each local face in face-lex
        order (c00, c10, c01, c11)."""
        mesh = self.mesh
        assert mesh.dim == 3
        fv = _face_vertices(3)
        cv = mesh.cells
        corners = np.stack([cv[:, fv[f]] for f in range(6)], axis=1)  # (C, 6, 4)
        keys = np.sort(corners.reshape(-1, 4), axis=1)
        uniq, inv = np.unique(keys, axis=0, return_inverse=True)
        ids = inv.reshape(corners.shape[:2]).astype(np.int64)
        return ids, corners, len(uniq)

    @cached_property
    def _offsets(self):
        p = self.degree
        mesh = self.mesh
        n_lines = self._lines[2]
        n_quads = self._quads[2] if mesh.dim == 3 else 0
        off_line = mesh.n_vertices
        off_quad = off_line + (n_lines * (p - 1) if p > 1 else 0)
        off_cell = off_quad + (n_quads * (p - 1) ** 2 if p > 1 else 0)
        n_total = off_cell + (mesh.n_cells_total * (p - 1) ** mesh.dim
                              if p > 1 else 0)
        return off_line, off_quad, off_cell, n_total

    @property
    def n_dofs(self) -> int:
        return self._offsets[3]

    @property
    def dofs_per_cell(self) -> int:
        return (self.degree + 1) ** self.mesh.dim

    # -- the index table ----------------------------------------------------------

    @cached_property
    def cell_dofs(self) -> np.ndarray:
        """(C, (p+1)^dim) global DoFs per cell, local lexicographic (x fastest),
        orientation permutations applied (get_dof_indices analog).  Vectorized
        over cells: the loop runs over the (p+1)^dim local slots only."""
        p = self.degree
        dim = self.mesh.dim
        mesh = self.mesh
        off_line, off_quad, off_cell, _ = self._offsets
        n1 = p + 1
        L = n1**dim
        C = mesh.n_cells_total
        lat = np.stack(
            [np.arange(L) // n1**d % n1 for d in range(dim)], axis=1)  # (L, dim)
        inner = (lat > 0) & (lat < p)
        vc = _VERTEX_COORDS[dim]
        edges = _edge_vertices(dim)
        line_ids, line_flip, _ = self._lines
        if dim == 3:
            quad_ids, quad_corners, _ = self._quads
            quad_canon = _canonical_quad_vec(quad_corners)  # (C, 6, 4)
            fv_axes = [(f // 2) for f in range(6)]

        def vlookup(coords01):
            return int(np.where((vc == coords01).all(axis=1))[0][0])

        out = np.empty((C, L), dtype=np.int64)
        cell_interior_base = off_cell + np.arange(C, dtype=np.int64) * (p - 1) ** dim

        for l in range(L):
            coords = lat[l]
            k = int(inner[l].sum())
            if k == 0:
                out[:, l] = mesh.cells[:, vlookup(coords // p)]
            elif k == 1:
                d = int(np.where(inner[l])[0][0])
                t = int(coords[d])
                lo = coords.copy(); lo[d] = 0
                hi = coords.copy(); hi[d] = p
                va, vb = vlookup(lo // p), vlookup(hi // p)
                # which local edge is (va, vb)?
                e = next(i for i, (a, b, _ax) in enumerate(edges)
                         if (a, b) == (va, vb) or (b, a) == (va, vb))
                li = line_ids[:, e]
                idx = np.where(line_flip[:, e], p - 1 - t, t - 1)
                out[:, l] = off_line + li * (p - 1) + idx
            elif k == 2 and dim == 3:
                ds = np.where(inner[l])[0]
                a, b = int(ds[0]), int(ds[1])
                d_out = 3 - a - b
                side = int(coords[d_out]) // p  # 0 or 1
                f = 2 * d_out + side
                s, t = int(coords[a]), int(coords[b])
                # face-lex order of face f: fastest axis = lower remaining axis
                # = a (since a < b), so (s, t) are already the face-lex coords
                u, v = _quad_uv_vec(quad_canon[:, f], quad_corners[:, f], s, t, p)
                qi = quad_ids[:, f]
                out[:, l] = (off_quad + qi * (p - 1) ** 2
                             + (v - 1) * (p - 1) + (u - 1))
            else:
                idx = 0
                mult = 1
                for d in range(dim):
                    idx += (int(coords[d]) - 1) * mult
                    mult *= p - 1
                out[:, l] = cell_interior_base + idx
        return out.astype(np.int32)

    @cached_property
    def boundary_mask(self) -> np.ndarray:
        """(n_dofs,) True where the DoF lies on a boundary face."""
        p = self.degree
        dim = self.mesh.dim
        n1 = p + 1
        L = n1**dim
        lat = np.stack(
            [np.arange(L) // n1**d % n1 for d in range(dim)], axis=1)
        mask = np.zeros(self.n_dofs, dtype=bool)
        nbr = self.mesh.face_neighbors()
        cd = self.cell_dofs
        for f in range(2 * dim):
            cs = np.where(nbr[:, f] < 0)[0]
            if len(cs) == 0:
                continue
            d, s = f // 2, f % 2
            on = lat[:, d] == (0 if s == 0 else p)
            mask[cd[np.ix_(cs, np.where(on)[0])].reshape(-1)] = True
        return mask

    @cached_property
    def points(self) -> np.ndarray:
        """(n_dofs, dim) physical DoF support points (isoparametric GLL lattice).

        Shared DoFs receive identical coordinates from every adjacent cell
        (the mapping restricted to a shared entity depends only on that
        entity's data), so a last-write-wins scatter is exact.
        """
        sp = self.mesh.cell_mapping_points(self.degree)  # (C, L, dim)
        pts = np.zeros((self.n_dofs, self.mesh.dim))
        cd = self.cell_dofs
        pts[cd.reshape(-1)] = sp.reshape(-1, self.mesh.dim)
        return pts


def _canonical_quad_vec(corners: np.ndarray) -> np.ndarray:
    """Vectorized canonical corner order (origin, u-nb, v-nb, diag).

    corners: (..., 4) face-lex (c00, c10, c01, c11).  Origin = smallest id;
    u-neighbor = smaller adjacent corner of the origin."""
    c00, c10, c01, c11 = (corners[..., i] for i in range(4))
    stack = np.stack([c00, c10, c01, c11], axis=-1)
    argmin = np.argmin(stack, axis=-1)  # which face-lex corner is the origin
    # adjacency in face-lex indexing: 0:(1,2), 1:(0,3), 2:(3,0), 3:(2,1); diag: 3,2,1,0
    adj = np.array([[1, 2], [0, 3], [3, 0], [2, 1]])
    diag = np.array([3, 2, 1, 0])
    o = np.take_along_axis(stack, argmin[..., None], axis=-1)[..., 0]
    n1 = np.take_along_axis(stack, adj[argmin][..., 0:1], axis=-1)[..., 0]
    n2 = np.take_along_axis(stack, adj[argmin][..., 1:2], axis=-1)[..., 0]
    u = np.minimum(n1, n2)
    v = np.maximum(n1, n2)
    d = np.take_along_axis(stack, diag[argmin][..., None], axis=-1)[..., 0]
    return np.stack([o, u, v, d], axis=-1)


def _quad_uv_vec(canon: np.ndarray, local: np.ndarray, s: int, t: int, p: int):
    """Vectorized map of local face coords (s, t) to canonical (u, v).

    canon: (..., 4) canonical ids (o, u-nb, v-nb, diag); local: (..., 4)
    face-lex ids (c00, c10, c01, c11) with s toward c10, t toward c01.
    One of the 8 D4 transforms per face (reduced_access.h:38-66 analog)."""
    # canonical (u, v) of each of the 4 canonical slots
    slot_uv = np.array([[0, 0], [p, 0], [0, p], [p, p]])
    # for each local corner find its slot in canon
    # match[..., i] = position of local[..., i] within canon[..., :]
    eq = local[..., :, None] == canon[..., None, :]  # (..., 4local, 4canon)
    match = np.argmax(eq, axis=-1)  # (..., 4)
    pu = slot_uv[match][..., 0]  # (..., 4) canonical u of local corners
    pv = slot_uv[match][..., 1]
    # affine in (s, t): x = x00 + s/p·(x10 − x00) + t/p·(x01 − x00)
    u = pu[..., 0] + (s * (pu[..., 1] - pu[..., 0]) + t * (pu[..., 2] - pu[..., 0])) // p
    v = pv[..., 0] + (s * (pv[..., 1] - pv[..., 0]) + t * (pv[..., 2] - pv[..., 0])) // p
    return u, v
