"""Unstructured hexahedral/quadrilateral meshes with manifold-aware refinement.

Array-first replacement for deal.II's ``Triangulation`` on genuinely unstructured
geometries — the hyperball family of the reference driver
(/root/reference/element_centered_preconditioners_01.cc:398-408 uses
``GridGenerator::hyper_ball_balanced``) needs cells whose local coordinate
systems rotate relative to each other, which the structured lattice cannot
express.

Design: plain structure-of-arrays NumPy on host —
- ``vertices`` (V, dim), ``cells`` (C, 2^dim) vertex ids in *lexicographic*
  local order (x fastest: (0,0,0),(1,0,0),(0,1,0),(1,1,0),(0,0,1),…), matching
  deal.II's vertex convention;
- boundary manifold: an optional ``project`` callable that snaps newly created
  boundary vertices to the curved boundary (spherical for the ball), playing
  the role of deal.II's SphericalManifold attached to boundary faces;
- ``refine()`` splits every cell into 2^dim children (child index = octant,
  x fastest) and records ``parent_cells`` for MG transfer.

All orientation bookkeeping (which way a shared edge/face is traversed by each
adjacent cell) is resolved *here on the host* and baked into downstream index
tables; device code sees plain gathers (the array-native answer to
/root/reference/include/reduced_access.h's runtime orientation decoding).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import functools

import numpy as np

# lexicographic local vertex coordinates (x fastest), dim 2 and 3
_VERTEX_COORDS = {
    2: np.array([[0, 0], [1, 0], [0, 1], [1, 1]], dtype=np.int64),
    3: np.array(
        [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
         [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]], dtype=np.int64),
}

# deal.II face numbering: face 2d+s is orthogonal to axis d, side s (0=lo, 1=hi).
# Local vertex ids of each face, in the face's own lexicographic order
# (fastest axis = lowest remaining axis).  Cached: face_key() is called per
# cell-face in setup loops (recomputing this table dominated the 131k-cell
# ball FDM setup — treat the returned arrays as read-only).
@functools.lru_cache(maxsize=None)
def _face_vertices(dim: int) -> list[np.ndarray]:
    vc = _VERTEX_COORDS[dim]
    faces = []
    for d in range(dim):
        for s in (0, 1):
            ids = np.where(vc[:, d] == s)[0]
            # order by remaining axes, lowest axis fastest
            rem = [e for e in range(dim) if e != d]
            key = np.zeros(len(ids))
            mult = 1
            for e in rem:
                key = key + vc[ids, e] * mult
                mult *= 2
            faces.append(ids[np.argsort(key, kind="stable")])
    return faces


# local edges (3D): 12 edges, each a pair of local vertex ids, along axis d
def _edge_vertices(dim: int) -> list[tuple[int, int, int]]:
    """List of (v0, v1, axis) local edges."""
    vc = _VERTEX_COORDS[dim]
    out = []
    n = len(vc)
    for a in range(n):
        for b in range(a + 1, n):
            diff = vc[b] - vc[a]
            if np.abs(diff).sum() == 1:
                axis = int(np.argmax(np.abs(diff)))
                out.append((a, b, axis))
    return out


@dataclass
class UnstructuredMesh:
    """General quad/hex mesh; cells reference vertices in lexicographic order.

    Mutation contract: all fields are public, but the mesh memoizes derived
    topology/geometry tables (face tables, mapping points, harmonic extents).
    Any in-place mutation of ``cells``/``vertices``/``chart*`` MUST call
    ``invalidate_caches()`` afterwards (the two in-tree mutation sites —
    cell flips in ``_fix_cell_orientations`` and chart attachment — do).
    Cached arrays are returned read-only (``writeable=False``) so a caller
    mutating a result in place fails loudly instead of poisoning the cache.
    """

    dim: int
    vertices: np.ndarray               # (V, dim) float64
    cells: np.ndarray                  # (C, 2^dim) int64
    project: object = None             # callable (pts (N,dim)) -> (N,dim) boundary projection
    parent_cells: np.ndarray | None = None  # (C,) parent cell index after refine
    child_index: np.ndarray | None = None   # (C,) octant within parent
    # transfinite chart (TransfiniteInterpolationManifold analog): geometry as
    # a smooth map over the COARSE cells; refined cells remember their ref
    # sub-box within the coarse ancestor so every vertex / mapping support
    # point evaluates the chart exactly (no accumulated chord error)
    chart: object = None               # .eval(cell_ids (N,), ref (N,dim)) -> (N,dim)
    chart_cell: np.ndarray | None = None  # (C,) coarse ancestor id
    chart_lo: np.ndarray | None = None    # (C, dim) ref sub-box lower corner
    chart_h: np.ndarray | None = None     # (C,) ref sub-box size (1/2^level)

    # -- topology ------------------------------------------------------------


    @property
    def n_cells_total(self) -> int:
        return int(self.cells.shape[0])

    @property
    def n_vertices(self) -> int:
        return int(self.vertices.shape[0])

    def face_key(self, cell: int, face: int) -> tuple:
        fv = _face_vertices(self.dim)[face]
        return tuple(sorted(self.cells[cell, fv]))

    def invalidate_caches(self) -> None:
        """Drop memoized topology/geometry tables after in-place mutation
        (cell flips in _fix_cell_orientations, chart attachment)."""
        for name in ("_face_tables_cache", "_mapping_points_cache",
                     "_cell_extents_cache"):
            if hasattr(self, name):
                delattr(self, name)

    def _face_tables(self):
        """Cached (neighbor cell, neighbor face) per (cell, face), vectorized.

        Sort all C·2dim face-vertex keys lexicographically; interior faces
        appear exactly twice as adjacent rows (grid_tools.h:172-289 walk,
        done once for the whole mesh instead of per query)."""
        cached = getattr(self, "_face_tables_cache", None)
        if cached is not None:
            return cached
        fv = _face_vertices(self.dim)
        C = self.n_cells_total
        F = 2 * self.dim
        keys = np.sort(
            np.stack([self.cells[:, fv[f]] for f in range(F)], axis=1),
            axis=2).reshape(C * F, -1)
        order = np.lexsort(keys.T[::-1])
        s = keys[order]
        eq = np.all(s[1:] == s[:-1], axis=1)
        if np.any(eq[1:] & eq[:-1]):
            raise ValueError("non-manifold face")
        a, b = order[:-1][eq], order[1:][eq]
        nbr = np.full(C * F, -1, dtype=np.int64)
        nface = np.full(C * F, -1, dtype=np.int64)
        nbr[a], nbr[b] = b // F, a // F
        nface[a], nface[b] = b % F, a % F
        cached = (nbr.reshape(C, F), nface.reshape(C, F))
        for arr in cached:
            arr.flags.writeable = False
        self._face_tables_cache = cached
        return cached

    def face_neighbors(self) -> np.ndarray:
        """(C, 2*dim) neighbor cell id across each face; -1 at the boundary."""
        return self._face_tables()[0]

    def face_neighbor_faces(self) -> np.ndarray:
        """(C, 2*dim) the neighbor's local face index sharing each face; -1."""
        return self._face_tables()[1]

    def boundary_faces(self) -> list[tuple[int, int]]:
        nbr = self.face_neighbors()
        return [(c, f) for c in range(self.n_cells_total)
                for f in range(2 * self.dim) if nbr[c, f] < 0]

    def boundary_vertex_mask(self) -> np.ndarray:
        fv = _face_vertices(self.dim)
        nbr = self.face_neighbors()
        mask = np.zeros(self.n_vertices, dtype=bool)
        for f in range(2 * self.dim):
            bc = nbr[:, f] < 0
            if bc.any():
                mask[self.cells[bc][:, fv[f]].ravel()] = True
        return mask

    # -- refinement ------------------------------------------------------------

    def refine(self) -> "UnstructuredMesh":
        """Split every cell into 2^dim children (isotropic refinement).

        New vertices: edge midpoints, face midpoints (3D), cell centers —
        shared through entity-key dictionaries so the refined mesh is
        conforming.  New *boundary* vertices (all parent entity vertices on the
        boundary) are passed through ``project`` (the manifold), matching
        deal.II's boundary-manifold refinement semantics.
        """
        dim = self.dim
        verts = [self.vertices]
        next_id = self.n_vertices
        bnd = self.boundary_vertex_mask()
        nbr = self.face_neighbors()
        fv = _face_vertices(dim)
        vc_f = _VERTEX_COORDS[dim].astype(np.float64)
        cc, clo, ch = self._chart_boxes()

        new_pts: list[np.ndarray] = []
        new_on_boundary: list[bool] = []
        # chart bookkeeping for new vertices: (coarse cell, coarse ref coords)
        new_chart_cell: list[int] = []
        new_chart_ref: list[np.ndarray] = []

        def _mk(point: np.ndarray, on_bnd: bool, cell: int = -1,
                local_ref: np.ndarray | None = None) -> int:
            nonlocal next_id
            new_pts.append(point)
            new_on_boundary.append(on_bnd)
            if self.chart is not None:
                new_chart_cell.append(int(cc[cell]))
                new_chart_ref.append(clo[cell] + ch[cell] * local_ref)
            next_id += 1
            return next_id - 1

        # edge midpoints
        edge_mid: dict[tuple, int] = {}
        edges = _edge_vertices(dim)
        # which edges lie on the boundary: an edge is on the boundary iff it
        # belongs to some boundary face
        bnd_edges: set[tuple] = set()
        for c in range(self.n_cells_total):
            for f in range(2 * dim):
                if nbr[c, f] >= 0:
                    continue
                face_glob = self.cells[c, fv[f]]
                k = len(face_glob)
                if dim == 2:
                    bnd_edges.add(tuple(sorted(face_glob)))
                else:
                    # the 4 edges of the quad face (lex order: 0-1, 2-3, 0-2, 1-3)
                    for a, b in ((0, 1), (2, 3), (0, 2), (1, 3)):
                        bnd_edges.add(tuple(sorted((face_glob[a], face_glob[b]))))
        for c in range(self.n_cells_total):
            cv = self.cells[c]
            for (a, b, _ax) in edges:
                key = tuple(sorted((cv[a], cv[b])))
                if key in edge_mid:
                    continue
                mid = 0.5 * (self.vertices[key[0]] + self.vertices[key[1]])
                on_b = key in bnd_edges
                if on_b and self.project is not None and self.chart is None:
                    mid = np.asarray(self.project(mid[None, :]))[0]
                edge_mid[key] = _mk(mid, on_b, c, 0.5 * (vc_f[a] + vc_f[b]))

        # face midpoints (3D)
        face_mid: dict[tuple, int] = {}
        if dim == 3:
            for c in range(self.n_cells_total):
                for f in range(2 * dim):
                    key = self.face_key(c, f)
                    if key in face_mid:
                        continue
                    pts = self.vertices[list(key)]
                    mid = pts.mean(axis=0)
                    on_b = nbr[c, f] < 0
                    if on_b and self.project is not None and self.chart is None:
                        mid = np.asarray(self.project(mid[None, :]))[0]
                    face_mid[key] = _mk(mid, on_b, c, vc_f[fv[f]].mean(axis=0))

        # cell centers
        centers = {}
        mid_ref = np.full(dim, 0.5)
        for c in range(self.n_cells_total):
            centers[c] = _mk(self.vertices[self.cells[c]].mean(axis=0), False,
                             c, mid_ref)

        all_vertices = np.concatenate(
            [self.vertices, np.array(new_pts).reshape(-1, dim)], axis=0)
        if self.chart is not None and new_chart_cell:
            # batch-evaluate the chart for every new vertex (straight midpoints
            # above were placeholders); shared entities were created once, from
            # one adjacent cell — chart conformity makes the choice immaterial
            ids = np.asarray(new_chart_cell, dtype=np.int64)
            refs = np.asarray(new_chart_ref)
            all_vertices[self.n_vertices:] = self.chart.eval(ids, refs)

        # children: local fine lattice 3^dim of (vertex|edge-mid|face-mid|center)
        vc = _VERTEX_COORDS[dim]
        children = []
        parents = []
        child_idx = []
        n_child = 2**dim
        for c in range(self.n_cells_total):
            cv = self.cells[c]
            # fine lattice ids: position (i,j,k) in {0,1,2}^dim
            lat = {}
            for li, coords in enumerate(vc):
                lat[tuple(2 * coords)] = cv[li]
            for (a, b, _ax) in edges:
                pos = tuple(vc[a] + vc[b])
                lat[pos] = edge_mid[tuple(sorted((cv[a], cv[b])))]
            if dim == 3:
                for f in range(2 * dim):
                    ids = fv[f]
                    pos = tuple(vc[ids].sum(axis=0) // 2)
                    lat[pos] = face_mid[self.face_key(c, f)]
            lat[tuple([1] * dim)] = centers[c]
            for ci in range(n_child):
                oc = vc[ci]  # octant offset
                verts_c = []
                for li in range(n_child):
                    pos = tuple(oc + vc[li])
                    verts_c.append(lat[pos])
                children.append(verts_c)
                parents.append(c)
                child_idx.append(ci)

        parents_a = np.asarray(parents, dtype=np.int64)
        child_a = np.asarray(child_idx, dtype=np.int64)
        kw = {}
        if self.chart is not None:
            oct_f = _VERTEX_COORDS[dim].astype(np.float64)
            kw = dict(chart=self.chart,
                      chart_cell=cc[parents_a],
                      chart_lo=clo[parents_a]
                      + 0.5 * ch[parents_a, None] * oct_f[child_a],
                      chart_h=0.5 * ch[parents_a])
        return UnstructuredMesh(
            dim=dim,
            vertices=all_vertices,
            cells=np.asarray(children, dtype=np.int64),
            project=self.project,
            parent_cells=parents_a,
            child_index=child_a,
            **kw,
        )

    def _chart_boxes(self):
        """(chart_cell, chart_lo, chart_h) with coarse-level defaults."""
        C = self.n_cells_total
        cc = (self.chart_cell if self.chart_cell is not None
              else np.arange(C, dtype=np.int64))
        clo = (self.chart_lo if self.chart_lo is not None
               else np.zeros((C, self.dim)))
        ch = (self.chart_h if self.chart_h is not None else np.ones(C))
        return cc, clo, ch

    def refine_global(self, n: int) -> "UnstructuredMesh":
        m = self
        for _ in range(n):
            m = m.refine()
        return m

    # -- geometry ---------------------------------------------------------------

    def cell_mapping_points(self, mapping_degree: int) -> np.ndarray:
        """(C, (m+1)^dim, dim) isoparametric Q_m support points (GLL lattice).

        Trilinear blend of the cell vertices, with boundary-face lattices
        projected to the manifold — the role MappingQCache plays for the
        reference's ball runs (element_centered_preconditioners_01.cc:398-401
        caps the ball's mapping at degree 2).
        """
        from ..fem.lagrange import gauss_lobatto_points

        cache = getattr(self, "_mapping_points_cache", None)
        if cache is None:
            cache = self._mapping_points_cache = {}
        hit = cache.get(mapping_degree)
        if hit is not None:
            return hit

        dim = self.dim
        gll = gauss_lobatto_points(mapping_degree + 1)
        from .grid import _tensor_lattice

        unit = _tensor_lattice(gll, dim)  # (L, dim), x fastest
        if self.chart is not None:
            # evaluate the transfinite chart at every lattice point: curved
            # geometry everywhere in the blended region, not just on the
            # boundary faces (TransfiniteInterpolationManifold semantics)
            cc, clo, ch = self._chart_boxes()
            C, L = self.n_cells_total, unit.shape[0]
            refs = clo[:, None, :] + ch[:, None, None] * unit[None, :, :]
            ids = np.repeat(cc, L)
            sp = self.chart.eval(ids, refs.reshape(C * L, dim)).reshape(
                C, L, dim)
            sp.flags.writeable = False
            cache[mapping_degree] = sp
            return sp
        # multilinear shape functions at unit points
        vc = _VERTEX_COORDS[dim].astype(np.float64)
        w = np.ones((unit.shape[0], vc.shape[0]))
        for d in range(dim):
            xd = unit[:, d][:, None]
            w = w * np.where(vc[None, :, d] > 0.5, xd, 1.0 - xd)
        sp = np.einsum("lv,cvd->cld", w, self.vertices[self.cells])  # (C, L, dim)

        if self.project is not None:
            sp = self._project_boundary_lattices(sp, unit, mapping_degree)
        sp.flags.writeable = False
        cache[mapping_degree] = sp
        return sp

    def _project_boundary_lattices(self, sp: np.ndarray, unit: np.ndarray,
                                   mapping_degree: int) -> np.ndarray:
        """Snap mapping support points on boundary faces AND boundary edges to
        the manifold.

        The edge pass covers cells that touch the curved boundary only along
        an edge (no boundary face): without it their mapping disagrees with
        the neighbor that owns the boundary face — a nonconforming geometry
        (deal.II attaches the manifold to boundary edges for the same reason).
        """
        dim = self.dim
        nbr = self.face_neighbors()
        for c, f in zip(*np.where(nbr < 0)):
            d, s = f // 2, f % 2
            on_face = np.isclose(unit[:, d], float(s))
            sp[c, on_face] = np.asarray(self.project(sp[c, on_face]))
        if dim == 3:
            # boundary-edge keys (encoded min·V + max)
            V = self.n_vertices
            fv = _face_vertices(dim)
            keys = []
            for c, f in zip(*np.where(nbr < 0)):
                fg = self.cells[c, fv[f]]
                for a, b in ((0, 1), (2, 3), (0, 2), (1, 3)):
                    lo, hi = sorted((int(fg[a]), int(fg[b])))
                    keys.append(lo * V + hi)
            bnd_edges = np.unique(np.asarray(keys, dtype=np.int64))
            for (a, b, ax) in _edge_vertices(dim):
                va = self.cells[:, a]
                vb = self.cells[:, b]
                k = np.minimum(va, vb) * V + np.maximum(va, vb)
                cs = np.where(np.isin(k, bnd_edges))[0]
                if len(cs) == 0:
                    continue
                # unit lattice points on that local edge: the two off-axis
                # coords pinned at the edge's corner values
                on = np.ones(unit.shape[0], dtype=bool)
                for d in range(dim):
                    if d == ax:
                        continue
                    on &= np.isclose(unit[:, d], float(_VERTEX_COORDS[dim][a][d]))
                idx = np.where(on)[0]
                pts = sp[np.ix_(cs, idx)].reshape(-1, dim)
                sp[np.ix_(cs, idx)] = np.asarray(self.project(pts)).reshape(
                    len(cs), len(idx), dim)
        return sp

    def jacobian_factors(self, mapping_degree: int, quad_pts_1d: np.ndarray):
        """(B, sp) with J[c,q,e,d] = Σ_l B[q,l,d]·sp[c,l,e] (see grid.py)."""
        from ..fem.lagrange import lagrange_derivatives, lagrange_values, gauss_lobatto_points
        from .grid import _tensor_gradient

        sp = self.cell_mapping_points(mapping_degree)
        gll = gauss_lobatto_points(mapping_degree + 1)
        N = lagrange_values(gll, quad_pts_1d)
        D = lagrange_derivatives(gll, quad_pts_1d)
        B = _tensor_gradient(N, D, self.dim)  # (Q, L, dim)
        return B, sp

    def jacobians(self, mapping_degree: int, quad_pts_1d: np.ndarray) -> np.ndarray:
        """(C, Q, dim, dim) J[c,q,e,d] = ∂x_e/∂ξ_d at tensor quadrature points."""
        B, sp = self.jacobian_factors(mapping_degree, quad_pts_1d)
        return np.einsum("qld,cle->cqed", B, sp, optimize=True)

    def harmonic_cell_extents(self, n_q_1d: int = 2) -> np.ndarray:
        """(C, dim) quadrature-averaged distance between opposite faces
        (compute_harmonic_cell_extend, /root/reference/include/grid_tools.h:11-50)."""
        from ..fem.lagrange import gauss_points
        from .grid import _tensor_lattice_nd, _tensor_weights

        cache = getattr(self, "_cell_extents_cache", None)
        if cache is None:
            cache = self._cell_extents_cache = {}
        hit = cache.get(n_q_1d)
        if hit is not None:
            return hit
        q, w = gauss_points(n_q_1d)
        C = self.n_cells_total
        out = np.empty((C, self.dim))
        mdeg = 1 if self.project is None else 2
        for d in range(self.dim):
            axes = [q] * self.dim
            face_pts = []
            for val in (0.0, 1.0):
                coords = list(axes)
                coords[d] = np.array([val])
                face_pts.append(_tensor_lattice_nd(coords))
            p0 = self._physical_points(face_pts[0], mdeg)
            p1 = self._physical_points(face_pts[1], mdeg)
            dist = np.linalg.norm(p1 - p0, axis=2)
            wf = _tensor_weights([w if i != d else np.array([1.0])
                                  for i in range(self.dim)])
            out[:, d] = dist @ wf
        out.flags.writeable = False
        cache[n_q_1d] = out
        return out

    def _physical_points(self, unit_pts: np.ndarray, mapping_degree: int) -> np.ndarray:
        """(C, P, dim) images of per-cell reference points under the mapping."""
        from ..fem.lagrange import gauss_lobatto_points, lagrange_values

        sp = self.cell_mapping_points(mapping_degree)  # (C, L, dim)
        gll = gauss_lobatto_points(mapping_degree + 1)
        P = unit_pts.shape[0]
        per_dim = [lagrange_values(gll, unit_pts[:, d]) for d in range(self.dim)]
        # tensor basis values, local flat index l = Σ_d i_d·(m+1)^d (x fastest)
        w = per_dim[0]
        for d in range(1, self.dim):
            w = (per_dim[d][:, :, None] * w[:, None, :]).reshape(P, -1)
        return np.einsum("pl,cld->cpd", w, sp)

    def harmonic_patch_extents(self, n_q_1d: int = 2) -> np.ndarray:
        """(C, dim, 3) [left-neighbor, own, right-neighbor] extents along each
        LOCAL axis; 0 where there is no neighbor
        (compute_harmonic_patch_extend, grid_tools.h:54-138).

        The neighbor's extent is measured along ITS local axis orthogonal to
        the shared face — orientation-independent (it is a length).
        """
        ext = self.harmonic_cell_extents(n_q_1d)
        nbr = self.face_neighbors()
        nf = self.face_neighbor_faces()
        C = self.n_cells_total
        out = np.zeros((C, self.dim, 3))
        out[:, :, 1] = ext
        # for each face, the neighbor's extent along ITS axis orthogonal to
        # the shared face (vectorized over cells)
        for f in range(2 * self.dim):
            valid = nbr[:, f] >= 0
            d, s = f // 2, f % 2
            out[valid, d, 2 * s] = ext[nbr[valid, f], nf[valid, f] // 2]
        return out

    def max_aspect_ratio(self, n_q_1d: int = 2) -> float:
        from ..fem.lagrange import gauss_points

        q, _ = gauss_points(n_q_1d)
        mdeg = 1 if self.project is None else 2
        J = self.jacobians(mdeg, q)
        s = np.linalg.svd(J, compute_uv=False)
        return float((s[..., 0] / s[..., -1]).max())


# -- generators -----------------------------------------------------------------


class BallChart:
    """Transfinite chart for the balanced ball (the role deal.II's
    TransfiniteInterpolationManifold plays for GridGenerator::hyper_ball_balanced).

    Center-block cells are straight (multilinear).  Each shell cell has exactly
    one face on the sphere; its map is the straight multilinear blend plus the
    outer-face bulge — the radial projection of the bilinear outer-face point
    onto the sphere — faded linearly in the radial reference coordinate.  The
    fade is zero at the inner face (conforming with the straight center block)
    and the bulge on a shared radial face depends only on the shared outer
    edge, so adjacent shell cells agree: the refined mesh is watertight.
    Without this blend, interior refinement vertices sit on straight chords
    and the near-boundary cell layers shear (max aspect ratio 3.9 vs 2.4).
    """

    def __init__(self, vertices: np.ndarray, cells: np.ndarray, radius: float):
        self.dim = int(vertices.shape[1])
        self.corners = vertices[cells]        # (C, 2^dim, dim)
        self.radius = float(radius)
        C = cells.shape[0]
        self.axis = np.full(C, -1, dtype=np.int64)   # radial local axis
        self.side = np.zeros(C, dtype=np.int64)      # 1 if outer face at ref=1
        fv = _face_vertices(self.dim)
        r = np.linalg.norm(self.corners, axis=2)     # (C, 2^dim)
        on_sphere = np.isclose(r, radius, rtol=1e-9)
        for f in range(2 * self.dim):
            hit = on_sphere[:, fv[f]].all(axis=1)
            self.axis[hit] = f // 2
            self.side[hit] = f % 2

    @staticmethod
    def _blend(corners: np.ndarray, ref: np.ndarray) -> np.ndarray:
        """Multilinear blend: corners (N, 2^dim, dim) at ref (N, dim)."""
        dim = corners.shape[2]
        vc = _VERTEX_COORDS[dim].astype(np.float64)
        w = np.ones((ref.shape[0], vc.shape[0]))
        for d in range(dim):
            xd = ref[:, d][:, None]
            w = w * np.where(vc[None, :, d] > 0.5, xd, 1.0 - xd)
        return np.einsum("nv,nvd->nd", w, corners)

    def eval(self, ids: np.ndarray, ref: np.ndarray) -> np.ndarray:
        corners = self.corners[ids]
        out = self._blend(corners, ref)
        ax = self.axis[ids]
        idx = np.where(ax >= 0)[0]
        if len(idx) == 0:
            return out
        a = ax[idx]
        s = self.side[ids][idx]
        rows = np.arange(len(idx))
        ref_out = ref[idx].copy()
        ref_out[rows, a] = s.astype(np.float64)
        b_out = self._blend(corners[idx], ref_out)
        p_out = b_out / np.linalg.norm(b_out, axis=1, keepdims=True) * self.radius
        ra = ref[idx][rows, a]                       # radial reference coord
        w_rad = np.where(s > 0, ra, 1.0 - ra)
        out[idx] += w_rad[:, None] * (p_out - b_out)
        return out


def hyper_ball_balanced(dim: int, radius: float = 1.0) -> UnstructuredMesh:
    """Balanced ball mesh: 2^dim center cells + shell cells projected to the
    sphere — 12 cells in 2D, 32 in 3D (matching GridGenerator::hyper_ball_balanced
    cell counts used by the reference; data.pdf ball tables L=5 ⇒ 32·8^4 cells).

    Construction: the center block is a subdivided cube of half-width
    ``a = radius/(2·sqrt(dim))`` split into 2^dim cells; each of its outer
    surface quads/lines spawns one shell cell connecting it to the radial
    projection of its vertices onto the sphere.  New boundary vertices created
    during refinement are re-projected (``project``).
    """
    # inner half-width: swept for minimal refined max-aspect-ratio under the
    # transfinite chart (3D L3: 1.3 → 2.92; the pre-chart 1.6 → 3.98)
    a = radius / (2.0 * np.sqrt(dim)) * 1.3
    # center block: 2^dim cells over [-a, a]^dim, 3^dim lattice
    grid_1d = np.array([-a, 0.0, a])
    mesh_pts = np.meshgrid(*([grid_1d] * dim), indexing="ij")
    # lattice vertex ids (x fastest)
    shape = (3,) * dim
    lat_ids = np.arange(3**dim).reshape(shape)  # index [i_0, ..., i_{dim-1}]?
    # build vertices with x fastest: vertex (i, j, k) -> coords (x=i, y=j, z=k)
    pts = np.stack(np.meshgrid(*([grid_1d] * dim), indexing="ij"), axis=-1)
    pts = pts.reshape(-1, dim)  # index = i*9 + j*3 + k for dim 3 (x slowest!)
    # reorder so x is fastest: recompute with explicit strides
    coords = np.stack(np.meshgrid(*([np.arange(3)] * dim), indexing="ij"),
                      axis=-1).reshape(-1, dim)
    # want flat = sum_d idx_d * 3^d (x = dim 0 fastest)
    flat = sum(coords[:, d] * 3**d for d in range(dim))
    vertices = np.zeros((3**dim, dim))
    vertices[flat] = pts
    # the above maps coords (meshgrid order) to x-fastest flat ids; pts rows are
    # in meshgrid order with column d = grid_1d[coords[:, d]] — consistent.

    vc = _VERTEX_COORDS[dim]
    cells = []
    for ci in range(2**dim):
        base = vc[ci]
        cell = []
        for li in range(2**dim):
            pos = base + vc[li]
            cell.append(sum(pos[d] * 3**d for d in range(dim)))
        cells.append(cell)

    vertices = list(vertices)
    _cache = {tuple(np.round(v, 12)): i for i, v in enumerate(vertices)}

    def vertex_id(pt: np.ndarray) -> int:
        key = tuple(np.round(pt, 12))
        if key not in _cache:
            _cache[key] = len(vertices)
            vertices.append(np.asarray(pt, dtype=np.float64))
        return _cache[key]

    def proj(p):
        p = np.asarray(p, dtype=np.float64)
        nrm = np.linalg.norm(p, axis=-1, keepdims=True)
        return p / nrm * radius

    # shell cells: for each outer face of the center block, one cell between
    # the face and its spherical projection.  Outer faces of the block = faces
    # of the 2x2 block on the boundary of [-a, a]^dim: 2*dim*2^(dim-1) faces
    # (24 in 3D, 8 in 2D).
    block = UnstructuredMesh(dim, np.asarray(vertices), np.asarray(cells, dtype=np.int64))
    nbr = block.face_neighbors()
    fv = _face_vertices(dim)
    shell_cells = []
    for c in range(block.n_cells_total):
        for f in range(2 * dim):
            if nbr[c, f] >= 0:
                continue
            d, s = f // 2, f % 2
            inner = block.cells[c, fv[f]]  # (2^(dim-1),) inner quad/line, face-lex order
            outer = [vertex_id(proj(np.asarray(vertices[v]))) for v in inner]
            # cell = inner face + outer face along the face normal; orientation:
            # the new cell's local axis d' (say last axis) goes inner->outer if
            # s == 1, outer->inner if s == 0 — keep positive Jacobian by
            # ordering (lo side: outer first).
            if dim == 2:
                # face is a line (2 vertices in face-lex order); cell vertices
                # lexicographic: (v00, v10, v01, v11) with axis-1 = radial
                if s == 1:
                    cell = [inner[0], inner[1], outer[0], outer[1]]
                else:
                    cell = [outer[0], outer[1], inner[0], inner[1]]
            else:
                if s == 1:
                    cell = list(inner) + list(outer)
                else:
                    cell = list(outer) + list(inner)
            shell_cells.append(cell)

    all_cells = np.concatenate(
        [np.asarray(cells, dtype=np.int64),
         np.asarray(shell_cells, dtype=np.int64)], axis=0)
    mesh = UnstructuredMesh(dim, np.asarray(vertices, dtype=np.float64),
                            all_cells, project=proj)
    # fix inverted cells (negative Jacobian from face-ordering edge cases)
    _fix_cell_orientations(mesh)
    # transfinite chart AFTER orientation fixes (it reads the final cell
    # vertex order); `project` stays attached as the curved-geometry marker
    mesh.chart = BallChart(mesh.vertices, mesh.cells, radius)
    mesh.invalidate_caches()
    return mesh


def _fix_cell_orientations(mesh: UnstructuredMesh) -> None:
    """Flip cells with negative Jacobian determinant (swap along axis 0)."""
    q = np.array([0.5])
    J = mesh.jacobians(1, q)
    det = np.linalg.det(J[:, 0])
    bad = np.where(det <= 0)[0]
    if len(bad) == 0:
        return
    vc = _VERTEX_COORDS[mesh.dim]
    # swap local x: local index i maps to the index whose x-coordinate is flipped
    perm = np.empty(2**mesh.dim, dtype=np.int64)
    for i in range(2**mesh.dim):
        flipped = vc[i].copy()
        flipped[0] = 1 - flipped[0]
        perm[i] = int(np.where((vc == flipped).all(axis=1))[0][0])
    mesh.cells[bad] = mesh.cells[bad][:, perm]
    mesh.invalidate_caches()
    J = mesh.jacobians(1, q)
    det = np.linalg.det(J[:, 0])
    assert (det > 0).all(), "cell orientation fix failed"
