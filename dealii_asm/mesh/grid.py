"""Structured tensor-product meshes with analytic deformations.

Array-first replacement for deal.II's ``parallel::distributed::Triangulation`` +
``MappingQCache`` as used by the reference
(/root/reference/element_centered_preconditioners_01.cc:302,419-427).  A mesh is a
logically-Cartesian grid of cells over a box, optionally deformed by an analytic
transform; all geometry tables are structure-of-arrays NumPy built once on host and
baked as device arrays.

Provides the patch-geometry queries of the reference's L1 layer:
``harmonic_cell_extents`` and ``harmonic_patch_extents``
(/root/reference/include/grid_tools.h:11-138) and neighbor topology with
periodicity (/root/reference/include/grid_tools.h:199-347).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np

from ..fem.lagrange import gauss_lobatto_points, gauss_points, shape_1d


@dataclass(frozen=True)
class StructuredMesh:
    """Logically-Cartesian mesh of ``n_cells`` uniform cells over a box.

    Cells are indexed lexicographically (x fastest). ``transform`` maps box
    coordinates (N, dim) -> (N, dim); geometry (Jacobians, extents) is computed
    from an isoparametric Q_m mapping whose support points are the transformed
    GLL lattice of each cell (mirrors MappingQCache initialized by a lambda).
    """

    dim: int
    n_cells: tuple[int, ...]
    lengths: tuple[float, ...] = None  # box side lengths; default all 1.0
    periodic: tuple[bool, ...] = None
    transform: object = None  # callable (N, dim) -> (N, dim) or None
    origin: tuple[float, ...] = None  # box lower corner; default all 0.0

    def __post_init__(self):
        if self.lengths is None:
            object.__setattr__(self, "lengths", tuple(1.0 for _ in range(self.dim)))
        if self.periodic is None:
            object.__setattr__(self, "periodic", tuple(False for _ in range(self.dim)))
        if self.origin is None:
            object.__setattr__(self, "origin", tuple(0.0 for _ in range(self.dim)))
        assert len(self.n_cells) == self.dim

    # -- topology -----------------------------------------------------------

    @property
    def n_cells_total(self) -> int:
        return int(np.prod(self.n_cells))

    @property
    def h(self) -> np.ndarray:
        """Cell widths in box coordinates (before transform)."""
        return np.array(self.lengths) / np.array(self.n_cells)

    def cell_multi_index(self) -> np.ndarray:
        """(C, dim) integer cell coordinates, lexicographic with x fastest."""
        # meshgrid 'ij' makes the first axis slowest; we want x fastest so build
        # with reversed order then flip columns.
        grids = np.meshgrid(*[np.arange(n) for n in reversed(self.n_cells)], indexing="ij")
        mi = np.stack([g.ravel() for g in reversed(grids)], axis=1)
        return mi  # column d = coordinate along dim d

    def cell_flat_index(self, mi: np.ndarray) -> np.ndarray:
        """Flatten (… , dim) multi-indices (x fastest)."""
        strides = np.cumprod([1] + list(self.n_cells[:-1]))
        return (mi * strides).sum(axis=-1)

    def neighbors(self) -> np.ndarray:
        """(C, dim, 2) flat cell index of the lower/upper neighbor; -1 if none.

        Periodic wrap per dim (cf. extract_all_surrounding_cells_cartesian,
        /root/reference/include/grid_tools.h:199-289).
        """
        mi = self.cell_multi_index()
        out = np.full((self.n_cells_total, self.dim, 2), -1, dtype=np.int64)
        for d in range(self.dim):
            for side, shift in ((0, -1), (1, +1)):
                nb = mi.copy()
                nb[:, d] += shift
                if self.periodic[d]:
                    nb[:, d] %= self.n_cells[d]
                    valid = np.ones(len(mi), dtype=bool)
                else:
                    valid = (nb[:, d] >= 0) & (nb[:, d] < self.n_cells[d])
                    nb[:, d] = np.clip(nb[:, d], 0, self.n_cells[d] - 1)
                flat = self.cell_flat_index(nb)
                out[:, d, side] = np.where(valid, flat, -1)
        return out

    # -- geometry -----------------------------------------------------------

    def box_points(self, unit_pts: np.ndarray) -> np.ndarray:
        """Map per-cell reference coords (P, dim) in [0,1]^dim to box coords (C, P, dim)."""
        mi = self.cell_multi_index().astype(np.float64)  # (C, dim)
        h = self.h
        return np.asarray(self.origin)[None, None, :] + (
            mi[:, None, :] + unit_pts[None, :, :]
        ) * h[None, None, :]

    def physical_points(self, unit_pts: np.ndarray) -> np.ndarray:
        """Physical coordinates of per-cell reference points: (C, P, dim)."""
        pts = self.box_points(unit_pts)
        if self.transform is None:
            return pts
        C, P, d = pts.shape
        return np.asarray(self.transform(pts.reshape(C * P, d))).reshape(C, P, d)

    def mapping_support_points(self, mapping_degree: int) -> np.ndarray:
        """(C, (m+1)^dim, dim) isoparametric Q_m support points (GLL lattice), x fastest."""
        gll = gauss_lobatto_points(mapping_degree + 1)
        lattice = _tensor_lattice(gll, self.dim)
        return self.physical_points(lattice)

    def jacobian_factors(self, mapping_degree: int, quad_pts_1d: np.ndarray):
        """(B, sp) with J[c,q,e,d] = Σ_l B[q,l,d]·sp[c,l,e] — the factors of
        the Jacobian contraction, so callers can run it through XLA
        (ops/geometry.py:merged_det_coeff) instead of host numpy."""
        sp = self.mapping_support_points(mapping_degree)  # (C, L, dim)
        from ..fem.lagrange import lagrange_values, lagrange_derivatives

        gll = gauss_lobatto_points(mapping_degree + 1)
        N = lagrange_values(gll, quad_pts_1d)       # (q, m+1)
        D = lagrange_derivatives(gll, quad_pts_1d)  # (q, m+1)
        # Gradient tensor B[q_flat, l_flat, d] via tensor products (x fastest).
        B = _tensor_gradient(N, D, self.dim)        # (Q, L, dim)
        return B, sp

    def jacobians(self, mapping_degree: int, quad_pts_1d: np.ndarray) -> np.ndarray:
        """Jacobians dx/dξ at the tensor quadrature points.

        Returns (C, Q, dim, dim) with J[c,q,e,d] = ∂x_e/∂ξ_d where ξ is the unit
        reference coordinate of the cell. Q = len(quad_pts_1d)**dim, x fastest.
        """
        B, sp = self.jacobian_factors(mapping_degree, quad_pts_1d)
        return np.einsum("qld,cle->cqed", B, sp, optimize=True)

    def harmonic_cell_extents(self, n_q_1d: int = 2,
                              mapping_degree: int | None = None) -> np.ndarray:
        """(C, dim) quadrature-averaged distance between opposite face points.

        Mirrors compute_harmonic_cell_extend
        (/root/reference/include/grid_tools.h:11-50): for each axis d, average
        over face quadrature points of |x(face0, q) - x(face1, q)|.

        mapping_degree: evaluate the face points through the degree-m
        ISOPARAMETRIC mapping (the reference's FEFaceValues sees the
        MappingQCache-interpolated geometry, not the analytic transform —
        the operator here does too, mesh/grid.py jacobian_factors).  None
        keeps the analytic evaluation (historic default; the Kershaw
        parity probe measures the difference, results_r5.md).
        """
        C = self.n_cells_total
        if self.transform is None:
            # axis-aligned affine: extents are the box cell widths exactly
            return np.broadcast_to(self.h, (C, self.dim)).copy()
        q, w = gauss_points(n_q_1d)

        def to_physical(unit_pts):
            if mapping_degree is None:
                return self.physical_points(unit_pts)
            from ..fem.lagrange import lagrange_values

            gll = gauss_lobatto_points(mapping_degree + 1)
            sp = self.mapping_support_points(mapping_degree)  # (C, L, dim)
            m1 = mapping_degree + 1
            vals = [lagrange_values(gll, unit_pts[:, d])  # (P, m1)
                    for d in range(self.dim)]
            N = vals[0]
            for d in range(1, self.dim):
                # support lattice x fastest: l = (..·m1 + l1)·m1 + l0
                N = (vals[d][:, :, None] * N[:, None, :]).reshape(
                    N.shape[0], -1)
            return np.einsum("pl,cld->cpd", N, sp)

        out = np.empty((C, self.dim))
        for d in range(self.dim):
            # face quadrature lattice on the two faces orthogonal to axis d
            axes = [q] * self.dim
            face_pts = []
            for val in (0.0, 1.0):
                coords = axes.copy()
                coords[d] = np.array([val])
                face_pts.append(_tensor_lattice_nd(coords))
            p0 = to_physical(face_pts[0])  # (C, Qf, dim)
            p1 = to_physical(face_pts[1])
            dist = np.linalg.norm(p1 - p0, axis=2)  # (C, Qf)
            wf = _tensor_weights([w if i != d else np.array([1.0]) for i in range(self.dim)])
            out[:, d] = dist @ wf
        return out

    def max_aspect_ratio(self, n_q_1d: int = 2) -> float:
        """Max ratio of Jacobian singular values over quadrature points
        (GridTools::compute_maximum_aspect_ratio analog, used for the driver's
        aspect_ratio column)."""
        if self.transform is None:
            h = self.h
            return float(h.max() / h.min())
        from ..fem.lagrange import gauss_points

        q, _ = gauss_points(n_q_1d)
        J = self.jacobians(1, q)  # (C, Q, dim, dim)
        s = np.linalg.svd(J, compute_uv=False)  # (C, Q, dim) descending
        return float((s[..., 0] / s[..., -1]).max())

    def harmonic_patch_extents(self, n_q_1d: int = 2,
                               mapping_degree: int | None = None) -> np.ndarray:
        """(C, dim, 3) extents [left-neighbor, own, right-neighbor]; 0 if no neighbor.

        Mirrors compute_harmonic_patch_extend
        (/root/reference/include/grid_tools.h:54-138) including periodicity.
        DEALII_ASM_EXTENT_MAPPING_DEGREE overrides the mapping used for
        the face-point evaluation (parity experiment, see
        harmonic_cell_extents).
        """
        import os as _os

        env = _os.environ.get("DEALII_ASM_EXTENT_MAPPING_DEGREE")
        if env and mapping_degree is None:
            mapping_degree = int(env)
        ext = self.harmonic_cell_extents(n_q_1d, mapping_degree)
        nbr = self.neighbors()
        C = self.n_cells_total
        out = np.zeros((C, self.dim, 3))
        out[:, :, 1] = ext
        for d in range(self.dim):
            for side in (0, 1):
                n = nbr[:, d, side]
                valid = n >= 0
                out[valid, d, 2 * side] = ext[n[valid], d]
        return out


def _tensor_lattice(pts_1d: np.ndarray, dim: int) -> np.ndarray:
    """Tensor lattice of identical 1D point sets: ((n)^dim, dim), x fastest."""
    return _tensor_lattice_nd([pts_1d] * dim)


def _tensor_lattice_nd(pts: list[np.ndarray]) -> np.ndarray:
    """Tensor lattice from per-dim 1D point sets, x fastest in the flat index."""
    dim = len(pts)
    grids = np.meshgrid(*reversed(pts), indexing="ij")  # slowest = last dim
    return np.stack([g.ravel() for g in reversed(grids)], axis=1)


def _tensor_weights(ws: list[np.ndarray]) -> np.ndarray:
    """Tensor-product quadrature weights, x fastest in the flat index."""
    w = ws[0]
    for wn in ws[1:]:
        w = (wn[:, None] * w[None, :]).ravel()
    return w


def _tensor_gradient(N: np.ndarray, D: np.ndarray, dim: int) -> np.ndarray:
    """Full gradient tensor B[q, l, d] from 1D values/derivatives (x fastest)."""
    nq, nl = N.shape
    mats = []
    for d in range(dim):
        # product over dims: axis d uses D, others N; build with kron in
        # slowest-to-fastest order (z, y, x) so that x is fastest.
        m = np.array([[1.0]])
        for e in reversed(range(dim)):
            m = np.kron(m, D if e == d else N)
        mats.append(m)
    return np.stack(mats, axis=2)  # (nq^dim, nl^dim, dim)


def create_mesh_from_cells(mesh: StructuredMesh, cell_ids) -> "object":
    """Standalone UnstructuredMesh from a cell subset of a structured mesh.

    Rebuilds create_mesh_from_cells (/root/reference/include/grid_generator.h:
    9-103): vertices are the (transformed) physical corner positions of the
    selected cells, renumbered consecutively; cell connectivity is preserved.
    """
    from .unstructured import UnstructuredMesh, _VERTEX_COORDS

    mi = mesh.cell_multi_index()[np.asarray(cell_ids)]  # (Cs, dim)
    dim = mesh.dim
    vc = _VERTEX_COORDS[dim]
    corners = mi[:, None, :] + vc[None, :, :]  # (Cs, 2^dim, dim) lattice coords
    flat = corners.reshape(-1, dim)
    uniq, inv = np.unique(flat, axis=0, return_inverse=True)
    h = mesh.h
    pts = np.asarray(mesh.origin)[None, :] + uniq * h[None, :]
    if mesh.transform is not None:
        pts = np.asarray(mesh.transform(pts))
    cells = inv.reshape(corners.shape[:2])
    return UnstructuredMesh(dim, pts.astype(np.float64),
                           cells.astype(np.int64))


def patch_submesh(mesh: StructuredMesh, cell_id: int) -> tuple:
    """The 3^dim surrounding-cell patch of ``cell_id`` as an exact offset
    StructuredMesh (same transform, shifted origin/box).

    Returns (submesh, lower_extent) where lower_extent[d] ∈ {0, 1} says
    whether the lower neighbor exists (extract_all_surrounding_cells_cartesian
    analog, /root/reference/include/grid_tools.h:199-289, for the structured
    case — periodic wrap is not folded in: periodic axes always have both
    neighbors and use the wrapped geometry, which is identical for uniform h).
    """
    mi = mesh.cell_multi_index()[cell_id]
    h = mesh.h
    lo = []
    n_sub = []
    for d in range(mesh.dim):
        has_l = mesh.periodic[d] or mi[d] > 0
        has_r = mesh.periodic[d] or mi[d] < mesh.n_cells[d] - 1
        lo.append(1 if has_l else 0)
        n_sub.append(1 + (1 if has_l else 0) + (1 if has_r else 0))
    origin = tuple(mesh.origin[d] + (mi[d] - lo[d]) * h[d]
                   for d in range(mesh.dim))
    lengths = tuple(n_sub[d] * h[d] for d in range(mesh.dim))
    sub = StructuredMesh(mesh.dim, tuple(n_sub), lengths=lengths,
                         origin=origin, transform=mesh.transform)
    return sub, tuple(lo)
