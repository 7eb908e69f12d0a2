"""Additive / restricted Schwarz preconditioner with FDM local solves.

JAX rebuild of ``ASPoissonPreconditioner``
(/root/reference/include/matrix_free.h:63-1568): element-centric (overlap
1..p) or vertex-star patches, local inverses by fast diagonalization, and
multiplicity weighting none/pre/post/symm
(/root/reference/include/restrictors.h:8-15) or RAS ownership coloring
(matrix_free.h:536-673).

The apply is one fused jitted program per call:
gather patches → ⊗_d Vᵀ transforms → eigenvalue-sum reciprocal scale →
⊗_d V transforms → (weight) → scatter-add.  The reference's MPI ghost
machinery (partitioners, pre/post ranges) disappears: the gather/scatter run
against the global DoF vector and XLA/`jax.sharding` insert any needed
collectives when the arrays are sharded (SURVEY.md §2d P3-P6 mapping).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..fem.dofs import DofHandler
from ..fem.patches import element_patch_indices, vertex_patch_indices
from ..utils.jitutils import precision_context
from .fdm import (
    FDMCollection,
    build_fdm_collection,
    fdm_1d_matrices,
    fdm_1d_matrices_batched,
    vertex_patch_1d_matrices,
    vertex_patch_1d_matrices_batched,
)


# Default precision of the FDM applies' f32 matmuls (the eigen-transforms):
# true f32.  A config may select TF32 for its FDM smoother
# ("matmul precision": "tensorfloat32"): measured on the H100 at 17M DoF,
# the apply then takes 1.67 ms against 2.79 ms (rel-L2 1.0e-3 against f64
# instead of 1.2e-7).  The e2e configs that select it were measured to keep
# their iteration counts (PERF.md, "Precision on the card").
FDM_MATMUL_PRECISION = "highest"


def fdm_matmul_precision(dtype, precision: str | None = None):
    """Matmul precision of an FDM apply in ``dtype``: ``precision`` or the
    default for f32 applies, none for f64 ones (their matmuls are f64)."""
    if np.dtype(dtype) == np.float64:
        return None
    return precision or FDM_MATMUL_PRECISION


def _dedup_collection(keys: np.ndarray, build,
                      build_batched=None) -> FDMCollection:
    """Build an FDMCollection from per-(patch, dim) keys and a builder.

    keys: (P, dim, k) float; build(d, key_row) -> (M, K).
    build_batched (optional): build_batched(d, uniq (U, k)) -> (M (U,m,m),
    K (U,m,m)) — used with the batched eigensolver so deformed meshes
    (every key distinct, U ≈ P) set up in vectorized numpy instead of a
    per-key Python loop (the >25-min wall of the 131k-cell ball at L=5).
    """
    import scipy.linalg as sla

    from .. import native
    from .fdm import batched_generalized_eigh

    def _eigh(K, M):
        out = native.generalized_eigh(K, M)
        if out is not None:
            return out
        return sla.eigh(K, M)

    P, dim, _ = keys.shape
    eigvecs, eigvals = [], []
    ids = np.zeros((P, dim), dtype=np.int32)
    for d in range(dim):
        uniq, inv = np.unique(keys[:, d, :], axis=0, return_inverse=True)
        ids[:, d] = inv.astype(np.int32)
        if build_batched is not None:
            M, K = build_batched(d, uniq)
            lam, V = batched_generalized_eigh(K, M)
            eigvecs.append(V)
            eigvals.append(lam)
            continue
        V = None
        lam = None
        for u, key in enumerate(uniq):
            M, K = build(d, tuple(key))
            w, v = _eigh(K, M)
            if V is None:
                V = np.zeros((len(uniq),) + M.shape)
                lam = np.zeros((len(uniq), M.shape[0]))
            V[u] = v
            lam[u] = w
        eigvecs.append(V)
        eigvals.append(lam)
    return FDMCollection(eigvecs, eigvals, ids)


def _batched_apply(mats: jnp.ndarray, u: jnp.ndarray, axis: int, transpose: bool):
    """Apply per-patch 1D matrices along one local tensor axis.

    mats: (C, m, m); u: (C, m, ..., m). transpose=True applies Vᵀ.
    """
    full_axis = 1 + axis
    u = jnp.moveaxis(u, full_axis, -1)
    if transpose:
        u = jnp.einsum("c...i,cij->c...j", u, mats)
    else:
        u = jnp.einsum("c...i,cji->c...j", u, mats)
    return jnp.moveaxis(u, -1, full_axis)


def _axis_apply_lanes(u, axis: int, Vt, transpose: bool):
    """Per-patch 1D transform along one local axis, patches on the LANE axis.

    u: (m, ..., m, P) local tensors with the (huge) patch axis LAST, so every
    intermediate is contiguous along the patch axis whatever m is.
    Vt: (m_in, m_out, P) storing V[p][j, i].  The contraction is m²
    unrolled broadcast-FMAs over (…, P) slabs — elementwise streaming, no
    dot_general with a megascale batch dimension.
    """
    u = jnp.moveaxis(u, axis, 0)  # (m, rest..., P)
    m = Vt.shape[0]
    outs = []
    for i in range(m):
        acc = None
        for j in range(m):
            c = Vt[j, i] if transpose else Vt[i, j]  # (P,)
            t = u[j] * c
            acc = t if acc is None else acc + t
        outs.append(acc)
    return jnp.moveaxis(jnp.stack(outs, 0), 0, axis)


def fdm_apply_lanes(W, m: int, dim: int, Vt, lams):
    """(L, P) -> (L, P) batched tensor-product inverse, patches on lanes.

    L = m^dim local DoFs (x fastest), P patches.  2·dim axis transforms as
    unrolled broadcast-FMAs (`_axis_apply_lanes`) + one reciprocal — every
    intermediate is (m, ..., m, P), perfectly tiled for any m.  Vt[d] is
    (m, m, P), lams[d] is (m, P)."""
    P = W.shape[-1]
    u = W.reshape((m,) * dim + (P,))
    for a in range(dim):
        d = dim - 1 - a
        u = _axis_apply_lanes(u, a, Vt[d], transpose=True)
    denom = None
    for a in range(dim):
        d = dim - 1 - a
        lam = lams[d]  # (m, P)
        shape = [1] * dim + [P]
        shape[a] = m
        lam_b = lam.reshape(shape)
        denom = lam_b if denom is None else denom + lam_b
    u = u / denom
    for a in range(dim):
        d = dim - 1 - a
        u = _axis_apply_lanes(u, a, Vt[d], transpose=False)
    return u.reshape(m**dim, P)


def build_lanes_tables(eigvecs, eigvals, ids, dim: int, dtype):
    """Lane-major per-patch eigen-transform tables: Vt_d (m, m, P) storing
    V[p][j, i] and λ_d (m, P), patch axis LAST (see `fdm_apply_lanes`)."""
    ids_np = np.asarray(ids)
    Vt, lam_t = [], []
    for d in range(dim):
        V = np.asarray(eigvecs[d])[ids_np[:, d]]  # (P, m, m)
        Vt.append(jnp.asarray(
            np.ascontiguousarray(V.transpose(1, 2, 0)), dtype))
        lam_d = np.asarray(eigvals[d])[ids_np[:, d]]  # (P, m)
        lam_t.append(jnp.asarray(
            np.ascontiguousarray(lam_d.T), dtype))
    return Vt, lam_t


class ASMPreconditioner:
    """Element-centric / vertex-patch additive Schwarz with FDM local solves."""

    def __init__(
        self,
        dofs: DofHandler,
        n_overlap: int = 1,
        weighting_type: str = "post",
        patch_type: str = "element",  # "element" | "vertex"
        dtype=jnp.float64,
        n_q_1d: int | None = None,
        matmul_precision: str | None = None,
    ):
        if weighting_type not in ("none", "pre", "post", "symm", "ras"):
            raise ValueError(weighting_type)
        self.dofs = dofs
        self.dim = dofs.mesh.dim
        self.degree = dofs.degree
        self.n_overlap = n_overlap
        self.weighting_type = weighting_type
        self.patch_type = patch_type
        self.dtype = dtype
        self.matmul_precision = fdm_matmul_precision(dtype, matmul_precision)

        p = self.degree
        mesh = dofs.mesh
        extents = mesh.harmonic_patch_extents(n_q_1d or (p + 1))  # (C, dim, 3)

        # Deduplicate BEFORE building 1D matrices: on quasi-uniform meshes there
        # are only a handful of unique (extents, boundary-flags) keys per
        # direction, so setup cost is O(cells) hashing + O(unique) eigensolves
        # (the reference's FDM collection dedups by matrix content the same way,
        # matrix_free.h:389 / TensorProductMatrixSymmetricSumCollection).
        if patch_type == "element":
            self.m = p - 1 + 2 * n_overlap
            idx = element_patch_indices(dofs, n_overlap)  # (C, m^dim)
            nbr = mesh.neighbors()  # (C, dim, 2)
            C = mesh.n_cells_total

            def build(d, key):
                h_l, h_c, h_r, has_l, has_r = key
                bc_l = "internal" if has_l else "dirichlet"
                bc_r = "internal" if has_r else "dirichlet"
                return fdm_1d_matrices(p, n_overlap, (h_l, h_c, h_r),
                                       bc_l, bc_r, n_q_1d)

            def build_batched(d, uniq):
                return fdm_1d_matrices_batched(
                    p, n_overlap, uniq[:, 0:3],
                    uniq[:, 3] > 0.5, uniq[:, 4] > 0.5, n_q_1d)

            keys = np.concatenate(
                [np.round(extents, 12),
                 (nbr[:, :, 0:1] >= 0).astype(np.float64),
                 (nbr[:, :, 1:2] >= 0).astype(np.float64)], axis=2)  # (C,dim,5)
            self.collection = _dedup_collection(keys, build, build_batched)
        elif patch_type == "vertex":
            self.m = 2 * p - 1
            idx, anchors = vertex_patch_indices(dofs)

            def build(d, key):
                h0, h1 = key
                return vertex_patch_1d_matrices(p, (h0, h1), n_q_1d)

            def build_batched(d, uniq):
                return vertex_patch_1d_matrices_batched(p, uniq, n_q_1d)

            # two cells per dim: anchor cell and its upper neighbor; the patch
            # extents are [own, right-neighbor] of the anchor
            keys = np.round(extents[anchors][:, :, 1:3], 12)  # (P, dim, 2)
            self.collection = _dedup_collection(keys, build, build_batched)
        else:
            raise ValueError(patch_type)

        # globally constrained DoFs read/write nothing: redirect to the pad slot
        n = dofs.n_dofs
        mask = dofs.boundary_mask
        idx = np.where(mask[np.clip(idx, 0, n - 1)] | (idx >= n), n, idx)
        self._patch_idx_np = idx.astype(np.int32)
        self._patch_idx_dev = None  # lazy: only the gather fallback needs it
        self.n_dofs = n
        self.constrained = jnp.asarray(mask)
        self.grid_shape = tuple(reversed(dofs.nodes_per_dim))
        # both patch kinds are strided lattice windows: element windows start
        # at c·p−(o−1) with stride p; vertex-star windows (size 2p−1) start at
        # v·p+1 — the same global-transform algebra applies to either
        self.access = "lattice"

        # weights
        valid = np.asarray(idx) < n
        counts = np.zeros(n + 1)
        np.add.at(counts, np.asarray(idx).reshape(-1), valid.reshape(-1).astype(np.float64))
        counts[counts == 0] = 1.0
        inv_count = 1.0 / counts
        inv_count[-1] = 0.0
        if weighting_type == "symm":
            w = np.sqrt(inv_count)
        else:
            w = inv_count
        self.weights = jnp.asarray(w[:-1], dtype)  # (n,)

        self.ras_mask = None
        if weighting_type == "ras":
            self.ras_mask = jnp.asarray(self._ras_ownership(np.asarray(idx)), dtype)

        # device tables
        coll = self.collection
        self.eigvecs = [jnp.asarray(v, dtype) for v in coll.eigvecs]
        self.eigvals = [jnp.asarray(l, dtype) for l in coll.eigvals]
        self.ids = jnp.asarray(coll.ids)

        # per-coordinate factorization: on tensor-product geometries the 1D
        # matrices for direction d depend only on the cell's d-coordinate, so
        # the eigen-transforms become per-coordinate batched matmuls on the
        # interleaved window layout (no per-cell table gather at all)
        self.percoord = self._try_percoord(np.asarray(coll.ids))

        # dense local inverses: P⁻¹_patch = S·diag(1/Σλ)·Sᵀ materialized as an
        # (L, L) matrix per unique boundary pattern (≤3^dim patterns on
        # quasi-uniform meshes).  The dominant pattern applies as ONE
        # (C, L)·(L, L) GEMM; minority patterns are static row-group fixups.
        self.dense = None
        if patch_type == "element" and self.ras_mask is None:
            self.dense = self._try_dense(np.asarray(coll.ids))

        # globally separable FDM: P⁻¹ = (⊗G_dᵀ)·diag(1/Σλ)·(⊗G_d) with
        # per-direction (C_d·m × N_d) transforms (ops/tensorops.py) — dense
        # axis matmuls, boundary patterns encoded in G's rows
        self.global_fdm = None
        if self.percoord is not None and self.ras_mask is None:
            from ..ops.tensorops import fdm_direction_transform

            # constraints and multiplicity weights are SEPARABLE per axis on
            # the structured lattice (a node is constrained iff any coordinate
            # touches a Dirichlet boundary; patch counts are per-axis
            # products), so they fold into the columns of the per-direction
            # transforms and the jitted apply carries NO O(n) constants
            # (grid-sized closure constants would be embedded in every
            # compiled program).
            a_in, a_out = {"none": (0.0, 0.0), "pre": (1.0, 0.0),
                           "post": (0.0, 1.0), "symm": (0.5, 0.5)}[weighting_type]
            Gs, Gts, lams = [], [], []
            for d in range(self.dim):
                V, lam = self.percoord[d]
                G = fdm_direction_transform(
                    np.asarray(V), dofs.nodes_per_dim[d], p, n_overlap,
                    mesh.periodic[d], patch=patch_type)
                free_d, w_d = self._axis_free_and_weight(d)
                Gs.append(jnp.asarray(G * (free_d * w_d**a_in)[None, :], dtype))
                Gts.append(jnp.asarray(
                    (G * (free_d * w_d**a_out)[None, :]).T, dtype))
                lams.append(jnp.asarray(np.asarray(lam).reshape(-1), dtype))
            self.global_fdm = (Gs, Gts, lams)

        # lane-major per-patch FDM tables — the scalable apply for meshes whose
        # 1D patch matrices do NOT factor per coordinate (Kershaw & friends):
        # every per-patch table and intermediate carries the patch axis LAST.
        self.lanes = None
        self.ras_mask_T = None
        if self.global_fdm is None:
            self._build_lanes()

        # vertex patches without the separable fast path (RAS coloring or a
        # non-factoring mesh) fall back to the index-gather apply; the element
        # fallback paths below use element window geometry only
        if patch_type == "vertex" and self.global_fdm is None:
            self.access = "gather"

        # inline=True: surface captured patch tables to the outer jaxpr so
        # utils/jitutils.jit_hoist_consts can pass them as arguments
        self._vmult = jax.jit(self._vmult_impl, inline=True)

    def _build_lanes(self):
        """Build the lane-major per-patch eigen-transform tables (see
        ``_axis_apply_lanes``): Vt_d (m, m, P) and λ_d (m, P), patch axis last."""
        coll = self.collection
        self.lanes = build_lanes_tables(coll.eigvecs, coll.eigvals, coll.ids,
                                        self.dim, self.dtype)
        if self.ras_mask is not None:
            self.ras_mask_T = jnp.asarray(
                np.ascontiguousarray(np.asarray(self.ras_mask).T))

    def _try_dense(self, ids: np.ndarray, max_combos: int = 64):
        combos, combo_ids = np.unique(ids, axis=0, return_inverse=True)
        if len(combos) > max_combos:
            return None
        coll = self.collection
        mats = []
        for combo in combos:
            S = np.array([[1.0]])
            lam = np.zeros((1,))
            for d in reversed(range(self.dim)):  # kron: x fastest
                Sd = np.asarray(coll.eigvecs[d][combo[d]])
                ld = np.asarray(coll.eigvals[d][combo[d]])
                S = np.kron(S, Sd)
                lam = (lam[:, None] + ld[None, :]).reshape(-1)
            mats.append((S / lam[None, :]) @ S.T)
        counts = np.bincount(combo_ids, minlength=len(combos))
        base = int(np.argmax(counts))
        groups = []
        for u in range(len(combos)):
            if u == base:
                continue
            rows = np.where(combo_ids == u)[0].astype(np.int32)
            groups.append((jnp.asarray(rows), jnp.asarray(mats[u], self.dtype)))
        return jnp.asarray(mats[base], self.dtype), groups

    def _axis_window_starts(self, d: int):
        """Window start nodes along direction d for this patch kind."""
        mesh = self.dofs.mesh
        p = self.degree
        if self.patch_type == "element":
            return [c * p - (self.n_overlap - 1)
                    for c in range(mesh.n_cells[d])]
        if mesh.periodic[d]:
            return [v * p - (p - 1) for v in range(mesh.n_cells[d])]
        return [v * p + 1 for v in range(mesh.n_cells[d] - 1)]

    def _axis_free_and_weight(self, d: int):
        """Per-axis free mask and 1D multiplicity weight (weights = ⊗_d w_d)."""
        dofs = self.dofs
        N = dofs.nodes_per_dim[d]
        free = np.ones(N)
        if not dofs.mesh.periodic[d]:
            free[0] = free[-1] = 0.0
        # per-axis window count of each node
        counts = np.zeros(N)
        for start in self._axis_window_starts(d):
            for s in range(self.m):
                n = start + s
                if dofs.mesh.periodic[d]:
                    n %= N
                elif n < 0 or n >= N:
                    continue
                counts[n] += 1.0
        counts[counts == 0] = 1.0
        return free, 1.0 / counts

    @property
    def patch_idx(self):
        if self._patch_idx_dev is None:
            with jax.ensure_compile_time_eval():  # trace-safe lazy constant
                self._patch_idx_dev = jnp.asarray(self._patch_idx_np)
        return self._patch_idx_dev

    @patch_idx.setter
    def patch_idx(self, v):
        self._patch_idx_dev = v

    @property
    def patch_idx_T(self):
        """(L, P) transposed index table for the lane-major gather path."""
        if getattr(self, "_patch_idx_T_dev", None) is None:
            with jax.ensure_compile_time_eval():
                self._patch_idx_T_dev = jnp.asarray(
                    np.ascontiguousarray(self._patch_idx_np.T))
        return self._patch_idx_T_dev

    def _try_percoord(self, ids: np.ndarray):
        mesh = self.dofs.mesh
        dim = self.dim
        if self.patch_type == "element":
            per_dim = mesh.n_cells
        else:
            per_dim = tuple(
                mesh.n_cells[d] if mesh.periodic[d] else mesh.n_cells[d] - 1
                for d in range(dim))
        if int(np.prod(per_dim)) != ids.shape[0]:
            return None
        shape_zyx = tuple(reversed(per_dim))
        out = []
        for d in range(dim):
            a = dim - 1 - d  # grid axis of direction d
            ids3 = ids[:, d].reshape(shape_zyx)
            ids1 = np.moveaxis(ids3, a, 0).reshape(per_dim[d], -1)
            if not (ids1 == ids1[:, :1]).all():
                return None
            coord_ids = ids1[:, 0]  # (W_d,)
            V = np.asarray(self.collection.eigvecs[d])[coord_ids]
            lam = np.asarray(self.collection.eigvals[d])[coord_ids]
            out.append((jnp.asarray(V, self.dtype), jnp.asarray(lam, self.dtype)))
        return out

    # -- RAS ownership coloring ------------------------------------------------
    def _ras_ownership(self, idx: np.ndarray) -> np.ndarray:
        """Exclusive ownership: each DoF belongs to the lowest-index patch.

        The reference colors by iterated min-propagation over MPI
        (matrix_free.h:536-673); with a global view the fixed point is simply
        the minimum patch index containing each DoF.
        """
        n = self.n_dofs
        P, L = idx.shape
        owner = np.full(n + 1, np.iinfo(np.int64).max)
        flat = idx.reshape(-1)
        pids = np.repeat(np.arange(P), L)
        np.minimum.at(owner, flat, pids)
        mask = (idx < n) & (owner[idx] == np.arange(P)[:, None])
        return mask.astype(np.float64)

    # -- apply -------------------------------------------------------------------

    def _fdm_apply(self, xp):
        """(C, m^dim) -> (C, m^dim) batched tensor-product inverse."""
        C = xp.shape[0]
        m = self.m
        u = xp.reshape((C,) + (m,) * self.dim)
        # forward: Vᵀ along every axis (axis a holds direction dim-1-a)
        for a in range(self.dim):
            d = self.dim - 1 - a
            V = self.eigvecs[d][self.ids[:, d]]
            u = _batched_apply(V, u, a, transpose=True)
        # eigenvalue-sum reciprocal
        denom = None
        for a in range(self.dim):
            d = self.dim - 1 - a
            lam = self.eigvals[d][self.ids[:, d]]  # (C, m)
            shape = [C] + [1] * self.dim
            shape[1 + a] = m
            lam = lam.reshape(shape)
            denom = lam if denom is None else denom + lam
        u = u / denom
        for a in range(self.dim):
            d = self.dim - 1 - a
            V = self.eigvecs[d][self.ids[:, d]]
            u = _batched_apply(V, u, a, transpose=False)
        return u.reshape(C, m**self.dim)

    def _fdm_apply_lanes(self, W):
        """(L, P) -> (L, P) batched tensor-product inverse, patches on lanes.

        L = m^dim local DoFs (x fastest), P patches.  Six axis transforms as
        unrolled broadcast-FMAs (`_axis_apply_lanes`) + one reciprocal — every
        intermediate is (m, m, m, P), perfectly tiled for any m."""
        Vt, lams = self.lanes
        return fdm_apply_lanes(W, self.m, self.dim, Vt, lams)

    def _fdm_apply_percoord(self, w):
        """FDM inverse on interleaved windows (Cz,mz,Cy,my,Cx,mx) with
        per-coordinate eigen-transform tables (batched matmuls, no gathers)."""
        from ..ops.lattice import apply_axis_percoord

        dim = self.dim
        for d in range(dim):
            c_axis = 2 * (dim - 1 - d)
            V, _ = self.percoord[d]
            w = apply_axis_percoord(w, c_axis, c_axis + 1, V, transpose=True)
        denom = None
        for d in range(dim):
            c_axis = 2 * (dim - 1 - d)
            _, lam = self.percoord[d]
            shape = [1] * (2 * dim)
            shape[c_axis] = lam.shape[0]
            shape[c_axis + 1] = lam.shape[1]
            lam_b = lam.reshape(shape)
            denom = lam_b if denom is None else denom + lam_b
        w = w / denom
        for d in range(dim):
            c_axis = 2 * (dim - 1 - d)
            V, _ = self.percoord[d]
            w = apply_axis_percoord(w, c_axis, c_axis + 1, V, transpose=False)
        return w

    def _vmult_global_fdm(self, src):
        from ..ops.tensorops import fdm_global_apply

        Gs, Gts, lams = self.global_fdm
        # build the reciprocal eigenvalue-sum in-trace from the small per-axis
        # vectors so the jitted program carries no grid-sized constants
        denom = None
        for d in range(self.dim):
            shape = [1] * self.dim
            shape[self.dim - 1 - d] = lams[d].shape[0]
            lam_b = lams[d].reshape(shape)
            denom = lam_b if denom is None else denom + lam_b
        return fdm_global_apply(src.reshape(self.grid_shape), Gs, Gts,
                                1.0 / denom, self.dim).reshape(-1)

    def _vmult_impl(self, src):
        with precision_context(self.matmul_precision):
            return self._vmult_inner(src)

    def _vmult_inner(self, src):
        # the global-FDM fast path goes first and touches no O(n) instance
        # arrays (weights/constraints folded into its transforms at setup)
        if self.access == "lattice" and self.global_fdm is not None:
            return self._vmult_global_fdm(src)
        w = self.weights
        x = src
        if self.weighting_type in ("pre", "symm"):
            x = x * w
        if self.access == "lattice" and self.dense is not None:
            from ..ops.lattice import cells_to_grid_sliced, grid_to_cells_sliced

            mesh = self.dofs.mesh
            x0 = jnp.where(self.constrained, 0.0, x)
            W = grid_to_cells_sliced(x0.reshape(self.grid_shape), mesh.n_cells,
                                     self.degree, self.m, self.n_overlap,
                                     mesh.periodic)  # (L, C)
            P_base, groups = self.dense
            y = P_base @ W
            for cols, P_u in groups:
                y = y.at[:, cols].set(P_u @ W[:, cols])
            dst = cells_to_grid_sliced(y, self.grid_shape, mesh.n_cells,
                                       self.degree, self.m, self.n_overlap,
                                       mesh.periodic).reshape(-1)
            dst = jnp.where(self.constrained, 0.0, dst)
        elif self.access == "lattice" and self.percoord is not None and self.ras_mask is None:
            from ..ops.lattice import grid_to_windows, windows_to_grid

            mesh = self.dofs.mesh
            x0 = jnp.where(self.constrained, 0.0, x)
            w6 = grid_to_windows(x0.reshape(self.grid_shape), mesh.n_cells,
                                 self.degree, self.m, self.n_overlap, mesh.periodic)
            y = self._fdm_apply_percoord(w6)
            dst = windows_to_grid(y, self.grid_shape, self.degree,
                                  self.n_overlap, mesh.periodic).reshape(-1)
            dst = jnp.where(self.constrained, 0.0, dst)
        elif self.access == "lattice" and self.lanes is not None:
            # element windows on a structured lattice, non-factoring geometry:
            # strided-slice extraction straight into the (L, C) lane-major
            # layout, per-cell FDM with cells on the lane axis
            from ..ops.lattice import cells_to_grid_sliced, grid_to_cells_sliced

            mesh = self.dofs.mesh
            x0 = jnp.where(self.constrained, 0.0, x)
            W = grid_to_cells_sliced(x0.reshape(self.grid_shape), mesh.n_cells,
                                     self.degree, self.m, self.n_overlap,
                                     mesh.periodic)  # (L, C)
            y = self._fdm_apply_lanes(W)
            if self.ras_mask_T is not None:
                y = y * self.ras_mask_T
            dst = cells_to_grid_sliced(y, self.grid_shape, mesh.n_cells,
                                       self.degree, self.m, self.n_overlap,
                                       mesh.periodic).reshape(-1)
            dst = jnp.where(self.constrained, 0.0, dst)
        elif self.access == "lattice":
            from ..ops.lattice import cells_to_grid, grid_to_cells

            mesh = self.dofs.mesh
            x0 = jnp.where(self.constrained, 0.0, x)
            xp = grid_to_cells(x0.reshape(self.grid_shape), mesh.n_cells,
                               self.degree, self.m, self.n_overlap, mesh.periodic)
            y = self._fdm_apply(xp)
            if self.ras_mask is not None:
                y = y * self.ras_mask
            dst = cells_to_grid(y, self.grid_shape, mesh.n_cells, self.degree,
                                self.m, self.n_overlap, mesh.periodic).reshape(-1)
            dst = jnp.where(self.constrained, 0.0, dst)
        elif self.lanes is not None:
            # vertex / non-lattice patches: index gather straight into the
            # lane-major layout via the transposed (L, P) index table.
            # CHUNK the patch axis: the unchunked apply materializes ~10
            # (L, P) intermediates — ~8 GB of transients at 7.2M-DoF
            # deformed-vertex.  Static chunks, ~256 MB of gathered W each.
            xpad = jnp.concatenate([x, jnp.zeros((1,), x.dtype)])
            L, Pn = self.patch_idx_T.shape
            n_chunks = max(1, int(np.ceil(
                L * Pn * x.dtype.itemsize
                / getattr(self, "_gather_chunk_bytes", 256 << 20))))
            Vt, lams = self.lanes
            bounds = np.linspace(0, Pn, n_chunks + 1).astype(int)
            dst = jnp.zeros(self.n_dofs + 1, x.dtype)
            for lo, hi in zip(bounds[:-1], bounds[1:]):
                idx = self.patch_idx_T[:, lo:hi]
                W = xpad[idx]
                y = fdm_apply_lanes(
                    W, self.m, self.dim,
                    [v[..., lo:hi] for v in Vt],
                    [l[..., lo:hi] for l in lams])
                if self.ras_mask_T is not None:
                    y = y * self.ras_mask_T[:, lo:hi]
                dst = dst.at[idx.reshape(-1)].add(y.reshape(-1))
            dst = dst[:-1]
        else:
            xpad = jnp.concatenate([x, jnp.zeros((1,), x.dtype)])
            xp = xpad[self.patch_idx]  # (C, m^dim)
            y = self._fdm_apply(xp)
            if self.ras_mask is not None:
                y = y * self.ras_mask
            dst = jnp.zeros(self.n_dofs + 1, x.dtype).at[
                self.patch_idx.reshape(-1)
            ].add(y.reshape(-1))[:-1]
        if self.weighting_type in ("post", "symm"):
            dst = dst * w
        return dst

    def vmult(self, src):
        return self._vmult(src)

    def vmult_traceable(self, src):
        """Un-jitted apply, for composition inside larger jitted programs."""
        return self._vmult_impl(src)

    def __call__(self, src):
        return self.vmult(src)

    def step(self, x, b, A, relaxation: float = 1.0):
        """One Richardson step x ← x + ω P⁻¹(b − A x)."""
        return x + relaxation * self.vmult(b - A(x))
