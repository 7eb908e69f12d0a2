"""Additive/restricted Schwarz + FDM smoother on unstructured meshes.

The unstructured counterpart of ``ASMPreconditioner`` (see asm.py): the ball
family's smoother.  Element-centric overlap-1 patches coincide with the cell
DoF lattice (``get_dof_indices_cell_with_overlap`` with n_overlap=1,
/root/reference/include/dof_tools.h:9-137), so the gather table is the
orientation-baked ``cell_dofs``; local solves are batched FDM inverses built
from harmonic patch extents exactly as on structured meshes
(/root/reference/include/matrix_free.h:350-392).

Vertex-star patches anchor the (2p-1)^dim patch at an interior vertex and
resolve it through the same rotated-frame face-map composition
(fem/general_patches.general_vertex_patch_indices; reference
get_dof_indices_vertex_patch, dof_tools.h:206-300).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..fem.general_dofs import GeneralDofHandler
from ..utils.jitutils import precision_context
from .asm import (_batched_apply, _dedup_collection, build_lanes_tables,
                  fdm_apply_lanes, fdm_matmul_precision)
from .fdm import (fdm_1d_matrices, fdm_1d_matrices_batched,
                  vertex_patch_1d_matrices, vertex_patch_1d_matrices_batched)


class GeneralASMPreconditioner:
    """Element-centric / vertex-star additive Schwarz with FDM local solves."""

    def __init__(self, dofs: GeneralDofHandler, n_overlap: int = 1,
                 weighting_type: str = "post", dtype=jnp.float64,
                 n_q_1d: int | None = None, patch_type: str = "element",
                 matmul_precision: str | None = None):
        if weighting_type not in ("none", "pre", "post", "symm", "ras"):
            raise ValueError(weighting_type)
        if patch_type not in ("element", "vertex"):
            raise ValueError(patch_type)
        self.dofs = dofs
        mesh = dofs.mesh
        self.dim = mesh.dim
        self.degree = p = dofs.degree
        n_overlap = min(n_overlap, p)
        self.n_overlap = n_overlap
        self.patch_type = patch_type
        self.m = (2 * p - 1) if patch_type == "vertex" \
            else p - 1 + 2 * n_overlap
        self.weighting_type = weighting_type
        self.dtype = dtype
        self.matmul_precision = fdm_matmul_precision(dtype, matmul_precision)
        n = dofs.n_dofs
        mask = dofs.boundary_mask

        if patch_type == "vertex":
            from ..fem.general_patches import general_vertex_patch_indices

            idx, vext = general_vertex_patch_indices(dofs)
            idx = idx.astype(np.int64)

            def build(d, key):
                return vertex_patch_1d_matrices(p, key, n_q_1d)

            def build_batched(d, uniq):
                return vertex_patch_1d_matrices_batched(p, uniq, n_q_1d)

            keys = np.round(vext, 12)  # (P, dim, 2)
            self.collection = _dedup_collection(keys, build, build_batched)
        else:
            extents = mesh.harmonic_patch_extents(
                n_q_1d or (p + 1))  # (C, dim, 3)
            nbr = mesh.face_neighbors()  # (C, 2*dim): face 2d+s
            has_l = (nbr[:, 0::2] >= 0).astype(np.float64)  # (C, dim)
            has_r = (nbr[:, 1::2] >= 0).astype(np.float64)

            def build(d, key):
                h_l, h_c, h_r, hl_flag, hr_flag = key
                bc_l = "internal" if hl_flag else "dirichlet"
                bc_r = "internal" if hr_flag else "dirichlet"
                return fdm_1d_matrices(p, n_overlap, (h_l, h_c, h_r),
                                       bc_l, bc_r, n_q_1d)

            def build_batched(d, uniq):
                return fdm_1d_matrices_batched(
                    p, n_overlap, uniq[:, 0:3],
                    uniq[:, 3] > 0.5, uniq[:, 4] > 0.5, n_q_1d)

            keys = np.concatenate(
                [np.round(extents, 12), has_l[:, :, None], has_r[:, :, None]],
                axis=2)  # (C, dim, 5)
            self.collection = _dedup_collection(keys, build, build_batched)

        if patch_type == "vertex":
            pass  # idx built above
        elif n_overlap == 1:
            # overlap-1 element patch == the cell lattice itself
            idx = dofs.cell_dofs.astype(np.int64)
            idx = np.where(mask[idx], n, idx)
        else:
            from ..fem.general_patches import general_element_patch_indices

            idx = general_element_patch_indices(dofs, n_overlap).astype(
                np.int64)
        self.patch_idx = jnp.asarray(idx.astype(np.int32))
        self.n_dofs = n
        self.constrained = jnp.asarray(mask)

        valid = idx < n
        counts = np.zeros(n + 1)
        np.add.at(counts, idx.reshape(-1), valid.reshape(-1).astype(np.float64))
        counts[counts == 0] = 1.0
        inv_count = 1.0 / counts
        inv_count[-1] = 0.0
        w = np.sqrt(inv_count) if weighting_type == "symm" else inv_count
        self.weights = jnp.asarray(w[:-1], dtype)

        self.ras_mask = None
        if weighting_type == "ras":
            P, L = idx.shape
            owner = np.full(n + 1, np.iinfo(np.int64).max)
            np.minimum.at(owner, idx.reshape(-1),
                          np.repeat(np.arange(P), L))
            self.ras_mask = jnp.asarray(
                ((idx < n) & (owner[idx] == np.arange(P)[:, None]))
                .astype(np.float64), dtype)

        coll = self.collection
        self.eigvecs = [jnp.asarray(v, dtype) for v in coll.eigvecs]
        self.eigvals = [jnp.asarray(l, dtype) for l in coll.eigvals]
        self.ids = jnp.asarray(coll.ids)

        # lane-major apply (patch axis LAST): the production path (see
        # asm.py's _axis_apply_lanes)
        self.lanes = build_lanes_tables(coll.eigvecs, coll.eigvals, coll.ids,
                                        self.dim, dtype)
        self.patch_idx_T = jnp.asarray(
            np.ascontiguousarray(idx.astype(np.int32).T))
        self.ras_mask_T = None
        if self.ras_mask is not None:
            self.ras_mask_T = jnp.asarray(
                np.ascontiguousarray(np.asarray(self.ras_mask).T))

        # inline=True: surfaces the O(patches) gather/eigen tables to the
        # outer solver jaxpr so jit_hoist_consts passes them by reference
        # instead of embedding them in the executable (see
        # laplace_general.py)
        self._vmult = jax.jit(self._vmult_impl, inline=True)

    def _fdm_apply(self, xp):
        C = xp.shape[0]
        m = self.m
        u = xp.reshape((C,) + (m,) * self.dim)
        for a in range(self.dim):
            d = self.dim - 1 - a
            V = self.eigvecs[d][self.ids[:, d]]
            u = _batched_apply(V, u, a, transpose=True)
        denom = None
        for a in range(self.dim):
            d = self.dim - 1 - a
            lam = self.eigvals[d][self.ids[:, d]]
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

    def _vmult_impl(self, src):
        with precision_context(self.matmul_precision):
            return self._vmult_inner(src)

    def _vmult_inner(self, src):
        w = self.weights
        x = src
        if self.weighting_type in ("pre", "symm"):
            x = x * w
        xpad = jnp.concatenate([x, jnp.zeros((1,), x.dtype)])
        if self.lanes is not None:
            W = xpad[self.patch_idx_T]  # (L, P), patches on lanes
            y = fdm_apply_lanes(W, self.m, self.dim, *self.lanes)
            if self.ras_mask_T is not None:
                y = y * self.ras_mask_T
            dst = jnp.zeros(self.n_dofs + 1, x.dtype).at[
                self.patch_idx_T.reshape(-1)].add(y.reshape(-1))[:-1]
        else:
            xp = xpad[self.patch_idx]
            y = self._fdm_apply(xp)
            if self.ras_mask is not None:
                y = y * self.ras_mask
            dst = jnp.zeros(self.n_dofs + 1, x.dtype).at[
                self.patch_idx.reshape(-1)].add(y.reshape(-1))[:-1]
        if self.weighting_type in ("post", "symm"):
            dst = dst * w
        return dst

    def vmult(self, src):
        return self._vmult(src)

    def vmult_traceable(self, src):
        return self._vmult_impl(src)

    def __call__(self, src):
        return self.vmult(src)

    def step(self, x, b, A, relaxation: float = 1.0):
        return x + relaxation * self.vmult(b - A(x))
