"""Multigrid transfer operators (p- and h-coarsening).

Rebuilds deal.II's MGTwoLevelTransfer / MGTransferGlobalCoarsening as used by
the reference (/root/reference/include/multigrid.h:336-346, benchmarked in
/root/reference/transfer_01.likwid.cc): tensor-product cell-wise interpolation
embedded through gather → 1D interpolation contractions → valence-weighted
scatter.  Prolongation is pointwise polynomial interpolation of the coarse FE
function at fine nodes; restriction is its exact transpose.

p-transfer: same mesh, degree p_c → p_f; 1D matrix T[i,j] = N_j^{p_c}(x_i^{p_f}).
h-transfer: mesh n → 2n cells, same degree; per coarse cell the fine lattice is
the (2p+1)^dim union of the 2^dim children's GLL lattices.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..fem.dofs import DofHandler
from ..fem.lagrange import gauss_lobatto_points, lagrange_values


def _tensor_apply_all(T: jnp.ndarray, u: jnp.ndarray, dim: int, n_in: int):
    """Apply the same 1D matrix T (n_out, n_in) along all local axes of u (C, n_in^dim)."""
    shape = (-1,) + (n_in,) * dim
    u = u.reshape(shape)
    for axis in range(dim):
        u = jnp.moveaxis(jnp.matmul(jnp.moveaxis(u, 1 + axis, -1), T.T), -1, 1 + axis)
    return u.reshape(u.shape[0], -1)


class TwoLevelTransfer:
    """Transfer between a coarse and a fine DofHandler (p- or h-coarsening)."""

    def __init__(self, coarse: DofHandler, fine: DofHandler, dtype=jnp.float64,
                 matmul_precision: str | None = None):
        self.matmul_precision = matmul_precision
        self.coarse = coarse
        self.fine = fine
        self.dim = coarse.mesh.dim
        dim = self.dim
        pc, pf = coarse.degree, fine.degree
        same_mesh = coarse.mesh.n_cells == fine.mesh.n_cells

        if same_mesh:
            # p-transfer
            assert pf >= pc
            nodes_c = gauss_lobatto_points(pc + 1)
            nodes_f = gauss_lobatto_points(pf + 1)
            T1 = lagrange_values(nodes_c, nodes_f)  # (pf+1, pc+1)
        else:
            # h-transfer: fine mesh has 2x cells per dim
            assert pf == pc
            assert all(f == 2 * c for c, f in zip(coarse.mesh.n_cells, fine.mesh.n_cells))
            p = pc
            nodes = gauss_lobatto_points(p + 1)
            # fine nodes within the coarse cell: children [0,.5] and [.5,1]
            xf = np.concatenate([nodes * 0.5, 0.5 + nodes[1:] * 0.5])  # (2p+1,)
            T1 = lagrange_values(nodes, xf)  # (2p+1, p+1)

        # globally separable form: prolongation = ⊗_d P̂_d with banded global
        # 1D interpolation matrices (N_f × N_c per direction) — applies as
        # dense axis matmuls on the grid (same algebra as ops/tensorops.py)
        self.P1d = []
        for d in range(self.dim):
            P = self._global_interp_1d(np.asarray(T1), coarse, fine, d,
                                       same_mesh)
            self.P1d.append(jnp.asarray(P, dtype))
        self.coarse_grid_shape = tuple(reversed(coarse.nodes_per_dim))
        self.fine_grid_shape = tuple(reversed(fine.nodes_per_dim))
        # separable free masks (small 1D vectors, outer-product'ed in-trace:
        # no grid-sized jit constants)
        self._free_1d = {}
        for tag, dh in (("coarse", coarse), ("fine", fine)):
            vecs = []
            for a in range(self.dim):  # grid axes (z, y, x)
                d = self.dim - 1 - a
                f = np.ones(dh.nodes_per_dim[d], dtype=bool)
                if not dh.mesh.periodic[d]:
                    f[0] = f[-1] = False
                vecs.append(jnp.asarray(f))
            self._free_1d[tag] = vecs

        # inline=True: surface captured tables to the outer jaxpr for const
        # hoisting (see ops/laplace_general.py)
        self._prolongate = jax.jit(self._prolongate_impl, inline=True)
        self._restrict = jax.jit(self._restrict_impl, inline=True)

    @staticmethod
    def _global_interp_1d(T1: np.ndarray, coarse: DofHandler, fine: DofHandler,
                          d: int, same_mesh: bool) -> np.ndarray:
        """Global 1D interpolation matrix along direction d (N_f × N_c).

        Entries are SET per coarse cell block (shared nodes receive identical
        values — pointwise interpolation of a continuous function)."""
        Nf = fine.nodes_per_dim[d]
        Nc = coarse.nodes_per_dim[d]
        pc = coarse.degree
        pf_nodes = T1.shape[0]  # fine nodes per coarse cell (+ shared)
        P = np.zeros((Nf, Nc))
        n_cells_c = coarse.mesh.n_cells[d]
        step_f = (pf_nodes - 1)
        for c in range(n_cells_c):
            rows = (c * step_f + np.arange(pf_nodes)) % Nf
            cols = (c * pc + np.arange(pc + 1)) % Nc
            P[np.ix_(rows, cols)] = T1
        return P

    @staticmethod
    def _fine_lattice_indices(coarse: DofHandler, fine: DofHandler) -> np.ndarray:
        """(C_coarse, (2p+1)^dim) fine global DoFs of each coarse cell's lattice."""
        p = coarse.degree
        dim = coarse.mesh.dim
        Nf = fine.nodes_per_dim
        mi = coarse.mesh.cell_multi_index()  # (Cc, dim)
        m = 2 * p + 1
        per_dim = []
        for d in range(dim):
            k = mi[:, d, None] * 2 * p + np.arange(m)[None, :]
            if fine.mesh.periodic[d]:
                k = k % Nf[d]
            per_dim.append(k.astype(np.int64))
        strides = np.cumprod([1] + list(Nf[:-1]))
        C = mi.shape[0]
        out = np.zeros((C, m**dim), dtype=np.int64)
        for d in range(dim):
            reps_inner = m**d
            reps_outer = m ** (dim - 1 - d)
            sel = np.tile(np.repeat(np.arange(m), reps_inner), reps_outer)
            out += per_dim[d][:, sel] * strides[d]
        return out.astype(np.int32)

    def _free_mask(self, tag: str):
        f = self._free_1d[tag][0]
        for v in self._free_1d[tag][1:]:
            f = f[..., None] & v
        return f.reshape(-1)

    def _prolongate_impl(self, u_coarse):
        if self.matmul_precision is not None:
            with jax.default_matmul_precision(self.matmul_precision):
                return self._prolongate_inner(u_coarse)
        return self._prolongate_inner(u_coarse)

    def _prolongate_inner(self, u_coarse):
        from .tensorops import axis_matmul

        # zero constrained coarse rows so restrict == prolongateᵀ exactly
        u = jnp.where(self._free_mask("coarse"), u_coarse, 0.0)
        t = u.reshape(self.coarse_grid_shape)
        for d in range(self.dim):
            t = axis_matmul(t, self.P1d[d], self.dim - 1 - d)
        out = t.reshape(-1)
        return jnp.where(self._free_mask("fine"), out, 0.0)

    def _restrict_impl(self, r_fine):
        if self.matmul_precision is not None:
            with jax.default_matmul_precision(self.matmul_precision):
                return self._restrict_inner(r_fine)
        return self._restrict_inner(r_fine)

    def _restrict_inner(self, r_fine):
        from .tensorops import axis_matmul

        r = jnp.where(self._free_mask("fine"), r_fine, 0.0)
        t = r.reshape(self.fine_grid_shape)
        for d in range(self.dim):
            t = axis_matmul(t, self.P1d[d].T, self.dim - 1 - d)
        out = t.reshape(-1)
        return jnp.where(self._free_mask("coarse"), out, 0.0)

    def prolongate(self, u_coarse):
        return self._prolongate(u_coarse)

    def restrict(self, r_fine):
        return self._restrict(r_fine)


def p_sequence(degree: int, kind: str) -> list[int]:
    """Degree sequences of the reference driver
    (/root/reference/element_centered_preconditioners_01.cc:553-672)."""
    seq = [degree]
    if kind == "go to one":
        if degree > 1:
            seq.append(1)
    elif kind == "decrease by one":
        while seq[-1] > 1:
            seq.append(seq[-1] - 1)
    elif kind == "bisect":
        while seq[-1] > 1:
            seq.append(max(seq[-1] // 2, 1))
    else:
        raise ValueError(kind)
    return list(reversed(seq))
