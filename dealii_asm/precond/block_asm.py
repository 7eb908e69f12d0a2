"""Matrix-based Schwarz preconditioners (block extraction + batched solves).

Rebuilds the reference's matrix-based family
(/root/reference/include/preconditioners.h and restrictors.h):

- ``Restrictor`` = ElementCenteredRestrictor (restrictors.h:17-378): per-patch
  global index lists for "element" (overlap 1..p+1), "vertex" (interior
  vertex-star) and "vertex_all" patches, plus multiplicity weights;
- ``BlockInverse`` = RestrictedMatrixView (+invert) (preconditioners.h:528-605):
  dense patch blocks extracted from the assembled sparse matrix, batch-inverted
  once on host, applied as batched matvecs on device;
- ``BlockCG`` = CGMatrixView (preconditioners.h:259-345): a fixed number of CG
  iterations per block, batched over all patches in one jitted program;
- ``BlockDiagonal`` / ``BlockTriDiagonal`` = DiagonalMatrixView /
  TriDiagonalMatrixView (preconditioners.h:347-526; Thomas solve :490-504);
- ``RestrictedPreconditioner`` (preconditioners.h:744-813): restrict →
  block-solve → weighted scatter-add.

Matrix approximations "lobatto"/"equidistant" re-discretize with FE_Q_iso_Q1
(/root/reference/include/precondition.templates.h:33-85) before extracting
blocks; "none" uses the true operator matrix.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..fem.patches import element_patch_indices, vertex_patch_indices
from ..utils.config import get_param


class Restrictor:
    """Per-patch global index lists + multiplicity weights."""

    def __init__(self, dofs, n_overlap=1, weighting_type="symm",
                 restriction_type="element"):
        self.dofs = dofs
        self.weighting_type = weighting_type
        self.restriction_type = restriction_type
        n = dofs.n_dofs
        if restriction_type == "element":
            idx = element_patch_indices(dofs, n_overlap)
        elif restriction_type == "vertex":
            idx, _ = vertex_patch_indices(dofs)
        elif restriction_type == "vertex_all":
            from ..fem.patches import vertex_all_patch_indices

            idx, _ = vertex_all_patch_indices(dofs)
        else:
            raise ValueError(restriction_type)
        # constrained dofs do not participate
        mask = dofs.boundary_mask
        idx = np.where(mask[np.clip(idx, 0, n - 1)] | (idx >= n), n, idx)
        self.indices = idx  # (P, L) with pad = n

        valid = idx < n
        counts = np.zeros(n + 1)
        np.add.at(counts, idx.reshape(-1), valid.reshape(-1).astype(np.float64))
        counts[counts == 0] = 1.0
        w = 1.0 / counts
        w[-1] = 0.0
        self.inv_multiplicity = w[:-1]


def _extract_blocks(A_csr, indices: np.ndarray, n: int) -> np.ndarray:
    """Dense (P, L, L) patch blocks; pad slots become decoupled identity rows."""
    P, L = indices.shape
    blocks = np.zeros((P, L, L))
    A = A_csr.tocsc().tocsr()
    for pi in range(P):
        ids = indices[pi]
        valid = ids < n
        sub = np.asarray(A[ids[valid][:, None], ids[valid][None, :]].todense())
        vv = np.where(valid)[0]
        blocks[pi][np.ix_(vv, vv)] = sub
        inv = np.where(~valid)[0]
        blocks[pi][inv, inv] = 1.0
    return blocks


class BlockInverse:
    """RestrictedMatrixView + invert(): precomputed dense block inverses."""

    def __init__(self, blocks: np.ndarray, dtype=jnp.float64):
        self.inv = jnp.asarray(np.linalg.inv(blocks), dtype)

    def apply(self, r):  # r: (P, L)
        return jnp.einsum("pij,pj->pi", self.inv, r)


class BlockCG:
    """CGMatrixView: fixed-iteration batched CG on the patch blocks."""

    def __init__(self, blocks: np.ndarray, precon=None, n_iterations=1,
                 dtype=jnp.float64):
        self.A = jnp.asarray(blocks, dtype)
        self.n_iterations = n_iterations
        self.precon = precon

    def apply(self, r):
        A = self.A
        M = self.precon.apply if self.precon is not None else (lambda x: x)
        x = jnp.zeros_like(r)
        res = r
        z = M(res)
        p = z
        rz = jnp.sum(res * z, axis=1, keepdims=True)
        for _ in range(self.n_iterations):
            Ap = jnp.einsum("pij,pj->pi", A, p)
            pAp = jnp.sum(p * Ap, axis=1, keepdims=True)
            alpha = jnp.where(pAp != 0, rz / jnp.where(pAp != 0, pAp, 1.0), 0.0)
            x = x + alpha * p
            res = res - alpha * Ap
            z = M(res)
            rz_new = jnp.sum(res * z, axis=1, keepdims=True)
            beta = jnp.where(rz != 0, rz_new / jnp.where(rz != 0, rz, 1.0), 0.0)
            p = z + beta * p
            rz = rz_new
        return x


class BlockDiagonal:
    """DiagonalMatrixView: inverted block diagonals."""

    def __init__(self, blocks: np.ndarray, dtype=jnp.float64):
        d = np.einsum("pii->pi", blocks).copy()
        d[d == 0] = 1.0
        self.inv_diag = jnp.asarray(1.0 / d, dtype)

    def apply(self, r):
        return self.inv_diag * r


class BlockTriDiagonal:
    """TriDiagonalMatrixView: batched Thomas solve on tridiagonal patch blocks
    (preconditioners.h:420-526)."""

    def __init__(self, blocks: np.ndarray, dtype=jnp.float64):
        P, L, _ = blocks.shape
        self.a = jnp.asarray(np.array([np.diag(b, -1) for b in blocks]), dtype)
        self.b = jnp.asarray(np.array([np.diag(b) for b in blocks]), dtype)
        self.c = jnp.asarray(np.array([np.diag(b, 1) for b in blocks]), dtype)
        self.L = L

    def apply(self, r):
        a, b, c = self.a, self.b, self.c
        L = self.L
        # forward sweep (unrolled: L is small and static)
        cp = [c[:, 0] / b[:, 0]]
        dp = [r[:, 0] / b[:, 0]]
        for i in range(1, L):
            denom = b[:, i] - a[:, i - 1] * cp[i - 1]
            cp.append(c[:, i] / denom if i < L - 1 else jnp.zeros_like(denom))
            dp.append((r[:, i] - a[:, i - 1] * dp[i - 1]) / denom)
        x = [None] * L
        x[L - 1] = dp[L - 1]
        for i in range(L - 2, -1, -1):
            x[i] = dp[i] - cp[i] * x[i + 1]
        return jnp.stack(x, axis=1)


class RestrictedPreconditioner:
    """restrict → block solve → weighted scatter-add (preconditioners.h:744-813)."""

    def __init__(self, solver, restrictor: Restrictor, dtype=jnp.float64):
        self.solver = solver
        self.restrictor = restrictor
        self.idx = jnp.asarray(restrictor.indices.astype(np.int32))
        wt = restrictor.weighting_type
        w = restrictor.inv_multiplicity
        self.w = jnp.asarray(np.sqrt(w) if wt == "symm" else w, dtype)
        self.weighting_type = wt
        self.n = restrictor.dofs.n_dofs
        # inline=True: surface captured block tables to the outer jaxpr for
        # const hoisting (see ops/laplace_general.py)
        self._vmult = jax.jit(self._vmult_impl, inline=True)
        self.is_symmetric = wt in ("none", "symm")

    def _vmult_impl(self, src):
        x = src
        if self.weighting_type in ("pre", "symm"):
            x = x * self.w
        xpad = jnp.concatenate([x, jnp.zeros((1,), x.dtype)])
        r = xpad[self.idx]
        y = self.solver.apply(r)
        dst = jnp.zeros(self.n + 1, x.dtype).at[self.idx.reshape(-1)].add(
            y.reshape(-1))[:-1]
        if self.weighting_type in ("post", "symm"):
            dst = dst * self.w
        return dst

    def vmult(self, src):
        return self._vmult(src)

    def __call__(self, src):
        return self.vmult(src)


def _submesh_blocks(op, n_overlap: int, approximation: str = "none"):
    """Patch blocks re-assembled on extracted sub-meshes — the TRUE
    SubMeshMatrixView (/root/reference/include/preconditioners.h:607-723).

    For each cell, the 3^dim surrounding-cell patch is an exact offset
    StructuredMesh (same transform); the raw (Neumann) Laplace is assembled on
    it and the principal submatrix on the overlap window taken — zero
    Dirichlet outside the window, as the reference's sub-mesh assembly gives.
    Differs from global-matrix extraction for overlap ≥ 2 (second-ring cell
    contributions at window-boundary DoFs are excluded).  Deduplicated by
    (neighbor pattern) on uniform meshes with no transform; otherwise per cell.
    """
    from ..fem.dofs import DofHandler
    from ..fem.assemble import assemble_laplace, assemble_laplace_iso_q1
    from ..mesh.grid import patch_submesh

    mesh = op.dofs.mesh
    p = op.degree
    o = n_overlap
    m = p - 1 + 2 * o
    dim = mesh.dim
    C = mesh.n_cells_total
    blocks = np.zeros((C, m**dim, m**dim))
    cache: dict = {}
    for c in range(C):
        sub, lo = patch_submesh(mesh, c)
        key = (sub.n_cells, lo) if mesh.transform is None else None
        if key is not None and key in cache:
            blocks[c] = cache[key]
            continue
        sub_dofs = DofHandler(sub, p)
        if approximation in ("", "none"):
            A = assemble_laplace(sub_dofs, constrained="raw").toarray()
        else:
            A = assemble_laplace_iso_q1(sub_dofs, points=approximation,
                                        constrained="raw").toarray()
        # window slot -> sub-mesh node (per axis): local = lo·p − (o−1) + s
        per_axis = []
        for d in range(dim):
            N_sub = sub_dofs.nodes_per_dim[d]
            ids = np.array([lo[d] * p - (o - 1) + s for s in range(m)])
            valid = (ids >= 0) & (ids < N_sub)
            per_axis.append((np.clip(ids, 0, N_sub - 1), valid))
        strides = np.cumprod([1] + list(sub_dofs.nodes_per_dim[:-1]))
        win = np.zeros(m**dim, dtype=np.int64)
        ok = np.ones(m**dim, dtype=bool)
        for d in range(dim):
            sel = np.tile(np.repeat(np.arange(m), m**d), m ** (dim - 1 - d))
            win += per_axis[d][0][sel] * strides[d]
            ok &= per_axis[d][1][sel]
        B = np.eye(m**dim)
        vv = np.where(ok)[0]
        B[np.ix_(vv, vv)] = A[np.ix_(win[vv], win[vv])]
        blocks[c] = B
        if key is not None:
            cache[key] = B
    return blocks


def _approximated_matrix(op, approximation: str):
    from ..fem.assemble import assemble_laplace, assemble_laplace_iso_q1

    if approximation in ("", "none"):
        return assemble_laplace(op.dofs)
    if approximation in ("lobatto", "equidistant"):
        return assemble_laplace_iso_q1(op.dofs, points=approximation)
    raise ValueError(f"Matrix approximation <{approximation}> is not known!")


def create_block_preconditioner(op, params: dict, log=lambda *_: None):
    """Factory for the matrix-based Schwarz types
    (/root/reference/include/precondition.templates.h:614-813)."""
    ptype = params.get("type")
    log(f"- Create system preconditioner: {ptype}\n")
    degree = op.degree
    n_overlap = min(int(get_param(params, "n overlap", 1)), degree + 1)
    weighting = get_param(params, "weighting type", "symm")
    restriction_type = get_param(params, "restriction type", "element")
    approximation = get_param(params, "matrix approximation", "none")

    restrictor = Restrictor(op.dofs, n_overlap, weighting, restriction_type)
    if ptype == "SubMeshPreconditioner" and restriction_type == "element":
        # true sub-mesh re-assembly (preconditioners.h:607-723), not global
        # matrix extraction
        blocks = _submesh_blocks(op, n_overlap, approximation)
        # decouple slots the restrictor masked out (constrained global DoFs)
        n = op.dofs.n_dofs
        for c in range(blocks.shape[0]):
            bad = np.where(restrictor.indices[c] >= n)[0]
            blocks[c][bad, :] = 0.0
            blocks[c][:, bad] = 0.0
            blocks[c][bad, bad] = 1.0
    else:
        A = _approximated_matrix(op, approximation)
        blocks = _extract_blocks(A, restrictor.indices, op.dofs.n_dofs)

    if ptype in ("AdditiveSchwarzPreconditioner", "SubMeshPreconditioner"):
        solver = BlockInverse(blocks, op.dtype)
    elif ptype == "CGPreconditioner":
        n_it = int(get_param(params, "n iterations", 1))
        inner = BlockInverse(_extract_blocks(
            _approximated_matrix(op, approximation), restrictor.indices,
            op.dofs.n_dofs), op.dtype)
        exact = _extract_blocks(_approximated_matrix(op, "none"),
                                restrictor.indices, op.dofs.n_dofs)
        solver = BlockCG(exact, precon=inner, n_iterations=n_it, dtype=op.dtype)
    else:
        raise ValueError(ptype)
    return RestrictedPreconditioner(solver, restrictor, op.dtype)
