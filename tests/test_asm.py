import numpy as np
import jax.numpy as jnp
import pytest

from dealii_asm.fem.assemble import assemble_laplace
from dealii_asm.fem.dofs import DofHandler
from dealii_asm.fem.patches import element_patch_indices, vertex_patch_indices
from dealii_asm.mesh.grid import StructuredMesh
from dealii_asm.ops.laplace import LaplaceOperator
from dealii_asm.precond.asm import ASMPreconditioner
from dealii_asm.precond.fdm import fdm_1d_matrices


def test_patch_indices_overlap1_equal_cell_dofs():
    mesh = StructuredMesh(2, (3, 3))
    dofs = DofHandler(mesh, 3)
    idx = element_patch_indices(dofs, 1)
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(dofs.cell_dofs))


def test_patch_indices_overlap2_extends_into_neighbors():
    mesh = StructuredMesh(2, (2, 2))
    dofs = DofHandler(mesh, 2)
    idx = element_patch_indices(dofs, 2)
    m = 2 - 1 + 4  # p-1+2*overlap = 5
    assert idx.shape == (4, m * m)
    # cell 0 (lower-left): first row/col out of domain -> pad
    pad = dofs.n_dofs
    assert (np.asarray(idx[0]).reshape(m, m)[0] == pad).all()
    assert (np.asarray(idx[0]).reshape(m, m)[:, 0] == pad).all()
    # interior of cell 0's patch reaches one node into the right neighbor:
    # x-offset 3 = cell 1's local x-node 1 (its x-node 0 is shared with cell 0)
    assert np.asarray(idx[0]).reshape(m, m)[1, -1] == np.asarray(dofs.cell_dofs[1]).reshape(3, 3)[0, 1]


def test_fdm_1d_matrix_interior_is_assembled_subblock():
    # interior cell with neighbors h_l = h_c = h_r = h: window of the 3-cell
    # assembly; check against direct assembly
    p, ov, h = 3, 2, 0.25
    M, K = fdm_1d_matrices(p, ov, (h, h, h), "internal", "internal")
    m = p - 1 + 2 * ov
    assert M.shape == (m, m)
    # symmetric positive definite
    assert np.allclose(M, M.T) and np.allclose(K, K.T)
    assert (np.linalg.eigvalsh(M) > 0).all()
    assert (np.linalg.eigvalsh(K) > -1e-12).all()


def test_fdm_inverse_matches_dense_patch_inverse():
    """fdm_01 analog (/root/reference/fdm_01.cc:148-177): on a Cartesian but
    anisotropic mesh, the FDM tensor-product inverse equals the dense inverse of
    the assembled patch block."""
    mesh = StructuredMesh(2, (4, 3), lengths=(2.0, 0.75))
    p = 3
    dofs = DofHandler(mesh, p)
    A = assemble_laplace(dofs, constrained="raw").toarray()
    asm = ASMPreconditioner(dofs, n_overlap=1, weighting_type="none")
    idx = np.asarray(element_patch_indices(dofs, 1))
    mask = dofs.boundary_mask
    n = dofs.n_dofs

    # pick an interior cell: all patch dofs valid and unconstrained
    for c in range(idx.shape[0]):
        ids = idx[c]
        if (ids < n).all() and not mask[ids].any():
            break
    block = A[np.ix_(ids, ids)]
    rng = np.random.default_rng(0)
    r = rng.standard_normal(len(ids))
    expected = np.linalg.solve(block, r)

    src = np.zeros(n)
    src[ids] = r
    got_full = np.asarray(asm.vmult(jnp.asarray(src)))
    # restrict: with 'none' weighting neighbors also contribute; instead apply
    # the FDM block directly
    xp = jnp.zeros((idx.shape[0], len(ids)), jnp.float64).at[c].set(jnp.asarray(r))
    got = np.asarray(asm._fdm_apply(xp))[c]
    np.testing.assert_allclose(got, expected, rtol=1e-9, atol=1e-9)


def test_asm_single_cell_is_exact_inverse():
    # one cell, overlap 1, no weighting: P = A restricted to interior dofs
    mesh = StructuredMesh(2, (1, 1))
    dofs = DofHandler(mesh, 4)
    op = LaplaceOperator(dofs)
    asm = ASMPreconditioner(dofs, n_overlap=1, weighting_type="none")
    free = ~dofs.boundary_mask
    rng = np.random.default_rng(1)
    v = np.where(free, rng.standard_normal(dofs.n_dofs), 0.0)
    av = np.array(op.vmult(jnp.asarray(v)))
    av[dofs.boundary_mask] = 0.0
    back = np.asarray(asm.vmult(jnp.asarray(av)))
    np.testing.assert_allclose(back[free], v[free], rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("weighting", ["none", "pre", "post", "symm", "ras"])
def test_asm_weighting_modes_run_and_precondition(weighting):
    from dealii_asm.solvers.krylov import gmres, ReductionControl
    mesh = StructuredMesh(2, (4, 4))
    dofs = DofHandler(mesh, 3)
    op = LaplaceOperator(dofs)
    asm = ASMPreconditioner(dofs, n_overlap=1, weighting_type=weighting)
    b = op.assemble_rhs(lambda p: np.ones(p.shape[0]))
    res = gmres(op.vmult, b, M=asm.vmult, control=ReductionControl(200, 1e-12, 1e-8))
    assert res.converged
    # must beat unpreconditioned GMRES
    res0 = gmres(op.vmult, b, control=ReductionControl(200, 1e-12, 1e-8))
    assert res.n_iterations < res0.n_iterations


def test_symm_weighting_is_symmetric():
    mesh = StructuredMesh(2, (3, 3))
    dofs = DofHandler(mesh, 2)
    asm = ASMPreconditioner(dofs, n_overlap=1, weighting_type="symm")
    n = dofs.n_dofs
    P = np.column_stack([
        np.asarray(asm.vmult(jnp.zeros(n).at[i].set(1.0))) for i in range(n)
    ])
    np.testing.assert_allclose(P, P.T, atol=1e-12)


def test_ras_partition_of_unity():
    mesh = StructuredMesh(2, (4, 4))
    dofs = DofHandler(mesh, 3)
    asm = ASMPreconditioner(dofs, n_overlap=2, weighting_type="ras")
    # each free dof owned exactly once
    idx = np.asarray(asm.patch_idx)
    mask_own = np.asarray(asm.ras_mask)
    counts = np.zeros(dofs.n_dofs + 1)
    np.add.at(counts, idx.reshape(-1), mask_own.reshape(-1))
    free = ~dofs.boundary_mask
    np.testing.assert_allclose(counts[:-1][free], 1.0)


def test_vertex_patch_indices_and_asm():
    mesh = StructuredMesh(2, (4, 4))
    dofs = DofHandler(mesh, 3)
    idx, anchors = vertex_patch_indices(dofs)
    assert idx.shape == (9, (2 * 3 - 1) ** 2)  # 3x3 interior vertices
    asm = ASMPreconditioner(dofs, weighting_type="symm", patch_type="vertex")
    from dealii_asm.solvers.krylov import cg, ReductionControl
    op = LaplaceOperator(dofs)
    b = op.assemble_rhs(lambda p: np.ones(p.shape[0]))
    res = cg(op.vmult, b, M=asm.vmult, control=ReductionControl(200, 1e-12, 1e-8))
    assert res.converged and res.n_iterations < 40


# -- lane-major (patches-on-lanes) FDM path -----------------------------------
# The scalable apply for non-factoring geometries (Kershaw & friends): local
# tensors travel as (L, P) with the huge patch axis last (minor).

def _gather_reference_apply(asm, x):
    """Old patch-major gather apply (the slow oracle)."""
    w = asm.weights
    xs = x * w if asm.weighting_type in ("pre", "symm") else x
    xpad = jnp.concatenate([xs, jnp.zeros((1,), xs.dtype)])
    xp = xpad[asm.patch_idx]
    y = asm._fdm_apply(xp)
    if asm.ras_mask is not None:
        y = y * asm.ras_mask
    dst = jnp.zeros(asm.n_dofs + 1, xs.dtype).at[
        asm.patch_idx.reshape(-1)].add(y.reshape(-1))[:-1]
    if asm.weighting_type in ("post", "symm"):
        dst = dst * w
    return np.asarray(dst)


@pytest.mark.parametrize("ptype,ov,wt", [
    ("element", 1, "symm"), ("element", 1, "ras"), ("element", 2, "symm"),
    ("vertex", 1, "symm"), ("vertex", 1, "ras"),
])
def test_lanes_fdm_apply_matches_gather_oracle(ptype, ov, wt):
    import jax

    from dealii_asm.mesh.transforms import kershaw_transform

    mesh = StructuredMesh(3, (4, 4, 4), transform=kershaw_transform(0.3, 0.3))
    dofs = DofHandler(mesh, 3)
    asm = ASMPreconditioner(dofs, n_overlap=ov, weighting_type=wt,
                            patch_type=ptype, dtype=jnp.float64)
    # Kershaw extents don't factor per coordinate -> the lane-major tables
    # must exist; disable the small-mesh dense shortcut to hit the lanes branch
    assert asm.global_fdm is None and asm.lanes is not None
    asm.dense = None
    asm._vmult = jax.jit(asm._vmult_impl)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(dofs.n_dofs))
    got = np.asarray(asm.vmult(x))
    ref = _gather_reference_apply(asm, x)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-13 * np.abs(ref).max())


def test_batched_fdm_builders_match_scalar():
    """fdm_1d_matrices_batched / vertex_patch_1d_matrices_batched /
    batched_generalized_eigh reproduce the scalar builders (the vectorized
    setup path that unblocked the 131k-cell ball: every harmonic extent is
    distinct on a curved mesh, so setup cost is one batched eigh, not ~400k
    sequential scipy calls)."""
    import numpy as np
    import scipy.linalg as sla

    from dealii_asm.precond.fdm import (
        batched_generalized_eigh,
        fdm_1d_matrices,
        fdm_1d_matrices_batched,
        vertex_patch_1d_matrices,
        vertex_patch_1d_matrices_batched,
    )

    rng = np.random.default_rng(7)
    for p, ov in ((2, 1), (3, 2), (4, 1)):
        U = 17
        ext = rng.uniform(0.5, 2.0, (U, 3))
        il = rng.random(U) > 0.3
        ir = rng.random(U) > 0.3
        ext[~il, 0] = 0.0
        ext[~ir, 2] = 0.0
        Mb, Kb = fdm_1d_matrices_batched(p, ov, ext, il, ir)
        for u in range(U):
            M, K = fdm_1d_matrices(
                p, ov, tuple(ext[u]),
                "internal" if il[u] else "dirichlet",
                "internal" if ir[u] else "dirichlet")
            np.testing.assert_allclose(Mb[u], M, atol=1e-14)
            np.testing.assert_allclose(Kb[u], K, atol=1e-14)
        lam, V = batched_generalized_eigh(Kb, Mb)
        for u in range(U):
            w, _ = sla.eigh(Kb[u], Mb[u])
            np.testing.assert_allclose(lam[u], w, atol=1e-9)
            m = Mb.shape[-1]
            np.testing.assert_allclose(V[u].T @ Mb[u] @ V[u], np.eye(m),
                                       atol=1e-8)
            np.testing.assert_allclose(Kb[u] @ V[u],
                                       Mb[u] @ V[u] @ np.diag(lam[u]),
                                       atol=1e-8)
        ext2 = rng.uniform(0.5, 2.0, (U, 2))
        M2, K2 = vertex_patch_1d_matrices_batched(p, ext2)
        for u in range(U):
            M, K = vertex_patch_1d_matrices(p, tuple(ext2[u]))
            np.testing.assert_allclose(M2[u], M, atol=1e-14)
            np.testing.assert_allclose(K2[u], K, atol=1e-14)


def test_mesh_cache_invalidation_on_mutation():
    """In-place cell flips / chart attachment must drop memoized topology
    and mapping-point tables (regression: stale caches broke
    _fix_cell_orientations)."""
    import numpy as np

    from dealii_asm.mesh.unstructured import hyper_ball_balanced

    mesh = hyper_ball_balanced(3)
    sp1 = mesh.cell_mapping_points(2)
    assert mesh.cell_mapping_points(2) is sp1  # memoized
    nbr = mesh.face_neighbors()
    assert mesh.face_neighbors() is nbr
    mesh.invalidate_caches()
    sp2 = mesh.cell_mapping_points(2)
    assert sp2 is not sp1
    np.testing.assert_allclose(sp1, sp2)


def test_gather_lanes_chunked_matches_unchunked():
    """Chunked vertex gather apply (deformed meshes at scale) == one-chunk."""
    from dealii_asm.mesh.grid import StructuredMesh
    from dealii_asm.mesh.transforms import kershaw_transform
    from dealii_asm.fem.dofs import DofHandler
    from dealii_asm.precond.asm import ASMPreconditioner

    mesh = StructuredMesh(3, (6, 6, 6), transform=kershaw_transform(0.3, 0.3))
    dofs = DofHandler(mesh, 2)
    asm = ASMPreconditioner(dofs, n_overlap=1, weighting_type="symm",
                            patch_type="vertex", dtype=jnp.float64)
    assert asm.access == "gather" and asm.lanes is not None
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(dofs.n_dofs))
    ref = np.asarray(asm.vmult(x))
    asm2 = ASMPreconditioner(dofs, n_overlap=1, weighting_type="symm",
                             patch_type="vertex", dtype=jnp.float64)
    asm2._gather_chunk_bytes = 4096  # force many chunks
    got = np.asarray(asm2.vmult(x))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-13 * np.abs(ref).max())
