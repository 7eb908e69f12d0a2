import numpy as np
import jax.numpy as jnp
import pytest

from dealii_asm.fem.dofs import DofHandler
from dealii_asm.mesh.grid import StructuredMesh
from dealii_asm.ops.laplace import LaplaceOperator
from dealii_asm.precond.asm import ASMPreconditioner
from dealii_asm.precond.block_asm import (
    BlockTriDiagonal,
    Restrictor,
    create_block_preconditioner,
)


def _problem(p=3, cells=(4, 4), lengths=None):
    mesh = StructuredMesh(2, cells, lengths=lengths)
    dofs = DofHandler(mesh, p)
    return dofs, LaplaceOperator(dofs)


@pytest.mark.parametrize("overlap", [1, 2])
@pytest.mark.parametrize("weighting", ["none", "post", "symm"])
def test_block_asm_equals_fdm_asm_on_cartesian(overlap, weighting):
    """On Cartesian meshes the separable FDM patch inverse IS the dense patch
    block inverse, so both Schwarz paths must agree to roundoff (the reference's
    golden outputs show identical eigenvalues for both, e.g.
    dummy_mg_chebyshev_asm vs dummy_mg_chebyshev_fdm_3)."""
    dofs, op = _problem(lengths=(2.0, 0.5))
    blk = create_block_preconditioner(
        op, {"type": "AdditiveSchwarzPreconditioner", "n overlap": overlap,
             "weighting type": weighting})
    fdm = ASMPreconditioner(dofs, n_overlap=overlap, weighting_type=weighting)
    rng = np.random.default_rng(0)
    v = jnp.asarray(np.where(dofs.boundary_mask, 0.0, rng.standard_normal(dofs.n_dofs)))
    np.testing.assert_allclose(
        np.asarray(blk.vmult(v)), np.asarray(fdm.vmult(v)), rtol=1e-9, atol=1e-10)


def test_cg_preconditioner_converges_to_block_inverse():
    dofs, op = _problem(p=2, cells=(3, 3))
    exact = create_block_preconditioner(
        op, {"type": "AdditiveSchwarzPreconditioner", "n overlap": 1,
             "weighting type": "symm"})
    cgp = create_block_preconditioner(
        op, {"type": "CGPreconditioner", "n overlap": 1,
             "weighting type": "symm", "n iterations": 30})
    rng = np.random.default_rng(1)
    v = jnp.asarray(np.where(dofs.boundary_mask, 0.0, rng.standard_normal(dofs.n_dofs)))
    np.testing.assert_allclose(
        np.asarray(cgp.vmult(v)), np.asarray(exact.vmult(v)), rtol=1e-7, atol=1e-8)


def test_block_tridiagonal_thomas():
    rng = np.random.default_rng(2)
    P, L = 5, 9
    blocks = np.zeros((P, L, L))
    for p in range(P):
        a = rng.uniform(0.5, 1.0, L - 1)
        d = rng.uniform(3.0, 4.0, L)
        blocks[p] += np.diag(d) - np.diag(a, -1) - np.diag(a, 1)
    solver = BlockTriDiagonal(blocks)
    r = rng.standard_normal((P, L))
    got = np.asarray(solver.apply(jnp.asarray(r)))
    for p in range(P):
        np.testing.assert_allclose(got[p], np.linalg.solve(blocks[p], r[p]),
                                   rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("approx", ["lobatto", "equidistant"])
def test_matrix_approximation_spectrally_equivalent(approx):
    """eigenvalues_01 analog (/root/reference/eigenvalues_01.cc): the iso-Q1
    block approximations give a spectrally-equivalent preconditioner."""
    import scipy.linalg as sla
    from dealii_asm.fem.assemble import assemble_laplace

    dofs, op = _problem(p=4, cells=(3, 3))
    blk = create_block_preconditioner(
        op, {"type": "AdditiveSchwarzPreconditioner", "n overlap": 1,
             "weighting type": "symm", "matrix approximation": approx})
    A = assemble_laplace(dofs).toarray()
    n = dofs.n_dofs
    free = ~dofs.boundary_mask
    P = np.column_stack([
        np.asarray(blk.vmult(jnp.zeros(n, jnp.float64).at[i].set(1.0)))
        for i in range(n)])
    evs = np.real(sla.eigvals((P @ A)[np.ix_(free, free)]))
    assert evs.min() > 0.05
    assert evs.max() < 5.0


def test_vertex_restrictor_interior_only():
    dofs, op = _problem(p=3, cells=(3, 3))
    r = Restrictor(dofs, restriction_type="vertex")
    n = dofs.n_dofs
    ids = r.indices[r.indices < n]
    assert not dofs.boundary_mask[ids].any()


class TestSubMeshReassembly:
    """True sub-mesh block re-assembly (preconditioners.h:607-723 analog)."""

    def test_submesh_equals_extraction(self):
        # all coupling cells of an overlap<=p window lie inside the 3^dim
        # patch, so sub-mesh assembly must reproduce global-matrix extraction
        from dealii_asm.precond.block_asm import create_block_preconditioner

        mesh = StructuredMesh(3, (4, 4, 4))
        dofs = DofHandler(mesh, 3)
        op = LaplaceOperator(dofs, dtype=jnp.float64)
        x = jnp.asarray(np.random.default_rng(0).standard_normal(dofs.n_dofs))
        for o in (1, 2):
            p1 = create_block_preconditioner(
                op, {"type": "SubMeshPreconditioner", "n overlap": o,
                     "weighting type": "symm"})
            p2 = create_block_preconditioner(
                op, {"type": "AdditiveSchwarzPreconditioner", "n overlap": o,
                     "weighting type": "symm"})
            a = np.asarray(p1.vmult(x))
            b = np.asarray(p2.vmult(x))
            np.testing.assert_allclose(a, b, atol=1e-12 * np.abs(b).max())

    def test_submesh_deformed_mesh(self):
        # on a deformed mesh the sub-meshes carry the transform exactly
        from dealii_asm.mesh.transforms import kershaw_transform
        from dealii_asm.precond.block_asm import create_block_preconditioner
        from dealii_asm.solvers.krylov import solve as ksolve

        mesh = StructuredMesh(3, (3, 3, 3), transform=kershaw_transform(0.6, 0.6))
        dofs = DofHandler(mesh, 2)
        op = LaplaceOperator(dofs, dtype=jnp.float64)
        p1 = create_block_preconditioner(
            op, {"type": "SubMeshPreconditioner", "n overlap": 1,
                 "weighting type": "symm"})
        b = op.assemble_rhs(lambda pts: np.ones(pts.shape[0]))
        r = ksolve("CG", op.vmult, b, M=p1.vmult, max_iterations=100,
                   rel_tolerance=1e-8)
        assert r.converged and r.n_iterations < 60

    def test_create_mesh_from_cells(self):
        from dealii_asm.mesh.grid import create_mesh_from_cells

        mesh = StructuredMesh(3, (4, 4, 4))
        sub = create_mesh_from_cells(mesh, [0, 1, 4, 5])
        assert sub.n_cells_total == 4
        assert sub.n_vertices == 18
        J = sub.jacobians(1, np.array([0.5]))
        assert (np.linalg.det(J) > 0).all()
