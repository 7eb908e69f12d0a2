import numpy as np
import jax.numpy as jnp
import pytest

from dealii_asm.fem.assemble import assemble_laplace
from dealii_asm.fem.dofs import DofHandler
from dealii_asm.mesh.grid import StructuredMesh
from dealii_asm.mesh.transforms import kershaw_transform, sinusoidal_displacement
from dealii_asm.ops.laplace import LaplaceOperator


def _random_vec(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n)


@pytest.mark.parametrize(
    "dim,cells,p,kernel",
    [
        (2, (3, 4), 2, "sumfac"),
        (2, (4, 4), 3, "fused-B"),
        (3, (2, 3, 2), 2, "sumfac"),
        (3, (2, 2, 2), 3, "fused-B"),
    ],
)
def test_matrixfree_matches_dense_cartesian(dim, cells, p, kernel):
    mesh = StructuredMesh(dim, cells, lengths=tuple(float(c) for c in cells))
    dofs = DofHandler(mesh, p)
    A = assemble_laplace(dofs)
    op = LaplaceOperator(dofs, kernel=kernel)
    u = _random_vec(dofs.n_dofs)
    expected = A @ u
    got = np.asarray(op.vmult(jnp.asarray(u)))
    assert np.allclose(got, expected, atol=1e-10 * max(1, np.abs(expected).max()))


@pytest.mark.parametrize("transform_name", ["sinus", "kershaw"])
@pytest.mark.parametrize("dim", [2, 3])
def test_matrixfree_matches_dense_deformed(transform_name, dim):
    if transform_name == "sinus":
        tf = sinusoidal_displacement(0.05)
    else:
        tf = kershaw_transform(0.5, 0.5)
    cells = (6, 2) if dim == 2 else (6, 2, 2)
    mesh = StructuredMesh(dim, cells, transform=tf)
    dofs = DofHandler(mesh, 2)
    A = assemble_laplace(dofs)
    op = LaplaceOperator(dofs)
    assert op.geometry.kind == "merged"
    u = _random_vec(dofs.n_dofs, seed=3)
    expected = A @ u
    got = np.asarray(op.vmult(jnp.asarray(u)))
    assert np.allclose(got, expected, atol=1e-9 * max(1, np.abs(expected).max()))


def test_operator_identity_on_constrained():
    mesh = StructuredMesh(2, (3, 3))
    dofs = DofHandler(mesh, 2)
    op = LaplaceOperator(dofs)
    u = _random_vec(dofs.n_dofs, seed=1)
    got = np.asarray(op.vmult(jnp.asarray(u)))
    mask = dofs.boundary_mask
    assert np.allclose(got[mask], u[mask])


def test_periodic_no_constraints_and_nullspace():
    mesh = StructuredMesh(2, (4, 4), periodic=(True, True))
    dofs = DofHandler(mesh, 3)
    assert dofs.n_dofs == (3 * 4) ** 2
    assert not dofs.boundary_mask.any()
    op = LaplaceOperator(dofs)
    ones = jnp.ones(dofs.n_dofs)
    assert np.allclose(np.asarray(op.vmult(ones)), 0.0, atol=1e-12)


def test_diagonal_matches_dense():
    mesh = StructuredMesh(2, (4, 3))
    dofs = DofHandler(mesh, 3)
    A = assemble_laplace(dofs)
    op = LaplaceOperator(dofs)
    inv_diag = np.asarray(op.compute_inverse_diagonal())
    assert np.allclose(1.0 / inv_diag, A.diagonal(), atol=1e-11)


def test_poisson_solution_convergence():
    # -Δu = dim·π·Πsin(πx_d) on the unit square (the reference's sin-mp rhs),
    # so u = Πsin(πx_d)/π: solve with sparse LU and check nodal error drops.
    from dealii_asm.fem.functions import sinus_mp_rhs
    import scipy.sparse.linalg as spla

    errs = []
    for nc in (4, 8):
        mesh = StructuredMesh(2, (nc, nc))
        dofs = DofHandler(mesh, 2)
        op = LaplaceOperator(dofs)
        b = np.asarray(op.assemble_rhs(sinus_mp_rhs))
        A = assemble_laplace(dofs)
        u = spla.spsolve(A.tocsc(), b)
        pts = dofs.points
        exact = np.sin(np.pi * pts[:, 0]) * np.sin(np.pi * pts[:, 1]) / np.pi
        errs.append(np.abs(u - exact).max())
    assert errs[1] < errs[0] / 6  # ~p+1 order


class TestCompactGeometryVariants:
    """linear/quadratic geometry representations (operator.h:917-1159)."""

    @pytest.mark.parametrize("mt,mdeg", [("linear geometry", 1),
                                         ("quadratic geometry", 2),
                                         ("construct q", 2)])
    def test_matches_merged(self, mt, mdeg):
        from dealii_asm.mesh.transforms import kershaw_transform

        mesh = StructuredMesh(3, (3, 3, 3),
                              transform=kershaw_transform(0.5, 0.5))
        dofs = DofHandler(mesh, 2)
        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.standard_normal(dofs.n_dofs))
        op_c = LaplaceOperator(dofs, mapping_type=mt, dtype=jnp.float64)
        op_m = LaplaceOperator(dofs, mapping_degree=mdeg, dtype=jnp.float64)
        a = np.asarray(op_c.vmult(x))
        b = np.asarray(op_m.vmult(x))
        assert np.abs(a - b).max() / np.abs(b).max() < 1e-12
        d1 = np.asarray(op_c.compute_inverse_diagonal())
        d2 = np.asarray(op_m.compute_inverse_diagonal())
        np.testing.assert_allclose(d1, d2, rtol=1e-12)


class TestBandedApply:
    """Banded (diagonal-table) separable apply — the f64 outer-matvec path.

    The banded form runs elementwise shift-multiply-adds, O((2p+1)·n) per
    axis, in place of dense axis matmuls."""

    @pytest.mark.parametrize("periodic", [False, True])
    @pytest.mark.parametrize("dim,cells", [(2, (4, 3)), (3, (3, 4, 2)),
                                           (3, (2, 2, 2))])  # (2,2,2): band
    # wider than the periodic grid -> offset aliasing must not double-count
    def test_matches_dense_assembly(self, periodic, dim, cells):
        mesh = StructuredMesh(dim, cells,
                              lengths=tuple(1.0 + 0.3 * i for i in range(dim)),
                              periodic=(periodic,) * dim)
        dofs = DofHandler(mesh, 3)
        A = assemble_laplace(dofs)
        op = LaplaceOperator(dofs, kernel="banded", dtype=jnp.float64)
        u = _random_vec(dofs.n_dofs)
        mask = np.asarray(dofs.boundary_mask)
        expected = np.asarray(A @ np.where(mask, 0.0, u))
        expected = np.where(mask, u, expected)  # constrained rows = identity
        got = np.asarray(op.vmult(jnp.asarray(u)))
        assert np.allclose(got, expected,
                           atol=1e-10 * max(1, np.abs(expected).max()))

    @pytest.mark.parametrize("periodic", [False, True])
    @pytest.mark.parametrize("dim,cells", [(2, (4, 3)), (3, (3, 4, 2))])
    def test_dd_matches_emulated_f64(self, periodic, dim, cells):
        """The double-single (two-f32 Dekker/TwoSum) f64 vmult path agrees
        with the emulated-f64 banded path to ~2⁻⁴⁷ relative (ops/ddmath.py)."""
        mesh = StructuredMesh(dim, cells,
                              lengths=tuple(1.0 + 0.3 * i for i in range(dim)),
                              periodic=(periodic,) * dim)
        dofs = DofHandler(mesh, 3)
        op_dd = LaplaceOperator(dofs, dtype=jnp.float64)  # default: dd
        op_b = LaplaceOperator(dofs, kernel="banded", dtype=jnp.float64)
        u = _random_vec(dofs.n_dofs)
        a = np.asarray(op_dd.vmult(jnp.asarray(u)))
        b = np.asarray(op_b.vmult(jnp.asarray(u)))
        denom = max(1.0, np.abs(b).max())
        assert np.abs(a - b).max() / denom < 1e-12

    def test_f64_defaults_to_banded(self):
        mesh = StructuredMesh(3, (3, 3, 3))
        dofs = DofHandler(mesh, 2)
        op64 = LaplaceOperator(dofs, dtype=jnp.float64)
        op32 = LaplaceOperator(dofs, dtype=jnp.float32)
        u = _random_vec(dofs.n_dofs)
        a = np.asarray(op64.vmult(jnp.asarray(u)))
        b = np.asarray(op32.vmult(jnp.asarray(u, jnp.float32)))
        assert np.abs(a - b).max() / np.abs(a).max() < 1e-5


class TestMergedDDApply:
    """Double-single windowed apply on deformed (merged-geometry) meshes —
    the f64 outer-matvec path for Kershaw & friends
    (tensorops.merged_laplace_apply_windowed_dd)."""

    @pytest.mark.parametrize("periodic", [False, True])
    @pytest.mark.parametrize("dim,cells", [(2, (5, 4)), (3, (4, 3, 3))])
    def test_dd_matches_emulated_f64(self, periodic, dim, cells):
        tf = kershaw_transform(0.3, 0.3) if dim == 3 else \
            sinusoidal_displacement(0.08)
        mesh = StructuredMesh(dim, cells, periodic=(periodic,) * dim,
                              transform=tf)
        dofs = DofHandler(mesh, 4)
        op_dd = LaplaceOperator(dofs, mapping_degree=3, dtype=jnp.float64,
                                kernel="dd")
        op_or = LaplaceOperator(dofs, mapping_degree=3, dtype=jnp.float64,
                                kernel="banded")  # native windowed oracle
        assert op_dd.coeff6_dd is not None
        assert op_or.coeff6_dd is None
        u = _random_vec(dofs.n_dofs)
        a = np.asarray(op_dd.vmult(jnp.asarray(u)))
        b = np.asarray(op_or.vmult(jnp.asarray(u)))
        denom = max(1.0, np.abs(b).max())
        assert np.abs(a - b).max() / denom < 3e-13

    def test_residual_uses_dd_tables(self):
        tf = kershaw_transform(0.3, 0.3)
        mesh = StructuredMesh(3, (3, 3, 3), transform=tf)
        dofs = DofHandler(mesh, 3)
        op = LaplaceOperator(dofs, mapping_degree=3, dtype=jnp.float64,
                             kernel="dd")
        assert op.coeff6_dd is not None
        u = _random_vec(dofs.n_dofs)
        b = _random_vec(dofs.n_dofs)
        r = np.asarray(op.residual(jnp.asarray(b), jnp.asarray(u)))
        expect = np.asarray(b) - np.asarray(op.vmult(jnp.asarray(u)))
        assert np.abs(r - expect).max() < 1e-12 * max(1, np.abs(expect).max())
