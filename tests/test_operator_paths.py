"""Laplace operator applies on the XLA paths the GPU runs.

Native f64 (the default outer apply), double-single (kernel="dd" /
"lanes-dd") and the f32 MG-level applies, on Cartesian, Kershaw and ball
meshes, each checked against the float64 sparse reference assembly.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from dealii_asm.fem.assemble import assemble_laplace, assemble_laplace_general
from dealii_asm.fem.dofs import DofHandler
from dealii_asm.fem.general_dofs import GeneralDofHandler
from dealii_asm.mesh.grid import StructuredMesh
from dealii_asm.mesh.transforms import kershaw_transform
from dealii_asm.mesh.unstructured import hyper_ball_balanced
from dealii_asm.ops.laplace import LaplaceOperator
from dealii_asm.ops.laplace_general import GeneralLaplaceOperator


def rel_l2(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(a - ref) / np.linalg.norm(ref)


def _vec(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n)


@pytest.mark.parametrize("cells,p", [((4, 4, 4), 3), ((5, 3, 4), 4),
                                     ((2, 6, 3), 2)])
def test_dd_and_native_f64_match_oracle(cells, p):
    """The default f64 apply is native (banded, no dd tables); kernel="dd"
    is the double-single composition.  Both evaluate the same operator."""
    dofs = DofHandler(StructuredMesh(3, cells), p)
    nat = LaplaceOperator(dofs, dtype=jnp.float64)
    dd = LaplaceOperator(dofs, dtype=jnp.float64, kernel="dd")
    assert not nat.supports_dd and dd.supports_dd
    u = _vec(dofs.n_dofs)
    ref = assemble_laplace(dofs) @ u
    assert rel_l2(nat.vmult(jnp.asarray(u)), ref) < 1e-13
    assert rel_l2(dd.vmult(jnp.asarray(u)), ref) < 1e-12


def test_periodic_dd_matches_native():
    mesh = StructuredMesh(3, (4, 4, 4), periodic=(True, True, True))
    dofs = DofHandler(mesh, 2)
    nat = LaplaceOperator(dofs, dtype=jnp.float64)
    dd = LaplaceOperator(dofs, dtype=jnp.float64, kernel="dd")
    u = jnp.asarray(_vec(dofs.n_dofs, 1))
    assert rel_l2(dd.vmult(u), nat.vmult(u)) < 1e-12


@pytest.mark.parametrize("cells,p", [((4, 5, 3), 4), ((6, 4, 4), 2)])
def test_f32_level_operator_matches_oracle(cells, p):
    """The MG-level f32 apply: dense separable axis matmuls at "highest"
    (as the solver builds level operators) and the banded form."""
    dofs = DofHandler(StructuredMesh(3, cells), p)
    u = np.float32(_vec(dofs.n_dofs, 2))
    ref = assemble_laplace(dofs) @ u.astype(np.float64)
    dense = LaplaceOperator(dofs, dtype=jnp.float32,
                            matmul_precision="highest")
    banded = LaplaceOperator(dofs, dtype=jnp.float32, kernel="banded")
    assert rel_l2(dense.vmult(jnp.asarray(u)), ref) < 1e-5
    assert rel_l2(banded.vmult(jnp.asarray(u)), ref) < 1e-5


def _kershaw(cells, degree):
    mesh = StructuredMesh(3, cells, transform=kershaw_transform(0.3, 0.3))
    return DofHandler(mesh, degree)


@pytest.mark.parametrize("cells,degree", [((4, 4, 6), 3), ((3, 4, 5), 2),
                                          ((4, 3, 4), 4)])
def test_windowed_kershaw_apply_matches_oracle(cells, degree):
    """Deformed geometry, f64: the windowed merged-coefficient apply."""
    dofs = _kershaw(cells, degree)
    op = LaplaceOperator(dofs, mapping_degree=3, dtype=jnp.float64)
    assert op.coeff6_dd is None
    u = _vec(dofs.n_dofs, 5)
    ref = assemble_laplace(dofs, mapping_degree=3) @ u
    assert rel_l2(op.vmult(jnp.asarray(u)), ref) < 1e-12


def test_windowed_kershaw_dd_matches_native():
    """kernel="dd" on deformed geometry: the dd windowed apply equals the
    native one; the outer CG keeps f64 (no dd matvec on this geometry)."""
    dofs = _kershaw((4, 4, 4), 3)
    nat = LaplaceOperator(dofs, mapping_degree=3, dtype=jnp.float64)
    dd = LaplaceOperator(dofs, mapping_degree=3, dtype=jnp.float64,
                         kernel="dd", geometry=nat.geometry)
    assert dd.coeff6_dd is not None and not dd.supports_dd
    u = jnp.asarray(_vec(dofs.n_dofs, 11))
    assert rel_l2(dd.vmult(u), nat.vmult(u)) < 1e-12


@pytest.mark.parametrize("degree", [2, 3, 4])
def test_unstructured_lanes_apply_matches_oracle(degree):
    dh = GeneralDofHandler(hyper_ball_balanced(3), degree)
    op = GeneralLaplaceOperator(dh, dtype=jnp.float64)
    assert op.kernel == "lanes" and op.coeff6_dd is None
    u = _vec(dh.n_dofs, degree)
    ref = assemble_laplace_general(dh) @ u
    assert rel_l2(op.vmult(jnp.asarray(u)), ref) < 1e-12


def test_unstructured_lanes_dd_matches_native():
    # refined ball: 56 cells
    dh = GeneralDofHandler(hyper_ball_balanced(3).refine(), 3)
    nat = GeneralLaplaceOperator(dh, dtype=jnp.float64)
    dd = GeneralLaplaceOperator(dh, dtype=jnp.float64, kernel="lanes-dd")
    assert dd.kernel == "lanes" and dd.coeff6_dd is not None
    u = jnp.asarray(_vec(dh.n_dofs, 7))
    assert rel_l2(dd.vmult(u), nat.vmult(u)) < 1e-12


def test_unstructured_lanes_f32_matches_oracle():
    dh = GeneralDofHandler(hyper_ball_balanced(3), 3)
    op = GeneralLaplaceOperator(dh, dtype=jnp.float32,
                                matmul_precision="highest")
    u = np.float32(_vec(dh.n_dofs, 8))
    ref = assemble_laplace_general(dh) @ u.astype(np.float64)
    assert rel_l2(op.vmult(jnp.asarray(u)), ref) < 1e-5


def test_unstructured_residual_is_b_minus_vmult():
    dh = GeneralDofHandler(hyper_ball_balanced(3), 2)
    op = GeneralLaplaceOperator(dh, dtype=jnp.float64)
    u, b = (jnp.asarray(_vec(dh.n_dofs, s)) for s in (9, 10))
    assert rel_l2(op.residual(b, u), b - op.vmult(u)) < 1e-14
