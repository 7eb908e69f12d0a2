import numpy as np
import pytest

from dealii_asm.fem.lagrange import (
    gauss_lobatto_points,
    gauss_points,
    lagrange_derivatives,
    lagrange_values,
    reference_mass_stiffness_1d,
    shape_1d,
)


def test_gauss_points_integrate_polynomials():
    q, w = gauss_points(4)
    # exact for degree up to 7 on [0,1]
    for k in range(8):
        assert np.isclose((w * q**k).sum(), 1.0 / (k + 1), atol=1e-14)


def test_gll_points_symmetric_and_bounded():
    for n in range(2, 9):
        x = gauss_lobatto_points(n)
        assert x[0] == 0.0 and x[-1] == 1.0
        assert np.allclose(x + x[::-1], 1.0, atol=1e-14)
        assert np.all(np.diff(x) > 0)


def test_lagrange_partition_of_unity_and_derivative():
    nodes = gauss_lobatto_points(5)
    x = np.linspace(0, 1, 13)
    V = lagrange_values(nodes, x)
    assert np.allclose(V.sum(axis=1), 1.0, atol=1e-12)
    D = lagrange_derivatives(nodes, x)
    assert np.allclose(D.sum(axis=1), 0.0, atol=1e-11)
    # interpolation of a quartic is exact for 5 nodes
    f = lambda t: 3 * t**4 - t**2 + 0.5
    df = lambda t: 12 * t**3 - 2 * t
    assert np.allclose(V @ f(nodes), f(x), atol=1e-12)
    assert np.allclose(D @ f(nodes), df(x), atol=1e-10)


@pytest.mark.parametrize("p", [1, 2, 3, 4, 7])
def test_reference_mass_stiffness(p):
    M, K = reference_mass_stiffness_1d(p)
    # mass: row sums integrate the basis -> total = 1; K annihilates constants
    assert np.isclose(M.sum(), 1.0, atol=1e-13)
    assert np.allclose(K @ np.ones(p + 1), 0.0, atol=1e-11)
    # linear function: K x = [-1, 0.., 1] boundary fluxes
    nodes = gauss_lobatto_points(p + 1)
    kx = K @ nodes
    expect = np.zeros(p + 1)
    expect[0], expect[-1] = -1.0, 1.0
    assert np.allclose(kx, expect, atol=1e-11)
    # symmetry
    assert np.allclose(M, M.T, atol=1e-14)
    assert np.allclose(K, K.T, atol=1e-14)


def test_p1_matrices_analytic():
    M, K = reference_mass_stiffness_1d(1)
    assert np.allclose(M, np.array([[2, 1], [1, 2]]) / 6.0, atol=1e-14)
    assert np.allclose(K, np.array([[1, -1], [-1, 1]]), atol=1e-14)
