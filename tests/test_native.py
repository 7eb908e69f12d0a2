"""Native C++ setup core vs NumPy fallbacks (must agree to roundoff)."""

import numpy as np
import pytest
import scipy.linalg as sla

import dealii_asm.native as native
from dealii_asm.fem.lagrange import reference_mass_stiffness_1d
from dealii_asm.precond.fdm import fdm_1d_matrices as py_fdm

pytestmark = pytest.mark.skipif(native.get_lib() is None,
                                reason="native library unavailable")


def test_assemble_global_1d_matches_python():
    Mr, Kr = reference_mass_stiffness_1d(3)
    for per in (False, True):
        M, K = native.assemble_global_1d(Mr, Kr, 3, 5, 0.7, per)
        p, C = 3, 5
        N = p * C if per else p * C + 1
        Mp = np.zeros((N, N))
        Kp = np.zeros((N, N))
        for c in range(C):
            idx = (c * p + np.arange(p + 1)) % N
            Mp[np.ix_(idx, idx)] += Mr * 0.7
            Kp[np.ix_(idx, idx)] += Kr / 0.7
        np.testing.assert_allclose(M, Mp, atol=1e-14)
        np.testing.assert_allclose(K, Kp, atol=1e-14)


@pytest.mark.parametrize("ov,ext,bl,br", [
    (1, (0.3, 0.3, 0.3), "internal", "internal"),
    (2, (0.0, 0.3, 0.4), "dirichlet", "internal"),
    (3, (0.2, 0.3, 0.0), "internal", "dirichlet"),
    (1, (0.0, 0.5, 0.0), "dirichlet", "dirichlet"),
])
def test_fdm_1d_matrices_match_python(ov, ext, bl, br):
    Mr, Kr = reference_mass_stiffness_1d(4)
    Mw, Kw = native.fdm_1d_matrices(Mr, Kr, 4, ov, ext, bl, br)
    Mp, Kp = py_fdm(4, ov, ext, bl, br)
    np.testing.assert_allclose(Mw, Mp, atol=1e-14)
    np.testing.assert_allclose(Kw, Kp, atol=1e-14)


def test_generalized_eigh_matches_scipy():
    rng = np.random.default_rng(1)
    for n in (4, 9, 15):
        A = rng.standard_normal((n, n))
        K = A @ A.T + n * np.eye(n)
        B = rng.standard_normal((n, n))
        M = B @ B.T + n * np.eye(n)
        lam, V = native.generalized_eigh(K, M)
        lam_ref = sla.eigh(K, M, eigvals_only=True)
        np.testing.assert_allclose(lam, lam_ref, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(V.T @ M @ V, np.eye(n), atol=1e-16 * n * 100)
        np.testing.assert_allclose(K @ V, M @ V @ np.diag(lam), atol=1e-10)
