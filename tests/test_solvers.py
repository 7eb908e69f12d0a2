import numpy as np
import jax.numpy as jnp
import pytest

from dealii_asm.solvers.krylov import (
    ReductionControl,
    bicgstab,
    cg,
    flexible_cg,
    fgmres,
    gmres,
)
from dealii_asm.solvers.chebyshev import ChebyshevPreconditioner, EigenvalueInfo


def _spd_system(n=60, seed=0):
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    lam = np.linspace(0.5, 50.0, n)
    A = (Q * lam) @ Q.T
    b = rng.standard_normal(n)
    return jnp.asarray(A), jnp.asarray(b)


@pytest.mark.parametrize("solver", [cg, flexible_cg, gmres, fgmres, bicgstab])
def test_krylov_solves_spd(solver):
    A, b = _spd_system()
    res = solver(lambda x: A @ x, b, control=ReductionControl(500, 1e-12, 1e-10))
    assert res.converged
    x = np.asarray(res.x)
    assert np.linalg.norm(np.asarray(A) @ x - np.asarray(b)) < 1e-8


def test_gmres_left_right_preconditioning():
    A, b = _spd_system(40, 1)
    d = jnp.asarray(1.0 / np.diag(np.asarray(A)))
    M = lambda x: d * x
    for right in (True, False):
        res = gmres(lambda x: A @ x, b, M=M, right_preconditioning=right,
                    control=ReductionControl(300, 1e-12, 1e-10))
        assert res.converged
        assert np.linalg.norm(np.asarray(A) @ np.asarray(res.x) - np.asarray(b)) < 1e-7


def test_cg_lanczos_eigenvalues():
    A, b = _spd_system(50, 2)
    res = cg(lambda x: A @ x, b, control=ReductionControl(200, 1e-14, 1e-13),
             track_eigenvalues=True)
    evs = res.tridiag_eigenvalues
    # extremal eigenvalues of the Lanczos tridiagonal approximate those of A
    assert abs(evs[-1] - 50.0) < 0.5
    assert abs(evs[0] - 0.5) < 0.1


def test_chebyshev_first_kind_residual_polynomial():
    # After a degree-k vmult on x0=0, the error e = x* - x satisfies
    # e = r_k(P⁻¹A) x* with r_k(λ) = T_k((θ-λ)/δ)/T_k(θ/δ).  Check on a diagonal
    # system where everything is computable analytically.
    lam = np.array([0.1, 0.5, 1.0, 1.5, 2.0])
    A = jnp.asarray(np.diag(lam))
    info = EigenvalueInfo(2.0, 2.4, 0)
    for degree in (1, 2, 3, 5):
        cheb = ChebyshevPreconditioner(
            lambda x: A @ x, lambda x: x, 5, degree=degree, eigenvalues=info)
        xstar = jnp.asarray(np.ones(5))
        b = A @ xstar
        x = cheb.vmult(b)
        theta, delta = cheb.theta, cheb.delta
        tk = np.polynomial.chebyshev.Chebyshev([0] * degree + [1])
        rk = tk((theta - lam) / delta) / tk(theta / delta)
        np.testing.assert_allclose(np.asarray(xstar - x), rk * np.asarray(xstar),
                                   atol=1e-12)


def test_chebyshev_fourth_kind_residual_polynomial():
    # The 4th-kind recurrence must realize the residual polynomial
    # r_k(λ) = W_k(1 - 2λ/λmax) / (2k+1) with W_k the Chebyshev polynomial of
    # the fourth kind, W_k(cos θ) = sin((k+1/2)θ)/sin(θ/2).
    lam = np.linspace(0.05, 2.0, 30)
    A = jnp.asarray(np.diag(lam))
    info = EigenvalueInfo(2.0, 2.4, 0)
    lam_max = info.max_eigenvalue_estimate
    for degree in (1, 2, 5):
        cheb = ChebyshevPreconditioner(lambda x: A @ x, lambda x: x, 30,
                                       degree=degree,
                                       polynomial_type="4th kind",
                                       eigenvalues=info)
        xstar = jnp.asarray(np.ones(30))
        b = A @ xstar
        x = cheb.vmult(b)
        err = np.asarray(xstar - x)
        theta = np.arccos(np.clip(1.0 - 2.0 * lam / lam_max, -1.0, 1.0))
        with np.errstate(invalid="ignore", divide="ignore"):
            W = np.sin((degree + 0.5) * theta) / np.sin(theta / 2.0)
        W = np.where(theta == 0.0, 2 * degree + 1, W)
        rk = W / (2 * degree + 1)
        np.testing.assert_allclose(err, rk, atol=1e-12)
        # step() from the vmult result must keep improving
        x2 = cheb.step(x, b)
        assert np.linalg.norm(np.asarray(xstar - x2)) < np.linalg.norm(err)


class TestDDCG:
    """All-dd outer CG (krylov._cg_device_dd): engages on the P8 architecture
    (f64 rhs + dd-capable operator + f32 preconditioner behind an adapter)
    and must reproduce the f64 device CG's iterations and solution."""

    def _setup(self, cells=(6, 5, 4), p=2):
        from dealii_asm.fem.dofs import DofHandler
        from dealii_asm.mesh.grid import StructuredMesh
        from dealii_asm.ops.laplace import LaplaceOperator
        from dealii_asm.precond.adapter import PrecisionAdapter
        from dealii_asm.precond.diagonal import DiagonalPreconditioner

        mesh = StructuredMesh(3, cells)
        dofs = DofHandler(mesh, p)
        op = LaplaceOperator(dofs, dtype=jnp.float64, kernel="dd")
        assert op.supports_dd
        op32 = LaplaceOperator(dofs, dtype=jnp.float32)
        M = PrecisionAdapter(DiagonalPreconditioner(op32), jnp.float32)
        rng = np.random.default_rng(3)
        b = jnp.asarray(rng.standard_normal(dofs.n_dofs))
        b = jnp.where(op.constrained if hasattr(op, "constrained")
                      else jnp.zeros_like(b, bool), 0.0, b)
        return op, M, b

    def test_matches_f64_device_cg(self):
        from dealii_asm.solvers import krylov

        op, M, b = self._setup()
        control = ReductionControl(max_steps=200, tolerance=1e-12,
                                   reduce=1e-8)
        res_dd = krylov._cg_device_dd(op, b, M.vmult, control, None)
        res_64 = krylov._cg_device(op.vmult, b, M.vmult, control, None)
        assert res_dd.converged and res_64.converged
        assert res_dd.n_iterations == res_64.n_iterations
        x_dd = np.asarray(res_dd.x)
        x_64 = np.asarray(res_64.x)
        assert np.abs(x_dd - x_64).max() <= 1e-9 * np.abs(x_64).max()

    def test_dispatch_engages(self, monkeypatch):
        from dealii_asm.solvers import krylov

        op, M, b = self._setup(cells=(4, 4, 3))
        hits = []
        orig = krylov._cg_device_dd

        def spy(*a, **k):
            hits.append(1)
            return orig(*a, **k)

        monkeypatch.setattr(krylov, "_cg_device_dd", spy)
        res = krylov.cg(op.vmult, b, M=M.vmult,
                        control=ReductionControl(max_steps=200,
                                                 tolerance=1e-10,
                                                 reduce=1e-6))
        assert hits and res.converged

    def test_vmult_dd_matches_f64_vmult(self):
        from dealii_asm.ops.ddmath import dd_from_f64, dd_to_f64

        op, M, b = self._setup(cells=(5, 4, 4), p=3)
        u = b / jnp.linalg.norm(b)
        vh, vl = op.vmult_dd(*dd_from_f64(u))
        v_dd = np.asarray(dd_to_f64(vh, vl))
        v_64 = np.asarray(op.vmult(u))
        assert np.abs(v_dd - v_64).max() <= 1e-11 * np.abs(v_64).max()


class TestChunkedDeviceCG:
    """The device CG re-dispatches in bounded chunks (first chunk 32
    iterations) so no while_loop dispatch runs for minutes.  A solve
    crossing several chunk boundaries must match the host loop exactly."""

    def test_long_solve_crosses_chunks(self):
        from dealii_asm.fem.dofs import DofHandler
        from dealii_asm.mesh.grid import StructuredMesh
        from dealii_asm.ops.laplace import LaplaceOperator
        from dealii_asm.precond.factory import DiagonalPreconditioner

        mesh = StructuredMesh(2, (24, 24))
        dofs = DofHandler(mesh, 2)
        op = LaplaceOperator(dofs, dtype=jnp.float64)
        M = DiagonalPreconditioner(op)
        b = op.assemble_rhs(lambda p: np.ones(len(p)))
        ctl = ReductionControl(500, 1e-16, 1e-10)
        dev = cg(op.vmult, b, M=M.vmult, control=ctl)
        host = cg(op.vmult, b, M=M.vmult, control=ctl, device_loop=False)
        assert dev.converged and host.converged
        assert dev.n_iterations > 32  # crossed at least one chunk boundary
        assert dev.n_iterations == host.n_iterations
        np.testing.assert_allclose(np.asarray(dev.x), np.asarray(host.x),
                                   rtol=0, atol=1e-9)
        # same monitoring convention/length; values agree to summation-order
        # noise (which is amplified near the 1e-12 residual floor)
        assert len(dev.residuals) == len(host.residuals)
        np.testing.assert_allclose(dev.residuals[:20], host.residuals[:20],
                                   rtol=1e-5)
