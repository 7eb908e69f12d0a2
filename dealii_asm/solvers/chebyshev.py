"""Chebyshev and relaxation smoothers with Lanczos eigenvalue estimation.

Replicates deal.II PreconditionChebyshev / PreconditionRelaxation as configured
by the reference factory (/root/reference/include/precondition.templates.h:89-158,
267-438):

- eigenvalue estimation: 40 preconditioned-CG iterations, rhs = the deterministic
  high-frequency pattern (global index mod 11, mean subtracted, constrained rows
  zeroed), Lanczos tridiagonal eigenvalues from the CG coefficients;
- the returned estimates follow the reference's printed contract
  (golden outputs, tests/element_centered_preconitioners/small/*.output):
  min_estimate = λ̂ (largest tridiagonal eigenvalue), max_estimate = 1.2·λ̂;
- Chebyshev (first kind) smooths on [max_est/smoothing_range, max_est]
  with smoothing_range = 20; fourth kind uses the Lottes recurrence on
  (0, max_est];
- Relaxation uses ω = 2/(max_est/smoothing_range + max_est).

The smoother step is expressed as one jit-able composition so XLA fuses the
vector updates into the operator/preconditioner applications — the analog of
the reference's fused pre/post vector operations (P5 in SURVEY.md §2d).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from .krylov import IterationNumberControl, cg


def eig_initial_guess(n_dofs: int, constrained_mask=None):
    """deal.II's deterministic pseudo-random start vector: i % 11, mean removed."""
    v = (np.arange(n_dofs) % 11).astype(np.float64)
    v -= v.mean()
    if constrained_mask is not None:
        v[np.asarray(constrained_mask)] = 0.0
    return jnp.asarray(v)


@dataclass
class EigenvalueInfo:
    min_eigenvalue_estimate: float
    max_eigenvalue_estimate: float
    cg_n_iterations: int


def estimate_eigenvalues(A, n_dofs: int, M=None, constrained_mask=None,
                         n_iterations: int = 40, algorithm: str = "lanczos",
                         b0=None) -> EigenvalueInfo:
    """Estimate the largest eigenvalue of M⁻¹A.

    lanczos: CG tridiagonal after ``n_iterations`` its (deal.II eig_cg_n_iterations=40,
    /root/reference/include/precondition.templates.h:110).
    power iteration: ``n_iterations`` power steps on M⁻¹A.
    Returns (λ̂, 1.2·λ̂) matching the reference's printed min/max ev contract.
    ``b0`` overrides the start vector (sharded layouts pass the PADDED i%11
    pattern so estimates match the single-device run exactly).
    """
    b = eig_initial_guess(n_dofs, constrained_mask) if b0 is None else b0
    if algorithm == "lanczos":
        # stop the Lanczos CG when it has converged *in working precision*:
        # past convergence/stagnation the alpha/beta coefficients are noise
        # and poison the tridiagonal eigenvalues (in f32 this inflated a
        # level estimate to 14.9 vs a true 1.6)
        eps = float(jnp.finfo(b.dtype).eps)
        tol = max(1e-8, float(np.sqrt(eps))) * float(jnp.linalg.norm(b))
        control = IterationNumberControl(n_iterations, tol)
        result = cg(A, b, M=M, control=control, track_eigenvalues=True)
        if result.tridiag_eigenvalues is None or len(result.tridiag_eigenvalues) == 0:
            lam = 1.0
        else:
            lam = float(result.tridiag_eigenvalues[-1])
        its = result.n_iterations
        if float(jnp.finfo(b.dtype).eps) > 1e-10:
            # low precision: the Lanczos run may stop before λmax converges
            # (stagnation at the f32 noise floor under-estimates it, which
            # un-damps the Chebyshev top); take the max with a short Rayleigh
            # power iteration, which is cancellation-free
            Mfn = M or (lambda x: x)
            v = b / jnp.linalg.norm(b)
            lam_p = 0.0
            for _ in range(12):
                w = Mfn(A(v))
                lam_p = float(jnp.vdot(v, w))
                v = w / jnp.linalg.norm(w)
            lam = max(lam, lam_p)
    elif algorithm == "power iteration":
        M = M or (lambda x: x)
        v = b
        lam = 1.0
        for _ in range(n_iterations):
            w = M(A(v))
            lam = float(jnp.linalg.norm(w)) / float(jnp.linalg.norm(v))
            v = w / jnp.linalg.norm(w)
        its = n_iterations
    else:
        raise ValueError(algorithm)
    return EigenvalueInfo(lam, 1.2 * lam, its)


class ChebyshevPreconditioner:
    """deal.II-style Chebyshev smoother around (A, P).

    degree = number of P⁻¹A applications per vmult. First kind smooths
    [alpha, beta] = [max_est/smoothing_range, max_est]; residual polynomial is
    T_k((θ-λ)/δ)/T_k(θ/δ). Fourth kind follows the Lottes recurrence with
    λmax = max_est.
    """

    def __init__(self, A, M, n_dofs, degree=3, smoothing_range=20.0,
                 polynomial_type="1st kind", eigenvalues: EigenvalueInfo | None = None,
                 constrained_mask=None, ev_algorithm="lanczos",
                 eig_cg_n_iterations=40, eig_b0=None):
        self.A = A
        self.M = M
        self.degree = int(degree)
        self.smoothing_range = smoothing_range
        self.polynomial_type = polynomial_type
        if eigenvalues is None:
            eigenvalues = estimate_eigenvalues(
                A, n_dofs, M=M, constrained_mask=constrained_mask,
                n_iterations=eig_cg_n_iterations, algorithm=ev_algorithm,
                b0=eig_b0)
        self.eigenvalues = eigenvalues
        mx = eigenvalues.max_eigenvalue_estimate
        mn = eigenvalues.min_eigenvalue_estimate
        if smoothing_range > 1.0:
            alpha = mx / smoothing_range
        else:
            alpha = min(0.9 * mx, mn)
        self.alpha, self.beta_range = alpha, mx
        self.theta = (mx + alpha) / 2.0
        self.delta = (mx - alpha) / 2.0

    # -- first kind ----------------------------------------------------------

    def _first_kind(self, x, b, zero_guess=False):
        theta, delta = self.theta, self.delta
        if zero_guess:
            # x = 0: the residual IS b — skip the operator apply entirely
            # (pre-smoothing hits this on every level).
            p = self.M(b) * (1.0 / theta)
            x = p
        else:
            r = b - self.A(x)
            p = self.M(r) * (1.0 / theta)
            x = x + p
        rhok = delta / theta
        for _ in range(1, self.degree):
            r = b - self.A(x)
            rhokp = 1.0 / (2.0 * theta / delta - rhok)
            factor1 = rhokp * rhok
            factor2 = 2.0 * rhokp / delta
            p = factor1 * p + factor2 * self.M(r)
            x = x + p
            rhok = rhokp
        return x

    # -- fourth kind (Lottes) -------------------------------------------------

    def _fourth_kind(self, x, b, zero_guess=False):
        lam = self.beta_range
        if zero_guess:
            d = self.M(b) * (4.0 / (3.0 * lam))
        else:
            r = b - self.A(x)
            d = self.M(r) * (4.0 / (3.0 * lam))
        for k in range(1, self.degree):
            x = x + d
            r = b - self.A(x)
            d = d * ((2.0 * k - 1.0) / (2.0 * k + 3.0)) + self.M(r) * (
                (8.0 * k + 4.0) / ((2.0 * k + 3.0) * lam)
            )
        return x + d

    def _apply(self, x, b, zero_guess=False):
        if self.polynomial_type in ("1st kind", "first_kind", "first"):
            return self._first_kind(x, b, zero_guess)
        return self._fourth_kind(x, b, zero_guess)

    def vmult(self, b):
        return self._apply(jnp.zeros_like(b), b, zero_guess=True)

    def step(self, x, b):
        return self._apply(x, b)

    def __call__(self, b):
        return self.vmult(b)


class RelaxationPreconditioner:
    """deal.II PreconditionRelaxation: x ← x + ω P⁻¹ (b − A x), n_iterations times.

    ω defaults to 2/(max_est/smoothing_range + max_est)
    (/root/reference/include/precondition.templates.h:293-316).
    """

    def __init__(self, A, M, n_dofs, n_iterations=3, omega=0.0,
                 eigenvalues: EigenvalueInfo | None = None, smoothing_range=20.0,
                 constrained_mask=None, ev_algorithm="lanczos", eig_b0=None):
        self.A = A
        self.M = M
        self.n_iterations = int(n_iterations)
        if omega == 0.0:
            if eigenvalues is None:
                eigenvalues = estimate_eigenvalues(
                    A, n_dofs, M=M, constrained_mask=constrained_mask,
                    algorithm=ev_algorithm, b0=eig_b0)
            mx = eigenvalues.max_eigenvalue_estimate
            alpha = mx / smoothing_range if smoothing_range > 1.0 else min(
                0.9 * mx, eigenvalues.min_eigenvalue_estimate)
            omega = 2.0 / (alpha + mx)
            self.eigenvalues = eigenvalues
        else:
            self.eigenvalues = eigenvalues
        self.omega = omega

    def step(self, x, b):
        for _ in range(self.n_iterations):
            x = x + self.omega * self.M(b - self.A(x))
        return x

    def vmult(self, b):
        # zero initial guess: the first step is ω·M(b) — no operator apply
        x = self.omega * self.M(b)
        for _ in range(1, self.n_iterations):
            x = x + self.omega * self.M(b - self.A(x))
        return x

    def __call__(self, b):
        return self.vmult(b)
