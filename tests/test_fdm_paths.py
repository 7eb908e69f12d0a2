"""FDM Schwarz apply and smoother composition on the XLA paths the GPU runs.

Every case is checked against a float64 NumPy oracle that assembles each
patch's tensor-product matrix from ``fdm_1d_matrices`` and inverts it
densely (no eigen-decomposition, no global folding), and the Laplace
operator from the sparse reference assembly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dealii_asm.fem.assemble import assemble_laplace
from dealii_asm.fem.dofs import DofHandler
from dealii_asm.fem.patches import element_patch_indices
from dealii_asm.mesh.grid import StructuredMesh
from dealii_asm.mesh.transforms import kershaw_transform
from dealii_asm.ops.laplace import LaplaceOperator
from dealii_asm.precond.asm import ASMPreconditioner
from dealii_asm.precond.fdm import fdm_1d_matrices
from dealii_asm.solvers.chebyshev import (ChebyshevPreconditioner,
                                          EigenvalueInfo,
                                          RelaxationPreconditioner)

GRID = [((4, 4, 4), 2, "symm"), ((4, 3, 5), 3, "symm"),
        ((3, 4, 2), 2, "post"), ((2, 3, 4), 4, "pre"), ((3, 3, 3), 3, "none")]


def fdm_oracle(dofs, weighting, x):
    """Σ_c R_cᵀ W A_c⁻¹ W R_c x in float64 NumPy (element patches, ov 1)."""
    mesh, p, n = dofs.mesh, dofs.degree, dofs.n_dofs
    dim = mesh.dim
    idx = np.asarray(element_patch_indices(dofs, 1))
    mask = np.asarray(dofs.boundary_mask)
    idx = np.where(mask[np.clip(idx, 0, n - 1)] | (idx >= n), n, idx)
    counts = np.bincount(idx.ravel(), minlength=n + 1)[:n].astype(float)
    counts[counts == 0] = 1.0
    w = {"none": np.ones(n), "pre": 1 / counts, "post": 1 / counts,
         "symm": np.sqrt(1 / counts)}[weighting]
    w_in = w if weighting in ("pre", "symm") else np.ones(n)
    w_out = w if weighting in ("post", "symm") else np.ones(n)
    ext = mesh.harmonic_patch_extents(p + 1)
    nbr = mesh.neighbors()
    xw = np.append(np.asarray(x, np.float64) * w_in, 0.0)
    dst = np.zeros(n + 1)
    for c in range(idx.shape[0]):
        mk = []
        for d in range(dim):
            bc = ["internal" if nbr[c, d, s] >= 0 else "dirichlet"
                  for s in (0, 1)]
            mk.append(fdm_1d_matrices(p, 1, tuple(ext[c, d]), *bc))
        A = 0.0
        for d in range(dim):
            term = np.ones((1, 1))
            for e in reversed(range(dim)):  # kron: x fastest
                term = np.kron(term, mk[e][1] if e == d else mk[e][0])
            A = A + term
        np.add.at(dst, idx[c], np.linalg.solve(A, xw[idx[c]]))
    return dst[:n] * w_out


def laplace_oracle(dofs):
    return assemble_laplace(dofs, constrained="identity")


def rel_l2(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(a - ref) / np.linalg.norm(ref)


def _setup(cells, p, wt=None, dtype=jnp.float64):
    dofs = DofHandler(StructuredMesh(3, cells), p)
    asm = ASMPreconditioner(dofs, n_overlap=1, weighting_type=wt or "symm",
                            dtype=dtype)
    return dofs, asm


@pytest.mark.parametrize("cells,p,wt", GRID)
def test_global_fdm_apply_matches_dense_oracle(cells, p, wt):
    """The folded global FDM (tensorops.fdm_global_apply), in f64 to
    roundoff and in f32 at the solver's matmul precision to f32 level."""
    dofs, asm = _setup(cells, p, wt)
    assert asm.global_fdm is not None  # the production Cartesian path
    x = np.random.default_rng(0).standard_normal(dofs.n_dofs)
    ref = fdm_oracle(dofs, wt, x)
    assert rel_l2(asm.vmult(jnp.asarray(x)), ref) < 1e-11
    asm32 = ASMPreconditioner(dofs, n_overlap=1, weighting_type=wt,
                              dtype=jnp.float32)
    got = asm32.vmult(jnp.asarray(x, jnp.float32))
    assert rel_l2(got, fdm_oracle(dofs, wt, np.float32(x))) < 1e-5


def _dot_precisions(fn, x):
    hlo = jax.jit(fn).lower(x).as_text()
    return [ln for ln in hlo.splitlines() if "dot_general" in ln]


def test_fdm_matmul_precision_is_explicit():
    """The f32 FDM applies name their matmul precision (true f32 unless a
    config selects TF32); a traced apply carries it on every dot, as do the
    level operator's."""
    dofs, asm = _setup((3, 3, 3), 3, dtype=jnp.float32)
    assert asm.matmul_precision == "highest"
    tf32 = ASMPreconditioner(dofs, n_overlap=1, weighting_type="symm",
                             dtype=jnp.float32,
                             matmul_precision="tensorfloat32")
    op = LaplaceOperator(dofs, dtype=jnp.float32, matmul_precision="highest")
    x = jnp.ones(dofs.n_dofs, jnp.float32)
    for fn, want in ((asm.vmult_traceable, "[HIGHEST, HIGHEST]"),
                     (tf32.vmult_traceable, "[HIGH, HIGH]"),
                     (op.vmult_traceable, "[HIGHEST, HIGHEST]")):
        dots = _dot_precisions(fn, x)
        assert dots and all(want in ln for ln in dots)


@pytest.mark.parametrize("dtype,asked,want", [
    (jnp.float32, None, "highest"),
    (jnp.float32, "tensorfloat32", "tensorfloat32"),
    (jnp.float64, None, None),
    (jnp.float64, "tensorfloat32", None)])
def test_fdm_matmul_precision_applies_to_f32_only(dtype, asked, want):
    """f64 FDM applies name no precision whatever the config asks: their
    matmuls are f64 and the dots carry the default."""
    dofs = DofHandler(StructuredMesh(3, (3, 3, 3)), 2)
    asm = ASMPreconditioner(dofs, n_overlap=1, weighting_type="symm",
                            dtype=dtype, matmul_precision=asked)
    assert asm.matmul_precision == want
    if want is None:
        dots = _dot_precisions(asm.vmult_traceable,
                               jnp.ones(dofs.n_dofs, dtype))
        assert dots and not any("HIGH" in ln for ln in dots)


@pytest.mark.parametrize("general", [False, True])
def test_fdm_matmul_precision_follows_config(general):
    """The FDM smoother's "matmul precision" key reaches the structured and
    the unstructured ASM; without it the default holds."""
    from dealii_asm.precond.factory import create_system_preconditioner

    if general:
        from dealii_asm.fem.general_dofs import GeneralDofHandler
        from dealii_asm.mesh.unstructured import hyper_ball_balanced
        from dealii_asm.ops.laplace_general import GeneralLaplaceOperator

        op = GeneralLaplaceOperator(
            GeneralDofHandler(hyper_ball_balanced(3), 2), dtype=jnp.float32)
    else:
        op = LaplaceOperator(DofHandler(StructuredMesh(3, (2, 2, 2)), 2),
                             dtype=jnp.float32)
    params = {"type": "FDM", "n overlap": 1, "weighting type": "symm"}
    quiet = lambda *_: None
    assert create_system_preconditioner(
        op, params, quiet).matmul_precision == "highest"
    params["matmul precision"] = "tensorfloat32"
    assert create_system_preconditioner(
        op, params, quiet).matmul_precision == "tensorfloat32"


def test_lanes_fdm_apply_on_deformed_mesh_matches_dense_oracle():
    """Kershaw geometry: the 1D patch matrices do not factor per
    coordinate, so the lane-major per-cell path serves (no global fold)."""
    mesh = StructuredMesh(3, (3, 3, 4), transform=kershaw_transform(0.3, 0.3))
    dofs = DofHandler(mesh, 3)
    asm = ASMPreconditioner(dofs, n_overlap=1, weighting_type="symm")
    assert asm.global_fdm is None and asm.lanes is not None
    x = np.random.default_rng(4).standard_normal(dofs.n_dofs)
    assert rel_l2(asm.vmult(jnp.asarray(x)), fdm_oracle(dofs, "symm", x)) \
        < 1e-11


@pytest.mark.parametrize("cells,p,wt,om", [
    ((4, 4, 4), 2, "symm", 1.0), ((4, 3, 5), 3, "symm", 0.8),
    ((3, 4, 2), 2, "post", 1.0), ((2, 3, 4), 4, "pre", 0.9)])
def test_smoother_step_matches_oracle(cells, p, wt, om):
    """One relaxation step x + ω P⁻¹(b − A x): f64 to roundoff, and the f32
    MG-level composition (operator at "highest") to f32 level."""
    dofs, asm = _setup(cells, p, wt)
    A = laplace_oracle(dofs)
    rng = np.random.default_rng(1)
    x, b = rng.standard_normal((2, dofs.n_dofs))
    ref = x + om * fdm_oracle(dofs, wt, b - A @ x)
    for dtype, tol in ((jnp.float64, 1e-11), (jnp.float32, 1e-5)):
        op = LaplaceOperator(dofs, dtype=dtype, matmul_precision="highest")
        M = asm if dtype == jnp.float64 else ASMPreconditioner(
            dofs, n_overlap=1, weighting_type=wt, dtype=dtype)
        rel = RelaxationPreconditioner(op.vmult, M.vmult, dofs.n_dofs,
                                       n_iterations=1, omega=om)
        got = rel.step(jnp.asarray(x, dtype), jnp.asarray(b, dtype))
        assert rel_l2(got, ref) < tol


@pytest.mark.parametrize("cells,p,n_steps", [
    ((4, 4, 4), 2, 2), ((4, 3, 5), 3, 2), ((3, 4, 4), 2, 3)])
def test_relaxation_sweep_matches_repeated_oracle_steps(cells, p, n_steps):
    dofs, asm = _setup(cells, p)
    op = LaplaceOperator(dofs)
    A = laplace_oracle(dofs)
    rng = np.random.default_rng(3)
    x, b = rng.standard_normal((2, dofs.n_dofs))
    om = 0.7
    rel = RelaxationPreconditioner(op.vmult, asm.vmult, dofs.n_dofs,
                                   n_iterations=n_steps, omega=om)
    ref_step, ref_vmult = x, np.zeros_like(b)
    for _ in range(n_steps):
        ref_step = ref_step + om * fdm_oracle(dofs, "symm", b - A @ ref_step)
        ref_vmult = ref_vmult + om * fdm_oracle(dofs, "symm",
                                                b - A @ ref_vmult)
    assert rel_l2(rel.step(jnp.asarray(x), jnp.asarray(b)), ref_step) < 1e-11
    assert rel_l2(rel.vmult(jnp.asarray(b)), ref_vmult) < 1e-11


def _chebyshev_oracle(A, P, x, b, deg, kind, lam_max):
    """deal.II PreconditionChebyshev recurrences on the oracle (float64)."""
    if kind == "1st kind":
        alpha = lam_max / 20.0
        theta, delta = (lam_max + alpha) / 2, (lam_max - alpha) / 2
        p = P(b - A @ x) / theta
        x = x + p
        rhok = delta / theta
        for _ in range(1, deg):
            rhokp = 1.0 / (2.0 * theta / delta - rhok)
            p = rhokp * rhok * p + 2.0 * rhokp / delta * P(b - A @ x)
            x, rhok = x + p, rhokp
        return x
    d = P(b - A @ x) * (4.0 / (3.0 * lam_max))
    for k in range(1, deg):
        x = x + d
        d = d * ((2 * k - 1) / (2 * k + 3)) + P(b - A @ x) * (
            (8 * k + 4) / ((2 * k + 3) * lam_max))
    return x + d


@pytest.mark.parametrize("cells,p,deg,kind,zero", [
    ((4, 4, 4), 2, 3, "1st kind", False), ((4, 3, 5), 3, 2, "1st kind", True),
    ((3, 4, 4), 2, 3, "4th kind", True)])
def test_chebyshev_sweep_matches_oracle(cells, p, deg, kind, zero):
    """Chebyshev smoother (both kinds, with and without the zero-guess
    fast path) against the recurrences evaluated on the oracle."""
    dofs, asm = _setup(cells, p)
    op = LaplaceOperator(dofs)
    A = laplace_oracle(dofs)
    cheb = ChebyshevPreconditioner(
        op.vmult, asm.vmult, dofs.n_dofs, degree=deg,
        eigenvalues=EigenvalueInfo(1.2, 1.5, 0), polynomial_type=kind)
    rng = np.random.default_rng(11)
    x, b = rng.standard_normal((2, dofs.n_dofs))
    x0 = np.zeros_like(b) if zero else x
    ref = _chebyshev_oracle(A, lambda r: fdm_oracle(dofs, "symm", r), x0, b,
                            deg, kind, 1.5)
    got = (cheb.vmult(jnp.asarray(b)) if zero
           else cheb.step(jnp.asarray(x), jnp.asarray(b)))
    assert rel_l2(got, ref) < 1e-11


@pytest.mark.parametrize("kind", ["1st kind", "4th kind"])
def test_degree_one_chebyshev_is_one_weighted_step(kind):
    """Degree-1 Chebyshev (the flagship smoother) is one Richardson step
    with ω = 1/θ (first kind) or 4/(3 λmax) (fourth kind)."""
    dofs, asm = _setup((3, 3, 4), 3)
    op = LaplaceOperator(dofs)
    cheb = ChebyshevPreconditioner(
        op.vmult, asm.vmult, dofs.n_dofs, degree=1,
        eigenvalues=EigenvalueInfo(1.1, 1.4, 0), polynomial_type=kind)
    om = 1.0 / cheb.theta if kind == "1st kind" else 4.0 / (3.0 * 1.4)
    rel = RelaxationPreconditioner(op.vmult, asm.vmult, dofs.n_dofs,
                                   n_iterations=1, omega=om)
    rng = np.random.default_rng(5)
    x, b = (jnp.asarray(v) for v in rng.standard_normal((2, dofs.n_dofs)))
    assert rel_l2(cheb.step(x, b), rel.step(x, b)) < 1e-13
