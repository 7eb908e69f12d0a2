"""Mixed-precision iterative refinement (solvers/refinement.py)."""

import numpy as np
import jax.numpy as jnp

from dealii_asm.fem.dofs import DofHandler
from dealii_asm.fem.functions import constant_rhs
from dealii_asm.mesh.grid import StructuredMesh
from dealii_asm.ops.laplace import LaplaceOperator
from dealii_asm.precond.asm import ASMPreconditioner
from dealii_asm.solvers.chebyshev import ChebyshevPreconditioner, estimate_eigenvalues
from dealii_asm.solvers.refinement import refined_solve


def test_refined_solve_reaches_f64_accuracy():
    mesh = StructuredMesh(2, (8, 8))
    dofs = DofHandler(mesh, 3)
    op64 = LaplaceOperator(dofs, dtype=jnp.float64)
    op32 = LaplaceOperator(dofs, dtype=jnp.float32)
    asm = ASMPreconditioner(dofs, n_overlap=1, weighting_type="symm",
                            dtype=jnp.float32)
    ev = estimate_eigenvalues(op32.vmult, dofs.n_dofs, M=asm.vmult,
                              constrained_mask=dofs.boundary_mask)
    cheb = ChebyshevPreconditioner(op32.vmult, asm.vmult, dofs.n_dofs,
                                   degree=2, eigenvalues=ev)
    b = op64.assemble_rhs(constant_rhs)
    res = refined_solve(op64.vmult, op32.vmult, b, cheb.vmult,
                        rel_tolerance=1e-9, max_outer=12)
    assert res.converged
    # each refinement cycle contracts the TRUE residual (f64-verified)
    ratios = [b_ / a_ for a_, b_ in zip(res.residuals, res.residuals[1:])]
    assert max(ratios) < 0.5
    # true residual really is below 1e-9 relative
    r = np.asarray(op64.vmult(res.x)) - np.asarray(b)
    assert np.linalg.norm(r) < 1e-9 * np.linalg.norm(np.asarray(b)) * 1.01
