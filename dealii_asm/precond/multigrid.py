"""Geometric/polynomial multigrid V-cycle preconditioner.

Rebuilds ``PreconditionerGMG`` (/root/reference/include/multigrid.h:109-537)
and deal.II's Multigrid level-V-step: per level pre-smooth (vmult), residual,
restrict, recurse, prolongate-and-add, post-smooth (step).  Supports the
reference's options: one-sided V-cycle (identity post-smoother,
multigrid.h:305-322), n>1 coarse cycles (multigrid.h:357-375), and an
intermediate level that splits the hierarchy into a fine part and an inner
multigrid used as its coarse solver (multigrid.h:260-375).

Coarse solvers: any preconditioner's vmult (MGCoarseGridApplyPreconditioner,
multigrid.h:19-107) or a dense direct inverse ("AMG-equivalent": the reference
uses Trilinos AMG on the coarsest level; a direct solve reproduces its
iteration counts at coarse sizes — documented deviation).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


class DirectCoarseSolver:
    """Dense inverse of the (constrained) coarse matrix, applied as a matmul.

    Stands in for TrilinosWrappers::PreconditionAMG
    (/root/reference/include/precondition.templates.h:592-613): at the coarse
    sizes the reference runs AMG on, a direct solve gives the same outer
    iteration counts (AMG is essentially exact there, cf. dummy_amg.output: 1 it).
    """

    def __init__(self, dofs, dtype=jnp.float64):
        from ..fem.general_dofs import GeneralDofHandler

        if isinstance(dofs, GeneralDofHandler):
            from ..fem.assemble import assemble_laplace_general as _asm
        else:
            from ..fem.assemble import assemble_laplace as _asm
        A = _asm(dofs).toarray()
        self.Ainv = jnp.asarray(np.linalg.inv(A), dtype)

    def vmult(self, b):
        return jnp.matmul(self.Ainv, b, precision="highest")

    def __call__(self, b):
        return self.vmult(b)


class IterativeCoarseSolver:
    """Matrix-free coarse solve: diagonal-preconditioned CG to a reduction.

    The scalable replacement for the dense inverse at large coarse sizes
    (the reference runs Trilinos AMG there,
    /root/reference/include/precondition.templates.h:592-613); fixed iteration
    structure (lax.while under jit via the Krylov layer), usable inside a
    whole-V-cycle jit because it is called with concrete tolerances.
    """

    def __init__(self, op, reduction: float = 1e-4, max_iterations: int = 200):
        from ..solvers.krylov import cg_traceable

        self._cg = cg_traceable
        self.op = op
        self.reduction = reduction
        self.max_iterations = max_iterations
        self._inv_diag = op.compute_inverse_diagonal()

    def vmult(self, b):
        inv_diag = self._inv_diag

        def M(v):
            return v * inv_diag

        return self._cg(self.op.vmult_traceable, b, M,
                        reduction=self.reduction,
                        max_iterations=self.max_iterations)

    def __call__(self, b):
        return self.vmult(b)


class Multigrid:
    """V-cycle over a list of levels (coarse → fine).

    levels: list of dicts with keys 'operator' (callable vmult) and 'smoother'
    (object with vmult(b) and step(x, b)).  transfers[i] connects level i
    (coarse) to level i+1 (fine).  coarse_solver: callable vmult on level 0.
    """

    def __init__(self, operators, smoothers, transfers, coarse_solver,
                 one_sided: bool = False, n_coarse_cycles: int = 1,
                 timer=None):
        assert len(operators) == len(smoothers) + 1 or len(operators) == len(smoothers)
        self.operators = operators
        self.smoothers = smoothers  # smoothers[l] for level l >= 1 (index l-1)
        self.transfers = transfers
        self.coarse_solver = coarse_solver
        self.one_sided = one_sided
        self.n_coarse_cycles = n_coarse_cycles
        self.n_levels = len(operators)
        if timer is None:
            from ..utils.profiling import StageTimer

            timer = StageTimer(enabled=False)
        self.timer = timer
        # the V-cycle is pure static control flow: jit it whole so one
        # application is ONE dispatch (a 9-level cycle otherwise pays ~60
        # host round-trips).
        # Stage timing requires host boundaries, so jit only when not timing.
        self._jitted = None

    def _vmult_whole(self, src):
        return self._v_step(self.n_levels - 1, src)

    def _coarse_solve(self, rhs):
        x = self.coarse_solver(rhs)
        for _ in range(1, self.n_coarse_cycles):
            x = x + self.coarse_solver(rhs - self.operators[0](x))
        return x

    def _v_step(self, level: int, rhs):
        t = self.timer
        if level == 0:
            return t.run(0, "coarse solve", self._coarse_solve, rhs)
        A = self.operators[level]
        smoother = self.smoothers[level - 1]
        x = t.run(level, "pre smooth", smoother.vmult, rhs)
        r = t.run(level, "residual", lambda: rhs - A(x))
        rc = t.run(level, "restrict", self.transfers[level - 1].restrict, r)
        xc = self._v_step(level - 1, rc)
        x = t.run(level, "prolongate",
                  lambda: x + self.transfers[level - 1].prolongate(xc))
        if not self.one_sided:
            x = t.run(level, "post smooth", smoother.step, x, rhs)
        return x

    def vmult(self, src):
        if self.timer.enabled:
            return self._v_step(self.n_levels - 1, src)
        if self._jitted is None:
            import jax

            from ..utils.jitutils import jit_hoist_consts

            # hoist level tables to runtime parameters: captured constants
            # would be embedded in the executable at O(n_dofs) sizes
            self._jitted = jit_hoist_consts(
                self._vmult_whole, jax.ShapeDtypeStruct(src.shape, src.dtype))
        return self._jitted(src)

    def __call__(self, src):
        return self.vmult(src)
