"""Mixed-precision iterative refinement.

The reference solves with a double outer Krylov over float MG levels (P8 in
SURVEY.md §2d).  Iterative refinement moves almost all of the outer work to
f32 as well:

    r₀ = b − A x          (float64: one accurate residual)
    repeat: solve A e = r in float32 (MG-preconditioned CG, to its ~1e-4
            attainable floor), x ← x + e and r ← b − A x in float64

Each cycle multiplies the true residual by the inner reduction (~1e-4), so two
to three f64 residual evaluations reach 1e-5..1e-12 — versus one f64 vmult and
five f64 reductions per iteration for the all-f64 CG.

CONVERGENCE LIMIT (measured, 17M-DoF Q4): refinement contracts only while
κ(A)·relerr(A32) < 1.  The f32 operator's error on smooth modes is the
cancellation floor eps32/h² (inherent to assembled FEM in single precision —
the cell-local and global-separable forms measure identical, and the reference
has the same property in its float operators, which is exactly why its outer
Krylov runs in double).  At 64³ cells/Q4, κ·relerr ≳ 1 and the true residual
stalls around 4e-4 relative.  refined_solve detects the stall and stops; the
driver's "auto" policy therefore uses refinement only below a conditioning
threshold and otherwise runs the reference architecture (f64 outer Krylov,
f32 MG preconditioner — models/poisson.py).

Requires JAX_ENABLE_X64 (f64 emulation available); degrades gracefully to a
plain f32 restarted solve otherwise.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .krylov import ReductionControl, SolveResult, _norm, cg


def refined_solve(A64, A32, b, M32, rel_tolerance=1e-5, abs_tolerance=1e-10,
                  inner_reduction=3e-4, max_outer=6, max_inner=25,
                  inner_solver=cg, log=lambda *_: None) -> SolveResult:
    """Solve A x = b with f64 residuals and f32 inner MG-CG solves.

    A64/A32: vmult callables in each precision; M32: f32 preconditioner vmult.
    Returns a SolveResult whose n_iterations counts INNER iterations (the
    comparable cost unit); .outer_cycles records refinement cycles.
    """
    b64 = b.astype(jnp.float64)
    r = b64
    x = jnp.zeros_like(b64)
    r0 = _norm(r)
    target = max(abs_tolerance, rel_tolerance * r0)
    total_inner = 0
    outer = 0
    history = [r0]
    res = r0
    while res > target and outer < max_outer:
        scale = res  # work on the scaled correction to stay in f32 range
        rhs32 = (r / scale).astype(jnp.float32)
        inner_ctrl = ReductionControl(max_inner, 1e-30, inner_reduction)
        inner = inner_solver(A32, rhs32, M=M32, control=inner_ctrl)
        total_inner += inner.n_iterations
        e = inner.x.astype(jnp.float64) * scale
        x = x + e
        r = b64 - A64(x)
        res = _norm(r)
        history.append(res)
        outer += 1
        log(f"   - refinement cycle {outer}: true residual {res:.3e} "
            f"({inner.n_iterations} inner its)")
        if res > 0.5 * history[-2]:
            # stall: κ(A)·relerr(A32) ≥ 1 — corrections solve the wrong
            # system; further cycles cannot contract (see module docstring)
            log("   - refinement stalled (f32 operator accuracy floor);"
                " aborting")
            break
    result = SolveResult(x, total_inner, res <= target, history)
    result.outer_cycles = outer
    return result
