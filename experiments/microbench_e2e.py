"""Micro-benchmark: end-to-end anatomy of the 17M-DoF headline solve.

Times each piece of the reference headline configuration (aniso Q4 64^3,
h-MG Chebyshev(1)+FDM-symm, CG rel 1e-5, f64 outer / f32 levels):
  - the f64 outer vmult: double-single (dd) vs emulated-f64 banded,
  - the f32 MG V-cycle behind the PrecisionAdapter,
  - one full CG iteration worth of vector ops,
  - the whole solve (the driver's number).
Informs which piece to attack next (BASELINE.md: reference node = 0.237 s).
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timeit(fn, label, n_rep=10, n_best=3):
    import jax

    @jax.jit
    def many(x):
        for _ in range(n_rep):
            x = fn(x)
        return x

    t0 = time.perf_counter()
    y = many_in = None
    y = many(_X0)
    _ = float(y.reshape(-1)[0])
    print(f"[{label}] compile+run {time.perf_counter() - t0:.1f}s", flush=True)
    best = float("inf")
    for _ in range(n_best):
        t0 = time.perf_counter()
        y = many(_X0)
        _ = float(y.reshape(-1)[0])
        best = min(best, (time.perf_counter() - t0) / n_rep)
    print(f"[{label}] {best * 1e3:8.2f} ms", flush=True)
    return best


def main():
    import jax

    from dealii_asm.utils.jitutils import enable_compilation_cache

    enable_compilation_cache()
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from dealii_asm.models.poisson import run_config

    cfg = {
        "type": "matrixfree", "dim": 3, "degree": 4, "n refinements": 6,
        "print timing": True,
        "solver": {"type": "CG", "rel tolerance": 1e-05, "best of": 3},
        "mesh": {"name": "anisotropy", "stratch": 1},
        "preconditioner": {
            "type": "Multigrid", "mg type": "h",
            "mg number type": "float32",
            "mg smoother": {
                "type": "Chebyshev", "degree": 1,
                "polynomial type": "1st kind",
                "preconditioner": {"type": "FDM", "n overlap": 1,
                                   "weighting type": "symm"}},
            "mg coarse grid solver": {"type": "AMG"}},
    }

    # piecewise anatomy first (shares nothing with run_config: own objects)
    from dealii_asm.fem.dofs import DofHandler
    from dealii_asm.mesh.grid import StructuredMesh
    from dealii_asm.ops.laplace import LaplaceOperator

    t0 = time.perf_counter()
    mesh = StructuredMesh(3, (64,) * 3)
    dofs = DofHandler(mesh, 4)
    op64 = LaplaceOperator(dofs, dtype=jnp.float64)            # dd default
    op64b = LaplaceOperator(dofs, dtype=jnp.float64, kernel="banded")
    print(f"setup ops {time.perf_counter() - t0:.0f}s", flush=True)

    global _X0
    rng = np.random.default_rng(0)
    _X0 = jnp.asarray(rng.standard_normal(dofs.n_dofs))

    timeit(op64.vmult_traceable, "f64 vmult (dd)")
    timeit(op64b.vmult_traceable, "f64 vmult (emulated banded)")

    from dealii_asm.solvers.krylov import _dot_twostage

    def cg_vecops(x):  # one CG iteration's vector work minus vmult/precond
        Ap = x
        pAp = _dot_twostage(x, Ap)
        al = (1.0 / pAp).astype(x.dtype)
        xn = x + al * x
        rn = x - al * Ap
        resn = jnp.sqrt(_dot_twostage(rn, rn))
        return xn + resn.astype(x.dtype) * rn

    timeit(cg_vecops, "CG vector ops + 2 dots (f64)")

    # whole driver config (includes V-cycle timing via print timing)
    print("--- run_config (driver) ---", flush=True)
    out = run_config(cfg)
    print(f"it={out['it']}", flush=True)


if __name__ == "__main__":
    main()
