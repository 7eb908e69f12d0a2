"""Micro-benchmark: one full CG iteration body at the 17M-DoF headline config.

The driver solve is 0.339 s / 5 it = 67.8 ms/it, but the measured pieces
(dd vmult 24.8 + V-cycle 19.2 + vector ops 6.65) only sum to ~51 ms.  This
times the exact CG body (krylov._cg_device semantics) and its pieces within
one jit to find the remainder (suspects: f64 constraint masking inside
op.vmult, the f64 hist/scalar chain, adapter casts, XLA scheduling).
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    from dealii_asm.utils.jitutils import enable_compilation_cache

    enable_compilation_cache()
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from dealii_asm.models.poisson import (
        _build_multigrid, _make_dofs, _make_operator, make_mesh_family,
    )
    from dealii_asm.precond.adapter import PrecisionAdapter
    from dealii_asm.solvers.krylov import _dot_twostage

    params = {
        "type": "matrixfree", "dim": 3, "degree": 4, "n refinements": 6,
        "mesh": {"name": "anisotropy", "stratch": 1},
    }
    quiet = lambda *a, **k: None
    family = make_mesh_family(params, quiet)
    dofs = _make_dofs(family, family.fine_mesh, 4)
    op = _make_operator(family, dofs, jnp.float64, "")
    precon_p = {
        "type": "Multigrid", "mg type": "h",
        "mg smoother": {"type": "Chebyshev", "degree": 1,
                        "polynomial type": "1st kind",
                        "preconditioner": {"type": "FDM", "n overlap": 1,
                                           "weighting type": "symm"}},
        "mg coarse grid solver": {"type": "AMG"},
    }
    t0 = time.perf_counter()
    mg = _build_multigrid(precon_p, family, 4, op, quiet, jnp.float32)
    adapter = PrecisionAdapter(mg, jnp.float32)
    print(f"setup {time.perf_counter() - t0:.0f}s", flush=True)

    rng = np.random.default_rng(0)
    r64 = jnp.asarray(rng.standard_normal(dofs.n_dofs))

    def dot(a, c):
        return _dot_twostage(a, c)

    def cg_body(x, r, p, rz):
        Ap = op.vmult(p)
        pAp = dot(p, Ap)
        al = (rz / pAp).astype(x.dtype)
        xn = x + al * p
        rn = r - al * Ap
        resn = jnp.sqrt(dot(rn, rn))
        z = adapter.vmult(rn)
        rzn = dot(rn, z)
        beta = (rzn / rz).astype(z.dtype)
        pn = z + beta * p
        return xn, rn, pn, rzn + 0 * resn

    def timeit(fn, args, label, n_rep=8):
        @jax.jit
        def many(*a):
            for _ in range(n_rep):
                a = fn(*a)
            return a

        t0 = time.perf_counter()
        y = many(*args)
        _ = float(y[0].reshape(-1)[0])
        print(f"[{label}] compile+run {time.perf_counter() - t0:.1f}s",
              flush=True)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            y = many(*args)
            _ = float(y[0].reshape(-1)[0])
            best = min(best, (time.perf_counter() - t0) / n_rep)
        print(f"[{label}] {best * 1e3:8.2f} ms", flush=True)
        return best

    # pieces
    timeit(lambda x: (op.vmult(x),), (r64,), "op.vmult f64 (full, w/ masking)")
    timeit(lambda x: (adapter.vmult(x),), (r64,), "adapter.vmult (casts + V-cycle)")
    timeit(lambda x: (x + 0.5 * x * jnp.sqrt(dot(x, x)),), (r64,),
           "axpy + two-stage dot (f64)")
    # whole body
    timeit(cg_body, (r64, r64, r64, jnp.float64(1.0)), "full CG body")


if __name__ == "__main__":
    main()
