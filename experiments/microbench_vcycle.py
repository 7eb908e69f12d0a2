"""Micro-benchmark: V-cycle anatomy at the 17M-DoF headline configuration.

The e2e solve is 0.358 s = 5 CG its x (25 ms dd vmult + 7 ms vector ops
+ ~38 ms V-cycle): this times the V-cycle whole and per fine-level stage to
find where those 38 ms go (smoothers are fused Pallas steps at 4.1 ms)."""

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
    print(f"setup {time.perf_counter() - t0:.0f}s levels={mg.n_levels}",
          flush=True)

    rng = np.random.default_rng(0)
    r64 = jnp.asarray(rng.standard_normal(dofs.n_dofs))
    r32 = r64.astype(jnp.float32)

    def timeit(fn, x0, label, n_rep=10):
        @jax.jit
        def many(x):
            for _ in range(n_rep):
                x = 0.5 * x + 0.5 * fn(x)  # keep shapes, prevent hoisting
            return x

        t0 = time.perf_counter()
        y = many(x0)
        _ = float(y.reshape(-1)[0])
        print(f"[{label}] compile+run {time.perf_counter() - t0:.1f}s",
              flush=True)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            y = many(x0)
            _ = float(y.reshape(-1)[0])
            best = min(best, (time.perf_counter() - t0) / n_rep)
        print(f"[{label}] {best * 1e3:8.2f} ms", flush=True)
        return best

    # whole V-cycle (as the CG preconditioner application, f32-in/out)
    timeit(mg._vmult_whole, r32, "V-cycle whole (f32)")

    # adapter round-trip as CG sees it: f64 -> f32 cycle -> f64
    timeit(lambda x: mg._vmult_whole(x.astype(jnp.float32)).astype(
        jnp.float64), r64, "V-cycle + dtype casts (f64 io)")

    L = mg.n_levels - 1
    sm = mg.smoothers[L - 1]
    A = mg.operators[L]
    T = mg.transfers[L - 1]
    timeit(sm.vmult, r32, "fine pre-smooth (Cheby1 vmult)")
    timeit(lambda x: sm.step(x, r32), r32, "fine post-smooth (step)")
    timeit(A, r32, "fine residual vmult (f32)")
    timeit(lambda x: T.prolongate(T.restrict(x)), r32,
           "fine restrict+prolongate round trip")


if __name__ == "__main__":
    main()
