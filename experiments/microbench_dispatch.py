"""Separate per-dispatch overhead from true per-step cost (slope/intercept)."""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp

    from dealii_asm.fem.dofs import DofHandler
    from dealii_asm.mesh.grid import StructuredMesh
    from dealii_asm.ops.laplace import LaplaceOperator
    from dealii_asm.precond.asm import ASMPreconditioner

    dtype = jnp.float32
    mesh = StructuredMesh(3, (64,) * 3)
    dofs = DofHandler(mesh, 4)
    n = dofs.n_dofs
    op = LaplaceOperator(dofs, dtype=dtype)
    asm = ASMPreconditioner(dofs, n_overlap=1, weighting_type="symm", dtype=dtype)

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(n), dtype)
    b = jnp.asarray(rng.standard_normal(n), dtype)

    def step(x):
        r = b - op.vmult_traceable(x)
        return x + asm.vmult_traceable(r)

    times = {}
    for k in (1, 2, 8):
        @jax.jit
        def many(x, k=k):
            for _ in range(k):
                x = step(x)
            return x

        y = many(x)
        y.block_until_ready()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(5):
                y = many(y)
            y.block_until_ready()
            best = min(best, (time.perf_counter() - t0) / 5)
        times[k] = best
        print(f"k={k:3d}: {best * 1e3:9.3f} ms total, {best / k * 1e3:8.3f} ms/step",
              flush=True)

    slope = (times[8] - times[2]) / 6
    icept = times[2] - 2 * slope
    print(f"true per-step: {slope * 1e3:.3f} ms  ({n / slope / 1e9:.2f} GDoF/s); "
          f"dispatch overhead ≈ {icept * 1e3:.3f} ms", flush=True)

    # same for a pure elementwise op (bandwidth reference)
    g = x.reshape(257, 257, 257)
    for k in (1, 8):
        @jax.jit
        def ew(t, k=k):
            for _ in range(k):
                t = t * 1.000001 + 0.5
            return t

        y = ew(g); y.block_until_ready()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(5):
                y = ew(y)
            y.block_until_ready()
            best = min(best, (time.perf_counter() - t0) / 5)
        print(f"elementwise k={k:3d}: {best * 1e3:9.3f} ms", flush=True)
        times[f"ew{k}"] = best
    s = (times["ew8"] - times["ew1"]) / 7
    print(f"elementwise true: {s * 1e3:.3f} ms -> {2 * n * 4 / s / 1e9:.0f} GB/s",
          flush=True)


if __name__ == "__main__":
    main()
