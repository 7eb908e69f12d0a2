"""Measure bf16-operand variants of the flagship dense-global paths."""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timeit(fn, *args, n_rep=10, n_best=2, label=""):
    t0 = time.perf_counter()
    y = fn(*args)
    _ = np.asarray(y.block_until_ready() if hasattr(y, "block_until_ready") else y)
    print(f"[{label}] compiled in {time.perf_counter() - t0:.1f}s", flush=True)
    best = float("inf")
    for _ in range(n_best):
        t0 = time.perf_counter()
        for _ in range(n_rep):
            y = fn(*args)
        y.block_until_ready()
        best = min(best, (time.perf_counter() - t0) / n_rep)
    print(f"[{label}] {best * 1e3:8.3f} ms", flush=True)
    return best


def main():
    import jax
    import jax.numpy as jnp

    from dealii_asm.fem.dofs import DofHandler
    from dealii_asm.mesh.grid import StructuredMesh
    from dealii_asm.ops.laplace import LaplaceOperator
    from dealii_asm.precond.asm import ASMPreconditioner

    dtype = jnp.float32
    cells = 64
    degree = 4
    mesh = StructuredMesh(3, (cells,) * 3)
    dofs = DofHandler(mesh, degree)
    n = dofs.n_dofs
    print(f"n_dofs = {n:,}")

    op = LaplaceOperator(dofs, dtype=dtype)
    asm = ASMPreconditioner(dofs, n_overlap=1, weighting_type="symm", dtype=dtype)

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(n), dtype)
    b = jnp.asarray(rng.standard_normal(n), dtype)

    def fused(x, b):
        r = b - op.vmult_traceable(x)
        return x + asm.vmult_traceable(r)

    t_f32 = timeit(jax.jit(fused), x, b, label="fused/f32")
    ref = np.asarray(jax.jit(fused)(x, b))

    # bf16 variant: same algebra, matmul OPERANDS cast to bf16, f32 accumulate
    def axmm_bf16(T, M, grid_axis):
        dim = T.ndim
        letters = "zyxw"[:dim]
        it = letters[grid_axis]
        out = letters.replace(it, "o")
        return jnp.einsum(f"o{it},{letters}->{out}",
                          M.astype(jnp.bfloat16), T.astype(jnp.bfloat16),
                          preferred_element_type=jnp.float32)

    import dealii_asm.ops.tensorops as tops

    orig = tops.axis_matmul
    tops.axis_matmul = axmm_bf16
    try:
        f = jax.jit(fused)
        t_bf16 = timeit(f, x, b, label="fused/bf16")
        out = np.asarray(f(x, b))
    finally:
        tops.axis_matmul = orig
    rel = np.linalg.norm(out - ref) / np.linalg.norm(ref)
    print(f"bf16 rel error vs f32: {rel:.3e}")
    print(f"speedup: {t_f32 / t_bf16:.2f}x   "
          f"{n / t_bf16 / 1e9:.2f} GDoF/s (bf16) vs {n / t_f32 / 1e9:.2f} (f32)")

    # split-bf16 variant: M = M_hi + M_lo with M_hi = bf16(M); two bf16 matmuls
    # recover ~f32 operand precision on the small matrices (error ~2^-16)
    def axmm_split(T, M, grid_axis):
        dim = T.ndim
        letters = "zyxw"[:dim]
        it = letters[grid_axis]
        out = letters.replace(it, "o")
        Tb = T.astype(jnp.bfloat16)
        M_hi = M.astype(jnp.bfloat16)
        M_lo = (M - M_hi.astype(M.dtype)).astype(jnp.bfloat16)
        hi = jnp.einsum(f"o{it},{letters}->{out}", M_hi, Tb,
                        preferred_element_type=jnp.float32)
        lo = jnp.einsum(f"o{it},{letters}->{out}", M_lo, Tb,
                        preferred_element_type=jnp.float32)
        return hi + lo

    tops.axis_matmul = axmm_split
    try:
        f = jax.jit(fused)
        t_split = timeit(f, x, b, label="fused/bf16-split")
        out = np.asarray(f(x, b))
    finally:
        tops.axis_matmul = orig
    rel = np.linalg.norm(out - ref) / np.linalg.norm(ref)
    print(f"bf16-split rel error vs f32: {rel:.3e}")
    print(f"{n / t_split / 1e9:.2f} GDoF/s (split)")


if __name__ == "__main__":
    main()
