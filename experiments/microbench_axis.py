"""Per-axis matmul timing on the 257^3 grid — find the layout bottleneck."""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timeit(fn, *args, n_rep=20, n_best=2, label=""):
    t0 = time.perf_counter()
    y = fn(*args)
    y.block_until_ready()
    print(f"[{label}] compiled {time.perf_counter() - t0:.1f}s", flush=True)
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

    N = 257
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal((N, N, N)), jnp.float32)
    M = jnp.asarray(rng.standard_normal((N, N)), jnp.float32)
    G = jnp.asarray(rng.standard_normal((320, N)), jnp.float32)

    from dealii_asm.ops.tensorops import axis_matmul

    bytes_grid = N**3 * 4 / 1e9

    for ax, name in ((0, "z-major"), (1, "y-mid"), (2, "x-minor")):
        t = timeit(jax.jit(lambda T, ax=ax: axis_matmul(T, M, ax)), u,
                   label=f"axismm/{name}")
        print(f"   -> {2 * bytes_grid / t:.0f} GB/s eff, "
              f"{2 * N * N**3 / t / 1e12:.1f} TFLOP/s", flush=True)

    # matmul-shaped reference: (N², N) @ (N, N), minor-dim contraction
    u2 = u.reshape(N * N, N)
    t = timeit(jax.jit(lambda A: A @ M.T), u2, label="ref/(N²,N)@(N,N)")
    print(f"   -> {2 * N * N**3 / t / 1e12:.1f} TFLOP/s", flush=True)

    # f64-style: highest precision matmul for comparison
    t = timeit(jax.jit(lambda A: jax.lax.dot(A, M.T,
               precision=jax.lax.Precision.HIGHEST)), u2, label="ref/highest")
    print(f"   -> {2 * N * N**3 / t / 1e12:.1f} TFLOP/s (x3 passes)", flush=True)

    # elementwise pass for bandwidth reference
    t = timeit(jax.jit(lambda T: T * 2.0 + 1.0), u, label="ref/elementwise")
    print(f"   -> {2 * bytes_grid / t:.0f} GB/s", flush=True)

    # FDM-shaped G application along each axis
    for ax, name in ((0, "z"), (1, "y"), (2, "x")):
        t = timeit(jax.jit(lambda T, ax=ax: axis_matmul(T, G, ax)), u,
                   label=f"fdmmm/{name}")
        print(f"   -> {2 * 320 * N * (N * N) / t / 1e12:.1f} TFLOP/s", flush=True)


if __name__ == "__main__":
    main()
