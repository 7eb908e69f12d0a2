"""Micro-benchmark: deformed-geometry (Kershaw) Q4 vmult vs Cartesian (f32).

VERDICT #9: bring Kershaw Q4 vmult within 2x of the Cartesian path
(reference merged q-point path: /root/reference/include/operator.h:1162-1219).
Compares, at Q4 48^3 cells (~7.2M DoF, q-grid 240^3):
  - Cartesian separable apply (the fast-path yardstick, same DoF count),
  - merged dense path (global E-matmuls, coeff6 as jit args — captured
    constants overflow the remote-compile request at this size),
  - merged windowed path (small shared transforms),
  - construct-q / compact variants where available.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timeit(op, x0, label, n_rep=10, n_best=3):
    import jax

    extra = tuple(getattr(op, "_coeff_args", ()) or ())

    @jax.jit
    def many(x, *c6):
        for _ in range(n_rep):
            x = op._vmult_impl(x, c6)
        return x

    t0 = time.perf_counter()
    try:
        y = many(x0, *extra)
        _ = float(y.reshape(-1)[0])
    except Exception as e:
        print(f"[{label}] FAILED: {type(e).__name__}: {str(e)[:200]}",
              flush=True)
        return None
    print(f"[{label}] compile+run {time.perf_counter() - t0:.1f}s", flush=True)
    best = float("inf")
    for _ in range(n_best):
        t0 = time.perf_counter()
        y = many(x0, *extra)
        _ = float(y.reshape(-1)[0])
        best = min(best, (time.perf_counter() - t0) / n_rep)
    print(f"[{label}] {best * 1e3:8.2f} ms", flush=True)
    return best


def main():
    import jax

    from dealii_asm.utils.jitutils import enable_compilation_cache

    enable_compilation_cache()
    import jax.numpy as jnp

    from dealii_asm.fem.dofs import DofHandler
    from dealii_asm.mesh.grid import StructuredMesh
    from dealii_asm.mesh.transforms import kershaw_transform
    from dealii_asm.ops.laplace import LaplaceOperator

    cells = int(os.environ.get("CELLS", 48))
    degree = 4
    tf = kershaw_transform(0.3, 0.3)

    t0 = time.perf_counter()
    mesh_c = StructuredMesh(3, (cells,) * 3)
    dofs_c = DofHandler(mesh_c, degree)
    op_c = LaplaceOperator(dofs_c, dtype=jnp.float32)
    print(f"setup cartesian {time.perf_counter() - t0:.0f}s "
          f"({dofs_c.n_dofs/1e6:.1f}M DoF)", flush=True)

    t0 = time.perf_counter()
    mesh_k = StructuredMesh(3, (cells,) * 3, transform=tf)
    dofs_k = DofHandler(mesh_k, degree)
    op_k = LaplaceOperator(dofs_k, dtype=jnp.float32)
    print(f"setup kershaw merged {time.perf_counter() - t0:.0f}s", flush=True)

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(dofs_c.n_dofs), jnp.float32)

    t_c = timeit(op_c, x, "cartesian separable f32")
    t_m = timeit(op_k, x, "kershaw merged dense f32")

    # windowed variant (force it through the banded branch)
    op_kw = LaplaceOperator(dofs_k, dtype=jnp.float32, kernel="banded")
    t_w = timeit(op_kw, x, "kershaw merged windowed f32")
    del op_kw

    for mt in ("linear geometry", "quadratic geometry"):
        try:
            geo = None
            op_v = LaplaceOperator(dofs_k, dtype=jnp.float32, mapping_type=mt)
            timeit(op_v, x, f"kershaw {mt} f32")
            del op_v
        except Exception as e:
            print(f"[{mt}] unavailable: {type(e).__name__}: {str(e)[:150]}",
                  flush=True)

    if t_m and t_c:
        print(f"ratio merged/cartesian:   {t_m / t_c:.2f}x", flush=True)
    if t_w and t_c:
        print(f"ratio windowed/cartesian: {t_w / t_c:.2f}x", flush=True)


if __name__ == "__main__":
    main()
