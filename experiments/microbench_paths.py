"""Micro-benchmark: compare flagship-kernel path variants on the real chip.

Times each compute path of the Q4/64^3 fused smoother step (vmult + FDM ov1
apply) in isolation, prints one line per variant.  Informs which path the
production dispatch should pick per (problem size, dtype) — cf. the reference's
label-grammar sweeps (/root/reference/matrix_free_loop_08.likwid.cc).
"""

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
    print(f"n_dofs = {n:,}  ({cells}^3 cells, Q{degree})")

    op = LaplaceOperator(dofs, dtype=dtype)
    asm = ASMPreconditioner(dofs, n_overlap=1, weighting_type="symm", dtype=dtype)

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(n), dtype)
    b = jnp.asarray(rng.standard_normal(n), dtype)

    results = {}

    # -- vmult variants --------------------------------------------------------
    # 1. global dense separable (current default)
    f = jax.jit(op._vmult_impl)
    results["vmult/global-dense"] = timeit(f, x, label="vmult/global-dense")

    # 2. windowed separable (percoord window layout, shared small mats)
    from dealii_asm.ops.lattice import (
        apply_axis_shared,
        cells_to_grid_sliced,
        grid_to_cells_sliced,
        grid_to_windows,
        windows_to_grid,
    )

    def vmult_windows(u):
        w = grid_to_windows(u.reshape(op.grid_shape), mesh.n_cells, degree,
                            degree + 1, 1, mesh.periodic)
        v = op._cartesian_separable(w)
        return windows_to_grid(v, op.grid_shape, degree, 1,
                               mesh.periodic).reshape(-1)

    results["vmult/windows"] = timeit(jax.jit(vmult_windows), x, label="vmult/windows")

    # 3. dense local GEMM (A_loc, (L,L) @ (L,C))
    def vmult_gemm(u):
        W = grid_to_cells_sliced(u.reshape(op.grid_shape), mesh.n_cells, degree,
                                 degree + 1, 1, mesh.periodic)  # (L, C)
        V = op.A_loc @ W
        return cells_to_grid_sliced(V, op.grid_shape, mesh.n_cells, degree,
                                    degree + 1, 1, mesh.periodic).reshape(-1)

    results["vmult/local-gemm"] = timeit(jax.jit(vmult_gemm), x, label="vmult/local-gemm")

    # -- FDM variants ----------------------------------------------------------
    results["fdm/global-dense"] = timeit(jax.jit(asm._vmult_global_fdm), x, label="fdm/global-dense")

    def fdm_windows(u):
        w = grid_to_windows(u.reshape(op.grid_shape), mesh.n_cells, degree,
                            asm.m, 1, mesh.periodic)
        y = asm._fdm_apply_percoord(w)
        return windows_to_grid(y, op.grid_shape, degree, 1,
                               mesh.periodic).reshape(-1)

    results["fdm/windows"] = timeit(jax.jit(fdm_windows), x, label="fdm/windows")

    if asm.dense is not None:
        P_base, groups = asm.dense
        print(f"dense combos: 1 base + {len(groups)} fixups")

        def fdm_gemm(u):
            W = grid_to_cells_sliced(u.reshape(op.grid_shape), mesh.n_cells,
                                     degree, asm.m, 1, mesh.periodic)
            y = P_base @ W
            for cols, P_u in groups:
                y = y.at[:, cols].set(P_u @ W[:, cols])
            return cells_to_grid_sliced(y, op.grid_shape, mesh.n_cells, degree,
                                        asm.m, 1, mesh.periodic).reshape(-1)

        results["fdm/local-gemm"] = timeit(jax.jit(fdm_gemm), x, label="fdm/local-gemm")

    # -- fused step (current default path mix) ----------------------------------
    def fused(x, b):
        r = b - op.vmult_traceable(x)
        return x + asm.vmult_traceable(r)

    results["fused/default"] = timeit(jax.jit(fused), x, b, label="fused/default")

    for k, v in sorted(results.items()):  # noqa
        gd = n / v / 1e9
        print(f"{k:24s} {v * 1e3:8.3f} ms   {gd:7.2f} GDoF/s")


if __name__ == "__main__":
    main()
