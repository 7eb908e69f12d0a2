"""Smoother-composition and access-variant timing studies.

JAX rebuild of the reference's variant benchmarks:
- /root/reference/matrix_free_loop_02.cc: smoother composition sweep —
  {FDM, diagonal} local solver x {Chebyshev, relaxation ω=1.0, ω=1.1} x
  {vmult, step}; fused-vs-unfused pre/post becomes "one jitted program vs
  per-op dispatch" here (P5: XLA fuses vector ops inside one jit);
- /root/reference/matrix_free_loop_03.cc: gather/communication variants
  (mf_normal / own_communication / own_gather / own_gather_and_copy) —
  the analogs here are the smoother's ACCESS PATHS: the folded global-
  transform algebra ("global"), the index-table gather fallback ("gather")
  and the lane-major per-cell path ("lanes").

Output: the `>> label n_dofs n_rep time bytes degree 0 0` protocol
(matrix_free_loop_08.likwid.cc:390-395 format), DoF/s = n_dofs·n_rep/time.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def _time_chain(fn, x, n_rep, extra=None):
    import jax

    @jax.jit
    def many(y):
        for _ in range(n_rep):
            y = fn(y)
        return y

    y = jax.block_until_ready(many(x))
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        y = jax.block_until_ready(many(y))
        best = min(best, time.perf_counter() - t0)
    return best


def run_composition_bench(params: dict, out=sys.stdout):
    """matrix_free_loop_02 analog: smoother-composition sweep."""
    import jax.numpy as jnp

    from ..fem.dofs import DofHandler
    from ..mesh.grid import StructuredMesh
    from ..ops.laplace import LaplaceOperator
    from ..precond.asm import ASMPreconditioner
    from ..precond.diagonal import DiagonalPreconditioner
    from ..solvers.chebyshev import (
        ChebyshevPreconditioner,
        EigenvalueInfo,
        RelaxationPreconditioner,
    )

    dim = int(params.get("dim", 3))
    degree = int(params.get("degree", 4))
    s = int(params.get("n subdivisions", 16))
    n_rep = int(params.get("n repetitions", 10))
    dtype = jnp.float32

    mesh = StructuredMesh(dim, (s,) * dim)
    dofs = DofHandler(mesh, degree)
    op = LaplaceOperator(dofs, dtype=dtype)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(dofs.n_dofs), dtype)
    b = jnp.asarray(rng.standard_normal(dofs.n_dofs), dtype)

    inners = {
        "fdm": ASMPreconditioner(dofs, n_overlap=1, weighting_type="symm",
                                 dtype=dtype),
        "diag": DiagonalPreconditioner(op),
    }
    ev = EigenvalueInfo(1.2, 2.2, 0)

    for iname, inner in inners.items():
        wrappers = {
            "cheby-2": ChebyshevPreconditioner(
                op.vmult_traceable, inner.vmult_traceable
                if hasattr(inner, "vmult_traceable") else inner.vmult,
                dofs.n_dofs, degree=2, eigenvalues=ev),
            "relax-1.0": RelaxationPreconditioner(
                op.vmult_traceable, inner.vmult_traceable
                if hasattr(inner, "vmult_traceable") else inner.vmult,
                dofs.n_dofs, n_iterations=2, omega=1.0),
            "relax-1.1": RelaxationPreconditioner(
                op.vmult_traceable, inner.vmult_traceable
                if hasattr(inner, "vmult_traceable") else inner.vmult,
                dofs.n_dofs, n_iterations=2, omega=1.1),
        }
        for wname, w in wrappers.items():
            for mode in ("vmult", "step"):
                if mode == "vmult":
                    fn = lambda y, w=w: w.vmult(y)
                else:
                    fn = lambda y, w=w: w.step(y, b)
                dt = _time_chain(fn, x, n_rep)
                label = f"{iname}-{wname}-{mode}"
                print(f">> {label} {dofs.n_dofs} {n_rep} {dt:.6g} "
                      f"{jnp.dtype(dtype).itemsize} {degree} 0 0",
                      file=out, flush=True)
    return dofs.n_dofs


def run_access_bench(params: dict, out=sys.stdout):
    """matrix_free_loop_03 analog: smoother access-path variants."""
    import jax.numpy as jnp

    from ..fem.dofs import DofHandler
    from ..mesh.grid import StructuredMesh
    from ..ops.laplace import LaplaceOperator
    from ..precond.asm import ASMPreconditioner

    dim = int(params.get("dim", 3))
    degree = int(params.get("degree", 4))
    s = int(params.get("n subdivisions", 16))
    n_rep = int(params.get("n repetitions", 10))
    n_overlap = int(params.get("n overlap", 1))
    dtype = jnp.float32

    mesh = StructuredMesh(dim, (s,) * dim)
    dofs = DofHandler(mesh, degree)
    op = LaplaceOperator(dofs, dtype=dtype)
    asm = ASMPreconditioner(dofs, n_overlap=n_overlap, weighting_type="symm",
                            dtype=dtype)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(dofs.n_dofs), dtype)
    b = jnp.asarray(rng.standard_normal(dofs.n_dofs), dtype)

    variants = {}
    variants["global"] = lambda y: y + asm.vmult_traceable(
        b - op.vmult_traceable(y))

    gather = ASMPreconditioner(dofs, n_overlap=n_overlap,
                               weighting_type="symm", dtype=dtype)
    gather.access = "gather"
    gather.global_fdm = None
    gather.dense = None
    variants["gather"] = lambda y: y + gather.vmult_traceable(
        b - op.vmult_traceable(y))

    # lane-major per-cell path (what deformed/non-factoring meshes run)
    lanes = ASMPreconditioner(dofs, n_overlap=n_overlap,
                              weighting_type="symm", dtype=dtype)
    lanes.global_fdm = None
    lanes.dense = None
    lanes._build_lanes()
    variants["lanes"] = lambda y: y + lanes.vmult_traceable(
        b - op.vmult_traceable(y))

    for label, fn in variants.items():
        dt = _time_chain(fn, x, n_rep)
        print(f">> {label} {dofs.n_dofs} {n_rep} {dt:.6g} "
              f"{jnp.dtype(dtype).itemsize} {degree} 0 0", file=out,
              flush=True)
    return dofs.n_dofs


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    which = argv[0] if argv else "access"
    params = {}
    if len(argv) > 1:
        with open(argv[1]) as f:
            params = json.load(f)
    if which == "composition":
        run_composition_bench(params)
    else:
        run_access_bench(params)
    return 0


if __name__ == "__main__":
    sys.exit(main())
