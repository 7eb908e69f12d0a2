"""Cross-kernel cache-reuse study — power_kernel_01 analog.

The reference (/root/reference/power_kernel_01.likwid.cc) fuses a vmult with a
follow-up cell pass when vertex-touch dependency tracking allows, comparing
variants power-own / power-batch / sequential.  Under XLA the equivalent question
is whether XLA fuses two dependent grid sweeps inside one jit versus
dispatching them separately; this driver measures

    sequential : two jitted programs, dst = A·(A·u) with a host round-trip
    fused      : one jitted program computing A·(A·u)
    fused-axpy : one jitted program computing A·(A·u) + α·u (vector op fused in)

and prints the reference's '>>' protocol lines.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def run_power_kernel(params: dict, out=sys.stdout):
    import jax
    import jax.numpy as jnp

    from ..fem.dofs import DofHandler
    from ..mesh.balanced import balanced_hyper_cube_subdivisions
    from ..mesh.grid import StructuredMesh
    from ..ops.laplace import LaplaceOperator
    from ..utils.config import get_param

    dim = int(get_param(params, "dim", 3))
    s = int(get_param(params, "n subdivision", 6))
    degree = int(get_param(params, "fe degree", 4))
    n_rep = int(get_param(params, "n repetitions", 10))
    cells, lengths = balanced_hyper_cube_subdivisions(dim, s)
    mesh = StructuredMesh(dim, tuple(cells), lengths=tuple(lengths),
                          periodic=(True,) * dim)
    dofs = DofHandler(mesh, degree)
    op = LaplaceOperator(dofs, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal(dofs.n_dofs), jnp.float32)

    fused = jax.jit(lambda v: op.vmult_traceable(op.vmult_traceable(v)))
    fused_axpy = jax.jit(
        lambda v: op.vmult_traceable(op.vmult_traceable(v)) + 0.5 * v)

    def sequential(v):
        return op.vmult(op.vmult(v))

    for label, fn in (("sequential", sequential), ("power-own", fused),
                      ("power-own-axpy", fused_axpy)):
        y = fn(u)
        _ = float(jnp.asarray(y).ravel()[0])
        t0 = time.perf_counter()
        y = u
        for _ in range(n_rep):
            y = fn(y)
        _ = float(jnp.asarray(y).ravel()[0])
        dt = time.perf_counter() - t0
        print(f">> {label} {dofs.n_dofs} {2 * n_rep} {dt:.6g} 4 {degree} 0 0",
              file=out, flush=True)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    for path in argv or [None]:
        params = {}
        if path:
            with open(path) as f:
                params = json.load(f)
        run_power_kernel(params)
    return 0


if __name__ == "__main__":
    sys.exit(main())
