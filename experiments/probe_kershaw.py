"""Staged fault isolation for the 7.2M Kershaw E2E (data.pdf Table 13).

Runs each solve component as its own bounded dispatch with block_until_ready
and a stage marker, so a device fault names its component instead of
killing a monolithic CG while_loop.  Usage:

    python -m experiments.probe_kershaw [n_refinements]
"""

import json
import sys
import time

import jax

jax.config.update("jax_enable_x64", True)  # match the CLI (__main__.py)

import jax.numpy as jnp
import numpy as np

from dealii_asm.models.poisson import (_build_multigrid, _make_dofs,
                                           _make_operator, make_mesh_family)
from dealii_asm.fem.functions import make_rhs_and_dbc
from dealii_asm.precond.adapter import PrecisionAdapter
from dealii_asm.utils.config import get_child


def stage(name):
    print(f"[{time.strftime('%H:%M:%S')}] === {name}", flush=True)


def main():
    n_ref = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    params = json.load(open("experiments/e2e_kershaw_q4.json"))
    params["n refinements"] = n_ref

    stage("mesh/dofs/operator (f64 outer)")
    family = make_mesh_family(params, lambda *a: None)
    dofs = _make_dofs(family, family.fine_mesh, 4)
    op = _make_operator(family, dofs, jnp.float64)
    print("n_dofs:", dofs.n_dofs, flush=True)

    stage("rhs")
    rhs_fn, dbc_fn = make_rhs_and_dbc("constant", 3)
    b = op.assemble_rhs(rhs_fn, dirichlet=dbc_fn)
    jax.block_until_ready(b)

    stage("outer f64 vmult")
    t0 = time.perf_counter()
    v = op.vmult(b)
    jax.block_until_ready(v)
    print("vmult ok", time.perf_counter() - t0, flush=True)
    t0 = time.perf_counter()
    jax.block_until_ready(op.vmult(v))
    print("vmult warm", time.perf_counter() - t0, flush=True)

    stage("build f32 MG")
    mg = _build_multigrid(get_child(params, "preconditioner"), family, 4, op,
                          lambda *a: None, jnp.float32)
    precon = PrecisionAdapter(mg, jnp.float32)

    stage("V-cycle apply")
    t0 = time.perf_counter()
    y = precon.vmult(b)
    jax.block_until_ready(y)
    print("vcycle ok", time.perf_counter() - t0, flush=True)
    t0 = time.perf_counter()
    jax.block_until_ready(precon.vmult(y))
    print("vcycle warm", time.perf_counter() - t0, flush=True)

    stage("CG 3 iterations (device loop)")
    from dealii_asm.solvers.krylov import solve as krylov_solve

    r = krylov_solve("CG", op.vmult, b, M=precon.vmult, max_iterations=3,
                     abs_tolerance=1e-10, rel_tolerance=1e-5)
    print("cg3:", r.n_iterations, r.converged, flush=True)

    stage("CG full")
    t0 = time.perf_counter()
    r = krylov_solve("CG", op.vmult, b, M=precon.vmult, max_iterations=1000,
                     abs_tolerance=1e-10, rel_tolerance=1e-5)
    jax.block_until_ready(r.x)
    print("cg full:", r.n_iterations, r.converged,
          time.perf_counter() - t0, flush=True)


if __name__ == "__main__":
    main()
