"""Benchmark: Q4 smoother step at 17M DoF and the flagship solve, on a GPU.

Two measurements, on the first JAX device (which must be a GPU):

1. STEP: the reference's headline configuration (BASELINE.md) — 3D Q4,
   64^3 cells = 16,974,593 DoFs — one plain f32 smoother step
   x' = x + P⁻¹(b − A x) (vmult + FDM ov-1 symm apply + update) as XLA
   compiles it, in ms per step.  Beside it, in the same process, the copy
   ceiling of the same traffic: read x, read b, write x' (3 vectors).  Steps
   run chained in one jitted loop; the per-step time is the marginal one,
   (T(REP2) − T(REP1)) / (REP2 − REP1), which cancels the fixed per-call
   cost.

2. END-TO-END: the full solve of experiments/e2e_aniso_q4.json (CG rel 1e-5,
   f64 outer over f32 MG levels, h-MG + Chebyshev(1) + FDM-symm-ov1),
   best of 3, against data.pdf Table 1's 5 it / 0.237 s on the 40-rank
   node.  vs_baseline = reference_seconds / our_seconds.

Prints one JSON line that names the device.
"""

import json
import os
import subprocess
import time

import numpy as np

E2E_REF_SECONDS = 0.237  # data.pdf Table 1: CG+FDM(symm, ov1, k=1), 5 it
E2E_REF_ITERATIONS = 5
REP1, REP2 = 20, 40


def _marginal_ms(step, x, b):
    """Marginal ms per step of y <- step(y, b) chained inside one jit."""
    import jax

    def make(rep):
        @jax.jit
        def many(x, b):
            return jax.lax.fori_loop(
                0, rep,
                lambda _, y: jax.lax.optimization_barrier(step(y, b)), x)
        return many

    many1, many2 = make(REP1), make(REP2)
    jax.block_until_ready(many1(x, b))
    jax.block_until_ready(many2(x, b))
    t_short = t_long = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(many1(x, b))
        t_short = min(t_short, time.perf_counter() - t0)
        t0 = time.perf_counter()
        jax.block_until_ready(many2(x, b))
        t_long = min(t_long, time.perf_counter() - t0)
    return (t_long - t_short) / (REP2 - REP1) * 1e3


def _step_bench():
    import jax.numpy as jnp

    from dealii_asm.fem.dofs import DofHandler
    from dealii_asm.mesh.grid import StructuredMesh
    from dealii_asm.ops.laplace import LaplaceOperator
    from dealii_asm.precond.asm import ASMPreconditioner

    dtype = jnp.float32
    dofs = DofHandler(StructuredMesh(3, (64,) * 3), 4)
    op = LaplaceOperator(dofs, dtype=dtype, matmul_precision="highest")
    asm = ASMPreconditioner(dofs, n_overlap=1, weighting_type="symm",
                            dtype=dtype)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(dofs.n_dofs), dtype)
    b = jnp.asarray(rng.standard_normal(dofs.n_dofs), dtype)
    step_ms = _marginal_ms(
        lambda y, c: y + asm.vmult_traceable(c - op.vmult_traceable(y)), x, b)
    copy_ms = _marginal_ms(lambda y, c: 0.5 * (y + c), x, b)
    return dofs.n_dofs, step_ms, copy_ms


def _e2e_bench():
    """Full 17M-DoF solve through the driver path; returns (seconds, its)."""
    from dealii_asm.models.poisson import run_config

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "experiments", "e2e_aniso_q4.json")) as f:
        params = json.load(f)
    result = run_config(params, log=lambda *_: None)
    if not result["converged"]:
        raise RuntimeError("E2E solve did not converge")
    return result["time"], result["it"]


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU, found {dev.platform!r}")
    # the protocol is a TRUE f64 outer Krylov over f32 MG levels (the
    # reference's architecture)
    jax.config.update("jax_enable_x64", True)
    from dealii_asm.utils.jitutils import enable_compilation_cache

    enable_compilation_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)

    n_dofs, step_ms, copy_ms = _step_bench()
    e2e_s, e2e_it = _e2e_bench()
    print(json.dumps({
        "metric": "Q4 vmult+FDM-ov1 smoother step (XLA)",
        "value": step_ms, "unit": "ms/step", "n_dofs": n_dofs,
        "copy_ceiling_ms": copy_ms,
        "step_over_copy": step_ms / copy_ms,
        "e2e_seconds": e2e_s, "e2e_iterations": e2e_it,
        "vs_baseline": E2E_REF_SECONDS / e2e_s,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()),
                   "nvidia_smi": smi.stdout.strip().splitlines()[0]},
    }))


if __name__ == "__main__":
    main()
