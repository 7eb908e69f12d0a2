"""V-cycle anatomy for the Kershaw ph-MG (f32 levels): per-level operator,
smoother, transfer, and whole-cycle timings.

    python -m experiments.probe_kershaw_vcycle [n_refinements]
"""

import json
import sys
import time

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from dealii_asm.models.poisson import _build_multigrid, make_mesh_family
from dealii_asm.utils.config import get_child


def timeit(label, fn, *args, n=5):
    fn(*args)  # compile
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / n * 1e3
    print(f"  {label:44s} {dt:9.2f} ms", flush=True)
    return dt


def walk(mg, tag=""):
    rng = np.random.default_rng(0)
    for i, op in enumerate(mg.operators):
        n = None
        # find n via a zero-vector shape probe on the smoother side
        obj = getattr(op, "__self__", None)
        n = getattr(obj, "n_dofs", None)
        v = jnp.asarray(rng.standard_normal(n), jnp.float32)
        timeit(f"{tag}op[{i}] vmult (n={n})", jax.jit(op), v)
    for i, sm in enumerate(mg.smoothers):
        obj = getattr(sm, "op", None) or getattr(sm, "operator", None)
        n = getattr(getattr(sm, "vmult", None), "__self__", sm)
        nd = None
        for cand in (obj, sm):
            nd = getattr(cand, "n_dofs", nd)
        if nd is None:
            aop = mg.operators[i + 1]
            nd = getattr(aop.__self__, "n_dofs", None)
        v = jnp.asarray(rng.standard_normal(nd), jnp.float32)
        timeit(f"{tag}smoother[{i + 1}].vmult (n={nd})", jax.jit(sm.vmult), v)
        if hasattr(sm, "step"):
            x0 = jnp.zeros_like(v)
            timeit(f"{tag}smoother[{i + 1}].step", jax.jit(sm.step), x0, v)
    for i, tr in enumerate(mg.transfers):
        nf = getattr(mg.operators[i + 1].__self__, "n_dofs", None)
        vf = jnp.asarray(rng.standard_normal(nf), jnp.float32)
        timeit(f"{tag}transfer[{i}] restrict", jax.jit(tr.restrict), vf)
        nc = getattr(mg.operators[i].__self__, "n_dofs", None)
        vc = jnp.asarray(rng.standard_normal(nc), jnp.float32)
        timeit(f"{tag}transfer[{i}] prolongate", jax.jit(tr.prolongate), vc)


def main():
    n_ref = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    params = json.load(open("experiments/e2e_kershaw_q4.json"))
    params["n refinements"] = n_ref
    family = make_mesh_family(params, lambda *a: None)
    t0 = time.perf_counter()
    mg = _build_multigrid(get_child(params, "preconditioner"), family, 4,
                          None, lambda *a: None, jnp.float32)
    print(f"MG setup: {time.perf_counter() - t0:.1f} s", flush=True)

    # coarse function may itself be an inner Multigrid
    inner = getattr(mg.coarse_solver, "__self__", None)
    from dealii_asm.precond.multigrid import Multigrid

    if isinstance(inner, Multigrid):
        print("[inner h-MG]")
        walk(inner, tag="in ")
    print("[outer p-MG]")
    walk(mg)

    fine_n = mg.operators[-1].__self__.n_dofs
    rng = np.random.default_rng(1)
    b = jnp.asarray(rng.standard_normal(fine_n), jnp.float32)
    timeit("WHOLE V-cycle", mg.vmult, b)


if __name__ == "__main__":
    main()
