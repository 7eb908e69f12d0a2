"""Execute the large-scaling ladder on one device up to its memory limit
(matches /root/reference/experiments/large-scaling.py:32 — anisotropy
stretch 50, hp-MG, refinements 0..11, smoothers diag/fdm1/fdm2/fdmv).

Refinement 7 is 128^3 cells = 135,005,697 DoFs (Q4); refinement 8 (1.07B
DoFs) needs the multi-device path.  The outer Krylov runs f64 exactly like
the E2E gates; pass --f32 to run the outer in f32 instead (halves vector
memory; the scaling shape is the point here, not the parity contract).

    python -m experiments.run_large_scaling [--f32] [--best-of N] [SPEC...]

SPEC entries are `smoother:rmin[-rmax]` with smoother in diag,fdm1,fdm2,fdmv.
Default plan: fdm1:0-7 diag:7 fdm2:7 fdmv:7 (the size ladder on the headline
smoother + every smoother at the top size).
Appends JSON lines to experiments/results_large_scaling.jsonl.
"""

import json
import sys
import time

import jax

jax.config.update("jax_enable_x64", True)

SMOOTHER_COL = {"diag": 0, "fdm1": 1, "fdm2": 2, "fdmv": 3}
OUT = "experiments/results_large_scaling.jsonl"


def config_for(smoother: str, refinement: int) -> dict:
    idx = refinement * 4 + SMOOTHER_COL[smoother]
    path = f"experiments/sweep_large_scaling/input_{idx:04d}.json"
    params = json.load(open(path))
    assert params["n refinements"] == refinement, path
    return params


def main():
    args = sys.argv[1:]
    f32 = "--f32" in args
    args = [a for a in args if a != "--f32"]
    best_of = 3
    if "--best-of" in args:
        i = args.index("--best-of")
        best_of = int(args[i + 1])
        del args[i : i + 2]
    specs = args or ["fdm1:0-7", "diag:7", "fdm2:7", "fdmv:7"]

    plan = []
    for spec in specs:
        name, rng = spec.split(":")
        lo, _, hi = rng.partition("-")
        for r in range(int(lo), int(hi or lo) + 1):
            plan.append((name, r))

    import jax.numpy as jnp

    from dealii_asm.models.poisson import run_config

    dtype = jnp.float32 if f32 else jnp.float64
    for name, r in plan:
        params = config_for(name, r)
        params["solver"]["best of"] = best_of
        label = f"{name} r={r}"
        print(f"=== {label} (outer {'f32' if f32 else 'f64'})", flush=True)
        t0 = time.time()
        try:
            res = run_config(params, log=lambda *a: None, dtype=dtype)
            rec = {
                "smoother": name, "refinement": r, "n_dofs": res["n_dofs"],
                "n_cells": res["n_cells"], "it": res["it"],
                "solve_seconds": res["time"],
                "outer_dtype": "f32" if f32 else "f64",
                "seconds_per_it": res["time"] / max(res["it"], 1),
                "ns_per_dof_it": res["time"] / max(res["it"], 1)
                / res["n_dofs"] * 1e9,
                "gdofs_per_s": res["n_dofs"] * res["it"] / res["time"] / 1e9
                if res["time"] > 0 else None,
                "setup_plus_total_seconds": time.time() - t0,
            }
        except Exception as e:  # record the obstacle, keep laddering
            rec = {"smoother": name, "refinement": r,
                   "outer_dtype": "f32" if f32 else "f64",
                   "error": f"{type(e).__name__}: {e}"[:500]}
        print(json.dumps(rec), flush=True)
        with open(OUT, "a") as fh:
            fh.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
