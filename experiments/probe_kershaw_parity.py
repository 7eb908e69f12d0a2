"""Kershaw iteration-parity isolation (VERDICT r4 task #3).

Reference: data.pdf Table 13, cg-fdm symm 1 f-1st kind-two sided, bisect:
k=1: 96 it, k=2: 51 it, k=3: 38 it, k=4: 32, k=5: 28.  The repo records
55 it at k=2 — +4.  Candidate causes: (a) Chebyshev max-ev estimates (the
Lanczos start vector is permuted by our lexicographic DoF numbering, so
estimates deviate ~2-4% from the reference's), (b) mesh/mapping geometry,
(c) FDM harmonic extents.  This probe isolates (a) directly: sharpen or
scale the per-level eigenvalue estimates and watch the iteration count;
the k-ladder localizes whether the offset behaves like smoother quality
(shrinks with k) or like an outer-operator difference (constant).

    python -m experiments.probe_kershaw_parity [n_ref] [variants...]

Variants: base  k:N  evscale:X  evexact  evref
  base        stock config (k=2)
  k:N         smoother degree N
  evscale:X   multiply every level's (min,max) ev estimate by X
  evexact     replace the 40-it Lanczos estimate with a 200-it power
              iteration (converged lambda_max, same 1.2 safety factor)
  evexact+k:N both
Default variant set: base k:1 k:3 evexact evscale:0.95 evscale:1.05
"""

import copy
import json
import sys
import time

import jax

jax.config.update("jax_enable_x64", True)

from dealii_asm.solvers import chebyshev as _cheb

_ORIG_ESTIMATE = _cheb.estimate_eigenvalues


def _patched(mode):
    if mode is None:
        return _ORIG_ESTIMATE
    if mode == "exact":
        def f(A, n_dofs, M=None, constrained_mask=None, n_iterations=40,
              algorithm="lanczos", b0=None):
            info = _ORIG_ESTIMATE(A, n_dofs, M=M,
                                  constrained_mask=constrained_mask,
                                  n_iterations=200,
                                  algorithm="power iteration", b0=b0)
            print(f"    [evexact] lambda_max(power-200) = "
                  f"{info.max_eigenvalue_estimate / 1.2:.6g}", flush=True)
            return info
        return f
    scale = float(mode)

    def f(A, n_dofs, M=None, constrained_mask=None, n_iterations=40,
          algorithm="lanczos", b0=None):
        info = _ORIG_ESTIMATE(A, n_dofs, M=M, constrained_mask=constrained_mask,
                              n_iterations=n_iterations, algorithm=algorithm,
                              b0=b0)
        return _cheb.EigenvalueInfo(
            info.min_eigenvalue_estimate * scale,
            info.max_eigenvalue_estimate * scale,
            info.cg_n_iterations)
    return f


def run_variant(params, name):
    from dealii_asm.models.poisson import run_config

    p = copy.deepcopy(params)
    mode = None
    for part in name.split("+"):
        if part == "base":
            pass
        elif part.startswith("k:"):
            p["preconditioner"]["mg smoother"]["degree"] = int(part[2:])
        elif part.startswith("evscale:"):
            mode = part[len("evscale:"):]
        elif part == "evexact":
            mode = "exact"
        else:
            raise SystemExit(f"unknown variant {part!r}")
    _cheb.estimate_eigenvalues = _patched(mode)
    try:
        t0 = time.time()
        res = run_config(p, log=lambda *a: None)
        dt = time.time() - t0
    finally:
        _cheb.estimate_eigenvalues = _ORIG_ESTIMATE
    print(f"  {name:16s} it={res['it']:4d}  solve={res['time']:.3f}s  "
          f"(total {dt:.0f}s, n_dofs={res['n_dofs']})", flush=True)
    with open("experiments/results_unstructured_queue.jsonl", "a") as fh:
        fh.write(json.dumps({"task": "kershaw_parity", "variant": name,
                             "it": res["it"], "solve_seconds": res["time"],
                             "n_dofs": res["n_dofs"]}) + "\n")
    # long-lived probe processes accumulate device buffers across variants
    # (jit caches hold hoisted-const references) — drop them or the 4th
    # 7.2M-DoF setup in one process OOMs the 16 GB chip (measured r5)
    res = {k: res[k] for k in ("it", "time", "n_dofs")}
    import gc

    import jax as _jax

    from dealii_asm.solvers import krylov as _krylov

    _krylov._CG_DD_CACHE.clear()
    _jax.clear_caches()
    gc.collect()
    return res


def main():
    args = sys.argv[1:]
    n_ref = int(args[0]) if args and args[0].isdigit() else 3
    variants = [a for a in args if not a.isdigit()] or [
        "base", "k:1", "k:3", "evexact", "evscale:0.95", "evscale:1.05"]
    params = json.load(open("experiments/e2e_kershaw_q4.json"))
    params["n refinements"] = n_ref
    params["solver"]["best of"] = 1
    ref = {1: 96, 2: 51, 3: 38, 4: 32, 5: 28}
    print(f"Kershaw eps=0.3 Q4 n_ref={n_ref}; reference k->it (L=5): {ref}",
          flush=True)
    for v in variants:
        run_variant(params, v)


if __name__ == "__main__":
    main()
