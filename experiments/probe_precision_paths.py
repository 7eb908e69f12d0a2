"""Time and accuracy of the solver's precision choices on the GPU.

Sections (all by default):

  f64   the outer f64 operator apply, native f64 against double-single
        (kernel="dd" / "lanes-dd"), each against an independent f64
        evaluation: flagship Cartesian Q4 (64^3 cells), Kershaw Q4 (48^3),
        ball Q4 (4 refinements)
  f32   the f32 MG-level operator and the FDM apply at "highest" and at
        "tensorfloat32" against their f64 twins; the plain smoother step
        x + w P^-1 (b - A x) and a 3-vector copy ceiling (read x, read b,
        write x') in the same process
  its   the flagship and Kershaw solves with the FDM and MG-level matmuls
        at "highest" or "tensorfloat32"

    python -m experiments.probe_precision_paths [--cells N] [--kershaw-ref R]
        [--ball-ref R] [sections...]

Times are per apply, best of 3 chains of --rep applies inside one jitted
loop, each ending in block_until_ready.  Errors are rel-L2.
"""

import argparse
import json
import subprocess
import time

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from dealii_asm.utils.jitutils import enable_compilation_cache


def per_apply_ms(fn, x, *args, rep=20):
    """ms per fn(y, *args) application, chained rep times in one program."""
    eps = 1e-20 if x.dtype == jnp.float32 else 1e-200

    @jax.jit
    def chain(x, *args):
        def body(_, y):
            # y stays ~x: no growth over the chain, fn cannot be elided
            return jax.lax.optimization_barrier(x + eps * fn(y, *args))
        return jax.lax.fori_loop(0, rep, body, x)

    jax.block_until_ready(chain(x, *args))
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(chain(x, *args))
        best = min(best, time.perf_counter() - t0)
    return best / rep * 1e3


def step_ms(step, x, b, rep=20):
    """ms per smoother step y <- step(y, b), chained rep times."""
    @jax.jit
    def chain(x, b):
        return jax.lax.fori_loop(
            0, rep, lambda _, y: jax.lax.optimization_barrier(step(y, b)), x)

    jax.block_until_ready(chain(x, b))
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(chain(x, b))
        best = min(best, time.perf_counter() - t0)
    return best / rep * 1e3


def rel_l2(a, ref):
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(a - ref) / np.linalg.norm(ref))


def report(**kw):
    print(json.dumps(kw), flush=True)


def _cartesian(cells):
    from dealii_asm.fem.dofs import DofHandler
    from dealii_asm.mesh.grid import StructuredMesh

    return DofHandler(StructuredMesh(3, (cells,) * 3), 4)


def section_f64(args):
    from dealii_asm.models.poisson import make_mesh_family, _make_dofs
    from dealii_asm.ops.laplace import LaplaceOperator
    from dealii_asm.ops.laplace_general import GeneralLaplaceOperator
    from dealii_asm.ops.tensorops import (merged_laplace_apply,
                                          separable_laplace_apply)

    rng = np.random.default_rng(0)
    f64 = jnp.float64

    # flagship: Cartesian, reference = dense separable axis matmuls in f64
    dofs = _cartesian(args.cells)
    nat = LaplaceOperator(dofs, dtype=f64)
    dd = LaplaceOperator(dofs, dtype=f64, kernel="dd")
    x = jnp.asarray(rng.standard_normal(dofs.n_dofs))
    free = nat._free_mask()
    ref = jnp.where(free, separable_laplace_apply(
        jnp.where(free, x, 0.0).reshape(nat.grid_shape), nat.M1d_global,
        nat.K1d_global, 3).reshape(-1), x)
    for name, op in (("native", nat), ("dd", dd)):
        report(case="flagship f64 apply", path=name, n_dofs=dofs.n_dofs,
               rel_l2_vs_f64=rel_l2(op.vmult(x), ref),
               ms=per_apply_ms(lambda y, _op=op: _op._vmult_impl(y), x))
    del nat, dd, ref

    # Kershaw: reference = global dense E-matmul apply in f64
    params = json.load(open("experiments/e2e_kershaw_q4.json"))
    params["n refinements"] = args.kershaw_ref
    fam = make_mesh_family(params)
    dofs = _make_dofs(fam, fam.fine_mesh, 4)
    nat = LaplaceOperator(dofs, mapping_degree=fam.mapping_degree, dtype=f64)
    dd = LaplaceOperator(dofs, mapping_degree=fam.mapping_degree, dtype=f64,
                         kernel="dd", geometry=nat.geometry)
    x = jnp.asarray(rng.standard_normal(dofs.n_dofs))
    free = nat._free_mask()
    ref = jnp.where(free, merged_laplace_apply(
        jnp.where(free, x, 0.0).reshape(nat.grid_shape), nat.Ev, nat.Ed,
        nat.Evt, nat.Edt, nat.coeff6, 3).reshape(-1), x)
    for name, op in (("native", nat), ("dd", dd)):
        report(case="kershaw f64 apply", path=name, n_dofs=dofs.n_dofs,
               rel_l2_vs_f64=rel_l2(op.vmult(x), ref),
               ms=per_apply_ms(lambda y, *c, _op=op: _op._vmult_impl(y, c),
                               x, *op._coeff_args))
    del nat, dd, ref

    # ball: reference = patch-major sumfac apply in f64
    params = json.load(open("experiments/e2e_ball_q4.json"))
    params["n refinements"] = args.ball_ref
    fam = make_mesh_family(params)
    dofs = _make_dofs(fam, fam.fine_mesh, 4)
    x = jnp.asarray(rng.standard_normal(dofs.n_dofs))
    ref = GeneralLaplaceOperator(dofs, dtype=f64, kernel="sumfac").vmult(x)
    for name, kern in (("native", "lanes"), ("dd", "lanes-dd")):
        op = GeneralLaplaceOperator(dofs, dtype=f64, kernel=kern)
        report(case="ball f64 apply", path=name, n_dofs=dofs.n_dofs,
               rel_l2_vs_f64=rel_l2(op.vmult(x), ref),
               ms=per_apply_ms(lambda y, *c, _op=op: _op._vmult_impl(y, *c),
                               x, *op._coeff_args))
        del op


def section_f32(args):
    from dealii_asm.ops.laplace import LaplaceOperator
    from dealii_asm.precond.asm import ASMPreconditioner

    rng = np.random.default_rng(1)
    dofs = _cartesian(args.cells)
    x64 = jnp.asarray(rng.standard_normal(dofs.n_dofs))
    b64 = jnp.asarray(rng.standard_normal(dofs.n_dofs))
    x, b = x64.astype(jnp.float32), b64.astype(jnp.float32)
    x64, b64 = x.astype(jnp.float64), b.astype(jnp.float64)

    op64 = LaplaceOperator(dofs, dtype=jnp.float64)
    ref = op64.vmult(x64)
    for prec in ("highest", "tensorfloat32"):
        op = LaplaceOperator(dofs, dtype=jnp.float32, matmul_precision=prec)
        report(case="f32 level operator", precision=prec,
               rel_l2_vs_f64=rel_l2(op.vmult(x), ref),
               ms=per_apply_ms(lambda y, _op=op: _op._vmult_impl(y), x))
    opb = LaplaceOperator(dofs, dtype=jnp.float32, kernel="banded")
    report(case="f32 level operator", precision="banded (no matmul)",
           rel_l2_vs_f64=rel_l2(opb.vmult(x), ref),
           ms=per_apply_ms(lambda y: opb._vmult_impl(y), x))
    del op64, opb

    asm64 = ASMPreconditioner(dofs, n_overlap=1, weighting_type="symm",
                              dtype=jnp.float64)
    ref = asm64.vmult(x64)
    rstep = x64 + 0.3 * asm64.vmult(b64 - LaplaceOperator(
        dofs, dtype=jnp.float64).vmult(x64))
    del asm64
    op = LaplaceOperator(dofs, dtype=jnp.float32, matmul_precision="highest")
    asm = ASMPreconditioner(dofs, n_overlap=1, weighting_type="symm",
                            dtype=jnp.float32)
    for prec in ("highest", "tensorfloat32"):
        asm.matmul_precision = prec

        def step(y, b):
            return y + 0.3 * asm.vmult_traceable(b - op.vmult_traceable(y))

        report(case="f32 FDM apply", precision=prec,
               rel_l2_vs_f64=rel_l2(asm.vmult_traceable(x), ref),
               ms=per_apply_ms(lambda y: asm.vmult_traceable(y), x))
        report(case="f32 smoother step", fdm_precision=prec,
               n_dofs=dofs.n_dofs,
               rel_l2_vs_f64=rel_l2(jax.jit(step)(x, b), rstep),
               ms=step_ms(step, x, b))
    report(case="copy ceiling (read x, read b, write x')",
           n_dofs=dofs.n_dofs,
           ms=step_ms(lambda y, b: 0.5 * (y + b), x, b),
           bytes_per_step=3 * dofs.n_dofs * 4)


def section_its(args):
    """Solves with the FDM and MG-level matmul precisions varied."""
    import dealii_asm.models.poisson as poisson

    for cfg, fdm, level in (
            ("e2e_aniso_q4.json", "highest", "highest"),
            ("e2e_aniso_q4.json", "tensorfloat32", "highest"),
            ("e2e_aniso_q4.json", "tensorfloat32", "tensorfloat32"),
            ("e2e_kershaw_q4.json", "tensorfloat32", "tensorfloat32")):
        params = json.load(open(f"experiments/{cfg}"))
        smoother = params["preconditioner"]["mg smoother"]
        smoother["preconditioner"]["matmul precision"] = fdm
        poisson.LEVEL_MATMUL_PRECISION = level
        r = poisson.run_config(params, log=lambda *_: None)
        report(case="solve", config=cfg, fdm_precision=fdm,
               level_precision=level, its=r["it"], converged=r["converged"],
               solve_s=r["time"], setup_s=r["setup_time"])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sections", nargs="*", default=["f64", "f32", "its"])
    ap.add_argument("--cells", type=int, default=64)
    ap.add_argument("--kershaw-ref", type=int, default=3)
    ap.add_argument("--ball-ref", type=int, default=4)
    args = ap.parse_args()
    enable_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU, found {dev.platform}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    report(platform=dev.platform, kind=dev.device_kind,
           nvidia_smi=smi.stdout.strip().splitlines()[:1])
    for s in args.sections:
        {"f64": section_f64, "f32": section_f32, "its": section_its}[s](args)


if __name__ == "__main__":
    main()
