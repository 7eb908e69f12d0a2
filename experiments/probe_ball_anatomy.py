"""Per-component anatomy of the unstructured (ball) solve iteration.

Pins where the time of one outer iteration goes:

    gather        u0[cell_dofs_T]                  (L, C) XLA gather
    local         apply_local_lanes on gathered W  (pure elementwise chain)
    scatter       zeros.at[idx].add(v)             XLA scatter-add
    vmult         the production composition (all of the above)
    vmult-f32     the f32 single-pass twin (what MG levels run)
    precon        the full V-cycle apply (from the e2e config's MG)
    cg-it         one outer CG iteration (vmult + precon + vector ops)

Protocol: passed-args jits, lax.scan chaining (REP steps), scalar-fetch
sync, best-of-3.

    python -m experiments.probe_ball_anatomy [n_ref] [sections...]
"""

import json
import sys
import time

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np


def timed(label, fn, n_dofs, rep, fetch):
    """fn: () -> array; chained internally rep times."""
    out = fn()
    _ = fetch(out)  # compile + settle
    dt = float("inf")
    for _r in range(3):
        t0 = time.perf_counter()
        _ = fetch(fn())
        dt = min(dt, (time.perf_counter() - t0) / rep)
    print(f"{label:12s} {dt*1e3:9.3f} ms  {n_dofs/dt/1e9:7.3f} GDoF/s",
          flush=True)
    return dt


def main():
    args = sys.argv[1:]
    n_ref = int(args[0]) if args and args[0].isdigit() else 3
    sections = set(a for a in args if not a.isdigit()) or {
        "gather", "local", "scatter", "vmult", "vmultf32", "precon", "cgit"}

    from dealii_asm.models.poisson import (_build_multigrid, _make_dofs,
                                               _make_operator,
                                               make_mesh_family)
    from dealii_asm.precond.adapter import PrecisionAdapter
    from dealii_asm.utils.config import get_child

    params = json.load(open("experiments/e2e_ball_q4.json"))
    params["n refinements"] = n_ref
    family = make_mesh_family(params, lambda *a: None)
    dofs = _make_dofs(family, family.fine_mesh, 4)
    op = _make_operator(family, dofs, jnp.float64)
    n = dofs.n_dofs
    C = family.fine_mesh.n_cells_total
    print(f"ball L={n_ref}: {C} cells, {n} dofs", flush=True)

    key = jax.random.PRNGKey(0)
    u = jax.random.normal(key, (n,), jnp.float64)
    REP = 10

    from dealii_asm.ops.ddmath import dd_from_f64

    idxT = op.cell_dofs_T

    if "gather" in sections:
        @jax.jit
        def g_chain(u, idxT):
            uh, ul = dd_from_f64(u)
            def body(c, _):
                W = uh[idxT] + c
                return W * 0.5, None
            out, _ = jax.lax.scan(
                body, jnp.zeros(idxT.shape, jnp.float32), None, length=REP)
            return out
        timed("gather", lambda: g_chain(u, idxT), n, REP,
              lambda o: float(o[0, 0]))

    if "local" in sections:
        W = jax.device_put(u[idxT])

        @jax.jit
        def l_chain(W, *cf):
            def body(c, _):
                return op.apply_local_lanes(c, cf), None
            out, _ = jax.lax.scan(body, W, None, length=REP)
            return out
        timed("local", lambda: l_chain(W, *op.coeff6), n, REP,
              lambda o: float(o[0, 0]))

    if "scatter" in sections:
        v0 = jax.device_put(np.random.randn(*idxT.shape).astype(np.float32))

        from dealii_asm.ops.scatter import TransposeScatter

        tscat = TransposeScatter(np.asarray(op.dofs.cell_dofs).T, n)
        for variant in ("full", "ranked", "2d"):
            @jax.jit
            def s_new(v, _var=variant):
                def body(c, _):
                    dst = tscat.apply(v + c[0], dtype=jnp.float32,
                                      variant=_var)
                    return (c[0] + 1.0, dst), None
                (_, dst), _ = jax.lax.scan(
                    body, (jnp.float32(0.0), jnp.zeros(n, jnp.float32)),
                    None, length=REP)
                return dst
            timed(f"scat-{variant}", lambda: s_new(v0), n, REP,
                  lambda o: float(o[0]))
        print(f"(op table K={tscat.K}, shared={tscat.n_shared}/{n})",
              flush=True)

        # f64 scatter-add (the dd path's single collapse scatter)
        v64 = jax.device_put(np.random.randn(*idxT.shape))

        @jax.jit
        def s_old64(v, idxT):
            flat = idxT.reshape(-1)
            def body(c, _):
                dst = jnp.zeros(n, jnp.float64).at[flat].add(
                    (v + c[0]).reshape(-1))
                return (c[0] + 1.0, dst), None
            (_, dst), _ = jax.lax.scan(
                body, (jnp.float64(0.0), jnp.zeros(n, jnp.float64)),
                None, length=REP)
            return dst
        timed("scatter-f64", lambda: s_old64(v64, idxT), n, REP,
              lambda o: float(o[0]))

        @jax.jit
        def s_old(v, idxT):
            flat = idxT.reshape(-1)
            def body(c, _):
                dst = jnp.zeros(n, jnp.float32).at[flat].add(
                    (v + c[0]).reshape(-1))
                return (c[0] + 1.0, dst), None
            (_, dst), _ = jax.lax.scan(
                body, (jnp.float32(0.0), jnp.zeros(n, jnp.float32)),
                None, length=REP)
            return dst
        timed("scatter-old", lambda: s_old(v0, idxT), n, REP,
              lambda o: float(o[0]))

    if "vmult" in sections:
        @jax.jit
        def v_chain(u, *cf):
            def body(x, _):
                return op._vmult_impl(x, *cf) * 0.1, None
            out, _ = jax.lax.scan(body, u, None, length=REP)
            return out
        timed("vmult", lambda: v_chain(u, *op._coeff_args), n, REP,
              lambda o: float(o[0]))

    if "vmultf32" in sections:
        op32 = _make_operator(family, dofs, jnp.float32)
        u32 = u.astype(jnp.float32)

        @jax.jit
        def v32_chain(u, *cf):
            def body(x, _):
                return op32._vmult_impl(x, *cf) * 0.1, None
            out, _ = jax.lax.scan(body, u, None, length=REP)
            return out
        timed("vmult-f32", lambda: v32_chain(u32, *op32._coeff_args), n, REP,
              lambda o: float(o[0]))

    if "precon" in sections or "cgit" in sections:
        t0 = time.time()
        mg = _build_multigrid(get_child(params, "preconditioner"), family, 4,
                              op, lambda *a: None, jnp.float32)
        precon = PrecisionAdapter(mg, jnp.float32)
        print(f"(mg setup {time.time()-t0:.0f} s)", flush=True)

        if "precon" in sections:
            PREP = 5

            def p_run():
                x = u
                for _ in range(PREP):
                    x = precon.vmult(x) * 0.1
                return x
            timed("precon", p_run, n, PREP, lambda o: float(o[0]))

        if "cgit" in sections:
            PREP = 5

            def cg_run():
                x = u
                for _ in range(PREP):
                    r = op.vmult(x)
                    z = precon.vmult(r)
                    a = jnp.vdot(r, z) / jnp.vdot(z, op.vmult(z))
                    x = x - a * z
                return x
            timed("cg-it", cg_run, n, PREP, lambda o: float(o[0]))


if __name__ == "__main__":
    main()
