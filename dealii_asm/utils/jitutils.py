"""jit helpers: constant hoisting, the persistent compilation cache, and
the matmul-precision context of traced applies.

``jax.jit`` of a solver loop that closes over operator/preconditioner tables
embeds every captured device array into the lowered program as a literal
constant.  At O(n_dofs) table sizes (merged-geometry coefficients, per-patch
FDM eigen-transform tables: gigabytes at the 7.2M-DoF Kershaw solve) that
copies every table into the executable, bloats compile time and memory, and
keys the compilation cache on the table contents.

``jit_hoist_consts`` traces the function once (``jax.make_jaxpr``), splits
off the captured constants, and jits a replay of the jaxpr that takes them
as runtime PARAMETERS — device-resident tables are then passed by reference
at dispatch time and the executable holds only the program.
(``jax.closure_convert`` does NOT do this: it only hoists tracer-derived
constants; concrete arrays stay embedded.)
"""

from __future__ import annotations

import contextlib
import os

# the checkout root: the compile cache lives at a fixed path inside it (the
# path is part of JAX's cache key, so a moving directory never hits)
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compilation_cache():
    """Turn on JAX's persistent compilation cache.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is the cache (JAX reads it
    itself, and no other directory is set here); otherwise the cache is
    ``.jax_cache/`` in the checkout."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(_ROOT, ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def precision_context(name):
    """Context naming the matmul precision of a traced apply (f32 matmuls
    that name none may run in TF32 on the GPU); no-op for None."""
    import jax

    return (jax.default_matmul_precision(name) if name
            else contextlib.nullcontext())


def jit_hoist_consts(fn, *example_args):
    """jit ``fn`` with closed-over array constants hoisted to arguments.

    ``example_args`` fix the positional signature (concrete arrays or
    ``jax.ShapeDtypeStruct``).  Tracing happens here, once; the returned
    callable replays the closed jaxpr with the hoisted constants prepended.
    """
    import jax
    from jax import tree_util

    try:
        from jax.extend.core import Jaxpr  # noqa: F401  (availability probe)
        from jax.core import eval_jaxpr
    except ImportError:  # pragma: no cover - older jax layouts
        from jax.core import eval_jaxpr

    closed, out_shape = jax.make_jaxpr(fn, return_shape=True)(*example_args)
    out_tree = tree_util.tree_structure(out_shape)
    jaxpr, consts = closed.jaxpr, list(closed.consts)

    def lifted(consts, *args):
        flat, _ = tree_util.tree_flatten(args)
        out = eval_jaxpr(jaxpr, consts, *flat)
        return tree_util.tree_unflatten(out_tree, out)

    jitted = jax.jit(lifted)

    def run(*args):
        return jitted(consts, *args)

    run._hoisted_n_consts = len(consts)  # introspection for tests
    return run
