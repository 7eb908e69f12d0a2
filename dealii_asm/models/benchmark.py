"""Smoother/operator throughput benchmark — matrix_free_loop_08 equivalent.

Rebuilds /root/reference/matrix_free_loop_08.likwid.cc: a periodic balanced
hyper-cube (optionally sinusoidally deformed), a list of preconditioner labels
in the reference's compact grammar, warm-up + timed repetitions, and
grep-friendly output lines

    >> label n_dofs n_rep time sizeof(Number) degree n_ghost n_import

Label grammar (matrix_free_loop_08.likwid.cc:108-144, 244-298):
    vmult                                  — operator only
    <wt>-<ov|v>-<seq>[-<prepost>-<const>]  — FDM smoother apply
        wt  ∈ {add(=none), pre, post, symm, ras};  ov ∈ 1..p or 'v' (vertex)
        seq ∈ {g(lobal), l(ocal), c(ompressed), dg} — weight storage layout;
        under XLA all weight layouts fuse into the apply, so seq is accepted and
        recorded but does not change the kernel
    cheby-<deg>-<opt>-<inner...>           — Chebyshev around diag or FDM

The LIKWID hardware-counter role is played by jax profiling + the HLO cost
model (utils/profiling.py); n_ghost/n_import report the sharded halo sizes
(0 on a single chip).
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from ..fem.dofs import DofHandler
from ..mesh.balanced import balanced_hyper_cube_subdivisions
from ..mesh.grid import StructuredMesh
from ..mesh.transforms import sinusoidal_displacement
from ..ops.laplace import LaplaceOperator
from ..precond.asm import ASMPreconditioner
from ..precond.diagonal import DiagonalPreconditioner
from ..solvers.chebyshev import ChebyshevPreconditioner, estimate_eigenvalues
from ..utils.config import get_param


def parse_fdm_label(props, offset):
    """process_fdm_parameters analog."""
    wt = props[offset]
    overlap = props[offset + 1]
    cfg = {
        "weighting_type": "none" if wt == "add" else wt,
        "patch_type": "vertex" if overlap == "v" else "element",
        "n_overlap": 1 if overlap == "v" else int(overlap),
    }
    return cfg


def build_from_label(label: str, op, dofs, dtype, jmesh=None):
    """Build the timed apply for one label.

    Returns (fn, factor, pad, unpad, n_ghost): with a device mesh the apply is
    the explicit-halo sharded twin (parallel/halo.py) over padded vectors, and
    n_ghost is the per-rank ghost-layer size actually exchanged per apply
    (2·hw·Ny·Nx — the analog of the reference's partitioner ghost/import
    columns, matrix_free_loop_08.likwid.cc:390-395)."""
    import jax.numpy as jnp

    props = label.split("-")
    t = props[0]
    factor = 1
    ident = (lambda v: v)

    def _sharded(asm):
        from ..parallel.halo import ShardedLattice

        sl = ShardedLattice(op, asm, jmesh)
        plane = int(np.prod(sl.grid_shape_pad[1:]))
        return sl, plane

    if t == "vmult":
        if jmesh is not None:
            sl, plane = _sharded(None)
            import jax as _jax

            return (_jax.jit(sl.vmult_traceable), 1, sl.pad, sl.unpad,
                    2 * max(sl._hw_Mz, sl._hw_Kz) * plane)
        fn = op.vmult
    elif t == "cheby":
        degree = int(props[1])
        factor = degree
        if props[3] == "diag":
            inner = DiagonalPreconditioner(op)
            sym = True
            asm = None
        else:
            cfg = parse_fdm_label(props, 3)
            asm = ASMPreconditioner(
                dofs, n_overlap=cfg["n_overlap"],
                weighting_type=cfg["weighting_type"],
                patch_type=cfg["patch_type"], dtype=dtype)
            inner = asm
            sym = cfg["weighting_type"] in ("none", "symm")
        if jmesh is not None:
            import jax as _jax

            sl, plane = _sharded(asm)
            if asm is None:
                dinv = sl.pad(jnp.asarray(inner.inv_diag, sl.dtype))
                M = lambda r: r * dinv
                ghost = 2 * max(sl._hw_Mz, sl._hw_Kz) * plane
            else:
                M = sl.smoother_traceable
                ghost = 2 * max(sl._hw_Mz, sl._hw_Kz, sl._hw_Gz,
                                sl._hw_Gzt) * plane
            cheb = ChebyshevPreconditioner(
                sl.vmult_traceable, M, sl.n_padded, degree=degree,
                ev_algorithm="lanczos" if sym else "power iteration")
            return _jax.jit(cheb.vmult), factor, sl.pad, sl.unpad, ghost
        ev = estimate_eigenvalues(
            op.vmult, dofs.n_dofs, M=inner.vmult,
            constrained_mask=dofs.boundary_mask,
            algorithm="lanczos" if sym else "power iteration")
        cheb = ChebyshevPreconditioner(op.vmult, inner.vmult, dofs.n_dofs,
                                       degree=degree, eigenvalues=ev)
        fn = cheb.vmult
    else:
        cfg = parse_fdm_label(props, 0)
        asm = ASMPreconditioner(
            dofs, n_overlap=cfg["n_overlap"],
            weighting_type=cfg["weighting_type"],
            patch_type=cfg["patch_type"], dtype=dtype)
        if jmesh is not None and asm.global_fdm is not None:
            import jax as _jax

            sl, plane = _sharded(asm)
            return (_jax.jit(sl.smoother_traceable), 1, sl.pad, sl.unpad,
                    2 * max(sl._hw_Gz, sl._hw_Gzt) * plane)
        fn = asm.vmult
    return fn, factor, ident, ident, 0


def run_benchmark(params: dict, out=sys.stdout):
    import jax
    import jax.numpy as jnp

    dim = int(get_param(params, "dim", 3))
    s = int(get_param(params, "n subdivisions",
                  get_param(params, "n subdivision", 6)))
    degree = int(get_param(params, "fe degree", 4))
    n_rep = int(get_param(params, "n repetitions", 10))
    cartesian = get_param(params, "use cartesian mesh", True)
    labels = get_param(params, "preconditioner types", "vmult").split()
    dtype = {"float32": jnp.float32, "float64": jnp.float64,
             "bfloat16": jnp.bfloat16}[get_param(params, "number type", "float32")]

    cells, lengths = balanced_hyper_cube_subdivisions(dim, s)
    tf = None if cartesian else sinusoidal_displacement(0.1)
    mesh = StructuredMesh(dim, tuple(cells), lengths=tuple(lengths),
                          periodic=(True,) * dim, transform=tf)
    dofs = DofHandler(mesh, degree)
    op = LaplaceOperator(dofs, dtype=dtype)

    rng = np.random.default_rng(0)
    src0 = jnp.asarray(rng.standard_normal(dofs.n_dofs), dtype)

    n_dev_param = get_param(params, "n devices", 1)
    n_devices = (len(jax.devices()) if n_dev_param == "auto"
                 else int(n_dev_param))
    jmesh = None
    if n_devices > 1:
        from ..parallel.sharding import make_mesh

        jmesh = make_mesh(n_devices)

    for label in labels:
        fn, factor, pad, unpad, n_ghost = build_from_label(
            label, op, dofs, dtype, jmesh)
        src = pad(src0)
        # warm up (compile)
        y = fn(src)
        for _ in range(min(n_rep, 3)):
            y = fn(y)
        _ = float(jnp.asarray(y).ravel()[0])
        t0 = time.perf_counter()
        y = src
        for _ in range(n_rep):
            y = fn(y)
        _ = float(jnp.asarray(y).ravel()[0])  # force execution of the chain
        dt = time.perf_counter() - t0
        print(f">> {label} {dofs.n_dofs} {n_rep * factor} {dt:.6g} "
              f"{jnp.dtype(dtype).itemsize} {degree} {n_ghost} {n_ghost}",
              file=out, flush=True)
    return dofs.n_dofs


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    for path in argv:
        with open(path) as f:
            run_benchmark(json.load(f))
    return 0


if __name__ == "__main__":
    sys.exit(main())
