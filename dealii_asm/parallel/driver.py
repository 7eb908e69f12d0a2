"""Multi-device driver path: the JSON-config solve, sharded.

The reference driver is MPI-parallel end to end — every level operator,
smoother, transfer and the outer Krylov run on distributed vectors
(`element_centered_preconditioners_01.cc` under ``mpirun -np 40``,
`experiments/README.MD`).  This module is the JAX twin wired into
``models/poisson.run_config`` via the ``"n devices"`` config key: level
operators and FDM smoothers become explicit-halo ``ShardedLattice`` twins
(parallel/halo.py, z-slab sharding + ``ppermute`` ghost exchange), MG
transfers become ``ShardedTransfer``s, and levels below a size threshold are
REPLICATED on every device — the analog of the reference's coarse
sub-communicator (MPI_Comm_split,
element_centered_preconditioners_01.cc:592-632).

The replicated tail (coarse levels + coarse-grid solver + any
intermediate-split inner hierarchy) is built by the standard single-device
factory and runs redundantly on every device; the junction is a
replicated-coarse ``ShardedTransfer`` (restriction = one ``psum`` of the
small coarse grid, prolongation reads the replicated vector locally).

Iteration parity with the single-device driver is exact: padded z-planes are
decoupled (identity rows, zero rhs), the eigenvalue-estimate start vector is
the PADDED single-device i%11 pattern, and all level algebra is the same
sum-factorized kernels split into per-shard banded blocks.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..precond.multigrid import Multigrid
from ..solvers.chebyshev import (ChebyshevPreconditioner, EigenvalueInfo,
                                 RelaxationPreconditioner, eig_initial_guess)
from ..utils.config import get_child, get_param
from .halo import ShardedLattice, ShardedTransfer
from .sharding import make_mesh


def _noop_log(msg=""):
    pass


def _padded_mask(sl: ShardedLattice):
    """Constrained mask on the padded z-major layout (pad planes constrained)."""
    m = np.asarray(sl.op.dofs.boundary_mask).reshape(sl.grid_shape)
    Nz_pad = sl.grid_shape_pad[0]
    out = np.ones(sl.grid_shape_pad, bool)
    out[: sl.grid_shape[0]] = m
    return out.reshape(-1)


def _padded_b0(sl: ShardedLattice):
    """Single-device eig start vector (i%11, mean over n_dofs, constrained
    rows zeroed), zero-extended to the padded layout — keeps the Lanczos
    estimates bit-comparable with the unsharded driver."""
    v = eig_initial_guess(sl.n_dofs, sl.op.dofs.boundary_mask)
    return sl.pad(v)


def _sharded_smoother(sl: ShardedLattice, params: dict, log=_noop_log):
    """Sharded twin of the factory's Chebyshev/Relaxation + (FDM|Diagonal)."""
    ptype = params.get("type", "")
    inner_p = get_child(params, "preconditioner")
    itype = inner_p.get("type", "FDM" if ptype in ("Chebyshev", "Relaxation")
                        else "")
    if itype == "FDM":
        if sl.asm is None:
            raise ValueError("sharded FDM smoother needs the ASM attached")
        # the jitted applies: the eigenvalue estimate below calls them from
        # a host loop, where an un-jitted shard_map runs op by op and
        # compiles every primitive separately
        M = sl.smoother_vmult
        wt = sl.asm.weighting_type
        inner_sym = wt in ("none", "symm")
    elif itype == "Diagonal":
        from ..precond.diagonal import DiagonalPreconditioner

        d = DiagonalPreconditioner(sl.op)
        dinv = sl.pad(jnp.asarray(d.inv_diag, sl.dtype))
        M = lambda r: r * dinv
        inner_sym = True
    else:
        raise ValueError(
            f"sharded smoother: inner <{itype}> not supported (FDM/Diagonal)")

    sym = getattr(sl.op, "is_symmetric", True) and inner_sym
    algo = get_param(params, "ev algorithm",
                     "lanczos" if sym else "power iteration")
    mask = _padded_mask(sl)
    b0 = _padded_b0(sl)
    if ptype == "Chebyshev":
        sm = ChebyshevPreconditioner(
            sl.vmult, M, sl.n_padded,
            degree=int(get_param(params, "degree", 3)),
            smoothing_range=float(get_param(params, "smoothing range", 20.0)),
            polynomial_type=get_param(params, "polynomial type", "1st kind"),
            constrained_mask=mask, ev_algorithm=algo, eig_b0=b0)
        ev = sm.eigenvalues
    elif ptype == "Relaxation":
        sm = RelaxationPreconditioner(
            sl.vmult, M, sl.n_padded,
            n_iterations=int(get_param(params, "degree", 3)),
            omega=float(get_param(params, "omega", 0.0)),
            constrained_mask=mask, ev_algorithm=algo, eig_b0=b0)
        ev = sm.eigenvalues
    else:
        raise ValueError(
            f"sharded smoother type <{ptype}> not supported "
            "(Chebyshev/Relaxation)")
    log(f"- Create level smoother (sharded): {ptype}")
    if ev is not None:
        log(f"    - min ev: {ev.min_eigenvalue_estimate:g}")
        log(f"    - max ev: {ev.max_eigenvalue_estimate:g}\n")
    sm.is_symmetric = sym
    return sm


def _needs_asm(smoother_p: dict) -> bool:
    return get_child(smoother_p, "preconditioner").get("type", "FDM") == "FDM"


def _level_asm(dofs, smoother_p: dict, dtype):
    from ..precond.asm import ASMPreconditioner

    inner_p = get_child(smoother_p, "preconditioner")
    n_overlap = min(int(get_param(inner_p, "n overlap", 1)), dofs.degree)
    weighting = get_param(inner_p, "weighting type", "symm")
    patch = "element" if get_param(inner_p, "element centric", True) \
        else "vertex"
    asm = ASMPreconditioner(
        dofs, n_overlap=n_overlap, weighting_type=weighting,
        patch_type=patch, dtype=dtype,
        matmul_precision=get_param(inner_p, "matmul precision", None))
    if asm.global_fdm is None:
        raise ValueError(
            "sharded FDM smoother needs the separable global-FDM path "
            "(Cartesian/anisotropic lattice, non-RAS weighting)")
    return asm


class ShardedMGSolve:
    """Handles for the sharded outer solve: padded f64 fine operator +
    the level_dtype MG preconditioner over ShardedLattice levels."""

    def __init__(self, mg, fine_sl_outer, fine_sl_level):
        self.mg = mg
        self.fine_sl = fine_sl_outer      # outer-dtype fine lattice
        self.fine_sl_level = fine_sl_level

    def pad(self, v):
        return self.fine_sl.pad(v)

    def unpad(self, v):
        return self.fine_sl.unpad(v)

    @property
    def vmult(self):
        return self.fine_sl.vmult_traceable


def build_sharded_multigrid(precon_p: dict, family, fe_degree: int,
                            log, dtype, outer_dtype, n_devices: int,
                            replicate_below: int | None = None):
    """Sharded twin of models.poisson._build_multigrid.

    Levels with fewer than ``replicate_below`` DoFs (and everything at or
    below the intermediate split) are built replicated by the standard
    factory; the rest become explicit-halo ShardedLattice levels.  Returns a
    :class:`ShardedMGSolve`.
    """
    from ..models.poisson import (LEVEL_MATMUL_PRECISION, _make_dofs,
                                  _make_operator, _make_transfer,
                                  mg_level_layout)
    from ..precond.factory import create_system_preconditioner

    jmesh = make_mesh(n_devices)
    levels, intermediate = mg_level_layout(precon_p, family, fe_degree, log)
    if replicate_below is None:
        replicate_below = int(get_param(precon_p, "replicate below", 100_000))

    prec = LEVEL_MATMUL_PRECISION if dtype != jnp.float64 else None
    dofs_list, ops = [], []
    for r, d in levels:
        mesh = family.mesh_at(r)
        dofs = _make_dofs(family, mesh, d)
        op = _make_operator(family, dofs, dtype, matmul_precision=prec)
        log(f"- Create operator:\n  - n cells:          {mesh.n_cells_total}\n"
            f"  - n dofs:           {dofs.n_dofs}\n")
        dofs_list.append(dofs)
        ops.append(op)

    # junction: first sharded level (everything below stays replicated);
    # at least one replicated level (coarse solver), and the intermediate
    # split — if any — must live inside the replicated tail
    k = len(levels) - 1
    while k > 1 and dofs_list[k - 1].n_dofs >= replicate_below:
        k -= 1
    k = max(k, intermediate + 1, 1)
    if k >= len(levels):
        raise ValueError("no sharded level: raise 'n devices' problem size "
                         "or lower 'replicate below'")
    log(f" - sharded levels: {k}..{len(levels) - 1} over {n_devices} devices"
        f" (replicated below {replicate_below} DoFs)\n")

    smoother_p = get_child(precon_p, "mg smoother")
    interm_p = get_child(precon_p, "mg intermediate smoother")
    if not interm_p.get("type"):
        interm_p = smoother_p
    coarse_p = get_child(precon_p, "mg coarse grid solver")
    one_sided = get_param(precon_p, "one-sided v-cycle", False)
    n_coarse_cycles = int(get_param(precon_p, "n coarse cycles", 1))

    transfers_all = [
        _make_transfer(family, dofs_list[i], dofs_list[i + 1], dtype,
                       matmul_precision=prec)
        for i in range(len(levels) - 1)]

    # ---- replicated tail (levels 0..k-1): the standard factory ------------
    log("- Setting up coarse-grid solver on level 0\n")
    coarse = create_system_preconditioner(ops[0], coarse_p, log)
    if k == 1:
        replicated_fn = coarse.vmult
    else:
        rep_smoothers = []
        for l in range(1, k):
            p_l = interm_p if l <= intermediate else smoother_p
            log(f"- Setting up smoother on level {l}\n")
            rep_smoothers.append(
                create_system_preconditioner(ops[l], p_l, log))
        replicated = Multigrid([o.vmult for o in ops[:k]], rep_smoothers,
                               transfers_all[: k - 1], coarse.vmult,
                               one_sided=one_sided,
                               n_coarse_cycles=n_coarse_cycles)
        replicated_fn = replicated.vmult

    # ---- sharded levels k..L-1 ---------------------------------------------
    sls, sh_smoothers = [], []
    for l in range(k, len(levels)):
        asm = (_level_asm(dofs_list[l], smoother_p, dtype)
               if _needs_asm(smoother_p) else None)
        sl = ShardedLattice(ops[l], asm, jmesh)
        sls.append(sl)
        log(f"- Setting up smoother on level {l} (sharded)\n")
        sh_smoothers.append(_sharded_smoother(sl, smoother_p, log))

    sh_transfers = [ShardedTransfer(transfers_all[k - 1], sls[0],
                                    coarse_dofs=dofs_list[k - 1])]
    for i in range(1, len(sls)):
        sh_transfers.append(ShardedTransfer(transfers_all[k - 1 + i],
                                            sls[i], coarse_sl=sls[i - 1]))

    # level 0 of the outer hierarchy is the replicated junction level; its
    # operator is only used by n_coarse_cycles > 1 refreshes
    mg = Multigrid([ops[k - 1].vmult]
                   + [sl.vmult_traceable for sl in sls], sh_smoothers,
                   sh_transfers, replicated_fn, one_sided=one_sided,
                   n_coarse_cycles=n_coarse_cycles)

    # outer-dtype fine lattice for the Krylov loop (P8: f64 outer over f32
    # levels — both share the same padded layout, so PrecisionAdapter casts
    # compose without re-padding)
    if outer_dtype == dtype:
        fine_outer = sls[-1]
    else:
        fine_outer = ShardedLattice(
            _make_operator(family, dofs_list[-1], outer_dtype), None, jmesh)
    return ShardedMGSolve(mg, fine_outer, sls[-1])
