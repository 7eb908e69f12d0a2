"""SPMD sharding of the solver over a jax device mesh.

Device-mesh replacement for the reference's MPI domain decomposition
(SURVEY.md §2d): p4est SFC partitioning + two-phase ghost exchange
(/root/reference/include/matrix_free_internal.h:15-103) become a 1D device
mesh over which both the cell-batch axis and the DoF-vector axis are sharded
with ``jax.sharding.NamedSharding``; XLA's SPMD partitioner inserts the halo
collectives (the gather/scatter index maps are static, so the exchanged sets
are exactly the reference's ghost/import index sets).

The structured mesh is partitioned in slabs along the slowest axis, so
cross-shard indices touch only neighbor slabs and the inserted collectives are
neighbor permutes on ICI rather than all-gathers at scale.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS = "dd"  # domain-decomposition axis


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (AXIS,))


def shard_cells(mesh: Mesh, *arrays):
    """Place cell-batched arrays (leading axis = cells) sharded over the mesh."""
    sh = NamedSharding(mesh, P(AXIS))
    out = tuple(jax.device_put(a, sh) for a in arrays)
    return out if len(out) > 1 else out[0]


def shard_dofs(mesh: Mesh, vec):
    """Place a global DoF vector sharded over the mesh."""
    return jax.device_put(vec, NamedSharding(mesh, P(AXIS)))


def replicate(mesh: Mesh, *arrays):
    sh = NamedSharding(mesh, P())
    out = tuple(jax.device_put(a, sh) for a in arrays)
    return out if len(out) > 1 else out[0]


class ShardedPoissonStep:
    """A fully-jitted, sharded smoother-preconditioned solve step.

    One step = fused (Chebyshev-FDM-smoothed Richardson) update
      r = b − A x;  x += smoother(r)
    which exercises the full hot path: sum-factorized operator, patch gather,
    batched FDM transforms, weighted scatter — all sharded over the cell axis.
    """

    def __init__(self, op, smoother, mesh: Mesh, asm=None):
        self.mesh = mesh
        # shard the big per-cell tables; replicate small shape tables
        op.cell_dofs = shard_cells(mesh, op.cell_dofs)
        if op.coeff is not None:
            op.coeff = shard_cells(mesh, op.coeff)
        else:
            op.cell_widths = shard_cells(mesh, op.cell_widths)
        if asm is not None and hasattr(asm, "patch_idx"):
            asm.patch_idx = shard_cells(mesh, asm.patch_idx)
            asm.ids = shard_cells(mesh, asm.ids)
        self.op = op
        self.smoother = smoother
        dof_sh = NamedSharding(mesh, P(AXIS))
        self._step = jax.jit(
            self._step_impl, in_shardings=(dof_sh, dof_sh),
            out_shardings=dof_sh)

    def _step_impl(self, x, b):
        r = b - self.op.vmult_traceable(x)
        return x + self.smoother.vmult(r)

    def step(self, x, b):
        return self._step(x, b)


class HaloSolverStep:
    """Fused smoothed-Richardson step on the explicit-halo sharded operators.

    x ← x + cheb(b − A x) with A and the FDM smoother applied through
    shard_map/ppermute halo exchanges (parallel/halo.py) — the production
    multi-chip hot path, jitted as ONE program.
    """

    def __init__(self, sl, cheb_degree=2, eigenvalues=None):
        import jax

        from ..solvers.chebyshev import ChebyshevPreconditioner, EigenvalueInfo

        self.sl = sl
        cheb = ChebyshevPreconditioner(
            sl.vmult_traceable, sl.smoother_traceable, sl.n_padded,
            degree=cheb_degree,
            eigenvalues=eigenvalues or EigenvalueInfo(1.0, 1.2, 0))
        self.cheb = cheb
        self._step = jax.jit(
            lambda x, b: x + cheb.vmult(b - sl.vmult_traceable(x)))

    def step(self, x, b):
        return self._step(x, b)


def sharded_solver_step(dim=3, degree=2, cells_per_device=2, n_devices=None,
                        mesh=None, dtype=jnp.float32, mode="halo"):
    """Build a tiny sharded problem + one jitted solve step (dryrun helper).

    mode="halo": explicit shard_map/ppermute ghost exchange (default);
    mode="spmd": NamedSharding-annotated arrays, XLA chooses collectives.
    """
    from ..fem.dofs import DofHandler
    from ..mesh.grid import StructuredMesh
    from ..ops.laplace import LaplaceOperator
    from ..precond.asm import ASMPreconditioner
    from ..solvers.chebyshev import ChebyshevPreconditioner, EigenvalueInfo

    mesh = mesh or make_mesh(n_devices)
    n_dev = mesh.devices.size
    cells = tuple([4] * (dim - 1) + [cells_per_device * n_dev])
    rng = np.random.default_rng(0)
    if mode == "halo":
        from .halo import ShardedLattice

        # Dirichlet cube: its z node count does NOT divide the device count,
        # exercising the pad-plane machinery of the halo path
        smesh = StructuredMesh(dim, cells)
        dofs = DofHandler(smesh, degree)
        op = LaplaceOperator(dofs, dtype=dtype)
        asm = ASMPreconditioner(dofs, n_overlap=1, weighting_type="symm",
                                dtype=dtype)
        sl = ShardedLattice(op, asm, mesh)
        step = HaloSolverStep(sl)
        b = sl.pad(jnp.asarray(rng.standard_normal(dofs.n_dofs), dtype))
        x = sl.pad(jnp.zeros(dofs.n_dofs, dtype))
        return step, x, b
    # XLA-SPMD fallback path: fully periodic so the lattice divides evenly
    smesh = StructuredMesh(dim, cells, periodic=(True,) * dim)
    dofs = DofHandler(smesh, degree)
    op = LaplaceOperator(dofs, dtype=dtype)
    asm = ASMPreconditioner(dofs, n_overlap=1, weighting_type="symm", dtype=dtype)
    cheb = ChebyshevPreconditioner(
        op.vmult_traceable, asm.vmult_traceable, dofs.n_dofs, degree=2,
        eigenvalues=EigenvalueInfo(1.0, 1.2, 0))
    step = ShardedPoissonStep(op, cheb, mesh, asm=asm)
    n = dofs.n_dofs
    b = shard_dofs(mesh, jnp.asarray(rng.standard_normal(n), dtype))
    x = shard_dofs(mesh, jnp.zeros(n, dtype))
    return step, x, b
