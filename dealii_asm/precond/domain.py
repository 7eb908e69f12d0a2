"""Subdomain-level additive Schwarz (rank-level ASM of the reference).

Rebuilds ``DomainPreconditioner`` (/root/reference/include/preconditioners.h:
27-127) and the halo-layer study of /root/reference/schwarz_02.cc:51-92: the
mesh is partitioned into slabs (one per MPI rank there, one per device shard
here), each subdomain solves its restricted sparse system (with n halo cell
layers) directly, and the weighted contributions are summed.

This is the matrix-based slow-oracle family: subdomain solves run on host via
sparse LU (the reference's inner solver is AMG/direct on the restricted serial
matrix).  The device Schwarz paths are precond/asm.py.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse.linalg as spla

from ..fem.assemble import assemble_laplace
from ..fem.dofs import DofHandler


class DomainPreconditioner:
    # host-side numpy/scipy oracle: must NOT be traced into jitted Krylov
    # device loops (solvers/krylov.py dispatches on this flag)
    device_traceable = False

    def __init__(self, dofs: DofHandler, n_subdomains: int = 2,
                 n_halo_layers: int = 1, weighting_type: str = "symm",
                 inner_solver: str = "direct", inner_reduction: float = 1e-8):
        """inner_solver "direct" = sparse LU per subdomain (the reference's
        TrilinosWrappers::SolverDirect path); "amg-cg" = diagonally smoothed
        CG to ``inner_reduction`` standing in for the inner AMG option
        (preconditioners.h:27-127 takes an arbitrary inner preconditioner)."""
        self.dofs = dofs
        self.weighting_type = weighting_type
        self.inner_solver = inner_solver
        self.inner_reduction = inner_reduction
        mesh = dofs.mesh
        dim = mesh.dim
        A = assemble_laplace(dofs).tocsc()
        n = dofs.n_dofs

        # partition cells in slabs along the slowest axis, widen by halo cells
        axis = dim - 1
        n_cells_axis = mesh.n_cells[axis]
        n_subdomains = min(n_subdomains, n_cells_axis)
        bounds = np.linspace(0, n_cells_axis, n_subdomains + 1).astype(int)
        cd = np.asarray(dofs.cell_dofs)
        mi = mesh.cell_multi_index()

        self.blocks = []
        counts = np.zeros(n)
        for sdom in range(n_subdomains):
            lo = max(bounds[sdom] - n_halo_layers, 0)
            hi = min(bounds[sdom + 1] + n_halo_layers, n_cells_axis)
            cells = np.where((mi[:, axis] >= lo) & (mi[:, axis] < hi))[0]
            ids = np.unique(cd[cells].reshape(-1))
            ids = ids[~dofs.boundary_mask[ids]]
            Ab = A[np.ix_(ids, ids)].tocsc()
            if inner_solver == "direct":
                solver = spla.splu(Ab).solve
            else:  # inexact inner solve (AMG stand-in)
                def solver(rhs, Ab=Ab):
                    d = Ab.diagonal()
                    M = spla.LinearOperator(Ab.shape,
                                            matvec=lambda v: v / d)
                    x, _ = spla.cg(Ab, rhs, rtol=self.inner_reduction,
                                   maxiter=500, M=M)
                    return x
            self.blocks.append((ids, solver))
            counts[ids] += 1.0
        counts[counts == 0] = 1.0
        w = 1.0 / counts
        self.w = np.sqrt(w) if weighting_type == "symm" else w
        self.is_symmetric = weighting_type in ("none", "symm")

    def vmult(self, src):
        import jax.numpy as jnp

        x = np.asarray(src, dtype=np.float64)
        if self.weighting_type in ("pre", "symm"):
            x = x * self.w
        dst = np.zeros_like(x)
        for ids, solve in self.blocks:
            dst[ids] += solve(x[ids])
        if self.weighting_type in ("post", "symm"):
            dst = dst * self.w
        return jnp.asarray(dst, src.dtype)

    def __call__(self, src):
        return self.vmult(src)
