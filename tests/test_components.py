"""Tests for auxiliary components: IDR/Richardson, domain ASM, vertex_all,
precision adapter, VTU output, aspect ratio."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from dealii_asm.fem.dofs import DofHandler
from dealii_asm.mesh.grid import StructuredMesh
from dealii_asm.ops.laplace import LaplaceOperator
from dealii_asm.solvers.krylov import ReductionControl, idr, richardson


def _spd(n=50, seed=0):
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    A = (Q * np.linspace(1.0, 30.0, n)) @ Q.T
    return jnp.asarray(A), jnp.asarray(rng.standard_normal(n))


def test_idr_solves():
    A, b = _spd()
    res = idr(lambda x: A @ x, b, control=ReductionControl(400, 1e-12, 1e-9), s=2)
    assert res.converged
    assert np.linalg.norm(np.asarray(A) @ np.asarray(res.x) - np.asarray(b)) < 1e-6


def test_richardson_solves_with_jacobi():
    A, b = _spd(30, 1)
    d = jnp.asarray(1.0 / np.diag(np.asarray(A)))
    res = richardson(lambda x: A @ x, b, M=lambda x: 0.06 * x,
                     control=ReductionControl(5000, 1e-12, 1e-8))
    assert res.converged


def test_domain_preconditioner():
    from dealii_asm.precond.domain import DomainPreconditioner
    from dealii_asm.solvers.krylov import cg

    mesh = StructuredMesh(2, (8, 8))
    dofs = DofHandler(mesh, 2)
    op = LaplaceOperator(dofs)
    b = op.assemble_rhs(lambda p: np.ones(p.shape[0]))
    for halo in (0, 1, 2):
        dp = DomainPreconditioner(dofs, n_subdomains=2, n_halo_layers=halo)
        res = cg(op.vmult, b, M=dp.vmult, control=ReductionControl(200, 1e-12, 1e-8))
        assert res.converged
    # single subdomain without halo = exact solve -> 1 iteration
    dp1 = DomainPreconditioner(dofs, n_subdomains=1, n_halo_layers=0,
                               weighting_type="none")
    res1 = cg(op.vmult, b, M=dp1.vmult, control=ReductionControl(200, 1e-12, 1e-8))
    assert res1.n_iterations <= 2


def test_vertex_all_block_asm():
    from dealii_asm.precond.block_asm import create_block_preconditioner
    from dealii_asm.solvers.krylov import gmres

    mesh = StructuredMesh(2, (4, 4))
    dofs = DofHandler(mesh, 3)
    op = LaplaceOperator(dofs)
    blk = create_block_preconditioner(
        op, {"type": "AdditiveSchwarzPreconditioner",
             "restriction type": "vertex_all", "weighting type": "symm"})
    b = op.assemble_rhs(lambda p: np.ones(p.shape[0]))
    res = gmres(op.vmult, b, M=blk.vmult, control=ReductionControl(100, 1e-12, 1e-8))
    assert res.converged and res.n_iterations < 30


def test_precision_adapter():
    from dealii_asm.precond.adapter import PrecisionAdapter
    from dealii_asm.precond.diagonal import DiagonalPreconditioner

    mesh = StructuredMesh(2, (4, 4))
    dofs = DofHandler(mesh, 2)
    op32 = LaplaceOperator(dofs, dtype=jnp.float32)
    diag = DiagonalPreconditioner(op32)
    ad = PrecisionAdapter(diag, jnp.float32)
    x = jnp.asarray(np.random.default_rng(0).standard_normal(dofs.n_dofs))
    y = ad.vmult(x)
    assert y.dtype == x.dtype  # output back in f64
    np.testing.assert_allclose(
        np.asarray(y), np.asarray(diag.vmult(x.astype(jnp.float32))),
        rtol=1e-6)


def test_vtu_output(tmp_path):
    from dealii_asm.utils.vtu import write_vtu

    mesh = StructuredMesh(2, (3, 3))
    dofs = DofHandler(mesh, 2)
    path = os.path.join(tmp_path, "out.vtu")
    write_vtu(path, dofs, {"solution": np.arange(dofs.n_dofs, dtype=float)})
    text = open(path).read()
    assert "UnstructuredGrid" in text and "solution" in text
    assert text.count("DataArray") >= 8


def test_aspect_ratio():
    mesh = StructuredMesh(2, (4, 4), lengths=(1.0, 3.0))
    assert abs(mesh.max_aspect_ratio() - 3.0) < 1e-12
    from dealii_asm.mesh.transforms import kershaw_transform

    meshk = StructuredMesh(3, (6, 2, 2), transform=kershaw_transform(0.3, 0.3))
    assert meshk.max_aspect_ratio() > 1.5
