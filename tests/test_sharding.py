"""Multi-device (8 virtual CPU devices) validation of the sharded paths.

VERDICT round-1 item #1: the sharded fused step must equal the single-device
result for Cartesian and Kershaw, element overlap 1 and 2, and a sharded
2-level MG V-cycle must preserve iteration counts.  Halo exchange is explicit
(shard_map/ppermute, parallel/halo.py) — the analog of the reference's
ghost-layer code (/root/reference/include/matrix_free_internal.h:15-103).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dealii_asm.fem.dofs import DofHandler
from dealii_asm.mesh.grid import StructuredMesh
from dealii_asm.mesh.transforms import kershaw_transform
from dealii_asm.ops.laplace import LaplaceOperator
from dealii_asm.ops.transfer import TwoLevelTransfer
from dealii_asm.parallel.halo import ShardedLattice, ShardedTransfer
from dealii_asm.parallel.sharding import make_mesh
from dealii_asm.precond.asm import ASMPreconditioner
from dealii_asm.solvers.chebyshev import (
    ChebyshevPreconditioner,
    EigenvalueInfo,
)


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return make_mesh(8)


def _rand(n, seed=0):
    return jnp.asarray(np.random.default_rng(seed).standard_normal(n))


def _problem(transform=None, degree=3, cells=(4, 4, 6), dtype=jnp.float64):
    mesh = StructuredMesh(3, cells, transform=transform)
    dofs = DofHandler(mesh, degree)
    op = LaplaceOperator(dofs, dtype=dtype)
    return mesh, dofs, op


def test_vmult_cartesian(jmesh):
    _, dofs, op = _problem()
    sl = ShardedLattice(op, None, jmesh)
    u = _rand(dofs.n_dofs)
    y = sl.unpad(sl.vmult(sl.pad(u)))
    np.testing.assert_allclose(np.asarray(y), np.asarray(op.vmult(u)),
                               atol=1e-12)
    # real halos were exchanged (band did not fit in one shard)
    assert sl._hw_Kz > 0


def test_vmult_kershaw_merged(jmesh):
    _, dofs, op = _problem(transform=kershaw_transform(0.3, 0.3))
    assert op.coeff is not None  # merged deformed-geometry path
    sl = ShardedLattice(op, None, jmesh)
    u = _rand(dofs.n_dofs)
    y = sl.unpad(sl.vmult(sl.pad(u)))
    np.testing.assert_allclose(np.asarray(y), np.asarray(op.vmult(u)),
                               atol=1e-11)


@pytest.mark.parametrize("n_overlap,weighting", [(1, "symm"), (2, "post")])
def test_fdm_smoother(jmesh, n_overlap, weighting):
    _, dofs, op = _problem()
    asm = ASMPreconditioner(dofs, n_overlap=n_overlap,
                            weighting_type=weighting, dtype=op.dtype)
    sl = ShardedLattice(op, asm, jmesh)
    r = _rand(dofs.n_dofs, seed=1)
    y = sl.unpad(sl.smoother_vmult(sl.pad(r)))
    np.testing.assert_allclose(np.asarray(y), np.asarray(asm.vmult(r)),
                               atol=1e-12)


@pytest.mark.parametrize("n_overlap", [1, 2])
def test_fused_step_cartesian(jmesh, n_overlap):
    """One fused Chebyshev-FDM smoother step, sharded vs single-device."""
    _, dofs, op = _problem()
    asm = ASMPreconditioner(dofs, n_overlap=n_overlap, weighting_type="symm",
                            dtype=op.dtype)
    ev = EigenvalueInfo(1.5, 1.8, 0)
    cheb_ref = ChebyshevPreconditioner(
        op.vmult_traceable, asm.vmult_traceable, dofs.n_dofs, degree=3,
        eigenvalues=ev)
    sl = ShardedLattice(op, asm, jmesh)
    cheb_sh = ChebyshevPreconditioner(
        sl.vmult_traceable, sl.smoother_traceable, sl.n_padded, degree=3,
        eigenvalues=ev)
    b = _rand(dofs.n_dofs, seed=2)
    x = _rand(dofs.n_dofs, seed=3)
    # constrained rows of b/x zero so identity rows do not differ by padding
    free = np.asarray(~dofs.boundary_mask)
    b = jnp.asarray(np.asarray(b) * free)
    x = jnp.asarray(np.asarray(x) * free)
    y_ref = cheb_ref.step(x, b)
    step_sh = jax.jit(cheb_sh.step)
    y_sh = sl.unpad(step_sh(sl.pad(x), sl.pad(b)))
    np.testing.assert_allclose(np.asarray(y_sh), np.asarray(y_ref), atol=1e-11)


def test_fused_step_kershaw(jmesh):
    """Chebyshev-Jacobi step on the deformed (merged) operator."""
    _, dofs, op = _problem(transform=kershaw_transform(0.3, 0.3))
    dinv = op.compute_inverse_diagonal()
    ev = EigenvalueInfo(1.2, 1.44, 0)
    cheb_ref = ChebyshevPreconditioner(
        op.vmult_traceable, lambda r: dinv * r, dofs.n_dofs, degree=3,
        eigenvalues=ev)
    sl = ShardedLattice(op, None, jmesh)
    dinv_pad = sl.pad(dinv)  # pad rows: M(r)=0 there, matching r=0
    cheb_sh = ChebyshevPreconditioner(
        sl.vmult_traceable, lambda r: dinv_pad * r, sl.n_padded, degree=3,
        eigenvalues=ev)
    free = np.asarray(~dofs.boundary_mask)
    b = jnp.asarray(np.asarray(_rand(dofs.n_dofs, seed=4)) * free)
    x = jnp.asarray(np.asarray(_rand(dofs.n_dofs, seed=5)) * free)
    y_ref = cheb_ref.step(x, b)
    y_sh = sl.unpad(jax.jit(cheb_sh.step)(sl.pad(x), sl.pad(b)))
    np.testing.assert_allclose(np.asarray(y_sh), np.asarray(y_ref), atol=1e-11)


def test_transfer_sharded_both_levels(jmesh):
    """p-transfer with both levels z-sharded: equals the unsharded transfer."""
    mesh = StructuredMesh(3, (4, 4, 6))
    dofs_c = DofHandler(mesh, 2)
    dofs_f = DofHandler(mesh, 4)
    op_c = LaplaceOperator(dofs_c, dtype=jnp.float64)
    op_f = LaplaceOperator(dofs_f, dtype=jnp.float64)
    t = TwoLevelTransfer(dofs_c, dofs_f)
    sl_c = ShardedLattice(op_c, None, jmesh)
    sl_f = ShardedLattice(op_f, None, jmesh)
    st = ShardedTransfer(t, sl_f, coarse_sl=sl_c)
    uc = _rand(dofs_c.n_dofs, seed=6)
    rf = _rand(dofs_f.n_dofs, seed=7)
    np.testing.assert_allclose(
        np.asarray(sl_f.unpad(st.prolongate(sl_c.pad(uc)))),
        np.asarray(t.prolongate(uc)), atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(sl_c.unpad(st.restrict(sl_f.pad(rf)))),
        np.asarray(t.restrict(rf)), atol=1e-12)


def test_transfer_replicated_coarse(jmesh):
    """P7: coarse level replicated on all devices (sub-communicator analog)."""
    mesh = StructuredMesh(3, (4, 4, 6))
    dofs_c = DofHandler(mesh, 1)
    dofs_f = DofHandler(mesh, 4)
    op_f = LaplaceOperator(dofs_f, dtype=jnp.float64)
    t = TwoLevelTransfer(dofs_c, dofs_f)
    sl_f = ShardedLattice(op_f, None, jmesh)
    st = ShardedTransfer(t, sl_f, coarse_dofs=dofs_c)
    uc = _rand(dofs_c.n_dofs, seed=8)
    rf = _rand(dofs_f.n_dofs, seed=9)
    np.testing.assert_allclose(
        np.asarray(sl_f.unpad(st.prolongate(uc))),
        np.asarray(t.prolongate(uc)), atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(st.restrict(sl_f.pad(rf))),
        np.asarray(t.restrict(rf)), atol=1e-12)


@pytest.mark.slow
def test_sharded_mg_iteration_parity(jmesh):
    """2-level p-MG (replicated coarse, sharded fine) preserves CG counts."""
    from dealii_asm.precond.multigrid import DirectCoarseSolver, Multigrid
    from dealii_asm.solvers.krylov import ReductionControl, cg

    mesh = StructuredMesh(3, (4, 4, 6))
    dofs_c = DofHandler(mesh, 2)
    dofs_f = DofHandler(mesh, 4)
    op_c = LaplaceOperator(dofs_c, dtype=jnp.float64)
    op_f = LaplaceOperator(dofs_f, dtype=jnp.float64)
    asm_f = ASMPreconditioner(dofs_f, n_overlap=1, weighting_type="symm",
                              dtype=jnp.float64)
    t = TwoLevelTransfer(dofs_c, dofs_f)
    coarse = DirectCoarseSolver(dofs_c)
    ev = EigenvalueInfo(1.7, 2.05, 0)

    # single-device reference
    cheb_ref = ChebyshevPreconditioner(
        op_f.vmult_traceable, asm_f.vmult_traceable, dofs_f.n_dofs, degree=1,
        eigenvalues=ev)
    mg_ref = Multigrid([None, op_f.vmult_traceable], [cheb_ref], [t],
                       coarse.vmult)

    # sharded twin: fine level explicit-halo, coarse level replicated (P7)
    sl_f = ShardedLattice(op_f, asm_f, jmesh)
    st = ShardedTransfer(t, sl_f, coarse_dofs=dofs_c)
    cheb_sh = ChebyshevPreconditioner(
        sl_f.vmult_traceable, sl_f.smoother_traceable, sl_f.n_padded, degree=1,
        eigenvalues=ev)
    mg_sh = Multigrid([None, sl_f.vmult_traceable], [cheb_sh], [st],
                      coarse.vmult)

    rng = np.random.default_rng(10)
    b = jnp.asarray(rng.standard_normal(dofs_f.n_dofs)
                    * np.asarray(~dofs_f.boundary_mask))
    ctrl = ReductionControl(100, 1e-16, 1e-8)
    res_ref = cg(op_f.vmult, b, M=mg_ref.vmult, control=ctrl)

    b_pad = sl_f.pad(b)
    res_sh = cg(sl_f.vmult, b_pad, M=mg_sh.vmult,
                control=ReductionControl(100, 1e-16, 1e-8))
    assert res_sh.n_iterations == res_ref.n_iterations
    np.testing.assert_allclose(
        np.asarray(sl_f.unpad(res_sh.x)), np.asarray(res_ref.x),
        rtol=1e-8, atol=1e-10)


def test_unstructured_ball_sharded(jmesh):
    """Gather-path vmult + ASM on the ball under XLA SPMD sharding: sharded
    DoF vectors must reproduce the single-device result (the unstructured
    paths have no lattice layout — P1 domain decomposition rides the
    partitioner's gather/scatter collectives)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dealii_asm.fem.general_dofs import GeneralDofHandler
    from dealii_asm.mesh.unstructured import hyper_ball_balanced
    from dealii_asm.ops.laplace_general import GeneralLaplaceOperator
    from dealii_asm.precond.asm_general import GeneralASMPreconditioner

    mesh = hyper_ball_balanced(3).refine()
    dh = GeneralDofHandler(mesh, 2)
    op = GeneralLaplaceOperator(dh, dtype=jnp.float64)
    asm = GeneralASMPreconditioner(dh, weighting_type="symm",
                                   dtype=jnp.float64)
    n = dh.n_dofs
    pad = -n % 8
    x = _rand(n + pad)

    def step(v):
        u = v[:n]
        r = asm.vmult_traceable(op.vmult_traceable(u))
        return jnp.concatenate([r, jnp.zeros(pad, r.dtype)])

    ref = np.asarray(jax.jit(step)(x))[:n]
    sh = NamedSharding(jmesh, P(jmesh.axis_names[0]))
    xs = jax.device_put(x, sh)
    out = np.asarray(jax.jit(step, in_shardings=sh)(xs))[:n]
    np.testing.assert_allclose(out, ref, atol=1e-11)


def test_sharded_smoother_setup_compiles_few_programs(jmesh):
    """The sharded Chebyshev smoother estimates its eigenvalues through the
    jitted applies: an un-jitted shard_map called from the host loop runs op
    by op and compiles every primitive (1536 programs on this lattice)."""
    from dealii_asm.parallel.driver import _sharded_smoother

    _, dofs, op = _problem(dtype=jnp.float32)
    asm = ASMPreconditioner(dofs, n_overlap=1, weighting_type="symm",
                            dtype=jnp.float32)
    sl = ShardedLattice(op, asm, jmesh)
    params = {"type": "Chebyshev", "degree": 1,
              "preconditioner": {"type": "FDM"}}
    n_compiles = []

    def count(event, duration, **kw):
        if event == "/jax/core/compile/backend_compile_duration":
            n_compiles.append(duration)

    jax.monitoring.register_event_duration_secs_listener(count)
    try:
        sm = _sharded_smoother(sl, params)
    finally:
        jax.monitoring.unregister_event_duration_listener(count)
    assert len(n_compiles) < 100
    assert 0.0 < sm.eigenvalues.max_eigenvalue_estimate < 10.0
