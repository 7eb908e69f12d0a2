"""Multi-device unstructured path (parallel/general_sharded.py) equality on
the virtual 8-device CPU mesh — the P1/P3-for-every-mesh-family contract
(VERDICT r4 missing #5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from dealii_asm.fem.general_dofs import GeneralDofHandler
from dealii_asm.mesh.unstructured import hyper_ball_balanced
from dealii_asm.ops.laplace_general import GeneralLaplaceOperator
from dealii_asm.parallel.general_sharded import (GeneralPartition,
                                                     ShardedGeneralOperator)


def _mesh(n_dev):
    devs = jax.devices()[:n_dev]
    return Mesh(np.array(devs), ("dev",))


class TestPartition:
    def test_roundtrip(self):
        mesh = hyper_ball_balanced(3)
        dh = GeneralDofHandler(mesh, 2)
        part = GeneralPartition(dh, 4)
        rng = np.random.default_rng(0)
        u = jnp.asarray(rng.standard_normal(dh.n_dofs))
        np.testing.assert_array_equal(np.asarray(part.unpad(part.pad(u))),
                                      np.asarray(u))

    def test_owner_blocked(self):
        mesh = hyper_ball_balanced(3).refine()
        dh = GeneralDofHandler(mesh, 2)
        part = GeneralPartition(dh, 8)
        assert part.n_own.sum() == dh.n_dofs
        # every cell's dofs resolve to valid local slots on its device
        assert int(np.asarray(part.gather_tab).max()) <= part.n_loc


class TestShardedOperator:
    @pytest.mark.parametrize("n_dev,degree,dtype", [
        (4, 2, jnp.float64),
        (8, 2, jnp.float32),
    ])
    def test_vmult_matches_single_device(self, n_dev, degree, dtype):
        mesh = hyper_ball_balanced(3).refine()
        dh = GeneralDofHandler(mesh, degree)
        op = GeneralLaplaceOperator(dh, dtype=dtype)
        part = GeneralPartition(dh, n_dev)
        sop = ShardedGeneralOperator(op, part, _mesh(n_dev))
        rng = np.random.default_rng(1)
        u = jnp.asarray(rng.standard_normal(dh.n_dofs), dtype)
        ref = np.asarray(op.vmult(u), np.float64)
        got = np.asarray(sop.vmult_global(u), np.float64)
        tol = 1e-11 if dtype == jnp.float64 else 2e-5
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=tol * np.abs(ref).max())


class TestShardedASM:
    @pytest.mark.parametrize("wt", ["symm", "post", "ras"])
    def test_matches_single_device(self, wt):
        from dealii_asm.precond.asm_general import GeneralASMPreconditioner

        mesh = hyper_ball_balanced(3).refine()
        dh = GeneralDofHandler(mesh, 2)
        asm = GeneralASMPreconditioner(dh, n_overlap=1, weighting_type=wt,
                                       dtype=jnp.float32)
        part = GeneralPartition(dh, 8)
        from dealii_asm.parallel.general_sharded import ShardedGeneralASM

        sasm = ShardedGeneralASM(asm, part, _mesh(8))
        rng = np.random.default_rng(2)
        x = jnp.asarray(rng.standard_normal(dh.n_dofs), jnp.float32)
        ref = np.asarray(asm.vmult(x), np.float64)
        got = np.asarray(sasm.vmult_global(x), np.float64)
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=3e-5 * np.abs(ref).max())


class TestShardedTransfer:
    def test_matches_single_device(self):
        from dealii_asm.ops.transfer_general import GeneralTwoLevelTransfer
        from dealii_asm.parallel.general_sharded import (
            ShardedGeneralTransfer)

        mesh = hyper_ball_balanced(3)
        dh_c = GeneralDofHandler(mesh, 1)
        dh_f = GeneralDofHandler(mesh, 2)
        tr = GeneralTwoLevelTransfer(dh_c, dh_f, dtype=jnp.float32)
        part = GeneralPartition(dh_f, 4)
        st = ShardedGeneralTransfer(tr, part, _mesh(4))
        rng = np.random.default_rng(3)
        uc = jnp.asarray(rng.standard_normal(dh_c.n_dofs), jnp.float32)
        rf = jnp.asarray(rng.standard_normal(dh_f.n_dofs), jnp.float32)

        ref_p = np.asarray(tr.prolongate(uc), np.float64)
        got_p = np.asarray(part.unpad(st.prolongate_blocked(uc)), np.float64)
        np.testing.assert_allclose(got_p, ref_p, rtol=0,
                                   atol=3e-6 * (np.abs(ref_p).max() + 1))

        ref_r = np.asarray(tr.restrict(rf), np.float64)
        got_r = np.asarray(st.restrict_blocked(part.pad(rf)), np.float64)
        np.testing.assert_allclose(got_r, ref_r, rtol=0,
                                   atol=3e-6 * (np.abs(ref_r).max() + 1))
