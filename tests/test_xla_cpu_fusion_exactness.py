"""Minimal repro of the XLA:CPU fusion-emitter reassociation hazard.

The double-single error-free transforms (TwoSum/QTwoSum chains on split
coefficient tables) are dd-exact per-op, but XLA:CPU's fusion-kernel
emitter reassociates/contracts somewhere below the dumped IR surfaces,
shifting results by ~1e-7.  The fix is compiling dd-exact CPU jits with
``xla_disable_hlo_passes=fusion`` (ddmath.EXACT_EFT_CPU_COMPILER_OPTIONS).
This test pins the contract that matters: under those compiler options the
EFT chain is bit-exact against the sequential (numpy) evaluation.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dealii_asm.ops.ddmath import EXACT_EFT_CPU_COMPILER_OPTIONS

f32 = np.float32


def _two_sum_np(a, b):
    s = a + b
    bv = s - a
    return s, (a - (s - bv)) + (b - bv)


def _eft_chain_np(x, y, c1, c2):
    # two products + one TwoSum + one QTwoSum — the 2-term minimal repro
    p1 = f32(c1 * x)
    p2 = f32(c2 * y)
    s, e = _two_sum_np(p1, p2)
    t = f32(s + e)
    return t, f32(e - (t - s))


def _eft_chain_jax(x, y, c1, c2):
    p1 = c1 * x
    p2 = c2 * y
    s = p1 + p2
    bv = s - p1
    e = (p1 - (s - bv)) + (p2 - bv)
    t = s + e
    return t, e - (t - s)


@pytest.mark.skipif(jax.default_backend() != "cpu",
                    reason="CPU fusion-emitter contract")
def test_eft_chain_bit_exact_with_fusion_disabled():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((64, 128)).astype(f32)
    y = rng.standard_normal((64, 128)).astype(f32)
    c1 = rng.standard_normal((1, 128)).astype(f32)
    c2 = rng.standard_normal((1, 128)).astype(f32)

    fn = jax.jit(_eft_chain_jax,
                 compiler_options=EXACT_EFT_CPU_COMPILER_OPTIONS)
    th, tl = fn(jnp.asarray(x), jnp.asarray(y), jnp.asarray(c1),
                jnp.asarray(c2))
    rh, rl = _eft_chain_np(x, y, c1, c2)
    # bit-exact: the whole point of disabling the fusion pass
    np.testing.assert_array_equal(np.asarray(th), rh)
    np.testing.assert_array_equal(np.asarray(tl), rl)
