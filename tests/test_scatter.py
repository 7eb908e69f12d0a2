"""TransposeScatter (ops/scatter.py) vs the .at[].add oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from dealii_asm.ops.scatter import TransposeScatter


def _oracle(v, idx, n):
    vpad = jnp.zeros(n + 1)
    return vpad.at[np.minimum(idx.reshape(-1), n)].add(v.reshape(-1))[:-1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_table(seed):
    rng = np.random.default_rng(seed)
    n, S = 97, 431
    idx = rng.integers(0, n, size=(S,))
    v = rng.standard_normal(S)
    ts = TransposeScatter(idx, n)
    np.testing.assert_allclose(np.asarray(ts.apply(jnp.asarray(v))),
                               np.asarray(_oracle(jnp.asarray(v), idx, n)),
                               rtol=1e-13, atol=1e-13)


def test_invalid_entries_dropped():
    rng = np.random.default_rng(3)
    n = 40
    idx = rng.integers(0, n + 1, size=(17, 9))  # n == pad target
    v = rng.standard_normal(idx.shape)
    ts = TransposeScatter(idx, n)
    np.testing.assert_allclose(np.asarray(ts.apply(jnp.asarray(v))),
                               np.asarray(_oracle(jnp.asarray(v), idx, n)),
                               rtol=1e-13, atol=1e-13)


def test_untouched_dofs_zero():
    idx = np.array([3, 3, 3, 7])
    v = np.array([1.0, 2.0, 4.0, 8.0])
    ts = TransposeScatter(idx, 10)
    out = np.asarray(ts.apply(jnp.asarray(v)))
    expect = np.zeros(10)
    expect[3], expect[7] = 7.0, 8.0
    np.testing.assert_allclose(out, expect)


def test_skewed_valence():
    # one hot dof collects hundreds of slots; most collect one
    rng = np.random.default_rng(4)
    n = 300
    idx = np.concatenate([np.full(257, 5), np.arange(n)])
    v = rng.standard_normal(idx.shape[0])
    ts = TransposeScatter(idx, n)
    assert ts.K == 258
    np.testing.assert_allclose(np.asarray(ts.apply(jnp.asarray(v))),
                               np.asarray(_oracle(jnp.asarray(v), idx, n)),
                               rtol=1e-12, atol=1e-12)


def test_dtype_cast():
    idx = np.array([0, 1, 1, 2])
    v = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    ts = TransposeScatter(idx, 4)
    out = ts.apply(jnp.asarray(v), dtype=jnp.float64)
    assert out.dtype == jnp.float64
    np.testing.assert_allclose(np.asarray(out), [1.0, 5.0, 4.0, 0.0])


def test_apply_dd_matches_f64():
    rng = np.random.default_rng(5)
    n, S = 211, 997
    idx = rng.integers(0, n, size=(S,))
    v64 = rng.standard_normal(S)
    vh = v64.astype(np.float32)
    vl = (v64 - vh.astype(np.float64)).astype(np.float32)
    ts = TransposeScatter(idx, n)
    oh, ol = ts.apply_dd(jnp.asarray(vh), jnp.asarray(vl))
    got = np.asarray(oh, np.float64) + np.asarray(ol, np.float64)
    ref = np.zeros(n)
    np.add.at(ref, idx, v64)
    scale = np.abs(ref).max() + 1.0
    assert np.abs(got - ref).max() < 1e-13 * scale


@pytest.mark.parametrize("variant", ["full", "ranked", "2d"])
def test_variants_match(variant):
    rng = np.random.default_rng(6)
    n = 157
    idx = rng.integers(0, n + 1, size=(61, 7))
    v = rng.standard_normal(idx.shape)
    ts = TransposeScatter(idx, n)
    np.testing.assert_allclose(
        np.asarray(ts.apply(jnp.asarray(v), variant=variant)),
        np.asarray(_oracle(jnp.asarray(v), idx, n)), rtol=1e-13, atol=1e-13)
