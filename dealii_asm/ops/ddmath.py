"""Double-single ("dd") arithmetic: ~47-bit-accurate values as pairs of f32.

The outer-Krylov matvec of the mixed-precision architecture (P8, reference
/root/reference/element_centered_preconditioners_01.cc:780-792) only needs
enough mantissa to see residuals at rel. 1e-5 through the operator's
conditioning (κ ≈ 1/h²: ~33 bits at 17M DoFs); a double-single
representation (hi + lo, both f32, |lo| ≤ ulp(hi)/2 ≈ 2⁻²⁴|hi|) provides
~47 bits using only f32 adds and multiplies.  The f64 applies of the
Laplace operators are native f64; this double-single path stays reachable
only for its tests (``kernel="dd"`` / ``"lanes-dd"``) until it is deleted,
and is not a user option.

All error-free transformations here are FMA-free (Dekker/Veltkamp): products
are made exact by splitting both operands into ≤12-bit-significand halves
(12·2 ≤ 24 = f32 mantissa ⇒ each partial product is exact in f32), and sums
by the Knuth TwoSum.  They hold only if the compiler evaluates each
operation as written: a backend that reassociates, or that contracts a
product into a following TwoSum's addition, breaks them.

References: Dekker 1971 (A floating-point technique for extending the
available precision); Hida/Li/Bailey 2001 (double-double library); Thall 2006
(extended-precision on GPUs).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# XLA:CPU's fusion emitter silently degrades the error-free transforms:
# compiled dd results deviate ~3e-8 (plain-f32 level) from the identical
# arithmetic run per-op (eager), which is dd-exact to ~1e-14.  Bisected on a
# 2-term minimal repro (tests/test_xla_cpu_fusion_exactness.py): the emitted
# HLO is complete, the LLVM kernels carry no fast-math flags, no FMA
# contraction and no f64 promotion — yet `--xla_disable_hlo_passes=fusion`
# restores exactness, so the defect sits in the CPU fusion emitter itself.
# optimization_barrier does NOT help.  CPU callers that need dd-exact
# results compile their jit with these options.
EXACT_EFT_CPU_COMPILER_OPTIONS = {"xla_disable_hlo_passes": "fusion"}

_SPLIT = 4097.0  # 2^12 + 1 (Veltkamp constant for a 12-bit split of f32)


def split12(a):
    """Veltkamp split: a = hi + lo with hi carrying ≤12 significand bits.

    Exact for all finite a away from overflow (|a| < 2^115 here — FEM scale)."""
    c = _SPLIT * a
    big = c - a
    hi = c - big
    return hi, a - hi


def two_sum(a, b):
    """Knuth TwoSum: s + e == a + b exactly (6 flops, branch-free)."""
    s = a + b
    bv = s - a
    e = (a - (s - bv)) + (b - bv)
    return s, e


def quick_two_sum(a, b):
    """Fast TwoSum, requires |a| >= |b| (3 flops)."""
    s = a + b
    return s, b - (s - a)


def two_prod(a, b, ahi, alo, bhi, blo):
    """Dekker TwoProd with pre-split operands: p + e == a·b exactly."""
    p = a * b
    e = (((ahi * bhi - p) + ahi * blo) + alo * bhi) + alo * blo
    return p, e


def dd_from_f64(x64):
    """f64 array → (hi, lo) f32 pair (3 emulated-f64 ops per element)."""
    hi = x64.astype(jnp.float32)
    lo = (x64 - hi.astype(jnp.float64)).astype(jnp.float32)
    return hi, lo


def dd_to_f64(hi, lo):
    return hi.astype(jnp.float64) + lo.astype(jnp.float64)


def dd_add(ah, al, bh, bl):
    """(ah,al) + (bh,bl), ~2⁻⁴⁷-accurate sloppy variant (11 flops)."""
    s, e = two_sum(ah, bh)
    e = e + (al + bl)
    return quick_two_sum(s, e)


def dd_scalar_split(s64):
    """f64 scalar → (sh, sl, shh, shl) f32 scalars for dd_axpy (trace-safe)."""
    sh = s64.astype(jnp.float32)
    sl = (s64 - sh.astype(jnp.float64)).astype(jnp.float32)
    shh, shl = split12(sh)
    return sh, sl, shh, shl


def dd_axpy(sh, sl, shh, shl, bh, bl, ah, al):
    """(ah,al) + s·(bh,bl) with a pre-split dd scalar s — the CG update
    kernel: ~26 native f32 flops/element vs ~3 emulated-f64 ops (measured
    2.5x on the 17M-DoF axpys; the f64 CG state itself is what forces every
    other vector op into emulation, hence the all-dd outer loop)."""
    bhh, bhl = split12(bh)
    p = sh * bh
    e = (((shh * bhh - p) + shh * bhl) + shl * bhh) + shl * bhl
    e = e + (sh * bl + sl * bh)
    s, e2 = two_sum(ah, p)
    return quick_two_sum(s, e2 + (al + e))


def split_table_np(d: np.ndarray):
    """Host-side dd split of an f64 coefficient table: returns f32 arrays
    (dh, dl, dhh, dhl) with d ≈ dh + dl and dh = dhh + dhl (Veltkamp)."""
    dh = d.astype(np.float32)
    dl = (d - dh.astype(np.float64)).astype(np.float32)
    c = np.float32(_SPLIT) * dh
    big = c - dh
    dhh = c - big
    dhl = dh - dhh
    return dh, dl, dhh, dhl
