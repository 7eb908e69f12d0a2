"""dealii_asm — a JAX matrix-free high-order FEM multigrid framework.

Rebuilds the capabilities of peterrum/dealii-asm (cache-optimized additive-Schwarz
multigrid smoothers for high-order FEM) as an idiomatic JAX/XLA framework:

- sum-factorized tensor-product Laplace operators over batched cells (``ops.laplace``),
- element-centric / vertex-patch additive & restricted Schwarz smoothers with
  fast-diagonalization (FDM) local solves (``precond.asm``),
- Chebyshev (1st/4th kind) and relaxation smoothing with Lanczos/power-iteration
  eigenvalue estimation (``solvers.chebyshev``),
- hybrid geometric/polynomial multigrid V-cycles (``precond.multigrid``),
- Krylov solvers (CG/FCG/GMRES/FGMRES/BiCGStab) (``solvers.krylov``),
- structured meshes with Kershaw / anisotropic / sinusoidal deformations (``mesh``),
- SPMD sharding of the cell-batch axis over a jax device mesh (``parallel``).

Reference: /root/reference (peterrum/dealii-asm); see SURVEY.md for the layer map.
"""

__version__ = "0.1.0"

import sys as _sys

# tracing a Pallas kernel nested inside the whole-V-cycle jit (recursive
# level descent × jit trace × pl.when cond traces) exceeds CPython's default
# 1000-frame recursion limit
if _sys.getrecursionlimit() < 10000:
    _sys.setrecursionlimit(10000)

# Large-array setup performance: on this platform first-touch page faults run
# at ~20 MB/s (vs ~50 GB/s warm), and glibc mmap()s every allocation above
# 128 KB and munmap()s it on free — so EVERY multi-hundred-MB NumPy temporary
# in the host setup layer pays the first-touch penalty again (measured: a
# single 786 MB broadcast add took 93 s; 0.1 s once pages are warm).  Raising
# M_MMAP_THRESHOLD keeps big blocks on the brk heap, where freed pages are
# reused warm across temporaries (measured: 64³ Q4 operator+smoother setup
# 744 s -> tens of seconds).
try:  # glibc only; harmless elsewhere
    import ctypes as _ctypes

    _libc = _ctypes.CDLL(None, use_errno=True)
    _M_MMAP_THRESHOLD = -3
    _libc.mallopt(_M_MMAP_THRESHOLD, 1 << 31)
except Exception:  # pragma: no cover - non-glibc platforms
    pass
