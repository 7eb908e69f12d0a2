"""Krylov solvers with deal.II-compatible iteration semantics.

The reference drives deal.II's SolverCG / SolverFlexibleCG / SolverGMRES /
SolverFGMRES / SolverBicgstab with a ReductionControl
(/root/reference/element_centered_preconditioners_01.cc:108-263;
/root/reference/outer_solver_01.likwid.cc:140-232).  Golden-output parity
requires the same convergence-control and residual-monitoring conventions:

- ReductionControl: converged when ||r|| < max(abs_tol, reduce · ||r_0||),
  with the check at step 0 on the initial residual;
- CG monitors the unpreconditioned 2-norm of the residual and exposes the
  Lanczos tridiagonal eigenvalues from its alpha/beta coefficients (used by
  Chebyshev eigenvalue estimation);
- GMRES defaults to RIGHT preconditioning with classical Gram-Schmidt
  (the driver's defaults at element_centered_preconditioners_01.cc:170-177),
  monitoring the true-residual estimate from the Givens recurrence.

Host-side loops orchestrate jitted device kernels; fully-jitted fixed-iteration
variants for benchmarking live alongside.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np


@dataclass
class SolveResult:
    x: object
    n_iterations: int
    converged: bool
    residuals: list = field(default_factory=list)
    tridiag_eigenvalues: np.ndarray | None = None


class ReductionControl:
    """deal.II ReductionControl: success when value < max(tolerance, reduce·initial)."""

    def __init__(self, max_steps=1000, tolerance=1e-10, reduce=1e-2):
        self.max_steps = max_steps
        self.tolerance = tolerance
        self.reduce = reduce
        self.initial = None
        self.history = []

    def check(self, step: int, value: float) -> str:
        value = float(value)
        self.history.append(value)
        if step == 0:
            self.initial = value
        if value <= self.tolerance or (self.initial is not None and value < self.reduce * self.initial):
            return "success"
        if step >= self.max_steps:
            return "failure"
        return "iterate"


class IterationNumberControl:
    """deal.II IterationNumberControl: run exactly max_steps unless below tolerance."""

    def __init__(self, max_steps=100, tolerance=1e-10):
        self.max_steps = max_steps
        self.tolerance = tolerance
        self.history = []

    def check(self, step: int, value: float) -> str:
        value = float(value)
        self.history.append(value)
        if value <= self.tolerance:
            return "success"
        if step >= self.max_steps:
            return "success"  # IterationNumberControl treats reaching max as success
        return "iterate"


def _identity(x):
    return x


def _dot(a, b) -> float:
    """Inner product with float64 accumulation when available.

    float32 reductions over millions of entries carry O(N·eps) error on
    accelerators, which destroys Krylov orthogonality/recurrences at scale
    (observed: GMRES true residual stuck at 0.18 relative after 28 f32
    iterations on 2.1M DoFs).  Upcasting the reduction restores the
    reference's double-precision outer-solve accuracy (P8) at bandwidth cost.
    """
    import jax

    if jax.config.jax_enable_x64 and a.dtype != jnp.float64:
        return float(jnp.vdot(a.astype(jnp.float64), b.astype(jnp.float64)))
    return float(jnp.vdot(a, b))


def _norm(a) -> float:
    import jax

    if jax.config.jax_enable_x64 and a.dtype != jnp.float64:
        return float(jnp.linalg.norm(a.astype(jnp.float64)))
    return float(jnp.linalg.norm(a))


def _dot_twostage(a, c):
    """Layout-safe in-jit inner product (two-stage reshaped reduction).

    A flat full-length reduce consuming the operator-apply output makes XLA
    pick a packed layout for the whole vector and insert a relayout copy per
    Krylov iteration (~190 ms per dot at 17M f64 — measured: 5×(vmult+vdot)
    1297 ms vs 5×vmult 346 ms).  Reshaping the elementwise product to
    (rows, 8192) and chaining two partial sums keeps the vector layout
    untouched: 5×(vmult+two-stage dot) = 344 ms, i.e. the dots become free.
    Summation order differs from vdot only in grouping (same dtype, ~1e-9
    relative agreement at 17M f64).
    """
    p = a * c
    n = p.shape[0]
    K = 8192
    if n <= 2 * K:
        return p.sum()
    pad = (-n) % K
    if pad:
        p = jnp.concatenate([p, jnp.zeros((pad,), p.dtype)])
    return p.reshape(-1, K).sum(0).sum()


def _device_traceable(fn) -> bool:
    """True when a bound operator/preconditioner method may be traced into a
    jitted device loop.  Host-side oracles (e.g. DomainPreconditioner's scipy
    sparse-LU solve) set ``device_traceable = False`` on their class."""
    obj = getattr(fn, "__self__", None)
    return getattr(obj, "device_traceable", True) if obj is not None else True


_CG_DEVICE_CACHE: dict = {}


def _cg_device(A, b, M, control: ReductionControl, x0) -> SolveResult:
    """CG as ONE jitted device program (lax.while_loop control flow).

    Same iteration/convergence semantics as the host loop below — same
    operation order, ||r|| monitoring and ReductionControl checks — but with
    zero per-iteration host round-trips.  Each host scalar pull drains the
    device pipeline; the host loop pays three per iteration (pAp, ||r||,
    r·z)."""
    import jax
    from jax import lax

    key = (A, M, control.tolerance, control.reduce, control.max_steps,
           b.shape, str(b.dtype), x0 is not None)
    fns = _CG_DEVICE_CACHE.get(key)
    if fns is None:
        # bounded cache: keys hold strong refs to operator/preconditioner
        # objects — evict oldest entries so long config sweeps don't retain
        # every problem's device tables
        while len(_CG_DEVICE_CACHE) >= 8:
            _CG_DEVICE_CACHE.pop(next(iter(_CG_DEVICE_CACHE)))
        tol, red, max_steps = (control.tolerance, control.reduce,
                               control.max_steps)
        use64 = jax.config.jax_enable_x64

        def dot(a, c):
            if use64 and a.dtype != jnp.float64:
                return _dot_twostage(a.astype(jnp.float64),
                                     c.astype(jnp.float64))
            return _dot_twostage(a, c)

        def norm(a):
            return jnp.sqrt(dot(a, a))

        def init_impl(x, r):
            res0 = norm(r)
            hist = jnp.zeros(max_steps + 1, res0.dtype).at[0].set(res0)
            init_done = res0 <= tol  # step-0 check (res < red·res0 is false)
            z = M(r)
            p = z
            rz = dot(r, z)
            return (x, r, p, rz, jnp.int32(0), res0, res0, init_done,
                    init_done, hist)

        def chunk_impl(s, it_hi):
            # run until convergence OR the chunk's iteration ceiling: one
            # unbounded while_loop dispatch can run for minutes; the host
            # re-dispatches bounded chunks until done (one scalar fetch
            # per chunk)
            def cond(s):
                return (~s[7]) & (s[4] < it_hi)

            def body(s):
                x, r, p, rz, it, res0, res, done, conv, hist = s
                Ap = A(p)
                pAp = dot(p, Ap)
                breakdown = pAp == 0.0
                alpha = jnp.where(breakdown, 0.0, rz / jnp.where(
                    breakdown, 1.0, pAp))
                # scalars come from f64 dots; cast to the vector dtype as the
                # host loop's weak python floats would (no silent promotion)
                al = alpha.astype(x.dtype)
                xn = jnp.where(breakdown, x, x + al * p)
                rn = jnp.where(breakdown, r, r - al * Ap)
                resn = jnp.where(breakdown, res, norm(rn))
                itn = it + 1
                hist = hist.at[itn].set(resn)
                success = (resn <= tol) | (resn < red * res0)
                failure = itn >= max_steps
                donen = breakdown | success | failure

                def cont(args):
                    rn, p, rz = args
                    z = M(rn)
                    rzn = dot(rn, z)
                    beta = (rzn / rz).astype(z.dtype)
                    return z + beta * p, rzn

                pn, rzn = lax.cond(donen, lambda a: (a[1], a[2]), cont,
                                   (rn, p, rz))
                return (xn, rn, pn, rzn, itn, res0, resn, donen,
                        success & ~breakdown, hist)

            return lax.while_loop(cond, body, s)

        from ..utils.jitutils import jit_hoist_consts

        sds = jax.ShapeDtypeStruct(b.shape, b.dtype)
        init = jit_hoist_consts(init_impl, sds, sds)
        state_sds = jax.eval_shape(init_impl, sds, sds)
        chunk = jit_hoist_consts(chunk_impl, state_sds,
                                 jax.ShapeDtypeStruct((), jnp.int32))
        fns = (init, chunk)
        _CG_DEVICE_CACHE[key] = fns
    init, chunk = fns

    import time as _time

    x = jnp.zeros_like(b) if x0 is None else x0
    r = b - A(x) if x0 is not None else b
    state = init(x, r)
    # chunked dispatch: first chunk covers typical MG-preconditioned solves
    # in ONE dispatch/fetch; long solves adapt the chunk to ~20 s dispatches
    n_chunk, it_hi, prev_it = 32, 32, 0
    while True:
        t0 = _time.perf_counter()
        state = chunk(state, jnp.int32(it_hi))
        # ONE host round-trip per chunk for all scalars
        it, done, conv, hist = jax.device_get(
            (state[4], state[7], state[8], state[9]))
        if bool(done):
            break
        dt = _time.perf_counter() - t0
        its = int(it) - prev_it
        if its > 0:
            per_it = max(dt / its, 1e-6)
            n_chunk = max(8, min(int(20.0 / per_it),
                                 control.max_steps + 1))
        prev_it = int(it)
        it_hi = int(it) + n_chunk
    it = int(it)
    return SolveResult(state[0], it, bool(conv),
                       [float(v) for v in hist[: it + 1]])


_CG_DD_CACHE: dict = {}


def _dot_dd(ah, al, ch, cl):
    """Inner product of double-single vectors, no emulated-f64 vector pass.

    f32 products with the first-order cross terms, cascaded partial sums
    with f32 chains ≤ 16 (worst-case chain error 16·2⁻²⁴ ≈ 1e-6; the tail
    reduction runs in f64 on ~1M partials, ~0.1 ms at 17M elements).  CG's
    coefficient dots tolerate far more; the ||r|| stopping test needs the
    norm only to ~1e-3 of the threshold crossing."""
    p = ah * ch + (ah * cl + al * ch)
    K = 8192
    n = p.shape[0]
    if n <= 2 * K:
        return p.astype(jnp.float64).sum()
    pad = (-n) % K
    if pad:
        p = jnp.concatenate([p, jnp.zeros((pad,), p.dtype)])
    p = p.reshape(-1, K)
    C = 16
    padr = (-p.shape[0]) % C
    if padr:
        p = jnp.concatenate([p, jnp.zeros((padr, K), p.dtype)])
    s = p.reshape(-1, C, K).sum(1)  # f32 chains of C
    return s.astype(jnp.float64).sum(0).sum()


def _cg_device_dd(op, b, M, control: ReductionControl, x0) -> SolveResult:
    """CG with ALL vector state in double-single (hi/lo f32) pairs.

    Engages with an operator built with kernel="dd": keeping x/r/p as dd
    pairs makes every outer op f32 arithmetic (ops/ddmath.py): same ~47-bit
    state accuracy, no f64 vector pass anywhere in the loop (b is split
    once, x merged once).
    Iteration semantics identical to _cg_device (verified: same counts on
    the golden configs and the 17M headline)."""
    import jax
    from jax import lax

    from ..ops.ddmath import dd_axpy, dd_from_f64, dd_scalar_split, dd_to_f64

    key = (op, M, control.tolerance, control.reduce, control.max_steps,
           b.shape, str(b.dtype), x0 is not None)
    run = _CG_DD_CACHE.get(key)
    if run is None:
        while len(_CG_DD_CACHE) >= 8:
            _CG_DD_CACHE.pop(next(iter(_CG_DD_CACHE)))
        tol, red, max_steps = (control.tolerance, control.reduce,
                               control.max_steps)

        def norm_dd(ah, al):
            return jnp.sqrt(_dot_dd(ah, al, ah, al))

        def init_impl(xh, xl, rh, rl):
            res0 = norm_dd(rh, rl)
            hist = jnp.zeros(max_steps + 1, res0.dtype).at[0].set(res0)
            init_done = res0 <= tol
            z = M(rh)
            ph, pl = z, jnp.zeros_like(z)
            rz = _dot_dd(rh, rl, z, jnp.zeros_like(z))
            return (xh, xl, rh, rl, ph, pl, rz, jnp.int32(0), res0, res0,
                    init_done, init_done, hist)

        def chunk_impl(s, it_hi):
            # bounded chunks, as in _cg_device
            def cond(s):
                return (~s[10]) & (s[7] < it_hi)

            def body(s):
                (xh, xl, rh, rl, ph, pl, rz, it, res0, res, done, conv,
                 hist) = s
                qh, ql = op.vmult_dd(ph, pl)
                pAp = _dot_dd(ph, pl, qh, ql)
                breakdown = pAp == 0.0
                alpha = jnp.where(breakdown, 0.0, rz / jnp.where(
                    breakdown, 1.0, pAp))
                sp = dd_scalar_split(alpha)
                sn = dd_scalar_split(-alpha)
                xh2, xl2 = dd_axpy(*sp, ph, pl, xh, xl)
                rh2, rl2 = dd_axpy(*sn, qh, ql, rh, rl)
                xhn = jnp.where(breakdown, xh, xh2)
                xln = jnp.where(breakdown, xl, xl2)
                rhn = jnp.where(breakdown, rh, rh2)
                rln = jnp.where(breakdown, rl, rl2)
                resn = jnp.where(breakdown, res, norm_dd(rhn, rln))
                itn = it + 1
                hist = hist.at[itn].set(resn)
                success = (resn <= tol) | (resn < red * res0)
                failure = itn >= max_steps
                donen = breakdown | success | failure

                def cont(args):
                    rhn, rln, ph, pl, rz = args
                    z = M(rhn)
                    rzn = _dot_dd(rhn, rln, z, jnp.zeros_like(z))
                    beta = rzn / rz
                    sb = dd_scalar_split(beta)
                    pn_h, pn_l = dd_axpy(*sb, ph, pl, z, jnp.zeros_like(z))
                    return pn_h, pn_l, rzn

                phn, pln, rzn = lax.cond(
                    donen, lambda a: (a[2], a[3], a[4]), cont,
                    (rhn, rln, ph, pl, rz))
                return (xhn, xln, rhn, rln, phn, pln, rzn, itn, res0, resn,
                        donen, success & ~breakdown, hist)

            return lax.while_loop(cond, body, s)

        def merge_impl(s):
            return dd_to_f64(s[0], s[1])

        from ..utils.jitutils import jit_hoist_consts

        sds = jax.ShapeDtypeStruct(b.shape, jnp.float32)
        init = jit_hoist_consts(init_impl, sds, sds, sds, sds)
        state_sds = jax.eval_shape(init_impl, sds, sds, sds, sds)
        chunk = jit_hoist_consts(chunk_impl, state_sds,
                                 jax.ShapeDtypeStruct((), jnp.int32))
        merge = jax.jit(merge_impl)
        run = (init, chunk, merge)
        _CG_DD_CACHE[key] = run

    bh, bl = dd_from_f64(b)
    if x0 is None:
        xh = jnp.zeros_like(bh)
        xl = jnp.zeros_like(bl)
        rh, rl = bh, bl
    else:
        from ..ops.ddmath import dd_axpy as _axpy, dd_scalar_split as _split

        xh, xl = dd_from_f64(x0.astype(b.dtype))
        qh, ql = op.vmult_dd(xh, xl)
        rh, rl = _axpy(*_split(jnp.float64(-1.0)), qh, ql, bh, bl)
    init, chunk, merge = run
    import time as _time

    import jax as _jax

    state = init(xh, xl, rh, rl)
    n_chunk, it_hi, prev_it = 32, 32, 0
    while True:
        t0 = _time.perf_counter()
        state = chunk(state, jnp.int32(it_hi))
        it, done, conv, hist = _jax.device_get(
            (state[7], state[10], state[11], state[12]))
        if bool(done):
            break
        dt = _time.perf_counter() - t0
        its = int(it) - prev_it
        if its > 0:
            n_chunk = max(8, min(int(20.0 / max(dt / its, 1e-6)),
                                 control.max_steps + 1))
        prev_it = int(it)
        it_hi = int(it) + n_chunk
    it = int(it)
    return SolveResult(merge(state), it, bool(conv),
                       [float(v) for v in hist[: it + 1]])


def cg(A, b, M=None, control: ReductionControl | None = None, x0=None,
       track_eigenvalues: bool = False, device_loop: bool | None = None
       ) -> SolveResult:
    """Preconditioned CG, deal.II SolverCG semantics.

    Monitors sqrt(r·r); optionally accumulates the CG-Lanczos tridiagonal and
    returns its eigenvalues (deal.II connect_eigenvalues_slot equivalent, used
    for Chebyshev eigenvalue estimation).

    device_loop=True (default when not tracking eigenvalues) runs the whole
    solve as one jitted lax.while_loop program — no per-iteration host
    synchronization (see _cg_device).  The eigenvalue-estimation path keeps
    the host loop (it needs the alpha/beta stall heuristics).
    """
    M = M or _identity
    control = control or ReductionControl()
    if device_loop is None:
        device_loop = (not track_eigenvalues
                       and isinstance(control, ReductionControl)
                       and hasattr(A, "__self__") and hasattr(M, "__self__")
                       and _device_traceable(A) and _device_traceable(M))
    if device_loop and not track_eigenvalues:
        try:
            hash(A), hash(M)
        except TypeError:
            pass
        else:
            import jax

            # all-dd outer loop: engages on the P8 mixed-precision
            # architecture with a dd operator (f64 rhs, kernel="dd" matvec,
            # f32-level preconditioner behind a PrecisionAdapter)
            op = getattr(A, "__self__", None)
            madp = getattr(M, "__self__", None)
            if (b.dtype == jnp.float64 and op is not None
                    and getattr(op, "supports_dd", False)
                    and madp is not None
                    and getattr(madp, "inner_dtype", None) == jnp.float32):
                try:
                    return _cg_device_dd(op, b, M, control, x0)
                except jax.errors.JAXTypeError:
                    pass
            try:
                return _cg_device(A, b, M, control, x0)
            except jax.errors.JAXTypeError:
                pass  # operator not traceable after all: host loop below
    x = jnp.zeros_like(b) if x0 is None else x0
    r = b - A(x) if x0 is not None else b.copy() if hasattr(b, "copy") else b
    res = _norm(r)
    state = control.check(0, res)
    alphas, betas = [], []
    it = 0
    stall = 0
    best_res = res
    if state != "success":
        z = M(r)
        p = z
        rz = _dot(r, z)
        while state == "iterate":
            it += 1
            Ap = A(p)
            pAp = _dot(p, Ap)
            if pAp <= 0.0 and track_eigenvalues:
                break  # breakdown: further coefficients are noise
            if pAp == 0.0:
                break
            alpha = rz / pAp
            x = x + alpha * p
            r = r - alpha * Ap
            res = _norm(r)
            if track_eigenvalues:
                # stagnation guard: once the residual has stopped decreasing
                # for a while in working precision, Lanczos coefficients are
                # noise (loose threshold: early plateaus are normal)
                if res < best_res * 0.999:
                    best_res = min(best_res, res)
                    stall = 0
                else:
                    stall += 1
                    if stall >= 8:
                        alphas.append(alpha)
                        break
            state = control.check(it, res)
            if state != "iterate":
                alphas.append(alpha)
                break
            z = M(r)
            rz_new = _dot(r, z)
            beta = rz_new / rz
            rz = rz_new
            p = z + beta * p
            alphas.append(alpha)
            betas.append(beta)

    eigs = None
    if track_eigenvalues and alphas:
        eigs = _lanczos_eigenvalues(alphas, betas)
    return SolveResult(x, it, state == "success", control.history, eigs)


def _lanczos_eigenvalues(alphas, betas):
    """Eigenvalues of the CG-Lanczos tridiagonal built from alpha/beta.

    T[k,k] = 1/alpha_k + beta_{k-1}/alpha_{k-1}; T[k,k+1] = sqrt(beta_k)/alpha_k.
    (deal.II SolverCG eigenvalue estimation.)
    """
    m = len(alphas)
    diag = np.zeros(m)
    off = np.zeros(max(m - 1, 0))
    for k in range(m):
        diag[k] = 1.0 / alphas[k]
        if k > 0:
            diag[k] += betas[k - 1] / alphas[k - 1]
        if k < m - 1:
            off[k] = np.sqrt(max(betas[k], 0.0)) / alphas[k]
    if m == 1:
        return diag
    from scipy.linalg import eigh_tridiagonal

    vals = eigh_tridiagonal(diag, off, eigvals_only=True)
    return vals


def flexible_cg(A, b, M=None, control=None, x0=None) -> SolveResult:
    """Flexible CG (Polak-Ribière beta), deal.II SolverFlexibleCG analog."""
    M = M or _identity
    control = control or ReductionControl()
    x = jnp.zeros_like(b) if x0 is None else x0
    r = b - A(x) if x0 is not None else b
    res = _norm(r)
    state = control.check(0, res)
    it = 0
    r_old = None
    z_old = None
    p = None
    rz_old = None
    while state == "iterate":
        z = M(r)
        if p is None:
            p = z
            rz = _dot(r, z)
        else:
            # flexible beta: (z, r - r_old)/(z_old, r_old)
            beta = _dot(z, r - r_old) / rz_old
            rz = _dot(r, z)
            p = z + beta * p
        it += 1
        Ap = A(p)
        pAp = _dot(p, Ap)
        if pAp == 0.0:
            break
        alpha = _dot(r, z) / pAp
        r_old, z_old, rz_old = r, z, _dot(r, z)
        x = x + alpha * p
        r = r - alpha * Ap
        res = _norm(r)
        state = control.check(it, res)
    return SolveResult(x, it, state == "success", control.history)


_GMRES_DEVICE_CACHE: dict = {}


def _gmres_device(A, b, M, control: ReductionControl, x0, restart: int,
                  right_preconditioning: bool) -> SolveResult:
    """GMRES restart cycles as jitted device programs (CGS2, Givens).

    Same math as the host loop below, but each restart cycle runs entirely
    on-device: the host CGS2 pulls 2(k+1) scalars per iteration, each a
    device synchronization.  One host sync per cycle remains (the restart
    decision)."""
    import jax
    from jax import lax

    key = (A, M, control.tolerance, control.reduce, control.max_steps,
           restart, right_preconditioning, b.shape, str(b.dtype))
    cycle = _GMRES_DEVICE_CACHE.get(key)
    if cycle is None:
        while len(_GMRES_DEVICE_CACHE) >= 8:
            _GMRES_DEVICE_CACHE.pop(next(iter(_GMRES_DEVICE_CACHE)))
        tol, red, max_steps = (control.tolerance, control.reduce,
                               control.max_steps)
        R = restart
        use64 = jax.config.jax_enable_x64
        hdt = jnp.float64 if use64 else b.dtype

        def dot(a, c):
            if use64 and a.dtype != jnp.float64:
                return _dot_twostage(a.astype(jnp.float64),
                                     c.astype(jnp.float64))
            return _dot_twostage(a, c)

        def norm(a):
            return jnp.sqrt(dot(a, a))

        def cycle_impl(x, b, initial, it0):
            r = b - A(x)
            if not right_preconditioning:
                r = M(r)
            beta = norm(r)
            initial = jnp.where(initial < 0.0, beta, initial)
            n = b.shape[0]
            V = jnp.zeros((R + 1, n), b.dtype).at[0].set(
                (r / beta.astype(b.dtype)))
            H = jnp.zeros((R + 1, R), hdt)
            cs = jnp.zeros(R, hdt)
            sn = jnp.zeros(R, hdt)
            g = jnp.zeros(R + 1, hdt).at[0].set(beta)
            # step-0 convergence (first cycle only, it0 == 0)
            done0 = (it0 == 0) & (beta <= tol)

            def cond(s):
                return (~s[6]) & (s[5] < R)

            def body(s):
                V, H, cs, sn, g, k, done, succ, res = s
                vk = lax.dynamic_index_in_dim(V, k, 0, keepdims=False)
                w = A(M(vk)) if right_preconditioning else M(A(vk))
                # CGS2 — rows of V beyond k are zero, so full matvecs
                # self-mask; dots accumulate in f64
                Vd = V.astype(hdt) if V.dtype != hdt else V
                wd = w.astype(hdt) if w.dtype != hdt else w
                h1 = Vd @ wd
                wd = wd - Vd.T @ h1
                h2 = Vd @ wd
                wd = wd - Vd.T @ h2
                hcol = h1 + h2  # (R+1,)
                hk1 = norm(wd)
                vnew = (wd / jnp.where(hk1 == 0.0, 1.0, hk1)).astype(b.dtype)
                Vn = lax.dynamic_update_index_in_dim(V, vnew, k + 1, 0)

                def rot(j, hc):
                    t = cs[j] * hc[j] + sn[j] * hc[j + 1]
                    u = -sn[j] * hc[j] + cs[j] * hc[j + 1]
                    on = j < k
                    return hc.at[j].set(jnp.where(on, t, hc[j])).at[
                        j + 1].set(jnp.where(on, u, hc[j + 1]))

                hcol = hcol.at[k + 1].set(hk1)
                hcol = lax.fori_loop(0, R, rot, hcol)
                hk = hcol[k]
                hkp = hcol[k + 1]
                denom = jnp.hypot(hk, hkp)
                ck = jnp.where(denom == 0.0, 1.0, hk / jnp.where(
                    denom == 0.0, 1.0, denom))
                sk = jnp.where(denom == 0.0, 0.0, hkp / jnp.where(
                    denom == 0.0, 1.0, denom))
                hcol = hcol.at[k].set(denom).at[k + 1].set(0.0)
                csn = cs.at[k].set(ck)
                snn = sn.at[k].set(sk)
                gk = g[k]
                gn = g.at[k + 1].set(-sk * gk).at[k].set(ck * gk)
                Hn = H.at[:, k].set(hcol[:R + 1])
                resn = jnp.abs(gn[k + 1])
                itn = it0 + k + 1
                success = (resn <= tol) | (resn < red * initial)
                failure = itn >= max_steps
                donen = success | failure | (hk1 == 0.0)
                return (Vn, Hn, csn, snn, gn, k + 1, donen, success, resn)

            s0 = (V, H, cs, sn, g, jnp.int32(0), done0, done0, beta)
            V, H, cs, sn, g, k, done, succ, res = lax.while_loop(cond, body,
                                                                 s0)

            # masked back-substitution for H[:k,:k] y = g[:k]
            def backsub(i_rev, y):
                i = R - 1 - i_rev
                num = g[i] - jnp.vdot(H[i, :R], y)
                hii = H[i, i]
                yi = jnp.where((i < k) & (hii != 0.0),
                               num / jnp.where(hii == 0.0, 1.0, hii), 0.0)
                return y.at[i].set(yi)

            y = lax.fori_loop(0, R, backsub, jnp.zeros(R, hdt))
            update = (V[:R].T @ y.astype(b.dtype)).astype(b.dtype)
            if right_preconditioning:
                update = M(update)
            xn = x + update
            return xn, k, res, succ, done0, initial

        from ..utils.jitutils import jit_hoist_consts

        sds = jax.ShapeDtypeStruct(b.shape, b.dtype)
        cycle = jit_hoist_consts(
            cycle_impl, sds, sds, jax.ShapeDtypeStruct((), hdt),
            jax.ShapeDtypeStruct((), jnp.int32))
        _GMRES_DEVICE_CACHE[key] = cycle

    x = jnp.zeros_like(b) if x0 is None else x0
    it = 0
    hdt0 = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    initial = jnp.asarray(-1.0, hdt0)  # device scalars: python ints/floats
    history = []                       # as jit args would retrace per value
    while True:
        x, k, res, succ, done0, initial = cycle(x, b, initial,
                                                jnp.asarray(it, jnp.int32))
        it += int(k)
        history.append(float(res))
        if bool(done0):
            return SolveResult(x, 0, bool(succ), history)
        if bool(succ):
            return SolveResult(x, it, True, history)
        if it >= control.max_steps or int(k) == 0:
            return SolveResult(x, it, False, history)


def gmres(A, b, M=None, control=None, x0=None, restart=28,
          right_preconditioning=True, orthogonalization="classical",
          device_loop: bool | None = None) -> SolveResult:
    """GMRES with restart; right preconditioning by default (driver default).

    restart=28 matches deal.II's default max_n_tmp_vectors=30 (basis 28).
    device_loop (default: on for hashable bound-method A/M with classical
    orthogonalization) runs each restart cycle as one jitted device program.
    """
    M = M or _identity
    control = control or ReductionControl()
    if device_loop is None:
        device_loop = (orthogonalization == "classical"
                       and isinstance(control, ReductionControl)
                       and hasattr(A, "__self__") and hasattr(M, "__self__")
                       and _device_traceable(A) and _device_traceable(M))
    if device_loop and orthogonalization == "classical":
        try:
            hash(A), hash(M)
        except TypeError:
            pass
        else:
            import jax

            try:
                return _gmres_device(A, b, M, control, x0, restart,
                                     right_preconditioning)
            except jax.errors.JAXTypeError:
                pass  # operator not traceable after all: host loop below
    n = b.shape[0]
    x = jnp.zeros_like(b) if x0 is None else x0

    it = 0
    state = None
    first = True
    while True:
        r = b - A(x) if (x0 is not None or not first) else b
        if not right_preconditioning:
            r = M(r)
        beta = _norm(r)
        if first:
            state = control.check(0, beta)
            first = False
            if state != "iterate":
                break
        V = [r / beta]
        H = np.zeros((restart + 1, restart))
        cs = np.zeros(restart)
        sn = np.zeros(restart)
        g = np.zeros(restart + 1)
        g[0] = beta
        k = 0
        broke = False
        for k in range(restart):
            if right_preconditioning:
                w = A(M(V[k]))
            else:
                w = M(A(V[k]))
            if orthogonalization == "classical":
                # CGS2: one re-orthogonalization pass — classical Gram-Schmidt
                # alone loses orthogonality catastrophically in float32 at
                # large n (observed: GMRES stagnation at 2M DoFs)
                hcol = np.array([_dot(V[j], w) for j in range(k + 1)])
                for j in range(k + 1):
                    w = w - hcol[j] * V[j]
                h2 = np.array([_dot(V[j], w) for j in range(k + 1)])
                for j in range(k + 1):
                    w = w - h2[j] * V[j]
                H[: k + 1, k] = hcol + h2
            else:  # modified Gram-Schmidt
                for j in range(k + 1):
                    hjk = _dot(V[j], w)
                    H[j, k] = hjk
                    w = w - hjk * V[j]
            hk1 = _norm(w)
            H[k + 1, k] = hk1
            # Givens rotations
            for j in range(k):
                t = cs[j] * H[j, k] + sn[j] * H[j + 1, k]
                H[j + 1, k] = -sn[j] * H[j, k] + cs[j] * H[j + 1, k]
                H[j, k] = t
            denom = np.hypot(H[k, k], H[k + 1, k])
            cs[k] = H[k, k] / denom if denom else 1.0
            sn[k] = H[k + 1, k] / denom if denom else 0.0
            H[k, k] = denom
            H[k + 1, k] = 0.0
            g[k + 1] = -sn[k] * g[k]
            g[k] = cs[k] * g[k]
            it += 1
            res = abs(g[k + 1])
            state = control.check(it, res)
            if state != "iterate" or hk1 == 0.0:
                broke = True
                k += 1
                break
            V.append(w / hk1)
        else:
            k = restart
        # solve the small triangular system and update x
        if k > 0:
            y = np.linalg.solve(H[:k, :k], g[:k])
            update = V[0] * y[0]
            for j in range(1, k):
                update = update + V[j] * y[j]
            if right_preconditioning:
                update = M(update)
            x = x + update
        x0 = x  # subsequent cycles recompute the residual
        if state != "iterate":
            break
    return SolveResult(x, it, state == "success", control.history)


def fgmres(A, b, M=None, control=None, x0=None, restart=28) -> SolveResult:
    """Flexible GMRES (stores preconditioned vectors; deal.II SolverFGMRES)."""
    M = M or _identity
    control = control or ReductionControl()
    x = jnp.zeros_like(b) if x0 is None else x0
    it = 0
    state = None
    first = True
    while True:
        r = b - A(x) if (x0 is not None or not first) else b
        beta = _norm(r)
        if first:
            state = control.check(0, beta)
            first = False
            if state != "iterate":
                break
        V = [r / beta]
        Z = []
        H = np.zeros((restart + 1, restart))
        cs = np.zeros(restart)
        sn = np.zeros(restart)
        g = np.zeros(restart + 1)
        g[0] = beta
        k = 0
        for k in range(restart):
            z = M(V[k])
            Z.append(z)
            w = A(z)
            for j in range(k + 1):
                hjk = _dot(V[j], w)
                H[j, k] = hjk
                w = w - hjk * V[j]
            hk1 = _norm(w)
            H[k + 1, k] = hk1
            for j in range(k):
                t = cs[j] * H[j, k] + sn[j] * H[j + 1, k]
                H[j + 1, k] = -sn[j] * H[j, k] + cs[j] * H[j + 1, k]
                H[j, k] = t
            denom = np.hypot(H[k, k], H[k + 1, k])
            cs[k] = H[k, k] / denom if denom else 1.0
            sn[k] = H[k + 1, k] / denom if denom else 0.0
            H[k, k] = denom
            H[k + 1, k] = 0.0
            g[k + 1] = -sn[k] * g[k]
            g[k] = cs[k] * g[k]
            it += 1
            res = abs(g[k + 1])
            state = control.check(it, res)
            if state != "iterate" or hk1 == 0.0:
                k += 1
                break
            V.append(w / hk1)
        else:
            k = restart
        if k > 0:
            y = np.linalg.solve(H[:k, :k], g[:k])
            update = Z[0] * y[0]
            for j in range(1, k):
                update = update + Z[j] * y[j]
            x = x + update
        x0 = x
        if state != "iterate":
            break
    return SolveResult(x, it, state == "success", control.history)


def bicgstab(A, b, M=None, control=None, x0=None) -> SolveResult:
    """Preconditioned BiCGStab (right preconditioning), deal.II-style monitoring."""
    M = M or _identity
    control = control or ReductionControl()
    x = jnp.zeros_like(b) if x0 is None else x0
    r = b - A(x) if x0 is not None else b
    res = _norm(r)
    state = control.check(0, res)
    r0 = r
    rho_old = alpha = omega = 1.0
    v = p = jnp.zeros_like(b)
    it = 0
    while state == "iterate":
        rho = _dot(r0, r)
        if rho == 0.0 or omega == 0.0:
            break
        beta = (rho / rho_old) * (alpha / omega)
        p = r + beta * (p - omega * v)
        phat = M(p)
        v = A(phat)
        denom = _dot(r0, v)
        if denom == 0.0:
            break
        alpha = rho / denom
        s = r - alpha * v
        # early exit on half step
        res = _norm(s)
        it += 1
        state = control.check(it, res)
        if state != "iterate":
            x = x + alpha * phat
            break
        shat = M(s)
        t = A(shat)
        tt = _dot(t, t)
        omega = _dot(t, s) / tt if tt else 0.0
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho_old = rho
        res = _norm(r)
        state = control.check(it, res)
    return SolveResult(x, it, state == "success", control.history)


def richardson(A, b, M=None, control=None, x0=None, omega=1.0) -> SolveResult:
    """Preconditioned Richardson iteration (deal.II SolverRelaxation analog,
    used for n>1 coarse cycles at /root/reference/include/multigrid.h:357-375)."""
    M = M or _identity
    control = control or ReductionControl()
    x = jnp.zeros_like(b) if x0 is None else x0
    r = b - A(x) if x0 is not None else b
    res = _norm(r)
    state = control.check(0, res)
    it = 0
    while state == "iterate":
        x = x + omega * M(r)
        r = b - A(x)
        it += 1
        res = _norm(r)
        state = control.check(it, res)
    return SolveResult(x, it, state == "success", control.history)


def idr(A, b, M=None, control=None, x0=None, s=2, seed=42) -> SolveResult:
    """IDR(s) (van Gijzen/Sonneveld; deal.II SolverIDR as exercised by
    /root/reference/outer_solver_01.likwid.cc:140-232)."""
    M = M or _identity
    control = control or ReductionControl()
    x = jnp.zeros_like(b) if x0 is None else x0
    r = b - A(x) if x0 is not None else b
    res = _norm(r)
    state = control.check(0, res)
    it = 0
    n = b.shape[0]
    rng = np.random.default_rng(seed)
    P = np.linalg.qr(rng.standard_normal((n, s)))[0]  # shadow space
    P = [jnp.asarray(P[:, j], b.dtype) for j in range(s)]
    G = [jnp.zeros_like(b) for _ in range(s)]
    U = [jnp.zeros_like(b) for _ in range(s)]
    Mmat = np.eye(s)
    om = 1.0
    while state == "iterate":
        f = np.array([_dot(P[j], r) for j in range(s)])
        for k in range(s):
            if state != "iterate":
                break
            c = np.linalg.solve(Mmat[k:, k:], f[k:])
            v = r
            for j in range(k, s):
                v = v - c[j - k] * G[j]
            v = M(v)
            u = om * v
            for j in range(k, s):
                u = u + c[j - k] * U[j]
            g = A(u)
            # bi-orthogonalize against P[0..k-1]
            for j in range(k):
                alpha = _dot(P[j], g) / Mmat[j, j]
                g = g - alpha * G[j]
                u = u - alpha * U[j]
            G[k], U[k] = g, u
            for j in range(k, s):
                Mmat[j, k] = _dot(P[j], g)
            if Mmat[k, k] == 0.0:
                state = "failure"
                break
            beta = f[k] / Mmat[k, k]
            x = x + beta * u
            r = r - beta * g
            it += 1
            res = _norm(r)
            state = control.check(it, res)
            if state != "iterate":
                break
            for j in range(k + 1, s):
                f[j] -= beta * Mmat[j, k]
            f[k] = 0.0
        if state != "iterate":
            break
        # dimension-reduction step
        v = M(r)
        t = A(v)
        tt = _dot(t, t)
        om = _dot(t, r) / tt if tt else 0.0
        x = x + om * v
        r = r - om * t
        it += 1
        res = _norm(r)
        state = control.check(it, res)
    return SolveResult(x, it, state == "success", control.history)


_SOLVERS = {
    "CG": cg,
    "FCG": flexible_cg,
    "GMRES": gmres,
    "FGMRES": fgmres,
    "Bicgstab": bicgstab,
    "IDR": idr,
    "Richardson": richardson,
}


def solve(solver_type, A, b, M=None, max_iterations=1000, abs_tolerance=1e-10,
          rel_tolerance=1e-2, control_type="ReductionControl", **kwargs) -> SolveResult:
    """Dispatch mirroring the driver's solve()
    (/root/reference/element_centered_preconditioners_01.cc:108-263)."""
    if control_type == "ReductionControl":
        control = ReductionControl(max_iterations, abs_tolerance, rel_tolerance)
    else:
        control = IterationNumberControl(max_iterations, abs_tolerance)
    fn = _SOLVERS[solver_type]
    return fn(A, b, M=M, control=control, **kwargs)


def cg_traceable(A, b, M=None, reduction: float = 1e-4,
                 max_iterations: int = 200):
    """Jit-composable preconditioned CG (lax.while_loop, device-side control).

    For use INSIDE larger jitted programs (e.g. as a scalable coarse-level
    solver in a whole-V-cycle jit, where the reference runs AMG —
    /root/reference/include/precondition.templates.h:592-613).  Stops on
    ||r|| ≤ reduction·||b|| or after max_iterations; returns x only.
    """
    import jax
    import jax.lax as lax

    M = M or _identity
    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = M(r0)
    rz0 = jnp.vdot(r0, z0)
    target2 = (reduction * reduction) * jnp.vdot(b, b)

    def cond(state):
        it, x, r, p, rz = state
        return (it < max_iterations) & (jnp.vdot(r, r) > target2)

    def body(state):
        it, x, r, p, rz = state
        Ap = A(p)
        alpha = rz / jnp.vdot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = jnp.vdot(r, z)
        p = z + (rz_new / rz) * p
        return (it + 1, x, r, p, rz_new)

    _, x, _, _, _ = lax.while_loop(cond, body, (0, x0, r0, z0, rz0))
    return x
