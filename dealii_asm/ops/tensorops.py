"""Global tensor-product operator algebra — axis matmuls on the grid.

On tensor-product (Cartesian/anisotropic) geometries both hot operators factor
per axis GLOBALLY, so their applies become dense matmuls along grid axes — the
shape matrix units are built for — with no window materialization, no gathers and no
scatters:

- assembled Laplace:  A = Σ_d  M̂_{d'} ⊗ … K̂_d … ⊗ M̂_{d''}   with global
  banded 1D mass/stiffness matrices M̂, K̂ (N_d × N_d);
- FDM Schwarz apply:  P⁻¹ = (⊗_d G_dᵀ) · diag(1/Σ_d λ_d) · (⊗_d G_d) with
  G_d (C_d·m × N_d) = per-window eigen-transform ∘ window selector; boundary
  window patterns are just different rows of G_d (no fixups), any overlap.

This supersedes the reference's compressed-index machinery for structured
meshes (SURVEY.md §L3): index metadata disappears entirely into the operators.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..fem.lagrange import reference_mass_stiffness_1d


def axis_matmul(T, M, grid_axis: int):
    """Contract M (out, in) against one axis of grid tensor T."""
    dim = T.ndim
    letters = "zyxw"[:dim]
    it = letters[grid_axis]
    out = letters.replace(it, "o")
    return jnp.einsum(f"o{it},{letters}->{out}", M, T)


def assemble_global_1d(degree: int, n_cells: int, h: float, periodic: bool,
                       n_q_1d: int | None = None):
    """Global assembled 1D mass/stiffness (N × N), natural boundary rows."""
    M_ref, K_ref = reference_mass_stiffness_1d(degree, n_q_1d)
    from .. import native

    nat = native.assemble_global_1d(M_ref, K_ref, degree, n_cells, h, periodic)
    if nat is not None:
        return nat
    p = degree
    N = p * n_cells if periodic else p * n_cells + 1
    M = np.zeros((N, N))
    K = np.zeros((N, N))
    for c in range(n_cells):
        idx = (c * p + np.arange(p + 1)) % N
        M[np.ix_(idx, idx)] += M_ref * h
        K[np.ix_(idx, idx)] += K_ref / h
    return M, K


def global_laplace_1d_factors(mesh, degree: int, n_q_1d: int | None = None):
    """Per-direction (M̂_d, K̂_d) for the separable global Laplace."""
    out = []
    for d in range(mesh.dim):
        M, K = assemble_global_1d(degree, mesh.n_cells[d], mesh.h[d],
                                  mesh.periodic[d], n_q_1d)
        out.append((M, K))
    return out


def separable_laplace_apply(u_grid, Ms, Ks, dim: int):
    """v = Σ_d (⊗ M̂ … K̂_d … M̂) u via staged axis matmuls (8 in 3D, 4 in 2D).

    Ms/Ks are device arrays ordered by direction d (x first); grid axis of
    direction d is dim-1-d.
    """
    ax = lambda d: dim - 1 - d
    if dim == 2:
        a = axis_matmul(u_grid, Ms[0], ax(0))
        v = axis_matmul(a, Ks[1], ax(1))
        v = v + axis_matmul(axis_matmul(u_grid, Ks[0], ax(0)), Ms[1], ax(1))
        return v
    a = axis_matmul(u_grid, Ms[0], ax(0))        # Mx u
    b = axis_matmul(a, Ms[1], ax(1))             # My Mx u
    v = axis_matmul(b, Ks[2], ax(2))             # Kz My Mx u
    v = v + axis_matmul(axis_matmul(a, Ks[1], ax(1)), Ms[2], ax(2))
    v = v + axis_matmul(
        axis_matmul(axis_matmul(u_grid, Ks[0], ax(0)), Ms[1], ax(1)),
        Ms[2], ax(2))
    return v


def fdm_direction_transform(eigvecs_c: np.ndarray, n_nodes: int, degree: int,
                            n_overlap: int, periodic: bool,
                            patch: str = "element"):
    """G_d (W·m × N): window selection fused with the eigen-transform.

    eigvecs_c: (W, m, m) per-window M-orthonormal eigenvectors along this
    direction (columns = modes).  Element windows (patch="element") of window
    w cover nodes w·p − (o−1)…; vertex windows (patch="vertex",
    m = 2p−1) cover the star of interior vertex w+1: nodes w·p+1… (periodic:
    every vertex, nodes w·p − (p−1)… wrapped).  Out-of-range slots (ghosts
    beyond a boundary) select nothing.
    G[(w,k), n] = Σ_s V_w[s,k]·[n == wrap(start(w) + s)].
    """
    from .. import native

    C, m, _ = eigvecs_c.shape
    p = degree
    if patch == "element":
        nat = native.fdm_direction_transform(
            np.ascontiguousarray(eigvecs_c, dtype=np.float64), n_nodes, degree,
            n_overlap, periodic)
        if nat is not None:
            return nat
        start = lambda w: w * p - (n_overlap - 1)
    else:
        start = (lambda w: w * p - (p - 1)) if periodic else (
            lambda w: w * p + 1)
    G = np.zeros((C * m, n_nodes))
    for c in range(C):
        for s in range(m):
            n = start(c) + s
            if periodic:
                n %= n_nodes
            elif n < 0 or n >= n_nodes:
                continue
            G[c * m : (c + 1) * m, n] += eigvecs_c[c, s, :]
    return G


def cartesian_stable_factors(mesh, degree: int, n_q_1d: int | None = None,
                             nodes_per_dim=None):
    """Gradient-factored Cartesian operator: A = Σ_d (⊗_e Ã_e^{(d)})ᵀ(⊗_e Ã_e^{(d)}).

    Ã_e^{(d)} is the global per-axis evaluation matrix with √(quadrature
    weight · h_e) folded in (derivative axis additionally scaled 1/h_d).
    Algebraically identical to the Σ⊗M̂K̂ form, but numerically far stabler in
    low precision: the Kronecker-sum form accumulates the global 1/h-scaled
    stiffness rows directly (relative error ~eps/h² on smooth fields — 36x at
    64³ cells in f32), while this form differentiates first (error ~eps·p²/h,
    deal.II-float quality).
    """
    from ..fem.lagrange import shape_1d

    dim = mesh.dim
    s = shape_1d(degree, n_q_1d)
    sw = np.sqrt(s.w)
    out = []  # out[d][e] = global matrix for grid direction e of term d
    for d in range(dim):
        mats = []
        for e in range(dim):
            h = mesh.h[e]
            if e == d:
                B = (sw[:, None] * s.D) * (np.sqrt(h) / h)
            else:
                B = (sw[:, None] * s.N) * np.sqrt(h)
            E = interp_direction_transform(B, nodes_per_dim[e], degree,
                                           mesh.n_cells[e], mesh.periodic[e])
            mats.append(E)
        out.append(mats)
    return out


def separable_stable_apply(u_grid, factors, dim: int):
    """v = Σ_d (⊗Ã)ᵀ(⊗Ã) u via per-term forward/backward axis matmuls."""
    ax = lambda d: dim - 1 - d
    v = None
    for d in range(dim):
        t = u_grid
        for e in range(dim):
            t = axis_matmul(t, factors[d][e], ax(e))
        for e in range(dim):
            t = axis_matmul(t, factors[d][e].T, ax(e))
        v = t if v is None else v + t
    return v


def interp_direction_transform(B: np.ndarray, n_nodes: int, degree: int,
                               n_cells: int, periodic: bool) -> np.ndarray:
    """Global per-axis evaluation matrix E (C·q × N) from a 1D shape matrix
    B (q × p+1): row (c, iq) evaluates at quadrature point iq of cell c.

    Together with the symmetric coefficient in quadrature space this gives the
    deformed-geometry operator as axis matmuls (the reference's merged
    per-q-point representation, operator.h:1162-1219, reshaped into axis matmuls)."""
    q, n1 = B.shape
    p = degree
    E = np.zeros((n_cells * q, n_nodes))
    for c in range(n_cells):
        cols = (c * p + np.arange(n1)) % n_nodes
        E[c * q : (c + 1) * q, cols] = B
    return E


def merged_laplace_apply(u_grid, Ev, Ed, Evt, Edt, coeff6, dim: int):
    """Deformed-geometry Laplace apply via q-space axis matmuls.

    Ev/Ed: per-direction global value/derivative matrices (device arrays,
    direction order x first); Evt/Edt their transposes; coeff6: symmetric
    w|J|J⁻¹J⁻ᵀ per q-grid point, packed [xx, yy, zz, xy, xz, yz] (3D) or
    [xx, yy, xy] (2D)."""
    ax = lambda d: dim - 1 - d
    if dim == 2:
        a = axis_matmul(u_grid, Ev[0], ax(0))
        d1 = axis_matmul(u_grid, Ed[0], ax(0))
        gy = axis_matmul(a, Ed[1], ax(1))
        gx = axis_matmul(d1, Ev[1], ax(1))
        cxx, cyy, cxy = coeff6
        tx = cxx * gx + cxy * gy
        ty = cxy * gx + cyy * gy
        v = axis_matmul(axis_matmul(ty, Edt[1], ax(1)), Evt[0], ax(0))
        v = v + axis_matmul(axis_matmul(tx, Evt[1], ax(1)), Edt[0], ax(0))
        return v
    a = axis_matmul(u_grid, Ev[0], ax(0))     # x values
    d1 = axis_matmul(u_grid, Ed[0], ax(0))    # x derivatives
    b = axis_matmul(a, Ev[1], ax(1))
    c = axis_matmul(a, Ed[1], ax(1))
    e = axis_matmul(d1, Ev[1], ax(1))
    gz = axis_matmul(b, Ed[2], ax(2))
    gy = axis_matmul(c, Ev[2], ax(2))
    gx = axis_matmul(e, Ev[2], ax(2))
    cxx, cyy, czz, cxy, cxz, cyz = coeff6
    tx = cxx * gx + cxy * gy + cxz * gz
    ty = cxy * gx + cyy * gy + cyz * gz
    tz = cxz * gx + cyz * gy + czz * gz
    w1 = axis_matmul(tz, Edt[2], ax(2))
    w2 = axis_matmul(ty, Evt[2], ax(2))
    w3 = axis_matmul(tx, Evt[2], ax(2))
    r12 = axis_matmul(w1, Evt[1], ax(1)) + axis_matmul(w2, Edt[1], ax(1))
    r3 = axis_matmul(w3, Evt[1], ax(1))
    return axis_matmul(r12, Evt[0], ax(0)) + axis_matmul(r3, Edt[0], ax(0))


def fdm_global_apply(x_grid, Gs, Gts, inv_denom, dim: int):
    """P⁻¹x = (⊗G_dᵀ)·diag(inv_denom)·(⊗G_d)x — six axis matmuls + one scale."""
    ax = lambda d: dim - 1 - d
    t = x_grid
    for d in range(dim):
        t = axis_matmul(t, Gs[d], ax(d))
    t = t * inv_denom
    for d in range(dim):
        t = axis_matmul(t, Gts[d], ax(d))
    return t


def banded_offsets(N: int, bandwidth: int, periodic: bool) -> list[int]:
    """Distinct diagonal offsets of a banded (possibly periodic) N×N matrix.

    Periodic with 2b+1 > N: offsets alias mod N (a roll by off and off±N hit
    the same column) — enumerate each residue exactly once instead."""
    if periodic and 2 * bandwidth + 1 > N:
        return list(range(N))
    return list(range(-bandwidth, bandwidth + 1))


def banded_diagonals(M: np.ndarray, bandwidth: int,
                     periodic: bool = False):
    """(diags, offsets): diagonal table of a banded matrix,
    diags[k][i] = M[i, i+offsets[k]] (periodic: column wraps mod N, matching
    jnp.roll; non-periodic: zero outside the matrix, killing wrapped lanes)."""
    N = M.shape[0]
    offs = banded_offsets(N, bandwidth, periodic)
    out = np.zeros((len(offs), N))
    idx = np.arange(N)
    for k, off in enumerate(offs):
        cols = idx + off
        if periodic:
            out[k] = M[idx, cols % N]
        else:
            ok = (cols >= 0) & (cols < N)
            out[k, idx[ok]] = M[idx[ok], cols[ok]]
    return out, offs


def banded_axis_apply(t, diags, offsets, grid_axis: int,
                      periodic: bool = False):
    """y = M̂ t along one grid axis with M̂ given by its diagonal table.

    FLOPs are O((2b+1)·N) per point instead of the dense matmul's O(N) — and
    crucially the work is ELEMENTWISE, so a float64 apply uses the cheap
    emulated add/mul path instead of emulated matmuls (measured 461 ms for
    the dense f64 vmult at 17M DoFs vs 96 ms banded).

    Implemented as ONE pad + static slices of the padded buffer (all shifted
    views of the same array, which XLA fuses into the mad chain) rather than
    per-offset rolls (each roll materializes a copy).  Non-periodic zero
    padding doubles as the out-of-range kill the diagonal tables also encode;
    periodic wrap-padding reproduces roll semantics."""
    nd = t.ndim
    shape = [1] * nd
    N = t.shape[grid_axis]
    shape[grid_axis] = N
    lo = max(0, -min(offsets))
    hi = max(0, max(offsets))
    pad = [(0, 0)] * nd
    pad[grid_axis] = (lo, hi)
    tp = jnp.pad(t, pad, mode="wrap" if periodic else "constant")
    acc = None
    for k, off in enumerate(offsets):
        d = diags[k].reshape(shape)
        sl = [slice(None)] * nd
        sl[grid_axis] = slice(lo + off, lo + off + N)
        term = d * tp[tuple(sl)]
        acc = term if acc is None else acc + term
    return acc


def separable_laplace_apply_banded(u_grid, Mdiags, Kdiags, offsets, dim: int,
                                   periodic=None):
    """separable_laplace_apply with banded (diagonal-table) axis applies.

    Mdiags/Kdiags[d] = diagonal tables of direction d; offsets[d] their
    diagonal offsets (per-direction: grid sizes differ); periodic[d] selects
    wrap padding."""
    per = periodic or (False,) * dim
    ap = lambda t, tab, d: banded_axis_apply(t, tab, offsets[d], dim - 1 - d,
                                             per[d])
    if dim == 2:
        a = ap(u_grid, Mdiags[0], 0)
        v = ap(a, Kdiags[1], 1) + ap(ap(u_grid, Kdiags[0], 0), Mdiags[1], 1)
        return v
    a = ap(u_grid, Mdiags[0], 0)
    b = ap(a, Mdiags[1], 1)
    v = ap(b, Kdiags[2], 2)
    v = v + ap(ap(a, Kdiags[1], 1), Mdiags[2], 2)
    v = v + ap(ap(ap(u_grid, Kdiags[0], 0), Mdiags[1], 1), Mdiags[2], 2)
    return v


def banded_axis_apply_dd(th, tl, dtab, offsets, grid_axis: int,
                         periodic: bool = False):
    """banded_axis_apply on a double-single pair (th, tl) — see ops/ddmath.

    dtab = (dh, dl, dhh, dhl): the f64 diagonal table split host-side by
    ddmath.split_table_np.  Every partial product dh·xh is made exact by
    Dekker's algorithm on the ≤12-bit operand halves; the running sum keeps a
    compensation term via TwoSum.  ~21 native f32 flops per (element,
    diagonal) — vs XLA's software-f64 mads, measured ~4× faster end-to-end
    (the outer-Krylov vmult of the P8 mixed-precision architecture)."""
    from .ddmath import quick_two_sum, split12, two_sum

    dh, dl, dhh, dhl = dtab
    nd = th.ndim
    N = th.shape[grid_axis]
    shape = [1] * nd
    shape[grid_axis] = N
    lo_p = max(0, -min(offsets))
    hi_p = max(0, max(offsets))
    pad = [(0, 0)] * nd
    pad[grid_axis] = (lo_p, hi_p)
    mode = "wrap" if periodic else "constant"
    tph = jnp.pad(th, pad, mode=mode)
    tpl = jnp.pad(tl, pad, mode=mode)
    tphh, tphl = split12(tph)  # split once per apply, sliced per diagonal
    acc_h = acc_c = None
    for k, off in enumerate(offsets):
        sl = [slice(None)] * nd
        sl[grid_axis] = slice(lo_p + off, lo_p + off + N)
        sl = tuple(sl)
        xh, xl = tph[sl], tpl[sl]
        xhh, xhl = tphh[sl], tphl[sl]
        Dh = dh[k].reshape(shape)
        Dl = dl[k].reshape(shape)
        Dhh = dhh[k].reshape(shape)
        Dhl = dhl[k].reshape(shape)
        p = Dh * xh  # exact error via pre-split halves (FMA-free Dekker)
        e = (((Dhh * xhh - p) + Dhh * xhl) + Dhl * xhh) + Dhl * xhl
        e = e + (Dh * xl + Dl * xh)  # cross terms (dl·xl ~2⁻⁴⁸: dropped)
        if acc_h is None:
            acc_h, acc_c = p, e
        else:
            acc_h, e2 = two_sum(acc_h, p)
            acc_c = acc_c + (e2 + e)
    return quick_two_sum(acc_h, acc_c)


def separable_laplace_apply_banded_dd(uh, ul, Mdd, Kdd, offsets, dim: int,
                                      periodic=None):
    """separable_laplace_apply_banded on a double-single (hi, lo) pair.

    Mdd/Kdd[d] = split diagonal tables (ddmath.split_table_np) of direction d.
    Returns the (hi, lo) result pair; combine with ddmath.dd_to_f64."""
    from .ddmath import dd_add

    per = periodic or (False,) * dim
    ap = lambda t2, tabs, d: banded_axis_apply_dd(
        t2[0], t2[1], tabs[d], offsets[d], dim - 1 - d, per[d])
    if dim == 2:
        a = ap((uh, ul), Mdd, 0)
        v1 = ap(a, Kdd, 1)
        v2 = ap(ap((uh, ul), Kdd, 0), Mdd, 1)
        return dd_add(*v1, *v2)
    a = ap((uh, ul), Mdd, 0)
    b = ap(a, Mdd, 1)
    v = ap(b, Kdd, 2)
    v = dd_add(*v, *ap(ap(a, Kdd, 1), Mdd, 2))
    v = dd_add(*v, *ap(ap(ap((uh, ul), Kdd, 0), Mdd, 1), Mdd, 2))
    return v


def _axis_apply_shared_dd(uh, ul, m_axis: int, M_np: np.ndarray):
    """Shared small-matrix apply along one m-axis on a double-single pair.

    M_np is a host f64 (out, in) matrix; every entry becomes four baked
    scalar constants (Dekker split), so each of the out·in taps is one exact
    TwoProd + compensated accumulation on (…,) f32 slabs — native VPU flops
    instead of XLA's software-f64 mads (the same trick as
    banded_axis_apply_dd, with scalars instead of diagonal tables)."""
    from .ddmath import quick_two_sum, split12, two_sum

    uh = jnp.moveaxis(uh, m_axis, 0)
    ul = jnp.moveaxis(ul, m_axis, 0)
    uhh, uhl = split12(uh)
    Ch = M_np.astype(np.float32)
    Cl = (M_np - Ch.astype(np.float64)).astype(np.float32)
    c = np.float32(4097.0) * Ch
    big = c - Ch
    Chh = c - big
    Chl = Ch - Chh
    qo, qi = M_np.shape
    outs_h, outs_c = [], []
    for i in range(qo):
        acc_h = acc_c = None
        for j in range(qi):
            ch, cl = float(Ch[i, j]), float(Cl[i, j])
            chh, chl = float(Chh[i, j]), float(Chl[i, j])
            if ch == 0.0 and cl == 0.0:
                continue
            p = ch * uh[j]
            e = ((chh * uhh[j] - p) + chh * uhl[j]
                 + chl * uhh[j]) + chl * uhl[j]
            e = e + (ch * ul[j] + cl * uh[j])
            if acc_h is None:
                acc_h, acc_c = p, e
            else:
                acc_h, e2 = two_sum(acc_h, p)
                acc_c = acc_c + (e2 + e)
        h2, c2 = quick_two_sum(acc_h, acc_c)
        outs_h.append(h2)
        outs_c.append(c2)
    return (jnp.moveaxis(jnp.stack(outs_h, 0), 0, m_axis),
            jnp.moveaxis(jnp.stack(outs_c, 0), 0, m_axis))


def _dd_mul_split_tab(tab4, gh, gl, ghh, ghl):
    """(dd table with pre-split hi halves) × (dd tensor with pre-split hi)."""
    ch, cl, chh, chl = tab4
    p = ch * gh
    e = ((chh * ghh - p) + chh * ghl + chl * ghh) + chl * ghl
    e = e + (ch * gl + cl * gh)
    return p, e


def merged_laplace_apply_windowed_dd(uh_grid, ul_grid, Nq_np, Dq_np,
                                     coeff6dd, n_cells, degree: int,
                                     periodic, dim: int):
    """merged_laplace_apply_windowed on a double-single (hi, lo) pair.

    The f64 outer-Krylov matvec on deformed meshes: XLA's emulated-f64
    windowed form measured 1.91 s at 7.2M DoFs (Kershaw Q4); this dd form
    runs the same contraction graph in native f32 with error-free products
    (Nq/Dq entries baked as split scalar constants; the merged coefficient
    pre-split host-side into four f32 tables per symmetric component —
    ddmath.split_table_np) and TwoSum-compensated window face sums
    (lattice.windows_to_grid_dd).  ~47-bit result accuracy, VPU rate.

    Nq_np: (q, p+1) host f64; Dq_np[d]: same, pre-scaled 1/h_d; coeff6dd:
    six 4-tuples of f32 tables on the INTERLEAVED q-grid."""
    from .ddmath import dd_add, split12
    from .lattice import grid_to_windows, windows_to_grid_dd

    m = degree + 1
    wh = grid_to_windows(uh_grid, n_cells, degree, m, 1, periodic)
    wl = grid_to_windows(ul_grid, n_cells, degree, m, 1, periodic)
    mx = lambda d: 2 * (dim - 1 - d) + 1
    ap = lambda t2, d_ax, M: _axis_apply_shared_dd(t2[0], t2[1], mx(d_ax), M)
    NqT_np = np.ascontiguousarray(Nq_np.T)
    DqT_np = [np.ascontiguousarray(D.T) for D in Dq_np]
    u2 = (wh, wl)
    if dim == 2:
        a = ap(u2, 0, Nq_np)
        d1 = ap(u2, 0, Dq_np[0])
        gy = ap(a, 1, Dq_np[1])
        gx = ap(d1, 1, Nq_np)
        cxx, cyy, cxy = coeff6dd
        gxs, gys = split12(gx[0]), split12(gy[0])
        tx = dd_add(*_dd_mul_split_tab(cxx, gx[0], gx[1], *gxs),
                    *_dd_mul_split_tab(cxy, gy[0], gy[1], *gys))
        ty = dd_add(*_dd_mul_split_tab(cxy, gx[0], gx[1], *gxs),
                    *_dd_mul_split_tab(cyy, gy[0], gy[1], *gys))
        r = dd_add(*ap(ap(ty, 1, DqT_np[1]), 0, NqT_np),
                   *ap(ap(tx, 1, NqT_np), 0, DqT_np[0]))
    else:
        a = ap(u2, 0, Nq_np)
        d1 = ap(u2, 0, Dq_np[0])
        b = ap(a, 1, Nq_np)
        c_ = ap(a, 1, Dq_np[1])
        e = ap(d1, 1, Nq_np)
        gz = ap(b, 2, Dq_np[2])
        gy = ap(c_, 2, Nq_np)
        gx = ap(e, 2, Nq_np)
        cxx, cyy, czz, cxy, cxz, cyz = coeff6dd
        gxs, gys, gzs = split12(gx[0]), split12(gy[0]), split12(gz[0])

        def contract(cA, cB, cC):
            t = _dd_mul_split_tab(cA, gx[0], gx[1], *gxs)
            t = dd_add(*t, *_dd_mul_split_tab(cB, gy[0], gy[1], *gys))
            return dd_add(*t, *_dd_mul_split_tab(cC, gz[0], gz[1], *gzs))

        tx = contract(cxx, cxy, cxz)
        ty = contract(cxy, cyy, cyz)
        tz = contract(cxz, cyz, czz)
        w1 = ap(tz, 2, DqT_np[2])
        w2 = ap(ty, 2, NqT_np)
        w3 = ap(tx, 2, NqT_np)
        r12 = dd_add(*ap(w1, 1, NqT_np), *ap(w2, 1, DqT_np[1]))
        r3 = ap(w3, 1, NqT_np)
        r = dd_add(*ap(r12, 0, NqT_np), *ap(r3, 0, DqT_np[0]))
    return windows_to_grid_dd(r[0], r[1], uh_grid.shape, degree, 1, periodic)


def merged_laplace_apply_windowed(u_grid, Nq, Dq, NqT, DqT, coeff6i,
                                  n_cells, degree: int, periodic, dim: int):
    """Deformed-geometry Laplace apply in window form: small shared per-cell
    transforms instead of global dense interp matrices.

    The global E_d matmul has inner dimension N_d; in window form the same
    contraction is (…, p+1)·(p+1, q) — ~N/(p+1)× fewer FLOPs, and small
    enough that XLA's f64 emulation lowers it to cheap elementwise passes
    (the f64 outer-Krylov path on deformed meshes; cf. the banded Cartesian
    form).  Nq/Dq: (q, p+1) value/derivative (Dq pre-scaled 1/h_d per
    direction); coeff6i: symmetric coefficients on the INTERLEAVED q-grid
    (Cz, q, Cy, q, Cx, q)."""
    from .lattice import apply_axis_shared as ap
    from .lattice import grid_to_windows, windows_to_grid

    m = degree + 1
    w = grid_to_windows(u_grid, n_cells, degree, m, 1, periodic)
    mx = lambda d: 2 * (dim - 1 - d) + 1  # m-axis of direction d
    if dim == 2:
        a = ap(w, mx(0), Nq)
        d1 = ap(w, mx(0), Dq[0])
        gy = ap(a, mx(1), Dq[1])
        gx = ap(d1, mx(1), Nq)
        cxx, cyy, cxy = coeff6i
        tx = cxx * gx + cxy * gy
        ty = cxy * gx + cyy * gy
        r = ap(ap(ty, mx(1), DqT[1]), mx(0), NqT)
        r = r + ap(ap(tx, mx(1), NqT), mx(0), DqT[0])
    else:
        a = ap(w, mx(0), Nq)       # x values
        d1 = ap(w, mx(0), Dq[0])   # x derivatives
        b = ap(a, mx(1), Nq)
        c_ = ap(a, mx(1), Dq[1])
        e = ap(d1, mx(1), Nq)
        gz = ap(b, mx(2), Dq[2])
        gy = ap(c_, mx(2), Nq)
        gx = ap(e, mx(2), Nq)
        cxx, cyy, czz, cxy, cxz, cyz = coeff6i
        tx = cxx * gx + cxy * gy + cxz * gz
        ty = cxy * gx + cyy * gy + cyz * gz
        tz = cxz * gx + cyz * gy + czz * gz
        w1 = ap(tz, mx(2), DqT[2])
        w2 = ap(ty, mx(2), NqT)
        w3 = ap(tx, mx(2), NqT)
        r12 = ap(w1, mx(1), NqT) + ap(w2, mx(1), DqT[1])
        r3 = ap(w3, mx(1), NqT)
        r = ap(r12, mx(0), NqT) + ap(r3, mx(0), DqT[0])
    grid_shape = u_grid.shape
    return windows_to_grid(r, grid_shape, degree, 1, periodic)
