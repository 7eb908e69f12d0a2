"""Lattice window extraction — the structured 'reduced access' layer.

The reference compresses per-cell DoF indices to 3^dim start indices per cell to
cut index-memory bandwidth (/root/reference/include/vector_access_reduced.h,
reduced_access.h).  Here the redesign is stronger: on a structured node
lattice the per-cell (patch) DoF windows are *strided slices* of the grid-shaped
vector, so cell access needs NO index tables at all and the transpose-scatter
becomes a conflict-free overlap-add of m shifted slabs per axis (each slab hits
every target once → vectorized adds, not serialized scatters).

Window geometry along one axis (degree p, overlap o, m = p-1+2o):
window start of cell c = c·p − (o−1); nodes outside a non-periodic boundary are
zero-padding (the reference's invalid_dof_index), periodic wraps.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def _pad_amounts(n_nodes: int, n_cells: int, degree: int, m: int, overlap: int,
                 periodic: bool) -> tuple[int, int]:
    lo = overlap - 1
    span = (n_cells - 1) * degree + m
    hi = span - lo - n_nodes
    return lo, max(hi, 0)


def split_windows_axis(u, axis: int, n_cells: int, degree: int, m: int,
                       overlap: int, periodic: bool):
    """(..., N, ...) -> (..., C, m, ...) windows along ``axis``.

    Built from p-strided *reshapes* (free) plus 2·overlap−1 thin strided
    columns, not m strided slabs: the bulk of every window is the contiguous
    block u[c·p : (c+1)·p], which u[..., :C·p].reshape(C, p) yields for free.
    """
    u = jnp.moveaxis(u, axis, -1)
    N = u.shape[-1]
    lo, hi = _pad_amounts(N, n_cells, degree, m, overlap, periodic)
    if lo or hi:
        pad = [(0, 0)] * (u.ndim - 1) + [(lo, hi)]
        u = jnp.pad(u, pad, mode="wrap" if periodic else "constant")
    p = degree
    C = n_cells
    lead = u.shape[:-1]
    # window of cell c covers padded indices [c·p, c·p+m); slots 0..p-1 come
    # from the free reshape, the remaining 2·overlap-1 from thin strided slices
    core = u[..., : C * p].reshape(lead + (C, p))
    post = [
        u[..., s : s + (C - 1) * p + 1 : p][..., None]
        for s in range(p, m)
    ]
    w = jnp.concatenate([core] + post, axis=-1)  # (..., C, m)
    return _restore(w, axis)


def _restore(w, axis):
    # w: (..., C, m) with the split axis moved to the end; move (C, m) back to
    # position `axis` as two consecutive axes.
    w = jnp.moveaxis(w, -2, axis)      # C -> axis
    w = jnp.moveaxis(w, -1, axis + 1)  # m -> axis+1
    return w


def overlap_add_axis(w, axis: int, n_nodes: int, degree: int, overlap: int,
                     periodic: bool):
    """Inverse of split_windows_axis: (..., C, m, ...) -> (..., N, ...) by
    overlap-adding the m shifted slabs (conflict-free per slab)."""
    m_axis = axis + 1
    w = jnp.moveaxis(w, m_axis, -1)
    w = jnp.moveaxis(w, axis, -2)  # (..., C, m)
    C = w.shape[-2]
    m = w.shape[-1]
    p = degree
    lo, hi = _pad_amounts(n_nodes, C, p, m, overlap, periodic)
    padded_len = n_nodes + lo + hi
    # inverse of the reshape+thin-column split: the first p slots reshape back
    # in one write; the remaining 2·overlap-1 slots are thin strided adds
    out = jnp.zeros(w.shape[:-2] + (padded_len,), w.dtype)
    out = out.at[..., : C * p].add(w[..., :, :p].reshape(w.shape[:-2] + (C * p,)))
    for s in range(p, m):
        out = out.at[..., s : s + p * (C - 1) + 1 : p].add(w[..., :, s])
    if periodic:
        core = out[..., lo : lo + n_nodes]
        if lo:
            core = core.at[..., n_nodes - lo :].add(out[..., :lo])
        if hi:
            core = core.at[..., :hi].add(out[..., lo + n_nodes :])
    else:
        core = out[..., lo : lo + n_nodes]
    return jnp.moveaxis(core, -1, axis)


def grid_to_windows(u_grid, n_cells: tuple, degree: int, m: int, overlap: int,
                    periodic: tuple):
    """Grid (Nz, Ny, Nx) -> interleaved windows (Cz, mz, Cy, my, Cx, mx).

    The interleaved layout keeps per-axis contractions transpose-free: compute
    kernels contract the m-axes (positions 1,3,5) in place; per-coordinate
    matrix tables index the C-axes (positions 0,2,4)."""
    dim = len(n_cells)
    w = u_grid
    for a in range(dim - 1, -1, -1):
        d = dim - 1 - a
        w = split_windows_axis(w, a, n_cells[d], degree, m, overlap, periodic[d])
    return w


def windows_to_grid(w, grid_shape: tuple, degree: int, overlap: int,
                    periodic: tuple):
    """Inverse of grid_to_windows (overlap-add)."""
    dim = len(grid_shape)
    for a in range(dim):
        d = dim - 1 - a
        w = overlap_add_axis(w, a, grid_shape[a], degree, overlap, periodic[d])
    return w


def overlap_add_axis_dd(wh, wc, axis: int, n_nodes: int, degree: int,
                        overlap: int, periodic: bool):
    """overlap_add_axis on a double-single (hi, comp) pair.

    The face planes where adjacent windows meet are the ONLY sums in the
    windowed operator apply that live outside the dd-compensated axis
    kernels; a plain hi-part add there would round away ~2⁻²⁴·|face value| —
    the very compensation the dd path exists to keep.  Each strided face add
    is a TwoSum with the error folded into the compensation plane."""
    from .ddmath import two_sum

    m_axis_ = axis + 1
    wh = jnp.moveaxis(jnp.moveaxis(wh, m_axis_, -1), axis, -2)
    wc = jnp.moveaxis(jnp.moveaxis(wc, m_axis_, -1), axis, -2)
    C, m = wh.shape[-2], wh.shape[-1]
    p = degree
    lo, hi = _pad_amounts(n_nodes, C, p, m, overlap, periodic)
    padded_len = n_nodes + lo + hi
    out_h = jnp.zeros(wh.shape[:-2] + (padded_len,), wh.dtype)
    out_c = jnp.zeros_like(out_h)
    bulk = wh.shape[:-2] + (C * p,)
    out_h = out_h.at[..., : C * p].set(wh[..., :, :p].reshape(bulk))
    out_c = out_c.at[..., : C * p].set(wc[..., :, :p].reshape(bulk))
    for s in range(p, m):
        sl = slice(s, s + p * (C - 1) + 1, p)
        a = out_h[..., sl]
        sm, e = two_sum(a, wh[..., :, s])
        out_h = out_h.at[..., sl].set(sm)
        out_c = out_c.at[..., sl].add(e + wc[..., :, s])
    if periodic:
        ch_, cc_ = out_h[..., lo: lo + n_nodes], out_c[..., lo: lo + n_nodes]
        for src, dst in (((slice(None, lo) if lo else None),
                          slice(n_nodes - lo, None)),
                         ((slice(lo + n_nodes, None) if hi else None),
                          slice(None, hi))):
            if src is None:
                continue
            a = ch_[..., dst]
            sm, e = two_sum(a, out_h[..., src])
            ch_ = ch_.at[..., dst].set(sm)
            cc_ = cc_.at[..., dst].add(e + out_c[..., src])
        out_h, out_c = ch_, cc_
    else:
        out_h = out_h[..., lo: lo + n_nodes]
        out_c = out_c[..., lo: lo + n_nodes]
    return (jnp.moveaxis(out_h, -1, axis), jnp.moveaxis(out_c, -1, axis))


def windows_to_grid_dd(wh, wc, grid_shape: tuple, degree: int, overlap: int,
                       periodic: tuple):
    """windows_to_grid on a double-single pair (compensated face sums)."""
    dim = len(grid_shape)
    for a in range(dim):
        d = dim - 1 - a
        wh, wc = overlap_add_axis_dd(wh, wc, a, grid_shape[a], degree,
                                     overlap, periodic[d])
    return wh, wc


def apply_axis_shared(w, m_axis: int, mat):
    """Contract a shared 1D matrix (out, in) against one m-axis of a window tensor."""
    w = jnp.moveaxis(w, m_axis, -1)
    w = jnp.matmul(w, mat.T)
    return jnp.moveaxis(w, -1, m_axis)


def apply_axis_percoord(w, c_axis: int, m_axis: int, mats, transpose: bool):
    """Contract per-coordinate matrices (C_d, m, m) against one (C, m) axis pair.

    transpose=True applies matsᵀ (out_j = Σ_i mats[c,i,j]·in_i)."""
    w = jnp.moveaxis(w, m_axis, -1)
    w = jnp.moveaxis(w, c_axis if c_axis < m_axis else c_axis - 1, -2)
    eq = "...ci,cij->...cj" if transpose else "...ci,cji->...cj"
    w = jnp.einsum(eq, w, mats)
    w = jnp.moveaxis(w, -2, c_axis if c_axis < m_axis else c_axis - 1)
    return jnp.moveaxis(w, -1, m_axis)


def grid_to_cells_sliced(u_grid, n_cells: tuple, degree: int, m: int,
                         overlap: int, periodic: tuple):
    """Grid -> (L, C) via m^dim strided slices, L = m^dim.

    Layout note: local-dof-major (L, C) keeps the big cell axis contiguous
    (minor).  A local dense (L, L) operator then applies as ONE large
    A(L,L) @ W(L,C) GEMM."""
    dim = len(n_cells)
    # via the interleaved windows (per-axis free reshape + 2·overlap−1 thin
    # columns) and ONE transpose — NOT an m^dim-slice stack: XLA fuses a
    # 125-way concatenate into every consumer's reads
    w = grid_to_windows(u_grid, n_cells, degree, m, overlap, periodic)
    perm = tuple(range(1, 2 * dim, 2)) + tuple(range(0, 2 * dim, 2))
    w = w.transpose(perm)  # (mz, my, mx, Cz, Cy, Cx)
    return w.reshape(m**dim, -1)


def cells_to_grid_sliced(v, grid_shape: tuple, n_cells: tuple, degree: int,
                         m: int, overlap: int, periodic: tuple):
    """Inverse of grid_to_cells_sliced: (L, C) -> grid.

    Routes through the interleaved-window overlap-add (windows_to_grid):
    per axis ONE contiguous bulk add (a free p-strided reshape) plus
    2·overlap−1 thin strided adds, in place of the direct form's m^dim
    strided 3D scatter-adds of full cell slabs."""
    dim = len(n_cells)
    cells_zyx = tuple(reversed(n_cells))
    # L unravels as (m_z, m_y, m_x) with x fastest
    w = v.reshape((m,) * dim + cells_zyx)
    perm = []
    for a in range(dim):
        perm += [dim + a, a]  # (Cz, mz, Cy, my, Cx, mx)
    w = w.transpose(perm)
    return windows_to_grid(w, grid_shape, degree, overlap, periodic)


def grid_to_cells(u_grid, n_cells: tuple, degree: int, m: int, overlap: int,
                  periodic: tuple):
    """Grid (Nz, Ny, Nx) -> cell-batched (C, m^dim) local tensors (x fastest).

    dim axes are ordered slowest-to-fastest (z, y, x), matching the flat DoF
    numbering u.reshape(Nz, Ny, Nx).
    """
    dim = len(n_cells)
    w = u_grid
    # split each grid axis back-to-front; grid axis a holds direction dim-1-a,
    # and splitting at position a leaves lower positions untouched
    for a in range(dim - 1, -1, -1):
        d = dim - 1 - a
        w = split_windows_axis(w, a, n_cells[d], degree, m, overlap, periodic[d])
    # after splitting from last to first axis, layout is
    # (Cz, mz, Cy, my, Cx, mx); reorder to (Cz, Cy, Cx, mz, my, mx)
    perm_c = tuple(range(0, 2 * dim, 2))
    perm_m = tuple(range(1, 2 * dim, 2))
    w = w.transpose(perm_c + perm_m)
    C = int(np.prod(n_cells))
    return w.reshape(C, m**dim)


def cells_to_grid(v, grid_shape: tuple, n_cells: tuple, degree: int, m: int,
                  overlap: int, periodic: tuple):
    """Inverse of grid_to_cells: (C, m^dim) -> grid (Nz, Ny, Nx) overlap-added."""
    dim = len(n_cells)
    cells_zyx = tuple(reversed([n_cells[d] for d in range(dim)]))  # (Cz, Cy, Cx)
    w = v.reshape(cells_zyx + (m,) * dim)
    # back to interleaved (Cz, mz, Cy, my, Cx, mx)
    perm = []
    for i in range(dim):
        perm.append(i)
        perm.append(dim + i)
    w = w.transpose(perm)
    # merge (C, m) pairs front-to-back: each merge collapses two axes into one
    # at position a, so the a-th pair always sits at position a
    for a in range(dim):
        d = dim - 1 - a
        w = overlap_add_axis(w, a, grid_shape[a], degree, overlap, periodic[d])
    return w
