"""Scatter-add as transpose gathers — a gather-only `compress(add)`.

Every unstructured-path kernel ends in "scatter local values back to global
DoFs" (the reference's `distribute_local_to_global`,
/root/reference/include/vector_access_reduced.h:407-548, conflict-free by
SIMD-lane transposes).  The direct JAX spelling `zeros.at[idx].add(v)` is an
XLA scatter with colliding indices; the transpose form inverts the map ONCE
on the host — for each global dof, the (padded) list of source slots that
contribute to it — and the device op becomes K dense gathers + adds, pure
streaming with no conflict resolution:

    out[d] = sum_k v_flat_padded[tab[d, k]]

with `tab[d, k] = S` (a zero pad slot) beyond dof d's contribution count.
K is the max valence (8 for regular vertices; most dofs are cell-interior
with one contributor, whose k >= 1 gathers hit the pad slot — wasted loads
that measured CHEAPER than any bookkeeping to skip them: a count-ranked
prefix variant paid K whole-array dynamic-update-slices and lost).

``apply_dd`` accumulates a double-single (hi, lo) pair with TwoSum
compensation entirely in f32 — the f64 spelling gathered 8-byte values and
ran the K-term adds in emulated f64, which dominated the unstructured f64
matvec's cost at ball L=3 (probe_ball_anatomy).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


class TransposeScatter:
    """Host-built dof->slots transpose of an index table.

    Parameters
    ----------
    idx : np.ndarray (any shape)
        Target dof of each source slot (row-major flattened order must match
        the `v` passed to `apply`).  Entries ``>= n_dofs`` are treated as
        invalid (dropped) — the unstructured patch tables use ``n_dofs`` as
        their pad target.
    n_dofs : int
        Size of the output vector.
    """

    def __init__(self, idx: np.ndarray, n_dofs: int):
        flat = np.asarray(idx).reshape(-1)
        S = flat.shape[0]
        self.n_slots = S
        self.n_dofs = int(n_dofs)

        valid = flat < n_dofs
        targets = flat[valid]
        slots = np.nonzero(valid)[0]
        order = np.argsort(targets, kind="stable")
        t_sorted = targets[order]
        s_sorted = slots[order]
        counts = np.bincount(t_sorted, minlength=n_dofs)
        K = int(counts.max()) if counts.size else 1
        starts = np.zeros(n_dofs + 1, np.int64)
        np.cumsum(counts, out=starts[1:])

        tab = np.full((n_dofs, K), S, dtype=np.int64)
        k_of = np.arange(t_sorted.shape[0]) - starts[t_sorted]
        tab[t_sorted, k_of] = s_sorted
        self.K = K
        self.tab_cols = [jnp.asarray(np.ascontiguousarray(tab[:, k]),
                                     jnp.int32) for k in range(K)]

        # ranked-compact variant: dofs ordered by descending contribution
        # count, so tail columns gather only over the shared-dof prefix;
        # one final unrank gather restores dof order.  Wins when most dofs
        # have a single contributor (cell-interior nodes).
        rank_order = np.argsort(-counts, kind="stable")  # rank -> dof
        rank_of = np.empty(n_dofs, np.int64)
        rank_of[rank_order] = np.arange(n_dofs)
        tab_r = tab[rank_order]
        counts_r = counts[rank_order]
        self.n_shared = int((counts_r > 1).sum()) if K > 1 else 0
        # column 0 full width; tail columns fixed at the shared-dof prefix
        # length (pad-slot entries beyond each column's true count)
        self.rank_cols = [jnp.asarray(np.ascontiguousarray(tab_r[:, 0]),
                                      jnp.int32)]
        self.rank_cols += [jnp.asarray(
            np.ascontiguousarray(tab_r[: self.n_shared, k]), jnp.int32)
            for k in range(1, K)]
        self.unrank = jnp.asarray(rank_of, jnp.int32)  # dof -> rank

    def apply(self, v, dtype=None, variant: str = "full"):
        """sum-scatter the flat source values ``v`` (shape (n_slots,) after
        reshape) into a dense (n_dofs,) vector.

        variant: "full" (K full-width gather columns), "ranked" (tail
        columns gather only the shared-dof prefix + one unrank gather),
        "2d" (one (n, K) gather + row sum)."""
        v = v.reshape(-1)
        if dtype is not None:
            v = v.astype(dtype)
        vpad = jnp.concatenate([v, jnp.zeros((1,), v.dtype)])
        if variant == "ranked":
            n2 = self.n_shared
            out = vpad[self.rank_cols[0]]
            head = out[:n2]
            for k in range(1, self.K):
                head = head + vpad[self.rank_cols[k]]
            return jnp.concatenate([head, out[n2:]])[self.unrank]
        if variant == "2d":
            tab2d = jnp.stack(self.tab_cols, axis=1)
            return vpad[tab2d].sum(axis=1)
        out = vpad[self.tab_cols[0]]
        for k in range(1, self.K):
            out = out + vpad[self.tab_cols[k]]
        return out

    def apply_dd(self, vh, vl):
        """sum-scatter a double-single (hi, lo) f32 pair with TwoSum
        compensation; returns the (hi, lo) f32 result pair."""
        vh = vh.reshape(-1)
        vl = vl.reshape(-1)
        zh = jnp.zeros((1,), vh.dtype)
        hpad = jnp.concatenate([vh, zh])
        lpad = jnp.concatenate([vl, zh])
        oh = hpad[self.tab_cols[0]]
        ol = lpad[self.tab_cols[0]]
        for k in range(1, self.K):
            bh = hpad[self.tab_cols[k]]
            s = oh + bh
            t = s - oh
            e = (oh - (s - t)) + (bh - t)  # TwoSum error term
            oh = s
            ol = ol + (e + lpad[self.tab_cols[k]])
        return oh, ol
