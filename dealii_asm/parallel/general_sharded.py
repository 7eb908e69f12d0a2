"""Multi-device (SPMD) path for UNSTRUCTURED meshes — P1/P3 for every
mesh family.

The reference partitions any p4est forest across ranks with a space-filling
curve and runs two-phase ghost exchange on the shared dofs
(/root/reference/include/matrix_free_internal.h:15-103; SURVEY P1/P3).
The device-mesh analog here:

- **cells** are split into device-contiguous index ranges (the mesh's cell
  order follows the refinement tree — the SFC-locality analog),
- **dofs** are owned by the lowest-index device whose cells touch them and
  renumbered owner-blocked, so the global vector is a (D, B) block-sharded
  array (`jax.sharding` over a 1D device mesh),
- the fine level runs under `shard_map`: gathers read from an
  `all_gather`-reconstructed padded global vector (v1 fetch; the
  neighbor-only `ppermute` refinement is a recorded optimization, not a
  correctness need), local cell work is the SAME lane-major apply as
  single-device, and the scatter-back sums own-range slots natively plus a
  ghost block that is exchanged and `compress(add)`-ed into owners — one
  colliding `.at[].add` per side (measured fastest, results_r5.md),
- **coarse levels replicate**: every device runs the identical inner
  multigrid on the restricted residual (the analog of the reference's
  shrinking coarse sub-communicator, element_centered_preconditioners_01.cc
  :598-632 — at 8x-per-level coarsening the replicated work is <15%).

Everything here is host-built static tables + jit-compiled collectives;
no data-dependent control flow.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
try:
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax layouts
    from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

AXIS = "dev"


class GeneralPartition:
    """Cell-contiguous D-way partition with owner-blocked dof renumbering.

    new numbering: dofs sorted by (owner device, old id); device d owns
    new ids [offsets[d], offsets[d+1]).  The padded global vector has
    length D·B (B = max owned count); slot d·B + i holds new id
    offsets[d] + i (i < n_own[d]), pads are zero.
    """

    def __init__(self, dofs, n_dev: int):
        self.dofs = dofs
        self.n_dev = int(n_dev)
        cd = np.asarray(dofs.cell_dofs, np.int64)  # (C, L)
        C = cd.shape[0]
        n = dofs.n_dofs
        self.n_dofs = n
        # balanced contiguous cell ranges
        bounds = np.linspace(0, C, self.n_dev + 1).astype(np.int64)
        self.cell_bounds = bounds
        cell_owner = np.searchsorted(bounds[1:], np.arange(C), side="right")

        owner = np.full(n, self.n_dev, np.int64)
        np.minimum.at(owner, cd.reshape(-1),
                      np.repeat(cell_owner, cd.shape[1]))
        assert owner.max() < self.n_dev, "dof untouched by any cell"
        self.owner = owner

        order = np.argsort(owner * (n + 1) + np.arange(n), kind="stable")
        self.new_of_old = np.empty(n, np.int64)
        self.new_of_old[order] = np.arange(n)
        self.old_of_new = order
        n_own = np.bincount(owner, minlength=self.n_dev)
        self.n_own = n_own
        self.offsets = np.concatenate([[0], np.cumsum(n_own)])
        self.B = int(n_own.max())

        # padded-slot id of each new id: dev·B + (new − offsets[dev])
        dev_of_new = owner[order]
        self.slot_of_new = (dev_of_new * self.B
                            + np.arange(n) - self.offsets[dev_of_new])
        self.NB = self.n_dev * self.B

        # constrained mask / any global vector, in padded-block layout
        self._pad_perm = np.full(self.NB, n, np.int64)
        self._pad_perm[self.slot_of_new] = self.old_of_new
        self._unpad_perm = self.slot_of_new[self.new_of_old]

        # per-device tables for the cell map (the operator's slot table)
        self.cells = self.slot_tables(cd, bounds)
        # convenience aliases (the operator's tables)
        self.Cmax = self.cells.Smax
        self.L = cd.shape[1]
        self.Gmax = self.cells.Gmax
        self.n_loc = self.cells.n_loc
        self.gather_tab = self.cells.gather_tab
        self.fetch_tab = self.cells.fetch_tab
        self.recv_tab = self.cells.recv_tab

    def slot_tables(self, idx_np, bounds=None):
        """Per-device gather/fetch/recv tables for an arbitrary slot map.

        idx_np: (S, L) old-numbering dof targets (entries >= n_dofs are
        pads -> zero slot).  bounds: (D+1,) contiguous split of the S axis
        (default: balanced)."""
        idx = np.asarray(idx_np, np.int64)
        S, L = idx.shape
        n = self.n_dofs
        if bounds is None:
            bounds = np.linspace(0, S, self.n_dev + 1).astype(np.int64)
        t = type("SlotTables", (), {})()
        t.bounds = bounds
        t.Smax = int((bounds[1:] - bounds[:-1]).max())
        t.L = L

        # old -> padded-slot ids, with an invalid sentinel channel
        slot_of_old = np.concatenate(
            [self.slot_of_new[self.new_of_old], [self.NB]])
        idx_slot = slot_of_old[np.minimum(idx, n)]  # (S, L); invalid -> NB

        ghost_slots = []
        gmax = 1
        for d in range(self.n_dev):
            rows = idx_slot[bounds[d]: bounds[d + 1]]
            lo, hi = d * self.B, d * self.B + self.B
            g = np.unique(rows[((rows < lo) | (rows >= hi))
                               & (rows < self.NB)])
            ghost_slots.append(g)
            gmax = max(gmax, len(g))
        t.Gmax = gmax
        n_loc = self.B + t.Gmax
        t.n_loc = n_loc
        gtab = np.full((self.n_dev, L, t.Smax), n_loc, np.int64)
        for d in range(self.n_dev):
            rows = idx_slot[bounds[d]: bounds[d + 1]]  # (S_d, L)
            lo = d * self.B
            local = np.where(
                (rows >= lo) & (rows < lo + self.B), rows - lo,
                np.where(rows >= self.NB, n_loc,
                         self.B + np.searchsorted(ghost_slots[d], rows)))
            gtab[d, :, : rows.shape[0]] = local.T
        t.gather_tab = jnp.asarray(gtab, jnp.int32)  # (D, L, Smax)

        ftab = np.full((self.n_dev, n_loc + 1), self.NB, np.int64)
        for d in range(self.n_dev):
            ftab[d, : self.B] = d * self.B + np.arange(self.B)
            ftab[d, self.B: self.B + len(ghost_slots[d])] = ghost_slots[d]
        t.fetch_tab = jnp.asarray(ftab, jnp.int32)  # (D, n_loc+1)

        rtab = np.full((self.n_dev, self.n_dev * t.Gmax), self.B, np.int64)
        for src in range(self.n_dev):
            g = ghost_slots[src]
            own_dev = g // self.B
            own_idx = g - own_dev * self.B
            for dst in range(self.n_dev):
                sel = own_dev == dst
                rtab[dst, src * t.Gmax + np.nonzero(sel)[0]] = own_idx[sel]
        t.recv_tab = jnp.asarray(rtab, jnp.int32)  # (D, D·Gmax)
        t.ghost_slots = ghost_slots
        return t

    def pad(self, u):
        """global (n,) old-numbering -> (NB,) padded owner-blocked."""
        up = jnp.concatenate([u, jnp.zeros((1,), u.dtype)])
        return up[jnp.asarray(self._pad_perm)]

    def unpad(self, ub):
        """(NB,) padded owner-blocked -> (n,) old numbering."""
        return ub[jnp.asarray(self._unpad_perm)]


class ShardedGeneralOperator:
    """Sharded twin of GeneralLaplaceOperator (lane-major f32/f64-dd).

    vmult runs under shard_map on a 1D device mesh; the local cell apply
    is the operator's own `apply_local_lanes` / `apply_local_lanes_dd` on
    per-device cell blocks.
    """

    def __init__(self, op, part: GeneralPartition, jmesh: Mesh):
        self.op = op
        self.part = part
        self.jmesh = jmesh
        D = part.n_dev
        # per-device coefficient blocks, cells padded to Cmax (zeros)
        q = op.n_q_1d
        dim = op.dim
        Q = q ** dim

        def split_cells(arr_qC):  # (..., C) lane-major -> (D, ..., Cmax)
            C = arr_qC.shape[-1]
            out = np.zeros((D,) + arr_qC.shape[:-1] + (part.Cmax,),
                           arr_qC.dtype)
            for d in range(D):
                lo, hi = part.cell_bounds[d], part.cell_bounds[d + 1]
                out[d, ..., : hi - lo] = arr_qC[..., lo:hi]
            return out

        if np.dtype(op.dtype) == np.float64:
            self._mode = "dd"
            if op.coeff6_dd is not None:
                tabs = [np.asarray(t) for t in op.coeff6_dd]
            else:
                # the fused single-device kernel skips the XLA split
                # tables; rebuild them from the f64 components
                from ..ops.ddmath import split_table_np

                tabs = []
                for c6 in op.coeff6:
                    tabs.extend(split_table_np(np.asarray(c6, np.float64)))
            self.coeff_dev = tuple(jnp.asarray(split_cells(t))
                                   for t in tabs)
        else:
            self._mode = "f32"
            self.coeff_dev = tuple(
                jnp.asarray(split_cells(np.asarray(t))) for t in op.coeff6)
        self.constrained_b = part.pad(op.constrained)
        del Q

    def _local_apply(self, W_or_pair, coeffs):
        op = self.op
        if self._mode == "dd":
            n_sym = len(coeffs) // 4
            c6dd = [tuple(coeffs[4 * k: 4 * k + 4]) for k in range(n_sym)]
            return op.apply_local_lanes_dd(W_or_pair[0], W_or_pair[1], c6dd)
        return op.apply_local_lanes(W_or_pair, coeffs)

    def vmult_blocked(self, ub):
        """(NB,) padded owner-blocked -> (NB,) result, SPMD."""
        part = self.part
        spec_v = P(AXIS)

        def kernel(ub_d, gt_d, ft_d, rt_d, *coeffs):
            gt = gt_d[0]
            ft = ft_d[0]
            rt = rt_d[0]
            cfs = [c[0] for c in coeffs]
            xfull = jax.lax.all_gather(ub_d, AXIS, tiled=True)  # (NB,)
            xfull = jnp.concatenate([xfull, jnp.zeros((1,), xfull.dtype)])
            local = xfull[ft]  # (n_loc+1,) incl zero slot
            if self._mode == "dd":
                from ..ops.ddmath import dd_from_f64

                lh, ll = dd_from_f64(local)
                W = (lh[gt], ll[gt])
                vh, vl = self._local_apply(W, cfs)
                v = vh.astype(ub_d.dtype) + vl.astype(ub_d.dtype)
            else:
                W = local[gt]
                v = self._local_apply(W, cfs)
            # scatter into own range + ghost block
            partv = jnp.zeros(part.n_loc + 1, ub_d.dtype).at[
                gt.reshape(-1)].add(v.reshape(-1))
            own = partv[: part.B]
            ghost = partv[part.B: part.B + part.Gmax]
            gall = jax.lax.all_gather(ghost, AXIS, tiled=False).reshape(-1)
            own = jnp.concatenate(
                [own, jnp.zeros((1,), own.dtype)]).at[rt].add(gall)[:-1]
            return own

        mesh = self.jmesh
        spec_t = lambda a: P(AXIS, *([None] * (a.ndim - 1)))
        fn = shard_map(
            kernel, mesh=mesh,
            in_specs=(spec_v, spec_t(part.gather_tab),
                      spec_t(part.fetch_tab), spec_t(part.recv_tab))
            + tuple(spec_t(c) for c in self.coeff_dev),
            out_specs=spec_v)
        u0 = jnp.where(self.constrained_b, 0.0, ub).astype(ub.dtype)
        out = fn(u0, part.gather_tab, part.fetch_tab, part.recv_tab,
                 *self.coeff_dev)
        return jnp.where(self.constrained_b, ub, out)

    def vmult_global(self, u):
        """(n,) old numbering in/out — the equality-test wrapper."""
        return self.part.unpad(self.vmult_blocked(self.part.pad(u)))


class ShardedGeneralASM:
    """Sharded twin of GeneralASMPreconditioner (lanes FDM apply).

    Patches split into contiguous index ranges; the per-patch eigen tables
    slice along their patch-last axis; weights/RAS masks ride the blocked
    dof layout.  Same gather -> local FDM -> scatter+exchange shape as the
    operator."""

    def __init__(self, asm, part: GeneralPartition, jmesh: Mesh):
        self.asm = asm
        self.part = part
        self.jmesh = jmesh
        D = part.n_dev
        idx = np.asarray(asm.patch_idx, np.int64)  # (P, Lp), n = pad
        self.tabs = part.slot_tables(idx)
        bounds = self.tabs.bounds
        Pmax = self.tabs.Smax

        def split_last(a):  # (..., P) -> (D, ..., Pmax), zero-padded
            a = np.asarray(a)
            out = np.zeros((D,) + a.shape[:-1] + (Pmax,), a.dtype)
            for d in range(D):
                lo, hi = bounds[d], bounds[d + 1]
                out[d, ..., : hi - lo] = a[..., lo:hi]
            return out

        Vt, lam = asm.lanes
        self.Vt_dev = tuple(jnp.asarray(split_last(v)) for v in Vt)
        self.lam_dev = tuple(jnp.asarray(split_last(l)) for l in lam)
        self.ras_dev = None
        if asm.ras_mask_T is not None:
            self.ras_dev = jnp.asarray(split_last(
                np.asarray(asm.ras_mask_T)))
        self.weights_b = part.pad(asm.weights)
        self.wt = asm.weighting_type
        self.m, self.dim = asm.m, asm.dim

    def vmult_blocked(self, xb):
        from ..precond.asm import fdm_apply_lanes

        part, tabs = self.part, self.tabs
        x = xb
        if self.wt in ("pre", "symm"):
            x = x * self.weights_b
        spec_v = P(AXIS)
        spec_t = lambda a: P(AXIS, *([None] * (a.ndim - 1)))

        ras = (self.ras_dev,) if self.ras_dev is not None else ()

        def kernel(x_d, gt_d, ft_d, rt_d, *tabs_dev):
            gt, ft, rt = gt_d[0], ft_d[0], rt_d[0]
            nV = len(self.Vt_dev)
            Vt = [t[0] for t in tabs_dev[:nV]]
            lam = [t[0] for t in tabs_dev[nV: 2 * nV]]
            rmask = tabs_dev[2 * nV][0] if ras else None
            xfull = jax.lax.all_gather(x_d, AXIS, tiled=True)
            xfull = jnp.concatenate([xfull, jnp.zeros((1,), xfull.dtype)])
            local = xfull[ft]
            W = local[gt]  # (Lp, Pmax)
            y = fdm_apply_lanes(W, self.m, self.dim, Vt, lam)
            if rmask is not None:
                y = y * rmask
            partv = jnp.zeros(part.B + tabs.Gmax + 1, x_d.dtype).at[
                gt.reshape(-1)].add(y.reshape(-1))
            own = partv[: part.B]
            ghost = partv[part.B: part.B + tabs.Gmax]
            gall = jax.lax.all_gather(ghost, AXIS, tiled=False).reshape(-1)
            own = jnp.concatenate(
                [own, jnp.zeros((1,), own.dtype)]).at[rt].add(gall)[:-1]
            return own

        fn = shard_map(
            kernel, mesh=self.jmesh,
            in_specs=(spec_v, spec_t(tabs.gather_tab), spec_t(tabs.fetch_tab),
                      spec_t(tabs.recv_tab))
            + tuple(spec_t(t) for t in self.Vt_dev)
            + tuple(spec_t(t) for t in self.lam_dev)
            + tuple(spec_t(t) for t in ras),
            out_specs=spec_v)
        dst = fn(x.astype(self.weights_b.dtype), tabs.gather_tab,
                 tabs.fetch_tab, tabs.recv_tab, *self.Vt_dev,
                 *self.lam_dev, *ras)
        if self.wt in ("post", "symm"):
            dst = dst * self.weights_b
        return dst

    def vmult_global(self, x):
        return self.part.unpad(self.vmult_blocked(self.part.pad(x)))


class ShardedGeneralTransfer:
    """Sharded-fine / replicated-coarse junction of GeneralTwoLevelTransfer.

    The replicated coarse side is the reference's shrinking-coarse analog
    (P7): every device holds the full coarse vector and runs the identical
    inner multigrid on it."""

    def __init__(self, tr, part: GeneralPartition, jmesh: Mesh):
        self.tr = tr
        self.part = part
        self.jmesh = jmesh
        D = part.n_dev
        fine_lat = np.asarray(tr.fine_lat, np.int64)  # (C, Lf)
        C = fine_lat.shape[0]
        self.tabs = part.slot_tables(fine_lat)
        bounds = self.tabs.bounds
        self.Cmax = self.tabs.Smax
        ccd = np.asarray(tr.coarse_cd, np.int64)  # (C, Lc)
        nc = tr.n_coarse
        ctab = np.full((D, self.Cmax, ccd.shape[1]), nc, np.int64)
        for d in range(D):
            lo, hi = bounds[d], bounds[d + 1]
            ctab[d, : hi - lo] = ccd[lo:hi]
        self.coarse_tab = jnp.asarray(ctab, jnp.int32)
        self.inv_valence_b = part.pad(tr.fine_inv_valence)
        self.fine_constrained_b = part.pad(tr.fine_constrained)

    def prolongate_blocked(self, uc):
        """replicated coarse (nc,) -> blocked fine (NB,)."""
        part, tabs, tr = self.part, self.tabs, self.tr
        spec_v = P(AXIS)
        spec_t = lambda a: P(AXIS, *([None] * (a.ndim - 1)))

        def kernel(uc_r, ct_d, gt_d, rt_d):
            ct, gt, rt = ct_d[0], gt_d[0], rt_d[0]
            u0 = jnp.where(tr.coarse_constrained, 0.0, uc_r)
            ucp = jnp.concatenate([u0, jnp.zeros((1,), u0.dtype)])
            ucell = ucp[ct]  # (Cmax, Lc)
            vf = tr._interp(ucell)  # (Cmax, Lf)
            partv = jnp.zeros(part.B + tabs.Gmax + 1, vf.dtype).at[
                gt.reshape(-1)].add(vf.T.reshape(-1))
            own = partv[: part.B]
            ghost = partv[part.B: part.B + tabs.Gmax]
            gall = jax.lax.all_gather(ghost, AXIS, tiled=False).reshape(-1)
            own = jnp.concatenate(
                [own, jnp.zeros((1,), own.dtype)]).at[rt].add(gall)[:-1]
            return own

        fn = shard_map(
            kernel, mesh=self.jmesh,
            in_specs=(P(), spec_t(self.coarse_tab), spec_t(tabs.gather_tab),
                      spec_t(tabs.recv_tab)),
            out_specs=spec_v)
        out = fn(uc, self.coarse_tab, tabs.gather_tab, tabs.recv_tab)
        out = out * self.inv_valence_b
        return jnp.where(self.fine_constrained_b, 0.0, out)

    def restrict_blocked(self, rb):
        """blocked fine (NB,) -> replicated coarse (nc,)."""
        part, tabs, tr = self.part, self.tabs, self.tr
        spec_v = P(AXIS)
        spec_t = lambda a: P(AXIS, *([None] * (a.ndim - 1)))
        r = jnp.where(self.fine_constrained_b, 0.0, rb)
        r = r * self.inv_valence_b

        def kernel(r_d, ct_d, gt_d, ft_d):
            ct, gt, ft = ct_d[0], gt_d[0], ft_d[0]
            rfull = jax.lax.all_gather(r_d, AXIS, tiled=True)
            rfull = jnp.concatenate([rfull, jnp.zeros((1,), rfull.dtype)])
            local = rfull[ft]
            W = local[gt]  # (Lf, Cmax)
            vc = tr._interp_t(W.T)  # (Cmax, Lc)
            out = jnp.zeros(tr.n_coarse + 1, vc.dtype).at[
                ct.reshape(-1)].add(vc.reshape(-1))[:-1]
            return jax.lax.psum(out, AXIS)

        fn = shard_map(
            kernel, mesh=self.jmesh,
            in_specs=(spec_v, spec_t(self.coarse_tab),
                      spec_t(tabs.gather_tab), spec_t(tabs.fetch_tab)),
            out_specs=P())
        out = fn(r, self.coarse_tab, tabs.gather_tab, tabs.fetch_tab)
        return jnp.where(self.tr.coarse_constrained, 0.0, out)
