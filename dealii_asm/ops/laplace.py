"""Matrix-free sum-factorized Laplace operator (JAX).

JAX rebuild of ``LaplaceOperatorMatrixFree``
(/root/reference/include/operator.h:269-1628).  The reference evaluates cell
integrals with deal.II FEEvaluation (even-odd sum factorization over SIMD cell
batches); here the cell batch is the leading array axis and the 1D contractions
are batched matmuls.  Constrained (Dirichlet) rows act as
identity, matching deal.II matrix-free convention
(/root/reference/include/matrix_free_internal.h:247-255).

Two compute paths:
- ``sumfac``: staged 1D contractions (7 fwd + 7 bwd in 3D) — fewest FLOPs;
- ``fused-B``: one batched (C×L)·(L×dim·Q) matmul for all gradients — more FLOPs
  but one large matmul; selectable because it can win at moderate p.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..fem.dofs import DofHandler
from ..fem.lagrange import shape_1d
from ..mesh.grid import _tensor_gradient, _tensor_weights
from .geometry import GeometryData, compute_geometry


def _apply_1d(mat: jnp.ndarray, u: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Contract ``mat`` (q, n) against local axis ``axis`` of u (C, ..., n, ...).

    axis counts the local tensor axes only (0 = slowest local axis).
    """
    # move target axis last, matmul, move back
    full_axis = 1 + axis
    u = jnp.moveaxis(u, full_axis, -1)
    u = jnp.matmul(u, mat.T)
    return jnp.moveaxis(u, -1, full_axis)


def gradients_sumfac(u, N1, D1, dim: int, n: int):
    """Cell-batched reference gradients: (C, n^dim) -> (C, Q, dim), x fastest."""
    u = u.reshape((-1,) + (n,) * dim)
    if dim == 2:
        t0 = _apply_1d(N1, u, 1)
        gy = _apply_1d(D1, t0, 0)
        gx = _apply_1d(N1, _apply_1d(D1, u, 1), 0)
        grads = [gx, gy]
    elif dim == 3:
        t0 = _apply_1d(N1, u, 2)
        t1 = _apply_1d(N1, t0, 1)
        gz = _apply_1d(D1, t1, 0)
        gy = _apply_1d(N1, _apply_1d(D1, t0, 1), 0)
        gx = _apply_1d(N1, _apply_1d(N1, _apply_1d(D1, u, 2), 1), 0)
        grads = [gx, gy, gz]
    else:
        raise NotImplementedError(dim)
    Q = N1.shape[0] ** dim
    return jnp.stack([g.reshape(-1, Q) for g in grads], axis=2)


def integrate_sumfac(t, N1, D1, dim: int):
    """Transpose of gradients_sumfac: (C, Q, dim) -> (C, n^dim)."""
    q = N1.shape[0]
    N, D = N1.T, D1.T
    Qshape = (-1,) + (q,) * dim
    if dim == 2:
        tx = t[:, :, 0].reshape(Qshape)
        ty = t[:, :, 1].reshape(Qshape)
        v = _apply_1d(N, _apply_1d(D, tx, 1), 0) + _apply_1d(
            D, _apply_1d(N, ty, 1), 0)
    else:
        tx = t[:, :, 0].reshape(Qshape)
        ty = t[:, :, 1].reshape(Qshape)
        tz = t[:, :, 2].reshape(Qshape)
        v = (_apply_1d(N, _apply_1d(N, _apply_1d(D, tx, 2), 1), 0)
             + _apply_1d(N, _apply_1d(D, _apply_1d(N, ty, 2), 1), 0)
             + _apply_1d(D, _apply_1d(N, _apply_1d(N, tz, 2), 1), 0))
    return v.reshape(v.shape[0], -1)


class LaplaceOperator:
    """Poisson/Laplace operator on a DofHandler.

    Parameters mirror the reference operator's AdditionalData (compress_indices
    and mapping_type are reinterpreted: geometry kind is chosen from the mesh).
    """

    def __init__(
        self,
        dofs: DofHandler,
        n_q_1d: int | None = None,
        mapping_degree: int | None = None,
        dtype=jnp.float64,
        geometry: GeometryData | None = None,
        kernel: str = "sumfac",
        mapping_type: str = "",
        matmul_precision: str | None = None,
    ):
        """mapping_type selects the deformed-geometry REPRESENTATION:
        "" / "merged" = precomputed symmetric w|J|J⁻¹J⁻ᵀ per q-point
        (operator.h:1162-1219); "linear geometry" / "quadratic geometry" =
        per-cell 2^dim / 3^dim mapping support points with Jacobians
        reconstructed in-trace at each q-point (operator.h:917-1033 /
        :1036-1159) — ~60x less geometry memory at Q4, more FLOPs."""
        self.dofs = dofs
        self.mesh = dofs.mesh
        self.degree = dofs.degree
        self.dim = self.mesh.dim
        self.n_q_1d = n_q_1d or (self.degree + 1)
        self.dtype = dtype
        self.kernel = kernel
        if mapping_degree is None:
            mapping_degree = 1 if self.mesh.transform is None else min(self.degree, 3)
        self.mapping_degree = mapping_degree
        self.geo_mode = "merged"
        self.geo_sp = None
        if (mapping_type in ("linear geometry", "quadratic geometry")
                and self.mesh.transform is not None):
            self.geo_mode = ("linear" if mapping_type == "linear geometry"
                             else "quadratic")
            mapping_degree = 1 if self.geo_mode == "linear" else 2
            self.mapping_degree = mapping_degree
        elif mapping_type == "construct q" and self.mesh.transform is not None:
            # store only the physical quadrature POINTS (dim·Q per cell) and
            # rebuild Jacobians in-trace by collocation differentiation
            # (operator.h:1221-1333 analog): J[..., e, d] = D_colloc applied
            # along reference axis d to coordinate e of the q-point lattice
            self.geo_mode = "construct_q"

        geo = geometry or compute_geometry(self.mesh, self.n_q_1d, mapping_degree)
        self.geometry = geo

        s = shape_1d(self.degree, self.n_q_1d)
        self.N1 = jnp.asarray(s.N, dtype)   # (q, n)
        self.D1 = jnp.asarray(s.D, dtype)   # (q, n)
        self._shape = s

        self._cell_dofs = None  # lazy: only the gather fallback needs it
        self.n_dofs = dofs.n_dofs
        self._constrained = None  # lazy O(n) mask (gather fallback only)
        # separable constraint mask: node constrained iff any lattice
        # coordinate sits on a non-periodic boundary — kept as dim small 1D
        # vectors and outer-product'ed IN-TRACE, so jitted programs carry no
        # grid-sized constants
        self._free_1d = []
        for a in range(self.dim):  # grid axes (z, y, x)
            d = self.dim - 1 - a
            f = np.ones(dofs.nodes_per_dim[d], dtype=bool)
            if not self.mesh.periodic[d]:
                f[0] = f[-1] = False
            self._free_1d.append(jnp.asarray(f))
        # lattice access: strided window slices instead of index-table
        # gather/scatter (ops/lattice.py) — the structured reduced access
        self.access = "lattice"
        self.grid_shape = tuple(reversed(dofs.nodes_per_dim))  # (Nz, Ny, Nx)

        if geo.kind == "cartesian":
            self.cell_widths = jnp.asarray(geo.cell_widths, dtype)  # (C, dim)
            self.quad_w = jnp.asarray(geo.quad_weights, dtype)      # (Q,)
            self.coeff = None
            # separable per-axis 1D matrices: cells are uniform, so the whole
            # cell operator is Σ_d K_d ⊗ Π_{e≠d} M_e with M_d = h_d·M_ref,
            # K_d = K_ref/h_d (constant-coefficient fast path; the reference's
            # Cartesian geometry representation, operator.h:917 analog)
            from ..fem.lagrange import reference_mass_stiffness_1d

            M_ref, K_ref = reference_mass_stiffness_1d(self.degree, self.n_q_1d)
            h = self.mesh.h
            self.M1d = [jnp.asarray(M_ref * h[d], dtype) for d in range(self.dim)]
            self.K1d = [jnp.asarray(K_ref / h[d], dtype) for d in range(self.dim)]
            # dense local stiffness: every cell of a uniform Cartesian mesh
            # shares ONE (L, L) matrix, so the whole cell loop is a single
            # (C, L)·(L, L) GEMM — the dense-matmul formulation of the
            # reference's "Cartesian geometry" fast path (operator.h:917)
            A_loc = np.zeros(((self.degree + 1) ** self.dim,) * 2)
            for d in range(self.dim):
                term = np.array([[1.0]])
                for e in reversed(range(self.dim)):  # kron: x fastest
                    m1 = (K_ref / h[e]) if e == d else (M_ref * h[e])
                    term = np.kron(term, m1)
                A_loc += term
            self.A_loc = jnp.asarray(A_loc, dtype)
            # globally separable form: A = Σ_d M̂⊗…K̂_d…⊗M̂ with assembled 1D
            # factors — applies as dense axis matmuls on the grid (tensorops)
            from .tensorops import (
                cartesian_stable_factors,
                global_laplace_1d_factors,
            )

            factors = global_laplace_1d_factors(self.mesh, self.degree,
                                                self.n_q_1d)
            self.M1d_global = [jnp.asarray(M, dtype) for M, _ in factors]
            self.K1d_global = [jnp.asarray(K, dtype) for _, K in factors]
            # banded (diagonal-table) form of the same factors: elementwise
            # shift-multiply-add applies, O((2p+1)·n) work per axis — the
            # native-f64 outer vmult.  kernel="dd" (kept only for its
            # tests) runs it as double-single f32 pairs (ops/ddmath.py)
            from .tensorops import banded_diagonals

            bw = self.degree
            self.Mdiags, self.Kdiags, self.band_offsets = [], [], []
            self.Mdd, self.Kdd = [], []
            want_dd = np.dtype(self.dtype) == np.float64 and kernel == "dd"
            for d, (M, K) in enumerate(factors):
                md, offs = banded_diagonals(np.asarray(M), bw,
                                            self.mesh.periodic[d])
                kd, _ = banded_diagonals(np.asarray(K), bw,
                                         self.mesh.periodic[d])
                self.Mdiags.append(jnp.asarray(md, dtype))
                self.Kdiags.append(jnp.asarray(kd, dtype))
                self.band_offsets.append(tuple(offs))
                if want_dd:
                    from .ddmath import split_table_np

                    self.Mdd.append(tuple(
                        jnp.asarray(t) for t in split_table_np(md)))
                    self.Kdd.append(tuple(
                        jnp.asarray(t) for t in split_table_np(kd)))
            # gradient-factored alternative form (kernel="stable"): measured
            # to have the SAME low-precision rounding behavior as the
            # Kronecker-sum form (the 1/h cancellation reappears in the
            # integration stage), so it is opt-in only; accurate residuals at
            # scale come from the f64 outer solve (P8), as in the reference
            self.stable_factors = None
            if kernel == "stable":
                sf = cartesian_stable_factors(self.mesh, self.degree,
                                              self.n_q_1d, dofs.nodes_per_dim)
                self.stable_factors = [
                    [jnp.asarray(E, dtype) for E in row] for row in sf]
        elif self.geo_mode == "construct_q":
            self.coeff = None
            from ..fem.lagrange import (
                gauss_lobatto_points,
                lagrange_derivatives,
                lagrange_values,
            )

            # q-points OF THE ISOPARAMETRIC MAPPING (degree m ≤ n_q−1 so the
            # collocation derivative of their interpolant is EXACT for the
            # mapping); exact-transform points would make the interpolant a
            # different — possibly folding — geometry
            mdeg = min(self.mapping_degree, self.n_q_1d - 1)
            sp = self.mesh.mapping_support_points(mdeg)  # (C, Lm, dim)
            gll = gauss_lobatto_points(mdeg + 1)
            Nt = _tensor_values(lagrange_values(gll, s.q), self.dim)  # (Q, Lm)
            qp = np.einsum("ql,cld->cqd", Nt, sp)
            self.geo_qp = jnp.asarray(qp, dtype)  # (C, Q, dim)
            # collocation derivative on the 1D quadrature points (unit cell)
            self.Dcol = jnp.asarray(lagrange_derivatives(s.q, s.q), dtype)
            self.quad_w = jnp.asarray(_tensor_weights([s.w] * self.dim), dtype)
            self.access = "gather"
        elif self.geo_mode in ("linear", "quadratic"):
            # compact geometry: per-cell 2^dim/3^dim mapping support points;
            # Jacobians reconstructed in-trace at q-points (operator.h:917,
            # :1036 analogs) — gather path, no q-grid coefficient tensors
            self.coeff = None
            from ..fem.lagrange import (
                gauss_lobatto_points,
                lagrange_derivatives,
                lagrange_values,
            )

            mdeg = self.mapping_degree
            sp = self.mesh.mapping_support_points(mdeg)  # (C, Lm, dim)
            self.geo_sp = jnp.asarray(sp, dtype)
            gll = gauss_lobatto_points(mdeg + 1)
            Ngeo = lagrange_values(gll, s.q)
            Dgeo = lagrange_derivatives(gll, s.q)
            Bgeo = _tensor_gradient(Ngeo, Dgeo, self.dim)  # (Q, Lm, dim)
            self.gradN_geo = jnp.asarray(Bgeo, dtype)
            self.quad_w = jnp.asarray(_tensor_weights([s.w] * self.dim), dtype)
            self.access = "gather"
        else:
            self.coeff = jnp.asarray(geo.coeff, dtype)  # (C, Q, dim, dim)
            # deformed-geometry tensor path: global per-axis value/derivative
            # evaluation matrices + symmetric coefficient on the q-grid
            from .tensorops import interp_direction_transform

            s0 = shape_1d(self.degree, self.n_q_1d)
            self.Ev, self.Ed, self.Evt, self.Edt = [], [], [], []
            for d in range(self.dim):
                Ev = interp_direction_transform(
                    s0.N, dofs.nodes_per_dim[d], self.degree,
                    self.mesh.n_cells[d], self.mesh.periodic[d])
                Ed = interp_direction_transform(
                    s0.D / self.mesh.h[d], dofs.nodes_per_dim[d], self.degree,
                    self.mesh.n_cells[d], self.mesh.periodic[d])
                self.Ev.append(jnp.asarray(Ev, dtype))
                self.Ed.append(jnp.asarray(Ed, dtype))
                self.Evt.append(jnp.asarray(Ev.T, dtype))
                self.Edt.append(jnp.asarray(Ed.T, dtype))
            # small shared per-cell transforms for the window-form apply
            # (f64 outer path): (q, p+1) value/derivative matrices
            self.Nq_small = jnp.asarray(s0.N, dtype)
            self.NqT_small = jnp.asarray(s0.N.T, dtype)
            self.Dq_small = [jnp.asarray(s0.D / self.mesh.h[d], dtype)
                             for d in range(self.dim)]
            self.DqT_small = [jnp.asarray((s0.D / self.mesh.h[d]).T, dtype)
                              for d in range(self.dim)]
            # coefficient on the q-grid, symmetric-packed; the merged coeff is
            # in REFERENCE gradients, while Ed above differentiates in box
            # coords (∂ξ = h·∂box) — scale accordingly: C_box = h_d C_ref h_e
            qn = self.n_q_1d
            cells_zyx = tuple(reversed(self.mesh.n_cells))
            cc = geo.coeff.reshape(cells_zyx + (qn,) * self.dim
                                   + (self.dim, self.dim))
            # (cz,cy,cx,qz,qy,qx,d,e) -> (cz,qz,cy,qy,cx,qx,d,e)
            perm = []
            for i in range(self.dim):
                perm += [i, self.dim + i]
            cc = cc.transpose(tuple(perm) + (2 * self.dim, 2 * self.dim + 1))
            qshape = tuple(c * qn for c in cells_zyx)
            cc = cc.reshape(qshape + (self.dim, self.dim))
            h = self.mesh.h
            pairs = ([(0, 0), (1, 1), (0, 1)] if self.dim == 2
                     else [(0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)])
            self.coeff6 = [
                jnp.asarray(cc[..., a, b_] * (h[a] * h[b_]), dtype)
                for a, b_ in pairs
            ]
            # host f64 copies of the small shared transforms + pre-split
            # coefficient tables for the double-single windowed f64 apply
            # (kernel="dd", tensorops.merged_laplace_apply_windowed_dd)
            self._Nq_np = np.asarray(s0.N, np.float64)
            self._Dq_np = [np.asarray(s0.D, np.float64) / self.mesh.h[d]
                           for d in range(self.dim)]
            self.coeff6_dd = None
            if np.dtype(dtype) == np.float64 and kernel == "dd":
                from .ddmath import split_table_np

                tabs = []
                for a, b_ in pairs:
                    t64 = np.asarray(cc[..., a, b_], np.float64) * (
                        h[a] * h[b_])
                    tabs.extend(jnp.asarray(x) for x in split_table_np(t64))
                self.coeff6_dd = tuple(tabs)
        self.jxw = jnp.asarray(geo.jxw, dtype)           # (C, Q)

        # reference-gradient tensor for the fused-B path and diagonal
        # computation — lazy (device upload only when actually used)
        self._B_dev = None

        # matmul precision: an f32 matmul that names none may run in TF32
        # on the GPU, whose ~1e-3 operand rounding is amplified ~1/h² on
        # smooth modes and poisons deep f32 MG hierarchies.  MG level
        # operators pass "highest" (true-f32 dots).
        self.matmul_precision = matmul_precision

        # the merged-geometry coefficient tensors are O(n): pass them as jit
        # ARGUMENTS, not captured constants embedded in the program
        if getattr(self, "coeff6_dd", None) is not None:
            self._coeff_args = self.coeff6_dd
        else:
            self._coeff_args = tuple(getattr(self, "coeff6", ()) or ())
        self._vmult = jax.jit(lambda u, *c6: self._vmult_impl(u, c6))
        # fused-vector-op forms (the reference fuses pre/post vector updates
        # into the cell loop, operator.h:1368-1430; under XLA the fusion is
        # automatic inside one jitted expression)
        self._residual = jax.jit(
            lambda b, x, *c6: b - self._vmult_impl(x, c6))

    def residual(self, b, x):
        """r = b - A x as one fused program."""
        return self._residual(b, x, *self._coeff_args)

    @property
    def constrained(self):
        if self._constrained is None:
            with jax.ensure_compile_time_eval():  # trace-safe lazy constant
                self._constrained = jnp.asarray(self.dofs.boundary_mask)
        return self._constrained

    def _free_mask(self):
        """(n,) free-node mask built in-trace from dim small 1D vectors."""
        f = self._free_1d[0]
        for v in self._free_1d[1:]:
            f = f[..., None] & v
        return f.reshape(-1)

    @property
    def cell_dofs(self):
        if self._cell_dofs is None:
            with jax.ensure_compile_time_eval():  # trace-safe lazy constant
                self._cell_dofs = jnp.asarray(self.dofs.cell_dofs)
        return self._cell_dofs

    @cell_dofs.setter
    def cell_dofs(self, v):
        self._cell_dofs = v

    @property
    def B(self):
        if self._B_dev is None:
            with jax.ensure_compile_time_eval():  # trace-safe lazy constant
                self._B_dev = jnp.asarray(self._B_np, self.dtype)
        return self._B_dev

    @property
    def _B_np(self):
        B = getattr(self, "_B_np_cache", None)
        if B is None:
            s = self._shape
            B = _tensor_gradient(s.N, s.D, self.dim)
            self._B_np_cache = B
        return B

    # -- local integral -------------------------------------------------------

    def _local_shape(self, n):
        return (-1,) + (n,) * self.dim

    def _gradients_sumfac(self, u):
        """u (C, n^dim flattened local, x fastest) -> gradients at q (C, Q, dim)."""
        return gradients_sumfac(u, self.N1, self.D1, self.dim, self.degree + 1)

    def _integrate_sumfac(self, t):
        """t (C, Q, dim) -> v (C, L): v = Σ_d ∫ ∂_d φ · t_d."""
        return integrate_sumfac(t, self.N1, self.D1, self.dim)

    def _construct_q_jacobians(self):
        """(C, Q, dim, dim) Jacobians from stored physical q-points by
        collocation differentiation along each reference axis."""
        q1 = self.n_q_1d
        qp = self.geo_qp.reshape((-1,) + (q1,) * self.dim + (self.dim,))
        cols = []
        for d in range(self.dim):  # reference direction (x first)
            axis_full = 1 + (self.dim - 1 - d)
            t = jnp.moveaxis(qp, axis_full, -1)       # (..., dim, q)
            t = jnp.matmul(t, self.Dcol.T)
            cols.append(jnp.moveaxis(t, -1, axis_full))
        J = jnp.stack(cols, axis=-1)  # (C, qz.., dim(e), dim(d))
        return J.reshape(J.shape[0], -1, self.dim, self.dim)

    def _apply_coefficient(self, g):
        """g (C, Q, dim) reference gradients -> coefficient-scaled (C, Q, dim)."""
        if self.geo_sp is not None or self.geo_mode == "construct_q":
            if self.geo_mode == "construct_q":
                J = self._construct_q_jacobians()
            else:
                # in-trace Jacobians from the compact support points;
                # K[..., e, f] = ∂ξ_f/∂x_e (cofactor transpose, _small_inv_det)
                J = jnp.einsum("qld,cle->cqed", self.gradN_geo, self.geo_sp)
            det, K = _small_inv_det(J, self.dim)
            sgrad = jnp.einsum("cqef,cqf->cqe", K, g)   # physical gradient
            t = jnp.einsum("cqed,cqe->cqd", K, sgrad)   # back to reference
            return t * (self.quad_w[None, :, None] * det[..., None])
        if self.coeff is not None:
            return jnp.einsum("cqde,cqe->cqd", self.coeff, g)
        # cartesian: coeff diag = w_q * prod(h) / h_d^2
        h = self.cell_widths  # (C, dim)
        detj = jnp.prod(h, axis=1, keepdims=True)  # (C, 1)
        scale = detj / (h * h)  # (C, dim)
        return g * self.quad_w[None, :, None] * scale[:, None, :]

    def apply_cells(self, u_cells):
        """Local cell integral: (C, L) -> (C, L)."""
        if self.kernel == "fused-B":
            # g[c,q,d] = Σ_l B[q,l,d] u[c,l] — one (C×L)·(L×dim·Q) matmul
            g = jnp.einsum("qld,cl->cqd", self.B, u_cells)
            t = self._apply_coefficient(g)
            return jnp.einsum("qld,cqd->cl", self.B, t)
        g = self._gradients_sumfac(u_cells)
        t = self._apply_coefficient(g)
        return self._integrate_sumfac(t)

    # -- global apply ----------------------------------------------------------

    def _cartesian_separable(self, w):
        """Σ_d K_d ⊗ Π M_e on interleaved windows (m-axes at 1, 3, 5)."""
        from .lattice import apply_axis_shared as ap

        if self.dim == 2:
            # axes: (Cy, my, Cx, mx); direction x = axis 3, y = axis 1
            Mx, My = self.M1d[0], self.M1d[1]
            Kx, Ky = self.K1d[0], self.K1d[1]
            a = ap(w, 3, Mx)
            v = ap(a, 1, Ky) + ap(ap(w, 3, Kx), 1, My)
            return v
        Mx, My, Mz = self.M1d
        Kx, Ky, Kz = self.K1d
        a = ap(w, 5, Mx)           # Mx u
        b = ap(a, 3, My)           # My Mx u
        v = ap(b, 1, Kz)           # Kz My Mx u
        v = v + ap(ap(a, 3, Ky), 1, Mz)   # Mz Ky Mx u
        v = v + ap(ap(ap(w, 5, Kx), 3, My), 1, Mz)  # Mz My Kx u
        return v

    def _vmult_impl(self, u, coeff6=None):
        if self.matmul_precision is not None:
            with jax.default_matmul_precision(self.matmul_precision):
                return self._vmult_inner(u, coeff6)
        return self._vmult_inner(u, coeff6)

    def _vmult_inner(self, u, coeff6=None):
        if coeff6 is None or len(coeff6) == 0:
            coeff6 = getattr(self, "coeff6", None)
        if self.access == "lattice":
            free = self._free_mask()
            u0 = jnp.where(free, u, 0.0).astype(self.dtype)
        else:
            free = None
            u0 = jnp.where(self.constrained, 0.0, u).astype(self.dtype)
        if self.access == "lattice" and self.coeff is None:
            from .tensorops import (
                separable_laplace_apply,
                separable_laplace_apply_banded,
                separable_stable_apply,
            )

            if self.stable_factors is not None:
                dst = separable_stable_apply(
                    u0.reshape(self.grid_shape), self.stable_factors,
                    self.dim).reshape(-1)
            elif self.Mdd:
                # double-single path (kernel="dd"): hi/lo f32 pairs with
                # error-free Dekker products and compensated sums
                # (ops/ddmath.py), ~47-bit accurate
                from .ddmath import dd_from_f64, dd_to_f64
                from .tensorops import separable_laplace_apply_banded_dd

                ob = jax.lax.optimization_barrier
                uh, ul = dd_from_f64(u0.reshape(self.grid_shape))
                uh, ul = ob((uh, ul))
                vh, vl = ob(separable_laplace_apply_banded_dd(
                    uh, ul, self.Mdd, self.Kdd, self.band_offsets,
                    self.dim, self.mesh.periodic))
                dst = dd_to_f64(vh, vl).reshape(-1)
            elif (self.kernel == "banded"
                  or np.dtype(self.dtype) == np.float64):
                # optimization_barrier: with flat in/out, XLA layout
                # assignment may propagate the packed 1D layout through the
                # shift-mad chain and turn every shift into a relayout
                ob = jax.lax.optimization_barrier
                dst = ob(separable_laplace_apply_banded(
                    ob(u0.reshape(self.grid_shape)), self.Mdiags, self.Kdiags,
                    self.band_offsets, self.dim,
                    self.mesh.periodic)).reshape(-1)
            else:
                dst = separable_laplace_apply(
                    u0.reshape(self.grid_shape), self.M1d_global,
                    self.K1d_global, self.dim).reshape(-1)
        elif self.access == "lattice":
            from .tensorops import (
                merged_laplace_apply,
                merged_laplace_apply_windowed,
                merged_laplace_apply_windowed_dd,
            )

            if getattr(self, "coeff6_dd", None) is not None:
                # double-single windowed form (kernel="dd"): f32
                # Dekker/TwoSum pairs in place of f64 arithmetic
                from .ddmath import dd_from_f64, dd_to_f64

                n_sym = 6 if self.dim == 3 else 3
                c6 = coeff6 if len(coeff6) == 4 * n_sym else self.coeff6_dd
                qn = self.n_q_1d
                cells_zyx = tuple(reversed(self.mesh.n_cells))
                ishape = tuple(
                    v for cz in cells_zyx for v in (cz, qn))
                c6dd = [tuple(t.reshape(ishape) for t in c6[4 * k: 4 * k + 4])
                        for k in range(n_sym)]
                ob = jax.lax.optimization_barrier
                uh, ul = dd_from_f64(u0.reshape(self.grid_shape))
                uh, ul = ob((uh, ul))
                vh, vl = ob(merged_laplace_apply_windowed_dd(
                    uh, ul, self._Nq_np, self._Dq_np, c6dd,
                    self.mesh.n_cells, self.degree, self.mesh.periodic,
                    self.dim))
                dst = dd_to_f64(vh, vl).reshape(-1)
            elif self.kernel == "banded" or np.dtype(self.dtype) == np.float64:
                # window form: small shared (q, p+1) transforms per cell
                # instead of the global dense E-matmuls, whose inner
                # dimension is the whole axis
                qn = self.n_q_1d
                cells_zyx = tuple(reversed(self.mesh.n_cells))
                ishape = (cells_zyx[0], qn, cells_zyx[1], qn, cells_zyx[2], qn
                          ) if self.dim == 3 else (
                              cells_zyx[0], qn, cells_zyx[1], qn)
                c6i = [c.reshape(ishape) for c in coeff6]
                ob = jax.lax.optimization_barrier
                dst = ob(merged_laplace_apply_windowed(
                    ob(u0.reshape(self.grid_shape)), self.Nq_small,
                    self.Dq_small, self.NqT_small, self.DqT_small, c6i,
                    self.mesh.n_cells, self.degree, self.mesh.periodic,
                    self.dim)).reshape(-1)
            else:
                dst = merged_laplace_apply(
                    u0.reshape(self.grid_shape), self.Ev, self.Ed, self.Evt,
                    self.Edt, coeff6, self.dim).reshape(-1)
        else:
            uc = u0[self.cell_dofs]  # (C, L)
            v = self.apply_cells(uc)
            dst = jnp.zeros_like(u0).at[self.cell_dofs.reshape(-1)].add(
                v.reshape(-1))
        if free is not None:
            return jnp.where(free, dst, u)
        return jnp.where(self.constrained, u, dst)

    def vmult(self, u):
        return self._vmult(u, *self._coeff_args)

    def vmult_traceable(self, u):
        """Un-jitted apply, for composition inside larger jitted programs."""
        return self._vmult_impl(u)

    @property
    def supports_dd(self) -> bool:
        """True when vmult_dd is available (dd-pair outer Krylov loops):
        Cartesian geometry with kernel="dd"."""
        return bool(getattr(self, "Mdd", None))

    def vmult_dd(self, uh, ul):
        """A·u on a double-single pair (hi, lo f32) — the dd-CG matvec.

        Same arithmetic as the f64 vmult's dd path but WITHOUT the
        f64↔dd conversions and f64 constraint masking around it (each an
        f64 pass over the vector; the all-dd outer CG keeps its
        state in f32 pairs end-to-end).  Constrained rows are identity, as
        in vmult (reference operator.h:1368-1430 semantics)."""
        assert self.supports_dd
        free = self._free_mask()
        u0h = jnp.where(free, uh, 0.0).astype(jnp.float32)
        u0l = jnp.where(free, ul, 0.0).astype(jnp.float32)
        from .tensorops import separable_laplace_apply_banded_dd

        ob = jax.lax.optimization_barrier
        gh = u0h.reshape(self.grid_shape)
        gl = u0l.reshape(self.grid_shape)
        gh, gl = ob((gh, gl))
        vh, vl = ob(separable_laplace_apply_banded_dd(
            gh, gl, self.Mdd, self.Kdd, self.band_offsets,
            self.dim, self.mesh.periodic))
        vh, vl = vh.reshape(-1), vl.reshape(-1)
        return jnp.where(free, vh, uh), jnp.where(free, vl, ul)

    def __call__(self, u):
        return self.vmult(u)

    # -- diagonal / rhs / dense -------------------------------------------------

    def compute_inverse_diagonal(self):
        """Matrix-free diagonal (constrained rows = 1), inverted.

        Mirrors compute_inverse_diagonal (/root/reference/include/operator.h:1512).
        """
        if self.coeff is None and self.access == "lattice":
            # diag(Σ_d ⊗ M̂…K̂_d…M̂) = Σ_d ⊗ diag(·): outer products of the
            # global 1D diagonals — no cell loop at all
            dM = [jnp.diagonal(M) for M in self.M1d_global]
            dK = [jnp.diagonal(K) for K in self.K1d_global]
            diag = None
            for d in range(self.dim):
                vecs = [dK[e] if e == d else dM[e]
                        for e in reversed(range(self.dim))]  # z slowest first
                term = vecs[0]
                for v in vecs[1:]:
                    term = (term[:, None] * v[None, :]).reshape(-1)
                diag = term if diag is None else diag + term
            diag = jnp.where(self._free_mask(), diag, 1.0)
            return 1.0 / diag
        if (self.coeff is not None or self.geo_sp is not None
                or self.geo_mode == "construct_q"):
            coeff = (self.coeff if self.coeff is not None
                     else jnp.asarray(self.geometry.coeff, self.dtype))
            local = jnp.einsum("cqde,qld,qle->cl", coeff, self.B, self.B)
        else:
            h = self.cell_widths
            detj = jnp.prod(h, axis=1, keepdims=True)
            scale = detj / (h * h)  # (C, dim)
            wq = self.quad_w
            local = jnp.einsum("q,cd,qld->cl", wq, scale, self.B * self.B)
        diag = jnp.zeros(self.n_dofs, self.dtype).at[self.cell_dofs.reshape(-1)].add(
            local.reshape(-1)
        )
        diag = jnp.where(self.constrained, 1.0, diag)
        return 1.0 / diag

    def assemble_rhs(self, f, dirichlet=None):
        """b_i = ∫ f φ_i with inhomogeneous Dirichlet lift (operator.h:297-395 analog)."""
        geo = self.geometry
        fq = np.asarray(f(geo.q_points.reshape(-1, self.dim))).reshape(geo.jxw.shape)
        s = self._shape
        Nval = _tensor_values(s.N, self.dim)  # (Q, L)
        local = np.einsum("cq,ql->cl", geo.jxw * fq, Nval)
        b = np.zeros(self.n_dofs)
        np.add.at(b, np.asarray(self.dofs.cell_dofs).reshape(-1), local.reshape(-1))
        mask = np.asarray(self.dofs.boundary_mask)
        if dirichlet is not None:
            g = np.zeros(self.n_dofs)
            g[mask] = np.asarray(dirichlet(self.dofs.points[mask]))
            if np.any(g != 0.0):
                ag = np.asarray(self.vmult(jnp.asarray(np.where(mask, 0.0, g), self.dtype)))
                # A(0 with g at constrained) under our vmult is zero at free rows;
                # we need A·g restricted to free rows: do the cell loop with g values.
                gc = np.asarray(g)[np.asarray(self.dofs.cell_dofs)]
                v = np.asarray(self.apply_cells(jnp.asarray(gc, self.dtype)))
                lift = np.zeros(self.n_dofs)
                np.add.at(lift, np.asarray(self.dofs.cell_dofs).reshape(-1), v.reshape(-1))
                b = b - lift
            b[mask] = g[mask]
        else:
            b[mask] = 0.0
        return jnp.asarray(b, self.dtype)


def _tensor_values(N: np.ndarray, dim: int) -> np.ndarray:
    out = np.array([[1.0]])
    for _ in range(dim):
        out = np.kron(out, N)
    return out


def _small_inv_det(J, dim: int):
    """(det, K) of (..., dim, dim) Jacobians via cofactors (in-trace).

    J[..., e, d] = ∂x_e/∂ξ_d; returns K[..., e, d] = ∂ξ_d/∂x_e (i.e. the
    TRANSPOSE of the matrix inverse of J viewed with rows e / cols d)."""
    if dim == 2:
        a, b = J[..., 0, 0], J[..., 0, 1]
        c, d = J[..., 1, 0], J[..., 1, 1]
        det = a * d - b * c
        inv = jnp.stack([
            jnp.stack([d, -c], axis=-1),
            jnp.stack([-b, a], axis=-1),
        ], axis=-2) / det[..., None, None]
        return det, inv
    a = J[..., 0, 0]; b = J[..., 0, 1]; c = J[..., 0, 2]
    d = J[..., 1, 0]; e = J[..., 1, 1]; f = J[..., 1, 2]
    g_ = J[..., 2, 0]; h = J[..., 2, 1]; i = J[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g_)
    C = d * h - e * g_
    det = a * A + b * B + c * C
    # adjugate transposed into Jinv[d, e] = cof(J)[e, d] / det
    inv = jnp.stack([
        jnp.stack([A, B, C], axis=-1),
        jnp.stack([-(b * i - c * h), a * i - c * g_, -(a * h - b * g_)],
                  axis=-1),
        jnp.stack([b * f - c * e, -(a * f - c * d), a * e - b * d], axis=-1),
    ], axis=-2) / det[..., None, None]
    return det, inv
