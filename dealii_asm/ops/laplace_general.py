"""Matrix-free Laplace operator on unstructured meshes (gather/scatter path).

The unstructured counterpart of ``LaplaceOperator`` — the hyperball family and
any mesh whose cells rotate relative to each other.  Where the structured
operator turns into global axis matmuls, here the apply is the reference's own
shape (/root/reference/include/operator.h:269-1628): gather cell DoFs
(orientation already baked into the index table, see fem/general_dofs.py) →
sum-factorized gradients → merged symmetric coefficient per q-point
(operator.h:1162-1219) → transpose integration → scatter-add.  Constrained
(Dirichlet) rows act as identity (matrix_free_internal.h:247-255 convention).

Two local-apply layouts:

- ``kernel="lanes"`` (default, the production path): cells travel on the
  LAST (lane) axis — local tensors are (n, ..., n, C), the shared 1D shape
  matrices apply as unrolled scalar broadcast-FMAs, and the merged
  coefficient is six symmetric components of shape (q, ..., q, C).
  ``kernel="lanes-dd"`` runs the same layout's f64 apply as double-single
  f32 pairs (ops/ddmath.py); it is kept only for its tests, not as a user
  option.
- ``kernel="sumfac"``/``"fused-B"``: the patch-major oracle (kept for
  equality tests and small problems).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..fem.general_dofs import GeneralDofHandler
from ..fem.lagrange import shape_1d
from ..mesh.grid import _tensor_gradient, _tensor_weights
from .laplace import gradients_sumfac, integrate_sumfac, _tensor_values

# symmetric coefficient component order per dim: upper triangle of (d, e)
_SYM_PAIRS = {2: [(0, 0), (0, 1), (1, 1)],
              3: [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]}


def _axis_apply_shared(u, axis: int, M):
    """Apply a shared (q_out, q_in) 1D matrix along ``axis`` of a lane-major
    tensor (..., C): q_out·q_in unrolled broadcast-FMAs with scalar
    coefficients — elementwise streaming over the (…, C) slabs."""
    u = jnp.moveaxis(u, axis, 0)
    qo, qi = M.shape
    outs = []
    for i in range(qo):
        acc = None
        for j in range(qi):
            t = u[j] * M[i, j]
            acc = t if acc is None else acc + t
        outs.append(acc)
    return jnp.moveaxis(jnp.stack(outs, 0), 0, axis)


class GeneralLaplaceOperator:
    """Poisson operator on a GeneralDofHandler (merged-coefficient geometry)."""

    def __init__(self, dofs: GeneralDofHandler, n_q_1d: int | None = None,
                 mapping_degree: int | None = None, dtype=jnp.float64,
                 kernel: str = "lanes", matmul_precision: str | None = None):
        self.dofs = dofs
        self.mesh = dofs.mesh
        self.degree = dofs.degree
        self.dim = self.mesh.dim
        self.n_q_1d = n_q_1d or (self.degree + 1)
        self.dtype = dtype
        want_dd = kernel == "lanes-dd" and np.dtype(dtype) == np.float64
        kernel = "lanes" if kernel == "lanes-dd" else kernel
        self.kernel = kernel
        self.matmul_precision = matmul_precision
        if mapping_degree is None:
            # the reference caps the ball's mapping at 2
            # (element_centered_preconditioners_01.cc:398-401)
            mapping_degree = 1 if self.mesh.project is None else 2
        self.mapping_degree = mapping_degree

        s = shape_1d(self.degree, self.n_q_1d)
        self.N1 = jnp.asarray(s.N, dtype)
        self.D1 = jnp.asarray(s.D, dtype)
        self._N_np = np.asarray(s.N, np.float64)
        self._D_np = np.asarray(s.D, np.float64)
        self._shape = s

        wq = _tensor_weights([s.w] * self.dim)
        from .geometry import merged_det_coeff

        # one XLA-CPU program for J/det/inv/coeff (host BLAS is unvectorized
        # on this class of VM; see geometry.merged_det_coeff)
        Bj, spj = self.mesh.jacobian_factors(mapping_degree, s.q)
        detj, coeff = merged_det_coeff(Bj, spj, wq, self.dim)
        if (detj <= 0).any():
            raise ValueError("non-positive Jacobian determinant")
        self._jxw_np = wq[None, :] * detj
        self.jxw = jnp.asarray(self._jxw_np, dtype)

        self.n_dofs = dofs.n_dofs
        self.cell_dofs = jnp.asarray(dofs.cell_dofs)
        self.constrained = jnp.asarray(dofs.boundary_mask)
        self._B_np = _tensor_gradient(s.N, s.D, self.dim)  # (Q, L, dim)
        self._B_dev = None

        C = coeff.shape[0]
        q = self.n_q_1d
        if kernel == "lanes":
            # six symmetric components, cells on lanes: (q, ..., q, C) each
            self.coeff = None
            comps_np = [np.ascontiguousarray(
                coeff[:, :, d, e].T.reshape((q,) * self.dim + (C,)))
                for d, e in _SYM_PAIRS[self.dim]]
            self.coeff6 = tuple(jnp.asarray(c, dtype) for c in comps_np)
            self.cell_dofs_T = jnp.asarray(np.ascontiguousarray(
                np.asarray(dofs.cell_dofs).T.astype(np.int32)))  # (L, C)
            self._coeff_args = self.coeff6
            # f64 lanes-dd: double-single local apply (f32 Dekker/TwoSum
            # pairs in place of f64 arithmetic)
            self.coeff6_dd = None
            if want_dd:
                from .ddmath import split_table_np

                tabs = []
                for c in comps_np:
                    tabs.extend(jnp.asarray(t) for t in split_table_np(c))
                self.coeff6_dd = tuple(tabs)
                self._coeff_args = self.coeff6_dd
        else:
            self.coeff = jnp.asarray(coeff, dtype)
            self.coeff6 = None
            self.coeff6_dd = None
            self._coeff_args = (self.coeff,)

        # coefficients are O(cells): pass as jit arguments, not captured
        # constants.  inline=True: under an OUTER jit (the solver loop) this
        # trace inlines, so the gather tables (cell_dofs_T etc.) surface as
        # outer consts where jit_hoist_consts lifts them to runtime
        # parameters — a nested pjit keeps them as inner-jaxpr literals.
        self._vmult = jax.jit(lambda u, *cf: self._vmult_impl(u, *cf),
                              inline=True)
        self._residual = jax.jit(
            lambda b, x, *cf: b - self._vmult_impl(x, *cf), inline=True)

    @property
    def B(self):
        if self._B_dev is None:
            self._B_dev = jnp.asarray(self._B_np, self.dtype)
        return self._B_dev

    def apply_cells(self, u_cells, coeff=None):
        """Local cell integral (C, L) -> (C, L)."""
        if coeff is None:
            coeff = self.coeff
        if self.kernel == "fused-B":
            g = jnp.einsum("qld,cl->cqd", self.B, u_cells)
            t = jnp.einsum("cqde,cqe->cqd", coeff, g)
            return jnp.einsum("qld,cqd->cl", self.B, t)
        g = gradients_sumfac(u_cells, self.N1, self.D1, self.dim,
                             self.degree + 1)
        t = jnp.einsum("cqde,cqe->cqd", coeff, g)
        return integrate_sumfac(t, self.N1, self.D1, self.dim)

    def apply_local_lanes(self, W, coeff6=None):
        """Lane-major local cell integral (L, C) -> (L, C).

        Gradients/integration as unrolled shared-matrix FMAs over (…, C)
        slabs; the merged symmetric coefficient applies as six elementwise
        multiplies.  No (C, n, n, n) tensor anywhere."""
        if coeff6 is None:
            coeff6 = self.coeff6
        dim, n, q = self.dim, self.degree + 1, self.n_q_1d
        C = W.shape[-1]
        N, D = self.N1, self.D1
        u = W.reshape((n,) * dim + (C,))
        if dim == 2:
            gx = _axis_apply_shared(_axis_apply_shared(u, 1, D), 0, N)
            gy = _axis_apply_shared(_axis_apply_shared(u, 1, N), 0, D)
            c00, c01, c11 = coeff6
            tx = c00 * gx + c01 * gy
            ty = c01 * gx + c11 * gy
            v = (_axis_apply_shared(_axis_apply_shared(tx, 1, D.T), 0, N.T)
                 + _axis_apply_shared(_axis_apply_shared(ty, 1, N.T), 0, D.T))
        elif dim == 3:
            t0 = _axis_apply_shared(u, 2, N)
            t1 = _axis_apply_shared(t0, 1, N)
            gz = _axis_apply_shared(t1, 0, D)
            gy = _axis_apply_shared(_axis_apply_shared(t0, 1, D), 0, N)
            gx = _axis_apply_shared(_axis_apply_shared(
                _axis_apply_shared(u, 2, D), 1, N), 0, N)
            c00, c01, c02, c11, c12, c22 = coeff6
            tx = c00 * gx + c01 * gy + c02 * gz
            ty = c01 * gx + c11 * gy + c12 * gz
            tz = c02 * gx + c12 * gy + c22 * gz
            Nt, Dt = N.T, D.T
            v = (_axis_apply_shared(_axis_apply_shared(_axis_apply_shared(
                    tx, 2, Dt), 1, Nt), 0, Nt)
                 + _axis_apply_shared(_axis_apply_shared(_axis_apply_shared(
                    ty, 2, Nt), 1, Dt), 0, Nt)
                 + _axis_apply_shared(_axis_apply_shared(_axis_apply_shared(
                    tz, 2, Nt), 1, Nt), 0, Dt))
        else:
            raise NotImplementedError(dim)
        return v.reshape(n**dim, C)

    def apply_local_lanes_dd(self, Wh, Wl, coeff6dd):
        """apply_local_lanes on a double-single pair — the f64 outer matvec.

        Shared 1D shape matrices apply as baked split-scalar dd FMAs
        (tensorops._axis_apply_shared_dd); the six coefficient components
        come pre-split (ddmath.split_table_np).  ~47-bit accuracy from f32
        arithmetic (kernel="lanes-dd")."""
        from .ddmath import dd_add, split12
        from .tensorops import _axis_apply_shared_dd, _dd_mul_split_tab

        dim, n = self.dim, self.degree + 1
        C = Wh.shape[-1]
        N, D = self._N_np, self._D_np
        ap = _axis_apply_shared_dd
        u2 = (Wh.reshape((n,) * dim + (C,)), Wl.reshape((n,) * dim + (C,)))

        def contract(comps, grads, splits):
            acc = None
            for c6, g, gs in zip(comps, grads, splits):
                t = _dd_mul_split_tab(c6, g[0], g[1], *gs)
                acc = t if acc is None else dd_add(*acc, *t)
            return acc

        if dim == 2:
            a = ap(*u2, 1, D)
            gx = ap(a[0], a[1], 0, N)
            b_ = ap(*u2, 1, N)
            gy = ap(b_[0], b_[1], 0, D)
            c00, c01, c11 = coeff6dd
            gxs, gys = split12(gx[0]), split12(gy[0])
            tx = contract((c00, c01), (gx, gy), (gxs, gys))
            ty = contract((c01, c11), (gx, gy), (gxs, gys))
            v = dd_add(
                *ap(*ap(*tx, 1, D.T), 0, N.T),
                *ap(*ap(*ty, 1, N.T), 0, D.T))
        else:
            t0 = ap(*u2, 2, N)
            t1 = ap(*t0, 1, N)
            gz = ap(*t1, 0, D)
            gy = ap(*ap(*t0, 1, D), 0, N)
            gx = ap(*ap(*ap(*u2, 2, D), 1, N), 0, N)
            c00, c01, c02, c11, c12, c22 = coeff6dd
            gxs, gys, gzs = split12(gx[0]), split12(gy[0]), split12(gz[0])
            grads, splits = (gx, gy, gz), (gxs, gys, gzs)
            tx = contract((c00, c01, c02), grads, splits)
            ty = contract((c01, c11, c12), grads, splits)
            tz = contract((c02, c12, c22), grads, splits)
            Nt, Dt = N.T, D.T
            v = dd_add(
                *ap(*ap(*ap(*tx, 2, Dt), 1, Nt), 0, Nt),
                *ap(*ap(*ap(*ty, 2, Nt), 1, Dt), 0, Nt))
            v = dd_add(*v, *ap(*ap(*ap(*tz, 2, Nt), 1, Nt), 0, Dt))
        return v[0].reshape(n**dim, C), v[1].reshape(n**dim, C)

    def _vmult_impl(self, u, *cf):
        if self.matmul_precision is not None:
            with jax.default_matmul_precision(self.matmul_precision):
                return self._vmult_inner(u, *cf)
        return self._vmult_inner(u, *cf)

    def _vmult_inner(self, u, *cf):
        u0 = jnp.where(self.constrained, 0.0, u).astype(self.dtype)
        if self.kernel == "lanes" and self.coeff6_dd is not None:
            from .ddmath import dd_from_f64

            c6 = cf if cf else self.coeff6_dd
            n_sym = len(_SYM_PAIRS[self.dim])
            c6dd = [tuple(c6[4 * k: 4 * k + 4]) for k in range(n_sym)]
            uh, ul = dd_from_f64(u0)
            Wh = uh[self.cell_dofs_T]
            Wl = ul[self.cell_dofs_T]
            vh, vl = self.apply_local_lanes_dd(Wh, Wl, c6dd)
            # ONE f64 colliding scatter-add of the merged pairs
            v = vh.astype(jnp.float64) + vl.astype(jnp.float64)
            dst = jnp.zeros_like(u0).at[self.cell_dofs_T.reshape(-1)].add(
                v.reshape(-1))
        elif self.kernel == "lanes":
            coeff6 = cf if cf else self.coeff6
            W = u0[self.cell_dofs_T]  # (L, C), cells on lanes
            v = self.apply_local_lanes(W, coeff6)
            dst = jnp.zeros_like(u0).at[self.cell_dofs_T.reshape(-1)].add(
                v.reshape(-1))
        else:
            coeff = cf[0] if cf else self.coeff
            uc = u0[self.cell_dofs]
            v = self.apply_cells(uc, coeff)
            dst = jnp.zeros_like(u0).at[self.cell_dofs.reshape(-1)].add(
                v.reshape(-1))
        return jnp.where(self.constrained, u, dst)

    def vmult(self, u):
        return self._vmult(u, *self._coeff_args)

    def vmult_traceable(self, u):
        return self._vmult_impl(u)

    def residual(self, b, x):
        return self._residual(b, x, *self._coeff_args)

    def __call__(self, u):
        return self.vmult(u)

    def compute_inverse_diagonal(self):
        """Matrix-free diagonal (constrained rows = 1), inverted
        (operator.h:1512 analog)."""
        if self.kernel == "lanes":
            # local[l, c] = Σ_pairs mult · (B_d ⊙ B_e)ᵀ @ coeff6_pair —
            # six small (L, Q) x (Q, C) matmuls, no (C, Q, L) tensor
            Q = self.n_q_1d ** self.dim
            local = None
            for (d, e), c6 in zip(_SYM_PAIRS[self.dim], self.coeff6):
                mult = 1.0 if d == e else 2.0
                BB = jnp.asarray(
                    (self._B_np[:, :, d] * self._B_np[:, :, e]).T * mult,
                    self.dtype)  # (L, Q)
                t = BB @ c6.reshape(Q, -1)  # (L, C)
                local = t if local is None else local + t
            diag = jnp.zeros(self.n_dofs, self.dtype).at[
                self.cell_dofs_T.reshape(-1)].add(local.reshape(-1))
        else:
            local = jnp.einsum("cqde,qld,qle->cl", self.coeff, self.B, self.B)
            diag = jnp.zeros(self.n_dofs, self.dtype).at[
                self.cell_dofs.reshape(-1)].add(local.reshape(-1))
        diag = jnp.where(self.constrained, 1.0, diag)
        return 1.0 / diag

    def assemble_rhs(self, f, dirichlet=None):
        """b_i = ∫ f φ_i with inhomogeneous Dirichlet lift
        (operator.h:297-395 analog)."""
        from ..mesh.grid import _tensor_lattice

        s = self._shape
        unit = _tensor_lattice(s.q, self.dim)
        qp = self.mesh._physical_points(unit, self.mapping_degree)  # (C, Q, dim)
        fq = np.asarray(f(qp.reshape(-1, self.dim))).reshape(self._jxw_np.shape)
        Nval = _tensor_values(s.N, self.dim)  # (Q, L)
        local = np.einsum("cq,ql->cl", self._jxw_np * fq, Nval)
        b = np.zeros(self.n_dofs)
        cd = np.asarray(self.dofs.cell_dofs)
        np.add.at(b, cd.reshape(-1), local.reshape(-1))
        mask = np.asarray(self.dofs.boundary_mask)
        if dirichlet is not None:
            g = np.zeros(self.n_dofs)
            g[mask] = np.asarray(dirichlet(self.dofs.points[mask]))
            if np.any(g != 0.0):
                if self.kernel == "lanes":
                    W = jnp.asarray(g[cd].T, self.dtype)  # (L, C)
                    v = np.asarray(self.apply_local_lanes(W)).T
                else:
                    v = np.asarray(
                        self.apply_cells(jnp.asarray(g[cd], self.dtype)))
                lift = np.zeros(self.n_dofs)
                np.add.at(lift, cd.reshape(-1), v.reshape(-1))
                b = b - lift
            b[mask] = g[mask]
        else:
            b[mask] = 0.0
        return jnp.asarray(b, self.dtype)
