"""Geometry coefficient tables for the Laplace cell integral.

The reference's four geometry representations live at
/root/reference/include/operator.h:867-1333 (generic MappingInfo, trilinear
vertex-coefficient, quadratic 3^dim-coefficient, merged symmetric coefficient per
q-point, construct-q).  Here we provide:

- ``cartesian``: axis-aligned affine cells — one (dim,) width vector per cell;
  the merged coefficient is diagonal and separable, the cheapest path.
- ``merged``: precomputed symmetric w_q·|J|·J⁻¹J⁻ᵀ per (cell, q-point) — the
  general path for deformed meshes (operator.h:1162-1219 analog).

Compressed variants (trilinear / quadratic / construct-q) are layered on later;
they change memory traffic, not semantics.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..fem.lagrange import shape_1d
from ..mesh.grid import StructuredMesh, _tensor_weights


@dataclass(frozen=True)
class GeometryData:
    """Host-side geometry tables (float64 NumPy).

    ``jxw`` and ``q_points`` are LAZY (computed on first access): they are
    (C, Q)/(C, Q, dim) arrays needed only for rhs/mass integrals, and
    materializing them eagerly dominated operator setup at scale (¾ GB of
    first-touch page faults at 64³ Q4 — see dealii_asm/__init__.py)."""

    kind: str                      # "cartesian" | "merged"
    dim: int
    n_q_1d: int
    quad_weights: np.ndarray       # (Q,) tensor-product weights, x fastest
    cell_widths: np.ndarray | None # (C, dim) for cartesian
    coeff: np.ndarray | None       # (C, Q, dim, dim) merged sym coefficient (incl. w_q)
    _jxw_fn: object = None         # () -> (C, Q) w_q |det J|
    _q_points_fn: object = None    # () -> (C, Q, dim) physical q-points

    @property
    def jxw(self) -> np.ndarray:
        cache = object.__getattribute__(self, "__dict__")
        if "_jxw" not in cache:
            cache["_jxw"] = self._jxw_fn()
        return cache["_jxw"]

    @property
    def q_points(self) -> np.ndarray:
        cache = object.__getattribute__(self, "__dict__")
        if "_q_points" not in cache:
            cache["_q_points"] = self._q_points_fn()
        return cache["_q_points"]


def _inv_det_batched(J, dim: int, xp=np):
    """(det, inv) of (..., dim, dim) matrices via cofactors (np or jnp).

    Written array-module-generic so the same formulas serve the host fallback
    and the jitted XLA pipeline below (closed-form cofactors: no batched LU in
    the pipeline, identical formulas on host and device)."""
    if dim == 1:
        det = J[..., 0, 0]
        return det, 1.0 / J
    if dim == 2:
        a, b = J[..., 0, 0], J[..., 0, 1]
        c, d = J[..., 1, 0], J[..., 1, 1]
        det = a * d - b * c
        inv = xp.stack([
            xp.stack([d, -b], axis=-1),
            xp.stack([-c, a], axis=-1),
        ], axis=-2) / det[..., None, None]
        return det, inv
    a, b, c = J[..., 0, 0], J[..., 0, 1], J[..., 0, 2]
    d, e, f = J[..., 1, 0], J[..., 1, 1], J[..., 1, 2]
    g, h, i = J[..., 2, 0], J[..., 2, 1], J[..., 2, 2]
    A = e * i - f * h
    B = f * g - d * i
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv = xp.stack([
        xp.stack([A, c * h - b * i, b * f - c * e], axis=-1),
        xp.stack([B, a * i - c * g, c * d - a * f], axis=-1),
        xp.stack([C, b * g - a * h, a * e - b * d], axis=-1),
    ], axis=-2) / det[..., None, None]
    return det, inv


_PIPE_CACHE: dict = {}


def merged_det_coeff(B: np.ndarray, sp: np.ndarray, wq: np.ndarray,
                     dim: int):
    """(detj, coeff) of the merged-geometry representation, computed as ONE
    jitted XLA program on the host CPU backend.

    J[c,q,e,d] = Σ_l B[q,l,d]·sp[c,l,e]; coeff = w_q |J| J⁻¹J⁻ᵀ.  This class
    of VM ships an unvectorized reference BLAS (~58 MFLOP/s measured) and
    numpy's strided cofactor arithmetic is allocation-bound — the identical
    f64 pipeline under XLA CPU measured 170x faster (0.5 s vs 89 s for
    24³ cells Q4 map-3).  Returns host numpy float64 arrays."""
    import jax

    from jax._src.config import enable_x64

    key = dim
    if key not in _PIPE_CACHE:
        import jax.numpy as jnp

        @jax.jit
        def pipe(B, sp, wq):
            J = jnp.einsum("qld,cle->cqed", B, sp)
            det, Jinv = _inv_det_batched(J, dim, xp=jnp)
            coeff = Jinv @ jnp.swapaxes(Jinv, -1, -2)
            coeff = coeff * (wq[None, :] * det)[:, :, None, None]
            return det, coeff

        _PIPE_CACHE[key] = pipe
    cpu = jax.devices("cpu")[0]
    with enable_x64(True), jax.default_device(cpu):
        det, coeff = _PIPE_CACHE[key](np.asarray(B, np.float64),
                                      np.asarray(sp, np.float64),
                                      np.asarray(wq, np.float64))
        return np.asarray(det), np.asarray(coeff)


def compute_geometry(
    mesh: StructuredMesh,
    n_q_1d: int,
    mapping_degree: int = 1,
    force_merged: bool = False,
) -> GeometryData:
    s = shape_1d(max(mapping_degree, 1), n_q_1d)
    wq = _tensor_weights([s.w] * mesh.dim)  # (Q,)

    from ..mesh.grid import _tensor_lattice

    q_lattice = _tensor_lattice(s.q, mesh.dim)  # (Q, dim)
    q_points_fn = lambda: mesh.physical_points(q_lattice)  # (C, Q, dim)

    if mesh.transform is None and not force_merged:
        h = np.broadcast_to(mesh.h, (mesh.n_cells_total, mesh.dim)).copy()
        detj = np.prod(h, axis=1)  # (C,)
        return GeometryData(
            kind="cartesian",
            dim=mesh.dim,
            n_q_1d=n_q_1d,
            quad_weights=wq,
            cell_widths=h,
            coeff=None,
            _jxw_fn=lambda: wq[None, :] * detj[:, None],
            _q_points_fn=q_points_fn,
        )

    B, sp = mesh.jacobian_factors(mapping_degree, s.q)
    detj, coeff = merged_det_coeff(B, sp, wq, mesh.dim)
    if (detj <= 0).any():
        raise ValueError("mesh transform produced non-positive Jacobian determinants")
    jxw = wq[None, :] * detj
    return GeometryData(
        kind="merged",
        dim=mesh.dim,
        n_q_1d=n_q_1d,
        quad_weights=wq,
        cell_widths=None,
        coeff=coeff,
        _jxw_fn=lambda: jxw,
        _q_points_fn=q_points_fn,
    )
