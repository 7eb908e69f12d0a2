"""JSON-driven preconditioner factory.

Rebuilds ``create_system_preconditioner``
(/root/reference/include/precondition.templates.h:251-818): dispatch on
params["type"] with the reference's defaults:

- Relaxation: degree 3, ω auto from eigenvalue estimate (templates.h:267-438);
- Chebyshev: degree 3, smoothing range 20, 40 eig-CG iterations, 1st/4th kind,
  ev algorithm lanczos iff operator∧preconditioner symmetric else power
  iteration (templates.h:89-158, 439-584);
- FDM: n overlap min(param, degree), weighting default symm, element centric
  (templates.h:162-247);
- AMG: direct coarse inverse stands in for Trilinos AMG (templates.h:592-613)
  — exact at the sizes the reference runs AMG on (documented deviation);
- AdditiveSchwarzPreconditioner / SubMeshPreconditioner / CGPreconditioner:
  matrix-based Schwarz via block extraction (templates.h:614-813).

The ``optimize`` levels (0-3) of the reference choose which of
operator/preconditioner use fused pre/post vector ranges; under XLA the whole
smoother step is one fused jitted program, so they are accepted and ignored.
"""

from __future__ import annotations

from ..solvers.chebyshev import ChebyshevPreconditioner, RelaxationPreconditioner
from ..utils.config import get_child, get_param
from .asm import ASMPreconditioner
from .diagonal import DiagonalPreconditioner


class IdentityPreconditioner:
    def vmult(self, x):
        return x

    def __call__(self, x):
        return self.vmult(x)

    is_symmetric = True


def _noop_log(msg=""):
    pass


def create_system_preconditioner(op, params: dict, log=_noop_log):
    """Return a preconditioner object with .vmult (and .is_symmetric)."""
    ptype = params.get("type", "")
    if ptype == "Identity":
        log("- Create system preconditioner: Identity\n")
        return IdentityPreconditioner()

    if ptype == "Diagonal":
        log("- Create system preconditioner: Diagonal\n")
        p = DiagonalPreconditioner(op)
        p.is_symmetric = True
        return p

    if ptype == "FDM":
        return _create_fdm(op, params, log)

    if ptype == "AMG":
        log("- Create system preconditioner: AMG\n")
        from .multigrid import DirectCoarseSolver

        p = DirectCoarseSolver(op.dofs, dtype=op.dtype)
        p.is_symmetric = True
        return p

    if ptype == "CoarseCG":
        # matrix-free coarse solver for large coarse levels (P7/scaling path):
        # CG on the level operator, diagonal-preconditioned, to a fixed
        # reduction — replaces the dense inverse where it would not scale
        # (the reference runs AMG there, precondition.templates.h:592-613)
        from .multigrid import IterativeCoarseSolver

        p = IterativeCoarseSolver(
            op, reduction=float(get_param(params, "reduction", 1e-4)),
            max_iterations=int(get_param(params, "max iterations", 200)))
        p.is_symmetric = True
        log("- Create system preconditioner: CoarseCG\n")
        return p

    if ptype in ("AdditiveSchwarzPreconditioner", "SubMeshPreconditioner",
                 "CGPreconditioner"):
        from .block_asm import create_block_preconditioner

        return create_block_preconditioner(op, params, log)

    if ptype == "Relaxation":
        inner = create_system_preconditioner(op, get_child(params, "preconditioner"), log)
        degree = int(get_param(params, "degree", 3))
        omega = float(get_param(params, "omega", 0.0))
        log(f"- Create system preconditioner: Relaxation\n    - degree: {degree}")
        sym = getattr(op, "is_symmetric", True) and getattr(inner, "is_symmetric", False)
        algo = get_param(params, "ev algorithm",
                         "lanczos" if sym else "power iteration")
        rel = RelaxationPreconditioner(
            op.vmult, inner.vmult, op.n_dofs, n_iterations=degree, omega=omega,
            constrained_mask=op.dofs.boundary_mask, ev_algorithm=algo)
        if rel.eigenvalues is not None:
            log(f"    - min ev: {rel.eigenvalues.min_eigenvalue_estimate:g}")
            log(f"    - max ev: {rel.eigenvalues.max_eigenvalue_estimate:g}")
        log(f"    - omega:  {rel.omega:g}\n")
        rel.is_symmetric = sym
        return rel

    if ptype == "Chebyshev":
        inner = create_system_preconditioner(op, get_child(params, "preconditioner"), log)
        degree = int(get_param(params, "degree", 3))
        sym = getattr(op, "is_symmetric", True) and getattr(inner, "is_symmetric", False)
        algo = get_param(params, "ev algorithm",
                         "lanczos" if sym else "power iteration")
        poly = get_param(params, "polynomial type", "1st kind")
        cheb = ChebyshevPreconditioner(
            op.vmult, inner.vmult, op.n_dofs, degree=degree,
            smoothing_range=float(get_param(params, "smoothing range", 20.0)),
            polynomial_type=poly, constrained_mask=op.dofs.boundary_mask,
            ev_algorithm=algo)
        ev = cheb.eigenvalues
        log("- Create system preconditioner: Chebyshev")
        log(f"    - degree: {degree}")
        log(f"    - min ev: {ev.min_eigenvalue_estimate:g}")
        log(f"    - max ev: {ev.max_eigenvalue_estimate:g}")
        log(f"    - omega:  {2.0 / (ev.min_eigenvalue_estimate + ev.max_eigenvalue_estimate):g}")
        # deviation note (the contract the golden suite enforces): estimates
        # use deal.II's i%11 start vector, but our lexicographic DoF numbering
        # permutes it, so values differ from the reference's by ~2-4%;
        # iteration counts are exact (see tests/test_golden_suite.py).
        # Configs may carry the reference's recorded values ("reference
        # min ev"/"reference max ev") — then the actual deviation is printed.
        ref_min = params.get("reference min ev")
        ref_max = params.get("reference max ev")
        if ref_min is not None and ref_max is not None:
            dev_min = abs(ev.min_eigenvalue_estimate / float(ref_min) - 1)
            dev_max = abs(ev.max_eigenvalue_estimate / float(ref_max) - 1)
            log(f"    - reference min/max ev: {float(ref_min):g} /"
                f" {float(ref_max):g} (deviation {dev_min:.2%} / {dev_max:.2%},"
                " start-vector-ordering dependent)\n")
        else:
            log("    - (ev estimates are start-vector-ordering dependent;"
                " iteration counts are the pinned contract)\n")
        cheb.is_symmetric = sym
        return cheb

    raise ValueError(f"Preconditioner <{ptype}> is not known!")


def _create_fdm(op, params: dict, log):
    degree = op.degree
    n_overlap = min(int(get_param(params, "n overlap", 1)), degree)
    weighting = get_param(params, "weighting type", "symm")
    element_centric = get_param(params, "element centric", True)
    sub_mesh_approximation = int(get_param(params, "sub mesh approximation", op.dim))
    # "weight sequence" (global/compressed/dg) selects the reference's weight
    # STORAGE/application strategy — same weight values, applied globally as a
    # vector op, from Q2-entity-compressed 3^dim tables, or per-cell DG-style
    # (/root/reference/include/matrix_free.h:714-887,
    # precondition.templates.h:207-209).  Here the multiplicity weights fold
    # into the FDM eigen-transforms at setup, so every sequence is the same
    # fused program; the key is accepted and recorded, not ignored silently.
    weight_sequence = get_param(params, "weight sequence",
                                "global" if n_overlap > 1 else "compressed")
    if weight_sequence not in ("global", "compressed", "dg"):
        raise ValueError(f"weight sequence <{weight_sequence}> is not known!")
    # f32 eigen-transform matmuls: "highest" unless the config selects
    # another (precond/asm.FDM_MATMUL_PRECISION)
    precision = get_param(params, "matmul precision", None)
    log("- Create system preconditioner: FDM")
    log(f"    - n overlap:              {n_overlap}")
    log(f"    - sub mesh approximation: {sub_mesh_approximation}")
    log(f"    - weight sequence:        {weight_sequence}"
        " (storage strategy; folded into the FDM transforms here)")
    log("    - reuse partitioner:      true")
    log("    - compress indices:       false\n")
    from ..fem.general_dofs import GeneralDofHandler

    if isinstance(op.dofs, GeneralDofHandler):
        from .asm_general import GeneralASMPreconditioner

        p = GeneralASMPreconditioner(
            op.dofs, n_overlap=n_overlap, weighting_type=weighting,
            patch_type="element" if element_centric else "vertex",
            dtype=op.dtype, matmul_precision=precision)
    else:
        p = ASMPreconditioner(
            op.dofs,
            n_overlap=n_overlap,
            weighting_type=weighting,
            patch_type="element" if element_centric else "vertex",
            dtype=op.dtype,
            matmul_precision=precision,
        )
    p.is_symmetric = weighting in ("none", "symm")
    return p
