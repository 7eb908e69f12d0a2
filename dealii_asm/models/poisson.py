"""JSON-config-driven Poisson solver — the main driver.

Rebuilds /root/reference/element_centered_preconditioners_01.cc: config schema,
mesh families (hypercube, symmetric hypercube, anisotropy, kershaw(-mp),
hyperball), rhs functions, operator, preconditioner construction (including
the Multigrid branch with h/p/hp/ph level layouts and intermediate-level
split, :508-749), Krylov solve with ReductionControl, and the org-mode
convergence table.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..fem.dofs import DofHandler
from ..fem.functions import make_rhs_and_dbc
from ..mesh.grid import StructuredMesh
from ..mesh.transforms import kershaw_transform
from ..ops.laplace import LaplaceOperator
from ..ops.transfer import TwoLevelTransfer, p_sequence
from ..precond.factory import create_system_preconditioner
from ..precond.multigrid import Multigrid
from ..solvers.krylov import solve as krylov_solve
from ..utils.config import get_child, get_param
from ..utils.table import ConvergenceTable

# Precision of the f32 MG levels' matmuls (level operators and transfers).
# Reduced-precision operands (TF32 on the GPU) carry smooth-mode noise
# amplified ~1/h², which degrades deep hierarchies; the choice was measured
# on the H100 (PERF.md, "Precision on the card").
LEVEL_MATMUL_PRECISION = "highest"


@dataclass(frozen=True)
class MeshFamily:
    """A refinement family of structured meshes (replaces the reference's
    triangulation + create_geometric_coarsening_sequence)."""

    dim: int
    base_cells: tuple[int, ...]          # cells per dim at refinement 0
    n_refinements: int                   # global refinements applied to base
    lengths: tuple[float, ...]
    origin: tuple[float, ...]
    transform: object
    mapping_degree: int
    name: str

    def mesh_at(self, refinement: int) -> StructuredMesh:
        cells = tuple(c * (1 << refinement) for c in self.base_cells)
        return StructuredMesh(self.dim, cells, lengths=self.lengths,
                              origin=self.origin, transform=self.transform)

    @property
    def fine_mesh(self) -> StructuredMesh:
        return self.mesh_at(self.n_refinements)

    @property
    def n_levels(self) -> int:
        """deal.II n_global_levels of the fine triangulation."""
        return self.n_refinements + 1


class GeneralMeshFamily:
    """A refinement family of unstructured meshes (the hyperball,
    /root/reference/element_centered_preconditioners_01.cc:398-408)."""

    def __init__(self, dim: int, coarse_mesh, n_refinements: int, name: str,
                 mapping_degree: int = 2):
        self.dim = dim
        self.n_refinements = n_refinements
        self.name = name
        self.mapping_degree = mapping_degree
        self.transform = None
        self._meshes = [coarse_mesh]

    def mesh_at(self, refinement: int):
        while len(self._meshes) <= refinement:
            self._meshes.append(self._meshes[-1].refine())
        return self._meshes[refinement]

    @property
    def fine_mesh(self):
        return self.mesh_at(self.n_refinements)

    @property
    def n_levels(self) -> int:
        return self.n_refinements + 1


def _make_dofs(family, mesh, degree: int):
    if isinstance(family, GeneralMeshFamily):
        from ..fem.general_dofs import GeneralDofHandler

        return GeneralDofHandler(mesh, degree)
    return DofHandler(mesh, degree)


def _make_operator(family, dofs, dtype, mapping_type: str = "",
                   matmul_precision=None):
    if isinstance(family, GeneralMeshFamily):
        from ..ops.laplace_general import GeneralLaplaceOperator

        return GeneralLaplaceOperator(dofs, dtype=dtype,
                                      matmul_precision=matmul_precision)
    return LaplaceOperator(dofs, mapping_degree=family.mapping_degree
                           if family.transform is not None else None,
                           dtype=dtype, mapping_type=mapping_type,
                           matmul_precision=matmul_precision)


def _make_transfer(family, coarse_dofs, fine_dofs, dtype, matmul_precision=None):
    if isinstance(family, GeneralMeshFamily):
        from ..ops.transfer_general import GeneralTwoLevelTransfer

        return GeneralTwoLevelTransfer(coarse_dofs, fine_dofs, dtype=dtype,
                                       matmul_precision=matmul_precision)
    return TwoLevelTransfer(coarse_dofs, fine_dofs, dtype=dtype,
                            matmul_precision=matmul_precision)


def make_mesh_family(params: dict, log=lambda *_: None) -> MeshFamily:
    """Mesh families of the driver
    (/root/reference/element_centered_preconditioners_01.cc:302-415)."""
    dim = int(get_param(params, "dim", 2))
    n_refine = int(get_param(params, "n refinements", 6))
    mesh_p = get_child(params, "mesh")
    name = get_param(mesh_p, "name", "hypercube")
    mapping_degree = int(get_param(params, "mapping degree", 10))

    if name == "hypercube":
        ns = int(get_param(mesh_p, "n subdivisions", 1))
        log("- Create mesh: hypercube\n")
        return MeshFamily(dim, (ns,) * dim, n_refine, (1.0,) * dim,
                          (0.0,) * dim, None, min(mapping_degree, 1), name)
    if name == "symmetric hypercube":
        ns = int(get_param(mesh_p, "n subdivisions", 1))
        log("- Create mesh: symmetric hypercube\n")
        return MeshFamily(dim, (ns,) * dim, n_refine, (2.0,) * dim,
                          (-1.0,) * dim, None, min(mapping_degree, 1), name)
    if name == "anisotropy":
        stretch = float(get_param(mesh_p, "stratch", 1.0))
        log(f"- Create mesh: anisotropy\n  - stratch: {stretch:g}\n")
        lengths = tuple([1.0] * (dim - 1) + [stretch])
        # the stretch is an axis scaling: stays Cartesian-affine (fast geometry)
        return MeshFamily(dim, (1,) * dim, n_refine, lengths,
                          (0.0,) * dim, None, 1, name)
    if name in ("kershaw", "kershaw-mp"):
        epsy = float(get_param(mesh_p, "epsy", 0.0))
        epsz = float(get_param(mesh_p, "epsz", 0.0))
        if epsy == 0.0 or epsz == 0.0:
            eps = float(get_param(mesh_p, "eps", 1.0))
            epsy = epsz = eps
        ni = int(get_param(mesh_p, "n initial refinements", 1))
        ns = int(get_param(mesh_p, "n subdivisions", 3))
        log(f"- Create mesh: kershaw\n  - epsx: 1\n  - epsy: {epsy:g}\n  - epsz: {epsz:g}\n")
        base = ns * (1 << ni)
        tf = kershaw_transform(epsy, epsz, shift_mp=(name == "kershaw-mp"))
        return MeshFamily(dim, (base,) * dim, n_refine, (1.0,) * dim,
                          (0.0,) * dim, tf, min(mapping_degree, 3), name)
    if name == "hyperball":
        from ..mesh.unstructured import hyper_ball_balanced

        log("- Create mesh: hyperball\n")
        return GeneralMeshFamily(dim, hyper_ball_balanced(dim), n_refine,
                                 name, mapping_degree=min(mapping_degree, 2))
    raise ValueError(f"Geometry with the name <{name}> is not known!")


def mg_level_layout(precon_p: dict, family, fe_degree: int,
                    log=lambda *_: None):
    """The reference's MG level layout: (refinement, degree) per level plus
    the intermediate-split index
    (/root/reference/element_centered_preconditioners_01.cc:508-749)."""
    mg_type = get_param(precon_p, "mg type", "h")
    mg_p_seq = get_param(precon_p, "mg p sequence", "bisect")
    log(f" - type:       {mg_type}")
    log(f" - p sequence: {mg_p_seq}\n")

    degrees = p_sequence(fe_degree, mg_p_seq)  # ascending
    n_trias = family.n_refinements + 1

    levels: list[tuple[int, int]] = []  # (refinement, degree)
    if mg_type == "h":
        levels = [(r, degrees[-1]) for r in range(n_trias)]
    elif mg_type == "p":
        levels = [(family.n_refinements, d) for d in degrees]
    elif mg_type == "hp":
        levels = [(0, d) for d in degrees]
        levels += [(r, degrees[-1]) for r in range(n_trias)]
    elif mg_type == "ph":
        levels = [(r, degrees[0]) for r in range(n_trias)]
        levels += [(family.n_refinements, d) for d in degrees]
    else:
        raise ValueError(f"Multigrid variant <{mg_type}> is not known!")
    # drop consecutive duplicates at hp/ph junctions (the reference keeps an
    # identity-transfer duplicate level; a no-op level changes nothing)
    dedup = [levels[0]]
    for lv in levels[1:]:
        if lv != dedup[-1]:
            dedup.append(lv)
    levels = dedup

    # intermediate level: last level with degree 1 seen from the top
    intermediate = 0
    for i in range(len(levels) - 1, -1, -1):
        if levels[i][1] == 1:
            intermediate = i
            break
    return levels, intermediate


def _build_sharded_general(precon_p: dict, family, fe_degree: int,
                           op64, log, level_dtype, dtype, n_devices: int):
    """Sharded-unstructured Multigrid: finest level SPMD over a 1D device
    mesh (parallel/general_sharded.py), every coarser level replicated —
    the P1/P3-for-any-mesh-family path (reference: p4est SFC partitioning
    + shrinking coarse sub-communicators)."""
    from jax.sharding import Mesh as _Mesh

    from ..parallel.general_sharded import (GeneralPartition,
                                            ShardedGeneralASM,
                                            ShardedGeneralOperator,
                                            ShardedGeneralTransfer)
    from ..precond.asm_general import GeneralASMPreconditioner
    from ..solvers.chebyshev import ChebyshevPreconditioner, eig_initial_guess

    jmesh = _Mesh(np.array(jax.devices()[:n_devices]), ("dev",))
    levels, intermediate = mg_level_layout(precon_p, family, fe_degree, log)
    prec = LEVEL_MATMUL_PRECISION if level_dtype != jnp.float64 else None
    ops, dofs_list = [], []
    for r, d in levels:
        mesh = family.mesh_at(r)
        dofs = _make_dofs(family, mesh, d)
        ops.append(_make_operator(family, dofs, level_dtype,
                                  matmul_precision=prec))
        dofs_list.append(dofs)
        log(f"- Create operator:\n  - n cells:          "
            f"{mesh.n_cells_total}\n  - n dofs:           {dofs.n_dofs}\n")
    transfers = [_make_transfer(family, dofs_list[i], dofs_list[i + 1],
                                level_dtype, matmul_precision=prec)
                 for i in range(len(levels) - 1)]

    smoother_p = get_child(precon_p, "mg smoother")
    coarse_p = get_child(precon_p, "mg coarse grid solver")
    one_sided = get_param(precon_p, "one-sided v-cycle", False)

    fine_dofs = dofs_list[-1]
    part = GeneralPartition(fine_dofs, n_devices)
    log(f" - n devices:  {n_devices} (sharded unstructured fine level; "
        f"B={part.B}, ghosts<={part.Gmax})")

    sop64 = ShardedGeneralOperator(op64, part, jmesh)
    sop32 = ShardedGeneralOperator(ops[-1], part, jmesh)

    inner_p = get_child(smoother_p, "preconditioner")
    if (inner_p.get("type") != "FDM"
            or int(get_param(inner_p, "n overlap", 1)) != 1
            or not get_param(inner_p, "element centric", True)):
        raise ValueError("sharded unstructured fine smoother supports "
                         "element-centric FDM overlap 1")
    asm = GeneralASMPreconditioner(
        fine_dofs, n_overlap=1,
        weighting_type=get_param(inner_p, "weighting type", "symm"),
        dtype=level_dtype,
        matmul_precision=get_param(inner_p, "matmul precision", None))
    sasm = ShardedGeneralASM(asm, part, jmesh)

    class _STransfer:
        def __init__(self, st):
            self._st = st

        def restrict(self, r):
            return self._st.restrict_blocked(r)

        def prolongate(self, uc):
            return self._st.prolongate_blocked(uc)

    stransfer = _STransfer(ShardedGeneralTransfer(transfers[-1], part, jmesh))

    b0 = part.pad(eig_initial_guess(
        fine_dofs.n_dofs, np.asarray(fine_dofs.boundary_mask)))
    log("- Setting up smoother on the sharded fine level\n")
    cheb = ChebyshevPreconditioner(
        sop32.vmult_blocked, sasm.vmult_blocked, part.NB,
        degree=int(get_param(smoother_p, "degree", 1)),
        polynomial_type=get_param(smoother_p, "polynomial type", "1st kind"),
        eig_b0=b0)

    # replicated sub-hierarchy (levels[:-1]) incl. optional intermediate
    # split — same construction as _build_multigrid on the truncated list
    def make_smoother(level: int, p: dict):
        log(f"- Setting up smoother on level {level}\n")
        return create_system_preconditioner(ops[level], p, log)

    interm_p = get_child(precon_p, "mg intermediate smoother")
    if not interm_p.get("type"):
        interm_p = smoother_p
    log("- Setting up coarse-grid solver on level 0\n")
    coarse = create_system_preconditioner(ops[0], coarse_p, log)
    if intermediate > 0:
        inner_smoothers = [make_smoother(l, interm_p)
                           for l in range(1, intermediate + 1)]
        inner = Multigrid([o.vmult for o in ops[: intermediate + 1]],
                          inner_smoothers, transfers[:intermediate],
                          coarse.vmult, one_sided=one_sided)
        mid_smoothers = [make_smoother(l, smoother_p)
                         for l in range(intermediate + 1, len(levels) - 1)]
        mg = Multigrid(
            [o.vmult for o in ops[intermediate:-1]]
            + [sop32.vmult_blocked],
            mid_smoothers + [cheb],
            transfers[intermediate:-1] + [stransfer],
            inner.vmult, one_sided=one_sided)
    else:
        smoothers = [make_smoother(l, smoother_p)
                     for l in range(1, len(levels) - 1)] + [cheb]
        mg = Multigrid([o.vmult for o in ops[:-1]] + [sop32.vmult_blocked],
                       smoothers, transfers[:-1] + [stransfer],
                       coarse.vmult, one_sided=one_sided)

    class _Ctx:
        pass

    ctx = _Ctx()
    ctx.mg = mg
    ctx.pad = part.pad
    ctx.unpad = part.unpad
    ctx.vmult = lambda u: sop64.vmult_blocked(u)
    ctx.part = part
    return ctx


def _build_multigrid(params: dict, family: MeshFamily, fe_degree: int,
                     fine_op: LaplaceOperator, log, dtype) -> Multigrid:
    precon_p = params
    levels, intermediate = mg_level_layout(precon_p, family, fe_degree, log)

    # build level operators
    prec = LEVEL_MATMUL_PRECISION if dtype != jnp.float64 else None
    ops = []
    dofs_list = []
    for r, d in levels:
        mesh = family.mesh_at(r)
        dofs = _make_dofs(family, mesh, d)
        op = _make_operator(family, dofs, dtype, matmul_precision=prec)
        log(f"- Create operator:\n  - n cells:          {mesh.n_cells_total}\n"
            f"  - n dofs:           {dofs.n_dofs}\n")
        dofs_list.append(dofs)
        ops.append(op)

    transfers = [_make_transfer(family, dofs_list[i], dofs_list[i + 1], dtype,
                                matmul_precision=prec)
                 for i in range(len(levels) - 1)]

    smoother_p = get_child(params, "mg smoother")
    interm_p = get_child(params, "mg intermediate smoother")
    if not interm_p.get("type"):
        interm_p = smoother_p
    coarse_p = get_child(params, "mg coarse grid solver")
    one_sided = get_param(params, "one-sided v-cycle", False)
    n_coarse_cycles = int(get_param(params, "n coarse cycles", 1))

    def make_smoother(level: int, p: dict):
        log(f"- Setting up smoother on level {level}\n")
        return create_system_preconditioner(ops[level], p, log)

    log("- Setting up coarse-grid solver on level 0\n")
    coarse = create_system_preconditioner(ops[0], coarse_p, log)

    if intermediate > 0:
        inner_smoothers = [make_smoother(l, interm_p)
                           for l in range(1, intermediate + 1)]
        inner = Multigrid([o.vmult for o in ops[: intermediate + 1]],
                          inner_smoothers, transfers[:intermediate],
                          coarse.vmult, one_sided=one_sided)
        outer_smoothers = [make_smoother(l, smoother_p)
                           for l in range(intermediate + 1, len(levels))]
        coarse_fn = inner.vmult
        return Multigrid([o.vmult for o in ops[intermediate:]],
                         outer_smoothers, transfers[intermediate:], coarse_fn,
                         one_sided=one_sided, n_coarse_cycles=n_coarse_cycles)

    smoothers = [make_smoother(l, smoother_p) for l in range(1, len(levels))]
    return Multigrid([o.vmult for o in ops], smoothers, transfers, coarse.vmult,
                     one_sided=one_sided, n_coarse_cycles=n_coarse_cycles)


def run_config(params: dict, table: ConvergenceTable | None = None,
               log=print, dtype=jnp.float64):
    """Run one config; returns a result dict (the reference's table row).

    Besides the row it holds ``setup_time`` (mesh, operators, preconditioner
    and eigenvalue estimates, host clock) and ``first_solve_time`` (the first
    solve, compilation included)."""
    t_start = time.perf_counter()
    table = table or ConvergenceTable()
    fe_degree = int(get_param(params, "degree", 1))
    family = make_mesh_family(params, log)
    mesh = family.fine_mesh
    dofs = _make_dofs(family, mesh, fe_degree)
    mapping_type = get_param(params, "operator mapping type", "")
    op = _make_operator(family, dofs, dtype, mapping_type)

    rhs_name = get_param(params, "rhs", "constant")
    rhs_fn, dbc_fn = make_rhs_and_dbc(rhs_name, family.dim)
    b = op.assemble_rhs(rhs_fn, dirichlet=dbc_fn)

    table.add_value("name", get_param(params, "name", family.name))
    table.add_value("n_cells", mesh.n_cells_total)
    table.add_value("L", family.n_levels)
    table.add_value("n_dofs", dofs.n_dofs)

    precon_p = get_child(params, "preconditioner")
    ptype = precon_p.get("type", "")
    mg_inner = None  # un-adapted float-level MG (mixed-precision fast path)
    level_dtype = dtype
    # multi-device: "n devices" = int or "auto" (all visible devices) — the
    # reference driver is MPI-parallel end to end (mpirun -np 40,
    # experiments/README.MD); >1 routes the whole solve through the
    # explicit-halo sharded path (parallel/driver.py)
    n_dev_param = get_param(params, "n devices", 1)
    if n_dev_param == "auto":
        n_devices = len(jax.devices())
    else:
        n_devices = int(n_dev_param)
    sharded = None
    if n_devices > 1:
        if ptype != "Multigrid":
            raise ValueError("'n devices' > 1 supports Multigrid "
                             "preconditioners")
    if ptype == "Multigrid":
        log("- Create system preconditioner: Multigrid")
        # mixed precision: the reference hard-codes float MG levels under a
        # double outer Krylov (element_centered_preconditioners_01.cc:788-792,
        # LevelOperatorType = LaplaceOperatorMatrixFree<dim, float>); the
        # level dtype is configurable via "mg number type" with the same
        # default (float32 whenever the outer runs in float64)
        import jax.numpy as _jnp

        default_lt = "float32" if dtype == _jnp.float64 else ""
        level_dtype = {"": dtype, "float64": _jnp.float64,
                       "float32": _jnp.float32, "bfloat16": _jnp.bfloat16}[
            get_param(params, "mg number type", default_lt)]
        if n_devices > 1 and isinstance(family, GeneralMeshFamily):
            sharded = _build_sharded_general(
                precon_p, family, fe_degree, op, log, level_dtype, dtype,
                n_devices)
            precon = sharded.mg
            if level_dtype != dtype:
                from ..precond.adapter import PrecisionAdapter

                mg_inner = precon
                precon = PrecisionAdapter(mg_inner, level_dtype)
                precon.timer = mg_inner.timer
        elif n_devices > 1:
            from ..parallel.driver import build_sharded_multigrid

            log(f" - n devices:  {n_devices} (explicit-halo sharding)")
            sharded = build_sharded_multigrid(
                precon_p, family, fe_degree, log, level_dtype, dtype,
                n_devices)
            precon = sharded.mg
            if level_dtype != dtype:
                from ..precond.adapter import PrecisionAdapter

                mg_inner = precon
                precon = PrecisionAdapter(mg_inner, level_dtype)
                precon.timer = mg_inner.timer
        else:
            precon = _build_multigrid(precon_p, family, fe_degree, op, log,
                                      level_dtype)
            if level_dtype != dtype:
                from ..precond.adapter import PrecisionAdapter

                mg_inner = precon
                precon = PrecisionAdapter(mg_inner, level_dtype)
                precon.timer = mg_inner.timer
    else:
        precon = create_system_preconditioner(op, precon_p, log)

    solver_p = get_child(params, "solver")
    solver_type = get_param(solver_p, "type", "")
    max_it = int(get_param(solver_p, "max iterations", 1000))
    abs_tol = float(get_param(solver_p, "abs tolerance", 1e-10))
    rel_tol = float(get_param(solver_p, "rel tolerance", 1e-2))
    log(f" - Solving with {solver_type}")
    log(f"   - max iterations: {max_it}")
    log(f"   - abs tolerance:  {abs_tol:g}")
    log(f"   - rel tolrance:   {rel_tol:g}")

    kwargs = {}
    if solver_type == "GMRES":
        kwargs["right_preconditioning"] = get_param(
            solver_p, "use right preconditioning", True)
        ortho = get_param(solver_p, "orthogonalization strategy",
                          "classical gram schmidt")
        kwargs["orthogonalization"] = (
            "classical" if ortho.startswith("classical") else "modified")
        mtv = int(get_param(solver_p, "max n tmp vectors", 0))
        if mtv > 0:
            kwargs["restart"] = mtv - 2

    # P8 policy: the reference architecture is a DOUBLE outer Krylov over
    # FLOAT MG levels (element_centered_preconditioners_01.cc:780-792) —
    # the krylov_solve dispatch below with the f32-level Multigrid behind a
    # PrecisionAdapter IS that architecture.
    # Iterative refinement (solvers/refinement.py) moves even the outer work
    # to f32, but only contracts while κ(A)·relerr(A32) < 1; the f32
    # operator's smooth-mode cancellation floor (eps32/h²) breaks that at
    # large κ — measured: 17M-DoF Q4 stalls at ~4e-4 true residual.  "auto"
    # therefore uses refinement only below a conditioning threshold;
    # "mixed precision solve": true forces it.
    mp_solve = get_param(params, "mixed precision solve", "auto")
    # crude conditioning proxy: nodes per direction ~ n^(1/dim); refinement is
    # safe while eps32/h² · κ_margin stays below the target reduction
    n_1d = dofs.n_dofs ** (1.0 / family.dim)
    refinement_safe = n_1d <= 80.0
    use_refinement = (
        mg_inner is not None and sharded is None
        and solver_type in ("CG", "GMRES")
        and (mp_solve is True
             or (mp_solve == "auto" and dtype == jnp.float64
                 and dofs.n_dofs > 2_000_000 and refinement_safe)))
    if use_refinement:
        from ..solvers.krylov import cg as _cg, gmres as _gmres
        from ..solvers.refinement import refined_solve

        op32 = _make_operator(family, dofs, level_dtype)
        inner_solver = _cg if solver_type == "CG" else _gmres
        inner_red = float(get_param(solver_p, "inner reduction", 3e-4))
        log("   - mixed-precision refinement (f32 inner, f64 residuals)")

        def dispatch():
            return refined_solve(
                op.vmult, op32.vmult, b, mg_inner.vmult,
                rel_tolerance=rel_tol, abs_tolerance=abs_tol,
                inner_reduction=inner_red, inner_solver=inner_solver, log=log)
    elif sharded is not None:
        b_pad = sharded.pad(b)
        sh_vmult = sharded.vmult

        def dispatch():
            r = krylov_solve(solver_type, sh_vmult, b_pad, M=precon.vmult,
                             max_iterations=max_it, abs_tolerance=abs_tol,
                             rel_tolerance=rel_tol, **kwargs)
            r.x = sharded.unpad(r.x)
            return r
    else:
        def dispatch():
            return krylov_solve(solver_type, op.vmult, b, M=precon.vmult,
                                max_iterations=max_it, abs_tolerance=abs_tol,
                                rel_tolerance=rel_tol, **kwargs)

    t_setup = time.perf_counter()
    result = dispatch()  # warm up (compiles)
    jax.block_until_ready(result.x)
    t_first = time.perf_counter()
    best_of = int(get_param(solver_p, "best of", 1))
    print_timing = get_param(params, "print timing", False)
    solve_time = 999.0
    if result.converged and (best_of > 1 or print_timing):
        for _ in range(best_of):
            t0 = time.perf_counter()
            r2 = dispatch()
            jax.block_until_ready(r2.x)
            solve_time = min(solve_time, time.perf_counter() - t0)
    if result.converged:
        log(f"   - n iterations:   {result.n_iterations}")
        if print_timing:
            log(f"   - time:           {solve_time} #")
        log("")
        table.add_value("it", result.n_iterations)
    else:
        log("   - DID NOT CONVERGE!\n")
        table.add_value("it", 999)
    if print_timing:
        table.add_value("time", solve_time)
        if hasattr(precon, "timer"):
            precon.timer.print_timings()
    table.add_value("aspect_ratio", mesh.max_aspect_ratio())
    if get_param(params, "do output", False):
        from ..utils.vtu import write_vtu

        write_vtu(get_param(params, "output file", "multigrid.vtu"), dofs,
                  {"solution": np.asarray(result.x)})
    table.end_row()
    return {
        "n_cells": mesh.n_cells_total,
        "L": family.n_levels,
        "n_dofs": dofs.n_dofs,
        "it": result.n_iterations if result.converged else 999,
        "converged": result.converged,
        "time": solve_time,
        "setup_time": t_setup - t_start,
        "first_solve_time": t_first - t_setup,
        "solution": result.x,
        "table": table,
    }
