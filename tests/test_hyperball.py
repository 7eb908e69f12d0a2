"""Unstructured-mesh / hyperball subsystem tests.

Covers the reference's orientation machinery semantics
(/root/reference/include/reduced_access.h, overlap_unstructured_01.cc) and the
ball mesh family (element_centered_preconditioners_01.cc:398-408) in the
array form: orientation-baked index tables + gather-path operator/ASM.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from dealii_asm.fem.general_dofs import GeneralDofHandler
from dealii_asm.mesh.unstructured import (
    UnstructuredMesh,
    _VERTEX_COORDS,
    hyper_ball_balanced,
)
from dealii_asm.ops.laplace_general import GeneralLaplaceOperator
from dealii_asm.precond.asm_general import GeneralASMPreconditioner


def box_mesh(dim, n):
    """Structured box as an UnstructuredMesh (oracle comparisons)."""
    grid = [np.linspace(0, 1, n + 1)] * dim
    coords = np.stack(np.meshgrid(*([np.arange(n + 1)] * dim), indexing="ij"),
                      axis=-1).reshape(-1, dim)
    flat = sum(coords[:, d] * (n + 1) ** d for d in range(dim))
    pts = np.stack(np.meshgrid(*grid, indexing="ij"), axis=-1).reshape(-1, dim)
    verts = np.zeros(((n + 1) ** dim, dim))
    verts[flat] = pts
    vc = _VERTEX_COORDS[dim]
    ci = np.stack(np.meshgrid(*([np.arange(n)] * dim), indexing="ij"),
                  axis=-1).reshape(-1, dim)
    cells = [[sum((c[d] + vc[l, d]) * (n + 1) ** d for d in range(dim))
              for l in range(2 ** dim)] for c in ci]
    return UnstructuredMesh(dim, verts, np.asarray(cells))


def rotated_two_cube_mesh():
    """Two unit cubes; the second's local frame is rotated (x<-y<-z<-x) —
    the overlap_unstructured_01.cc scenario: flipped/rotated shared entities."""
    verts = np.array([[i, j, k] for k in range(2) for j in range(2)
                      for i in range(3)], dtype=float)

    def vid(i, j, k):
        return i + j * 3 + k * 6

    vc = _VERTEX_COORDS[3]
    cell1 = [vid(*vc[l][[0, 1, 2]] * [1, 1, 1]) for l in range(8)]
    cell1 = [vid(vc[l][0], vc[l][1], vc[l][2]) for l in range(8)]
    cell2 = [vid(1 + vc[l][2], vc[l][0], vc[l][1]) for l in range(8)]
    return UnstructuredMesh(3, verts, np.asarray([cell1, cell2]))


def _interior_laplace_residual(mesh, p):
    """max |(A u_lin)_i| over interior i for the interpolant of a linear
    function — zero iff the orientation-baked tables give a conforming space."""
    from dealii_asm.fem.lagrange import shape_1d
    from dealii_asm.mesh.grid import _tensor_gradient, _tensor_weights

    dh = GeneralDofHandler(mesh, p)
    s = shape_1d(p, p + 1)
    B = _tensor_gradient(s.N, s.D, mesh.dim)
    wq = _tensor_weights([s.w] * mesh.dim)
    # mapping degree 2 on curved meshes (production/reference setting,
    # element_centered_preconditioners_01.cc:400): keeps the integrand degree
    # within Gauss-(p+1) exactness so A·(linear) vanishes exactly
    mdeg = min(p, 2) if mesh.project is not None else 1
    J = mesh.jacobians(mdeg, s.q)
    detj = np.linalg.det(J)
    assert (detj > 0).all()
    Jinv = np.linalg.inv(J)
    coeff = np.einsum("cqde,cqfe->cqdf", Jinv, Jinv) * (
        wq[None] * detj)[..., None, None]
    # isoparametric points for the mdeg mapping (u_lin must lie in the space)
    sp = mesh.cell_mapping_points(mdeg)
    from dealii_asm.fem.lagrange import gauss_lobatto_points, lagrange_values

    gllm = gauss_lobatto_points(mdeg + 1)
    gllp = gauss_lobatto_points(p + 1)
    T = lagrange_values(gllm, gllp)  # evaluate mdeg basis at p lattice
    Tt = T
    for _ in range(mesh.dim - 1):
        Tt = np.kron(T, Tt)
    pts_c = np.einsum("lm,cmd->cld", Tt, sp)  # (C, Lp, dim)
    a = np.arange(1, mesh.dim + 1, dtype=float)
    u_c = pts_c @ a + 0.5  # (C, Lp) per-cell nodal values
    cd = dh.cell_dofs
    u = np.zeros(dh.n_dofs)
    u[cd.reshape(-1)] = u_c.reshape(-1)
    g = np.einsum("qld,cl->cqd", B, u[cd])
    v = np.einsum("qld,cqd->cl", B, np.einsum("cqde,cqe->cqd", coeff, g))
    Au = np.zeros(dh.n_dofs)
    np.add.at(Au, cd.reshape(-1), v.reshape(-1))
    return np.abs(Au[~dh.boundary_mask]).max()


class TestMeshConstruction:
    def test_ball_cell_counts(self):
        # deal.II hyper_ball_balanced counts: data.pdf ball L=5 => 32·8^4 cells
        assert hyper_ball_balanced(2).n_cells_total == 12
        assert hyper_ball_balanced(3).n_cells_total == 32

    @pytest.mark.parametrize("dim", [2, 3])
    def test_refinement_geometry(self, dim):
        m = hyper_ball_balanced(dim).refine_global(2)
        assert m.n_cells_total == hyper_ball_balanced(dim).n_cells_total * 4**dim
        J = m.jacobians(2, np.array([0.25, 0.75]))
        assert (np.linalg.det(J) > 0).all()
        r = np.linalg.norm(m.vertices[m.boundary_vertex_mask()], axis=1)
        np.testing.assert_allclose(r, 1.0, atol=1e-12)

    def test_patch_extents_positive(self):
        m = hyper_ball_balanced(3).refine_global(1)
        ext = m.harmonic_patch_extents()
        assert (ext[:, :, 1] > 0).all()
        nbr = m.face_neighbors()
        has = (nbr[:, 0::2] >= 0)
        assert ((ext[:, :, 0] > 0) == has).all()


class TestOrientationCorrectness:
    @pytest.mark.parametrize("p", [2, 3, 4])
    def test_rotated_cells_conforming(self, p):
        # quad + line orientations across a rotated shared face
        err = _interior_laplace_residual(rotated_two_cube_mesh(), p)
        assert err < 1e-10

    @pytest.mark.parametrize("dim,p", [(2, 3), (3, 3)])
    def test_ball_conforming(self, dim, p):
        err = _interior_laplace_residual(hyper_ball_balanced(dim).refine(), p)
        assert err < 1e-9

    def test_box_matches_structured_numbering_count(self):
        dh = GeneralDofHandler(box_mesh(3, 2), 3)
        assert dh.n_dofs == 7**3
        cd = dh.cell_dofs
        assert cd.min() == 0 and cd.max() == dh.n_dofs - 1


class TestGeneralOperator:
    @pytest.mark.parametrize("dim", [2, 3])
    def test_vmult_matches_dense(self, dim):
        from dealii_asm.fem.assemble import assemble_laplace_general

        mesh = hyper_ball_balanced(dim)
        dh = GeneralDofHandler(mesh, 3)
        op = GeneralLaplaceOperator(dh, dtype=jnp.float64)
        A = assemble_laplace_general(dh, mapping_degree=2).toarray()
        rng = np.random.default_rng(3)
        x = rng.standard_normal(dh.n_dofs)
        np.testing.assert_allclose(
            np.asarray(op.vmult(jnp.asarray(x))), A @ x, atol=1e-11)

    def test_ball_poisson_convergence_order(self):
        # u = 1 - |x|^2, Q2 isoparametric-ish: O(h^3) nodal error
        from dealii_asm.solvers.krylov import solve as ksolve

        errs = []
        for nref in (1, 2):
            mesh = hyper_ball_balanced(2).refine_global(nref)
            dh = GeneralDofHandler(mesh, 2)
            op = GeneralLaplaceOperator(dh, dtype=jnp.float64)
            b = op.assemble_rhs(lambda x: np.full(x.shape[0], 4.0))
            res = ksolve("CG", op.vmult, b, M=lambda v: v,
                         max_iterations=2000, rel_tolerance=1e-12)
            u = np.asarray(res.x)
            uex = 1.0 - (dh.points ** 2).sum(axis=1)
            errs.append(np.abs(u - uex).max())
        assert errs[0] / errs[1] > 5.0  # ~8 expected


class TestGeneralASM:
    def test_fdm_symm_converges(self):
        from dealii_asm.solvers.krylov import solve as ksolve

        mesh = hyper_ball_balanced(2).refine_global(2)
        dh = GeneralDofHandler(mesh, 4)
        op = GeneralLaplaceOperator(dh, dtype=jnp.float64)
        asm = GeneralASMPreconditioner(dh, weighting_type="symm",
                                       dtype=jnp.float64)
        b = op.assemble_rhs(lambda x: np.full(x.shape[0], 1.0))
        res = ksolve("CG", op.vmult, b, M=asm.vmult, max_iterations=200,
                     rel_tolerance=1e-6)
        assert res.converged and res.n_iterations <= 60

    def test_ras_partition(self):
        mesh = hyper_ball_balanced(2).refine()
        dh = GeneralDofHandler(mesh, 3)
        asm = GeneralASMPreconditioner(dh, weighting_type="ras",
                                       dtype=jnp.float64)
        # every unconstrained DoF owned exactly once
        owned = np.zeros(dh.n_dofs + 1)
        np.add.at(owned, np.asarray(asm.patch_idx).reshape(-1),
                  np.asarray(asm.ras_mask).reshape(-1))
        interior = ~dh.boundary_mask
        np.testing.assert_allclose(owned[:-1][interior], 1.0)


class TestGeneralTransfer:
    @pytest.mark.parametrize("dim", [2, 3])
    def test_transpose_identity(self, dim):
        from dealii_asm.ops.transfer_general import GeneralTwoLevelTransfer

        coarse = hyper_ball_balanced(dim)
        fine = coarse.refine()
        dc = GeneralDofHandler(coarse, 2)
        df = GeneralDofHandler(fine, 2)
        tr = GeneralTwoLevelTransfer(dc, df, dtype=jnp.float64)
        rng = np.random.default_rng(0)
        u = jnp.asarray(rng.standard_normal(dc.n_dofs))
        r = jnp.asarray(rng.standard_normal(df.n_dofs))
        lhs = float(jnp.vdot(tr.prolongate(u), r))
        rhs = float(jnp.vdot(u, tr.restrict(r)))
        assert abs(lhs - rhs) < 1e-10 * max(abs(lhs), 1.0)

    def test_h_prolongation_exact_on_flat_mesh(self):
        # on a flat (affine) mesh the prolongation of the interpolant of a
        # polynomial of degree p reproduces its fine interpolant exactly
        from dealii_asm.ops.transfer_general import GeneralTwoLevelTransfer

        coarse = box_mesh(2, 2)
        fine = coarse.refine()
        p = 3
        dc = GeneralDofHandler(coarse, p)
        df = GeneralDofHandler(fine, p)
        tr = GeneralTwoLevelTransfer(dc, df, dtype=jnp.float64)

        def f(x):
            # vanishes on the boundary (transfers zero constrained rows)
            return (x[:, 0] * (1 - x[:, 0]) * x[:, 1] * (1 - x[:, 1])
                    * (1 + x[:, 0] - x[:, 1]))

        uc = jnp.asarray(f(dc.points))
        uf = np.asarray(tr.prolongate(uc))
        expect = f(df.points)
        free = ~df.boundary_mask
        np.testing.assert_allclose(uf[free], expect[free], atol=1e-12)


class TestBallMultigrid:
    @pytest.mark.slow
    def test_ball_mg_iteration_count(self):
        from dealii_asm.models.poisson import run_config

        cfg = {
            "dim": 2, "degree": 3, "n refinements": 2,
            "mesh": {"name": "hyperball"},
            "rhs": "constant",
            "preconditioner": {
                "type": "Multigrid", "mg type": "h",
                "mg smoother": {"type": "Chebyshev", "degree": 3,
                                "preconditioner": {"type": "FDM",
                                                   "n overlap": 1,
                                                   "weighting type": "symm"}},
                "mg coarse grid solver": {"type": "AMG"},
            },
            "solver": {"type": "CG", "rel tolerance": 1e-4},
        }
        r = run_config(cfg, log=lambda *a: None)
        assert r["converged"] and r["it"] <= 7


class TestGeneralOverlapPatches:
    """Cross-cell overlap patches with rotated frames (dof_tools.h:9-137)."""

    def test_box_patch_positions_exact(self):
        # every overlap-2 patch slot must land on the exact physical lattice
        # point of the equivalent structured patch
        from dealii_asm.fem.general_patches import (
            general_element_patch_indices,
        )
        from dealii_asm.fem.lagrange import gauss_lobatto_points

        p, o, nc = 3, 2, 3
        mesh = box_mesh(3, nc)
        dh = GeneralDofHandler(mesh, p)
        idx = general_element_patch_indices(dh, o)
        gll = gauss_lobatto_points(p + 1)
        h = 1.0 / nc
        m = p - 1 + 2 * o
        lat = np.stack([np.arange(m**3) // m**d % m for d in range(3)],
                       axis=1) - (o - 1)
        ci = np.stack(np.meshgrid(*([np.arange(nc)] * 3), indexing="ij"),
                      axis=-1).reshape(-1, 3)
        n = dh.n_dofs
        for c in range(mesh.n_cells_total):
            for l in range(m**3):
                gi = idx[c, l]
                if gi >= n:
                    continue
                exp = np.empty(3)
                for d in range(3):
                    g1 = ci[c, d] * p + int(lat[l, d])
                    cell2 = min(max(g1 // p, 0), nc - 1)
                    exp[d] = (cell2 + gll[g1 - cell2 * p]) * h
                assert np.abs(dh.points[gi] - exp).max() < 1e-10

    @pytest.mark.slow
    def test_ball_overlap2_converges_better(self):
        from dealii_asm.solvers.krylov import solve as ksolve

        mesh = hyper_ball_balanced(2).refine_global(2)
        dh = GeneralDofHandler(mesh, 3)
        op = GeneralLaplaceOperator(dh, dtype=jnp.float64)
        b = op.assemble_rhs(lambda x: np.ones(x.shape[0]))
        its = {}
        for o in (1, 2):
            asm = GeneralASMPreconditioner(dh, n_overlap=o,
                                           weighting_type="symm",
                                           dtype=jnp.float64)
            r = ksolve("CG", op.vmult, b, M=asm.vmult, max_iterations=300,
                       rel_tolerance=1e-6)
            assert r.converged
            its[o] = r.n_iterations
        assert its[2] <= its[1]


class TestGeneralLanesApply:
    """Lane-major (patches-on-lanes) FDM apply equals the patch-major oracle
    on the unstructured path (see asm.py's _axis_apply_lanes)."""

    @pytest.mark.parametrize("ov,wt", [(1, "symm"), (1, "ras"), (2, "post")])
    def test_matches_patch_major_oracle(self, ov, wt):
        mesh = hyper_ball_balanced(3).refine()
        dh = GeneralDofHandler(mesh, 3)
        asm = GeneralASMPreconditioner(dh, n_overlap=ov, weighting_type=wt,
                                       dtype=jnp.float64)
        assert asm.lanes is not None
        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.standard_normal(dh.n_dofs))
        got = np.asarray(asm.vmult(x))

        # patch-major oracle
        w = asm.weights
        xs = x * w if wt in ("pre", "symm") else x
        xpad = jnp.concatenate([xs, jnp.zeros((1,), xs.dtype)])
        y = asm._fdm_apply(xpad[asm.patch_idx])
        if asm.ras_mask is not None:
            y = y * asm.ras_mask
        ref = jnp.zeros(dh.n_dofs + 1, xs.dtype).at[
            asm.patch_idx.reshape(-1)].add(y.reshape(-1))[:-1]
        if wt in ("post", "symm"):
            ref = ref * w
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-13 * np.abs(ref).max())


class TestGeneralOperatorLanes:
    """Lane-major general operator equals the patch-major oracle (cells on
    lanes: no (C, n, n, n) tensor, no (C, Q, dim, dim) coefficient — six
    symmetric (q, ..., q, C) components instead)."""

    @pytest.mark.parametrize("dim", [2, 3])
    def test_vmult_diag_rhs_match_oracle(self, dim):
        mesh = hyper_ball_balanced(dim).refine()
        dh = GeneralDofHandler(mesh, 3)
        lanes = GeneralLaplaceOperator(dh, dtype=jnp.float64)  # default
        oracle = GeneralLaplaceOperator(dh, dtype=jnp.float64,
                                        kernel="sumfac")
        assert lanes.kernel == "lanes" and lanes.coeff6 is not None
        # f64: native f64 local apply by default (kernel="lanes-dd" is the
        # double-single variant)
        assert lanes.coeff6_dd is None
        rng = np.random.default_rng(1)
        x = jnp.asarray(rng.standard_normal(dh.n_dofs))
        got, ref = np.asarray(lanes.vmult(x)), np.asarray(oracle.vmult(x))
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-12 * np.abs(ref).max())
        dg, dr = (np.asarray(lanes.compute_inverse_diagonal()),
                  np.asarray(oracle.compute_inverse_diagonal()))
        np.testing.assert_allclose(dg, dr, rtol=1e-12)
        f = lambda p: np.cos(p[:, 0]) + p[:, 1]
        gfun = lambda p: p[:, 0] ** 2
        bg = np.asarray(lanes.assemble_rhs(f, dirichlet=gfun))
        br = np.asarray(oracle.assemble_rhs(f, dirichlet=gfun))
        np.testing.assert_allclose(bg, br, rtol=0,
                                   atol=1e-12 * np.abs(br).max())


class TestVectorizedPatchIndices:
    """Batched general_element_patch_indices vs the scalar oracle."""

    @pytest.mark.parametrize("dim,nref,p,ov", [
        (2, 1, 3, 1), (2, 1, 3, 2), (3, 0, 2, 1), (3, 0, 4, 2), (3, 1, 3, 2),
    ])
    def test_matches_scalar_ball(self, dim, nref, p, ov):
        from dealii_asm.fem.general_patches import (
            general_element_patch_indices,
            general_element_patch_indices_scalar,
        )

        mesh = hyper_ball_balanced(dim).refine_global(nref)
        dh = GeneralDofHandler(mesh, p)
        got = general_element_patch_indices(dh, ov)
        ref = general_element_patch_indices_scalar(dh, ov)
        np.testing.assert_array_equal(got, ref)

    def test_matches_scalar_box(self):
        from dealii_asm.fem.general_patches import (
            general_element_patch_indices,
            general_element_patch_indices_scalar,
        )

        dh = GeneralDofHandler(box_mesh(3, 3), 3)
        np.testing.assert_array_equal(
            general_element_patch_indices(dh, 2),
            general_element_patch_indices_scalar(dh, 2))


class TestGeneralVertexPatches:
    """Vertex-star patches on unstructured meshes (data.pdf Tables 15/16
    `cg-fdm symm v` rows; reference dof_tools.h:206-300)."""

    @pytest.mark.parametrize("dim,p", [(2, 3), (3, 2), (3, 4)])
    def test_box_matches_structured(self, dim, p):
        """On a box the general vertex ASM equals the structured one."""
        from dealii_asm.fem.dofs import DofHandler
        from dealii_asm.mesh.grid import StructuredMesh
        from dealii_asm.precond.asm import ASMPreconditioner

        nc = 3
        smesh = StructuredMesh(dim=dim, n_cells=(nc,) * dim)
        sdofs = DofHandler(smesh, p)
        sasm = ASMPreconditioner(sdofs, patch_type="vertex",
                                 weighting_type="symm", dtype=jnp.float64)

        gmesh = box_mesh(dim, nc)
        gdofs = GeneralDofHandler(gmesh, p)
        gasm = GeneralASMPreconditioner(gdofs, patch_type="vertex",
                                        weighting_type="symm",
                                        dtype=jnp.float64)
        # map: general DoF points -> structured lexicographic ids
        N = sdofs.nodes_per_dim
        pts = np.asarray(gdofs.points)
        coord = np.round(pts * (np.asarray(N) - 1)).astype(np.int64)
        gid = sum(coord[:, d] * int(np.prod(N[:d])) for d in range(dim))
        rng = np.random.default_rng(3)
        xs = rng.standard_normal(sdofs.n_dofs)
        xg = xs[gid]
        ys = np.asarray(sasm.vmult(jnp.asarray(xs)))
        yg = np.asarray(gasm.vmult(jnp.asarray(xg)))
        np.testing.assert_allclose(yg, ys[gid], rtol=1e-9, atol=1e-10)

    @pytest.mark.parametrize("dim", [2, 3])
    def test_ball_vertex_converges(self, dim):
        from dealii_asm.solvers.krylov import solve as ksolve

        mesh = hyper_ball_balanced(dim).refine_global(3 - dim + 1)
        dh = GeneralDofHandler(mesh, 3)
        op = GeneralLaplaceOperator(dh, dtype=jnp.float64)
        b = op.assemble_rhs(lambda x: np.ones(x.shape[0]))
        asm = GeneralASMPreconditioner(dh, patch_type="vertex",
                                       weighting_type="symm",
                                       dtype=jnp.float64)
        r = ksolve("CG", op.vmult, b, M=asm.vmult, max_iterations=300,
                   rel_tolerance=1e-6)
        assert r.converged
        assert r.n_iterations < 60
