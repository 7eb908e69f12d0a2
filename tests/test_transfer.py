import numpy as np
import jax.numpy as jnp
import pytest

from dealii_asm.fem.dofs import DofHandler
from dealii_asm.mesh.balanced import decompose_balanced
from dealii_asm.mesh.grid import StructuredMesh
from dealii_asm.ops.transfer import TwoLevelTransfer, p_sequence


def _transfer_matrix(tr, n_coarse, n_fine, prolongate=True):
    cols = []
    n_in = n_coarse if prolongate else n_fine
    f = tr.prolongate if prolongate else tr.restrict
    for i in range(n_in):
        e = jnp.zeros(n_in, jnp.float64).at[i].set(1.0)
        cols.append(np.asarray(f(e)))
    return np.column_stack(cols)


@pytest.mark.parametrize("kind", ["p", "h"])
def test_restriction_is_transpose_of_prolongation(kind):
    mesh_f = StructuredMesh(2, (4, 4))
    if kind == "p":
        coarse = DofHandler(mesh_f, 1)
        fine = DofHandler(mesh_f, 3)
    else:
        coarse = DofHandler(StructuredMesh(2, (2, 2)), 3)
        fine = DofHandler(mesh_f, 3)
    tr = TwoLevelTransfer(coarse, fine)
    P = _transfer_matrix(tr, coarse.n_dofs, fine.n_dofs, prolongate=True)
    R = _transfer_matrix(tr, coarse.n_dofs, fine.n_dofs, prolongate=False)
    np.testing.assert_allclose(R, P.T, atol=1e-12)


@pytest.mark.parametrize("kind", ["p", "h"])
def test_prolongation_preserves_polynomials(kind):
    # interpolating the coarse space's own functions must be exact on free dofs
    mesh_f = StructuredMesh(2, (4, 4))
    if kind == "p":
        coarse = DofHandler(mesh_f, 2)
        fine = DofHandler(mesh_f, 4)
    else:
        coarse = DofHandler(StructuredMesh(2, (2, 2)), 2)
        fine = DofHandler(mesh_f, 2)
    tr = TwoLevelTransfer(coarse, fine)
    # coarse nodal field of a global polynomial in the coarse space
    pc = coarse.points
    f = lambda x: 0.3 + x[:, 0] ** 2 - 0.5 * x[:, 1] * x[:, 0]
    uc = jnp.asarray(np.where(coarse.boundary_mask, 0.0, f(pc)))
    uf = np.asarray(tr.prolongate(uc))
    pf = fine.points
    expect = f(pf)
    free = ~fine.boundary_mask
    # interior fine nodes whose coarse interpolation stencil touches no
    # boundary node reproduce the polynomial exactly; compare away from bdry
    hc = 1.0 / coarse.mesh.n_cells[0]  # coarse cell width
    inner = free & (np.min(np.abs(pf - 0.0), axis=1) > hc + 0.01) & (
        np.min(np.abs(pf - 1.0), axis=1) > hc + 0.01)
    np.testing.assert_allclose(uf[inner], expect[inner], atol=1e-12)


def test_p_sequences():
    assert p_sequence(7, "bisect") == [1, 3, 7]
    assert p_sequence(4, "bisect") == [1, 2, 4]
    assert p_sequence(4, "decrease by one") == [1, 2, 3, 4]
    assert p_sequence(4, "go to one") == [1, 4]
    assert p_sequence(1, "go to one") == [1]


def test_balanced_decomposition_matches_reference_table():
    """Reproduces /root/reference/subdivided_hyper_cube_balanced_01.output:
    's n_refine s0 s1 s2 n_cells' rows for dim=3, s=1..49."""
    import os

    path = "/root/reference/subdivided_hyper_cube_balanced_01.output"
    if not os.path.exists(path):
        pytest.skip("reference output unavailable")
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 6:
                continue
            s, n_refine, s0, s1, s2, n_cells = parts
            got_refine, subdiv = decompose_balanced(3, int(s))
            assert got_refine == int(n_refine), s
            assert subdiv == [int(s0), int(s1), int(s2)], s
            total = subdiv[0] * subdiv[1] * subdiv[2] * 8 ** got_refine
            assert abs(total - float(n_cells)) / float(n_cells) < 5e-3, s
