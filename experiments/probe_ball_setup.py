"""Host-setup budget for the ball at L=5 (8.4M DoF) — VERDICT r3 task #3/#7.

Times each setup stage (mesh refinement, orientation-baked DoF tables, face
tables, operator geometry, FDM patch setup) on the host, no solve.  Target:
all host setup < 2 min (was > 25 min in round 2 before the batched builders
and the vectorized patch-index walks)."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np


def tick(label, t0):
    t = time.perf_counter()
    print(f"{label:42s} {t - t0:8.1f} s", flush=True)
    return t


def main():
    nref = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    degree = int(sys.argv[2]) if len(sys.argv) > 2 else 4

    from dealii_asm.mesh.unstructured import hyper_ball_balanced
    from dealii_asm.fem.general_dofs import GeneralDofHandler
    from dealii_asm.ops.laplace_general import GeneralLaplaceOperator
    from dealii_asm.precond.asm_general import GeneralASMPreconditioner

    t0 = time.perf_counter()
    mesh = hyper_ball_balanced(3)
    for _ in range(nref):
        mesh = mesh.refine()
    t0 = tick(f"mesh refine x{nref} ({mesh.n_cells_total} cells)", t0)

    dofs = GeneralDofHandler(mesh, degree)
    t0 = tick(f"GeneralDofHandler (n_dofs={dofs.n_dofs})", t0)

    op = GeneralLaplaceOperator(dofs, dtype=jnp.float32)
    t0 = tick("GeneralLaplaceOperator", t0)

    asm = GeneralASMPreconditioner(dofs, n_overlap=1, weighting_type="symm",
                                   dtype=jnp.float32)
    t0 = tick("GeneralASM ov1", t0)

    from dealii_asm.fem.general_patches import general_vertex_patch_indices

    idx, ext = general_vertex_patch_indices(dofs)
    t0 = tick(f"vertex patch indices ({idx.shape})", t0)


if __name__ == "__main__":
    main()
