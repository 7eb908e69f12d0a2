"""Mesh gallery + coarsening-sequence inspection drivers.

Rebuilds /root/reference/mesh_types_01/02/03.cc (mesh family gallery written
as VTU with per-cell aspect ratios) and coarsening_types.cc (the level layout
of each multigrid variant).

Usage:
  python -m dealii_asm.models.mesh_gallery gallery [outdir]
  python -m dealii_asm.models.mesh_gallery coarsening [degree]
"""

from __future__ import annotations

import os
import sys

import numpy as np


def run_gallery(outdir: str = "mesh_gallery"):
    from ..mesh.grid import StructuredMesh
    from ..mesh.transforms import kershaw_transform
    from ..mesh.unstructured import hyper_ball_balanced
    from ..utils.vtu import write_vtu_mesh

    os.makedirs(outdir, exist_ok=True)
    rows = []

    def emit(name, mesh):
        path = os.path.join(outdir, f"{name}.vtu")
        write_vtu_mesh(path, mesh)
        rows.append((name, mesh.n_cells_total, round(mesh.max_aspect_ratio(), 3)))

    emit("hypercube", StructuredMesh(3, (8, 8, 8)))
    for stretch in (2.0, 10.0, 50.0):
        emit(f"anisotropy_{stretch:g}",
             StructuredMesh(3, (8, 8, 8), lengths=(1.0, 1.0, stretch)))
    for eps in (1.0, 0.5, 0.3, 0.05):
        emit(f"kershaw_{eps:g}",
             StructuredMesh(3, (6, 6, 6), transform=kershaw_transform(eps, eps)))
    for dim in (2, 3):
        emit(f"hyperball_{dim}d", hyper_ball_balanced(dim).refine_global(2))

    print("| mesh | n_cells | aspect_ratio |")
    for name, nc, ar in rows:
        print(f"| {name} | {nc} | {ar} |")
    return rows


def run_coarsening(degree: int = 4, n_refinements: int = 3):
    """coarsening_types.cc analog: print each MG variant's level layout."""
    from ..ops.transfer import p_sequence

    print(f"degree = {degree}, n_refinements = {n_refinements}")
    for seq in ("bisect", "go to one", "decrease by one"):
        print(f"p sequence {seq!r}: {p_sequence(degree, seq)}")
    for mg_type in ("h", "p", "hp", "ph"):
        degrees = p_sequence(degree, "bisect")
        if mg_type == "h":
            levels = [(r, degree) for r in range(n_refinements + 1)]
        elif mg_type == "p":
            levels = [(n_refinements, d) for d in degrees]
        elif mg_type == "hp":
            levels = [(0, d) for d in degrees]
            levels += [(r, degree) for r in range(n_refinements + 1)]
        else:
            levels = [(r, degrees[0]) for r in range(n_refinements + 1)]
            levels += [(n_refinements, d) for d in degrees]
        dedup = [levels[0]]
        for lv in levels[1:]:
            if lv != dedup[-1]:
                dedup.append(lv)
        print(f"mg type {mg_type!r}: levels (refinement, degree) = {dedup}")


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    which = argv[0] if argv else "gallery"
    if which == "gallery":
        run_gallery(argv[1] if len(argv) > 1 else "mesh_gallery")
    else:
        run_coarsening(int(argv[1]) if len(argv) > 1 else 4)
    return 0


if __name__ == "__main__":
    sys.exit(main())
