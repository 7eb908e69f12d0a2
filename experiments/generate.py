"""Unified experiment-sweep generator — the reference's generator family.

Mirrors /root/reference/experiments/{anisotropy,cartesian,ball,fdm_vs_asm,
multigrid_cheby_degree,large-scaling,large-scaling-ras}.py: each subcommand
writes input_NNNN.json configs for the solver CLI
(``python -m dealii_asm input_*.json`` or ``experiments/run_sweep.py``).

Usage: python experiments/generate.py <family> [dim] [refinements] [degree]
"""

from __future__ import annotations

import copy
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _default():
    with open(os.path.join(HERE, "default.json")) as f:
        return json.load(f)


class Writer:
    def __init__(self, outdir):
        self.counter = 0
        self.outdir = outdir or HERE
        os.makedirs(self.outdir, exist_ok=True)

    def write(self, cfg):
        path = os.path.join(self.outdir, f"input_{self.counter:04d}.json")
        with open(path, "w") as f:
            json.dump(cfg, f, indent=4)
        self.counter += 1


def _apply_smoother(cfg, preconditioner, s, cheby_kind=None, cycle_type=None):
    """Decode the reference's preconditioner naming: diagonal |
    {fdm,asm}_{weighting}_{overlap|v}[_f]."""
    pre = cfg["preconditioner"]
    sm = pre["mg smoother"]
    sm["degree"] = s
    if cheby_kind is not None:
        sm["polynomial type"] = cheby_kind
    if preconditioner == "diagonal":
        sm["preconditioner"] = {"type": "Diagonal"}
    else:
        props = preconditioner.replace("-", "_").split("_")
        kind = props[0]
        if kind == "fdm":
            sm["preconditioner"] = {"type": "FDM",
                                    "weighting type": props[1]}
            if props[2] == "v":
                sm["preconditioner"]["element centric"] = False
                # vertex patches skip p=1 levels: intermediate diag-Chebyshev
                # (the reference does the same, anisotropy.py:89-101)
                pre["mg intermediate smoother"] = {
                    "type": "Chebyshev",
                    "degree": 2 * (s + 2) if cycle_type == "one sided" else s + 2,
                    "preconditioner": {"type": "Diagonal"},
                }
            else:
                sm["preconditioner"]["n overlap"] = int(props[2])
        elif kind == "asm":
            sm["preconditioner"] = {
                "type": "AdditiveSchwarzPreconditioner",
                "weighting type": props[1],
                "n overlap": int(props[2]),
            }
        else:
            raise ValueError(preconditioner)
    if cycle_type == "one sided":
        sm["degree"] = 2 * s
        pre["one-sided v-cycle"] = True


def _base(d, l, k, mesh, solver, sequence, name):
    cfg = _default()
    cfg["name"] = name
    cfg["dim"] = d
    cfg["n refinements"] = l
    cfg["degree"] = k
    cfg["mesh"] = mesh
    cfg["solver"]["type"] = solver
    cfg["preconditioner"]["mg p sequence"] = sequence
    return cfg


def gen_anisotropy(w, d=3, l=2, k=4, epsilons=(1.0, 50.0)):
    """experiments/anisotropy.py analog."""
    precons = ["diagonal"]
    for a in ["post", "symm"]:
        for o in range(1, 3):
            precons.append(f"fdm_{a}_{o}_f")
        precons.append(f"fdm_{a}_v_f")
    for eps in epsilons:
        for solver in ["CG", "GMRES"]:
            if solver == "CG":
                use = [i for i in precons if i == "diagonal" or "symm" in i]
            else:
                use = [i for i in precons if "post" in i]
            for precon in use:
                for kind in ["1st kind", "4th kind"]:
                    cycles = (["two sided"] if solver == "CG"
                              else ["two sided", "one sided"])
                    for cycle in cycles:
                        for seq in ["bisect", "go to one", "decrease by one"]:
                            for s in range(1, 6):
                                name = "-".join([solver.lower(), precon,
                                                 kind.replace(" ", "_"),
                                                 cycle.replace(" ", "_")])
                                cfg = _base(d, l, k,
                                            {"name": "anisotropy",
                                             "stratch": eps},
                                            solver, seq, name)
                                _apply_smoother(cfg, precon, s, kind, cycle)
                                w.write(cfg)


def gen_cartesian(w, d=3, l=2, k=4):
    """experiments/cartesian.py analog (all four weighting modes, RAS)."""
    precons = ["diagonal"]
    for a in ["none", "pre", "post", "symm"]:
        for o in range(1, min(k, 3) + 1):
            precons.append(f"fdm_{a}_{o}_f")
    for o in range(2, min(k, 3) + 1):
        precons.append(f"fdm_ras_{o}_f")
    for solver in ["CG", "GMRES"]:
        use = precons
        if solver == "CG":
            use = [i for i in precons
                   if i == "diagonal" or "symm" in i or "none" in i]
        for precon in use:
            for seq in ["bisect", "go to one", "decrease by one"]:
                for s in range(1, 6):
                    cfg = _base(d, l, k, {"name": "hypercube"},
                                solver, seq, f"{solver.lower()}-{precon}")
                    _apply_smoother(cfg, precon, s)
                    w.write(cfg)


def gen_ball(w, d=3, l=2, k=4):
    """experiments/ball.py analog."""
    precons = ["diagonal"]
    for a in ["none", "pre", "post", "symm"]:
        precons.append(f"fdm_{a}_1_f")
    for solver in ["CG", "GMRES"]:
        if solver == "CG":
            use = [i for i in precons if i == "diagonal" or "symm" in i]
        else:
            use = [i for i in precons if "post" in i]
        for precon in use:
            for kind in ["1st kind", "4th kind"]:
                cycles = (["two sided"] if solver == "CG"
                          else ["two sided", "one sided"])
                for cycle in cycles:
                    for seq in ["bisect", "go to one", "decrease by one"]:
                        for s in range(1, 6):
                            cfg = _base(d, l, k, {"name": "hyperball"},
                                        solver, seq,
                                        f"{solver.lower()}-{precon}")
                            # ball hierarchy is h-refined
                            cfg["preconditioner"]["mg type"] = "h"
                            _apply_smoother(cfg, precon, s, kind, cycle)
                            w.write(cfg)


def gen_fdm_vs_asm(w, d=3, l=2, k=4):
    """experiments/fdm_vs_asm.py analog: FDM vs matrix-based block ASM."""
    precons = ["diagonal"]
    for a in ["symm"]:
        for o in range(1, 3):
            precons.append(f"fdm_{a}_{o}_f")
        for o in range(1, 3):
            precons.append(f"asm_{a}_{o}_f")
    for eps in [1.0, 0.99, 0.9, 0.7, 0.5, 0.3]:
        for precon in precons:
            for seq in ["bisect", "go to one", "decrease by one"]:
                for s in range(1, 6):
                    cfg = _base(d, l, k, {"name": "kershaw", "eps": eps},
                                "CG", seq, f"cg-{precon}")
                    _apply_smoother(cfg, precon, s)
                    w.write(cfg)


def gen_multigrid_cheby_degree(w, d=3, l=6, k=4):
    """experiments/multigrid_cheby_degree.py analog."""
    for solver in ["CG", "GMRES"]:
        precon = "fdm_symm_1_f" if solver == "CG" else "fdm_post_1_f"
        for s in range(1, 6):
            for seq in ["bisect", "go to one", "decrease by one"]:
                cfg = _base(d, l, k, {"name": "anisotropy", "stratch": 50.0},
                            solver, seq, f"{solver.lower()}-cheby{s}")
                _apply_smoother(cfg, precon, s)
                w.write(cfg)


_LS_VARIANTS = {
    "diag": ("diagonal", 3, {}),
    "fdm1": ("fdm_symm_1_f", 2, {}),
    "fdm2": ("fdm_symm_2_f", 2, {}),
    "fdmv": ("fdm_symm_v_f", 2, {}),
    "ras": ("fdm_ras_2_f", 5, {"solver": "GMRES"}),
}


def gen_large_scaling(w, d=3, variants=("diag", "fdm1", "fdm2", "fdmv"),
                      max_refine=12):
    """experiments/large-scaling.py analog: refinement ladders 0..11
    (≥1B DoFs at the top at Q4, large-scaling.py:32)."""
    for l in range(0, max_refine):
        for v in variants:
            precon, s, extra = _LS_VARIANTS[v]
            cfg = _base(d, l, 4, {"name": "anisotropy", "stratch": 50.0},
                        extra.get("solver", "CG"), "bisect",
                        f"large-scaling-{v}")
            cfg["preconditioner"]["mg type"] = "hp"
            # coarse levels replicated; large coarse problems use the
            # matrix-free CG coarse solver instead of a dense inverse
            cfg["preconditioner"]["mg coarse grid solver"] = {
                "type": "AMG" if l <= 6 else "CoarseCG"}
            _apply_smoother(cfg, precon, s)
            w.write(cfg)


def _mfl_base(degree, subdivisions, labels, n_rep=10):
    return {
        "dim": 3,
        "n subdivision": subdivisions,
        "fe degree": degree,
        "n repetitions": n_rep,
        "use cartesian mesh": True,
        "number type": "float32",
        "preconditioner types": " ".join(labels),
    }


# (degree, subdivisions) ladder keeping n_dofs roughly constant
# (matrix_free_loop_08_degree.py:24; our balanced cube uses the same s)
_MFL_LADDER = [(2, 45), (3, 44), (4, 40), (5, 39), (6, 38), (7, 36)]


def gen_mfl_degree(w, *_):
    """Kernel-throughput sweep over fe degree (matrix_free_loop_08_degree.py);
    run with python -m dealii_asm.models.benchmark input_NNNN.json."""
    labels = ["vmult", "symm-1-c", "symm-2-g-p-n", "symm-v-c"]
    for k, s in _MFL_LADDER:
        w.write(_mfl_base(k, s, labels))


def gen_mfl_cheby(w, *_):
    """Chebyshev-wrapped smoother sweep (matrix_free_loop_08_cheby.py)."""
    labels = ["cheby-3-0-diag", "cheby-3-3-diag",
              "cheby-3-0-symm-1-c", "cheby-3-2-symm-1-c",
              "cheby-3-0-symm-2-g-p-n", "cheby-3-2-symm-2-g-p-n",
              "cheby-3-0-symm-v-c", "cheby-3-2-symm-v-c"]
    for k, s in _MFL_LADDER:
        w.write(_mfl_base(k, s, labels))


def gen_mfl_cheby_degree(w, *_):
    """Chebyshev-degree sweep at fixed size
    (matrix_free_loop_08_cheby_degree.py)."""
    for deg in range(1, 6):
        labels = [f"cheby-{deg}-0-diag", f"cheby-{deg}-2-diag",
                  f"cheby-{deg}-0-symm-1-c", f"cheby-{deg}-2-symm-1-c"]
        w.write(_mfl_base(4, 40, labels))


def gen_mfl_sequence(w, *_):
    """Weight-sequence × overlap × weighting-mode matrix
    (matrix_free_loop_08_sequence.py's predicate table)."""
    labels = []
    for k in ["1", "2", "v"]:
        for seq in ["c", "l", "dg", "g-s-c", "g-s-n", "g-p-c", "g-p-n"]:
            for op in ["add", "none", "post", "pre", "symm"]:
                ok = False
                if k in ("1", "v") and seq == "c" and op in ("post", "pre",
                                                             "symm"):
                    ok = True
                elif seq in ("l", "dg") and op in ("post", "pre", "symm"):
                    ok = True
                elif seq in ("g-s-c", "g-p-c") and op in ("pre", "symm"):
                    ok = True
                elif seq == "g-s-n" and op in ("none", "post", "pre", "symm"):
                    ok = True
                elif seq == "g-p-n":
                    ok = True
                if ok:
                    labels.append(f"{op}-{k}-{seq}")
    w.write(_mfl_base(4, 40, labels))


FAMILIES = {
    "anisotropy": gen_anisotropy,
    "cartesian": gen_cartesian,
    "ball": gen_ball,
    "fdm_vs_asm": gen_fdm_vs_asm,
    "multigrid_cheby_degree": gen_multigrid_cheby_degree,
    "large-scaling": gen_large_scaling,
    "mfl_degree": gen_mfl_degree,
    "mfl_cheby": gen_mfl_cheby,
    "mfl_cheby_degree": gen_mfl_cheby_degree,
    "mfl_sequence": gen_mfl_sequence,
}


def main():
    if len(sys.argv) < 2 or sys.argv[1] not in FAMILIES:
        print("usage: generate.py "
              f"{{{','.join(FAMILIES)}}} [dim] [refinements] [degree]")
        sys.exit(1)
    fam = sys.argv[1]
    args = [int(a) for a in sys.argv[2:5]]
    outdir = os.path.join(HERE, f"sweep_{fam.replace('-', '_')}")
    w = Writer(outdir)
    FAMILIES[fam](w, *args)
    print(f"wrote {w.counter} configs to {outdir}")


if __name__ == "__main__":
    main()
