"""Kershaw sweep generator (reference: experiments/kershaw.py).

Writes input_NNNN.json configs sweeping solver × smoother preconditioner ×
Chebyshev degree × polynomial kind × cycle type × p-sequence × eps for the
main driver (python -m dealii_asm input_*.json).
"""

import copy
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def run_instance(counter, d, l, k, solver, preconditioner, sequence, s, eps,
                 cheby_kind, cycle_type):
    with open(os.path.join(HERE, "default.json")) as f:
        cfg = json.load(f)

    cfg["name"] = "-".join([solver.lower(), preconditioner,
                            cheby_kind.replace(" ", "_"),
                            cycle_type.replace(" ", "_")])
    cfg["mesh"] = {"name": "kershaw", "eps": eps}
    cfg["dim"] = d
    cfg["n refinements"] = l
    cfg["degree"] = k
    cfg["solver"]["type"] = solver

    pre = cfg["preconditioner"]
    pre["mg p sequence"] = sequence
    sm = pre["mg smoother"]
    sm["degree"] = s
    sm["polynomial type"] = cheby_kind
    if preconditioner == "diagonal":
        sm["preconditioner"] = {"type": "Diagonal"}
    else:
        props = preconditioner.split("_")
        assert props[0] == "fdm"
        sm["preconditioner"] = {"type": "FDM", "weighting type": props[1]}
        if props[2] == "v":
            sm["preconditioner"]["element centric"] = False
        else:
            sm["preconditioner"]["n overlap"] = int(props[2])
    if cycle_type == "one sided":
        pre["one-sided v-cycle"] = True

    with open(os.path.join(HERE, f"input_{counter:04d}.json"), "w") as f:
        json.dump(cfg, f, indent=4)


def main():
    counter = 0
    dim, degree = 3, 4
    refinements = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    for eps in [1.0, 0.8, 0.5, 0.3]:
        for solver in ["CG", "GMRES"]:
            for precon in ["diagonal", "fdm_post_1", "fdm_symm_1",
                           "fdm_post_2", "fdm_post_v"]:
                for seq in ["bisect", "go to one", "decrease by one"]:
                    for s in [1, 2, 3, 4, 5]:
                        for kind in ["1st kind", "4th kind"]:
                            for cycle in ["two sided", "one sided"]:
                                run_instance(counter, dim, refinements, degree,
                                             solver, precon, seq, s, eps,
                                             kind, cycle)
                                counter += 1
    print(f"wrote {counter} configs")


if __name__ == "__main__":
    main()
