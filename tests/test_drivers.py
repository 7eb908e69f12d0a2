"""Driver smoke tests: benchmark protocols and deformed-mesh MG convergence."""

import io
import json

import numpy as np
import pytest


def test_throughput_benchmark_protocol():
    from dealii_asm.models.benchmark import run_benchmark

    out = io.StringIO()
    run_benchmark({
        "dim": 2, "n subdivision": 3, "fe degree": 3, "n repetitions": 2,
        "number type": "float64",
        "preconditioner types": "vmult post-1-c cheby-2-2-diag",
    }, out=out)
    lines = [l for l in out.getvalue().splitlines() if l.startswith(">>")]
    assert len(lines) == 3
    for l in lines:
        parts = l.split()
        assert len(parts) == 9
        assert int(parts[2]) > 0 and float(parts[4]) > 0


def test_solver_anatomy_protocol():
    from dealii_asm.models.solver_bench import run_solver_anatomy

    out = io.StringIO()
    run_solver_anatomy({"dim": 2, "n subdivision": 3, "fe degree": 2,
                        "n iterations": 5, "solvers": "CG GMRES IDR"}, out=out)
    lines = [l for l in out.getvalue().splitlines() if l.startswith(">> solver-")]
    assert len(lines) == 3


def test_transfer_bench_protocol():
    from dealii_asm.models.solver_bench import run_transfer_bench

    out = io.StringIO()
    run_transfer_bench({"dim": 2, "n subdivision": 3, "fe degree": 4,
                        "n repetitions": 2}, out=out)
    lines = [l for l in out.getvalue().splitlines() if l.startswith(">> transfer-")]
    assert len(lines) == 6  # 3 coarse degrees x {restrict, prolongate}


def test_power_kernel_protocol():
    from dealii_asm.models.power_kernel import run_power_kernel

    out = io.StringIO()
    run_power_kernel({"dim": 2, "n subdivision": 2, "fe degree": 2,
                      "n repetitions": 2}, out=out)
    lines = [l for l in out.getvalue().splitlines() if l.startswith(">>")]
    assert len(lines) == 3


def test_kershaw_mg_converges():
    """Deformed-mesh end-to-end: Kershaw ε=0.5, h-MG with FDM smoothing."""
    from dealii_asm.models.poisson import run_config

    cfg = {
        "dim": 3, "degree": 2, "n refinements": 1,
        "mesh": {"name": "kershaw", "eps": 0.5, "n subdivisions": 3,
                 "n initial refinements": 0},
        "solver": {"type": "CG", "rel tolerance": 1e-4},
        "preconditioner": {
            "type": "Multigrid",
            "mg smoother": {
                "type": "Chebyshev", "degree": 2,
                "preconditioner": {"type": "FDM", "n overlap": 1,
                                   "weighting type": "symm"}},
            "mg coarse grid solver": {"type": "AMG"},
        },
    }
    res = run_config(cfg, log=lambda *_: None)
    assert res["converged"]
    assert res["it"] <= 25  # ε=0.5 Kershaw, 2-level h-MG: ~18 its
    assert res["n_cells"] == 216


def test_experiment_generator(tmp_path, monkeypatch):
    import dealii_asm  # noqa: F401  (repo root on path)
    import experiments.kershaw as gen

    monkeypatch.setattr(gen, "HERE", str(tmp_path))
    import shutil

    shutil.copy("experiments/default.json", tmp_path / "default.json")
    gen.run_instance(0, 3, 2, 4, "CG", "fdm_post_1", "bisect", 2, 0.3,
                     "1st kind", "one sided")
    cfg = json.load(open(tmp_path / "input_0000.json"))
    assert cfg["mesh"]["eps"] == 0.3
    assert cfg["preconditioner"]["one-sided v-cycle"] is True
    assert cfg["preconditioner"]["mg smoother"]["preconditioner"]["n overlap"] == 1
