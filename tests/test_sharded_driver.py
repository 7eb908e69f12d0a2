"""Driver-level multi-device path: `"n devices"` in the JSON config routes the
whole solve through explicit-halo ShardedLattice levels (VERDICT r2 task #4 —
the reference driver is MPI-parallel end to end,
element_centered_preconditioners_01.cc under mpirun -np 40)."""

import os

import jax
import numpy as np
import pytest

from dealii_asm.models.poisson import run_config


def _cfg(**over):
    base = {
        "dim": 3,
        "degree": 3,
        "n refinements": 2,
        "solver": {"type": "CG", "rel tolerance": 1e-6},
        "preconditioner": {
            "type": "Multigrid",
            "mg type": "h",
            "mg smoother": {
                "type": "Chebyshev",
                "degree": 1,
                "preconditioner": {"type": "FDM", "n overlap": 1,
                                   "weighting type": "symm"},
            },
            "mg coarse grid solver": {"type": "AMG"},
        },
    }
    base.update(over)
    return base


class TestShardedDriver:
    @pytest.mark.slow
    def test_iteration_parity_and_solution(self):
        assert len(jax.devices()) >= 8
        r1 = run_config(_cfg(), log=lambda *_: None)
        cfg = _cfg(**{"n devices": 8})
        cfg["preconditioner"]["replicate below"] = 500
        r8 = run_config(cfg, log=lambda *_: None)
        assert r8["converged"] and r1["converged"]
        assert r8["it"] == r1["it"]
        np.testing.assert_allclose(np.asarray(r8["solution"]),
                                   np.asarray(r1["solution"]),
                                   rtol=1e-7, atol=1e-9)

    @pytest.mark.slow
    def test_two_sharded_levels_relaxation(self):
        """Sharded-sharded transfers + Relaxation smoother + diag inner."""
        cfg = _cfg(**{"n devices": 4, "degree": 2, "n refinements": 3})
        cfg["preconditioner"]["replicate below"] = 300
        cfg["preconditioner"]["mg smoother"] = {
            "type": "Chebyshev", "degree": 2,
            "preconditioner": {"type": "Diagonal"},
        }
        r1 = run_config(_cfg(**{"degree": 2, "n refinements": 3,
                                "preconditioner": cfg["preconditioner"]}),
                        log=lambda *_: None)
        r4 = run_config(cfg, log=lambda *_: None)
        assert r4["converged"]
        assert r4["it"] == r1["it"]
        np.testing.assert_allclose(np.asarray(r4["solution"]),
                                   np.asarray(r1["solution"]),
                                   rtol=1e-7, atol=1e-9)

    @pytest.mark.skipif(
        not os.environ.get("DEALII_ASM_HEAVY_TESTS"),
        reason="full unstructured sharded E2E: 30-70 min on the one-core "
               "CI host (two MG setups + multi-device shard compiles). "
               "Verified green this round at 8 devices (iteration parity "
               "+ solution match); component equality lives in "
               "test_general_sharded.py. DEALII_ASM_HEAVY_TESTS=1 "
               "runs it.")
    def test_unstructured_sharded_matches_single_device(self):
        # P1/P3 for every mesh family (round 5): the hyperball routes
        # through the sharded-fine / replicated-coarse path
        # (parallel/general_sharded.py) with single-device iteration parity
        # 4 virtual devices / 56 cells: the 8-dev variant of this test
        # measured 71 min on the one-core CI host (two full MG setups +
        # 8-way shard compiles); 4 devices covers the same code path
        cfg = _cfg(**{"n devices": 4})
        cfg["mesh"] = {"name": "hyperball"}
        cfg["n refinements"] = 1
        cfg["degree"] = 2
        res4 = run_config(cfg, log=lambda *_: None)
        cfg1 = dict(cfg)
        cfg1["n devices"] = 1
        res1 = run_config(cfg1, log=lambda *_: None)
        assert res4["converged"] and res1["converged"]
        assert res4["it"] == res1["it"]
        np.testing.assert_allclose(np.asarray(res4["solution"]),
                                   np.asarray(res1["solution"]),
                                   rtol=0, atol=1e-8)


class TestShardedBenchmark:
    def test_ghost_columns_and_parity(self, capsys):
        """`>>` lines report the true per-rank ghost-layer size (2·hw·plane)
        under sharding — matrix_free_loop_08.likwid.cc:390-395 — and the
        sharded applies run (values exercised by halo equality tests)."""
        import io

        from dealii_asm.models.benchmark import run_benchmark

        buf = io.StringIO()
        run_benchmark({"dim": 3, "n subdivisions": 14, "fe degree": 4,
                       "n repetitions": 2,
                       "preconditioner types": "vmult symm-1-g",
                       "number type": "float32", "n devices": 2}, out=buf)
        lines = [l.split() for l in buf.getvalue().splitlines()
                 if l.startswith(">>")]
        assert len(lines) == 2
        # z axis: 16 nodes sharded over 2; vmult band hw=4, plane 16*32
        assert int(lines[0][7]) == 2 * 4 * 16 * 32
        assert int(lines[1][7]) > 0
