"""Run a sweep of solver configs and print one results table.

The reference runs each input_NNNN.json through the driver under mpirun
(experiments/README.MD); here one process runs them sequentially on the
device and collects (name, n_dofs, iterations, time) — the iteration column
reproduces the corresponding data.pdf table.

Usage: python experiments/run_sweep.py <dir-or-json...> [--limit N] [--f32]
"""

from __future__ import annotations

import glob
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    limit = None
    for a in sys.argv[1:]:
        if a.startswith("--limit"):
            limit = int(a.split("=")[1]) if "=" in a else None
    use_f32 = "--f32" in sys.argv

    files = []
    for a in args:
        if os.path.isdir(a):
            files += sorted(glob.glob(os.path.join(a, "input_*.json")))
        else:
            files.append(a)
    if limit:
        files = files[:limit]

    import jax

    if not use_f32:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from dealii_asm.models.poisson import run_config
    from dealii_asm.utils.table import ConvergenceTable

    rows = []
    for fn in files:
        with open(fn) as f:
            cfg = json.load(f)
        try:
            r = run_config(cfg, log=lambda *a: None,
                           dtype=jnp.float32 if use_f32 else jnp.float64)
            rows.append((cfg.get("name", os.path.basename(fn)), r["n_dofs"],
                         r["it"], r["table"].rows[-1].get("time", "")))
        except Exception as e:  # record failures, keep sweeping
            rows.append((cfg.get("name", os.path.basename(fn)), "-", "ERR",
                         str(e)[:40]))
        print(f"{fn}: {rows[-1]}", flush=True)

    print("\n| name | n_dofs | it | time |")
    for name, nd, it, t in rows:
        print(f"| {name} | {nd} | {it} | {t} |")


if __name__ == "__main__":
    main()
