"""CLI: python -m dealii_asm config1.json [config2.json ...]

Mirrors the reference solver CLI
(/root/reference/element_centered_preconditioners_01.cc:840-881): each JSON
config is one run / one table row; the org-mode convergence table prints at
the end.
"""

import json
import sys

import jax

jax.config.update("jax_enable_x64", True)

from .models.poisson import run_config
from .utils.jitutils import enable_compilation_cache
from .utils.table import ConvergenceTable


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 1
    enable_compilation_cache()
    print("# NOTE: Chebyshev/Lanczos eigenvalue estimates are start-vector"
          " dependent;\n# they match the reference to ~4% while iteration"
          " counts match exactly\n# (see tests/test_golden_suite.py).")
    table = ConvergenceTable()
    for path in argv:
        with open(path) as f:
            params = json.load(f)
        run_config(params, table)
    table.print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
