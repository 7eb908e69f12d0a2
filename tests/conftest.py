import os

# Tests run on CPU with 8 virtual devices (multi-device sharding is validated on
# a virtual mesh; the GPU is exercised by chip_smoke.py) and float64 enabled so
# reference/golden comparisons match deal.II's double-precision behavior.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

# by config as well: a jax imported before this file would not see the env var
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from dealii_asm.utils.jitutils import enable_compilation_cache  # noqa: E402

# compiles dominate the suite's wall time
enable_compilation_cache()


def pytest_configure(config):
    # `slow` tags tests >~15 s on a 1-core host (sharded-driver parity,
    # on-mesh convergence runs).  The DEFAULT run includes them — the full
    # suite is the contract; `pytest -m "not slow"` is the quick dev loop
    # (~5 min instead of ~17).
    config.addinivalue_line(
        "markers", "slow: long-running test (excluded via -m 'not slow')")
