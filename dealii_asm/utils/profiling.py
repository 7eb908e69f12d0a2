"""Timing & profiling utilities.

Replaces the reference's two instrumentation mechanisms (SURVEY.md §5):
- per-MG-stage wall-clock timers hooked on V-cycle stages
  (/root/reference/include/multigrid.h:402-464, printed as a level×stage
  matrix at :188-245) → ``StageTimer`` + ``print_timings``;
- LIKWID hardware counters → ``trace`` wraps jax.profiler traces, and
  ``hlo_cost`` reports the XLA cost model (FLOPs / bytes) of a jitted fn,
  from which roofline numbers are derived.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax


class StageTimer:
    """Accumulates wall time per (level, stage); blocking at stage edges.

    Enable only for profiling runs: the block_until_ready barriers defeat
    cross-stage fusion/overlap.
    """

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.times = defaultdict(float)
        self.counts = defaultdict(int)

    def run(self, level: int, name: str, fn, *args):
        """Execute fn(*args), blocking on its result when timing is enabled."""
        if not self.enabled:
            return fn(*args)
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        self.times[(level, name)] += time.perf_counter() - t0
        self.counts[(level, name)] += 1
        return out

    def clear(self):
        self.times.clear()
        self.counts.clear()

    def print_timings(self, file=None):
        """Level × stage matrix (multigrid.h:188-245 analog)."""
        if not self.times:
            return
        stages = sorted({k[1] for k in self.times})
        levels = sorted({k[0] for k in self.times})
        header = "level | " + " | ".join(f"{s:>12}" for s in stages)
        print(header, file=file)
        for l in levels:
            row = f"{l:5d} | " + " | ".join(
                f"{self.times.get((l, s), 0.0):12.6f}" for s in stages)
            print(row, file=file)


@contextlib.contextmanager
def trace(log_dir: str):
    """jax profiler trace context (LIKWID-marker analog)."""
    with jax.profiler.trace(log_dir):
        yield


def hlo_cost(fn, *args):
    """XLA cost-analysis of a jitted function: flops / bytes accessed."""
    lowered = jax.jit(fn).lower(*args)
    compiled = lowered.compile()
    try:
        analysis = compiled.cost_analysis()
        if isinstance(analysis, list):
            analysis = analysis[0]
        return {
            "flops": analysis.get("flops", float("nan")),
            "bytes accessed": analysis.get("bytes accessed", float("nan")),
        }
    except Exception:
        return {}
