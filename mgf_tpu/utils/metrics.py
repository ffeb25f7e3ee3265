"""Metrics / tracing helpers.

The reference's only instrumentation is the demos' per-step wall-clock
print (balls.rs:107-112).  The engine returns a metrics dict from every
jitted step (num_pairs, num_contacts, broadphase_overflow, ...); this module
adds a host-side accumulator and a timing harness around
``jax.block_until_ready`` plus optional ``jax.profiler`` traces.
"""

from __future__ import annotations

import time
from typing import Optional

import jax
import numpy as np


class MetricsLog:
    """Accumulates per-step metrics dicts host-side."""

    def __init__(self):
        self.rows = []

    def append(self, metrics):
        self.rows.append({k: np.asarray(v).item()
                          for k, v in metrics.items()})

    def summary(self):
        if not self.rows:
            return {}
        keys = self.rows[0].keys()
        return {k: float(np.mean([r[k] for r in self.rows])) for k in keys}


class StepTimer:
    """Wall-clock step timing with warmup, mirroring balls.rs:107-112.

    with StepTimer() as t:
        for _ in range(n): world, m = step(world)
        t.sync(world)
    print(t.ms_per_step(n))
    """

    def __init__(self, trace_dir: Optional[str] = None):
        self.trace_dir = trace_dir
        self._t0 = None
        self._elapsed = None

    def __enter__(self):
        if self.trace_dir:
            self._trace = jax.profiler.trace(self.trace_dir)
            self._trace.__enter__()
        self._t0 = time.perf_counter()
        return self

    def sync(self, tree):
        jax.block_until_ready(tree)

    def __exit__(self, *exc):
        self._elapsed = time.perf_counter() - self._t0
        if self.trace_dir:
            self._trace.__exit__(*exc)
        return False

    def ms_per_step(self, n_steps: int) -> float:
        return self._elapsed / max(n_steps, 1) * 1000.0
