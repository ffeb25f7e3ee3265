"""Host-side stepping drivers: chunked scan stepping and the host-adaptive
solver schedule.

Two reasons motivate this module:

* an in-graph ``cfg.adapt_schedule`` ``lax.cond`` duplicates the solve
  into both branches, which defeats XLA fusion around it.  The
  JAX-idiomatic form of an adaptive schedule is a STATIC schedule per
  compile, with the HOST choosing which compiled step to dispatch;
* each per-step dispatch pays a host tax (Python pytree flattening and
  the launch itself); a ``lax.scan`` chunk of C steps per call amortizes
  it C-fold without changing the physics (the scan body IS ``step``).

Both costs were measured on the engine's first accelerator; neither has
been measured on the H100 yet.

The host decides the schedule from ``warm_hit_frac`` — the same signal
the in-graph cond used — read with a LAG of two chunks so the device->
host transfer always overlaps queued compute (a fresh read would stall
the dispatch pipeline until the device drains).  The mode switch
therefore reacts within ~2*C steps instead of the cond's same-step
reaction: fine for piles settling over hundreds of steps (the bench
regime), wrong for scenes with abrupt external impulses — those should
keep the in-graph cond (reference behavior analog: the demo always runs
the full 20-sweep schedule, world.rs:293).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from mgf_tpu.world import WorldConfig, step

__all__ = ["make_chunk_step", "AdaptiveChunkStepper"]


def make_chunk_step(cfg: WorldConfig, chunk: int = 16, light: bool = False):
    """A jitted ``world -> (world, metrics)`` running ``chunk`` ``step``
    calls via ``lax.scan``.  Metrics come back stacked (chunk,) per key;
    the physics is identical to ``chunk`` separate calls.

    ``light=True`` runs the chunk's interior steps with
    ``cfg.light_metrics`` (skipping the observability reductions) and the
    LAST step with full metrics, so every chunk still surfaces the quality
    guards (max_penetration, overflow, drift excess) in its final row.
    The physics is identical — light_metrics only changes metric outputs.

    Buffer donation is not offered: donating the world into the jitted
    step was measured slower on the engine's first accelerator (not
    measured on the H100).
    """
    C = int(chunk)
    full_cfg = cfg._replace(light_metrics=False)
    light_cfg = cfg._replace(light_metrics=True)

    def body_for(c):
        def body(w, _):
            return step(w, c)
        return body

    if not light:
        def run(world):
            return jax.lax.scan(body_for(cfg), world, None, length=C)
        return jax.jit(run)

    def run(world):
        if C > 1:
            world, m_int = jax.lax.scan(body_for(light_cfg), world, None,
                                        length=C - 1)
        world, m_last = step(world, full_cfg)
        m_last = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x)[None], m_last)
        if C > 1:
            m = jax.tree_util.tree_map(
                lambda a, b: jnp.concatenate([a, b], axis=0), m_int, m_last)
        else:
            m = m_last
        return world, m

    return jax.jit(run)


class AdaptiveChunkStepper:
    """Chunked stepping with the solver schedule selected by the host.

    ``cfg.adapt_schedule = (thr, it2, in2)`` is interpreted exactly as the
    in-graph form — full ``solver_iters x solver_inner`` while the contact
    set is in flux, ``it2 x in2`` once ``warm_hit_frac >= thr`` — but both
    schedules are separate STATIC compiles and the choice lags two chunks
    (see module docstring).  Disengagement is immediate on the first
    lagged read below the threshold; engagement needs ``patience``
    consecutive reads at or above it (hysteresis against boundary
    flicker).
    """

    def __init__(self, cfg: WorldConfig, chunk: int = 16,
                 patience: int = 2, light: bool = False):
        if cfg.adapt_schedule is None:
            raise ValueError("cfg.adapt_schedule is None — use "
                             "make_chunk_step directly")
        thr, it2, in2 = cfg.adapt_schedule
        self.thr = float(thr)
        self.chunk = int(chunk)
        self.patience = int(patience)
        base = cfg._replace(adapt_schedule=None)
        self.full = make_chunk_step(base, chunk, light=light)
        self.hot = make_chunk_step(base._replace(solver_iters=int(it2),
                                                 solver_inner=int(in2)),
                                   chunk, light=light)
        self.hot_on = False
        self._streak = 0
        self._pending = []      # warm_hit_frac device scalars, oldest first

    def _drain_one(self):
        frac = float(np.asarray(self._pending.pop(0)))
        if frac >= self.thr:
            self._streak += 1
            if self._streak >= self.patience:
                self.hot_on = True
        else:
            self._streak = 0
            self.hot_on = False

    def step_chunk(self, world):
        """Dispatch one chunk; returns (world, stacked metrics).  The
        schedule used was decided from the chunk-before-last's metrics."""
        # decide from reads that are EXACTLY 2 chunks old (their device
        # work is complete, so the transfer can't stall the queue) —
        # draining at >= 2 (not > 2) keeps the lag at the documented 2*C
        # steps
        while len(self._pending) >= 2:
            self._drain_one()
        f = self.hot if self.hot_on else self.full
        world, m = f(world)
        self._pending.append(m["warm_hit_frac"][-1])
        return world, m

    def run(self, world, n_steps):
        """Step ``n_steps`` (rounded up to whole chunks); returns
        (world, last metrics dict with per-key last-step values)."""
        n_chunks = -(-int(n_steps) // self.chunk)
        m = None
        for k in range(n_chunks):
            world, m = self.step_chunk(world)
        last = jax.tree_util.tree_map(lambda x: x[-1], m)
        return world, last
