"""Debug mode: NaN guards, world validation, and step invariant checks.

The reference relies on Rust's safety plus panics on misuse (SURVEY.md
§5.2-5.3: ``Pool::remove`` of an empty slot, ``BVH::root`` on empty,
``Sphere::new`` with r <= 0 all panic).  The engine's device code is
total (masks instead of panics) and host-side misuse is validated in
SceneBuilder; this module adds the runtime observability layer:

* :func:`enable_debug_mode` — JAX's NaN checker (every jitted step re-runs
  uncompiled and raises at the first NaN-producing op).
* :func:`validate_world` — host-side invariant sweep over a World pytree
  (finite state, unit quaternions, positive radii, sane inverse masses,
  warm/bp cache shape consistency).  The ``World::step`` misuse analog.
* :func:`check_step_metrics` — raises on the silent-degradation signals
  (broadphase overflow / span / reach violations, dropped solver rows)
  that turn into wrong physics if ignored.
"""

from __future__ import annotations

import jax
import numpy as np


def enable_debug_mode(nan_checks: bool = True):
    """Enable jax debug_nans (+ disable_jit-free NaN localization)."""
    if nan_checks:
        jax.config.update("jax_debug_nans", True)


def disable_debug_mode():
    jax.config.update("jax_debug_nans", False)


def validate_world(world, cfg=None):
    """Host-side invariant checks; raises ValueError with every violation
    found.  Cheap enough to call between steps in a debug loop."""
    b = world.bodies
    errs = []

    def finite(name, *arrays):
        for a in arrays:
            if not np.isfinite(np.asarray(a)).all():
                errs.append(f"{name}: non-finite values")
                return

    finite("x", b.x.x, b.x.y, b.x.z)
    finite("v", b.v.x, b.v.y, b.v.z)
    finite("omega", b.omega.x, b.omega.y, b.omega.z)
    finite("q", b.q.w, b.q.x, b.q.y, b.q.z)
    qn = np.sqrt(np.asarray(b.q.w) ** 2 + np.asarray(b.q.x) ** 2
                 + np.asarray(b.q.y) ** 2 + np.asarray(b.q.z) ** 2)
    if np.abs(qn - 1.0).max(initial=0.0) > 1e-3:
        errs.append(f"q: not unit (max |1-|q|| = {np.abs(qn-1).max():.2e})")
    if (np.asarray(b.shape_r) <= 0.0).any():
        errs.append("shape_r: non-positive radius (geom.rs:300 analog)")
    if (np.asarray(b.inv_mass) < 0.0).any():
        errs.append("inv_mass: negative")
    if (np.asarray(b.shape_half_h) < 0.0).any():
        errs.append("shape_half_h: negative")
    if world.warm is not None:
        n = b.n_bodies
        if world.warm.acc_n.shape[1] != n:
            errs.append(
                f"warm state N {world.warm.acc_n.shape[1]} != bodies {n} "
                "(re-run init_warm after changing the body count)")
        if cfg is not None:
            from mgf_tpu.world import solver_row_count
            r = solver_row_count(cfg, world.terrain.a.x.shape[0])
            if world.warm.acc_n.shape[0] != r:
                errs.append(
                    f"warm state rows {world.warm.acc_n.shape[0]} != "
                    f"solver_row_count {r} (config changed?)")
    if errs:
        raise ValueError("world validation failed:\n  " + "\n  ".join(errs))


def check_step_metrics(metrics, max_penetration: float = 1.0):
    """Raise on silent-degradation signals in a step's metrics dict."""
    errs = []
    g = lambda k: float(np.asarray(metrics[k])) if k in metrics else 0.0
    if g("broadphase_overflow") > 0:
        errs.append(f"broadphase bucket overflow "
                    f"{int(g('broadphase_overflow'))} bodies dropped "
                    "(raise GridConfig.bucket_cap)")
    if g("broadphase_span_excess") > 0:
        errs.append("scene span exceeds grid modulus (dim*cell) — occupied "
                    "cells alias; raise GridConfig.dim")
    if g("broadphase_reach_excess") > 0.0:
        errs.append(f"pair reach exceeds the candidate window guarantee by "
                    f"{g('broadphase_reach_excess'):.3f} (fast movers may "
                    "miss pairs; grow cell_size or lower fatten)")
    if g("terrain_reach_excess") > 0.0:
        errs.append(f"body reach exceeds the terrain grid window guarantee "
                    f"by {g('terrain_reach_excess'):.3f} (terrain contacts "
                    "may be missed; grow terrain_grid_cfg.cell_size)")
    if g("max_penetration") > max_penetration:
        errs.append(f"max penetration {g('max_penetration'):.3f} > "
                    f"{max_penetration} (solver not converging; add sweeps "
                    "or enable warm_start)")
    if errs:
        raise ValueError("step degradation detected:\n  "
                         + "\n  ".join(errs))
