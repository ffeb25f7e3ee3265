"""Benchmark harness: prints ONE JSON line with the headline metric.

Headline (BASELINE.json config 5): physics steps/sec on the 100k-sphere
stress scene on one GPU.  Secondary metrics (stderr, one JSON line): the
reference demo scenes (1,332-sphere balls, 1,331-capsule capsules), the
10k-body heightfield scene, the GJK/EPA and compound batch rates, the
cold 20-sweep and mixed 100k stress rows, and the body raytrace rates.
Every rate is the median over timed windows, each ending in
``block_until_ready``, with the window spread beside it; both lines name
the device.  Any scene that fails fails the run; without a GPU the run
stops before it starts.

Usage: python bench.py [--quick] [--bodies N] [--mixed]
"""

import argparse
import functools
import json
import sys
import time

import jax
import numpy as np

from mgf_tpu.utils.runtime import (device_info, enable_compile_cache,
                                   require_gpu)


def time_steps(world, cfg, warmup, iters, windows=3, chunk=0):
    """Step ``warmup`` steps, then time ``windows`` windows of ``iters``
    steps, each ending in ``block_until_ready``.  Returns (median rate,
    window rates, compile seconds, world, metrics of the last step).

    ``chunk`` > 0: dispatch ``chunk`` steps per jit call via
    ``driver.make_chunk_step`` (lax.scan — same physics, C-fold fewer
    host dispatches, light interior metrics with full metrics on each
    chunk's last step), with the adaptive solver schedule chosen on the
    host (``driver.AdaptiveChunkStepper``) instead of the in-graph
    lax.cond.
    """
    from mgf_tpu.world import step

    if chunk:
        from mgf_tpu.driver import AdaptiveChunkStepper, make_chunk_step
        if cfg.adapt_schedule is not None:
            fc = AdaptiveChunkStepper(cfg, chunk=chunk, light=True).step_chunk
        else:
            fc = make_chunk_step(cfg, chunk, light=True)
    else:
        chunk = 1
        fc = jax.jit(functools.partial(step, cfg=cfg))
    t0 = time.perf_counter()
    world, m = fc(world)
    jax.block_until_ready(world)
    compile_s = time.perf_counter() - t0
    for _ in range(-(-warmup // chunk)):
        world, m = fc(world)
    jax.block_until_ready(world)
    rates = []
    n_calls = -(-iters // chunk)
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(n_calls):
            world, m = fc(world)
        jax.block_until_ready(world)
        dt = time.perf_counter() - t0
        rates.append(n_calls * chunk / dt)
        if np.isnan(np.asarray(world.bodies.x.y)).any():
            raise RuntimeError("NaN in the body state")
    if chunk > 1:
        m = jax.tree_util.tree_map(lambda x: x[-1], m)
    return float(np.median(rates)), rates, compile_s, world, m


def _penetration_p99(world, cfg):
    """99th-percentile penetration over ALL valid contacts (pairs +
    terrain) at the world's current state — one collect_contacts step,
    computed on host (scripts/mixed_pen_types.py's statistic, carried in
    the bench artifact)."""
    from mgf_tpu.world import step

    fc = jax.jit(functools.partial(step, cfg=cfg, collect_contacts=True))
    _, m = fc(world)
    pens = []
    for key in ("pair_contacts", "terrain_contacts"):
        if key not in m:
            continue
        c = m[key]["contact"]
        pen = -((np.asarray(c.b.x) - np.asarray(c.a.x)) * np.asarray(c.n.x)
                + (np.asarray(c.b.y) - np.asarray(c.a.y)) * np.asarray(c.n.y)
                + (np.asarray(c.b.z) - np.asarray(c.a.z))
                * np.asarray(c.n.z))
        valid = np.asarray(c.valid)
        pens.append(np.maximum(pen[valid], 0.0))
    if not pens:
        return 0.0
    allp = np.concatenate(pens)
    return float(np.percentile(allp, 99.0)) if allp.size else 0.0


def _time_op(f, argsets):
    """Median seconds per call over ``argsets``, each call ending in
    ``block_until_ready`` (the first call compiles and is not timed)."""
    jax.block_until_ready(f(*argsets[0]))
    ts = []
    for a in argsets:
        t0 = time.perf_counter()
        jax.block_until_ready(f(*a))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def bench_gjk_batch(n=8192, iters=10):
    """BASELINE config 4: GJK/EPA discrete narrowphase batched over convex
    pairs (simplex.rs loop) — OBB vs OBB contact rate."""
    import jax.numpy as jnp
    from mgf_tpu.geom import OBB, support_obb
    from mgf_tpu.gjk import contact_convex_convex
    from mgf_tpu.math3d import Quat, Vec3, qnormalize

    rng = np.random.default_rng(0)

    def mk(eps):
        def obb(shift):
            q = qnormalize(Quat(*(jnp.asarray(
                rng.standard_normal(n), jnp.float32) for _ in range(4))))
            c = Vec3(*(jnp.asarray(
                rng.uniform(-1.5, 1.5, n) + shift + eps, jnp.float32)
                for _ in range(3)))
            r = Vec3(*(jnp.asarray(rng.uniform(0.5, 1.0, n), jnp.float32)
                       for _ in range(3)))
            return OBB(c=c, q=q, r=r)
        return obb(0.0), obb(1.0)

    def run(a, b):
        return contact_convex_convex(lambda d: support_obb(a, d),
                                     lambda d: support_obb(b, d),
                                     jnp.ones(n, jnp.float32))

    f = jax.jit(run)
    sec = _time_op(f, [mk(1e-5 * i) for i in range(iters)])
    return n / sec


def bench_compound_batch(parts=8192, iters=10):
    """BASELINE config 3: compound rigid bodies vs a polygon face
    (Compound Contacts, compound.rs:334-352) — part tests/sec."""
    import jax.numpy as jnp
    from mgf_tpu.compound import compound_contacts_polygon, compound_from_parts
    from mgf_tpu.geom import Rectangle
    from mgf_tpu.math3d import Vec3, vec3

    rng = np.random.default_rng(1)
    specs = []
    for i in range(parts):
        c = rng.uniform(-20, 20, 3)
        if i % 2 == 0:
            specs.append(dict(kind="sphere", center=tuple(c), r=0.5))
        else:
            specs.append(dict(kind="capsule", a=tuple(c),
                              d=(1.0, 0.0, 0.0), r=0.4))
    comp = compound_from_parts(specs)
    rect = Rectangle(c=vec3(0.0, -21.0, 0.0), u0=vec3(1.0, 0.0, 0.0),
                     u1=vec3(0.0, 0.0, 1.0), e0=jnp.float32(25.0),
                     e1=jnp.float32(25.0))

    def run(comp, v):
        return compound_contacts_polygon(comp, rect, v)

    f = jax.jit(run)
    argsets = [(comp, vec3(0.0, -3.0 - 1e-5 * i, 0.0))
               for i in range(iters)]
    sec = _time_op(f, argsets)
    return parts / sec


def bench_raytrace(world, rays=16384, iters=8):
    """Grid DDA body raytrace (BVH::raytrace, bvh.rs:345-369) vs the dense
    O(N) scan, downward rays into the settled stress pile.  The grid's
    cost is ~independent of N (only cells the ray crosses are tested), the
    dense scan scales with N.  The grid/state is passed as a jit
    ARGUMENT (closing over it bakes the table into the HLO as a constant,
    which compiles for minutes).  16k rays x 100k bodies = 1.6G ray tests
    per dense call."""
    import jax.numpy as jnp
    from mgf_tpu.math3d import Vec3
    from mgf_tpu.queries import (
        build_body_grid, raytrace_bodies, raytrace_bodies_grid)

    state = world.bodies
    rng = np.random.default_rng(3)
    side = float(np.asarray(state.x.x).max())
    top = float(np.asarray(state.x.y).max())

    def mk(eps):
        p = Vec3(*(jnp.asarray(rng.uniform(-side, side, rays) + eps,
                               jnp.float32) for _ in range(3)))
        p = p._replace(y=jnp.zeros((rays,), jnp.float32) + (top + 2.0))
        d = Vec3(jnp.asarray(rng.uniform(-0.3, 0.3, rays), jnp.float32),
                 jnp.full((rays,), -1.0, jnp.float32),
                 jnp.asarray(rng.uniform(-0.3, 0.3, rays), jnp.float32))
        return p, d

    # sizing: each axis' dims * cell modulus must EXCEED that axis'
    # OCCUPIED span or distinct occupied cells alias and overflow the
    # bucket cap — r3's bench caught exactly this (cubic dim 64 at cell
    # 1.25 -> modulus 80 vs pile span ~139 -> 254k dropped bodies, 346
    # missed rays).  The settled pile is FLAT (~1.15 bodies/unit^3 over
    # ~139 x 8 x 139), so the grid is anisotropic: x/z get modulus 160,
    # y stays at 8 cells; cap 24 covers the ~13 AABB-binned bodies/cell.
    grid = jax.jit(lambda s: build_body_grid(
        s, cell_size=1.25, dims=(128, 8, 128), cap=24))(state)
    fg = jax.jit(jax.vmap(raytrace_bodies_grid, in_axes=(None, 0, 0)))
    fd = jax.jit(jax.vmap(raytrace_bodies, in_axes=(None, 0, 0)))
    argsets = [mk(1e-4 * i) for i in range(iters)]
    sec_g = _time_op(lambda p, d: fg(grid, p, d), argsets)
    sec_d = _time_op(lambda p, d: fd(state, p, d), argsets)
    ig, bg = fg(grid, *argsets[0])
    id_, bd = fd(state, *argsets[0])
    hg, hd = np.asarray(ig.hit), np.asarray(id_.hit)
    tdiff = np.where(hg & hd,
                     np.asarray(ig.t) - np.where(hd, np.asarray(id_.t), 0.0),
                     0.0)
    mism = int(np.sum((hg != hd) | (np.abs(tdiff) > 1e-3)))
    return rays / sec_g, rays / sec_d, int(grid.overflow), mism


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="10k bodies, skip secondary scenes")
    ap.add_argument("--bodies", type=int, default=100_000)
    ap.add_argument("--mixed", action="store_true",
                    help="stress scene with a 25%% capsule mix (BASELINE "
                         "config 5's mixed form; longer compile)")
    args = ap.parse_args()
    try:
        require_gpu()
    except RuntimeError as e:
        sys.exit(f"bench: {e}")
    enable_compile_cache()
    device = device_info()

    from mgf_tpu.scenes import (balls_scene, capsules_scene, stress_scene,
                                terrain_scene)

    secondary = {}

    def rate(key, r):
        secondary[key] = r[0]
        secondary[key + "_windows"] = r[1]

    if not args.quick:
        w, cfg = balls_scene()
        # warm until the pile has landed (contact-rich regime)
        r = time_steps(w, cfg, warmup=180, iters=60)
        rate("balls_1332_steps_per_sec", r)
        secondary["balls_compile_s"] = r[2]

        w, cfg = capsules_scene()
        r = time_steps(w, cfg, warmup=280, iters=60)
        rate("capsules_1331_steps_per_sec", r)
        secondary["capsules_compile_s"] = r[2]

        # BASELINE config 3 as a real world: 10k mixed bodies raining on a
        # 10,368-triangle heightfield with grid-culled terrain
        w, cfg = terrain_scene(n_bodies=10_000)
        r = time_steps(w, cfg, warmup=120, iters=40)
        rate("terrain_10k_steps_per_sec", r)
        secondary["terrain_10k_contacts"] = int(r[4]["num_contacts"])

        secondary["gjk_obb_pairs_per_sec"] = bench_gjk_batch()
        secondary["compound_part_tests_per_sec"] = bench_compound_batch()

    # headline: 100k-sphere stress scene, measured at the SETTLED pile
    # (12-layer box fill reaches steady state by ~150 steps; overflow and
    # max penetration below are the quality guards for that regime)
    n = 10_000 if args.quick else args.bodies
    if not args.quick:
        # warm-start honesty row (the warm extension diverges from the
        # reference's cold GS schedule): same scene, REFERENCE solver
        # semantics — accumulators zeroed every frame and 20 two-phase
        # sweeps (solver.rs:72-78, world.rs:293); scripts/cold_oracle.py
        # establishes what the reference's own GS yields on this pile
        # (see PARITY.md).
        w, cfg = stress_scene(n)
        cfg = cfg._replace(warm_start=False, fused_iso=False,
                           warm_match="search", adapt_schedule=None,
                           solver_iters=20, solver_inner=1,
                           two_phase=True)
        r = time_steps(w._replace(warm=None), cfg, warmup=180, iters=30)
        rate("stress_cold20_steps_per_sec", r)
        secondary["stress_cold20_max_penetration"] = float(
            r[4]["max_penetration"])
        if not args.mixed:
            # BASELINE config 5 is "100k MIXED sphere/capsule": record the
            # mixed form beside the sphere headline.  warmup 400: the
            # mixed pile's capsule columns keep consolidating past the
            # nominal settle; chunked dispatch like the headline.
            w, cfg = stress_scene(n, mixed=True)
            r = time_steps(w, cfg, warmup=400, iters=64, windows=3,
                           chunk=16)
            rate("stress_mixed_steps_per_sec", r)
            m = r[4]
            secondary["stress_mixed_max_penetration"] = float(
                m["max_penetration"])
            secondary["stress_mixed_compile_s"] = r[2]
            # p99 penetration across ALL contacts (pairs + terrain):
            # distinguishes systemic interpenetration from a few pinned
            # corner bodies
            secondary["stress_mixed_p99_penetration"] = _penetration_p99(
                r[3], cfg)
            if cfg.bp_every > 1:
                secondary["stress_mixed_bp_drift_excess"] = float(
                    m["broadphase_cache_drift_excess"])
    w, cfg = stress_scene(n, mixed=args.mixed)
    # warmup 1600: the 12-layer pile keeps CONSOLIDATING well past the
    # nominal settle (scripts/soak_flagship.py) — the headline measures
    # the steady state the rebuild cadence is designed for.  Quality
    # guards (pen/overflow) below certify the regime.
    # chunk=64: 64 steps per dispatch (lax.scan) + HOST-adaptive schedule
    # — same physics, no in-graph cond.  Each window times 128 steps.
    sps, rates, comp, world, m = time_steps(w, cfg, warmup=1600, iters=128,
                                            windows=3, chunk=64)
    secondary["stress_chunk"] = 64
    secondary["stress_host_adaptive"] = cfg.adapt_schedule is not None
    secondary["stress_light_interior_metrics"] = True
    secondary["stress_steps_per_sec_windows"] = rates
    secondary["stress_compile_s"] = comp
    secondary["stress_num_contacts"] = int(m["num_contacts"])
    secondary["stress_broadphase_overflow"] = int(m["broadphase_overflow"])
    secondary["stress_max_penetration"] = float(m["max_penetration"])
    if cfg.bp_every > 1:
        # self-certify the rebuild cadence: the headline is only
        # meaningful if the bp_every gate was ENGAGED during the measured
        # window — sample the next 2*bp_every steps
        from mgf_tpu.world import step
        f = jax.jit(functools.partial(step, cfg=cfg))
        reb = 0
        for _ in range(2 * cfg.bp_every):
            world, m2 = f(world)
            reb += int(np.asarray(m2["broadphase_rebuilt"]))
        secondary["stress_bp_rebuilds_per_cycle"] = reb / 2.0
        secondary["stress_bp_drift_excess"] = float(
            np.asarray(m2["broadphase_cache_drift_excess"]))
    # narrowphase contact tests/sec = candidate pairs tested per second
    secondary["narrowphase_pair_tests_per_sec"] = (
        float(m["num_constraints"]) * sps)

    if not args.quick:
        # ray casts against the SETTLED headline world (the regime where
        # the grid DDA beats the dense scan)
        sps_g, sps_d, ovf, mism = bench_raytrace(world)
        secondary["raytrace_grid_rays_per_sec"] = sps_g
        secondary["raytrace_dense_rays_per_sec"] = sps_d
        secondary["raytrace_grid_overflow"] = ovf
        secondary["raytrace_grid_mismatch"] = mism

    secondary["device"] = device
    print(json.dumps(secondary), file=sys.stderr)
    print(json.dumps({
        "metric": (f"physics steps/sec at {n} "
                   + ("mixed sphere/capsule bodies" if args.mixed
                      else "spheres") + " (stress scene)"),
        "value": sps,
        "unit": "steps/s",
        "windows": rates,
        "device": device,
    }))


if __name__ == "__main__":
    main()
