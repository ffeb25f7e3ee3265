"""Direct tests for the r3 step-pipeline machinery:

* bp_every broadphase rebuild cadence — reuse-step trajectory parity on a
  settled pile, cadence observability, drift-excess detection for a body
  that outruns the cache, and the transient disengage gate;
* adapt_schedule — the lax.cond branches equal the explicit schedules on
  both sides of the warm-hit threshold;
* warm_match="pos" + stable_pairs — equivalent to the order-robust
  "search" matching while the partner set is unchanged.

All on the 12-layer stress pile at small N (the flagship config's own
scene builder, so the tested flags compose exactly as the bench runs
them).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mgf_tpu.math3d import Vec3
from mgf_tpu.scenes import stress_scene
from mgf_tpu.world import init_bp_cache, init_warm, step

N_BODIES = 800


def _scene():
    """The flagship stress config at test size on the jnp solve — the
    fused solver kernel's reference (the kernel compiles for the GPU
    only; tests/test_solver_sweep.py holds the two to parity)."""
    world, cfg = stress_scene(N_BODIES)
    return world, cfg._replace(pallas_solver=False)


@pytest.fixture(scope="module")
def settled():
    """The small stress pile settled under the flagship config."""
    world, cfg = _scene()
    f = jax.jit(functools.partial(step, cfg=cfg))
    m = None
    for _ in range(260):
        world, m = f(world)
    jax.block_until_ready(world)
    m = jax.tree_util.tree_map(np.asarray, m)
    assert int(m["broadphase_overflow"]) == 0
    assert float(m["max_penetration"]) < 0.3
    return world, cfg


def _steps(world, cfg, n, collect=None):
    f = jax.jit(functools.partial(step, cfg=cfg))
    ms = []
    for _ in range(n):
        world, m = f(world)
        if collect:
            ms.append({k: np.asarray(m[k]) for k in collect})
    jax.block_until_ready(world)
    return world, ms


def _pos(world):
    b = world.bodies
    return np.stack([np.asarray(b.x.x), np.asarray(b.x.y),
                     np.asarray(b.x.z)], -1)


def test_bp_every_trajectory_parity_settled(settled):
    """On a settled pile the cached candidate list is a superset of the
    fresh one whose extras are out of contact range — trajectories under
    bp_every=2 must track the rebuild-every-step path to float noise."""
    world, cfg = settled
    # pin the cadence to 2 (the flagship ships a longer cadence whose
    # rebuild count is set by the staleness trigger, not the modulus —
    # asserted separately below)
    cfg2 = cfg._replace(bp_every=2)
    w2, ms2 = _steps(world, cfg2, 24,
                     collect=["broadphase_rebuilt", "num_contacts",
                              "broadphase_cache_drift_excess"])
    cfg1 = cfg._replace(bp_every=1)
    w1, ms1 = _steps(world._replace(bp=None), cfg1, 24,
                     collect=["num_contacts"])
    p1, p2 = _pos(w1), _pos(w2)
    # two-tier noise band: candidate-slot membership differs between the
    # cached and fresh lists (no-contact extras shift canonical slot
    # positions), so solver accumulation order differs and f32 noise
    # amplifies through contact branches — a few coordinates land ~1e-2
    # after 24 steps.  Require 99% inside the 5 mm band and NOBODY past
    # 2 cm (4% of a radius).
    d = np.abs(p2 - p1)
    assert d.max() < 0.02, d.max()
    assert (d > 5e-3).mean() < 0.01, (d > 5e-3).mean()
    # median bound: systematic drift cannot hide inside the
    # per-coordinate outlier band — the TYPICAL coordinate must match to
    # sub-mm
    assert np.median(d) < 1e-3, np.median(d)
    # cadence observability: the modulus fires every other step; the
    # staleness trigger may add a few
    rebuilt = [bool(m["broadphase_rebuilt"]) for m in ms2]
    assert 12 <= sum(rebuilt) <= 18, rebuilt
    assert not all(rebuilt)
    # the flagship's own (longer) cadence must also ENGAGE on the settled
    # pile: strictly fewer rebuilds than steps, and zero drift excess
    _, msf = _steps(world, cfg, 24,
                    collect=["broadphase_rebuilt",
                             "broadphase_cache_drift_excess"])
    flag_reb = [bool(m["broadphase_rebuilt"]) for m in msf]
    assert sum(flag_reb) < 12, flag_reb
    assert max(float(m["broadphase_cache_drift_excess"])
               for m in msf) == 0.0
    # contact sets match on reuse steps (stale candidates, exact
    # narrowphase); the mm-scale positional noise above makes marginal
    # contacts flicker, so the band is relative (0.5%), not absolute
    for m1, m2 in zip(ms1, ms2):
        c1, c2 = int(m1["num_contacts"]), int(m2["num_contacts"])
        assert abs(c1 - c2) <= max(2, 0.005 * c1), (c1, c2)
    # nobody outran the cache at the settled state
    assert max(float(m["broadphase_cache_drift_excess"]) for m in ms2) == 0.0


def test_bp_every_fast_mover_forces_rebuild(settled):
    """r4 staleness gate: a body that outruns its build slack forces a
    rebuild THE SAME STEP (before the stale candidates would be used), so
    reuse steps never carry drift excess — the cache is self-certifying.
    A 60 m/s body (delta/step = 1.0 >> slack) must pin the cadence at
    rebuild-every-step while it flies."""
    world, cfg = settled
    b = world.bodies
    vx = b.v.x.at[0].set(60.0)
    fast = world._replace(bodies=b._replace(v=b.v._replace(x=vx)))
    _, ms = _steps(fast, cfg, 4,
                   collect=["broadphase_rebuilt",
                            "broadphase_cache_drift_excess"])
    assert all(bool(m["broadphase_rebuilt"]) for m in ms)
    assert all(float(m["broadphase_cache_drift_excess"]) == 0.0
               for m in ms)


def test_bp_every_transient_disengages_cadence(settled):
    """More than a handful of slack-clamped fast bodies must disengage the
    cadence entirely (every step rebuilds) — the transient safety gate."""
    world, cfg = settled
    b = world.bodies
    idx = jnp.arange(48)
    vx = b.v.x.at[idx].set(60.0)
    fast = world._replace(bodies=b._replace(v=b.v._replace(x=vx)))
    _, ms = _steps(fast, cfg, 4, collect=["broadphase_rebuilt"])
    assert all(bool(m["broadphase_rebuilt"]) for m in ms)


def test_adapt_schedule_engages_on_settled(settled):
    """At the settled state warm_hit_frac >= the trigger, so the adaptive
    config must produce exactly the cheap schedule's output."""
    world, cfg = settled
    thr, it2, in2 = cfg.adapt_schedule
    w_ad, ms = _steps(world, cfg, 3, collect=["warm_hit_frac"])
    assert min(float(m["warm_hit_frac"]) for m in ms) >= thr
    cheap = cfg._replace(adapt_schedule=None, solver_iters=int(it2),
                         solver_inner=int(in2))
    w_ch, _ = _steps(world, cheap, 3)
    np.testing.assert_allclose(_pos(w_ad), _pos(w_ch), atol=1e-6)
    # and it must NOT equal the full schedule's output (the cond is real)
    full = cfg._replace(adapt_schedule=None)
    w_fu, _ = _steps(world, full, 3)
    assert np.abs(np.asarray(w_ad.bodies.v.x)
                  - np.asarray(w_fu.bodies.v.x)).max() > 0.0


def test_adapt_schedule_full_during_transient():
    """A fresh drop has no warm rows (hit fraction 0): the adaptive config
    must run the FULL schedule."""
    world, cfg = _scene()
    w_ad, ms = _steps(world, cfg, 6, collect=["warm_hit_frac"])
    thr = cfg.adapt_schedule[0]
    assert all(float(m["warm_hit_frac"]) < thr for m in ms)
    full = cfg._replace(adapt_schedule=None)
    w_fu, _ = _steps(world, full, 6)
    np.testing.assert_allclose(_pos(w_ad), _pos(w_fu), atol=1e-6)


def test_warm_match_pos_equals_search_when_set_stable():
    """Positional matching equals the full key search EXACTLY while the
    partner set (and therefore, under stable_pairs, the slot layout) is
    unchanged — a resting two-sphere stack whose candidate list cannot
    churn.  (At 100k-pile scale the distance-keyed top-k churns slot
    membership as bodies jiggle, so "pos" loses warm rows and is NOT
    equivalent — measured pen 0.3 vs 0.12 on the r4 sweep; "search" is
    the shipped mode and this test documents the boundary.)"""
    from mgf_tpu.physics import SceneBuilder
    from mgf_tpu.broadphase import GridConfig
    from mgf_tpu.world import WorldConfig, make_world
    b = SceneBuilder()
    b.add_sphere((0.0, 0.5, 0.0), 0.5, 1.0, 0.0, 0.6)
    b.add_sphere((0.0, 1.5, 0.0), 0.5, 1.0, 0.0, 0.6)
    verts = np.asarray([[-5, 0, -5], [-5, 0, 5], [5, 0, 5], [5, 0, -5]],
                       np.float32)
    faces = np.asarray([(0, 1, 3), (1, 2, 3)], np.int32)
    world = make_world(b.build(), verts, faces)
    base = WorldConfig(dt=1 / 60, solver_iters=4, solver_inner=2,
                       two_phase=False, shape_mode="spheres", solver="rows",
                       grid=GridConfig(cell_size=2.0, dim=8, bucket_cap=4),
                       max_pairs=4, fatten=0.02, warm_start=True,
                       stable_pairs=True, terrain_bp="dense")
    world = init_warm(world, base)
    w0, _ = _steps(world, base, 30)           # settle + build warm rows
    for mode in ("search", "pos"):
        w, ms = _steps(w0, base._replace(warm_match=mode), 5,
                       collect=["warm_hit_frac"])
        if mode == "search":
            ref, ref_hit = w, ms[-1]["warm_hit_frac"]
    np.testing.assert_allclose(_pos(w), _pos(ref), atol=1e-6)
    assert float(ms[-1]["warm_hit_frac"]) == float(ref_hit) == 1.0


def test_warm_match_hybrid_equals_search_across_cadence():
    """hybrid == search EXACTLY across a window that contains both
    branch activations of hybrid's ``lax.cond(bp_rebuilt, match_search,
    match_pos)`` (world.py) — rebuild steps take the search branch,
    reuse steps the pos branch (the wiring was only
    exercised implicitly).  On this stable stack the candidate layout
    cannot churn, so a swapped branch would shed warm rows and break the
    bit-equality / warm_hit==1 assertions below."""
    from mgf_tpu.physics import SceneBuilder
    from mgf_tpu.broadphase import GridConfig
    from mgf_tpu.world import WorldConfig, make_world
    b = SceneBuilder()
    b.add_sphere((0.0, 0.5, 0.0), 0.5, 1.0, 0.0, 0.6)
    b.add_sphere((0.0, 1.5, 0.0), 0.5, 1.0, 0.0, 0.6)
    b.add_sphere((1.1, 0.5, 0.0), 0.5, 1.0, 0.0, 0.6)
    verts = np.asarray([[-5, 0, -5], [-5, 0, 5], [5, 0, 5], [5, 0, -5]],
                       np.float32)
    faces = np.asarray([(0, 1, 3), (1, 2, 3)], np.int32)
    world = make_world(b.build(), verts, faces)
    base = WorldConfig(dt=1 / 60, solver_iters=4, solver_inner=2,
                       two_phase=False, shape_mode="spheres", solver="rows",
                       grid=GridConfig(cell_size=2.0, dim=8, bucket_cap=4),
                       max_pairs=4, fatten=0.02, warm_start=True,
                       stable_pairs=True, terrain_bp="dense", bp_every=2,
                       # the candidate cache only exists for the fat grid
                       # modes (world.py fat_modes)
                       broadphase="fat27x4")
    world = init_warm(world, base)
    world = init_bp_cache(world, base)
    w0, _ = _steps(world, base, 30)           # settle + build warm rows
    out = {}
    for mode in ("search", "hybrid"):
        w, ms = _steps(w0, base._replace(warm_match=mode), 8,
                       collect=["warm_hit_frac", "broadphase_rebuilt"])
        out[mode] = (w, ms)
    w_h, ms_h = out["hybrid"]
    w_s, ms_s = out["search"]
    # the window exercised BOTH cond branches
    rebuilt = [bool(m["broadphase_rebuilt"]) for m in ms_h]
    assert any(rebuilt) and not all(rebuilt), rebuilt
    np.testing.assert_array_equal(_pos(w_h), _pos(w_s))
    for mh, msr in zip(ms_h, ms_s):
        assert float(mh["warm_hit_frac"]) == float(
            msr["warm_hit_frac"]) == 1.0


def test_warm_gamma_semantics():
    """cfg.warm_gamma scales the matched warm transfer at match time:
    gamma=0 must be step-for-step identical to a zeroed warm cache (the
    pre-apply AND the accumulator seed vanish together), and gamma=1 is
    the default classic warm start (bit-identical to not setting it)."""
    from mgf_tpu.physics import SceneBuilder
    from mgf_tpu.broadphase import GridConfig
    from mgf_tpu.world import WorldConfig, _reset_warm, make_world
    b = SceneBuilder()
    b.add_sphere((0.0, 0.5, 0.0), 0.5, 1.0, 0.0, 0.6)
    b.add_sphere((0.0, 1.5, 0.0), 0.5, 1.0, 0.0, 0.6)
    verts = np.asarray([[-5, 0, -5], [-5, 0, 5], [5, 0, 5], [5, 0, -5]],
                       np.float32)
    faces = np.asarray([(0, 1, 3), (1, 2, 3)], np.int32)
    world = make_world(b.build(), verts, faces)
    base = WorldConfig(dt=1 / 60, solver_iters=4, solver_inner=2,
                       two_phase=False, shape_mode="spheres", solver="rows",
                       grid=GridConfig(cell_size=2.0, dim=8, bucket_cap=4),
                       max_pairs=4, fatten=0.02, warm_start=True,
                       stable_pairs=True, terrain_bp="dense")
    world = init_warm(world, base)
    w0, _ = _steps(world, base, 20)            # build nonzero accumulators
    assert float(np.abs(np.asarray(w0.warm.acc_n)).max()) > 0.0
    w_g0, _ = _steps(w0, base._replace(warm_gamma=0.0), 3)
    w_z, _ = _steps(_reset_warm(w0), base, 3)
    np.testing.assert_array_equal(_pos(w_g0), _pos(w_z))
    w_g1, _ = _steps(w0, base._replace(warm_gamma=1.0), 3)
    w_d, _ = _steps(w0, base, 3)
    np.testing.assert_array_equal(_pos(w_g1), _pos(w_d))


def test_chunk_step_matches_per_step(settled):
    """driver.make_chunk_step (lax.scan, C steps per dispatch) is the SAME
    physics as C separate step() calls — the scan body IS step; only host
    dispatch count changes.  Contact counts and the last step's max
    penetration are bit-equal; positions agree to 2 ulp: inside the scan
    the force is loop-invariant, and XLA's while-loop invariant code
    motion hoists its products out of the loop, which changes where it
    contracts a multiply-add into one rounding (with that pass disabled
    the positions are bit-equal too)."""
    from mgf_tpu.driver import make_chunk_step
    world, cfg = settled
    cfg1 = cfg._replace(adapt_schedule=None)
    C = 8
    g = make_chunk_step(cfg1, C)
    w_c, ms = g(world)
    w_s, lastm = world, None
    f = jax.jit(functools.partial(step, cfg=cfg1))
    per_step_contacts = []
    for _ in range(C):
        w_s, lastm = f(w_s)
        per_step_contacts.append(int(np.asarray(lastm["num_contacts"])))
    np.testing.assert_allclose(_pos(w_c), _pos(w_s), rtol=0,
                               atol=2 * np.spacing(np.float32(16.0)))
    np.testing.assert_array_equal(np.asarray(ms["num_contacts"]),
                                  np.asarray(per_step_contacts))
    assert float(np.asarray(ms["max_penetration"][-1])) == float(
        np.asarray(lastm["max_penetration"]))


def test_adaptive_chunk_stepper_schedules(settled):
    """AdaptiveChunkStepper engages the cheap schedule only after
    ``patience`` lagged reads at/above the threshold, and its hot chunks
    equal the explicit static cheap schedule."""
    from mgf_tpu.driver import AdaptiveChunkStepper, make_chunk_step
    world, cfg = settled
    assert cfg.adapt_schedule is not None
    thr, it2, in2 = cfg.adapt_schedule
    C = 4
    st = AdaptiveChunkStepper(cfg, chunk=C, patience=2)
    # settled pile: warm_hit_frac is high, so after 2 lagged reads
    # (pending > 2 drains) the hot schedule engages
    w = world
    hots = []
    for k in range(6):
        w, m = st.step_chunk(w)
        hots.append(st.hot_on)
    assert hots[0] is False                 # nothing read yet
    assert st.hot_on, hots                  # engaged by the end
    # the hot compile equals the explicit cheap static schedule
    cheap = make_chunk_step(cfg._replace(adapt_schedule=None,
                                         solver_iters=int(it2),
                                         solver_inner=int(in2)), C)
    w1, _ = st.hot(w)
    w2, _ = cheap(w)
    np.testing.assert_array_equal(_pos(w1), _pos(w2))
    # a cold read (fraction below threshold) disengages immediately
    st._pending.insert(0, jnp.float32(0.0))
    st._drain_one()
    assert st.hot_on is False
