"""Spatially sharded (halo-exchange) step on the virtual 8-device CPU mesh.

Validates the scalable design (parallel/spatial.py): slab sharding +
fixed-capacity halo exchange must reproduce the single-device trajectory
for spheres AND mixed shapes, with comm that scales with the halo — not N.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest


def _cpu_mesh(n):
    devs = jax.devices("cpu")
    if len(devs) < n:
        pytest.skip(f"need {n} cpu devices")
    from jax.sharding import Mesh
    return Mesh(np.array(devs[:n]), ("b",))


def _run_pair(world, cfg, mesh, steps=5, halo=32):
    from mgf_tpu.parallel.spatial import (make_spatial_step,
                                          shard_world_spatial)
    from mgf_tpu.world import make_step_fn

    cpu = jax.devices("cpu")[0]
    w_single = jax.device_put(world, cpu)
    f_single = make_step_fn(cfg)
    for _ in range(steps):
        w_single, m_single = f_single(w_single)

    w_shard, bounds = shard_world_spatial(world, mesh)
    f_shard = make_spatial_step(cfg, mesh, bounds, halo=halo)
    for _ in range(steps):
        w_shard, m_shard = f_shard(w_shard)
    return w_single, m_single, w_shard, m_shard


def _sorted_y(world):
    """Trajectories compared order-independently (spatial sharding permutes
    bodies): sort the (x, y, z) triples lexicographically."""
    b = world.bodies
    arr = np.stack([np.asarray(b.x.x), np.asarray(b.x.y),
                    np.asarray(b.x.z)], axis=-1)
    order = np.lexsort((arr[:, 2], arr[:, 1], arr[:, 0]))
    return arr[order]


def test_spatial_spheres_matches_single_device():
    from mgf_tpu.scenes import balls_scene

    world, cfg = balls_scene(num=4, with_dropped=True)   # 65 bodies
    cfg = cfg._replace(two_phase=False)
    mesh = _cpu_mesh(8)
    ws, ms, wsh, msh = _run_pair(world, cfg, mesh, steps=5)
    pos_single = _sorted_y(ws)
    # drop pad rows (parked at x >= 1e5)
    arr = _sorted_y(wsh)
    arr = arr[arr[:, 0] < 9e4]
    np.testing.assert_allclose(arr, pos_single, atol=1e-4)
    assert int(msh["num_contacts"]) == int(ms["num_contacts"])
    assert int(msh["spatial_stray"]) == 0
    assert int(msh["halo_overflow"]) == 0


def test_spatial_mixed_matches_single_device():
    from mgf_tpu.scenes import terrain_scene

    world, cfg = terrain_scene(n_bodies=96, grid_n=16)
    cfg = cfg._replace(use_grid=True)
    mesh = _cpu_mesh(4)
    ws, ms, wsh, msh = _run_pair(world, cfg, mesh, steps=5, halo=48)
    arr = _sorted_y(wsh)
    arr = arr[arr[:, 0] < 9e4]
    np.testing.assert_allclose(arr, _sorted_y(ws), atol=1e-4)
    assert int(msh["num_contacts"]) == int(ms["num_contacts"])


def test_spatial_stress_config_matches_single_device():
    """The FLAGSHIP config semantics — warm start + stable pairs + fat8x4
    + "near" terrain cull + fused_iso count semantics — must run sharded
    and track the single-device trajectory."""
    from mgf_tpu.parallel.spatial import (make_spatial_step,
                                          shard_world_spatial)
    from mgf_tpu.scenes import stress_scene
    from mgf_tpu.world import make_step_fn

    world, cfg = stress_scene(n_bodies=300, layers=3)
    # the one-device reference runs the jnp solve (the fused kernel
    # compiles for the GPU only)
    cfg = cfg._replace(pallas_solver=False)
    assert cfg.warm_start and cfg.stable_pairs and cfg.fused_iso
    assert cfg.broadphase in ("fat8x4", "fat27x4")
    assert cfg.terrain_bp == "near"
    # drop the pile to just above the floor so contacts (and warm rows)
    # form within the first couple of steps
    import jax.numpy as jnp
    world = world._replace(bodies=world.bodies._replace(
        x=world.bodies.x._replace(y=world.bodies.x.y - 1.4)))
    mesh = _cpu_mesh(8)

    cpu = jax.devices("cpu")[0]
    ws = jax.device_put(world, cpu)
    fs = make_step_fn(cfg)
    for _ in range(8):
        ws, ms = fs(ws)

    wsh, bounds = shard_world_spatial(world, mesh, cfg=cfg)
    f = make_spatial_step(cfg, mesh, bounds, halo=48,
                          halo_width=cfg.grid.cell_size)
    if cfg.bp_every > 1:
        from mgf_tpu.parallel.spatial import init_spatial_bp_cache
        wsh = init_spatial_bp_cache(wsh, mesh, cfg, halo=48)
    for _ in range(8):
        wsh, msh = f(wsh)

    arr = _sorted_y(wsh)
    arr = arr[arr[:, 0] < 9e4]
    # iso-vs-Mat3 effective-mass rounding + row-order reduction
    # association differ between the paths; 8 warm-started steps stay
    # within ~1e-3
    np.testing.assert_allclose(arr, _sorted_y(ws), atol=5e-3)
    assert int(msh["spatial_stray"]) == 0
    assert int(msh["halo_overflow"]) == 0
    assert int(msh["broadphase_overflow"]) == 0
    # warm state must actually carry rows across frames
    assert int(np.sum(np.asarray(wsh.warm.partner) != -9)) > 0


def test_spatial_drift_stray_and_reshard():
    """Bodies sliding across slab boundaries: the stray metric must fire
    once they leave halo reach of their home slab, and a host re-shard
    must restore stray == 0 while trajectories keep matching the
    single-device run (the re-shard contract is exercised,
    not just documented)."""
    from mgf_tpu.parallel.spatial import (make_spatial_step,
                                          shard_world_spatial)
    from mgf_tpu.physics import SceneBuilder
    from mgf_tpu.scenes import _TERRAIN_FACES, _TERRAIN_VERTS
    from mgf_tpu.broadphase import GridConfig
    from mgf_tpu.world import WorldConfig, make_step_fn, make_world

    # 8 well-separated spheres resting on the floor, all sliding +x:
    # no pair contacts ever, so physics stays exact while they drift
    b = SceneBuilder()
    nb = 8
    xs = np.linspace(-7.0, 5.0, nb).astype(np.float32)
    pos = np.stack([xs, np.full(nb, -9.5, np.float32),
                    np.zeros(nb, np.float32)], axis=-1)
    b.add_spheres(pos, 0.5, mass=1.0, restitution=0.0, friction=0.0)
    world = make_world(b.build(), _TERRAIN_VERTS, _TERRAIN_FACES,
                       terrain_center=(0.0, -10.0, 0.0))
    import jax.numpy as jnp
    world = world._replace(bodies=world.bodies._replace(
        v=world.bodies.v._replace(x=jnp.full(nb, 6.0, jnp.float32))))
    cfg = WorldConfig(
        dt=1.0 / 60.0, solver_iters=10, two_phase=False,
        shape_mode="spheres", solver="rows",
        grid=GridConfig(cell_size=2.0, dim=32, bucket_cap=8),
        max_pairs=8, fatten=0.1)

    cpu = jax.devices("cpu")[0]
    ws = jax.device_put(world, cpu)
    fs = make_step_fn(cfg)

    mesh = _cpu_mesh(4)
    wsh, bounds = shard_world_spatial(world, mesh)
    f = make_spatial_step(cfg, mesh, bounds, halo=8, halo_width=0.5)

    strayed = False
    for i in range(24):
        ws, _ = fs(ws)
        wsh, msh = f(wsh)
        if int(msh["spatial_stray"]) > 0:
            strayed = True
            break
    assert strayed, "bodies crossed slabs but stray never fired"

    # host re-shard (the documented recovery), then continue
    wsh, bounds = shard_world_spatial(wsh, mesh)
    f = make_spatial_step(cfg, mesh, bounds, halo=8, halo_width=0.5)
    for _ in range(4):
        ws, _ = fs(ws)
        wsh, msh = f(wsh)
    assert int(msh["spatial_stray"]) == 0
    arr = _sorted_y(wsh)
    arr = arr[arr[:, 0] < 9e4]
    np.testing.assert_allclose(arr, _sorted_y(ws), atol=1e-4)


def test_spatial_cfg_field_coverage():
    """EVERY WorldConfig field must be either honored by the spatial step
    or flagged (raise/warn) in _check_cfg — the registry is exhaustive, so
    a new config field cannot silently diverge on the multi-chip path
    (_check_cfg violated its own never-silently-
    diverge policy for pallas_solver/adapt_schedule)."""
    import warnings
    from mgf_tpu.parallel import spatial
    from mgf_tpu.world import WorldConfig

    fields = set(WorldConfig._fields)
    covered = spatial.HONORED_FIELDS | spatial.FLAGGED_FIELDS
    assert fields == covered, (
        f"unregistered: {fields - covered}; stale: {covered - fields}")
    assert not (spatial.HONORED_FIELDS & spatial.FLAGGED_FIELDS)

    # every warn-flagged field, when activated, must actually warn (or
    # raise) — none may pass _check_cfg silently
    base = WorldConfig(solver="rows")
    active = {
        "profile_stage": "pairs",          # raises
        "solver": "parallel",              # raises
        "bp_margin": 0.5,
        "pallas_solver": True,
        "n_sphere_rows": 10,
        "use_grid": False,
    }
    for field, value in active.items():
        cfg = base._replace(**{field: value})
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            try:
                spatial._check_cfg(cfg)
                flagged = len(rec) > 0
            except ValueError:
                flagged = True
        assert flagged, f"{field}={value} passed _check_cfg silently"

    # honored fields must NOT warn: the flagship config (bp cadence +
    # hybrid warm matching + adaptive schedule) passes clean
    from mgf_tpu.scenes import stress_scene
    _, cfg = stress_scene(n_bodies=256, layers=3)
    cfg = cfg._replace(pallas_solver=False, n_sphere_rows=-1)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        spatial._check_cfg(cfg)
    assert not rec, [str(w.message) for w in rec]


def test_spatial_bp_cadence_matches_every_step_rebuild():
    """cfg.bp_every on the spatial path: the staleness-gated cache must
    reuse candidate lists across steps (some steps NOT rebuilt), keep
    drift excess at 0 (exactly conservative by construction), and track
    the rebuild-every-step spatial trajectory."""
    from mgf_tpu.parallel.spatial import (init_spatial_bp_cache,
                                          make_spatial_step,
                                          shard_world_spatial)
    from mgf_tpu.scenes import stress_scene

    world, cfg = stress_scene(n_bodies=256, layers=3)
    world = world._replace(bodies=world.bodies._replace(
        x=world.bodies.x._replace(y=world.bodies.x.y - 1.4)))
    cfg = cfg._replace(pallas_solver=False, n_sphere_rows=-1,
                       adapt_schedule=None)
    assert cfg.bp_every > 1 and cfg.stable_pairs
    mesh = _cpu_mesh(4)

    # rebuild-every-step reference run on the same mesh.  halo=64 covers
    # the whole 64-body shard: the cached build inflates the halo band by
    # each body's slack (~0.26 at this cell size), which at this tiny N
    # spans most of a slab — the halo capacity must cover the inflated
    # band or halo_overflow fires (it is counted against the fresh band).
    w1, b1 = shard_world_spatial(world, mesh, cfg=cfg)
    f1 = make_spatial_step(cfg._replace(bp_every=1, warm_match="search"),
                           mesh, b1, halo=64)
    for _ in range(8):
        w1, m1 = f1(w1)

    w2, b2 = shard_world_spatial(world, mesh, cfg=cfg)
    f2 = make_spatial_step(cfg, mesh, b2, halo=64)
    w2 = init_spatial_bp_cache(w2, mesh, cfg, halo=64)
    rebuilds, drift_excess = 0, 0.0
    for _ in range(8):
        w2, m2 = f2(w2)
        rebuilds += int(np.asarray(m2["broadphase_rebuilt"]))
        drift_excess = max(drift_excess, float(
            np.asarray(m2["broadphase_cache_drift_excess"])))
    assert rebuilds < 8, "cache never engaged (rebuilt every step)"
    assert rebuilds >= 1
    assert drift_excess == 0.0, drift_excess
    assert int(m2["spatial_stray"]) == 0
    assert int(m2["halo_overflow"]) == 0
    np.testing.assert_allclose(_sorted_y(w2), _sorted_y(w1), atol=5e-3)


def test_spatial_comm_scales_with_halo_not_n():
    from mgf_tpu.scenes import balls_scene
    from mgf_tpu.parallel.spatial import (make_spatial_step,
                                          shard_world_spatial)

    world, cfg = balls_scene(num=4, with_dropped=False)
    cfg = cfg._replace(two_phase=False)
    mesh = _cpu_mesh(8)
    w, bounds = shard_world_spatial(world, mesh)
    f = make_spatial_step(cfg, mesh, bounds, halo=4)
    w, m = f(w)
    per_dev = int(m["comm_floats_per_step"]) // 8
    # 2*H*16 shapes + 2*H counts + iters*2*H*8 state floats, H=4
    assert per_dev == 2 * 4 * 16 + 2 * 4 + cfg.solver_iters * 2 * 4 * 8
