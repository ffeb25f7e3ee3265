"""End-to-end world integration tests for all three shape modes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest


def _run(world, cfg, steps):
    from mgf_tpu.world import make_step_fn
    f = make_step_fn(cfg)
    m = None
    for _ in range(steps):
        world, m = f(world)
    jax.block_until_ready(world)
    return world, m


def test_balls_mini_settles():
    from mgf_tpu.scenes import balls_scene
    world, cfg = balls_scene(num=2, with_dropped=False)
    world, m = _run(world, cfg, 400)
    y = np.asarray(world.bodies.x.y)
    vy = np.asarray(world.bodies.v.y)
    # all spheres inside the box, resting near the floor (y = -10 + r -
    # resting penetration) or stacked above; none exploded or tunneled
    assert not np.isnan(y).any()
    assert y.min() > -10.0 and y.max() < 0.0
    assert np.abs(vy).max() < 1.0
    assert int(m["num_contacts"]) > 0
    assert int(m["broadphase_overflow"]) == 0


def test_capsules_mini_steps():
    from mgf_tpu.scenes import capsules_scene
    world, cfg = capsules_scene(num=2)
    # capsules start ~28 m above the floor: ~150 steps of free fall
    world, m = _run(world, cfg, 280)
    y = np.asarray(world.bodies.x.y)
    assert not np.isnan(y).any()
    assert y.min() > -10.0
    assert int(m["num_contacts"]) > 0
    assert int(m["broadphase_overflow"]) == 0


def test_mixed_mini_steps():
    from mgf_tpu.scenes import stress_scene
    world, cfg = stress_scene(64, mixed=True)
    world, m = _run(world, cfg, 120)
    y = np.asarray(world.bodies.x.y)
    assert not np.isnan(y).any()
    assert y.min() > 0.0  # resting on the floor at y=0
    assert int(m["num_contacts"]) > 0


def test_scene_builder_validation():
    from mgf_tpu.physics import SceneBuilder
    b = SceneBuilder()
    with pytest.raises(ValueError):
        b.add_sphere((0, 0, 0), -1.0, 1.0, 0.3, 0.6)
    with pytest.raises(ValueError):
        b.add_capsule((0, 0, 0), (0, 1, 0), 0.0, 1.0, 0.3, 0.6)
    with pytest.raises(ValueError):
        b.add_sphere((0, 0, 0), 1.0, 0.0, 0.3, 0.6)


def test_static_bodies_and_world_surgery():
    """Static colliders (RigidBodyRef::Static) + add/remove between steps."""
    import jax.numpy as jnp
    from mgf_tpu.physics import SceneBuilder
    from mgf_tpu.world import (WorldConfig, World, extend_world, make_step_fn,
                               make_world, remove_bodies)
    from mgf_tpu.broadphase import GridConfig

    b = SceneBuilder()
    b.add_static_spheres([[0.0, 0.0, 0.0]], 1.0, friction=0.5)
    b.add_sphere((0.0, 3.0, 0.0), 0.5, mass=1.0, restitution=0.0,
                 friction=0.5)
    world = make_world(b.build())
    cfg = WorldConfig(use_grid=False, max_pairs=4, solver_iters=10)
    step = make_step_fn(cfg)
    for _ in range(300):
        world, m = step(world)
    ys = np.asarray(world.bodies.x.y)
    # static anchor must not move; dynamic sphere rests on top (~1.5 - slop)
    assert ys[0] == 0.0
    assert 1.30 < ys[1] < 1.55

    # add a third body mid-simulation, drop it on the stack
    b2 = SceneBuilder()
    b2.add_sphere((0.0, 4.0, 0.0), 0.5, mass=1.0, restitution=0.0,
                  friction=0.5)
    world = extend_world(world, b2.build())
    assert world.bodies.n_bodies == 3
    step3 = make_step_fn(cfg)
    for _ in range(300):
        world, m = step3(world)
    ys = np.asarray(world.bodies.x.y)
    assert ys[2] > 2.0  # rests on the second sphere

    # remove the middle sphere; the top one drops onto the static anchor
    world = remove_bodies(world, [1])
    assert world.bodies.n_bodies == 2
    for _ in range(300):
        world, m = step(world)
    ys = np.asarray(world.bodies.x.y)
    assert ys[0] == 0.0 and 1.30 < ys[1] < 1.55


def test_capacity_world_no_recompile():
    """Pool semantics (pool.rs:37-113): spawn/kill below capacity are O(1)
    mask edits — the SAME compiled step keeps running."""
    import functools
    from mgf_tpu.physics import SceneBuilder
    from mgf_tpu.scenes import balls_scene
    from mgf_tpu.world import (kill_bodies, num_alive, spawn_bodies, step,
                               with_capacity)

    world, cfg = balls_scene(num=3, with_dropped=False)   # 27 bodies
    world = with_capacity(world, 40)
    assert num_alive(world) == 27
    f = jax.jit(functools.partial(step, cfg=cfg))
    w = world
    for _ in range(3):
        w, m = f(w)
    assert f._cache_size() == 1
    assert int(m["num_alive"]) == 27

    b = SceneBuilder()
    b.add_spheres(np.asarray([[0.0, 20.0, 0.0], [3.0, 20.0, 0.0]],
                             np.float32), 0.5, mass=1.0, restitution=0.3,
                  friction=0.6)
    w, idx = spawn_bodies(w, b.build())
    assert list(idx) == [27, 28]          # free-list reuse: first dead rows
    assert num_alive(w) == 29
    for _ in range(3):
        w, m = f(w)
    assert f._cache_size() == 1, "spawn_bodies must not recompile"
    assert int(m["num_alive"]) == 29
    # the spawned bodies actually simulate (gravity pulls them down)
    ys = np.asarray(w.bodies.x.y)[list(idx)]
    assert (ys < 20.0 - 1e-4).all()

    w = kill_bodies(w, idx)
    assert num_alive(w) == 27
    for _ in range(2):
        w, m = f(w)
    assert f._cache_size() == 1, "kill_bodies must not recompile"
    assert int(m["num_alive"]) == 27
    assert not np.isnan(np.asarray(w.bodies.x.y)).any()

    # slot REUSE: spawning again fills the killed rows (stable indices)
    w2, idx2 = spawn_bodies(w, b.build())
    assert list(idx2) == [27, 28]


def test_capacity_kill_matches_never_spawned():
    """Killing a body must leave survivors on the trajectory they would
    have had if the killed body had never been spawned (its dead row is
    bit-identical to a capacity pad row)."""
    import functools
    from mgf_tpu.physics import SceneBuilder
    from mgf_tpu.scenes import balls_scene
    from mgf_tpu.world import kill_bodies, step, with_capacity

    world, cfg = balls_scene(num=3, with_dropped=True)    # 28 bodies
    f = jax.jit(functools.partial(step, cfg=cfg))

    # A: capacity world, dropped ball killed after 2 steps
    wa = with_capacity(world, 32)
    for _ in range(2):
        wa, _ = f(wa)
    wa = kill_bodies(wa, [27])
    for _ in range(4):
        wa, _ = f(wa)

    # B: the dropped ball never existed (same capacity, same rows)
    wb, _ = balls_scene(num=3, with_dropped=False)
    wb = with_capacity(wb._replace(terrain=world.terrain,
                                   terrain_center=world.terrain_center), 32)
    wb = kill_bodies(wb, [])              # no-op; keeps tree structure
    for _ in range(6):
        wb, _ = f(wb)

    # the dropped ball is 120+ units above the grid: survivors never felt
    # it, so their trajectories must agree exactly
    np.testing.assert_allclose(np.asarray(wa.bodies.x.y)[:27],
                               np.asarray(wb.bodies.x.y)[:27], atol=1e-6)
