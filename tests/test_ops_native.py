"""Native (C++) host runtime tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest


def test_native_morton_and_weld():
    from mgf_tpu.native import morton_order, weld_vertices
    rng = np.random.default_rng(0)
    pos = rng.uniform(-10, 10, (500, 3)).astype(np.float32)
    order = morton_order(pos)
    assert sorted(order.tolist()) == list(range(500))
    # morton neighbors should be spatially close on average vs random order
    d_m = np.linalg.norm(np.diff(pos[order], axis=0), axis=1).mean()
    d_r = np.linalg.norm(np.diff(pos, axis=0), axis=1).mean()
    assert d_m < d_r

    verts = rng.uniform(-1, 1, (100, 3)).astype(np.float32)
    doubled = np.vstack([verts, verts + 1e-9])
    welded, remap = weld_vertices(doubled, tol=1e-6)
    assert welded.shape[0] == 100
    assert remap.shape[0] == 200
    # the weld must be a faithful relabeling: welded[remap] == verts
    np.testing.assert_allclose(welded[remap], doubled, atol=1e-6)


def test_weld_roundtrip_both_paths():
    """Regression: the numpy fallback emitted verts in first-occurrence order
    while remap indexed key-sorted order, scrambling geometry.  Assert the
    welded[remap] round-trip on the native AND numpy paths with an input
    whose first-occurrence and key orders differ."""
    import mgf_tpu.native as native

    verts = np.asarray([[1, 1, 1], [0, 0, 0], [1, 1, 1], [-2, 5, 0]],
                       np.float32)
    for force_numpy in (False, True):
        if force_numpy:
            saved = native._lib
            native._lib = False
        try:
            welded, remap = native.weld_vertices(verts, tol=1e-6)
        finally:
            if force_numpy:
                native._lib = saved
        assert welded.shape[0] == 3
        np.testing.assert_allclose(welded[remap], verts, atol=1e-6)


def test_native_cell_table_and_tree():
    from mgf_tpu.native import AabbTree, build_cell_table
    verts = np.asarray([[-10, 0, -10], [-10, 0, 10], [10, 0, 10],
                        [10, 0, -10], [0, 5, 0]], np.float32)
    faces = np.asarray([[0, 1, 3], [1, 2, 3], [0, 1, 4]], np.int32)
    table, overflow = build_cell_table(verts, faces, 8.0, 16, 4)
    assert overflow == 0
    assert (table >= 0).sum() == 3

    tree = AabbTree(verts, faces)
    hits = sorted(tree.query([0, 0, 0], [1, 1, 1]).tolist())
    # floor faces + the big slanted face's AABB all overlap the origin box
    assert hits == [0, 1, 2]
    hits = sorted(tree.query([0, 4, 0], [2, 2, 2]).tolist())
    assert hits == [2]


def test_queries():
    from helpers import V, F
    from mgf_tpu.geom import AABB
    from mgf_tpu.physics import SceneBuilder
    from mgf_tpu.queries import query_aabb, raytrace_bodies, raytrace_mesh
    from mgf_tpu.mesh import mesh_from_arrays

    b = SceneBuilder()
    b.add_sphere((0, 0, 0), 1.0, 1.0, 0.0, 0.5, gravity=(0, 0, 0))
    b.add_sphere((5, 0, 0), 1.0, 1.0, 0.0, 0.5, gravity=(0, 0, 0))
    b.add_capsule((10, -1, 0), (0, 2, 0), 0.5, 1.0, 0.0, 0.5,
                  gravity=(0, 0, 0))
    state = b.build()

    mask = query_aabb(state, AABB(c=V(0, 0, 0), r=V(2, 2, 2)))
    assert mask.tolist() == [True, False, False]

    inter, idx = raytrace_bodies(state, V(-5, 0, 0), V(1, 0, 0))
    assert bool(inter.hit) and int(idx) == 0
    assert float(inter.t) == pytest.approx(4.0, abs=1e-4)
    inter, idx = raytrace_bodies(state, V(20, 0, 0), V(-1, 0, 0))
    assert bool(inter.hit) and int(idx) == 2
    assert float(inter.t) == pytest.approx(9.5, abs=1e-4)

    m = mesh_from_arrays([(-1, 0, -1), (-1, 0, 1), (1, 0, 1), (1, 0, -1)],
                         [(0, 1, 3), (1, 2, 3)])
    inter, face = raytrace_mesh(m, V(0.5, 3.0, 0.5), V(0, -1, 0))
    assert bool(inter.hit)
    assert float(inter.t) == pytest.approx(3.0, abs=1e-5)


def test_raytrace_mesh_grid_matches_dense():
    """3-D DDA grid raytrace (BVH::raytrace equivalent for large meshes)
    vs the dense scan, random downward rays over a heightfield."""
    from mgf_tpu.math3d import Vec3
    from mgf_tpu.mesh import build_mesh_grid, mesh_from_arrays
    from mgf_tpu.queries import raytrace_mesh, raytrace_mesh_grid
    from mgf_tpu.scenes import terrain_scene

    w, _ = terrain_scene(n_bodies=10, grid_n=24)    # 1152 faces
    verts = np.concatenate(
        [np.stack([np.asarray(getattr(w.terrain, s).x),
                   np.asarray(getattr(w.terrain, s).y),
                   np.asarray(getattr(w.terrain, s).z)], -1)
         for s in "abc"])
    faces = np.arange(verts.shape[0]).reshape(3, -1).T
    m = mesh_from_arrays(verts, faces)
    grid = build_mesh_grid(m, cell_size=4.0, dim=16, cap=16)
    assert int(grid.overflow) == 0

    rng = np.random.default_rng(5)
    v3 = lambda a: Vec3(*(jnp.float32(x) for x in a))
    fd = jax.jit(lambda p, d: raytrace_mesh(m, p, d))
    fg = jax.jit(lambda p, d: raytrace_mesh_grid(m, grid, p, d))
    for i in range(12):
        p = v3([rng.uniform(-20, 20), 25.0, rng.uniform(-20, 20)])
        dv = np.asarray([rng.uniform(-0.4, 0.4), -1.0,
                         rng.uniform(-0.4, 0.4)])
        dv /= np.linalg.norm(dv)
        i1, f1 = fd(p, v3(dv.tolist()))
        i2, f2 = fg(p, v3(dv.tolist()))
        assert bool(i1.hit) == bool(i2.hit)
        if bool(i1.hit):
            assert abs(float(i1.t) - float(i2.t)) < 1e-4


def test_raytrace_mesh_grid_dealigned():
    """Regression: a mesh whose vertices are NOT multiples of
    the grid cell size has faces straddling cell boundaries; the old
    centroid-only binning made those invisible to rays entering from the
    neighboring cell.  AABB binning must keep the DDA exact."""
    from mgf_tpu.math3d import Vec3
    from mgf_tpu.mesh import build_mesh_grid, mesh_from_arrays
    from mgf_tpu.queries import raytrace_mesh, raytrace_mesh_grid
    from mgf_tpu.scenes import terrain_scene

    w, _ = terrain_scene(n_bodies=10, grid_n=24)
    verts = np.concatenate(
        [np.stack([np.asarray(getattr(w.terrain, s).x),
                   np.asarray(getattr(w.terrain, s).y),
                   np.asarray(getattr(w.terrain, s).z)], -1)
         for s in "abc"])
    verts = verts + np.asarray([[2.0, 1.3, 2.0]], np.float32)  # de-align
    faces = np.arange(verts.shape[0]).reshape(3, -1).T
    m = mesh_from_arrays(verts, faces)
    grid = build_mesh_grid(m, cell_size=4.0, dim=16, cap=24)
    assert int(grid.overflow) == 0

    rng = np.random.default_rng(7)
    v3 = lambda a: Vec3(*(jnp.float32(x) for x in a))
    fd = jax.jit(lambda p, d: raytrace_mesh(m, p, d))
    fg = jax.jit(lambda p, d: raytrace_mesh_grid(m, grid, p, d))
    hits = 0
    for i in range(16):
        # vertical boundary probes: x/z at exact cell-boundary multiples
        # plus jitter, the case that missed with centroid binning
        p = v3([rng.integers(-4, 5) * 4.0 + rng.uniform(-0.05, 0.05),
                25.0,
                rng.integers(-4, 5) * 4.0 + rng.uniform(-0.05, 0.05)])
        dv = np.asarray([rng.uniform(-0.3, 0.3), -1.0,
                         rng.uniform(-0.3, 0.3)])
        dv /= np.linalg.norm(dv)
        i1, f1 = fd(p, v3(dv.tolist()))
        i2, f2 = fg(p, v3(dv.tolist()))
        assert bool(i1.hit) == bool(i2.hit)
        if bool(i1.hit):
            hits += 1
            assert abs(float(i1.t) - float(i2.t)) < 1e-4
    assert hits >= 8  # the probe set must actually exercise hits


def test_raytrace_bodies_grid_matches_dense():
    """Grid-accelerated body raytrace (BVH::raytrace, bvh.rs:345-369) vs
    the dense O(N) scan, mixed sphere/capsule cloud, random rays."""
    from mgf_tpu.math3d import Vec3
    from mgf_tpu.physics import SceneBuilder
    from mgf_tpu.queries import (
        build_body_grid, raytrace_bodies, raytrace_bodies_grid)

    rng = np.random.default_rng(11)
    b = SceneBuilder()
    for i in range(120):
        c = rng.uniform(-18, 18, 3)
        if i % 3 == 0:
            d = rng.standard_normal(3)
            d = d / np.linalg.norm(d) * 0.8
            b.add_capsule(tuple(c - d), tuple(2 * d), 0.35, 1.0, 0.0, 0.5,
                          gravity=(0, 0, 0))
        else:
            b.add_sphere(tuple(c), 0.6, 1.0, 0.0, 0.5, gravity=(0, 0, 0))
    state = b.build()

    grid = build_body_grid(state, cell_size=2.5, dim=32, cap=16)
    assert int(grid.overflow) == 0
    v3 = lambda a: Vec3(*(jnp.float32(x) for x in a))
    fd = jax.jit(lambda p, d: raytrace_bodies(state, p, d))
    fg = jax.jit(lambda p, d: raytrace_bodies_grid(grid, p, d))
    xs = np.stack([np.asarray(state.x.x), np.asarray(state.x.y),
                   np.asarray(state.x.z)], -1)
    hits = 0
    for i in range(20):
        p = rng.uniform(-25, 25, 3)
        # aim at a random body (slightly off-center) so most rays hit
        tgt = xs[rng.integers(0, len(xs))] + rng.uniform(-0.3, 0.3, 3)
        dv = tgt - p
        dv /= np.linalg.norm(dv)
        i1, b1 = fd(v3(p.tolist()), v3(dv.tolist()))
        i2, b2 = fg(v3(p.tolist()), v3(dv.tolist()))
        assert bool(i1.hit) == bool(i2.hit), f"ray {i}"
        if bool(i1.hit):
            hits += 1
            assert abs(float(i1.t) - float(i2.t)) < 1e-4
            assert int(b1) == int(b2)
    assert hits >= 10
