"""Benchmark / demo scene builders reproducing the reference demos.

* :func:`balls_scene` — mgf_demo/balls.rs:64-96: an 11^3 grid of r=0.5
  spheres (the "1500-ball" demo actually simulates 11^3 = 1331 + 1 dropped
  from y=130), mass 1, restitution 0.3, friction 0.6, g = -9.8, dt = 1/60,
  20 solver iterations, on the demo's open-top box terrain
  (world.rs:118-150).
* :func:`capsules_scene` — mgf_demo/capsules.rs:66-95: 11^3 capsules
  (a=(-0.5,0,0), d=(1,0,0), r=1) on the same terrain.
* :func:`stress_scene` — the BASELINE.json 100k-body scaling config.
"""

from __future__ import annotations

import numpy as np

from mgf_tpu.broadphase import GridConfig
from mgf_tpu.physics import SceneBuilder
from mgf_tpu.world import World, WorldConfig, make_world


# demo terrain: open-top box, floor at y = -10, walls up to y = 0
# (world.rs:118-150: verts at y in {0, 10} shifted by set_pos to (0,-10,0))
_TERRAIN_VERTS = np.asarray([
    [-10.0, 0.0, -10.0],
    [-10.0, 0.0, 10.0],
    [10.0, 0.0, 10.0],
    [10.0, 0.0, -10.0],
    [-10.0, 10.0, -10.0],
    [-10.0, 10.0, 10.0],
    [10.0, 10.0, 10.0],
    [10.0, 10.0, -10.0],
], np.float32) + np.asarray([[0.0, -10.0, 0.0]], np.float32)

_TERRAIN_FACES = np.asarray([
    (0, 1, 3), (1, 2, 3),          # floor
    (0, 5, 1), (0, 4, 5),          # walls (world.rs:140-149)
    (0, 3, 7), (0, 7, 4),
    (2, 6, 3), (3, 6, 7),
    (1, 5, 2), (2, 5, 6),
], np.int32)


def _grid_positions(num, shift, y_base=10.0):
    """The demo's i/j/k grid (balls.rs:80-92)."""
    center = shift * num / 2.0
    pos = []
    for i in range(num):
        for j in range(num):
            for k in range(num):
                pos.append((i * shift - center,
                            y_base + j * shift + center * 2.0,
                            k * shift - center))
    return pos


def balls_scene(num: int = 11, with_dropped: bool = True,
                solver: str = "rows"):
    """The balls demo scene. Returns (World, WorldConfig)."""
    b = SceneBuilder()
    rad = 0.5
    b.add_spheres(np.asarray(_grid_positions(num, 2.5 * rad), np.float32),
                  rad, mass=1.0, restitution=0.3, friction=0.6)
    if with_dropped:
        b.add_sphere((0.0, 130.0, 0.0), rad, mass=1.0, restitution=0.3,
                     friction=0.6)
    world = make_world(b.build(), _TERRAIN_VERTS, _TERRAIN_FACES,
                       terrain_center=(0.0, -10.0, 0.0))
    # cell 2.0 >= the worst pair reach (settled ball 0.77 + the dropped
    # ball at terminal sweep ~1.15) — cell 1.6 left a 0.2 window-coverage
    # gap while the y=130 drop is in flight (broadphase_reach_excess)
    cfg = WorldConfig(
        dt=1.0 / 60.0, solver_iters=20, shape_mode="spheres", solver=solver,
        grid=GridConfig(cell_size=2.0, dim=64, bucket_cap=10),
        max_pairs=16, fatten=0.25, terrain_rows=4)
    return world, cfg


def capsules_scene(num: int = 11, solver: str = "rows"):
    """The capsules demo scene (capsules.rs:66-95).

    Faithful quirk: the reference grid spans x,z in [-27.5, 22.5]
    (shift 2.5 * rad with rad=2.0) while the demo box is only +-10, so
    MOST capsules miss the box and fall forever — exactly as in the
    reference demo (verified against capsules.rs:77-95); only the middle
    ~3x3 columns land and settle."""
    b = SceneBuilder()
    rad = 2.0
    pos = np.asarray(_grid_positions(num, 2.5 * rad), np.float32)
    # capsule centered at p: a = p + (-0.5, 0, 0), d = (1, 0, 0), r = 1
    b.add_capsules(pos + np.asarray([[-0.5, 0.0, 0.0]], np.float32),
                   np.asarray([[1.0, 0.0, 0.0]], np.float32), 1.0,
                   mass=1.0, restitution=0.3, friction=0.6)
    world = make_world(b.build(), _TERRAIN_VERTS, _TERRAIN_FACES,
                       terrain_center=(0.0, -10.0, 0.0))
    cfg = WorldConfig(
        dt=1.0 / 60.0, solver_iters=20, shape_mode="capsules", solver=solver,
        grid=GridConfig(cell_size=4.0, dim=64, bucket_cap=16),
        max_pairs=24, fatten=0.25, terrain_rows=6)
    return world, cfg


def terrain_scene(n_bodies: int = 10_000, grid_n: int = 72, seed: int = 2):
    """BASELINE config 3 as a real simulated world: mixed sphere/capsule
    bodies raining onto a ≥10k-triangle heightfield, with the grid-culled
    terrain narrowphase (mesh.rs:115-139 / BVH::query analog).

    Returns (World, WorldConfig).  grid_n=72 -> 72^2*2 = 10,368 faces.
    """
    rng = np.random.default_rng(seed)
    # heightfield: smooth sines, cell 2.0, amplitude 2
    cell = 2.0
    ext = grid_n * cell / 2.0
    xs = np.linspace(-ext, ext, grid_n + 1, dtype=np.float32)
    zs = np.linspace(-ext, ext, grid_n + 1, dtype=np.float32)
    X, Z = np.meshgrid(xs, zs, indexing="ij")
    Y = (2.0 * np.sin(X * 0.15) * np.cos(Z * 0.11)).astype(np.float32)
    verts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    idx = np.arange((grid_n + 1) * (grid_n + 1)).reshape(grid_n + 1,
                                                         grid_n + 1)
    a = idx[:-1, :-1].ravel()
    b = idx[:-1, 1:].ravel()
    c = idx[1:, :-1].ravel()
    d = idx[1:, 1:].ravel()
    faces = np.concatenate(
        [np.stack([a, b, c], axis=-1), np.stack([b, d, c], axis=-1)],
        axis=0).astype(np.int32)

    side = int(np.ceil(n_bodies ** (1.0 / 3.0)))
    ii = np.arange(side ** 3)[:n_bodies]
    i, j, k = ii // (side * side), (ii // side) % side, ii % side
    shift = 1.4
    pos = np.stack([
        (i - side / 2) * shift,
        8.0 + j * shift,
        (k - side / 2) * shift,
    ], axis=-1).astype(np.float32)
    pos += rng.uniform(-0.02, 0.02, pos.shape).astype(np.float32)

    bld = SceneBuilder()
    caps = np.arange(n_bodies) % 4 == 0
    bld.add_spheres(pos[~caps], 0.5, mass=1.0, restitution=0.3, friction=0.6)
    bld.add_capsules(pos[caps] - np.asarray([[0.25, 0.0, 0.0]]),
                     np.asarray([[0.5, 0.0, 0.0]]), 0.5,
                     mass=1.0, restitution=0.3, friction=0.6)

    # face cell >= max face radius (~cell*sqrt(2)/~1.4 + height slope)
    tg = GridConfig(cell_size=4.0, dim=64, bucket_cap=16)
    world = make_world(bld.build(), verts, faces, terrain_grid_cfg=tg)
    cfg = WorldConfig(
        dt=1.0 / 60.0, solver_iters=10, solver_inner=2, two_phase=False,
        shape_mode="mixed", solver="rows", broadphase="packed",
        grid=GridConfig(cell_size=1.6, dim=64, bucket_cap=8),
        max_pairs=12, fatten=0.1, terrain_bp="grid", terrain_cand=6,
        terrain_grid_cfg=tg, solver_rows=14,
        # spheres occupy the leading rows (added first): the partitioned
        # narrowphase runs the 4-stage triangle x capsule routine on the
        # capsule quarter only
        n_sphere_rows=int(np.sum(~caps)))
    return world, cfg


def stress_scene(n_bodies: int = 100_000, mixed: bool = False, seed: int = 0,
                 layers: int = 12, cap_frac: float = 0.25):
    """The 100k-body scaling stress config (BASELINE.json config 5).

    Bodies start as a ``layers``-deep block (default 12 — the demos' 11^3
    grid is 11 layers deep; this is that regime at 100k scale) over a large
    floor; uniform r=0.5 spheres (or a sphere/capsule mix with ``mixed``).
    A much deeper block (r1 used a 47-layer cube) collapses into
    unphysical interpenetration under any fixed-iteration impulse solver
    and makes the settled state meaningless.
    """
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n_bodies / layers)))
    idx = np.arange(side * side * layers)[:n_bodies]
    i, j, k = idx // (side * layers), (idx // layers) % side, idx % layers
    shift = 1.25
    pos = np.stack([
        (i - side / 2) * shift,
        2.0 + k * shift,
        (j - side / 2) * shift,
    ], axis=-1).astype(np.float32)
    pos += rng.uniform(-0.01, 0.01, pos.shape).astype(np.float32)

    b = SceneBuilder()
    if mixed:
        # every round(1/cap_frac)-th body is a capsule (default 25%);
        # cap_frac=1.0 gives a pure-capsule pile (diagnostic sweeps)
        if cap_frac >= 1.0:
            caps = np.ones(n_bodies, bool)
        else:
            caps = np.arange(n_bodies) % max(int(round(1.0 / cap_frac)),
                                             1) == 0
        b.add_spheres(pos[~caps], 0.5, mass=1.0, restitution=0.3,
                      friction=0.6)
        b.add_capsules(pos[caps] - np.asarray([[0.25, 0.0, 0.0]]),
                       np.asarray([[0.5, 0.0, 0.0]]), 0.5,
                       mass=1.0, restitution=0.3, friction=0.6)
    else:
        b.add_spheres(pos, 0.5, mass=1.0, restitution=0.3, friction=0.6)

    span = side * shift                  # initial pile footprint
    wall = float(span * 0.55 + 6.0)      # open-top box like the demo's
    wh = 40.0                            # wall height (world.rs:118-150)
    verts = np.asarray([
        [-wall, 0.0, -wall], [-wall, 0.0, wall], [wall, 0.0, wall],
        [wall, 0.0, -wall],
        [-wall, wh, -wall], [-wall, wh, wall], [wall, wh, wall],
        [wall, wh, -wall]], np.float32)
    faces = np.asarray([
        (0, 1, 3), (1, 2, 3),            # floor
        (0, 5, 1), (0, 4, 5),            # walls
        (0, 3, 7), (0, 7, 4),
        (2, 6, 3), (3, 6, 7),
        (1, 5, 2), (2, 5, 6)], np.int32)
    world = make_world(b.build(), verts, faces)
    # The values below were tuned by sweeps at 100k on the engine's first
    # accelerator; their speed on the H100 is not measured yet.  Quality
    # results (penetration, overflow, drift) carry over: they are
    # properties of the algorithm, not the device.
    if mixed:
        # "fat27x4": width-4 fat grid rows (coordinates inline, so the
        # cull needs NO per-candidate gather) + the FULL 27-cell window,
        # whose guarantee is the whole cell.  Cell 2.0 / cap 14: the
        # capsule-capsule pair reach (~1.54) leaves only ~0.03 of cadence
        # slack at cell 1.6, pinning bp_every at 2; cell 2.0 budgets
        # ~0.23/body so the staleness-gated cadence can engage
        # (bp_every=8).  The octant window ("fat8x4") is out: its
        # guarantee is cell/2 and capsule reach exceeds it at any usable
        # cell size.  Per-axis dims: the pile is FLAT — y gets 16 cells
        # (modulus 32); span_excess watches aliasing.
        grid = GridConfig(cell_size=2.0, dim=(128, 16, 128), bucket_cap=14)
        # NO row compaction (rows=0): the packed (R0, N, 20) top-k
        # intermediate of compaction costs more than solving the wider
        # rows.  K=9/cand=3 keep the uncompacted row count at 2*(9+3).
        bp, K, rows, cand = "fat27x4", 9, 0, 3
        n_sph = int(np.sum(~caps))
    else:
        # "fat27x4" at cell 1.6 / cap 12: the full-window guarantee
        # equals the WHOLE cell, so the per-body slack budget for the
        # rebuild cadence is 0.5*1.6 - r_eff ~ 0.26 and the staleness-
        # gated cache rebuilds every ~10 settled steps instead of every
        # ~2.  The grid modulus (dim * cell) must exceed the box span
        # (2 * wall) or occupied cells alias and buckets overflow
        dim = 32
        while dim * 1.6 < 2.0 * wall + 10.0:
            dim *= 2
        # per-axis dims: the pile is FLAT — y spans ~0..17 plus bounce
        # (16 cells = 25.6 modulus covers it; span_excess watches
        # aliasing) while x/z need `dim`.  cap 12: cap 10 showed a
        # transient overflow of 2 bodies at one settled rebuild (an
        # 11-occupant cell); 12 restores the overflow-0 guard margin.
        grid = GridConfig(cell_size=1.6, dim=(dim, 16, dim), bucket_cap=12)
        # R = K + terrain_cand = 12 solver rows, NO compaction (see the
        # mixed branch; dropped rows would go to 0)
        bp, K, rows, cand = "fat27x4", 9, 0, 3
    # warm_start (cross-frame impulse accumulators) holds the settled
    # 12-layer pile at max penetration ~0.17 where cold solves collapse
    # past 0.9 — see PERF.md.
    # mixed-mode note: with "ends" manifolds + the pierce-branch fix +
    # warm_gamma, the mixed pile truly settles (mean |v| 0.20,
    # freeze-stable); the remaining max penetration ~0.31-0.38 is the
    # rows solver's split-mass equilibrium on the deepest-loaded
    # bottom-layer rows — more sweeps do NOT reduce it (2x6/3x6/3x4/2x8
    # all land 0.31-0.34 at 10k), per-class p99 <= 0.18.
    # fused_iso + stable_pairs + positional warm matching eliminate the
    # separate constraint-precompute and warm-match gathers and cut
    # terrain rows from the per-sweep solver gather.
    cfg = WorldConfig(
        # schedule: 4 outer x 4 inner during transients; the ADAPTIVE
        # schedule drops to 2 outer x 6 inner once the warm-hit fraction
        # shows a persisted contact set (settled pile).  Settled 100k
        # max penetration 0.10-0.19 over a 600-step soak; the from-scratch
        # 10k collapse tracks the stock schedule (hit fraction stays below
        # threshold until the pile persists).  Plain static 3-outer
        # schedules DIVERGE on the collapse transient — block-Jacobi
        # partner terms refresh once per OUTER sweep and the collapse
        # needs >= 4 refreshes per step; the adaptive trigger is what
        # makes the cheap schedule safe.
        dt=1.0 / 60.0, solver_iters=4, solver_inner=4, two_phase=False,
        # settled schedule 2x6: max penetration 0.121 (2x8: 0.106, 2x4:
        # 0.146)
        adapt_schedule=(0.97, 2, 6),
        shape_mode="mixed" if mixed else "spheres",
        solver="rows", broadphase=bp, solver_rows=rows, warm_start=True,
        terrain_bp="near", terrain_cand=cand,
        grid=grid, max_pairs=K, fatten=0.02,
        stable_pairs=True,
        n_sphere_rows=n_sph if mixed else -1,
        # broadphase rebuild cadence: reuse the cached candidate list and
        # rebuild only on the cadence OR the moment any body's drift +
        # reach growth exceeds its build slack (exact staleness trigger)
        # — transients degrade to rebuild-every-step automatically.
        # Spheres: the 27-window slack budget sustains a long cadence —
        # the staleness trigger, not the modulus, schedules rebuilds
        # (every ~10 settled steps), so the forced-rebuild modulus only
        # ADDS rebuilds; drift_excess stays 0 by construction.  Mixed:
        # cell 2.0 budgets real capsule slack.
        bp_every=8 if mixed else 32,
        # hybrid warm matching: positional (elementwise) on cache-reuse
        # steps — the cached partner rows are bit-identical so pos
        # matching is exact for pair rows — and the full quadratic
        # search on rebuild steps
        warm_match="hybrid",
        # fused solver sweeps (spheres iso path only)
        pallas_solver=not mixed,
        # capsule flank stacks rock on the reference's single
        # interval-midpoint contact (pen ~0.54 at 100k mixed) — the
        # "ends" extension emits the overlap interval's two endpoints
        # into the two manifold slots (collision.py:413-514, documented
        # divergence), parity-gated against the f64 oracle's own ends
        # mode (test_oracle.py::test_capsule_ends_contact_stream_parity +
        # scripts/mixed_resync.py; PARITY.md "ends resync" row)
        cap_manifold="ends" if mixed else "mid",
        # full-gain warm pre-apply x sliding capsule contacts holds a
        # self-sustaining agitated state on mixed piles (mean |v| 1.39
        # where the f64 oracle and the engine's own cold-20 settle to
        # 0.17-0.23).  gamma=0.8 damps the loop: settled mean |v| 0.27,
        # contact count matches the cold run's fully-settled packing.
        # Spheres keep classic full warm starting (calm at gamma=1, and
        # the damping costs a fraction of warm convergence).
        warm_gamma=0.8 if mixed else 1.0,
        fused_iso=not mixed)
    from mgf_tpu.world import init_bp_cache, init_warm
    world = init_warm(world, cfg)
    if cfg.bp_every > 1:
        world = init_bp_cache(world, cfg)
    return world, cfg
