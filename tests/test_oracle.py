"""Contact-stream parity vs the f64 host oracle (PARITY.md; BASELINE north
star: per-contact agreement between the engine and reference semantics).

The oracle (mgf_tpu/oracle.py) reproduces the reference frame in f64 numpy
with the native sequential Gauss-Seidel inner loop; here the f32 jitted step
(sequential solver, mgf friction — the reference-exact path) runs the balls
scene through landing and every step's contact stream is diffed contact for
contact.
"""

import jax
import numpy as np
import pytest

from mgf_tpu.checks import ORACLE_BOUNDS, check_oracle_bounds, diff_streams


def test_balls_contact_stream_parity():
    """Per-step contact-stream parity on the PRODUCTION path.

    The oracle advances the trajectory in f64; each step its state is
    pushed into the f32 rows-solver step (grid broadphase) and the two
    contact streams are diffed contact for contact — so this also proves
    the grid broadphase finds every pair the reference's all-pairs logic
    finds.  The solver-schedule divergence (rows-Jacobi vs sequential GS)
    shows up as a per-step velocity delta, recorded and loosely bounded.
    """
    from mgf_tpu.checks import oracle_contact_parity

    worst, dvs, matmuls = oracle_contact_parity()
    # measured r3 (CI bounds ~2x measured): miss 0/1714, dt 4.0e-5,
    # dn 6e-8, dp 8.3e-7
    assert ORACLE_BOUNDS == {"miss": 0, "dt": 1e-4, "dn": 2e-7, "dp": 2e-6}
    check_oracle_bounds(worst)
    # the step does no matrix products (component algebra), so TF32
    # cannot enter it on a GPU
    assert matmuls == (0, 0), matmuls
    # dv measures the rows-Jacobi vs sequential-GS SCHEDULE divergence,
    # not an error: on quiet frames the one-step velocity outputs agree
    # to ~1e-6 (median gate), while on violent landing-cascade frames
    # (bodies impacting the pile at ~24 m/s) they diverge chaotically
    # (measured peak 41 on 10/90 frames) with identical contact streams;
    # the tight trajectory bound lives in test_sequential_trajectory_parity
    assert np.median(dvs) <= 1e-3, dvs
    assert int((dvs > 5.0).sum()) <= 15, dvs


def test_sequential_trajectory_parity():
    """Free-running f32 sequential-GS step vs the f64 oracle: the
    reference-exact solver path must track the oracle through landing."""
    import functools
    import jax
    from mgf_tpu import oracle
    from mgf_tpu.scenes import balls_scene
    from mgf_tpu.world import step

    world, cfg = balls_scene(num=3, with_dropped=True)   # 28 bodies
    cfg = cfg._replace(solver="sequential", friction_mode="mgf",
                       use_grid=False)
    f = jax.jit(functools.partial(step, cfg=cfg))
    ow = oracle.from_world(world)
    w = world
    worst_dx = 0.0
    for s in range(160):
        w, m = f(w)
        ow, _ = oracle.oracle_step(ow, dt=cfg.dt, iters=cfg.solver_iters,
                                   mgf_friction=True)
        worst_dx = max(worst_dx,
                       float(np.abs(np.asarray(w.bodies.x.y)
                                    - ow.x[:, 1]).max()))
    # measured r2: ~1.5e-4 at impact, ~6e-5 settled
    assert worst_dx <= 5e-3, worst_dx


def test_capsule_contact_stream_parity():
    """Per-step contact-stream parity for CAPSULES (the f64 oracle's
    capsule narrowphase vs the f32 engine, rows solver + box terrain).
    This resync caught a real engine bug in r2: sliver Minkowski quads
    fabricated t=0 contacts on walls 9 units away (see collision.py
    _near_axis)."""
    import functools
    from mgf_tpu import oracle
    from mgf_tpu.physics import SceneBuilder
    from mgf_tpu.scenes import _TERRAIN_FACES, _TERRAIN_VERTS
    from mgf_tpu.world import WorldConfig, make_world, step

    b = SceneBuilder()
    rng = np.random.default_rng(4)
    for i in range(8):
        p = rng.uniform(-4, 4, 3)
        p[1] = -6.0 - i * 0.4
        b.add_capsule(tuple(p - [0.5, 0, 0]), (1.0, 0.0, 0.0), 1.0,
                      1.0, 0.3, 0.6)
    world = make_world(b.build(), _TERRAIN_VERTS, _TERRAIN_FACES,
                       terrain_center=(0.0, -10.0, 0.0))
    cfg = WorldConfig(shape_mode="capsules", solver="rows",
                      use_grid=False, solver_iters=20)
    f = jax.jit(functools.partial(step, cfg=cfg, collect_contacts=True))
    ow = oracle.from_world(world)
    worst = dict(dt=0.0, dn=0.0, dp=0.0, miss=0, total=0)
    for s in range(80):
        w_in = oracle.to_world(ow, world)
        w, m = f(w_in)
        ow, rec = oracle.oracle_step(ow, dt=cfg.dt, iters=20)
        worst = diff_streams(m, rec, worst)
    # measured r3 after the relative-tolerance parallel classification in
    # closest_pts_seg (CI bounds ~2x measured): miss 1/581, dt 4.4e-3
    # (capsule TOI quadratics are touchier than spheres), dn 8.7e-7,
    # dp 1.6e-5 (was 0.26 with the exact denom==0 test — precision picked
    # the branch and the witness slid along the axis).  The single
    # residual miss is DIAGNOSED IRREDUCIBLE resync flicker, not a code
    # divergence: at step 33 the pair's true f64 separation is 2.000276
    # vs r_sum 2.0 (276 um graze) and the engine and oracle agree
    # exactly on identical inputs (both reject); the miss appears only
    # because the independently f32-integrated engine state sits on the
    # other side of the physical contact boundary than the f64 state.
    assert worst["miss"] <= 2, worst
    assert worst["dt"] <= 8e-3, worst
    assert worst["dn"] <= 2e-6, worst
    assert worst["dp"] <= 1e-4, worst


def test_capsule_ends_contact_stream_parity():
    """Contact-stream parity for the SHIPPED mixed semantics: the
    cap_manifold="ends" two-endpoint flank extension (the flagship mixed
    config, scenes.py stress_scene) vs the f64 oracle's ends mode (the
    extension previously had only unit goldens; its contact stream had
    never been diffed against f64).
    Parallel capsule columns force the flank-interval path every step."""
    import functools
    from mgf_tpu import oracle
    from mgf_tpu.physics import SceneBuilder
    from mgf_tpu.scenes import _TERRAIN_FACES, _TERRAIN_VERTS
    from mgf_tpu.world import WorldConfig, make_world, step

    b = SceneBuilder()
    rng = np.random.default_rng(9)
    # two stacks of axis-aligned (parallel) capsules + two tilted ones:
    # flank intervals dominate, end/sphere reductions still exercised
    for i in range(6):
        p = np.asarray([(-2.0 if i % 2 else 2.0) + rng.uniform(-0.1, 0.1),
                        -7.5 - (i // 2) * 0.8, rng.uniform(-0.3, 0.3)])
        b.add_capsule(tuple(p - [0.7, 0, 0]), (1.4, 0.0, 0.0), 0.5,
                      1.0, 0.3, 0.6)
    for i in range(2):
        p = rng.uniform(-2, 2, 3)
        p[1] = -5.0 - i * 0.5
        b.add_capsule(tuple(p - [0.5, 0.1 * i, 0]), (1.0, 0.2 * i, 0.0),
                      0.5, 1.0, 0.3, 0.6)
    world = make_world(b.build(), _TERRAIN_VERTS, _TERRAIN_FACES,
                       terrain_center=(0.0, -10.0, 0.0))
    cfg = WorldConfig(shape_mode="capsules", solver="rows",
                      use_grid=False, solver_iters=20,
                      cap_manifold="ends")
    f = jax.jit(functools.partial(step, cfg=cfg, collect_contacts=True))
    ow = oracle.from_world(world)
    worst = dict(dt=0.0, dn=0.0, dp=0.0, miss=0, total=0)
    slot1_seen = 0
    for s in range(100):
        w_in = oracle.to_world(ow, world)
        w, m = f(w_in)
        ow, rec = oracle.oracle_step(ow, dt=cfg.dt, iters=20,
                                     cap_manifold="ends")
        slot1_seen += int(np.sum((np.asarray(rec["kind"]) == 1)
                                 & (np.asarray(rec["slot"]) == 1)))
        worst = diff_streams(m, rec, worst)
    # the extension must actually fire (parallel flank stacks; measured 43)
    assert slot1_seen > 20, slot1_seen
    assert worst["total"] > 300, worst
    # same gate class as the capsule resync above; a small miss allowance
    # covers pruner-merge boundary flicker (the engine merges a slot-1
    # endpoint within 1e-2 of slot 0; the oracle emulates the merge but
    # f32/f64 sit on opposite sides at the threshold) and resync grazes
    assert worst["miss"] <= max(4, worst["total"] // 100), worst
    assert worst["dt"] <= 8e-3, worst
    # dn: flank normals of NEAR-parallel capsules are perpendicular
    # residues of almost-equal axis directions — the f32 error scales as
    # eps/sin(theta) (the closest_pts_seg conditioning documented in
    # PARITY.md), so the gate is wider than the well-conditioned capsule
    # resync's 2e-6.  Measured worst on this scene: 1.28e-5 (CPU f32).
    assert worst["dn"] <= 4e-5, worst
    assert worst["dp"] <= 1e-3, worst


def test_oracle_native_vs_python_solver():
    """The native C++ GS loop and the python fallback must agree exactly."""
    from mgf_tpu import native
    if not native.native_available():
        pytest.skip("no native toolchain")
    rng = np.random.default_rng(3)
    M, C = 8, 12
    v = rng.normal(size=(M, 3))
    omega = rng.normal(size=(M, 3)) * 0.1
    inv_mass = np.abs(rng.normal(size=M)) + 0.1
    inv_moment = np.broadcast_to(np.eye(3) * 0.4, (M, 3, 3)).copy()
    ia = rng.integers(0, M, C).astype(np.int32)
    ib = ((ia + 1 + rng.integers(0, M - 1, C)) % M).astype(np.int32)
    n = rng.normal(size=(C, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    t1 = np.cross(n, [0.0, 1.0, 0.001])
    t1 /= np.linalg.norm(t1, axis=-1, keepdims=True)
    t2 = np.cross(n, t1)
    args = dict(ra=rng.normal(size=(C, 3)) * 0.3,
                rb=rng.normal(size=(C, 3)) * 0.3,
                normal=n, t1=t1, t2=t2,
                friction=np.abs(rng.normal(size=C)) * 0.5,
                bias=rng.normal(size=C) * 0.1,
                normal_mass=np.abs(rng.normal(size=C)) + 0.2,
                tm1=np.abs(rng.normal(size=C)) + 0.2,
                tm2=np.abs(rng.normal(size=C)) + 0.2)
    for mgf in (True, False):
        vn, on = native.solve_contacts_f64(
            v.copy(), omega.copy(), inv_mass, inv_moment, ia, ib,
            iters=10, mgf_friction=mgf, **args)
        saved = native._lib
        native._lib = False
        try:
            vp, op_ = native.solve_contacts_f64(
                v.copy(), omega.copy(), inv_mass, inv_moment, ia, ib,
                iters=10, mgf_friction=mgf, **args)
        finally:
            native._lib = saved
        np.testing.assert_allclose(vn, vp, rtol=0, atol=1e-12)
        np.testing.assert_allclose(on, op_, rtol=0, atol=1e-12)
