"""The sharded physics step: bodies distributed over a 1-D device mesh.

Decomposition (per step):

* ``complete_motion`` / ``integrate`` — embarrassingly parallel over the
  body shard; no communication.
* broadphase — swept-bound centers are all-gathered (N x 8 floats packed),
  every device builds the same cell table and generates candidates only for
  its own rows.
* narrowphase / manifolds / constraint rows — device-local over the shard's
  candidate rows; partner shape data is read from the all-gathered packed
  shape table (one wide gather per side).
* solver — the scatter-free row solver: each device updates its own rows'
  velocities and the packed (8, N) body state is re-all-gathered each
  solver phase (3.2 MB at N = 100k).  No psum, no scatter.

Communication per step: 2 all-gathers of (N, 8)-ish tables +
``solver_iters`` all-gathers of the (8, N) state.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mgf_tpu import broadphase
from mgf_tpu.collision import LocalContact
from mgf_tpu.manifold import Manifold, prune
from mgf_tpu.math3d import Vec3, cross, dot, mat_vec
from mgf_tpu.physics import RigidBodyState, complete_motion, integrate
from mgf_tpu.solver import (
    BodyView, _friction_impulses, _normal_impulse, build_row_constraints,
    pack_body_state, unpack_body_state,
)
from mgf_tpu.world import (
    ShapeView, World, WorldConfig, _body_bounds, _pair_contact,
    _terrain_contact, gather_shapes, manifold_prox_sq, pack_shapes,
)


def pad_bodies(state: RigidBodyState, multiple: int) -> RigidBodyState:
    """Pad the body SoA to a row count divisible by ``multiple`` with inert
    static bodies (inv_mass 0, zero force) parked far from the scene.
    Lifts the N-divisible-by-mesh restriction of shard_map.

    Pads carry ``shape_r = -1`` — the universal "not a real body" marker:
    the grid builders (``build_grid``/``build_fat_grid`` ``valid`` arg)
    skip such rows entirely, so a pad can never alias through the grid
    modulus into an in-scene bucket and evict a real body."""
    n = state.n_bodies
    pad = (-n) % multiple
    if pad == 0:
        return state
    state = jax.tree_util.tree_map(
        lambda g: jnp.concatenate(
            [g, jnp.zeros((pad,) + g.shape[1:], g.dtype)], axis=0), state)
    far = 1.0e5 + 100.0 * jnp.arange(pad, dtype=jnp.float32)
    big = jnp.full((pad,), 1.0e5, jnp.float32)
    fix = lambda g, tail: jnp.concatenate([g[:n], tail], axis=0)
    return state._replace(
        x=Vec3(fix(state.x.x, far), fix(state.x.y, big),
               fix(state.x.z, big)),
        q=state.q._replace(w=fix(state.q.w, jnp.ones((pad,), jnp.float32))),
        shape_r=fix(state.shape_r, jnp.full((pad,), -1.0, jnp.float32)),
    )


def shard_world(world: World, mesh: Mesh, axis: str = "b") -> World:
    """Place body arrays row-sharded on the mesh; terrain replicated.
    Bodies are padded with inert statics up to a mesh-size multiple."""
    body_sharding = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())
    padded = pad_bodies(world.bodies, int(mesh.devices.size))
    bodies = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, body_sharding), padded)
    terrain = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, repl), world.terrain)
    center = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, repl), world.terrain_center)
    return World(bodies=bodies, terrain=terrain, terrain_center=center)


def make_sharded_step(cfg: WorldConfig, mesh: Mesh, axis: str = "b"):
    """Build a jitted sharded step (replicated all-gather fallback; prefer
    :mod:`mgf_tpu.parallel.spatial` for scale).  Bodies are padded to a
    mesh-size multiple.  Always uses the scatter-free row solver in its
    single-phase form; config options this path does not honor are
    rejected loudly rather than silently diverging."""
    import warnings
    if cfg.two_phase:
        warnings.warn(
            "sharded step solves friction+normal from one relative "
            "velocity (single-phase); cfg.two_phase=True is not honored — "
            "set two_phase=False or use parallel.spatial", stacklevel=2)
    if cfg.terrain_rows:
        warnings.warn(
            "sharded step does not compact terrain rows; cfg.terrain_rows "
            "is ignored — use parallel.spatial", stacklevel=2)
    if cfg.bp_every > 1:
        warnings.warn(
            "sharded step rebuilds its broadphase every step; "
            "cfg.bp_every (rebuild cadence) is ignored", stacklevel=2)

    def _local_step(bodies: RigidBodyState, terrain, terrain_center):
        state = complete_motion(bodies)
        state = integrate(state, cfg.dt)
        n_loc = state.inv_mass.shape[0]
        dev = jax.lax.axis_index(axis)
        row0 = dev * n_loc
        rows_g = row0 + jnp.arange(n_loc, dtype=jnp.int32)
        n_tris = terrain.a.x.shape[0]

        # ---- global shape view (all-gather the narrowphase slice) ----
        local_view = ShapeView(x=state.x, q=state.q, delta=state.delta,
                               shape_type=state.shape_type,
                               shape_r=state.shape_r,
                               shape_half_h=state.shape_half_h)
        ag = lambda t: jax.tree_util.tree_map(
            lambda x: jax.lax.all_gather(x, axis, tiled=True), t)
        gview = ag(local_view)
        n_glob = gview.shape_r.shape[0]
        ps = pack_shapes(gview)

        # ---- broadphase: replicated table, local candidate rows ----
        bounds_g = broadphase.swept_fat_bounds(
            _body_bounds(cfg, gview), gview.delta, cfg.fatten)
        grid = broadphase.build_fat_grid(bounds_g, cfg.grid,
                                         valid=gview.shape_r > 0.0)
        local_centers = jax.tree_util.tree_map(
            lambda x: jax.lax.dynamic_slice_in_dim(x, row0, n_loc),
            bounds_g.c)
        partner, pair_ok = broadphase.fat_grid_pairs(
            bounds_g, grid, cfg.grid, cfg.max_pairs, self_rows=rows_g,
            ordered=False, query_centers=local_centers,
            window="sel8" if cfg.broadphase == "fat8" else "27")

        # ---- narrowphase over local candidate rows ----
        prow = jnp.broadcast_to(rows_g[:, None], partner.shape).reshape(-1)
        pcol = jnp.where(pair_ok, partner, 0).reshape(-1)
        pair_valid = pair_ok.reshape(-1)
        ga = gather_shapes(cfg, ps, prow)
        gb = gather_shapes(cfg, ps, pcol)
        pc = _pair_contact(cfg, ga, gb)
        pc = pc._replace(valid=pc.valid & pair_valid[None, :])
        lc = LocalContact(
            local_a=pc.a - (ga.x + ga.delta * pc.t),
            local_b=pc.b - (gb.x + gb.delta * pc.t),
            contact=pc)
        n_slots = 1 if cfg.shape_mode == "spheres" else 2
        pair_manifold = prune(lc, max_contacts=n_slots,
                              prox_sq=manifold_prox_sq(cfg))
        K = partner.shape[1]

        def _deepest(c):
            pen = dot(c.b - c.a, c.n)
            return jnp.max(jnp.where(c.valid, jnp.maximum(-pen, 0.0), 0.0))

        max_pen = _deepest(pc)

        def man_to_rows(man, width):
            S = man.valid.shape[0]
            slotf = lambda x: (x.reshape(S, n_loc, width).swapaxes(1, 2)
                               .reshape(S * width, n_loc))
            pairf = lambda x: jnp.broadcast_to(
                x.reshape(n_loc, width).T[None],
                (S, width, n_loc)).reshape(-1, n_loc)
            return Manifold(
                time=pairf(man.time),
                normal=jax.tree_util.tree_map(pairf, man.normal),
                t1=jax.tree_util.tree_map(pairf, man.t1),
                t2=jax.tree_util.tree_map(pairf, man.t2),
                local_a=jax.tree_util.tree_map(slotf, man.local_a),
                local_b=jax.tree_util.tree_map(slotf, man.local_b),
                valid=slotf(man.valid),
            )

        blocks = [man_to_rows(pair_manifold, K)]
        partners = [jnp.broadcast_to(
            jnp.where(pair_ok, partner, n_glob).T[None],
            (pair_manifold.valid.shape[0], K, n_loc)).reshape(-1, n_loc)]
        if n_tris > 0:
            t_rows = jnp.broadcast_to(rows_g[:, None],
                                      (n_loc, n_tris)).reshape(-1)
            t_tris = jnp.broadcast_to(
                jnp.arange(n_tris, dtype=jnp.int32)[None, :],
                (n_loc, n_tris)).reshape(-1)
            tri = jax.tree_util.tree_map(lambda x: x[t_tris], terrain)
            gt = gather_shapes(cfg, ps, t_rows)
            tc = _terrain_contact(cfg, gt, tri)
            t_lc = LocalContact(
                local_a=tc.a - (gt.x + gt.delta * tc.t),
                local_b=tc.b - terrain_center,
                contact=tc)
            blocks.append(man_to_rows(prune(t_lc, max_contacts=n_slots,
                                   prox_sq=manifold_prox_sq(cfg)),
                                      n_tris))
            max_pen = jnp.maximum(max_pen, _deepest(tc))
            partners.append(jnp.full((n_slots * n_tris, n_loc), n_glob,
                                     jnp.int32))

        man_rows = jax.tree_util.tree_map(
            lambda *xs: jnp.concatenate(xs, axis=0), *blocks)
        partner_rows = jnp.concatenate(partners, axis=0)

        # ---- replicated extended body view for constraint precompute ----
        srow = lambda g: jnp.concatenate(
            [g, jnp.zeros((1,) + g.shape[1:], g.dtype)], axis=0)
        srow_t = lambda t: jax.tree_util.tree_map(srow, t)
        bodies_ext = BodyView(
            x=jax.tree_util.tree_map(
                lambda g, c: jnp.concatenate([g, c[None]], axis=0),
                ag(state.x + state.delta), terrain_center),
            v=srow_t(ag(state.v)),
            omega=srow_t(ag(state.omega)),
            restitution=srow(jax.lax.all_gather(state.restitution, axis,
                                                tiled=True)),
            friction=srow(jax.lax.all_gather(state.friction, axis,
                                             tiled=True)),
            inv_mass=srow(jax.lax.all_gather(state.inv_mass, axis,
                                             tiled=True)),
            inv_moment=srow_t(ag(state.inv_moment)),
        )

        # mass splitting: local row counts, all-gathered for partner lookups
        counts_loc = jnp.maximum(
            jnp.sum(man_rows.valid, axis=0).astype(jnp.float32), 1.0)
        counts = jnp.concatenate(
            [jax.lax.all_gather(counts_loc, axis, tiled=True),
             jnp.ones((1,), jnp.float32)])

        rc = build_row_constraints(bodies_ext, partner_rows, man_rows,
                                   cfg.dt, counts=counts, self_rows=rows_g,
                                   bias_max=cfg.bias_max)

        # ---- scatter-free sharded row solve ----
        v0 = jax.tree_util.tree_map(
            lambda x: jax.lax.dynamic_slice_in_dim(x, row0, n_loc),
            bodies_ext.v)
        o0 = jax.tree_util.tree_map(
            lambda x: jax.lax.dynamic_slice_in_dim(x, row0, n_loc),
            bodies_ext.omega)
        S_loc = pack_body_state(v0, o0)                # (8, n_loc)
        ima = state.inv_mass
        Ia = state.inv_moment

        def glob(S_loc):
            S_g = jax.lax.all_gather(S_loc, axis, axis=1, tiled=True)
            return jnp.concatenate(
                [S_g, jnp.zeros((8, 1), S_g.dtype)], axis=1)

        def rel_vel(S_glob, S_loc):
            g = S_glob[:, rc.partner]
            vb = Vec3(g[0], g[1], g[2])
            ob = Vec3(g[3], g[4], g[5])
            va = Vec3(S_loc[0][None], S_loc[1][None], S_loc[2][None])
            oa = Vec3(S_loc[3][None], S_loc[4][None], S_loc[5][None])
            return (vb + cross(ob, rc.rb)) - (va + cross(oa, rc.ra))

        def apply_self(S_loc, imp: Vec3):
            imp = Vec3(imp.x * rc.valid, imp.y * rc.valid, imp.z * rc.valid)
            lin = Vec3(-imp.x.sum(0), -imp.y.sum(0), -imp.z.sum(0)) * ima
            ang_pt = -cross(rc.ra, imp)
            ang = mat_vec(Ia, Vec3(ang_pt.x.sum(0), ang_pt.y.sum(0),
                                   ang_pt.z.sum(0)))
            return S_loc + jnp.stack(
                [lin.x, lin.y, lin.z, ang.x, ang.y, ang.z,
                 jnp.zeros_like(lin.x), jnp.zeros_like(lin.x)], axis=0)

        def sweep(carry, _):
            S_loc, acc_n, acc_t1, acc_t2 = carry
            S_g = glob(S_loc)
            dv = rel_vel(S_g, S_loc)
            f1, f2, acc_t1, acc_t2 = _friction_impulses(
                rc, dv, acc_t1, acc_t2, cfg.friction_mode, acc_n)
            fn, acc_n = _normal_impulse(rc, dv, acc_n)
            S_loc = apply_self(S_loc, rc.t1 * f1 + rc.t2 * f2
                               + rc.normal * fn)
            return (S_loc, acc_n, acc_t1, acc_t2), None

        # accumulators seeded from a device-varying array so the scan carry
        # has consistent varying-across-mesh types under the new shard_map
        zero = rc.bias * 0.0
        (S_loc, _, _, _), _ = jax.lax.scan(
            sweep, (S_loc, zero, zero, zero), None, length=cfg.solver_iters)
        v_new, o_new = unpack_body_state(S_loc)
        dvx, dvy, dvz = v_new.x - v0.x, v_new.y - v0.y, v_new.z - v0.z
        state = state._replace(v=v_new, omega=o_new)

        n_dev = jax.lax.psum(1, axis)
        metrics = {
            # overflow is identical on every device (computed from the
            # all-gathered table); average through a psum so the new
            # shard_map can prove the P() out_spec replication
            "broadphase_overflow": jax.lax.psum(grid.overflow, axis) // n_dev,
            "num_pairs": jax.lax.psum(jnp.sum(pair_valid), axis),
            "num_contacts": jax.lax.psum(jnp.sum(rc.valid), axis),
            "max_penetration": jax.lax.pmax(max_pen, axis),
            "solver_dv_norm": jnp.sqrt(jax.lax.psum(
                jnp.sum(dvx * dvx + dvy * dvy + dvz * dvz), axis)),
        }
        return state, metrics

    try:
        sharded = shard_map(
            _local_step, mesh=mesh,
            in_specs=(P(axis), P(), P()),
            out_specs=(P(axis), P()))
    except TypeError:  # older jax requires check_rep=False for our metrics
        sharded = shard_map(
            _local_step, mesh=mesh,
            in_specs=(P(axis), P(), P()),
            out_specs=(P(axis), P()),
            check_rep=False)

    @jax.jit
    def step_fn(world: World):
        bodies, metrics = sharded(world.bodies, world.terrain,
                                  world.terrain_center)
        return world._replace(bodies=bodies), metrics

    return step_fn
