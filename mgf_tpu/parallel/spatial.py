"""Spatially sharded physics step: slab decomposition + halo exchange.

The all-gather design in :mod:`mgf_tpu.parallel.sharded` replicates the
whole world on every device (O(N) per-device memory and comm regardless of
mesh size).  This module is the scalable design SURVEY §2.3 planned:

* bodies are assigned to devices by x-slab (host-side sort at shard time;
  :func:`shard_world_spatial`), so a body's broadphase partners live on the
  same device or an adjacent one;
* each step, every device selects its H bodies nearest each slab edge (the
  *halo*) and sends their shape/sweep rows to that neighbor with ONE
  ppermute per direction — no all-gather;
* the grid/broadphase/narrowphase/constraint assembly run on the device's
  own rows + 2H halo rows (local index space);
* each solver iteration re-exchanges only the halo rows' packed velocity
  state ((8, H) per direction) so the twin constraint copies on both owners
  see fresh partner velocities.

Comm per step: 2 x (H x 16 floats) + iters x 2 x (H x 8 floats), versus the
all-gather design's 2 x (N x 12) + iters x (N x 8).

The FLAGSHIP stress config runs on this path: warm
starting, the "near"/"grid" terrain culls, the fat8x4/fat27x4 broadphase, and
stable/deduped candidate slots are all honored.  Warm-start rows are keyed
by GLOBAL body ids (carried inside the halo rows), so matching survives
halo recomposition between frames; re-sharding resets the warm state (one
cold frame).  Config fields this path genuinely cannot honor raise or warn
loudly instead of silently diverging.

Soundness: a pair is found iff both bodies are within ``halo_width`` of the
shared slab boundary (halo_width must cover max pair reach) and within the
top-H nearest; bodies that drift across slab boundaries keep correct
physics while within halo reach (their pairs are mirrored by both owners,
like every pair in the rows solver).  Drift beyond halo reach of the home
slab is *counted* in ``metrics["spatial_stray"]`` — call
:func:`shard_world_spatial` again (cheap host resort) when it goes nonzero.
Reference analog: this replaces mgf's single-thread BVH broadphase
(bvh.rs) at multi-chip scale.
"""

from __future__ import annotations

import functools
import warnings
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mgf_tpu import broadphase
from mgf_tpu.collision import LocalContact
from mgf_tpu.manifold import Manifold, prune
from mgf_tpu.math3d import Quat, Vec3, cross, dot, magnitude2, mat_vec
from mgf_tpu.physics import RigidBodyState, complete_motion, integrate
from mgf_tpu.solver import (
    BodyView, _friction_impulses, _normal_impulse, build_row_constraints,
    pack_body_state, unpack_body_state,
)
from mgf_tpu.world import (
    ShapeView, SolverWarm, World, WorldConfig, _body_bounds, _pair_contact,
    _terrain_contact, gather_shapes, manifold_prox_sq, pack_shapes,
    solver_row_count,
)
from mgf_tpu.parallel.sharded import pad_bodies


def shard_world_spatial(world: World, mesh: Mesh, cfg: WorldConfig = None,
                        axis: str = "b"):
    """Sort bodies by x and place equal slabs on the mesh.

    Returns (world, boundaries): boundaries is a (D+1,) float array of slab
    x-extents (quantiles at shard time), consumed by
    :func:`make_spatial_step`.  Call again to re-shard after long drift
    (``metrics["spatial_stray"]`` > 0).

    Passing ``cfg`` with ``cfg.warm_start`` attaches a zeroed sharded
    warm-start state (``world.warm``); re-sharding resets it, so the frame
    after a re-shard solves cold — warm keys are global *sorted-order* ids
    which a re-shard permutes.
    """
    d = int(mesh.devices.size)
    xs = np.asarray(world.bodies.x.x)
    order = np.argsort(xs, kind="stable")
    take = lambda g: jnp.asarray(np.asarray(g)[order])
    bodies = jax.tree_util.tree_map(take, world.bodies)
    bodies = pad_bodies(bodies, d)
    n_loc = bodies.n_bodies // d
    xs_sorted = np.concatenate(
        [np.sort(xs), np.full(bodies.n_bodies - len(xs), np.inf)])
    bounds = np.empty(d + 1, np.float32)
    bounds[0] = -np.inf
    bounds[d] = np.inf
    for k in range(1, d):
        lo = xs_sorted[k * n_loc - 1]
        hi = xs_sorted[k * n_loc] if k * n_loc < len(xs) else lo
        bounds[k] = 0.5 * (lo + min(hi, lo + 1.0))

    body_sharding = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())
    bodies = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, body_sharding), bodies)
    terrain = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, repl), world.terrain)
    center = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, repl), world.terrain_center)
    tgrid = (jax.device_put(world.terrain_grid, repl)
             if world.terrain_grid is not None else None)
    warm = None
    if cfg is not None and cfg.warm_start:
        R = solver_row_count(cfg, world.terrain.a.x.shape[0])
        n = bodies.n_bodies
        warm_sh = NamedSharding(mesh, P(None, axis))
        z = jax.device_put(jnp.zeros((R, n), jnp.float32), warm_sh)
        none = jax.device_put(jnp.full((R, n), -9, jnp.int32), warm_sh)
        warm = SolverWarm(partner=none, key2=none, acc_n=z, acc_t1=z,
                          acc_t2=z)
    return (World(bodies=bodies, terrain=terrain, terrain_center=center,
                  terrain_grid=tgrid, warm=warm),
            bounds)


class SpatialBpCache(NamedTuple):
    """Per-shard broadphase cache for the staleness-gated rebuild cadence
    (cfg.bp_every > 1) on the spatial path — the multi-chip analog of
    world.BpCache.  All leaves are sharded on axis 0 (bodies / shards):

    * candidate lists are LOCAL-index (own rows 0..n_loc-1, halo slots
      n_loc..n_loc+2H-1), valid across steps because the HALO MEMBERSHIP
      (sl/sr index lists) is cached too — on reuse steps each halo slot
      carries the same global body it did at build;
    * the rebuild trigger is the single-device one (drift + reach growth
      vs per-body build slack) pmax'd across shards, so every shard
      rebuilds in lockstep (a stale halo copy on the neighbor is rebuilt
      the same step its owner outruns its slack).
    """
    partner: jnp.ndarray   # (N, K) int32 local candidate indices
    ok: jnp.ndarray        # (N, K) bool
    anchor: Vec3           # (N,) build positions (end-of-sweep)
    slack: jnp.ndarray     # (N,) float32 per-body build slack
    r_build: jnp.ndarray   # (N,) float32 swept fat radius at build
    overflow: jnp.ndarray  # (D,) int32 grid overflow at build (per shard)
    count: jnp.ndarray     # (D,) int32 steps since init (per shard)
    sl_idx: jnp.ndarray    # (D*H,) int32 send-left membership at build
    sl_ok: jnp.ndarray     # (D*H,) bool
    sr_idx: jnp.ndarray    # (D*H,) int32 send-right membership at build
    sr_ok: jnp.ndarray     # (D*H,) bool


def init_spatial_bp_cache(world: World, mesh: Mesh, cfg: WorldConfig,
                          halo: int, axis: str = "b") -> World:
    """Attach an (invalid) spatial broadphase cache; the first step
    rebuilds.  ``halo`` must match the value passed to
    :func:`make_spatial_step`."""
    d = int(mesh.devices.size)
    n = world.bodies.n_bodies
    n_loc = n // d
    H = min(int(halo), n_loc)
    sh_b = NamedSharding(mesh, P(axis))
    put = lambda a: jax.device_put(a, sh_b)
    far = jnp.full((n,), 1.0e9, jnp.float32)
    return world._replace(bp=SpatialBpCache(
        partner=put(jnp.full((n, cfg.max_pairs), -1, jnp.int32)),
        ok=put(jnp.zeros((n, cfg.max_pairs), bool)),
        anchor=Vec3(put(far), put(far), put(far)),
        slack=put(jnp.zeros((n,), jnp.float32)),
        r_build=put(jnp.zeros((n,), jnp.float32)),
        overflow=put(jnp.zeros((d,), jnp.int32)),
        count=put(jnp.zeros((d,), jnp.int32)),
        sl_idx=put(jnp.zeros((d * H,), jnp.int32)),
        sl_ok=put(jnp.zeros((d * H,), bool)),
        sr_idx=put(jnp.zeros((d * H,), jnp.int32)),
        sr_ok=put(jnp.zeros((d * H,), bool))))


# Every WorldConfig field is either HONORED by the spatial step (same
# semantics as the single-device step) or FLAGGED in _check_cfg (raises or
# warns the moment a config requests it) — the union is asserted exhaustive
# by tests/test_spatial.py::test_spatial_cfg_field_coverage, so a new
# config field cannot silently diverge on the multi-chip path.
HONORED_FIELDS = frozenset({
    "dt", "solver_iters", "grid", "max_pairs", "fatten", "shape_mode",
    "friction_mode", "two_phase", "solver_inner", "broadphase",
    "terrain_rows", "terrain_bp", "terrain_cand", "terrain_grid_cfg",
    "warm_start", "solver_rows", "cap_manifold", "stable_pairs",
    "warm_gamma",        # scales the matched warm transfer at match time
    "warm_match",        # hybrid/pos honored with a bp cache (exact on
                         # reuse steps); upgraded-with-warning otherwise
    "adapt_schedule",    # in-graph cond on the psum'd warm-hit fraction
                         # (all shards take the same branch)
    "bp_every",          # staleness-gated rebuild cadence (r5): per-shard
                         # anchors/slack + a pmax'd rebuild flag keep every
                         # shard's cache in lockstep
    "bias_max",          # threaded into build_row_constraints unchanged
    "light_metrics",     # skips the same observability reductions
    "fused_iso",         # SEMANTICS honored (previous-frame mass-splitting
                         # counts ride the halo rows); the single-device
                         # gather-fusion layout itself has no meaning here
})
FLAGGED_FIELDS = frozenset({
    "profile_stage", "solver", "bp_margin", "pallas_solver",
    "n_sphere_rows", "use_grid",
})


def _check_cfg(cfg: WorldConfig):
    """Reject or warn on config fields the spatial path does not honor
    (never silently diverge from the requested semantics).
    The honored/flagged split is the module-level registry above."""
    if cfg.profile_stage:
        raise ValueError("spatial step has no profile_stage hooks")
    if cfg.solver != "rows":
        raise ValueError("spatial step implements the rows solver only")
    if not cfg.use_grid:
        warnings.warn(
            "spatial step always uses the local fat-grid broadphase; "
            "cfg.use_grid=False (all-pairs candidates) is ignored",
            stacklevel=3)
    if cfg.bp_margin > 0.0:
        warnings.warn(
            "spatial step supports the cfg.bp_every staleness-gated "
            "cadence but not the bp_margin fat-proxy variant; bp_margin "
            "is ignored", stacklevel=3)
    if cfg.pallas_solver:
        warnings.warn(
            "spatial step runs its solve as the jnp halo-exchange sweep; "
            "cfg.pallas_solver is ignored (the kernel implements the "
            "single-device iso row layout — identical math either way)",
            stacklevel=3)
    if cfg.n_sphere_rows >= 0:
        warnings.warn(
            "spatial sharding re-sorts bodies by x, breaking the "
            "type-partitioned layout cfg.n_sphere_rows describes; the "
            "generic 4-kernel mixed narrowphase runs instead (identical "
            "contacts)", stacklevel=3)
    if (cfg.warm_start and cfg.warm_match in ("pos", "hybrid")
            and not (cfg.bp_every > 1 and cfg.stable_pairs)):
        warnings.warn(
            "spatial warm_match='pos'/'hybrid' needs the bp cache "
            "(cfg.bp_every > 1) + stable_pairs to make slots stable "
            "across frames; upgraded to the order-robust search matching",
            stacklevel=3)


def make_spatial_step(cfg: WorldConfig, mesh: Mesh, boundaries,
                      halo: int = 256, halo_width: float = None,
                      axis: str = "b"):
    """Build the jitted halo-exchange step.

    ``boundaries``: (D+1,) slab x-extents from :func:`shard_world_spatial`.
    ``halo``: fixed halo row capacity per direction.
    ``halo_width``: pair-reach the halo must cover; defaults to the grid
    cell size (the candidate window guarantee).
    """
    _check_cfg(cfg)
    D = int(mesh.devices.size)
    boundaries = np.asarray(boundaries, np.float32)
    if halo_width is None:
        halo_width = cfg.grid.cell_size
    H = int(halo)
    right_perm = [(i, i + 1) for i in range(D - 1)]
    left_perm = [(i, i - 1) for i in range(1, D)]
    # broadphase window/width mapping (world.py step, same table)
    bp_width = 4 if cfg.broadphase in ("fat8x4", "fat27x4") else 8
    bp_window = "sel8" if cfg.broadphase in ("fat8", "fat8x4") else "27"
    use_warm = cfg.warm_start
    use_cache = cfg.bp_every > 1
    light = cfg.light_metrics

    def _local_step(bodies: RigidBodyState, terrain, terrain_center,
                    terrain_grid, warm_in, bp_in):
        state = complete_motion(bodies)
        state = integrate(state, cfg.dt)
        n_loc = state.inv_mass.shape[0]
        H = min(int(halo), n_loc)        # halo can't exceed the shard
        dev = jax.lax.axis_index(axis)
        lo = jnp.asarray(boundaries)[dev]
        hi = jnp.asarray(boundaries)[dev + 1]
        n_tris = terrain.a.x.shape[0]
        gid_own = dev * n_loc + jnp.arange(n_loc, dtype=jnp.int32)
        gid_static = D * n_loc            # global id of the terrain row
        alive_own = state.shape_r > 0.0   # pads carry shape_r = -1

        # ---- bp cache staleness (cfg.bp_every cadence, r5) ----
        # the same trigger as the single-device step (world.py): a reuse
        # step is taken only while every live body's drift from its build
        # anchor plus swept-reach growth fits the slack the cache was
        # built with — pmax'd across shards so every shard's cache (and
        # the neighbors' halo copies of its bodies) rebuilds in lockstep.
        from mgf_tpu.geom import AABB
        from mgf_tpu.math3d import vmax, vmin

        def swept_bounds(centers, delta, r_shape):
            rv = Vec3(r_shape, r_shape, r_shape)
            blo = vmin(centers - rv, centers + delta - rv)
            bhi = vmax(centers + rv, centers + delta + rv)
            c = (bhi + blo) * 0.5
            rr = (bhi - blo) * 0.5
            f = cfg.fatten
            return AABB(c=c, r=Vec3(rr.x + f, rr.y + f, rr.z + f))

        r_shape_own = state.shape_r + jnp.where(
            state.shape_type == 1, state.shape_half_h, 0.0)
        bounds_own = swept_bounds(state.x, state.delta, r_shape_own)
        r_eff_own = jnp.where(alive_own, jnp.maximum(
            bounds_own.r.x,
            jnp.maximum(bounds_own.r.y, bounds_own.r.z)), 0.0)
        x_end = state.x + state.delta
        guarantee = cfg.grid.cell_size * (0.5 if bp_window == "sel8"
                                          else 1.0)
        if use_cache:
            drift = jnp.sqrt(magnitude2(x_end - bp_in.anchor))
            dmag = jnp.sqrt(magnitude2(state.delta))
            desired = ((cfg.bp_every - 1)
                       * (2.0 * dmag + 0.02)).astype(jnp.float32)
            budget = jnp.maximum(0.5 * guarantee - r_eff_own, 0.0)
            slack_new = jnp.minimum(desired, budget)
            r_grow = jnp.maximum(r_eff_own - bp_in.r_build, 0.0)
            stale = jnp.max(jnp.where(
                alive_own, drift + r_grow - bp_in.slack, 0.0)) > 0.0
            need = ((bp_in.count[0] % cfg.bp_every) == 0) | stale
            need = jax.lax.pmax(need, axis)
        else:
            slack_new = jnp.zeros((n_loc,), jnp.float32)
            need = jnp.bool_(True)

        # ---- halo selection: H bodies nearest each slab edge ----
        # the band is inflated by each body's build slack so a body that
        # drifts INTO halo reach between rebuilds was already exchanged
        # at build time (its drift is bounded by its slack).  On reuse
        # steps the CACHED membership is used, so each halo slot carries
        # the same global body the cached candidate lists index.
        x = state.x.x
        band = halo_width + slack_new
        sl_score, sl_idx_f = jax.lax.top_k(-x, H)
        sl_ok_f = ((-sl_score) <= lo + band[sl_idx_f]) & alive_own[sl_idx_f]
        sr_score, sr_idx_f = jax.lax.top_k(x, H)
        sr_ok_f = (sr_score >= hi - band[sr_idx_f]) & alive_own[sr_idx_f]
        if use_cache:
            sl_idx = jnp.where(need, sl_idx_f, bp_in.sl_idx)
            sl_ok = jnp.where(need, sl_ok_f, bp_in.sl_ok)
            sr_idx = jnp.where(need, sr_idx_f, bp_in.sr_idx)
            sr_ok = jnp.where(need, sr_ok_f, bp_in.sr_ok)
        else:
            sl_idx, sl_ok, sr_idx, sr_ok = (sl_idx_f, sl_ok_f,
                                            sr_idx_f, sr_ok_f)
        halo_overflow = (
            jnp.sum((x <= lo + band) & alive_own) - jnp.sum(sl_ok_f)
            + jnp.sum((x >= hi - band) & alive_own) - jnp.sum(sr_ok_f))
        stray = jnp.sum(((x < lo - halo_width) | (x > hi + halo_width))
                        & alive_own)

        # previous-frame contact counts (fused_iso mass-splitting
        # semantics): free from the warm state, exchanged WITH the halo
        # shape rows so no extra comm round is needed
        if use_warm and cfg.fused_iso:
            cnt_prev = jnp.maximum(jnp.sum(
                (warm_in.partner != -9).astype(jnp.float32), axis=0), 1.0)
        else:
            cnt_prev = jnp.ones((n_loc,), jnp.float32)

        # ---- pack + exchange halo rows (16 floats per body) ----
        # layout: p13 (x y z dx dy dz r half_h qw qx qy qz stype — the
        #         r4 pack_shapes row) | global id | cnt_prev | spare
        sv = ShapeView(x=state.x, q=state.q, delta=state.delta,
                       shape_type=state.shape_type, shape_r=state.shape_r,
                       shape_half_h=state.shape_half_h)
        ps_own = pack_shapes(sv)

        def pack_halo(idx, ok):
            p13 = jnp.where(ok[:, None], ps_own.p8[idx], 0.0)
            # park invalid halo rows far away with NEGATIVE radius: the
            # grid build masks r <= 0 rows out entirely, so a parked row
            # can never alias into an occupied bucket
            far = 1.0e8 + jax.lax.broadcasted_iota(
                jnp.float32, (H, 1), 0) * 100.0
            p13 = jnp.where(ok[:, None], p13,
                            jnp.concatenate([far] * 3 + [p13[:, 3:]],
                                            axis=1))
            p13 = p13.at[:, 6].set(jnp.where(ok, p13[:, 6], -1.0e3))
            p13 = p13.at[:, 8].set(jnp.where(ok, p13[:, 8], 1.0))  # qw
            gid = jnp.where(ok, gid_own[idx], -7)
            cnt = jnp.where(ok, cnt_prev[idx], 1.0)
            # build slack rides the spare column: the receiver inflates
            # the halo row's build bounds by it (bp cache conservatism)
            slk = jnp.where(ok, slack_new[idx], 0.0)
            return jnp.concatenate(
                [p13, gid[:, None].astype(jnp.float32), cnt[:, None],
                 slk[:, None]], axis=1)   # (H, 16)

        send_l = pack_halo(sl_idx, sl_ok)
        send_r = pack_halo(sr_idx, sr_ok)
        # rows I send LEFT become the LEFT neighbor's right-halo.  I
        # receive: from my right neighbor (their send_l) -> my right halo;
        # from my left neighbor (their send_r) -> my left halo.
        recv_r = jax.lax.ppermute(send_l, axis, left_perm)
        recv_l = jax.lax.ppermute(send_r, axis, right_perm)

        def halo_shapes(rows16):
            return (rows16[:, :13],
                    rows16[:, 12].astype(jnp.int32),
                    rows16[:, 13].astype(jnp.int32),
                    rows16[:, 14],
                    rows16[:, 15])

        lp13, lst, lgid, lcnt, lslk = halo_shapes(recv_l)
        rp13, rst, rgid, rcnt, rslk = halo_shapes(recv_r)
        ps = type(ps_own)(
            p8=jnp.concatenate([ps_own.p8, lp13, rp13], axis=0),
            shape_type=jnp.concatenate([ps_own.shape_type, lst, rst],
                                       axis=0))
        gids = jnp.concatenate([gid_own, lgid, rgid,
                                jnp.asarray([gid_static], jnp.int32)])
        m_rows = n_loc + 2 * H          # local body-table height
        alive_all = ps.p8[:, 6] > 0.0   # own pads + parked halo rows out

        # ---- local grid over own + halo rows (cached across steps) ----
        centers = Vec3(ps.p8[:, 0], ps.p8[:, 1], ps.p8[:, 2])
        delta = Vec3(ps.p8[:, 3], ps.p8[:, 4], ps.p8[:, 5])
        r_shape_all = ps.p8[:, 6] + jnp.where(
            ps.shape_type == 1, ps.p8[:, 7], 0.0)
        bounds = swept_bounds(centers, delta, r_shape_all)
        own_rows = jax.lax.broadcasted_iota(jnp.int32, (n_loc, 1),
                                            0).squeeze(-1)
        own_centers = jax.tree_util.tree_map(lambda g: g[:n_loc], bounds.c)

        def build_pairs(_):
            # build bounds inflated by per-body slack (own rows: this
            # step's slack_new; halo rows: the slack their OWNER built
            # with, exchanged in the halo row's spare column)
            slack_all = jnp.concatenate([slack_new, lslk, rslk])
            bb = bounds._replace(r=Vec3(bounds.r.x + slack_all,
                                        bounds.r.y + slack_all,
                                        bounds.r.z + slack_all))
            grid = broadphase.build_fat_grid(bb, cfg.grid, width=bp_width,
                                             valid=alive_all)
            partner, pair_ok = broadphase.fat_grid_pairs(
                bb, grid, cfg.grid, cfg.max_pairs, self_rows=own_rows,
                ordered=False, query_centers=own_centers,
                window=bp_window)
            if cfg.stable_pairs:
                # canonical slot order + duplicate masking, exactly as in
                # the single-device step (grid-modulus aliasing can bin
                # one body into two windows); local index sort ==
                # global-id sort here because own rows sort below halo
                # rows consistently per body
                big = jnp.int32(1 << 28)
                p_s = jnp.sort(jnp.where(pair_ok, partner, big), axis=1)
                dup = jnp.concatenate(
                    [jnp.zeros((p_s.shape[0], 1), bool),
                     p_s[:, 1:] == p_s[:, :-1]], axis=1)
                pair_ok = (p_s < big) & ~dup
                partner = jnp.where(pair_ok, p_s, 0)
            return partner, pair_ok, grid.overflow

        if use_cache:
            def rebuild(_):
                p, ok, of = build_pairs(None)
                return (p, ok, of, x_end.x, x_end.y, x_end.z, slack_new,
                        r_eff_own)

            def reuse(_):
                b = bp_in
                return (b.partner, b.ok, b.overflow[0], b.anchor.x,
                        b.anchor.y, b.anchor.z, b.slack, b.r_build)

            (partner, pair_ok, overflow, ax_, ay_, az_, bslack,
             rbuild) = jax.lax.cond(need, rebuild, reuse, None)
            bp_out = SpatialBpCache(
                partner=partner, ok=pair_ok, anchor=Vec3(ax_, ay_, az_),
                slack=bslack, r_build=rbuild, overflow=overflow[None],
                count=bp_in.count + 1,
                sl_idx=sl_idx, sl_ok=sl_ok, sr_idx=sr_idx, sr_ok=sr_ok)
            bp_drift_excess = jnp.where(need, 0.0, jnp.maximum(jnp.max(
                jnp.where(alive_own, drift - bslack, 0.0)), 0.0))
            bp_rebuilt = need
        else:
            partner, pair_ok, overflow = build_pairs(None)
            bp_out = bp_in
            bp_drift_excess = jnp.float32(0.0)
            bp_rebuilt = jnp.bool_(True)

        # ---- narrowphase over own candidate rows (local indices) ----
        prow = jnp.broadcast_to(own_rows[:, None], partner.shape).reshape(-1)
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

        def _deepest(cc):
            pen = dot(cc.b - cc.a, cc.n)
            return jnp.max(jnp.where(cc.valid, jnp.maximum(-pen, 0.0), 0.0))

        max_pen = _deepest(pc)

        def man_to_rows(man, width):
            S = man.valid.shape[0]
            slotf = lambda g: (g.reshape(S, n_loc, width).swapaxes(1, 2)
                               .reshape(S * width, n_loc))
            pairf = lambda g: jnp.broadcast_to(
                g.reshape(n_loc, width).T[None],
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

        S_pair = pair_manifold.valid.shape[0]
        blocks = [man_to_rows(pair_manifold, K)]
        partners = [jnp.broadcast_to(
            jnp.where(pair_ok, partner, m_rows).T[None],
            (S_pair, K, n_loc)).reshape(-1, n_loc)]
        # warm keys: pair rows keyed by (partner GLOBAL id, manifold slot);
        # terrain rows by (static id, triangle id) — same scheme as the
        # single-device step, but in the global id space so the key
        # survives halo recomposition between frames
        key2s = [jnp.broadcast_to(
            jnp.arange(S_pair, dtype=jnp.int32)[:, None, None],
            (S_pair, K, n_loc)).reshape(-1, n_loc)]

        # ---- terrain narrowphase: dense | near | grid cull ----
        t_reach_excess = jnp.float32(0.0)
        if n_tris > 0:
            if cfg.terrain_bp == "near":
                # exact AABB-distance cull to terrain_cand faces per body
                # (world.py step, same math, own rows only)
                ta = terrain
                tlo = [jnp.minimum(jnp.minimum(ta.a.x, ta.b.x), ta.c.x),
                       jnp.minimum(jnp.minimum(ta.a.y, ta.b.y), ta.c.y),
                       jnp.minimum(jnp.minimum(ta.a.z, ta.b.z), ta.c.z)]
                thi = [jnp.maximum(jnp.maximum(ta.a.x, ta.b.x), ta.c.x),
                       jnp.maximum(jnp.maximum(ta.a.y, ta.b.y), ta.c.y),
                       jnp.maximum(jnp.maximum(ta.a.z, ta.b.z), ta.c.z)]
                px = [state.x.x, state.x.y, state.x.z]
                d2 = jnp.zeros((n_loc, n_tris), jnp.float32)
                for k in range(3):
                    d_ax = jnp.maximum(
                        jnp.maximum(tlo[k][None, :] - px[k][:, None],
                                    px[k][:, None] - thi[k][None, :]), 0.0)
                    d2 = d2 + d_ax * d_ax
                reach = (state.shape_r + state.shape_half_h
                         + jnp.sqrt(magnitude2(state.delta)) + 0.1)
                score = jnp.where(d2 <= (reach * reach)[:, None], -d2,
                                  -jnp.inf)
                top, pick = jax.lax.top_k(score, cfg.terrain_cand)
                t_cand = pick.astype(jnp.int32)
                t_ok = jnp.isfinite(top)
                t_width = cfg.terrain_cand
            elif cfg.terrain_bp == "grid":
                # fused-key cull over the packed [fid | centroid] face
                # table — identical to the single-device step (world.py)
                tg = cfg.terrain_grid_cfg
                cap_t = terrain_grid.shape[1] // 4
                cc = lambda comp: jnp.floor(
                    comp / tg.cell_size).astype(jnp.int32)
                cx, cy, cz = cc(state.x.x), cc(state.x.y), cc(state.x.z)
                mmask = tg.dim - 1
                d2_max = (3.0 * tg.cell_size) ** 2
                inv_scale = 16383.0 / d2_max
                keys = []
                for dx in (-1, 0, 1):
                    for dy in (-1, 0, 1):
                        for dz in (-1, 0, 1):
                            h = ((((cx + dx) & mmask) * tg.dim
                                  + ((cy + dy) & mmask)) * tg.dim
                                 + ((cz + dz) & mmask))
                            rows_t = terrain_grid[h]
                            fid = rows_t[:, :cap_t]
                            dxc = rows_t[:, cap_t:2 * cap_t] \
                                - state.x.x[:, None]
                            dyc = rows_t[:, 2 * cap_t:3 * cap_t] \
                                - state.x.y[:, None]
                            dzc = rows_t[:, 3 * cap_t:4 * cap_t] \
                                - state.x.z[:, None]
                            d2 = dxc * dxc + dyc * dyc + dzc * dzc
                            q = jnp.minimum(
                                (d2 * inv_scale).astype(jnp.int32), 16383)
                            keys.append(jnp.where(
                                fid >= 0.0,
                                ((16383 - q) << 17)
                                | fid.astype(jnp.int32), -1))
                keym = jnp.concatenate(keys, axis=1)
                k1 = min(4 * cfg.terrain_cand, keym.shape[1])
                top1 = jax.lax.top_k(keym, k1)[0]
                dup = jnp.concatenate(
                    [jnp.zeros((top1.shape[0], 1), bool),
                     top1[:, 1:] == top1[:, :-1]], axis=1)
                top2 = jax.lax.top_k(jnp.where(dup, -1, top1),
                                     cfg.terrain_cand)[0]
                t_ok = top2 >= 0
                t_cand = jnp.where(t_ok, top2 & 0x1FFFF, -1)
                t_width = cfg.terrain_cand
                t_reach = (state.shape_r + state.shape_half_h
                           + jnp.sqrt(magnitude2(state.delta)))
                t_reach_excess = jnp.maximum(
                    jnp.max(jnp.where(alive_own, t_reach, 0.0))
                    - tg.cell_size, 0.0)
            else:
                t_width = n_tris
                t_cand = jnp.broadcast_to(
                    jnp.arange(n_tris, dtype=jnp.int32)[None, :],
                    (n_loc, n_tris))
                t_ok = jnp.ones((n_loc, n_tris), bool)
            if cfg.stable_pairs and cfg.terrain_bp in ("near", "grid"):
                tb = jnp.int32(1 << 28)
                tcs = jnp.sort(jnp.where(t_ok, t_cand, tb), axis=1)
                tdup = jnp.concatenate(
                    [jnp.zeros((tcs.shape[0], 1), bool),
                     tcs[:, 1:] == tcs[:, :-1]], axis=1)
                t_ok = (tcs < tb) & ~tdup
                t_cand = jnp.where(t_ok, tcs, 0)
            t_rows = jnp.broadcast_to(own_rows[:, None],
                                      (n_loc, t_width)).reshape(-1)
            t_tris = jnp.where(t_ok, t_cand, 0).reshape(-1)
            t_valid = t_ok.reshape(-1)
            tri = jax.tree_util.tree_map(lambda g: g[t_tris], terrain)
            gt = gather_shapes(cfg, ps, t_rows)
            tc = _terrain_contact(cfg, gt, tri)
            tc = tc._replace(valid=tc.valid & t_valid[None, :])
            t_lc = LocalContact(
                local_a=tc.a - (gt.x + gt.delta * tc.t),
                local_b=tc.b - terrain_center,
                contact=tc)
            tman = man_to_rows(prune(t_lc, max_contacts=n_slots,
                                   prox_sq=manifold_prox_sq(cfg)), t_width)
            t_key2 = jnp.broadcast_to(
                t_tris.reshape(n_loc, t_width).T[None],
                (n_slots, t_width, n_loc)).reshape(-1, n_loc)
            t_rows_n = tman.valid.shape[0]
            if cfg.terrain_rows and t_rows_n > cfg.terrain_rows:
                kk = cfg.terrain_rows
                score = (tman.valid.astype(jnp.float32)
                         * (2.0 - tman.time))
                _, t_idx = jax.lax.top_k(score.T, kk)
                sel = lambda g: jnp.take_along_axis(g, t_idx.T, axis=0)
                tman = jax.tree_util.tree_map(sel, tman)
                t_key2 = sel(t_key2)
                t_rows_n = kk
            blocks.append(tman)
            partners.append(jnp.full((t_rows_n, n_loc), m_rows, jnp.int32))
            key2s.append(t_key2)
            max_pen = jnp.maximum(max_pen, _deepest(tc))

        man_rows = jax.tree_util.tree_map(
            lambda *xs: jnp.concatenate(xs, axis=0), *blocks)
        partner_rows = jnp.concatenate(partners, axis=0)
        key2_rows = jnp.concatenate(key2s, axis=0)

        if cfg.solver_rows and man_rows.valid.shape[0] > cfg.solver_rows:
            kk = cfg.solver_rows
            score = (man_rows.valid.astype(jnp.float32)
                     * (2.0 - jnp.clip(man_rows.time, 0.0, 1.0)))
            _, r_idx = jax.lax.top_k(score.T, kk)
            sel = lambda g: jnp.take_along_axis(g, r_idx.T, axis=0)
            man_rows = jax.tree_util.tree_map(sel, man_rows)
            partner_rows = sel(partner_rows)
            key2_rows = sel(key2_rows)

        # ---- mass-splitting counts for own + halo rows ----
        if use_warm and cfg.fused_iso:
            # fused_iso semantics: previous-frame counts, already
            # exchanged inside the halo shape rows — zero extra comm
            counts = jnp.concatenate(
                [cnt_prev, jnp.maximum(lcnt, 1.0), jnp.maximum(rcnt, 1.0),
                 jnp.ones((1,), jnp.float32)])
            count_comm = 0
        else:
            # this-frame counts: halo rows' counts live on their owner;
            # exchange them the same way as the shape rows
            counts_own = jnp.maximum(
                jnp.sum(man_rows.valid, axis=0).astype(jnp.float32), 1.0)
            cl = jnp.where(sl_ok, counts_own[sl_idx], 1.0)
            cr = jnp.where(sr_ok, counts_own[sr_idx], 1.0)
            counts_r = jax.lax.ppermute(cl, axis, left_perm)
            counts_l = jax.lax.ppermute(cr, axis, right_perm)
            counts = jnp.concatenate(
                [counts_own, jnp.maximum(counts_l, 1.0),
                 jnp.maximum(counts_r, 1.0), jnp.ones((1,), jnp.float32)])
            count_comm = 2 * H

        # ---- extended body view: own + halo + one static row ----
        def exch(own, fill=0.0):
            sl = jnp.where(sl_ok, own[sl_idx], fill)
            sr = jnp.where(sr_ok, own[sr_idx], fill)
            rr_ = jax.lax.ppermute(sl, axis, left_perm)
            rl_ = jax.lax.ppermute(sr, axis, right_perm)
            return jnp.concatenate(
                [own, rl_, rr_,
                 jnp.zeros((1,) + own.shape[1:], own.dtype)], axis=0)

        exch_t = lambda t: jax.tree_util.tree_map(exch, t)
        x_end = state.x + state.delta
        bodies_ext = BodyView(
            x=jax.tree_util.tree_map(
                lambda own, c: jnp.concatenate(
                    [exch(own)[:-1], c[None]], axis=0),
                x_end, terrain_center),
            v=exch_t(state.v),
            omega=exch_t(state.omega),
            restitution=exch(state.restitution),
            friction=exch(state.friction),
            inv_mass=exch(state.inv_mass),
            inv_moment=exch_t(state.inv_moment),
        )

        rc = build_row_constraints(bodies_ext, partner_rows, man_rows,
                                   cfg.dt, counts=counts,
                                   self_rows=own_rows,
                                   bias_max=cfg.bias_max)

        # ---- warm-start row matching (global-id keys) ----
        partner_gid = gids[jnp.minimum(partner_rows, m_rows)]  # (R, n_loc)
        warm = None
        matched = None
        if use_warm:
            def match_pos(_):
                # positional: a row warms iff the SAME slot carried the
                # same (partner gid, key2) last frame — exact on bp-cache
                # REUSE steps (cached candidate lists + cached halo
                # membership keep both partner_gid and slot order
                # bit-identical); zero gathers
                hit = ((partner_gid == warm_in.partner)
                       & (key2_rows == warm_in.key2))
                hf = hit.astype(jnp.float32)
                return (warm_in.acc_n * hf, warm_in.acc_t1 * hf,
                        warm_in.acc_t2 * hf, hit)

            def match_search(_):
                # full (R, R_prev, n_loc) key search — order-robust
                eq = ((partner_gid[:, None, :] == warm_in.partner[None])
                      & (key2_rows[:, None, :] == warm_in.key2[None]))
                first = eq & (jnp.cumsum(eq.astype(jnp.int8), axis=1) == 1)
                zn = jnp.zeros(partner_rows.shape, jnp.float32)
                wn, wt1, wt2 = zn, zn, zn
                for k in range(warm_in.partner.shape[0]):
                    mk = first[:, k, :].astype(jnp.float32)
                    wn = wn + mk * warm_in.acc_n[k][None]
                    wt1 = wt1 + mk * warm_in.acc_t1[k][None]
                    wt2 = wt2 + mk * warm_in.acc_t2[k][None]
                return wn, wt1, wt2, jnp.any(first, axis=1)

            slots_stable = use_cache and cfg.stable_pairs
            if cfg.warm_match == "pos" and slots_stable:
                wn, wt1, wt2, matched = match_pos(None)
            elif cfg.warm_match == "hybrid" and slots_stable:
                # hybrid: positional on reuse steps (exact — see
                # match_pos), full search on rebuild steps.  Same
                # semantics as the single-device hybrid (world.py)
                wn, wt1, wt2, matched = jax.lax.cond(
                    bp_rebuilt, match_search, match_pos, None)
            else:
                wn, wt1, wt2, matched = match_search(None)
            okf = rc.valid.astype(jnp.float32)
            if cfg.warm_gamma != 1.0:
                okf = okf * jnp.float32(cfg.warm_gamma)
            warm = (wn * okf, wt1 * okf, wt2 * okf)

        # global warm-hit fraction — the adaptive-schedule trigger; psum'd
        # so every shard sees the same value and takes the same branch
        warm_hit_frac = jnp.float32(0.0)
        if use_warm and matched is not None:
            hits = jax.lax.psum(jnp.sum(
                (matched & rc.valid).astype(jnp.float32)), axis)
            tot = jax.lax.psum(jnp.sum(rc.valid.astype(jnp.float32)), axis)
            warm_hit_frac = hits / jnp.maximum(tot, 1.0)

        # ---- halo-exchange row solve ----
        S_loc = pack_body_state(state.v, state.omega)     # (8, n_loc)
        ima = state.inv_mass
        Ia = state.inv_moment

        def full_state(S_loc):
            """(8, m_rows + 1): own rows + fresh halo rows + static."""
            sl = jnp.where(sl_ok[None, :], S_loc[:, sl_idx], 0.0)
            sr = jnp.where(sr_ok[None, :], S_loc[:, sr_idx], 0.0)
            hr = jax.lax.ppermute(sl, axis, left_perm)
            hl = jax.lax.ppermute(sr, axis, right_perm)
            return jnp.concatenate(
                [S_loc, hl, hr, jnp.zeros((8, 1), S_loc.dtype)], axis=1)

        def partner_term(S_glob):
            g = S_glob[:, rc.partner]
            vb = Vec3(g[0], g[1], g[2])
            ob = Vec3(g[3], g[4], g[5])
            return vb + cross(ob, rc.rb)

        def apply_self(S_loc, imp: Vec3):
            imp = Vec3(imp.x * rc.valid, imp.y * rc.valid, imp.z * rc.valid)
            lin = Vec3(-imp.x.sum(0), -imp.y.sum(0), -imp.z.sum(0)) * ima
            ang_pt = -cross(rc.ra, imp)
            ang = mat_vec(Ia, Vec3(ang_pt.x.sum(0), ang_pt.y.sum(0),
                                   ang_pt.z.sum(0)))
            return S_loc.at[:6, :].add(jnp.stack(
                [lin.x, lin.y, lin.z, ang.x, ang.y, ang.z], axis=0))

        def run_solve(carry0, iters, inner_sweeps):
            def sweep(carry, _):
                S_loc = carry[0]
                frozen = partner_term(full_state(S_loc))

                def inner(carry2, _):
                    S_loc, acc_n, acc_t1, acc_t2 = carry2
                    va = Vec3(S_loc[0][None], S_loc[1][None],
                              S_loc[2][None])
                    oa = Vec3(S_loc[3][None], S_loc[4][None],
                              S_loc[5][None])
                    dv = frozen - (va + cross(oa, rc.ra))
                    f1, f2, acc_t1, acc_t2 = _friction_impulses(
                        rc, dv, acc_t1, acc_t2, cfg.friction_mode, acc_n)
                    if cfg.two_phase:
                        S_loc = apply_self(S_loc, rc.t1 * f1 + rc.t2 * f2)
                        va = Vec3(S_loc[0][None], S_loc[1][None],
                                  S_loc[2][None])
                        oa = Vec3(S_loc[3][None], S_loc[4][None],
                                  S_loc[5][None])
                        dv = frozen - (va + cross(oa, rc.ra))
                        fn, acc_n = _normal_impulse(rc, dv, acc_n)
                        S_loc = apply_self(S_loc, rc.normal * fn)
                    else:
                        fn, acc_n = _normal_impulse(rc, dv, acc_n)
                        S_loc = apply_self(
                            S_loc,
                            rc.t1 * f1 + rc.t2 * f2 + rc.normal * fn)
                    return (S_loc, acc_n, acc_t1, acc_t2), None

                if inner_sweeps == 1:
                    carry, _ = inner(carry, None)
                else:
                    carry, _ = jax.lax.scan(inner, carry, None,
                                            length=inner_sweeps)
                return carry, None

            return jax.lax.scan(sweep, carry0, None, length=iters)[0]

        zero = rc.bias * 0.0
        if warm is None:
            acc0 = (zero, zero, zero)
        else:
            wn, wt1, wt2 = warm
            S_loc = apply_self(S_loc, rc.t1 * wt1 + rc.t2 * wt2
                               + rc.normal * wn)
            acc0 = (wn, wt1, wt2)
        carry0 = (S_loc,) + acc0
        if cfg.adapt_schedule is not None and matched is not None:
            # adaptive solver schedule (same trigger semantics as the
            # single-device in-graph form): the cheap settled schedule
            # once the psum'd warm-hit fraction persists — all shards
            # take the same branch, so the in-branch halo ppermutes stay
            # in lockstep
            thr, it2, in2 = cfg.adapt_schedule
            hot = warm_hit_frac >= thr
            S_loc, acc_n, acc_t1, acc_t2 = jax.lax.cond(
                hot,
                lambda c: run_solve(c, int(it2), int(in2)),
                lambda c: run_solve(c, cfg.solver_iters, cfg.solver_inner),
                carry0)
            iters_used = jnp.where(hot, jnp.int32(it2),
                                   jnp.int32(cfg.solver_iters))
        else:
            S_loc, acc_n, acc_t1, acc_t2 = run_solve(
                carry0, cfg.solver_iters, cfg.solver_inner)
            iters_used = jnp.int32(cfg.solver_iters)
        v_new, o_new = unpack_body_state(S_loc)
        dvx = v_new.x - state.v.x
        dvy = v_new.y - state.v.y
        dvz = v_new.z - state.v.z
        state = state._replace(v=v_new, omega=o_new)

        if use_warm:
            warm_out = SolverWarm(
                partner=jnp.where(rc.valid, partner_gid, -9),
                key2=key2_rows, acc_n=acc_n, acc_t1=acc_t1, acc_t2=acc_t2)
        else:
            warm_out = warm_in

        comm_floats = (2 * H * 16 + count_comm
                       + iters_used * 2 * H * 8)
        z32 = jnp.int32(0)
        metrics = {
            "broadphase_overflow": jax.lax.psum(overflow, axis),
            "broadphase_rebuilt": bp_rebuilt,          # already lockstep
            "broadphase_cache_drift_excess": jax.lax.pmax(
                bp_drift_excess, axis),
            "warm_hit_frac": warm_hit_frac,            # already psum'd
            "num_pairs": (z32 if light
                          else jax.lax.psum(jnp.sum(pair_valid), axis)),
            "num_contacts": (z32 if light
                             else jax.lax.psum(jnp.sum(rc.valid), axis)),
            "max_penetration": (jnp.float32(0.0) if light
                                else jax.lax.pmax(max_pen, axis)),
            "terrain_reach_excess": jax.lax.pmax(t_reach_excess, axis),
            "halo_overflow": jax.lax.psum(halo_overflow, axis),
            "spatial_stray": jax.lax.psum(stray, axis),
            "comm_floats_per_step": jax.lax.psum(
                jnp.int32(comm_floats), axis),
            "solver_dv_norm": (jnp.float32(0.0) if light
                               else jnp.sqrt(jax.lax.psum(
                                   jnp.sum(dvx * dvx + dvy * dvy
                                           + dvz * dvz), axis))),
        }
        return state, metrics, warm_out, bp_out

    warm_spec = P(None, axis) if use_warm else P()
    grid_spec = P()
    bp_spec = P(axis)     # every SpatialBpCache leaf is sharded on axis 0
    try:
        sharded = shard_map(
            _local_step, mesh=mesh,
            in_specs=(P(axis), P(), P(), grid_spec, warm_spec, bp_spec),
            out_specs=(P(axis), P(), warm_spec, bp_spec))
    except TypeError:  # older jax needs check_rep=False for our metrics
        sharded = shard_map(
            _local_step, mesh=mesh,
            in_specs=(P(axis), P(), P(), grid_spec, warm_spec, bp_spec),
            out_specs=(P(axis), P(), warm_spec, bp_spec),
            check_rep=False)

    _dummy_warm = SolverWarm(
        partner=jnp.full((1, 1), -9, jnp.int32),
        key2=jnp.full((1, 1), -9, jnp.int32),
        acc_n=jnp.zeros((1, 1), jnp.float32),
        acc_t1=jnp.zeros((1, 1), jnp.float32),
        acc_t2=jnp.zeros((1, 1), jnp.float32))
    _dummy_grid = jnp.full((1, 4), -1.0, jnp.float32)
    zD = jnp.zeros((D,), jnp.float32)
    _dummy_bp = SpatialBpCache(
        partner=jnp.full((D, 1), -1, jnp.int32),
        ok=jnp.zeros((D, 1), bool),
        anchor=Vec3(zD, zD, zD), slack=zD, r_build=zD,
        overflow=jnp.zeros((D,), jnp.int32),
        count=jnp.zeros((D,), jnp.int32),
        sl_idx=jnp.zeros((D,), jnp.int32), sl_ok=jnp.zeros((D,), bool),
        sr_idx=jnp.zeros((D,), jnp.int32), sr_ok=jnp.zeros((D,), bool))

    @jax.jit
    def step_fn(world: World):
        warm = world.warm if use_warm else _dummy_warm
        if use_warm and world.warm is None:
            raise ValueError(
                "cfg.warm_start needs world.warm — shard with "
                "shard_world_spatial(world, mesh, cfg=cfg)")
        if use_cache and world.bp is None:
            raise ValueError(
                "cfg.bp_every > 1 needs world.bp — attach with "
                "init_spatial_bp_cache(world, mesh, cfg, halo)")
        bp = world.bp if use_cache else _dummy_bp
        tgrid = (world.terrain_grid if world.terrain_grid is not None
                 else _dummy_grid)
        bodies, metrics, warm_out, bp_out = sharded(
            world.bodies, world.terrain, world.terrain_center, tgrid,
            warm, bp)
        return world._replace(
            bodies=bodies,
            warm=warm_out if use_warm else world.warm,
            bp=bp_out if use_cache else world.bp), metrics

    return step_fn
