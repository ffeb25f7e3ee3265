"""The end-to-end physics step — one jitted function.

Counterpart of ``mgf_demo/world.rs:227-294`` (``World::step``):

    complete_motion -> integrate -> broadphase -> narrowphase ->
    manifolds -> contact constraints -> impulse solver

Where the reference walks a pointer BVH per body and pushes constraints into
a growable solver, every stage here is a fixed-shape array program in Vec3
component form: the broadphase is a rebuilt cell grid, candidate pairs live
in a dense (N, max_pairs) partner matrix, the narrowphase runs natively
batched over the flattened pair list, and the solver consumes one flat
constraint SoA.  Static terrain is a triangle soup tested densely (the demo
terrain has 10 triangles, world.rs:140-149); terrain impulses sink into a
virtual static body row with zero inverse mass — exactly
``RigidBodyRef::Static`` (physics.rs:289-302).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from mgf_tpu import broadphase
from mgf_tpu.broadphase import GridConfig
from mgf_tpu.bounds import capsule_aabb, sphere_aabb
from mgf_tpu.collision import (
    Contact, LocalContact, contact_capsule_moving_capsule,
    contact_capsule_moving_sphere, contact_moving_moving, contact_neg,
    contact_select, contact_sphere_moving_capsule,
    contact_sphere_moving_sphere, contact_stack,
    contact_triangle_moving_capsule, contact_triangle_moving_sphere,
)
from mgf_tpu.geom import AABB, Capsule, Sphere, Triangle
from mgf_tpu.manifold import Manifold, prune
from mgf_tpu.math3d import (Mat3, Quat, Vec3, dot, magnitude2, vfrom,
                            where_vec)
from mgf_tpu.physics import (
    SHAPE_CAPSULE, SHAPE_SPHERE, RigidBodyState, complete_motion, colliders,
    integrate,
)
from mgf_tpu.solver import (
    BodyView, ContactConstraints, build_constraints, build_row_constraints,
    build_row_constraints_iso, solve_parallel, solve_rows, solve_sequential,
)


class WorldConfig(NamedTuple):
    """Static (jit-time) configuration of the step pipeline."""
    dt: float = 1.0 / 60.0
    solver_iters: int = 20           # world.rs:293
    grid: GridConfig = GridConfig(cell_size=2.0, dim=64, bucket_cap=4)
    use_grid: bool = True            # False: O(N^2) candidates (small scenes)
    max_pairs: int = 16              # partner slots per body
    fatten: float = 0.25             # fat-proxy margin (world.rs:181)
    shape_mode: str = "spheres"      # "spheres" | "capsules" | "mixed"
    solver: str = "rows"             # "rows" | "parallel" | "sequential"
    friction_mode: str = "textbook"  # see solver.py docstring
    two_phase: bool = True           # rows solver: friction/normal phases
    solver_inner: int = 1            # rows solver: inner sweeps per gather
    broadphase: str = "packed"       # "packed" | "fat" candidate culling
    terrain_rows: int = 0            # rows solver: keep only the top-k valid
                                     # terrain constraint rows per body
                                     # (0 = one row per (slot, triangle))
    terrain_bp: str = "dense"        # "dense": test every (body, triangle);
                                     # "grid": cull faces via the world's
                                     # MeshGrid (mesh.rs:121 BVH::query
                                     # equivalent) to terrain_cand per body
    terrain_cand: int = 8            # candidate faces per body ("grid")
    terrain_grid_cfg: GridConfig = None  # face-table geometry ("grid";
                                     # must match make_world's
                                     # terrain_grid_cfg)
    profile_stage: str = ""          # "": full step.  Otherwise stop the
                                     # pipeline after the named stage and
                                     # return a probe scalar — keeps stage
                                     # attribution in scripts/
                                     # profile_stress.py in sync with the
                                     # real pipeline (static, so each
                                     # stage is its own jit cache entry)
    bp_margin: float = 0.0           # > 0: cache the candidate pair list
                                     # across steps, built with this much
                                     # extra fat, and rebuild only when a
                                     # body drifts > margin/2 from its
                                     # build anchor (fat-proxy refit
                                     # semantics, world.rs:233-238); the
                                     # world must carry init_bp_cache state
    bp_every: int = 1                # > 1: rebuild the candidate list only
                                     # every bp_every-th step; off-steps
                                     # reuse the cache (narrowphase stays
                                     # exact — only the candidate SET is
                                     # stale).  Build slack covers the
                                     # skipped steps' motion per body
                                     # ((bp_every-1) * (2|delta| + 0.02):
                                     # an impulse can at most reverse the
                                     # approach, doubling the per-step
                                     # travel).  Amortizes the grid build +
                                     # cull + top-k — the dominant 100k
                                     # stage.  metrics[
                                     # "broadphase_cache_drift_excess"]
                                     # reports actual drift beyond the
                                     # slack (> 0 = a fast body outran the
                                     # cache; candidates may be missed).
                                     # Requires init_bp_cache state.
    warm_start: bool = False         # rows solver: persist accumulated
                                     # impulses across frames (matched by
                                     # (partner, slot/triangle) keys) and
                                     # re-apply them up front — a documented
                                     # stability extension (the reference
                                     # zeroes accumulators every frame,
                                     # solver.rs:101-192; SURVEY §7.7)
    pallas_solver: bool = False      # iso rows path (fused_iso, single-
                                     # phase, textbook friction): run each
                                     # outer iteration's inner sweeps as
                                     # the fused Pallas kernel
                                     # (ops/solver_sweep.py, Triton, GPU
                                     # only) — identical math; the (R, N)
                                     # constraint channels are read once
                                     # per OUTER iteration instead of once
                                     # per sweep
    solver_rows: int = 0             # rows solver: compact ALL constraint
                                     # rows (pairs + terrain) to the top-k
                                     # valid per body before the solve — the
                                     # per-sweep partner gather and impulse
                                     # math scale with the row count
                                     # (0 = keep every slot row)
    cap_manifold: str = "mid"        # capsule x capsule parallel-flank
                                     # contacts: "mid" = the reference's
                                     # single interval-midpoint contact
                                     # (collision.rs:1331-1354); "ends" =
                                     # documented EXTENSION emitting the
                                     # overlap interval's two endpoints in
                                     # the two manifold slots (and relaxing
                                     # the pruner's proximity merge so
                                     # small-capsule endpoint pairs
                                     # survive) — parallel capsule stacks
                                     # rock on one-point manifolds
    stable_pairs: bool = False       # sort the candidate partner list (and
                                     # the terrain candidate list) by index
                                     # so row ORDER is deterministic while
                                     # the partner SET is unchanged — the
                                     # prerequisite for warm_match="pos".
                                     # Also drops duplicate partners (grid
                                     # modulus aliasing can bin the same
                                     # body twice)
    warm_match: str = "search"       # how warm-start rows are matched to
                                     # the previous frame's:
                                     # "search": full (R, R_prev, N)
                                     #   (partner, key2) key search + a
                                     #   matched-row accumulator gather
                                     #   (order-robust, ~R*N gather cost);
                                     # "pos": positional — a row warms only
                                     #   if the SAME slot held the same
                                     #   (partner, key2) last frame (zero
                                     #   gathers; pair with stable_pairs,
                                     #   which makes slots stable whenever
                                     #   the partner set is unchanged)
    warm_gamma: float = 1.0          # scale the matched warm-start
                                     # transfer (pre-apply AND accumulator
                                     # seed) by this factor.  1.0 = classic
                                     # full warm starting.  < 1 damps the
                                     # measured capsule-pile agitation
                                     # loop: full-gain warm pre-apply x
                                     # sliding capsule contact points holds
                                     # a self-sustaining agitated state
                                     # (mean |v| 1.39 where cold GS and the
                                     # f64 oracle settle to 0.17-0.23);
                                     # gamma 0.8 settles it to 0.27 with
                                     # warm convergence intact (PERF.md
                                     # "r5 mixed-quality root cause").
                                     # Applied once at match time, before
                                     # the split-solve block partition
    adapt_schedule: tuple = None     # (hit_frac, iters, inner): adaptive
                                     # solver schedule.  With warm_start,
                                     # when the fraction of valid rows
                                     # warm-matched from the previous
                                     # frame reaches hit_frac (the pile is
                                     # settled and convergence is
                                     # amortized), solve with iters x
                                     # inner sweeps instead of
                                     # solver_iters x solver_inner.  The
                                     # full schedule always runs during
                                     # transients (collapse needs more
                                     # partner-term refreshes per step);
                                     # metrics["warm_hit_frac"] records
                                     # the trigger signal
    n_sphere_rows: int = -1          # mixed mode: bodies [0, n_sphere_rows)
                                     # are spheres, the rest capsules
                                     # (SceneBuilder emits spheres first).
                                     # >= 0 enables the TYPE-PARTITIONED
                                     # narrowphase: the self-side kernel is
                                     # selected statically per column
                                     # block, so each pair evaluates 2
                                     # type kernels instead of 4 and the
                                     # expensive 4-stage triangle x capsule
                                     # terrain routine runs only on the
                                     # capsule block.  Identical contacts;
                                     # rows solver + culled/absent terrain
                                     # only (-1 = generic 4-kernel path)
    light_metrics: bool = False      # skip the heavyweight observability
                                     # reductions (reach/span excess,
                                     # max_penetration, num_pairs/contacts,
                                     # solver_dv_norm — the step's
                                     # metrics "tail" at 100k); the
                                     # skipped keys return 0 with the same
                                     # dtypes.  warm_hit_frac, overflow and
                                     # the bp staleness machinery (physics-
                                     # relevant) always run.  Meant for the
                                     # interior steps of a scanned chunk —
                                     # driver.make_chunk_step(light=True)
                                     # runs the chunk's LAST step with full
                                     # metrics so quality guards stay
                                     # observable every chunk
    bias_max: float = -1.0           # >= 0: clamp the Baumgarte position-
                                     # correction bias VELOCITY (the
                                     # restitution term is never clamped).
                                     # Documented stability EXTENSION
                                     # (solver.contact_bias): the
                                     # reference's unclamped beta/dt * pen
                                     # converts deep penetration into real
                                     # outgoing velocity (~12x pen at
                                     # dt=1/60), a measured self-
                                     # sustaining agitation loop in
                                     # capsule piles (pops re-trigger the
                                     # restitution threshold).  -1 =
                                     # reference semantics
    fused_iso: bool = False          # spheres+rows+warm_start fast path:
                                     # ONE wide partner gather at
                                     # narrowphase time feeds contact test
                                     # AND constraint precompute (with
                                     # PREVIOUS-frame mass-splitting
                                     # counts); terrain constraint rows
                                     # skip partner gathers entirely
                                     # (static body is known), including
                                     # inside every solver sweep.
                                     # Requires solver_rows == 0


class BpCache(NamedTuple):
    """Cached broadphase candidate list + the positions it was built at.

    The device-side analog of the reference's fat proxies (world.rs:233-238 +
    ``bounds + 0.25``, world.rs:181): candidates built with an extra
    ``cfg.bp_margin`` of slack stay CONSERVATIVE until some body drifts
    more than margin/2 from its anchor, so settled scenes skip the grid
    build + candidate cull entirely on most steps."""
    partner: jnp.ndarray   # (N, K) int32
    ok: jnp.ndarray        # (N, K) bool
    anchor: Vec3           # positions at build time (end-of-sweep)
    overflow: jnp.ndarray  # () int32 from the build
    count: jnp.ndarray     # () int32 steps since init (cfg.bp_every cadence)
    slack: jnp.ndarray     # (N,) float32 per-body extra fat at build time
    r_build: jnp.ndarray = None  # (N,) float32 swept fat radius at build
                                 # time (staleness accounting: a body whose
                                 # CURRENT reach grew past its build reach
                                 # consumes slack even without drifting)


class SolverWarm(NamedTuple):
    """Previous frame's constraint rows + accumulated impulses, for
    cfg.warm_start (rows matched by (partner, slot-or-triangle) key)."""
    partner: jnp.ndarray   # (R, N) int32
    key2: jnp.ndarray      # (R, N) int32: pair slot id / terrain tri id
    acc_n: jnp.ndarray     # (R, N) float32
    acc_t1: jnp.ndarray
    acc_t2: jnp.ndarray


class World(NamedTuple):
    """Dynamic world state pytree."""
    bodies: RigidBodyState
    terrain: Triangle        # triangle soup in world space, Vec3 (T,)
    terrain_center: Vec3
    terrain_grid: jnp.ndarray = None  # (dim^3, 4*cap) float face table for
                                      # cfg.terrain_bp == "grid", rows
                                      # [fid*cap | cx*cap | cy*cap |
                                      # cz*cap] (face id + centroid; built
                                      # by make_world(terrain_grid_cfg=…))
    warm: SolverWarm = None           # cfg.warm_start state (init_warm)
    bp: BpCache = None                # cfg.bp_margin state (init_bp_cache)


def solver_row_count(cfg: WorldConfig, n_tris: int) -> int:
    """The rows solver's row count R for a config (must mirror step())."""
    n_slots = 1 if cfg.shape_mode == "spheres" else 2
    r = n_slots * cfg.max_pairs
    if n_tris > 0:
        t_width = (cfg.terrain_cand if cfg.terrain_bp in ("grid", "near")
                   else n_tris)
        t_rows = n_slots * t_width
        if cfg.terrain_rows and t_rows > cfg.terrain_rows:
            t_rows = cfg.terrain_rows
        r += t_rows
    if cfg.solver_rows and r > cfg.solver_rows:
        r = cfg.solver_rows
    return r


def init_bp_cache(world: World, cfg: WorldConfig) -> World:
    """Attach an (invalid) broadphase cache; the first step rebuilds."""
    n = world.bodies.n_bodies
    return world._replace(bp=BpCache(
        partner=jnp.full((n, cfg.max_pairs), -1, jnp.int32),
        ok=jnp.zeros((n, cfg.max_pairs), bool),
        anchor=Vec3(jnp.full((n,), 1.0e9), jnp.full((n,), 1.0e9),
                    jnp.full((n,), 1.0e9)),
        overflow=jnp.int32(0),
        count=jnp.int32(0),
        slack=jnp.zeros((n,), jnp.float32),
        r_build=jnp.zeros((n,), jnp.float32)))


def init_warm(world: World, cfg: WorldConfig) -> World:
    """Attach a zeroed warm-start state so the step's jit signature is
    stable from the first call (cfg.warm_start scenes)."""
    n = world.bodies.n_bodies
    R = solver_row_count(cfg, world.terrain.a.x.shape[0])
    z = jnp.zeros((R, n), jnp.float32)
    none = jnp.full((R, n), -9, jnp.int32)
    return world._replace(warm=SolverWarm(partner=none, key2=none,
                                          acc_n=z, acc_t1=z, acc_t2=z))


def make_world(bodies: RigidBodyState, terrain_verts=None, terrain_faces=None,
               terrain_center=(0.0, 0.0, 0.0),
               terrain_grid_cfg: GridConfig = None) -> World:
    """Assemble a world; terrain given as (V, 3) vertices + (T, 3) faces.

    ``terrain_grid_cfg`` builds a static face cell table for the "grid"
    terrain broadphase (large meshes); each face is binned into every cell
    its AABB overlaps (for faces up to one cell in extent), so the +-1-cell
    query window only has to cover the BODY's reach (shape radius + half
    height + sweep) — keep cell_size >= both the largest face radius and
    the largest body reach.  The step emits ``terrain_reach_excess``
    (max body reach minus cell_size, clamped at 0) so a violation is
    observable, mirroring ``broadphase_reach_excess``.
    """
    grid_table = None
    if terrain_verts is None:
        z = jnp.zeros((0,), jnp.float32)
        v0 = Vec3(z, z, z)
        tri = Triangle(a=v0, b=v0, c=v0)
    else:
        tv = np.asarray(terrain_verts, np.float32)
        tf = np.asarray(terrain_faces, np.int32)
        tri = Triangle(a=vfrom(jnp.asarray(tv[tf[:, 0]])),
                       b=vfrom(jnp.asarray(tv[tf[:, 1]])),
                       c=vfrom(jnp.asarray(tv[tf[:, 2]])))
        if terrain_grid_cfg is not None:
            from mgf_tpu.mesh import build_mesh_grid, mesh_from_arrays
            mg = build_mesh_grid(mesh_from_arrays(tv, tf),
                                 terrain_grid_cfg.cell_size,
                                 terrain_grid_cfg.dim,
                                 terrain_grid_cfg.bucket_cap)
            # component-blocked float rows [fid*cap | cx*cap | cy*cap |
            # cz*cap]: the face CENTROID rides the window gather, so the
            # cull's distance scoring needs no per-candidate gather
            # (three (N, 27*cap) centroid gathers were most of the
            # terrain stage on the engine's first accelerator)
            ids = np.asarray(mg.table)                       # (C, cap)
            cent = tv[tf[:, 0]] / 3 + tv[tf[:, 1]] / 3 + tv[tf[:, 2]] / 3
            safe = np.maximum(ids, 0)
            okm = ids >= 0
            comp = [np.where(okm, ids, -1).astype(np.float32),
                    np.where(okm, cent[safe, 0], 0).astype(np.float32),
                    np.where(okm, cent[safe, 1], 0).astype(np.float32),
                    np.where(okm, cent[safe, 2], 0).astype(np.float32)]
            grid_table = jnp.asarray(np.concatenate(comp, axis=1))
    return World(bodies=bodies, terrain=tri,
                 terrain_center=vfrom(jnp.asarray(terrain_center,
                                                  jnp.float32)),
                 terrain_grid=grid_table)


def _stable_sort_pairs(partner, pair_ok):
    """Canonical slot order: sort each body's partner list by index
    (invalid slots to the end) and mask duplicate partners (modulus
    aliasing can bin one body into two windows).  The partner
    SET is unchanged; slot positions become deterministic."""
    big = jnp.int32(1 << 28)
    p_s = jnp.sort(jnp.where(pair_ok, partner, big), axis=1)
    dup = jnp.concatenate(
        [jnp.zeros((p_s.shape[0], 1), bool), p_s[:, 1:] == p_s[:, :-1]],
        axis=1)
    ok = (p_s < big) & ~dup
    return jnp.where(ok, p_s, -1), ok


# ---------------------------------------------------------------------------
# narrowphase dispatch over the flattened pair list
# ---------------------------------------------------------------------------

class ShapeView(NamedTuple):
    """The slice of body state the narrowphase reads.  In the sharded step
    this is assembled from all-gathered (global) arrays."""
    x: Vec3
    q: Quat
    delta: Vec3
    shape_type: jnp.ndarray
    shape_r: jnp.ndarray
    shape_half_h: jnp.ndarray


def shape_view(state: RigidBodyState) -> ShapeView:
    return ShapeView(x=state.x, q=state.q, delta=state.delta,
                     shape_type=state.shape_type, shape_r=state.shape_r,
                     shape_half_h=state.shape_half_h)


class PackedShapes(NamedTuple):
    """Per-body shape data packed for single wide gathers (gathers cost
    per index: fetching one 8-wide row beats eight scalar gathers).
    ``p8`` carries 12 columns in capsule/mixed modes — the quaternion
    rides the same row so the capsule frame costs no second gather."""
    p8: jnp.ndarray          # (N, 8|12): x y z dx dy dz r half_h [q wxyz]
    shape_type: jnp.ndarray  # (N,)


class GatheredShapes(NamedTuple):
    """One side of a pair batch after the gather."""
    x: Vec3
    delta: Vec3
    sphere: Sphere
    capsule: Capsule
    shape_type: jnp.ndarray


def pack_shapes(sv: ShapeView) -> PackedShapes:
    cols = [sv.x.x, sv.x.y, sv.x.z,
            sv.delta.x, sv.delta.y, sv.delta.z,
            sv.shape_r, sv.shape_half_h,
            # the quaternion (and shape type, col 12) ride the same row so
            # capsule/mixed partner fetches cost ONE gather, not two
            sv.q.w, sv.q.x, sv.q.y, sv.q.z,
            sv.shape_type.astype(jnp.float32)]
    return PackedShapes(p8=jnp.stack(cols, axis=-1),
                        shape_type=sv.shape_type)


def self_shapes(cfg: WorldConfig, sv: ShapeView, width: int,
                flat: bool = False) -> GatheredShapes:
    """The SELF side of a slot-major pair batch without any gather: every
    slot row reads the same (N,) body arrays, so a [None, :] broadcast
    (or broadcast+reshape for the flat (K*N,) layout) replaces the
    p8[iota] gather — the iota indices are a real gathered fetch that
    XLA does not fold away."""
    from mgf_tpu.math3d import qrotate
    if flat:
        exp = lambda a: jnp.broadcast_to(
            a[None, :], (width, a.shape[0])).reshape(-1)
    else:
        exp = lambda a: a[None, :]
    x = Vec3(exp(sv.x.x), exp(sv.x.y), exp(sv.x.z))
    delta = Vec3(exp(sv.delta.x), exp(sv.delta.y), exp(sv.delta.z))
    r = exp(sv.shape_r)
    sphere = Sphere(c=x, r=r)
    if cfg.shape_mode == "spheres":
        z = r * 0
        capsule = Capsule(a=x, d=Vec3(z, z, z), r=r)
        stype = jnp.zeros_like(r, dtype=sv.shape_type.dtype)
    else:
        hh = exp(sv.shape_half_h)
        zero = jnp.zeros_like(hh)
        q = Quat(exp(sv.q.w), exp(sv.q.x), exp(sv.q.y), exp(sv.q.z))
        d_half = qrotate(q, Vec3(zero, hh, zero))
        capsule = Capsule(a=x - d_half, d=d_half * 2.0, r=r)
        stype = (exp(sv.shape_type) if cfg.shape_mode == "mixed"
                 else jnp.ones_like(r, dtype=sv.shape_type.dtype))
    return GatheredShapes(x=x, delta=delta, sphere=sphere, capsule=capsule,
                          shape_type=stype)


def gather_shapes(cfg: WorldConfig, ps: PackedShapes, idx) -> GatheredShapes:
    from mgf_tpu.math3d import Quat, qrotate
    g = ps.p8[idx]
    x = Vec3(g[..., 0], g[..., 1], g[..., 2])
    delta = Vec3(g[..., 3], g[..., 4], g[..., 5])
    r = g[..., 6]
    sphere = Sphere(c=x, r=r)
    if cfg.shape_mode == "spheres":
        capsule = Capsule(a=x, d=Vec3(r * 0, r * 0, r * 0), r=r)
        stype = jnp.zeros_like(idx)
    else:
        hh = g[..., 7]
        zero = jnp.zeros_like(hh)
        d_half = qrotate(Quat(g[..., 8], g[..., 9], g[..., 10], g[..., 11]),
                         Vec3(zero, hh, zero))
        capsule = Capsule(a=x - d_half, d=d_half * 2.0, r=r)
        stype = (g[..., 12].astype(jnp.int32)
                 if cfg.shape_mode == "mixed" else jnp.ones_like(idx))
    return GatheredShapes(x=x, delta=delta, sphere=sphere, capsule=capsule,
                          shape_type=stype)


def manifold_prox_sq(cfg: WorldConfig) -> float:
    """Pruner proximity-merge threshold for this config: the reference
    value, or a tight one under the "ends" capsule-manifold extension so
    intentional endpoint pairs (< sqrt(0.5) apart on small capsules)
    survive the merge (see manifold.prune)."""
    from mgf_tpu.manifold import PERSISTENT_THRESHOLD_SQ
    return 1.0e-4 if cfg.cap_manifold == "ends" else PERSISTENT_THRESHOLD_SQ


def _pair_contact(cfg: WorldConfig, ga: GatheredShapes,
                  gb: GatheredShapes) -> Contact:
    """Contact slots (2, P) for body pairs (receiver a, argument b), natively
    batched.  Receiver/argument matches the reference's loop: the outer body
    collides against its broadphase partners (world.rs:260-275)."""
    def two_slot(c: Contact) -> Contact:
        return contact_stack([c, c._replace(valid=jnp.zeros_like(c.valid))])

    ends = cfg.cap_manifold == "ends"
    cc_fn = functools.partial(contact_capsule_moving_capsule, ends=ends)
    va, vb = ga.delta, gb.delta
    if cfg.shape_mode == "spheres":
        # sphere pairs emit exactly one contact — no second slot
        return contact_stack([contact_moving_moving(
            contact_sphere_moving_sphere, ga.sphere, va, gb.sphere, vb)])
    if cfg.shape_mode == "capsules":
        c_cc = contact_moving_moving(cc_fn, ga.capsule, va, gb.capsule, vb)
        return c_cc if ends else two_slot(c_cc)

    # mixed: evaluate all four type pairs, select by (type_a, type_b)
    c_ss = contact_moving_moving(contact_sphere_moving_sphere,
                                 ga.sphere, va, gb.sphere, vb)
    c_cc = contact_moving_moving(cc_fn, ga.capsule, va, gb.capsule, vb)
    c_cs = contact_moving_moving(contact_capsule_moving_sphere,
                                 ga.capsule, va, gb.sphere, vb)
    c_sc = contact_moving_moving(contact_sphere_moving_capsule,
                                 ga.sphere, va, gb.capsule, vb)
    both_s = (ga.shape_type == SHAPE_SPHERE) & (gb.shape_type == SHAPE_SPHERE)
    both_c = ((ga.shape_type == SHAPE_CAPSULE)
              & (gb.shape_type == SHAPE_CAPSULE))
    cap_sph = ((ga.shape_type == SHAPE_CAPSULE)
               & (gb.shape_type == SHAPE_SPHERE))
    if ends:
        cc0 = jax.tree_util.tree_map(lambda x: x[0], c_cc)
        cc1 = jax.tree_util.tree_map(lambda x: x[1], c_cc)
        s0 = contact_select(both_s, c_ss,
                            contact_select(both_c, cc0,
                                           contact_select(cap_sph, c_cs,
                                                          c_sc)))
        s1 = cc1._replace(valid=cc1.valid & both_c)
        return contact_stack([s0, s1])
    c = contact_select(both_s, c_ss,
                       contact_select(both_c, c_cc,
                                      contact_select(cap_sph, c_cs, c_sc)))
    return two_slot(c)


def _pair_contact_split(cfg: WorldConfig, ga: GatheredShapes,
                        gb: GatheredShapes, ns: int) -> Contact:
    """Mixed-mode pair narrowphase with bodies PARTITIONED by type along
    the lane (column) axis — spheres in columns [0, ns), capsules in
    [ns, N).  The self side's shape type is then static per block, so each
    pair evaluates TWO type kernels instead of four; contacts are
    bit-identical to :func:`_pair_contact`.  Requires 2-D slot-major
    (K, N) batches and type-sorted bodies (SceneBuilder emits spheres
    first)."""
    ends = cfg.cap_manifold == "ends"
    cc_fn = functools.partial(contact_capsule_moving_capsule, ends=ends)
    sl = lambda t, lo, hi: jax.tree_util.tree_map(
        lambda g: g[..., lo:hi], t)
    n = ga.sphere.r.shape[-1]
    two_slot = lambda c: contact_stack(
        [c, c._replace(valid=jnp.zeros_like(c.valid))])
    parts = []
    if ns > 0:
        a, b = sl(ga, 0, ns), sl(gb, 0, ns)
        va, vb = a.delta, b.delta
        c_ss = contact_moving_moving(contact_sphere_moving_sphere,
                                     a.sphere, va, b.sphere, vb)
        c_sc = contact_moving_moving(contact_sphere_moving_capsule,
                                     a.sphere, va, b.capsule, vb)
        part_sph = b.shape_type == SHAPE_SPHERE
        parts.append(two_slot(contact_select(part_sph, c_ss, c_sc)))
    if ns < n:
        a, b = sl(ga, ns, n), sl(gb, ns, n)
        va, vb = a.delta, b.delta
        c_cs = contact_moving_moving(contact_capsule_moving_sphere,
                                     a.capsule, va, b.sphere, vb)
        c_cc = contact_moving_moving(cc_fn, a.capsule, va, b.capsule, vb)
        part_sph = b.shape_type == SHAPE_SPHERE
        if ends:
            cc0 = jax.tree_util.tree_map(lambda x: x[0], c_cc)
            cc1 = jax.tree_util.tree_map(lambda x: x[1], c_cc)
            s0 = contact_select(part_sph, c_cs, cc0)
            s1 = cc1._replace(valid=cc1.valid & ~part_sph)
            parts.append(contact_stack([s0, s1]))
        else:
            parts.append(two_slot(contact_select(part_sph, c_cs, c_cc)))
    return jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs, axis=-1), *parts)


def _terrain_contact_split(cfg: WorldConfig, gt: GatheredShapes,
                           tri: Triangle, ns: int) -> Contact:
    """Type-partitioned terrain narrowphase: the expensive 4-stage
    triangle x capsule routine (collision.rs:693-1086) runs ONLY on the
    capsule column block; sphere columns get the cheap face/edge sphere
    test.  Bit-identical contacts to :func:`_terrain_contact`."""
    sl = lambda t, lo, hi: jax.tree_util.tree_map(
        lambda g: g[..., lo:hi], t)
    n = gt.sphere.r.shape[-1]
    parts = []
    if ns > 0:
        g, t_ = sl(gt, 0, ns), sl(tri, 0, ns)
        cs = contact_triangle_moving_sphere(t_, g.sphere, g.delta)
        parts.append(contact_stack(
            [cs, cs._replace(valid=jnp.zeros_like(cs.valid))]))
    if ns < n:
        g, t_ = sl(gt, ns, n), sl(tri, ns, n)
        parts.append(contact_triangle_moving_capsule(t_, g.capsule,
                                                     g.delta))
    out = jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs, axis=-1), *parts)
    return contact_neg(out)


def _terrain_contact(cfg: WorldConfig, gt: GatheredShapes,
                     tri: Triangle) -> Contact:
    """Contact slots (2, P) for (triangle, body) pairs, flipped so the BODY
    is side "a" — the mesh double-flip chain (mesh.rs:127-134 then
    compound.rs:186-188 via collision.rs:1490-1506) nets out to a = body
    point, b = terrain point, n = -triangle_normal."""
    v = gt.delta
    if cfg.shape_mode == "spheres":
        out = contact_stack([contact_triangle_moving_sphere(tri, gt.sphere,
                                                            v)])
    elif cfg.shape_mode == "capsules":
        out = contact_triangle_moving_capsule(tri, gt.capsule, v)
    else:
        cs = contact_triangle_moving_sphere(tri, gt.sphere, v)
        cs2 = contact_stack([cs, cs._replace(
            valid=jnp.zeros_like(cs.valid))])
        cc = contact_triangle_moving_capsule(tri, gt.capsule, v)
        is_sph = gt.shape_type == SHAPE_SPHERE
        out = contact_select(is_sph, cs2, cc)
    return contact_neg(out)


def _body_bounds(cfg: WorldConfig, sv) -> AABB:
    spheres, capsules = colliders(sv)
    if cfg.shape_mode == "spheres":
        return sphere_aabb(spheres)
    if cfg.shape_mode == "capsules":
        return capsule_aabb(capsules)
    sb = sphere_aabb(spheres)
    cb = capsule_aabb(capsules)
    is_sph = sv.shape_type == SHAPE_SPHERE
    return AABB(c=where_vec(is_sph, sb.c, cb.c),
                r=where_vec(is_sph, sb.r, cb.r))


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def step(world: World, cfg: WorldConfig, collect_contacts: bool = False):
    """One physics frame (World::step, world.rs:227-294). Jittable.
    Returns (new_world, metrics dict).

    ``collect_contacts`` (static) adds the raw narrowphase contact streams
    to the metrics dict (pair + terrain Contact batches with their index
    vectors) — the parity-oracle diffing hook (PARITY.md).

    With ``cfg.solver == "rows"`` (default) the pipeline is fully
    scatter-free: candidate pairs are kept in BOTH directions, every body
    owns a row of constraint slots, and the solver reduces impulses along
    rows (see solver.build_row_constraints/solve_rows).  The "parallel" /
    "sequential" modes use the flat single-direction constraint list
    (reference pair dedupe, world.rs:266-268).
    """
    state = complete_motion(world.bodies)
    state = integrate(state, cfg.dt, iso=cfg.shape_mode == "spheres")
    n = state.n_bodies
    n_tris = world.terrain.a.x.shape[0]
    sv = shape_view(state)
    rows_form = cfg.solver == "rows"

    # ---- broadphase (replaces fat-proxy BVH refit + query) ----
    # dead rows (capacity padding / killed bodies, shape_r <= 0) are
    # excluded from the grid table and from every observability metric
    alive = state.shape_r > 0.0
    bounds = broadphase.swept_fat_bounds(_body_bounds(cfg, sv), state.delta,
                                         cfg.fatten)
    # reach observability: the grid window only guarantees
    # coverage for pair reach <= cell_size ("27"/packed) or cell_size/2
    # ("sel8"); the worst pair reach is the sum of the two largest swept
    # fat radii.  Positive excess means fast movers may exceed the window
    # and silently miss pairs.
    r_eff = jnp.where(alive, jnp.maximum(
        bounds.r.x, jnp.maximum(bounds.r.y, bounds.r.z)), 0.0)
    light = cfg.light_metrics
    # top-2 via two max passes (two reductions instead of a lax.top_k
    # over 100k for a 2-element result)
    if n >= 2 and not light:
        m1 = jnp.max(r_eff)
        m2 = jnp.maximum(jnp.max(jnp.where(r_eff < m1, r_eff, -jnp.inf)),
                         0.0)
        top2sum = jnp.where(jnp.sum(r_eff == m1) >= 2, 2.0 * m1, m1 + m2)
    else:
        top2sum = jnp.float32(0.0)
    guarantee = (cfg.grid.cell_size
                 * (0.5 if cfg.broadphase in ("fat8", "fat8x4") else 1.0))
    fat_modes = ("fat", "fat8", "fat8x4", "fat27x4")
    reach_excess = (jnp.maximum(top2sum - guarantee, 0.0)
                    if cfg.use_grid and not light else jnp.float32(0.0))
    # modulus-aliasing observability: if the scene span exceeds the grid
    # modulus (dim_axis * cell, PER AXIS since dims may differ), distinct
    # OCCUPIED cells collide in the table and buckets overflow silently
    # (this bit r2's first 100k sweep).
    gdims = broadphase.grid_dims(cfg.grid)
    span = lambda c: (jnp.max(jnp.where(alive, c, -jnp.inf))
                      - jnp.min(jnp.where(alive, c, jnp.inf)))
    span_excess = (jnp.maximum(jnp.maximum(jnp.maximum(
        span(bounds.c.x) / (gdims[0] * cfg.grid.cell_size),
        span(bounds.c.y) / (gdims[1] * cfg.grid.cell_size)),
        span(bounds.c.z) / (gdims[2] * cfg.grid.cell_size))
        - 1.0, 0.0) if cfg.use_grid and not light else jnp.float32(0.0))
    if cfg.profile_stage == "integrate":
        return world, {"probe": jnp.sum(bounds.c.x)}
    new_bp = world.bp
    if cfg.use_grid and cfg.broadphase in fat_modes:
        use_cache = ((cfg.bp_margin > 0.0 or cfg.bp_every > 1)
                     and world.bp is not None)

        def build_pairs(bnds):
            grid = broadphase.build_fat_grid(
                bnds, cfg.grid,
                width=4 if cfg.broadphase in ("fat8x4", "fat27x4") else 8,
                valid=alive)
            partner, pair_ok = broadphase.fat_grid_pairs(
                bnds, grid, cfg.grid, cfg.max_pairs,
                ordered=not rows_form,
                window=("sel8" if cfg.broadphase in ("fat8", "fat8x4")
                        else "27"))
            if cfg.stable_pairs:
                # canonicalize INSIDE the build so cached lists are stored
                # sorted — reuse steps then skip the per-step (N, K) sort
                partner, pair_ok = _stable_sort_pairs(partner, pair_ok)
            return partner, pair_ok, grid.overflow

        if use_cache:
            x_end = state.x + state.delta
            drift2 = magnitude2(x_end - world.bp.anchor)
            if cfg.bp_every > 1:
                # fixed-cadence amortization: rebuild every bp_every-th
                # step.  Desired build slack per body covers the skipped
                # steps' worst-case motion (an impulse can at most reverse
                # the approach, doubling per-step travel, plus slop for
                # gravity/solver velocity growth) — but slack also
                # inflates the body's reach, and the bucket-window
                # guarantee (pair reach <= guarantee) must not degrade
                # below the ungated build's.  So slack is CLAMPED per
                # body to the window budget.  The cache is then kept
                # EXACTLY conservative by a staleness trigger (r4): a
                # reuse step is taken only while every live body's actual
                # drift from its build anchor — plus any growth of its
                # swept reach since the build — still fits the slack it
                # was built with.  Any body outrunning its slack forces a
                # rebuild THIS step (before the stale candidates would be
                # used), so reuse steps never miss pairs; transients
                # (collapse, fast movers) degrade gracefully to
                # rebuild-every-step with no worst-case counting gate.
                # (r3 gated on a worst-case n_clamped>32 count instead,
                # which tripped on settled jigglers and pinned the
                # cadence at 2.)
                dmag = jnp.sqrt(magnitude2(state.delta))
                desired = ((cfg.bp_every - 1)
                           * (2.0 * dmag + 0.02)).astype(jnp.float32)
                budget = jnp.maximum(0.5 * guarantee - r_eff, 0.0)
                slack = jnp.minimum(desired, budget)
                r_grow = jnp.maximum(r_eff - world.bp.r_build, 0.0)
                stale = jnp.max(jnp.where(
                    alive, jnp.sqrt(drift2) + r_grow - world.bp.slack,
                    0.0)) > 0.0
                need = (((world.bp.count % cfg.bp_every) == 0) | stale)
                if cfg.bp_margin > 0.0:   # drift safety net composes
                    need = need | (jnp.max(drift2)
                                   > (0.5 * cfg.bp_margin) ** 2)
                fat_bounds = broadphase.swept_fat_bounds(
                    _body_bounds(cfg, sv), state.delta,
                    cfg.fatten + cfg.bp_margin)
                fat_bounds = fat_bounds._replace(r=Vec3(
                    fat_bounds.r.x + slack, fat_bounds.r.y + slack,
                    fat_bounds.r.z + slack))
            else:
                # fat-proxy refit semantics: rebuild only when some body
                # drifted > margin/2 from the position the cache was
                # built at
                slack = jnp.full((n,), 0.5 * cfg.bp_margin, jnp.float32)
                need = jnp.max(drift2) > (0.5 * cfg.bp_margin) ** 2
                fat_bounds = broadphase.swept_fat_bounds(
                    _body_bounds(cfg, sv), state.delta,
                    cfg.fatten + cfg.bp_margin)

            def rebuild(_):
                p, ok, of = build_pairs(fat_bounds)
                return (p, ok, of, x_end.x, x_end.y, x_end.z, slack, r_eff)

            def reuse(_):
                b = world.bp
                return (b.partner, b.ok, b.overflow,
                        b.anchor.x, b.anchor.y, b.anchor.z, b.slack,
                        b.r_build)

            (partner, pair_ok, overflow, ax, ay, az, bslack,
             rbuild) = jax.lax.cond(need, rebuild, reuse, None)
            new_bp = BpCache(partner=partner, ok=pair_ok,
                             anchor=Vec3(ax, ay, az), overflow=overflow,
                             count=world.bp.count + 1, slack=bslack,
                             r_build=rbuild)
            # staleness observability: actual drift from the build anchor
            # beyond the per-body slack the cache was built with (> 0 =
            # some body outran the cache; candidates may be missed).
            # Zero on rebuild steps (the anchor is fresh).
            bp_drift_excess = jnp.where(need, 0.0, jnp.maximum(jnp.max(
                jnp.where(alive, jnp.sqrt(drift2) - bslack, 0.0)), 0.0))
            bp_rebuilt = need
        else:
            partner, pair_ok, overflow = build_pairs(bounds)
            bp_rebuilt = jnp.bool_(True)
            bp_drift_excess = jnp.float32(0.0)
    elif cfg.use_grid:
        table = broadphase.build_grid(bounds.c, cfg.grid, valid=alive)
        cand = broadphase.neighbor_candidates(bounds.c, table, cfg.grid)
        partner, pair_ok = broadphase.refine_pairs(
            bounds, cand, cfg.max_pairs, ordered=not rows_form)
        overflow = table.overflow
        bp_rebuilt = jnp.bool_(True)
        bp_drift_excess = jnp.float32(0.0)
    else:
        cand = broadphase.all_pairs_candidates(n)
        partner, pair_ok = broadphase.refine_pairs(
            bounds, cand, cfg.max_pairs, ordered=not rows_form)
        overflow = jnp.int32(0)
        bp_rebuilt = jnp.bool_(True)
        bp_drift_excess = jnp.float32(0.0)

    if cfg.stable_pairs and cfg.broadphase not in fat_modes:
        # fat-mode builds canonicalize inside build_pairs (so the cached
        # list is stored sorted); other paths canonicalize here
        partner, pair_ok = _stable_sort_pairs(partner, pair_ok)

    if cfg.profile_stage == "pairs":
        return world, {"probe": jnp.sum(partner) + jnp.sum(pair_ok)}

    # ---- body-body narrowphase over the flattened partner matrix ----
    # SLOT-MAJOR flattening ((K, N): slot k of every body, N minor):
    # the rows solver wants (slot, body) layout, so flattening this way
    # makes the row assembly below pure (free) reshapes — the row-major
    # form needed 17+ per-field (N, K) -> (K, N) transposes
    # fused iso fast path (cfg.fused_iso): spheres + rows solver + warm
    # start + no row compaction + culled terrain.  ONE wide partner gather
    # at narrowphase time carries shape fields AND every quantity the
    # constraint precompute needs; mass-splitting counts come from the
    # PREVIOUS frame (free from the warm state) instead of serializing
    # behind this frame's narrowphase.  All pair batches stay 2-D (K, N) so
    # the self side is a pure broadcast.
    fused = rows_form and cfg.fused_iso
    if cfg.fused_iso:
        if (cfg.shape_mode != "spheres" or not cfg.warm_start
                or cfg.solver_rows or not rows_form
                or (n_tris > 0 and cfg.terrain_bp not in ("near", "grid"))):
            raise ValueError(
                "cfg.fused_iso requires shape_mode='spheres', solver='rows',"
                " warm_start=True, solver_rows=0, and a culled terrain_bp")
    # type-partitioned mixed narrowphase (see cfg.n_sphere_rows): needs the
    # 2-D slot-major layout and a culled (or absent) terrain
    split_mixed = (rows_form and not fused and cfg.shape_mode == "mixed"
                   and cfg.n_sphere_rows >= 0
                   and (n_tris == 0 or cfg.terrain_bp in ("near", "grid")))
    two_d = fused or split_mixed

    K = partner.shape[1]
    partner_t = partner.T                          # (K, N) — 2 small
    pair_ok_t = pair_ok.T                          # transposes total
    rows = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[None, :],
                            (K, n)).reshape(-1)
    cols2 = jnp.where(pair_ok_t, partner_t, 0)
    cols = cols2.reshape(-1)

    if fused:
        from mgf_tpu.solver import PartnerFields
        cnt_prev = jnp.maximum(jnp.sum(
            (world.warm.partner != -9).astype(jnp.float32), axis=0), 1.0)
        pw = jnp.stack([
            sv.x.x, sv.x.y, sv.x.z,
            sv.delta.x, sv.delta.y, sv.delta.z, sv.shape_r,
            state.v.x, state.v.y, state.v.z,
            state.omega.x, state.omega.y, state.omega.z,
            state.restitution, state.friction, state.inv_mass,
            cnt_prev, state.inv_moment.xx], axis=-1)   # (N, 18)
        g18 = pw[cols2]                           # (K, N, 18) — THE gather
        gx = Vec3(g18[..., 0], g18[..., 1], g18[..., 2])
        gd = Vec3(g18[..., 3], g18[..., 4], g18[..., 5])
        gb = GatheredShapes(x=gx, delta=gd,
                            sphere=Sphere(c=gx, r=g18[..., 6]),
                            capsule=None, shape_type=None)
        exp = lambda a: a[None, :]
        gax = Vec3(exp(sv.x.x), exp(sv.x.y), exp(sv.x.z))
        gad = Vec3(exp(sv.delta.x), exp(sv.delta.y), exp(sv.delta.z))
        ga = GatheredShapes(x=gax, delta=gad,
                            sphere=Sphere(c=gax, r=exp(sv.shape_r)),
                            capsule=None, shape_type=None)
        pf = PartnerFields(
            x_end=gx + gd,
            v=Vec3(g18[..., 7], g18[..., 8], g18[..., 9]),
            omega=Vec3(g18[..., 10], g18[..., 11], g18[..., 12]),
            restitution=g18[..., 13], friction=g18[..., 14],
            inv_mass=g18[..., 15], count=g18[..., 16], iso=g18[..., 17])
        pair_valid = pair_ok_t                    # (K, N)
        ps = None
        pc = _pair_contact(cfg, ga, gb)           # slots (1, K, N)
    elif split_mixed:
        pair_valid = pair_ok_t                    # (K, N)
        ps = pack_shapes(sv)
        ga = self_shapes(cfg, sv, K)              # broadcast, no gather
        gb = gather_shapes(cfg, ps, cols2)
        pc = _pair_contact_split(cfg, ga, gb, cfg.n_sphere_rows)
    else:
        pair_valid = pair_ok_t.reshape(-1)
        ps = pack_shapes(sv)
        ga = self_shapes(cfg, sv, K, flat=True)   # broadcast, no gather
        gb = gather_shapes(cfg, ps, cols)
        pc = _pair_contact(cfg, ga, gb)                # slots (2, P)
    pc = pc._replace(valid=pc.valid & pair_valid[None])
    lc = LocalContact(
        local_a=pc.a - (ga.x + ga.delta * pc.t),
        local_b=pc.b - (gb.x + gb.delta * pc.t),
        contact=pc)
    n_slots = 1 if cfg.shape_mode == "spheres" else 2
    pair_manifold = prune(lc, max_contacts=n_slots,
                          prox_sq=manifold_prox_sq(cfg))
    if cfg.profile_stage == "narrow":
        return world, {"probe": jnp.sum(pair_manifold.valid)
                       + jnp.sum(pair_manifold.local_a.x)}

    def _deepest(c):
        """Max penetration depth over valid contacts ((ca-cb)·n > 0 when
        overlapping; solver.rs:140 sign convention)."""
        pen = dot(c.b - c.a, c.n)
        return jnp.max(jnp.where(c.valid, jnp.maximum(-pen, 0.0), 0.0))

    max_pen = jnp.float32(0.0) if light else _deepest(pc)

    # ---- terrain narrowphase ----
    # "dense": every (body, triangle) pair — exact for small terrains
    # (the demo box has 10 faces, world.rs:140-149).  "grid": candidate
    # faces from the static face cell table (the mesh BVH::query
    # equivalent, mesh.rs:121), top-terrain_cand by centroid distance.
    manifolds = [pair_manifold]
    idx_a = [rows]
    idx_b = [cols]
    t_reach_excess = jnp.float32(0.0)
    if n_tris > 0:
        if cfg.terrain_bp == "near":
            # dense AABB-distance cull: the body-to-face-AABB distance
            # lower-bounds the true distance, so keeping the terrain_cand
            # nearest faces within reach is conservative; the expensive
            # continuous contact math then runs on (N, terrain_cand)
            # instead of (N, T).  Right for small-to-mid T (walls/floors).
            ta = world.terrain
            tlo = [jnp.minimum(jnp.minimum(ta.a.x, ta.b.x), ta.c.x),
                   jnp.minimum(jnp.minimum(ta.a.y, ta.b.y), ta.c.y),
                   jnp.minimum(jnp.minimum(ta.a.z, ta.b.z), ta.c.z)]
            thi = [jnp.maximum(jnp.maximum(ta.a.x, ta.b.x), ta.c.x),
                   jnp.maximum(jnp.maximum(ta.a.y, ta.b.y), ta.c.y),
                   jnp.maximum(jnp.maximum(ta.a.z, ta.b.z), ta.c.z)]
            px = [state.x.x, state.x.y, state.x.z]
            d2 = jnp.zeros((n, n_tris), jnp.float32)
            for k in range(3):
                d_ax = jnp.maximum(
                    jnp.maximum(tlo[k][None, :] - px[k][:, None],
                                px[k][:, None] - thi[k][None, :]), 0.0)
                d2 = d2 + d_ax * d_ax
            reach = (state.shape_r + state.shape_half_h
                     + jnp.sqrt(magnitude2(state.delta)) + 0.1)
            score = jnp.where(d2 <= (reach * reach)[:, None], -d2, -jnp.inf)
            top, pick = jax.lax.top_k(score, cfg.terrain_cand)
            t_cand = pick.astype(jnp.int32)
            t_ok = jnp.isfinite(top)
            t_width = cfg.terrain_cand
        elif cfg.terrain_bp == "grid":
            tg = cfg.terrain_grid_cfg
            cap_t = world.terrain_grid.shape[1] // 4
            centers = state.x
            cc = lambda comp: jnp.floor(
                comp / tg.cell_size).astype(jnp.int32)
            cx, cy, cz = cc(centers.x), cc(centers.y), cc(centers.z)
            mmask = tg.dim - 1
            # the face table rows carry [fid | centroid xyz] component-
            # blocked (make_world), so the distance scoring rides the 27
            # window gathers — a per-candidate centroid gather here was
            # 3 x (N, 27*cap) indices, most of the terrain stage on the
            # engine's first accelerator.  Closeness and face id fuse into one int key
            # (14-bit quantized d2 | 17-bit fid) exactly like the pair
            # broadphase's fat_grid_pairs.
            d2_max = (3.0 * tg.cell_size) ** 2
            inv_scale = 16383.0 / d2_max
            keys = []
            for dx in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    for dz in (-1, 0, 1):
                        h = ((((cx + dx) & mmask) * tg.dim
                              + ((cy + dy) & mmask)) * tg.dim
                             + ((cz + dz) & mmask))
                        rows_t = world.terrain_grid[h]   # (N, 4*cap)
                        fid = rows_t[:, :cap_t]
                        dxc = rows_t[:, cap_t:2 * cap_t] \
                            - centers.x[:, None]
                        dyc = rows_t[:, 2 * cap_t:3 * cap_t] \
                            - centers.y[:, None]
                        dzc = rows_t[:, 3 * cap_t:4 * cap_t] \
                            - centers.z[:, None]
                        d2 = dxc * dxc + dyc * dyc + dzc * dzc
                        q = jnp.minimum((d2 * inv_scale).astype(jnp.int32),
                                        16383)
                        keys.append(jnp.where(
                            fid >= 0.0,
                            ((16383 - q) << 17) | fid.astype(jnp.int32),
                            -1))
            keym = jnp.concatenate(keys, axis=1)         # (N, 27*cap)
            # AABB binning duplicates a face across window cells;
            # duplicate keys are IDENTICAL (same fid, same d2) so they
            # come out of the top-k adjacent: over-select 4x, mask the
            # adjacent repeats, re-top-k to terrain_cand distinct faces.
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
            # window-coverage observability: the +-1-cell
            # query window guarantees candidates only while each body's
            # reach (radius + half height + sweep) <= cell_size — faces
            # themselves are covered at build time by AABB binning.  A
            # violation silently loses terrain contacts, so surface it
            # like broadphase_reach_excess.
            t_reach = (state.shape_r + state.shape_half_h
                       + jnp.sqrt(magnitude2(state.delta)))
            t_reach_excess = jnp.maximum(
                jnp.max(t_reach) - tg.cell_size, 0.0)
        else:
            t_width = n_tris
            t_rows = jnp.broadcast_to(
                jnp.arange(n, dtype=jnp.int32)[None, :],
                (n_tris, n)).reshape(-1)
            t_tris = jnp.broadcast_to(
                jnp.arange(n_tris, dtype=jnp.int32)[:, None],
                (n_tris, n)).reshape(-1)
            t_valid = None
        if cfg.terrain_bp in ("near", "grid"):
            if cfg.stable_pairs:
                # canonical candidate order by triangle index (+ dedupe:
                # grid-mode windows can bin one face twice) — stable slots
                # for warm_match="pos"
                tb = jnp.int32(1 << 28)
                tcs = jnp.sort(jnp.where(t_ok, t_cand, tb), axis=1)
                tdup = jnp.concatenate(
                    [jnp.zeros((tcs.shape[0], 1), bool),
                     tcs[:, 1:] == tcs[:, :-1]], axis=1)
                t_ok = (tcs < tb) & ~tdup
                t_cand = jnp.where(t_ok, tcs, 0)
            t_rows = jnp.broadcast_to(
                jnp.arange(n, dtype=jnp.int32)[None, :],
                (t_width, n)).reshape(-1)
            if two_d:
                t_tris = jnp.where(t_ok, t_cand, 0).T       # (T_w, N)
                t_valid = t_ok.T
            else:
                t_tris = jnp.where(t_ok, t_cand, 0).T.reshape(-1)
                t_valid = t_ok.T.reshape(-1)
            # t_tris is a REAL gather here (not a broadcast iota): fetch
            # all nine triangle components in one 12-wide row gather
            # instead of nine scalar ones (gather cost is per index)
            ta_ = world.terrain
            z9 = jnp.zeros_like(ta_.a.x)
            tpack = jnp.stack([ta_.a.x, ta_.a.y, ta_.a.z,
                               ta_.b.x, ta_.b.y, ta_.b.z,
                               ta_.c.x, ta_.c.y, ta_.c.z,
                               z9, z9, z9], axis=-1)     # (T, 12)
            gtri = tpack[t_tris]
            tri = Triangle(a=Vec3(gtri[..., 0], gtri[..., 1], gtri[..., 2]),
                           b=Vec3(gtri[..., 3], gtri[..., 4], gtri[..., 5]),
                           c=Vec3(gtri[..., 6], gtri[..., 7], gtri[..., 8]))
        else:
            tri = jax.tree_util.tree_map(lambda x: x[t_tris],
                                         world.terrain)
        if fused:
            gt = ga
        elif split_mixed:
            gt = self_shapes(cfg, sv, t_width)
        else:
            gt = self_shapes(cfg, sv, t_width, flat=True)
        tc = (_terrain_contact_split(cfg, gt, tri, cfg.n_sphere_rows)
              if split_mixed else _terrain_contact(cfg, gt, tri))
        if t_valid is not None:
            tc = tc._replace(valid=tc.valid & t_valid[None])
        t_lc = LocalContact(
            local_a=tc.a - (gt.x + gt.delta * tc.t),
            local_b=tc.b - world.terrain_center,
            contact=tc)
        # each terrain LocalContact is its own constraint (world.rs:240-253);
        # prune only merges a single (body,tri) pair's 2 slots (spheres emit
        # at most 1 contact per triangle - don't waste solver rows on slot 2)
        manifolds.append(prune(t_lc, max_contacts=n_slots,
                               prox_sq=manifold_prox_sq(cfg)))
        idx_a.append(t_rows)
        idx_b.append(jnp.full_like(t_rows, n))
        if not light:
            max_pen = jnp.maximum(max_pen, _deepest(tc))
    if cfg.profile_stage == "terrain":
        return world, {"probe": sum(jnp.sum(m_.valid) for m_ in manifolds)
                       + max_pen}

    # ---- extended body arrays: one virtual static row for the terrain ----
    srow = lambda g: jnp.concatenate(
        [g, jnp.zeros((1,) + g.shape[1:], g.dtype)], axis=0)
    srow_t = lambda t: jax.tree_util.tree_map(srow, t)
    bodies_ext = BodyView(
        x=jax.tree_util.tree_map(
            lambda g, c: jnp.concatenate([g, c[None]], axis=0),
            state.x + state.delta, world.terrain_center),
        v=srow_t(state.v),
        omega=srow_t(state.omega),
        restitution=srow(state.restitution),
        friction=srow(state.friction),   # Static{friction: 0.0}, world.rs:247
        inv_mass=srow(state.inv_mass),
        inv_moment=srow_t(state.inv_moment),
    )

    if rows_form:
        # ---- scatter-free row constraints ----
        # the pair lists were flattened SLOT-MAJOR ((width, N)), so
        # turning manifolds into solver rows is pure reshapes.

        def man_to_rows(man, width):
            """Manifold over P = width*n (slot-major) -> (S*width, n)."""
            S = man.valid.shape[0]
            slotf = lambda x: x.reshape(S * width, n)
            pairf = lambda x: jnp.broadcast_to(
                x.reshape(1, width, n), (S, width, n)).reshape(-1, n)
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
            jnp.where(pair_ok_t, partner_t, n).reshape(1, K, n),
            (S_pair, K, n)).reshape(-1, n)]
        # warm-start row keys: pair rows keyed by manifold slot id;
        # terrain rows keyed by triangle id (partner there is the static
        # row n, so the key spaces cannot collide)
        key2s = [jnp.broadcast_to(
            jnp.arange(S_pair, dtype=jnp.int32)[:, None, None],
            (S_pair, K, n)).reshape(-1, n)]
        if n_tris > 0:
            tman = man_to_rows(manifolds[1], t_width)    # (S*T, N)
            t_key2 = jnp.broadcast_to(
                t_tris.reshape(1, t_width, n),
                (n_slots, t_width, n)).reshape(-1, n).astype(jnp.int32)
            t_rows_n = tman.valid.shape[0]
            if cfg.terrain_rows and t_rows_n > cfg.terrain_rows:
                # a body touches at most a couple of terrain triangles, but
                # every (slot, triangle) pair costs a full-width solver row
                # (and a partner gather per sweep).  Keep only the top-k
                # valid rows per body — identical physics whenever <= k
                # triangle contacts exist, and a solver gather that scales
                # with k, not the terrain size.
                kk = cfg.terrain_rows
                score = (tman.valid.astype(jnp.float32)
                         * (2.0 - tman.time))            # valid + earlier first
                _, t_idx = jax.lax.top_k(score.T, kk)    # (N, kk)
                sel = lambda f: jnp.take_along_axis(f, t_idx.T, axis=0)
                tman = jax.tree_util.tree_map(sel, tman)
                t_key2 = sel(t_key2)
                t_rows_n = kk
            blocks.append(tman)
            partners.append(jnp.full((t_rows_n, n), n,
                                     jnp.int32))
            key2s.append(t_key2)

        man_rows = jax.tree_util.tree_map(
            lambda *xs: jnp.concatenate(xs, axis=0), *blocks)
        partner_rows = jnp.concatenate(partners, axis=0)
        key2_rows = jnp.concatenate(key2s, axis=0)

        rows_dropped = jnp.int32(0)
        if cfg.solver_rows and man_rows.valid.shape[0] > cfg.solver_rows:
            # compact to the top-k valid rows per body (earliest TOI first):
            # identical physics whenever a body has <= k contacts; beyond
            # that the latest-TOI rows are dropped (counted in metrics).
            # All 19 per-row fields ride in ONE packed (R0, N, 20) array so
            # the selection is a single wide-row gather, not 19 scalar ones
            # (body indices < 2^24 are exact in f32).
            kk = cfg.solver_rows
            n_valid = jnp.sum(man_rows.valid, axis=0)
            score = (man_rows.valid.astype(jnp.float32)
                     * (2.0 - jnp.clip(man_rows.time, 0.0, 1.0)))
            m = man_rows
            packed = jnp.stack([
                m.time, m.normal.x, m.normal.y, m.normal.z,
                m.t1.x, m.t1.y, m.t1.z, m.t2.x, m.t2.y, m.t2.z,
                m.local_a.x, m.local_a.y, m.local_a.z,
                m.local_b.x, m.local_b.y, m.local_b.z,
                m.valid.astype(jnp.float32),
                partner_rows.astype(jnp.float32),
                key2_rows.astype(jnp.float32),
                jnp.zeros_like(m.time)], axis=-1)       # (R0, N, 20)
            _, r_idx = jax.lax.top_k(score.T, kk)        # (N, kk)
            g = jnp.take_along_axis(packed, r_idx.T[:, :, None], axis=0)
            man_rows = Manifold(
                time=g[..., 0],
                normal=Vec3(g[..., 1], g[..., 2], g[..., 3]),
                t1=Vec3(g[..., 4], g[..., 5], g[..., 6]),
                t2=Vec3(g[..., 7], g[..., 8], g[..., 9]),
                local_a=Vec3(g[..., 10], g[..., 11], g[..., 12]),
                local_b=Vec3(g[..., 13], g[..., 14], g[..., 15]),
                valid=g[..., 16] > 0.5)
            partner_rows = g[..., 17].astype(jnp.int32)
            key2_rows = g[..., 18].astype(jnp.int32)
            rows_dropped = jnp.sum(
                jnp.maximum(n_valid - kk, 0)).astype(jnp.int32)
        if cfg.profile_stage == "rows":
            return world, {"probe": jnp.sum(man_rows.valid)
                           + jnp.sum(partner_rows)}

        # spheres: the world inverse inertia is isotropic (diag scalar) —
        # one 16-wide partner gather + scalar-inertia math replaces three
        # 8-wide gathers + Mat3 chains in the precompute and the sweeps
        iso_mode = cfg.shape_mode == "spheres"
        # TWO-BLOCK split (r4, mixed): bodies are type-sorted (spheres
        # [0, ns), capsules [ns, N)); sphere columns can never hold
        # slot-1 pair/terrain rows (spheres emit one contact per pair)
        # and their self inertia is a scalar, so BOTH the constraint
        # precompute and the solve run as: sphere block over its
        # K + terrain_cand live rows, then capsule block over all rows
        # with Mat3 inertia.  Row layout (man_to_rows): [pair slot0 K |
        # pair slot1 K | terrain slot0 C | terrain slot1 C].
        split_solve = (split_mixed and cfg.solver_rows == 0
                       and not cfg.terrain_rows and n_slots == 2)
        if split_solve:
            ns_b = cfg.n_sphere_rows
            C_t = t_width if n_tris > 0 else 0
            R0_b = man_rows.valid.shape[0]

            def rows_a(g):
                return jnp.concatenate(
                    [g[0:K, :ns_b], g[2 * K:2 * K + C_t, :ns_b]], axis=0)

            def rows_b(g):
                return g[:, ns_b:]
        if fused:
            # constraint precompute with ZERO gathers: pair-row partner
            # fields were fetched with the narrowphase gather; terrain rows
            # have the known static body as partner; mass-splitting counts
            # are last frame's (cnt_prev — carried in pf/self)
            n_pair_rows = S_pair * K
            bv = BodyView(x=state.x + state.delta, v=state.v,
                          omega=state.omega,
                          restitution=state.restitution,
                          friction=state.friction,
                          inv_mass=state.inv_mass,
                          inv_moment=state.inv_moment)
            from mgf_tpu.solver import build_row_constraints_iso_fused
            rc = build_row_constraints_iso_fused(
                bv, cnt_prev, pf, partner_rows, man_rows, cfg.dt,
                world.terrain_center, n_pair_rows,
                bias_max=cfg.bias_max)
            solver_inertia = state.inv_moment.xx
            pt0 = None
        elif iso_mode:
            # mass splitting: every contact of body i is in row i, so the
            # per-body count is a row reduction; partner counts ride the
            # constraint gather.
            counts = jnp.concatenate(
                [jnp.sum(man_rows.valid, axis=0).astype(jnp.float32),
                 jnp.ones((1,), jnp.float32)])
            counts = jnp.maximum(counts, 1.0)
            rc, pt0 = build_row_constraints_iso(
                bodies_ext, partner_rows, man_rows, cfg.dt, counts=counts,
                bias_max=cfg.bias_max)
            solver_inertia = bodies_ext.inv_moment.xx
        else:
            counts = jnp.concatenate(
                [jnp.sum(man_rows.valid, axis=0).astype(jnp.float32),
                 jnp.ones((1,), jnp.float32)])
            counts = jnp.maximum(counts, 1.0)
            if split_solve:
                # per-block precompute: the (rows x cols) product drops
                # ~40% (spheres: K+C of 2K+2C rows) and the slot-1 dead
                # rows of sphere columns are never built at all
                tA = lambda t: jax.tree_util.tree_map(rows_a, t)
                tB = lambda t: jax.tree_util.tree_map(rows_b, t)
                rc_a = build_row_constraints(
                    bodies_ext, rows_a(partner_rows), tA(man_rows),
                    cfg.dt, counts=counts, bias_max=cfg.bias_max)
                rc_b = build_row_constraints(
                    bodies_ext, rows_b(partner_rows), tB(man_rows),
                    cfg.dt, counts=counts, col_offset=ns_b,
                    bias_max=cfg.bias_max)
                rc = None
            else:
                rc = build_row_constraints(bodies_ext, partner_rows,
                                           man_rows, cfg.dt, counts=counts,
                                           bias_max=cfg.bias_max)
            solver_inertia = bodies_ext.inv_moment
            pt0 = None
        rc_valid = man_rows.valid    # == rc.valid on every build path
        if cfg.profile_stage == "constraints":
            if rc is None:
                return world, {"probe": jnp.sum(rc_a.bias)
                               + jnp.sum(rc_b.normal_mass)}
            return world, {"probe": jnp.sum(rc.bias)
                           + jnp.sum(rc.normal_mass)}
        warm = None
        matched = None
        if cfg.warm_start and world.warm is not None:
            def match_pos(_):
                # positional match: a row warms iff the SAME slot carried
                # the same (partner, key2) last frame — zero gathers, pure
                # elementwise.  Immune to the duplicate-key double-apply
                #.
                hit = ((partner_rows == world.warm.partner)
                       & (key2_rows == world.warm.key2))
                hf = hit.astype(jnp.float32)
                return (world.warm.acc_n * hf, world.warm.acc_t1 * hf,
                        world.warm.acc_t2 * hf, hit)

            def match_search(_):
                # full search: match rows by (partner, key2) key across all
                # previous slots; the three accumulators ride in one packed
                # array so the matched fetch is a single wide gather.
                # NOTE: the (R, R_prev, N) boolean intermediate
                # scales quadratically in row count — fine for compacted
                # configs, a memory hazard for uncompacted dense-terrain
                # ones.
                # r4: fuse (partner, key2) into ONE int32 when the ranges
                # fit (partner <= n < 2^17 incl. the static row, key2 =
                # slot id or triangle id < 2^14) — halves the eq tensor's
                # construction cost.  Injective, so equality is identical.
                kbit = 1 << 17
                key2_hi = max(n_tris, 8)
                if (n + 1) < kbit and key2_hi < (1 << 14):
                    k_now = key2_rows * kbit + partner_rows
                    k_prev = jnp.where(
                        world.warm.partner < 0, -9,
                        world.warm.key2 * kbit + world.warm.partner)
                    eq = k_now[:, None, :] == k_prev[None]
                else:
                    eq = ((partner_rows[:, None, :]
                           == world.warm.partner[None])
                          & (key2_rows[:, None, :]
                             == world.warm.key2[None]))
                # first-match one-hot contraction: replaces the (R, N)-index
                # matched-accumulator gather (per-index gather cost ~=
                # the whole solver sweep) with a static sum over the R_prev
                # slots — pure elementwise flops, no matrix product.  "first" keeps exact
                # first-match-wins semantics when duplicate keys exist
                # (possible without stable_pairs).
                first = eq & (jnp.cumsum(eq.astype(jnp.int8), axis=1) == 1)
                zn = jnp.zeros(partner_rows.shape, jnp.float32)
                wn, wt1, wt2 = zn, zn, zn
                for k in range(world.warm.partner.shape[0]):
                    mk = first[:, k, :].astype(jnp.float32)
                    wn = wn + mk * world.warm.acc_n[k][None]
                    wt1 = wt1 + mk * world.warm.acc_t1[k][None]
                    wt2 = wt2 + mk * world.warm.acc_t2[k][None]
                return wn, wt1, wt2, jnp.any(first, axis=1)

            if cfg.warm_match == "pos":
                wn, wt1, wt2, matched = match_pos(None)
            elif cfg.warm_match == "hybrid":
                # hybrid (r4): on cache-REUSE steps the pair partner rows
                # are bit-identical to the previous frame's (same cached
                # candidate list, same canonical sort), so positional
                # matching is exact for pair rows and the quadratic search
                # only runs on rebuild steps.  Terrain candidate slots are
                # recomputed per step and may shift on a reuse step (their
                # warm rows then restart cold for one frame) — warm origin
                # is a stability aid, not semantics, and warm_hit_frac
                # observes any loss.  Requires stable_pairs + a bp cache.
                if not cfg.stable_pairs:
                    raise ValueError(
                        "warm_match='hybrid' requires stable_pairs")
                wn, wt1, wt2, matched = jax.lax.cond(
                    bp_rebuilt, match_search, match_pos, None)
            else:
                wn, wt1, wt2, matched = match_search(None)
            if cfg.warm_gamma != 1.0:
                g = jnp.float32(cfg.warm_gamma)
                wn, wt1, wt2 = wn * g, wt1 * g, wt2 * g
            warm = (wn, wt1, wt2)
        if cfg.profile_stage == "warm":
            z = jnp.float32(0.0)
            return world, {"probe": (jnp.sum(warm[0]) + jnp.sum(warm[1])
                                     if warm is not None else z)
                           + jnp.sum(rc_valid)}
        # the fused path passes only the N live rows (terrain rows never
        # read the static row at all — n_gather_rows cuts them from the
        # per-sweep state gather)
        sv_in = ((state.v, state.omega, state.inv_mass) if fused
                 else (bodies_ext.v, bodies_ext.omega, bodies_ext.inv_mass))
        ngr = n_pair_rows if fused else None
        # fused Pallas inner sweeps: only on the iso scalar-inertia path
        # with the single-phase textbook sweep the kernel implements
        use_pk = (cfg.pallas_solver and fused and not cfg.two_phase
                  and cfg.friction_mode == "textbook")
        warm_hit_frac = jnp.float32(0.0)
        # split solve (see split_solve above): sphere block first (iso
        # self inertia, its live rows only), then the capsule block with
        # Mat3 — partner gathers read global state, so the sequential
        # order is a two-color Gauss-Seidel (capsules see solved sphere
        # velocities).
        if split_solve:
            iso_arr = bodies_ext.inv_moment.xx

            def split_warm(wtriple):
                if wtriple is None:
                    return None, None
                return (tuple(rows_a(w) for w in wtriple),
                        tuple(rows_b(w) for w in wtriple))

            warm_a, warm_b = split_warm(warm)

            def run_solve(it, inner):
                S1, acc_a = solve_rows(
                    rc_a, sv_in[0], sv_in[1], sv_in[2], iso_arr,
                    it, cfg.friction_mode, cfg.two_phase, inner,
                    warm=warm_a, return_acc=True, return_state=True)
                S2, acc_b = solve_rows(
                    rc_b, sv_in[0], sv_in[1], sv_in[2],
                    bodies_ext.inv_moment, it, cfg.friction_mode,
                    cfg.two_phase, inner, warm=warm_b, return_acc=True,
                    state0=S1, return_state=True, col_offset=ns_b)
                from mgf_tpu.solver import unpack_body_state
                v2, o2 = unpack_body_state(S2)
                accs = []
                for k in range(3):
                    a = jnp.zeros((R0_b, n), jnp.float32)
                    a = a.at[:, ns_b:].set(acc_b[k])
                    a = a.at[0:K, :ns_b].set(acc_a[k][0:K])
                    if C_t:
                        a = a.at[2 * K:2 * K + C_t, :ns_b].set(
                            acc_a[k][K:K + C_t])
                    accs.append(a)
                return v2, o2, tuple(accs)
        if cfg.warm_start:
            # NOTE: pt0 is NOT passed here — the warm pre-apply moves
            # partner velocities by full accumulated impulses, so a
            # pre-warm frozen term is too stale (measured: settled pile
            # max penetration 0.09 -> 0.34).  The reuse only pays on
            # cold solves.
            if not split_solve:
                def run_solve(it, inner):
                    return solve_rows(
                        rc, sv_in[0], sv_in[1], sv_in[2],
                        solver_inertia, it, cfg.friction_mode,
                        cfg.two_phase, inner, warm=warm,
                        return_acc=True, n_gather_rows=ngr,
                        pallas_inner=use_pk)

            if matched is not None:
                warm_hit_frac = (
                    jnp.sum((matched & rc_valid).astype(jnp.float32))
                    / jnp.maximum(jnp.sum(rc_valid.astype(jnp.float32)),
                                  1.0))
            if cfg.adapt_schedule is not None and matched is not None:
                # adaptive schedule: the warm-hit fraction ~1 means the
                # contact set persisted from last frame (settled pile,
                # convergence amortized across frames) — the cheap
                # schedule's fewer partner-term refreshes suffice.  Any
                # transient (falling bodies, new contacts) drops the hit
                # fraction and the full schedule runs.
                thr, it2, in2 = cfg.adapt_schedule
                v, omega, acc = jax.lax.cond(
                    warm_hit_frac >= thr,
                    lambda _: run_solve(int(it2), int(in2)),
                    lambda _: run_solve(cfg.solver_iters,
                                        cfg.solver_inner),
                    None)
            else:
                v, omega, acc = run_solve(cfg.solver_iters,
                                          cfg.solver_inner)
            new_warm = SolverWarm(partner=jnp.where(rc_valid, partner_rows,
                                                    -9),
                                  key2=key2_rows, acc_n=acc[0],
                                  acc_t1=acc[1], acc_t2=acc[2])
        elif split_solve:
            v, omega, _ = run_solve(cfg.solver_iters, cfg.solver_inner)
            new_warm = world.warm
        else:
            v, omega = solve_rows(rc, sv_in[0], sv_in[1], sv_in[2],
                                  solver_inertia,
                                  cfg.solver_iters, cfg.friction_mode,
                                  cfg.two_phase, cfg.solver_inner,
                                  partner_term0=pt0, n_gather_rows=ngr,
                                  pallas_inner=use_pk)
            new_warm = world.warm
        if cfg.profile_stage == "solve":
            # prefix ends at the solve output — the diff to the full step
            # attributes warm extraction + metrics tail
            return world, {"probe": jnp.sum(v.x) + jnp.sum(omega.x)}
        num_contacts = jnp.int32(0) if light else jnp.sum(rc_valid)
        num_constraints = rc_valid.size
        solver_rows_dropped = rows_dropped
    else:
        # ---- flat constraint list (reference single-direction form) ----
        def manifold_counts(man, ia, ib):
            pts = jnp.sum(man.valid, axis=0).astype(jnp.float32)
            ca = jax.ops.segment_sum(pts, ia, num_segments=n + 1)
            cb = jax.ops.segment_sum(pts, ib, num_segments=n + 1)
            return ca + cb

        counts = sum(manifold_counts(m, a, b)
                     for m, a, b in zip(manifolds, idx_a, idx_b))
        counts = jnp.maximum(counts, 1.0)
        use_split = cfg.solver == "parallel"

        cons = []
        for man, ia, ib in zip(manifolds, idx_a, idx_b):
            split_a = counts[ia] if use_split else None
            split_b = counts[ib] if use_split else None
            cons.append(build_constraints(bodies_ext, ia, ib, man, cfg.dt,
                                          split_a=split_a, split_b=split_b,
                                          bias_max=cfg.bias_max))
        con = jax.tree_util.tree_map(
            lambda *xs: jnp.concatenate(xs, axis=0), *cons)

        if cfg.solver == "parallel":
            v, omega = solve_parallel(con, bodies_ext, cfg.solver_iters,
                                      cfg.friction_mode)
        else:
            v, omega = solve_sequential(con, bodies_ext, cfg.solver_iters,
                                        cfg.friction_mode)
        num_contacts = jnp.sum(con.valid)
        num_constraints = con.valid.shape[0]
        solver_rows_dropped = jnp.int32(0)
        warm_hit_frac = jnp.float32(0.0)
        new_warm = world.warm

    trim = lambda t: jax.tree_util.tree_map(lambda g: g[:n], t)
    # NOTE: ``delta`` deliberately stays at its pre-solve value — mgf sets
    # the collider sweep in integrate (physics.rs:243-251) and the solver
    # only mutates velocities; next frame's complete_motion commits the
    # pre-solve displacement and Baumgarte recovers any penetration.
    vt, ot = trim(v), trim(omega)
    if light:
        dv_norm = jnp.float32(0.0)
    else:
        dv = vt - state.v        # statics never move: the trim drops only 0s
        dv_norm = jnp.sqrt(jnp.sum(dv.x * dv.x + dv.y * dv.y
                                   + dv.z * dv.z))
    state = state._replace(v=vt, omega=ot)

    metrics = {
        "num_alive": jnp.int32(0) if light else
        jnp.sum(alive).astype(jnp.int32),
        "broadphase_overflow": overflow,
        "broadphase_reach_excess": reach_excess,
        "broadphase_span_excess": span_excess,
        "terrain_reach_excess": t_reach_excess,
        "broadphase_rebuilt": bp_rebuilt,
        "broadphase_cache_drift_excess": bp_drift_excess,
        "num_pairs": jnp.int32(0) if light else
        jnp.sum(pair_valid).astype(jnp.int32),
        "num_contacts": num_contacts,
        "num_constraints": num_constraints,
        "solver_rows_dropped": solver_rows_dropped,
        "warm_hit_frac": warm_hit_frac,
        # observability (SURVEY §5.5): deepest contact penetration and the
        # total solver velocity correction this step
        "max_penetration": max_pen,
        "solver_dv_norm": dv_norm,
    }
    if collect_contacts:
        flat = lambda c: jax.tree_util.tree_map(
            lambda x: x.reshape(x.shape[0], -1), c)
        metrics["pair_contacts"] = dict(i=rows, j=cols,
                                        contact=flat(pc) if two_d else pc)
        if n_tris > 0:
            metrics["terrain_contacts"] = dict(
                i=t_rows,
                tri=t_tris.reshape(-1) if two_d else t_tris,
                contact=flat(tc) if two_d else tc)
    return world._replace(bodies=state, warm=new_warm, bp=new_bp), metrics


def make_step_fn(cfg: WorldConfig):
    """A jitted step closure over a static config."""
    return jax.jit(functools.partial(step, cfg=cfg))


# ---------------------------------------------------------------------------
# host-side world surgery (RigidBodyVec::add_body, physics.rs:200-218;
# Pool::push/remove, pool.rs:81-113)
# ---------------------------------------------------------------------------

def extend_world(world: World, new_bodies) -> World:
    """Append bodies to a world between steps (host-side; the step function
    RECOMPILES for the new N).  Prefer :func:`with_capacity` +
    :func:`spawn_bodies` for O(1) recompile-free insertion (Pool::push
    semantics)."""
    import numpy as np
    cat = lambda a, b: jnp.concatenate([jnp.asarray(a), jnp.asarray(b)],
                                       axis=0)
    merged = jax.tree_util.tree_map(cat, world.bodies, new_bodies)
    return world._replace(bodies=merged)


def remove_bodies(world: World, indices) -> World:
    """Remove bodies by index with array COMPACTION: surviving indices
    shift and the step recompiles for the new N.  Prefer
    :func:`kill_bodies` for O(1) stable-index removal (Pool::remove,
    pool.rs:100-113)."""
    import numpy as np
    n = world.bodies.n_bodies
    keep = np.ones(n, bool)
    keep[np.asarray(indices, np.int64)] = False
    kidx = jnp.asarray(np.nonzero(keep)[0])
    take = lambda a: jnp.take(jnp.asarray(a), kidx, axis=0)
    return world._replace(
        bodies=jax.tree_util.tree_map(take, world.bodies))


# ---------------------------------------------------------------------------
# capacity-padded worlds: O(1) add/remove without recompilation
# (Pool semantics, pool.rs:37-113 — stable indices, free-list reuse).
# A dead row is marked by shape_r <= 0 (the universal "not a real body"
# signature): the grid builders skip it, the narrowphase cannot hit it,
# and it is parked far from any scene so the terrain culls drop it too.
# ---------------------------------------------------------------------------

def _dead_row_fields(rows):
    """Canonical dead-row signature for body slots ``rows`` (np array)."""
    import numpy as np
    rows = np.asarray(rows, np.int64)
    px = (1.0e5 + 100.0 * rows).astype(np.float32)
    return px


def _kill_rows(bodies: RigidBodyState, idx) -> RigidBodyState:
    """Mark rows ``idx`` dead in-place (device scatter, no reshape)."""
    import numpy as np
    idx_np = np.asarray(idx, np.int64)
    px = jnp.asarray(_dead_row_fields(idx_np))
    far = jnp.full((len(idx_np),), 1.0e5, jnp.float32)
    zero = jnp.zeros((len(idx_np),), jnp.float32)
    one = jnp.ones((len(idx_np),), jnp.float32)
    i = jnp.asarray(idx_np)
    zv = lambda v: Vec3(v.x.at[i].set(zero), v.y.at[i].set(zero),
                        v.z.at[i].set(zero))
    zm = lambda m: jax.tree_util.tree_map(lambda g: g.at[i].set(zero), m)
    return bodies._replace(
        x=Vec3(bodies.x.x.at[i].set(px), bodies.x.y.at[i].set(far),
               bodies.x.z.at[i].set(far)),
        q=Quat(bodies.q.w.at[i].set(one), bodies.q.x.at[i].set(zero),
               bodies.q.y.at[i].set(zero), bodies.q.z.at[i].set(zero)),
        v=zv(bodies.v), omega=zv(bodies.omega),
        force=zv(bodies.force), torque=zv(bodies.torque),
        delta=zv(bodies.delta),
        restitution=bodies.restitution.at[i].set(zero),
        friction=bodies.friction.at[i].set(zero),
        inv_mass=bodies.inv_mass.at[i].set(zero),
        inv_moment_body=zm(bodies.inv_moment_body),
        inv_moment=zm(bodies.inv_moment),
        shape_type=bodies.shape_type.at[i].set(
            jnp.zeros((len(idx_np),), bodies.shape_type.dtype)),
        shape_r=bodies.shape_r.at[i].set(-jnp.ones((len(idx_np),),
                                                   jnp.float32)),
        shape_half_h=bodies.shape_half_h.at[i].set(zero),
    )


def _reset_warm(world: World) -> World:
    """Zero the warm-start state (body-slot surgery invalidates row keys:
    a reused slot id would warm a NEW body with a dead body's impulses).
    One cold frame, same convergence class."""
    if world.warm is None:
        return world
    w = world.warm
    return world._replace(warm=SolverWarm(
        partner=jnp.full_like(w.partner, -9),
        key2=jnp.full_like(w.key2, -9),
        acc_n=jnp.zeros_like(w.acc_n),
        acc_t1=jnp.zeros_like(w.acc_t1),
        acc_t2=jnp.zeros_like(w.acc_t2)))


def with_capacity(world: World, capacity: int) -> World:
    """Pad the body store to a static ``capacity`` with dead rows so later
    :func:`spawn_bodies` / :func:`kill_bodies` are O(1) mask edits that
    never change array shapes (and therefore never recompile the step).
    The device-side Pool (pool.rs:37-41): capacity is the slab, the
    shape_r > 0 mask is the free list."""
    import numpy as np
    n = world.bodies.n_bodies
    if capacity < n:
        raise ValueError(f"capacity {capacity} < current bodies {n}")
    pad = capacity - n
    if pad == 0:
        return world
    bodies = jax.tree_util.tree_map(
        lambda g: jnp.concatenate(
            [g, jnp.zeros((pad,) + g.shape[1:], g.dtype)], axis=0),
        world.bodies)
    bodies = _kill_rows(bodies, np.arange(n, capacity))
    out = world._replace(bodies=bodies)
    # warm/bp caches are shaped (R, N)/(N, K): rebuild for the new N
    if world.warm is not None:
        raise ValueError("call with_capacity BEFORE init_warm")
    return out


def free_slots(world: World):
    """Host-side indices of dead (spawnable) rows."""
    import numpy as np
    return np.nonzero(np.asarray(world.bodies.shape_r) <= 0.0)[0]


def spawn_bodies(world: World, new_bodies: RigidBodyState):
    """Insert bodies into free slots (Pool::push, pool.rs:81-96: freed
    slots are reused; stable indices).  Returns (world, slot_indices).
    O(n_new) device scatter — the step never recompiles.  Resets the
    warm-start state (see :func:`_reset_warm`)."""
    import numpy as np
    free = free_slots(world)
    n_new = new_bodies.n_bodies
    if len(free) < n_new:
        raise ValueError(
            f"world has {len(free)} free slots, need {n_new} — "
            "re-create with a larger with_capacity")
    idx = jnp.asarray(free[:n_new])
    merged = jax.tree_util.tree_map(
        lambda dst, src: dst.at[idx].set(jnp.asarray(src)),
        world.bodies, new_bodies)
    return _reset_warm(world._replace(bodies=merged)), np.asarray(free[:n_new])


def kill_bodies(world: World, indices) -> World:
    """Remove bodies by marking their slots dead (Pool::remove,
    pool.rs:100-113): surviving indices are STABLE, nothing reshapes, the
    step never recompiles.  Resets the warm-start state."""
    return _reset_warm(world._replace(
        bodies=_kill_rows(world.bodies, indices)))


def num_alive(world: World):
    """Number of live bodies (Pool::len equivalent) — host-side."""
    import numpy as np
    return int(np.sum(np.asarray(world.bodies.shape_r) > 0.0))
