"""World queries: overlap queries and ray casts over body sets.

Counterpart of the reference's BVH query surface
(bvh.rs:283-369): where mgf walks a pointer tree with a callback, these
return fixed-shape candidate sets / min-t hits over the whole body batch —
the natural query shape for array hardware.

* :func:`query_aabb` — ids of bodies whose fat bounds overlap a query AABB
  (BVH::query, bvh.rs:283-309),
* :func:`raytrace_bodies` — first-hit ray cast against every body collider
  (BVH::raytrace, bvh.rs:345-369), dense scan for small worlds,
* :func:`build_body_grid` + :func:`raytrace_bodies_grid` — the
  grid-accelerated form (cell DDA; only bodies in cells the ray crosses
  are tested) for large worlds,
* :func:`raytrace_mesh` / :func:`raytrace_mesh_grid` — the same pair for
  triangle meshes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mgf_tpu.broadphase import swept_fat_bounds
from mgf_tpu.collision import (
    Intersection, intersect_capsule, intersect_sphere, intersect_triangle,
)
from mgf_tpu.geom import AABB, Capsule, Sphere
from mgf_tpu.math3d import Vec3
from mgf_tpu.mesh import Mesh, mesh_triangles
from mgf_tpu.physics import SHAPE_SPHERE, colliders


def query_aabb(state, box: AABB, fatten: float = 0.0):
    """Boolean mask of bodies whose (fattened swept) bounds overlap ``box``
    — the broadphase query of world.rs:260-264 against an arbitrary AABB."""
    from mgf_tpu.world import _body_bounds, WorldConfig, shape_view
    cfg = WorldConfig(shape_mode="mixed")
    bounds = swept_fat_bounds(_body_bounds(cfg, shape_view(state)),
                              state.delta, fatten)
    d = bounds.c - box.c
    s = bounds.r + box.r
    return ((jnp.abs(d.x) <= s.x) & (jnp.abs(d.y) <= s.y)
            & (jnp.abs(d.z) <= s.z))


def raytrace_bodies(state, p: Vec3, d: Vec3, dt=jnp.inf) -> tuple:
    """First-hit ray/segment cast against every body's collider.

    Returns (Intersection, body_index).  Equivalent to BVH::raytrace +
    per-leaf Intersects (bvh.rs:345-369), evaluated densely.
    """
    spheres, capsules, = colliders(state)[:2]
    n = state.n_bodies
    b = lambda t: jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (n,) + jnp.shape(x)), t)
    i_s = intersect_sphere(b(p), b(d), dt, spheres)
    i_c = intersect_capsule(b(p), b(d), dt, capsules)
    is_sphere = state.shape_type == SHAPE_SPHERE
    hit = jnp.where(is_sphere, i_s.hit, i_c.hit)
    t = jnp.where(hit, jnp.where(is_sphere, i_s.t, i_c.t), jnp.inf)
    best = jnp.argmin(t)
    pick = lambda arr: arr[best]
    pt = jax.tree_util.tree_map(
        lambda a, c: jnp.where(is_sphere, a, c), i_s.p, i_c.p)
    inter = Intersection(
        p=jax.tree_util.tree_map(pick, pt),
        t=pick(t),
        hit=jnp.isfinite(pick(t)))
    return inter, best


class BodyGrid(NamedTuple):
    """Cell -> packed-collider table for ray casts against the body set.

    Each body is binned into EVERY cell its bound AABB overlaps (bodies up
    to one cell in reach -> extent 2 cells -> at most 27 cells, masked to
    the actual span), so the DDA tests exactly the visited cell.  Bucket
    rows pack the full collider inline —
    [cx cy cz r ax ay az dx dy dz is_sphere idx] — so a visited cell costs
    ONE (cap, 12) row fetch and no per-candidate body gather (gather
    cost is per index).

    ``dims`` is PER-AXIS (power-of-two each): big piles are usually flat,
    so giving x/z a modulus that exceeds the scene span while y stays
    small keeps the table affordable — a cell's modulus must exceed the
    OCCUPIED span on that axis or distinct occupied cells alias and
    overflow the bucket cap (query-side aliasing, e.g. a ray far above
    the pile, stays correctness-preserving: candidates are re-tested
    exactly)."""
    table: jnp.ndarray      # (dims[0]*dims[1]*dims[2], cap, 12) float32
    cell_size: float
    dims: tuple
    overflow: jnp.ndarray


def build_body_grid(state, cell_size: float, dim=64, cap: int = 8,
                    dims: tuple = None) -> BodyGrid:
    """Bin body colliders into a modular cell grid (the BVH build of
    bvh.rs:100-161, amortized over a ray batch; rebuild after stepping).
    ``dims`` (dx, dy, dz) overrides the cubic ``dim``."""
    from mgf_tpu.physics import colliders
    spheres, capsules = colliders(state)
    n = state.n_bodies
    if dims is None:
        dims = (int(dim),) * 3
    dx_, dy_, dz_ = dims
    ncell = dx_ * dy_ * dz_
    reach = state.shape_r + state.shape_half_h
    cc = lambda comp: jnp.floor(comp / cell_size).astype(jnp.int32)
    lo = [cc(state.x.x - reach), cc(state.x.y - reach),
          cc(state.x.z - reach)]
    hi = [cc(state.x.x + reach), cc(state.x.y + reach),
          cc(state.x.z + reach)]
    alive = state.shape_r > 0.0          # capacity pads / killed bodies
    hs, oks = [], []
    for dx in (0, 1, 2):
        for dy in (0, 1, 2):
            for dz in (0, 1, 2):
                cx, cy, cz = lo[0] + dx, lo[1] + dy, lo[2] + dz
                oks.append(alive & (cx <= hi[0]) & (cy <= hi[1])
                           & (cz <= hi[2]))
                hs.append((((cx & (dx_ - 1)) * dy_ + (cy & (dy_ - 1)))
                           * dz_ + (cz & (dz_ - 1))))
    h = jnp.concatenate(hs)
    ins_ok = jnp.concatenate(oks)
    body = jnp.tile(jnp.arange(n, dtype=jnp.int32), 27)
    from mgf_tpu.broadphase import _bucket_ranks
    sentinel = jnp.int32(ncell)
    hk = jnp.where(ins_ok, h, sentinel)
    order = jnp.argsort(hk)
    sorted_h = hk[order]
    rank = _bucket_ranks(sorted_h, 27 * n)
    ok = (rank < cap) & (sorted_h < sentinel)
    rows = jnp.stack([
        spheres.c.x, spheres.c.y, spheres.c.z, state.shape_r,
        capsules.a.x, capsules.a.y, capsules.a.z,
        capsules.d.x, capsules.d.y, capsules.d.z,
        (state.shape_type == SHAPE_SPHERE).astype(jnp.float32),
        jnp.arange(n, dtype=jnp.float32)], axis=-1)        # (N, 12)
    empty = jnp.full((12,), 0.0, jnp.float32).at[11].set(-1.0)
    table = jnp.broadcast_to(empty, (ncell, cap, 12))
    src = jnp.where(ok[:, None], rows[body[order]], empty[None, :])
    table = table.at[sorted_h, jnp.minimum(rank, cap - 1)].set(
        src, mode='drop')
    return BodyGrid(table=table, cell_size=cell_size, dims=dims,
                    overflow=jnp.sum((rank >= cap) & (sorted_h < sentinel))
                    .astype(jnp.int32))


def raytrace_bodies_grid(grid: BodyGrid, p: Vec3, d: Vec3, dt=jnp.inf,
                         max_steps: int = 192) -> tuple:
    """First-hit ray/segment cast against the body set via 3-D DDA cell
    marching over a :func:`build_body_grid` table — the log-ish
    BVH::raytrace (bvh.rs:345-369) replacing :func:`raytrace_bodies`'s
    dense O(N) scan for large worlds.  Exact for bodies within the grid's
    insertion reach; single ray, vmap for batches.

    Returns (Intersection, body_index) like :func:`raytrace_bodies`.
    """
    cap = grid.table.shape[1]
    cs = grid.cell_size
    dx_, dy_, dz_ = grid.dims

    db = lambda t, k: jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (k,) + jnp.shape(x)), t)

    eps = 1e-12
    inv = Vec3(*(jnp.where(jnp.abs(c) > eps, 1.0 / jnp.where(
        jnp.abs(c) > eps, c, 1.0), jnp.inf) for c in (d.x, d.y, d.z)))
    stepv = [jnp.where(c >= 0.0, 1, -1) for c in (d.x, d.y, d.z)]
    cell0 = [jnp.floor(c / cs).astype(jnp.int32)
             for c in (p.x, p.y, p.z)]

    def t_next(cell, pc, dc, ic):
        edge = (cell + (dc >= 0.0)) * cs
        return jnp.where(jnp.isfinite(ic), (edge - pc) * ic, jnp.inf)

    init = dict(cell=jnp.stack(cell0),
                tmax=jnp.stack([
                    t_next(cell0[0].astype(jnp.float32), p.x, d.x, inv.x),
                    t_next(cell0[1].astype(jnp.float32), p.y, d.y, inv.y),
                    t_next(cell0[2].astype(jnp.float32), p.z, d.z, inv.z)]),
                best_t=jnp.asarray(jnp.inf, jnp.float32),
                best_b=jnp.int32(-1),
                t_entry=jnp.float32(0.0),
                done=jnp.bool_(False))

    def body(st):
        cell = st["cell"]
        h = (((cell[0] & (dx_ - 1)) * dy_ + (cell[1] & (dy_ - 1))) * dz_
             + (cell[2] & (dz_ - 1)))
        r = grid.table[h]                            # (cap, 12)
        sph = Sphere(c=Vec3(r[:, 0], r[:, 1], r[:, 2]), r=r[:, 3])
        capsule = Capsule(a=Vec3(r[:, 4], r[:, 5], r[:, 6]),
                          d=Vec3(r[:, 7], r[:, 8], r[:, 9]), r=r[:, 3])
        is_sphere = r[:, 10] > 0.5
        idx = r[:, 11].astype(jnp.int32)
        i_s = intersect_sphere(db(p, cap), db(d, cap), dt, sph)
        i_c = intersect_capsule(db(p, cap), db(d, cap), dt, capsule)
        hit = jnp.where(is_sphere, i_s.hit, i_c.hit) & (idx >= 0)
        tt = jnp.where(hit, jnp.where(is_sphere, i_s.t, i_c.t), jnp.inf)
        k = jnp.argmin(tt)
        better = tt[k] < st["best_t"]
        best_t = jnp.where(better, tt[k], st["best_t"])
        best_b = jnp.where(better, idx[k], st["best_b"])

        ax = jnp.argmin(st["tmax"])
        t_exit = st["tmax"][ax]
        done = st["done"] | (best_t <= t_exit) | (st["t_entry"] > dt)
        cell = st["cell"].at[ax].add(
            jnp.where(done, 0, jnp.stack(stepv)[ax]))
        icomp = jnp.stack([inv.x, inv.y, inv.z])
        tmax = st["tmax"].at[ax].add(
            jnp.where(done, 0.0, jnp.abs(icomp[ax]) * cs))
        return dict(cell=cell, tmax=tmax, best_t=best_t, best_b=best_b,
                    t_entry=jnp.where(done, st["t_entry"], t_exit),
                    done=done, i=st["i"] + 1)

    # while_loop, not fori: under vmap the condition OR-reduces over the
    # ray batch, so a batch whose rays all resolve early stops marching
    # (the fori form paid all max_steps iterations every time)
    init["i"] = jnp.int32(0)
    st = jax.lax.while_loop(
        lambda st: (~st["done"]) & (st["i"] < max_steps), body, init)
    hit = jnp.isfinite(st["best_t"]) & (st["best_t"] <= dt)
    out = Intersection(p=p + d * st["best_t"], t=st["best_t"], hit=hit)
    return out, st["best_b"]


def raytrace_mesh_grid(m: Mesh, grid, p: Vec3, d: Vec3, dt=jnp.inf,
                       max_steps: int = 192) -> tuple:
    """First-hit ray cast through a :class:`mgf_tpu.mesh.MeshGrid` by 3-D
    DDA cell marching — the log-ish BVH::raytrace equivalent
    (bvh.rs:345-369) for large meshes: only the faces in cells the ray
    actually crosses are tested, with early exit on the first confirmed
    hit.  Exact regardless of grid aliasing (candidate faces are re-tested
    with the real triangle intersection).  Single ray; vmap for batches.

    Returns (Intersection, face_index) like :func:`raytrace_mesh`.
    """
    tris = mesh_triangles(m)
    T = m.n_faces
    cap = grid.table.shape[1]
    cs = grid.cell_size
    mmask = grid.dim - 1

    db = lambda t, k: jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (k,) + jnp.shape(x)), t)

    eps = 1e-12
    inv = Vec3(*(jnp.where(jnp.abs(c) > eps, 1.0 / jnp.where(
        jnp.abs(c) > eps, c, 1.0), jnp.inf) for c in (d.x, d.y, d.z)))
    stepv = [jnp.where(c >= 0.0, 1, -1) for c in (d.x, d.y, d.z)]
    cell0 = [jnp.floor(c / cs).astype(jnp.int32)
             for c in (p.x, p.y, p.z)]

    def t_next(cell, pc, dc, ic):
        edge = (cell + (dc >= 0.0)) * cs
        return jnp.where(jnp.isfinite(ic), (edge - pc) * ic, jnp.inf)

    init = dict(cell=jnp.stack(cell0),
                tmax=jnp.stack([
                    t_next(cell0[0].astype(jnp.float32), p.x, d.x, inv.x),
                    t_next(cell0[1].astype(jnp.float32), p.y, d.y, inv.y),
                    t_next(cell0[2].astype(jnp.float32), p.z, d.z, inv.z)]),
                best_t=jnp.asarray(jnp.inf, jnp.float32),
                best_f=jnp.int32(-1),
                t_entry=jnp.float32(0.0),
                done=jnp.bool_(False))

    def body(st):
        cell = st["cell"]
        h = (((cell[0] & mmask) * grid.dim + (cell[1] & mmask)) * grid.dim
             + (cell[2] & mmask))
        faces = grid.table[h]                       # (cap,)
        safe = jnp.maximum(faces, 0)
        tri = jax.tree_util.tree_map(lambda x: x[safe], tris)
        inter = intersect_triangle(db(p, cap), db(d, cap), dt, tri)
        tt = jnp.where(inter.hit & (faces >= 0), inter.t, jnp.inf)
        k = jnp.argmin(tt)
        better = tt[k] < st["best_t"]
        best_t = jnp.where(better, tt[k], st["best_t"])
        best_f = jnp.where(better, faces[k], st["best_f"])

        # advance to the next cell along the smallest boundary crossing
        ax = jnp.argmin(st["tmax"])
        t_exit = st["tmax"][ax]
        # a confirmed hit inside the already-traversed interval is final
        done = st["done"] | (best_t <= t_exit) | (st["t_entry"] > dt)
        cell = st["cell"].at[ax].add(
            jnp.where(done, 0, jnp.stack(stepv)[ax]))
        icomp = jnp.stack([inv.x, inv.y, inv.z])
        tmax = st["tmax"].at[ax].add(
            jnp.where(done, 0.0, jnp.abs(icomp[ax]) * cs))
        return dict(cell=cell, tmax=tmax, best_t=best_t, best_f=best_f,
                    t_entry=jnp.where(done, st["t_entry"], t_exit),
                    done=done, i=st["i"] + 1)

    # while_loop: early exit once every ray in the (vmapped) batch is done
    init["i"] = jnp.int32(0)
    st = jax.lax.while_loop(
        lambda st: (~st["done"]) & (st["i"] < max_steps), body, init)
    hit = jnp.isfinite(st["best_t"]) & (st["best_t"] <= dt)
    out = Intersection(p=p + d * st["best_t"], t=st["best_t"], hit=hit)
    return out, st["best_f"]


def raytrace_mesh(m: Mesh, p: Vec3, d: Vec3, dt=jnp.inf) -> tuple:
    """First-hit ray/segment cast against a triangle mesh.

    Returns (Intersection, face_index) — the raytrace path used by
    Compound/Mesh queries (mesh BVH raytrace equivalent)."""
    tris = mesh_triangles(m)
    T = m.n_faces
    b = lambda t: jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (T,) + jnp.shape(x)), t)
    inter = intersect_triangle(b(p), b(d), dt, tris)
    t = jnp.where(inter.hit, inter.t, jnp.inf)
    best = jnp.argmin(t)
    out = Intersection(
        p=jax.tree_util.tree_map(lambda a: a[best], inter.p),
        t=t[best], hit=jnp.isfinite(t[best]))
    return out, best
